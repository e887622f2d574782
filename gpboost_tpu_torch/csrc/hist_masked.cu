// Gradient / hessian / count histogram of the rows of one leaf, found by a
// masked scan of every row, for the parallel (masked full-scan) tree
// learners; with the mask compiled out, the histogram of every row.
//
// Replaces the Pallas TPU kernels hist_pallas
// (gpboost_tpu/ops/histogram.py:155, body _hist_kernel :27) and, as the
// unmasked variant of the same source, hist_block_pallas (:129, body
// _hist_block_kernel :113):
//
//   out[f, c, b] = sum over rows r with node[r] == target
//                  of stats[c, r] * 1{bins[f, r] == b}
//
// Inputs, in the reference's feature-major layout: bins (p, n) uint8 or
// int32; node (n,) int32 (null for the unmasked variant); stats (3, n) f32
// [grad, hess, count]; target as a host int or a device int32 (the tree
// learner passes the leaf id from the host, a caller that keeps it on the
// device launches without a sync). n needs no padding: the kernel masks the
// ragged edge itself. Output: (p, 3, num_bins) f32.
//
// What bounds it on an H100: bytes. One launch reads every bin code once
// (p bytes a row for uint8), the node ids (4 bytes a row) and the three
// stat channels (12 bytes a row); at p = 50, n = 200,000 that is ~13 MB, or
// ~4 us at 3.35 TB/s. The sums themselves are 3 adds per selected row and
// feature. What the design does about it: each block reads its rows of one
// feature, their node ids and stats once, coalesced, and keeps only the
// selected rows, compacted in row order in shared memory, so the bin loop
// that follows touches no device memory and runs over the leaf's rows only.
//
// The TPU kernel walks row blocks in order on one core and accumulates into
// one output block. Here chunks of rows run in parallel blocks, and the sum
// stays deterministic without float atomics (two launches are bitwise
// equal, so split ties resolve alike in every run and on every rank):
//   pass 1: one block per (chunk of kChunkRows rows, feature). The block
//           walks its chunk in tiles of kTileRows. For each tile it stages
//           the selected rows' bin codes and stats in shared memory, in row
//           order (warp ballots give each row its slot). Each thread owns
//           the bins b = tid, tid + kThreads, ... and adds the staged rows
//           of its bins in row order to partial[chunk, f, c, b];
//   pass 2: each output element sums the chunks in chunk order.
// The bin loop compares every staged row with every bin a thread owns;
// warp-private histograms (one pass over the rows) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 1024;              // rows staged at a time
constexpr int kTilesPerChunk = 4;
constexpr int kChunkRows = kTileRows * kTilesPerChunk;

template <typename BinT, bool kMasked>
__global__ void __launch_bounds__(kThreads)
hist_masked_partial_kernel(const BinT* __restrict__ bins,
                           const int32_t* __restrict__ node,
                           const float* __restrict__ stats,
                           const int32_t* __restrict__ target_dev,
                           int target_host, long long n, int p, int num_bins,
                           float* __restrict__ partial) {
  __shared__ int s_bin[kTileRows];
  __shared__ float s_g[kTileRows];
  __shared__ float s_h[kTileRows];
  __shared__ float s_c[kTileRows];
  __shared__ int s_warp_cnt[kWarps];

  const int f = blockIdx.y;
  const long long k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int target = 0;
  if (kMasked) target = target_dev ? *target_dev : target_host;
  const BinT* bins_f = bins + (long long)f * n;
  float* out = partial + ((k * p + f) * 3LL) * num_bins;

  for (int t = 0; t < kTilesPerChunk; ++t) {
    const long long row0 = k * kChunkRows + (long long)t * kTileRows;
    if (t > 0 && row0 >= n) break;           // tile 0 always writes `out`

    // stage the selected rows of this tile, compacted in row order
    int m = 0;                               // staged rows, block-uniform
    for (int r = 0; r < kTileRows; r += kThreads) {
      const long long row = row0 + r + tid;
      bool keep = row < n;
      if (kMasked && keep) keep = node[row] == target;
      const unsigned ballot = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_warp_cnt[warp] = __popc(ballot);
      __syncthreads();
      int before = m;
      int total = m;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_warp_cnt[w];
        if (w < warp) before += c;
        total += c;
      }
      if (keep) {
        const int i = before + __popc(ballot & ((1u << lane) - 1u));
        s_bin[i] = (int)bins_f[row];
        s_g[i] = stats[row];
        s_h[i] = stats[n + row];
        s_c[i] = stats[2 * n + row];
      }
      m = total;
      __syncthreads();                       // s_warp_cnt is reused
    }

    // each thread adds the staged rows of its own bins, in row order
    for (int b = tid; b < num_bins; b += kThreads) {
      float g = t > 0 ? out[b] : 0.f;
      float h = t > 0 ? out[num_bins + b] : 0.f;
      float c = t > 0 ? out[2 * num_bins + b] : 0.f;
      for (int i = 0; i < m; ++i) {
        if (s_bin[i] == b) {
          g += s_g[i];
          h += s_h[i];
          c += s_c[i];
        }
      }
      out[b] = g;
      out[num_bins + b] = h;
      out[2 * num_bins + b] = c;
    }
    __syncthreads();                         // before the next tile's stage
  }
}

__global__ void hist_chunk_sum_kernel(const float* __restrict__ partial,
                                      long long nchunks, long long per_chunk,
                                      float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= per_chunk) return;
  float s = 0.f;
  for (long long k = 0; k < nchunks; ++k) s += partial[k * per_chunk + j];
  out[j] = s;
}

template <typename BinT>
void launch_partial(dim3 grid, cudaStream_t stream, const void* bins,
                    const int32_t* node, const float* stats,
                    const int32_t* target_dev, int target_host, long long n,
                    int p, int num_bins, float* partial) {
  if (node) {
    hist_masked_partial_kernel<BinT, true><<<grid, kThreads, 0, stream>>>(
        (const BinT*)bins, node, stats, target_dev, target_host, n, p,
        num_bins, partial);
  } else {
    hist_masked_partial_kernel<BinT, false><<<grid, kThreads, 0, stream>>>(
        (const BinT*)bins, node, stats, target_dev, target_host, n, p,
        num_bins, partial);
  }
}

}  // namespace

extern "C" {

int gpb_hist_masked_chunk_rows() { return kChunkRows; }

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). node == null selects the unmasked variant (every row counts).
// target_dev, when not null, overrides target_host. partial holds
// (nchunks, p, 3, num_bins) f32 scratch with nchunks = max(1,
// ceil(n / kChunkRows)); chunk k covers rows [k * kChunkRows,
// (k + 1) * kChunkRows).
int gpb_hist_masked(int device, const void* bins, int bins_is_u8,
                    const int32_t* node, const float* stats,
                    const int32_t* target_dev, int target_host, long long n,
                    int p, int num_bins, long long nchunks, float* partial,
                    float* out, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid1((unsigned)nchunks, (unsigned)p);
  if (bins_is_u8) {
    launch_partial<uint8_t>(grid1, stream, bins, node, stats, target_dev,
                            target_host, n, p, num_bins, partial);
  } else {
    launch_partial<int32_t>(grid1, stream, bins, node, stats, target_dev,
                            target_host, n, p, num_bins, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per_chunk = (long long)p * 3 * num_bins;
  const unsigned grid2 = (unsigned)((per_chunk + kThreads - 1) / kThreads);
  hist_chunk_sum_kernel<<<grid2, kThreads, 0, stream>>>(partial, nchunks,
                                                        per_chunk, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
