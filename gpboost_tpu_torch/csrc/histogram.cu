// Gradient / hessian / count histogram of one contiguous position segment
// of the physically partitioned bin matrix, for the leaf-wise tree learner.
//
// Replaces the Pallas TPU kernel hist_block_rows_pallas
// (gpboost_tpu/ops/histogram.py:85, body _hist_block_rows_kernel :54), which
// the reference calls once per positional row block of a leaf's segment
// (tree_learner.py:664-681 hist_segment). Here ONE call covers the whole
// segment [s0, s0 + cnt): the per-block loop there is a Pallas-grid artifact.
//
//   out[f, c, b] = sum over rows r in [s0, s0+cnt) of stats[r, c] * 1{bins[r, f] == b}
//
// Inputs: bins (n_rows, p) uint8 or int32, row-major; stats (n_rows, 3) f32
// [grad, hess, count]; the segment either as host integers or as a device
// int32 pair [s0, cnt] (the tree learner computes the smaller child's
// segment on the device, which saves one host sync per split).
// Output: (p, 3, num_bins) f32, the layout the reference's hist_segment
// returns.
//
// What bounds it on an H100: memory traffic is the bin codes plus the three
// stat channels, p + 12 bytes per segment row (uint8 bins), read once per
// feature block; there is no reuse across features worth a tensor core.
// What the design does about it: each block stages one chunk of rows (bin
// codes of its feature and the three stats) in shared memory with a single
// pass over device memory, so the bin loop that follows never touches device
// memory again.
//
// Deterministic, without float atomics (the exact-tree goldens and split
// ties need bitwise-reproducible sums):
//   pass 1: one block per (row chunk, feature). Each thread owns bins
//           b = tid, tid + blockDim, ... and sums the chunk's rows in row
//           order into partial[chunk, f, c, b];
//   pass 2: each output element sums the chunks in chunk order.
// Making it fast (warp-private histograms in shared memory, one pass,
// fewer redundant compares) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkRows = 1024;   // rows one block stages in shared memory
constexpr int kThreads = 256;

template <typename BinT>
__global__ void hist_partial_kernel(const BinT* __restrict__ bins,
                                    const float* __restrict__ stats,
                                    const int32_t* __restrict__ seg_dev,
                                    long long s0_host, long long cnt_host,
                                    long long chunk0, int p, int num_bins,
                                    float* __restrict__ partial) {
  __shared__ int s_bin[kChunkRows];
  __shared__ float s_g[kChunkRows];
  __shared__ float s_h[kChunkRows];
  __shared__ float s_c[kChunkRows];

  const int f = blockIdx.y;
  const long long k = blockIdx.x;
  const long long s0 = seg_dev ? (long long)seg_dev[0] : s0_host;
  const long long cnt = seg_dev ? (long long)seg_dev[1] : cnt_host;
  const long long row0 = (chunk0 + k) * kChunkRows;
  long long lo = s0 > row0 ? s0 : row0;
  long long hi = s0 + cnt;
  if (hi > row0 + kChunkRows) hi = row0 + kChunkRows;
  if (hi < lo) hi = lo;                      // chunk outside the segment
  const int i0 = (int)(lo - row0);
  const int i1 = (int)(hi - row0);

  for (int i = i0 + (int)threadIdx.x; i < i1; i += blockDim.x) {
    const long long r = row0 + i;
    s_bin[i] = (int)bins[r * p + f];
    s_g[i] = stats[r * 3 + 0];
    s_h[i] = stats[r * 3 + 1];
    s_c[i] = stats[r * 3 + 2];
  }
  __syncthreads();

  float* out = partial + ((k * p + f) * 3LL) * num_bins;
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    float g = 0.f, h = 0.f, c = 0.f;
    for (int i = i0; i < i1; ++i) {
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
}

__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   long long nchunks, long long per_chunk,
                                   float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= per_chunk) return;
  float s = 0.f;
  for (long long k = 0; k < nchunks; ++k) s += partial[k * per_chunk + j];
  out[j] = s;
}

}  // namespace

extern "C" {

int gpb_hist_chunk_rows() { return kChunkRows; }

// Launches both passes on `stream` and returns cudaGetLastError() (0 on
// success). partial holds (nchunks, p, 3, num_bins) f32 scratch; chunk k
// covers rows [(chunk0 + k) * kChunkRows, (chunk0 + k + 1) * kChunkRows).
// seg_dev, when not null, overrides s0_host / cnt_host.
int gpb_hist_segment(int device, const void* bins, int bins_is_u8,
                     const float* stats, const int32_t* seg_dev,
                     long long s0_host, long long cnt_host, long long chunk0,
                     long long nchunks, int p, int num_bins, float* partial,
                     float* out, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  dim3 grid1((unsigned)nchunks, (unsigned)p);
  if (bins_is_u8) {
    hist_partial_kernel<uint8_t><<<grid1, kThreads, 0, stream>>>(
        (const uint8_t*)bins, stats, seg_dev, s0_host, cnt_host, chunk0, p,
        num_bins, partial);
  } else {
    hist_partial_kernel<int32_t><<<grid1, kThreads, 0, stream>>>(
        (const int32_t*)bins, stats, seg_dev, s0_host, cnt_host, chunk0, p,
        num_bins, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per_chunk = (long long)p * 3 * num_bins;
  const unsigned grid2 = (unsigned)((per_chunk + kThreads - 1) / kThreads);
  hist_reduce_kernel<<<grid2, kThreads, 0, stream>>>(partial, nchunks,
                                                     per_chunk, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
