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
// [grad, hess, count]; amax (3,) f32 on the device, max |stats| of each
// channel, which sets the fixed-point scale (hist_common.cuh); target as a
// host int or a device int32. n needs no padding. Output: (p, 3, num_bins)
// f32, written by the last block of each feature group.
//
// What bounds it on an H100: bytes. A masked scan must read every node id
// (4 bytes a row) and the codes and stats of the selected rows (p + 12
// bytes a row for uint8); at p = 50, n = 200,000, half the rows selected,
// ~7 MB, ~2 us at 3.35 TB/s. The adds are 3 per selected row and feature.
//
// What the design does about it. One launch, grid (row blocks, feature
// groups). A block walks tiles of up to kMaxTileRows rows, strided over
// the row blocks (hist_common.cuh plan_rows), and for each tile
//   1. issues all its loads of the tile's node ids and of the selected
//      rows' stats at once, coalesced, and quantises the stats once into
//      shared memory (int64, 24 KB);
//   2. lists the selected rows that add something, in row order (warp
//      ballots);
//   3. where the selection is dense, stages the group's codes of the whole
//      tile with 16-byte vector loads (the aligned 16-byte chunks that
//      cover it, at any alignment; the bytes outside it are never used and
//      never cross the tensor's 512-byte allocation granule); where it is
//      sparse, loads one code per listed row;
//   4. adds each listed row once into each feature's shared histogram,
//      consecutive lanes on consecutive listed rows (hist_common.cuh
//      add_row).
// Then it adds its non-zero bins to a global int64 accumulator, and the
// group's last block converts to f32 (hist_common.cuh finish). The flush
// budget caps the row blocks per group (33 at p = 50, B = 255: ~1.3 M
// int64 adds, which stay in L2). The stats and node ids are read once per
// feature group (7 groups at p = 50, B = 255), not once per feature.

#include "hist_common.cuh"

namespace {

using namespace gpb;

constexpr int kMaxTileRows = 1024;
constexpr int kRowsPerThread = kMaxTileRows / kThreads;

// Dynamic shared memory of one block: quantised stats (3 x tile int64),
// the histograms, the list of tile offsets (tile uint16) and the staged
// codes (group_feats x tile uint16).
inline size_t smem_bytes(int tile, int group_feats, int num_bins) {
  return 3 * (size_t)tile * sizeof(long long)
         + (size_t)hist_words(group_feats, num_bins) * sizeof(unsigned)
         + (size_t)tile * sizeof(uint16_t)
         + (size_t)group_feats * tile * sizeof(uint16_t);
}

template <typename BinT, bool kMasked>
__global__ void __launch_bounds__(kThreads)
hist_masked_kernel(const BinT* __restrict__ bins,
                   const int32_t* __restrict__ node,
                   const float* __restrict__ stats,
                   const float* __restrict__ amax, int log2_rows,
                   const int32_t* __restrict__ target_dev, int target_host,
                   long long n, int p, int num_bins, int group_feats,
                   int tile, long long* __restrict__ acc,
                   int* __restrict__ counters, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_q = (long long*)smem;                      // 3 x tile
  unsigned* s_hist = (unsigned*)(s_q + 3 * tile);
  uint16_t* s_idx = (uint16_t*)(s_hist + hist_words(group_feats, num_bins));
  uint16_t* s_codes = s_idx + tile;                       // g x tile
  __shared__ Scale sc;
  __shared__ int s_warp_cnt[kRowsPerThread][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = blockIdx.y * group_feats;
  const int g = min(group_feats, p - f0);
  const int B = num_bins;
  const long long tiles = (n + tile - 1) / tile;
  const bool has_rows = blockIdx.x < tiles;
  int target = 0;
  if (kMasked) target = target_dev ? *target_dev : target_host;
  load_scale(&sc, amax, log2_rows);
  if (has_rows) zero_hist(s_hist, hist_words(g, B));
  __syncthreads();

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * tile;
    const int rows = (int)min((long long)tile, n - row0);

    // 1: node ids and the selected rows' stats, every load in flight at
    // once; quantised once
    bool keep[kRowsPerThread];
    long long q[kRowsPerThread][3];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = k * kThreads + tid;
      const long long row = row0 + i;
      keep[k] = i < rows;
      if (kMasked && keep[k]) keep[k] = node[row] == target;
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const long long row = row0 + k * kThreads + tid;
      q[k][0] = keep[k] ? quantize(stats[row], sc, 0) : 0;
      q[k][1] = keep[k] ? quantize(stats[n + row], sc, 1) : 0;
      q[k][2] = keep[k] ? quantize(stats[2 * n + row], sc, 2) : 0;
      keep[k] = (q[k][0] | q[k][1] | q[k][2]) != 0;  // a zero row adds 0
    }
    // 2: list the rows that add something, in row order (warp ballots)
    unsigned ballot[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = k * kThreads + tid;
      if (i < tile) {
        s_q[i] = q[k][0];
        s_q[tile + i] = q[k][1];
        s_q[2 * tile + i] = q[k][2];
      }
      ballot[k] = __ballot_sync(0xffffffffu, keep[k]);
      if (lane == 0) s_warp_cnt[k][warp] = __popc(ballot[k]);
    }
    __syncthreads();
    int m = 0;                                   // listed rows, uniform
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      int before = m;
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_warp_cnt[k][w];
        if (w < warp) before += c;
        m += c;
      }
      if (keep[k])
        s_idx[before + __popc(ballot[k] & ((1u << lane) - 1u))] =
            (uint16_t)(k * kThreads + tid);
    }
    if (m == 0) {
      __syncthreads();                           // s_warp_cnt is reused
      continue;
    }
    // 3: where the selection is dense, stage the group's codes of the
    // whole tile with 16-byte loads (the aligned chunks that cover it)
    const bool dense = (long long)m * 16 >= (long long)rows * sizeof(BinT);
    if (dense) {
      constexpr int kPer = 16 / sizeof(BinT);
      const int chunks = (rows * (int)sizeof(BinT) + 15) / 16 + 1;
      for (int w = tid; w < g * chunks; w += kThreads) {
        const int fl = w / chunks;
        const int c = w - fl * chunks;
        const uintptr_t lo =
            (uintptr_t)(bins + (long long)(f0 + fl) * n + row0);
        const uintptr_t hi = lo + (uintptr_t)rows * sizeof(BinT);
        const uintptr_t a = (lo & ~(uintptr_t)15) + 16 * (uintptr_t)c;
        if (a >= hi) continue;
        union { uint4 v; BinT code[kPer]; } u;
        u.v = __ldg((const uint4*)a);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const uintptr_t aj = a + j * sizeof(BinT);
          if (aj >= lo && aj < hi)
            s_codes[fl * tile + (int)((aj - lo) / sizeof(BinT))] =
                (uint16_t)min((unsigned)u.code[j], 65535u);  // > any bin
        }
      }
    }
    __syncthreads();
    // 4: each listed row once into each feature's shared histogram
    for (int w = tid; w < g * m; w += kThreads) {
      const int fl = w / m;
      const int i = s_idx[w - fl * m];
      const int b = dense ? (int)s_codes[fl * tile + i]
                          : (int)bins[(long long)(f0 + fl) * n + row0 + i];
      add_row(s_hist + fl * 6 * B, B, b, s_q[i], s_q[tile + i],
              s_q[2 * tile + i]);
    }
    __syncthreads();                             // before the next tile
  }
  finish(s_hist, has_rows, f0, g, B, acc, counters + blockIdx.y, gridDim.x,
         sc, out);
}

template <typename BinT, bool kMasked>
cudaError_t launch(int device, dim3 grid, size_t smem, cudaStream_t stream,
                   const void* bins, const int32_t* node, const float* stats,
                   const float* amax, int log2_rows,
                   const int32_t* target_dev, int target_host, long long n,
                   int p, int num_bins, int group_feats, int tile,
                   long long* acc, int* counters, float* out) {
  static size_t limit[64];
  auto kernel = hist_masked_kernel<BinT, kMasked>;
  const cudaError_t err = allow_smem(kernel, device, smem, limit);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      (const BinT*)bins, node, stats, amax, log2_rows, target_dev,
      target_host, n, p, num_bins, group_feats, tile, acc, counters, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on `stream`; returns a CUDA error code (0 on success).
// node == null selects the unmasked variant (every row counts).
// target_dev, when not null, overrides target_host. amax (3,) f32 on the
// device; log2_rows = L with n <= 2^L. acc holds p * 3 * num_bins int64
// and counters p int32, both zero, and both are zero again when the
// launch ends.
int gpb_hist_masked(int device, const void* bins, int bins_is_u8,
                    const int32_t* node, const float* stats,
                    const float* amax, int log2_rows,
                    const int32_t* target_dev, int target_host, long long n,
                    int p, int num_bins, long long* acc, int* counters,
                    float* out, void* stream_ptr) {
  if (p < 1 || p > 65535 || num_bins < 1 || num_bins > kMaxBins || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int group_feats = 1;
  const int groups = plan_groups(p, num_bins, &group_feats);
  int tile = kThreads, row_blocks = 1;
  plan_rows(device, groups, p, num_bins, n, kThreads, kMaxTileRows, &tile,
            &row_blocks);
  const dim3 grid(row_blocks, groups);
  const size_t smem = smem_bytes(tile, group_feats, num_bins);
  const bool masked = node != nullptr;
#define GPB_LAUNCH(T, M)                                                   \
  launch<T, M>(device, grid, smem, stream, bins, node, stats, amax,        \
               log2_rows, target_dev, target_host, n, p, num_bins,         \
               group_feats, tile, acc, counters, out)
  if (bins_is_u8)
    err = masked ? GPB_LAUNCH(uint8_t, true) : GPB_LAUNCH(uint8_t, false);
  else
    err = masked ? GPB_LAUNCH(int32_t, true) : GPB_LAUNCH(int32_t, false);
#undef GPB_LAUNCH
  return (int)err;
}

}  // extern "C"
