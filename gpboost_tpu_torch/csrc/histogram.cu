// Gradient / hessian / count histogram of one contiguous position segment
// of the physically partitioned bin matrix, for the leaf-wise tree learner.
//
// Replaces the Pallas TPU kernel hist_block_rows_pallas
// (gpboost_tpu/ops/histogram.py:85, body _hist_block_rows_kernel :54), which
// the reference calls once per positional row block of a leaf's segment
// (tree_learner.py:664-681 hist_segment). Here ONE launch covers the whole
// segment [s0, s0 + cnt): the per-block loop there is a Pallas-grid artifact.
//
//   out[f, c, b] = sum over rows r in [s0, s0+cnt) of stats[r, c] * 1{bins[r, f] == b}
//
// Inputs: bins (n, p) uint8 or int32, row-major; stats (n, 3) f32
// [grad, hess, count]; amax (3,) f32 on the device, max |stats| of each
// channel, which sets the fixed-point scale (hist_common.cuh); the segment
// as host integers or as a device int32 pair [s0, cnt] (the tree learner
// computes the smaller child's segment on the device, which saves one host
// sync per split). Output: (p, 3, num_bins) f32, the layout the reference's
// hist_segment returns.
//
// What bounds it on an H100: bytes, p + 12 a segment row for uint8 bins
// (10.4 MB for the whole of n = 200,000, p = 50: ~3 us at 3.35 TB/s); the
// adds, 3 per row and feature, are below that.
//
// What the design does about it. One launch with a persistent grid that
// follows the segment, not n: (row blocks, feature groups), with the row
// blocks and tile size planned for the segment's rows (hist_common.cuh
// plan_rows; for a device segment, for n rows, the most it can hold), each
// block striding over the segment's tiles, so a small leaf costs one
// launch whose blocks find few tiles or none, whatever n is (bounds read
// on the device). For each tile a block
//   1. quantises the tile's stats once (three contiguous floats a row) into
//      shared memory;
//   2. stages the tile's codes, whole rows of p codes, which are contiguous
//      in the row-major layout, with 16-byte vector loads (the aligned
//      chunks that cover them; the extra bytes are never used and never
//      cross the tensor's 512-byte allocation granule), in place of one
//      strided byte load per row and feature; rows wider than kStageBytes /
//      32 are read from device memory where they lie;
//   3. adds each row once into the shared int64 histogram of each feature
//      of its group (32-bit atomicAdd on each int64's two halves).
// Then the non-zero bins go to the global int64 accumulator and the
// group's last block converts to f32 (hist_common.cuh finish_window).
//
// More bins than one block's shared histogram holds (kMaxBins, 4096: an
// EFB bundle of many features, int32 codes) are split into windows of at
// most kWindowBins (hist_common.cuh plan_windows): the grid's y axis runs
// over (feature group, window), each block adds only the codes inside its
// window and flushes and finishes that window alone. The sums are the same
// integers, so the bits do not depend on the windows; each window's blocks
// read the segment's codes again, a simple design whose speed is later
// work.

#include "hist_common.cuh"

namespace {

using namespace gpb;

constexpr int kStageBytes = 24 * 1024;    // staged codes of one tile
constexpr int kMaxTileRows = 1024;

// The most rows a tile may hold (a multiple of 32, which keeps every
// shared array 16-byte aligned), and whether the tile's codes are staged.
inline int max_tile_rows(int p, int code_bytes, bool* staged) {
  const long long row_bytes = (long long)p * code_bytes;
  *staged = row_bytes * 32 <= kStageBytes;
  if (!*staged) return kMaxTileRows;
  const long long t = kStageBytes / row_bytes / 32 * 32;
  return (int)(t < kMaxTileRows ? t : kMaxTileRows);
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
hist_segment_kernel(const BinT* __restrict__ bins,
                    const float* __restrict__ stats,
                    const float* __restrict__ amax, int log2_rows,
                    const int32_t* __restrict__ seg_dev, long long s0_host,
                    long long cnt_host, long long n, int p, int num_bins,
                    int group_feats, int windows, int win_bins, int tile,
                    int staged, long long* __restrict__ acc,
                    int* __restrict__ counters, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_q = (long long*)smem;                        // 3 x tile
  unsigned* s_hist = (unsigned*)(s_q + 3 * tile);
  const size_t hist_bytes =
      (size_t)hist_words(group_feats, win_bins) * sizeof(unsigned);
  unsigned char* s_codes =
      (unsigned char*)s_hist + ((hist_bytes + 15) & ~(size_t)15);
  __shared__ Scale sc;

  const int tid = threadIdx.x;
  const int f0 = (blockIdx.y / windows) * group_feats;
  const int g = min(group_feats, p - f0);
  const int w0 = (blockIdx.y % windows) * win_bins;   // this block's bins
  const int wn = min(win_bins, num_bins - w0);
  long long s0 = seg_dev ? (long long)seg_dev[0] : s0_host;
  long long cnt = seg_dev ? (long long)seg_dev[1] : cnt_host;
  s0 = s0 < 0 ? 0 : (s0 > n ? n : s0);
  cnt = cnt < 0 ? 0 : (cnt > n - s0 ? n - s0 : cnt);
  const long long tiles = (cnt + tile - 1) / tile;
  const bool has_rows = blockIdx.x < tiles;
  load_scale(&sc, amax, log2_rows);
  if (has_rows) zero_hist(s_hist, hist_words(g, wn));
  __syncthreads();

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = s0 + t * tile;
    const int rows = (int)min((long long)tile, s0 + cnt - row0);

    // 1: the tile's stats, quantised once
    const float* st = stats + row0 * 3;
    for (int j = tid; j < 3 * rows; j += kThreads) {
      const int c = j % 3;
      s_q[c * tile + j / 3] = quantize(st[j], sc, c);
    }
    // 2: the tile's codes, whole rows, 16 bytes a load
    const unsigned char* src = (const unsigned char*)(bins + row0 * p);
    if (staged) {
      const uintptr_t lo = (uintptr_t)src;
      const uintptr_t hi = lo + (uintptr_t)rows * p * sizeof(BinT);
      const uintptr_t base = lo & ~(uintptr_t)15;
      const int chunks = (int)((hi - base + 15) / 16);
      for (int c = tid; c < chunks; c += kThreads)
        ((uint4*)s_codes)[c] = __ldg((const uint4*)(base + 16 * (uintptr_t)c));
      src = s_codes + (lo - base);
    }
    __syncthreads();

    // 3: each row once into each feature's shared histogram
    for (int w = tid; w < g * rows; w += kThreads) {
      const int fl = w / rows;
      const int i = w - fl * rows;
      const long long q0 = s_q[i], q1 = s_q[tile + i], q2 = s_q[2 * tile + i];
      if ((q0 | q1 | q2) == 0) continue;
      const BinT b =
          *(const BinT*)(src + ((long long)i * p + f0 + fl) * sizeof(BinT));
      add_row(s_hist + fl * 6 * wn, wn, (int)b - w0, q0, q1, q2);
    }
    __syncthreads();                             // before the next tile
  }
  finish_window(s_hist, has_rows, f0, g, w0, wn, num_bins, acc,
                counters + blockIdx.y, gridDim.x, sc, out);
}

template <typename BinT>
cudaError_t launch(int device, dim3 grid, size_t smem, cudaStream_t stream,
                   const void* bins, const float* stats, const float* amax,
                   int log2_rows, const int32_t* seg_dev, long long s0_host,
                   long long cnt_host, long long n, int p, int num_bins,
                   int group_feats, int windows, int win_bins, int tile,
                   int staged, long long* acc, int* counters, float* out) {
  static size_t limit[64];
  auto kernel = hist_segment_kernel<BinT>;
  const cudaError_t err = allow_smem(kernel, device, smem, limit);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      (const BinT*)bins, stats, amax, log2_rows, seg_dev, s0_host, cnt_host,
      n, p, num_bins, group_feats, windows, win_bins, tile, staged, acc,
      counters, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch on `stream`; returns a CUDA error code (0 on success).
// seg_dev, when not null, overrides s0_host / cnt_host and the grid is
// sized for the largest segment, n rows; otherwise for cnt_host rows.
// amax (3,) f32 on the device; log2_rows = L with n <= 2^L. acc holds
// p * 3 * num_bins int64 and counters p * windows int32 (windows =
// ceil(num_bins / kWindowBins)), both zero, and both are zero again when
// the launch ends.
int gpb_hist_segment(int device, const void* bins, int bins_is_u8,
                     const float* stats, const float* amax, int log2_rows,
                     const int32_t* seg_dev, long long s0_host,
                     long long cnt_host, long long n, int p, int num_bins,
                     long long* acc, int* counters, float* out,
                     void* stream_ptr) {
  if (p < 1 || p > 65535 || num_bins < 1 || num_bins > kMaxSegmentBins
      || n < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int code_bytes = bins_is_u8 ? 1 : 4;
  bool staged = false;
  const int tile_max = max_tile_rows(p, code_bytes, &staged);
  int win_bins = num_bins;
  const int windows = plan_windows(num_bins, &win_bins);
  int group_feats = 1;
  const int groups = plan_groups(p, win_bins, &group_feats);
  if ((long long)groups * windows > 65535) return (int)cudaErrorInvalidValue;
  int tile = 32, row_blocks = 1;
  plan_rows(device, groups * windows, p, num_bins, seg_dev ? n : cnt_host,
            32, tile_max, &tile, &row_blocks);
  const dim3 grid(row_blocks, groups * windows);
  const size_t hist_bytes =
      (size_t)hist_words(group_feats, win_bins) * sizeof(unsigned);
  const size_t smem = 3 * (size_t)tile * sizeof(long long)
                      + ((hist_bytes + 15) & ~(size_t)15)
                      + (staged ? (size_t)tile * p * code_bytes + 32 : 0);
  if (bins_is_u8)
    err = launch<uint8_t>(device, grid, smem, stream, bins, stats, amax, log2_rows,
                          seg_dev, s0_host, cnt_host, n, p, num_bins,
                          group_feats, windows, win_bins, tile, staged, acc,
                          counters, out);
  else
    err = launch<int32_t>(device, grid, smem, stream, bins, stats, amax, log2_rows,
                          seg_dev, s0_host, cnt_host, n, p, num_bins,
                          group_feats, windows, win_bins, tile, staged, acc,
                          counters, out);
  return (int)err;
}

}  // extern "C"
