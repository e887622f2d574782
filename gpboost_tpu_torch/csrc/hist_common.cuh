// Shared accumulation core of the histogram kernels (histogram.cu,
// hist_masked.cu): deterministic fixed-point sums in shared memory, one
// flush to a global int64 accumulator, and a last-block finish, so each
// histogram is one launch with no partial buffer and no second pass.
//
// Fixed point. For each stat channel c the scale is 2^k_c with
//   k_c = 62 - L - e_c,  n <= 2^L,  max|v_c| < 2^e_c  (frexp's exponent),
// so every quantised value |round(v * 2^k_c)| <= 2^(62 - L) and any sum of
// at most n of them stays within 2^62: no int64 overflow for any row set
// of the input. v * 2^k_c is exact in double (a float times a power of
// two), rounding is to nearest even, and the sums are integer adds, which
// are associative: shared and global atomicAdd give the same bits in any
// order, for any grid. The result is f32(double(sum) * 2^-k_c), with an
// error of at most n * 2^-(k_c + 1) per bin, ~1e-8 of max|v_c| at
// n = 200,000. Counts stay exact. A channel whose max|v_c| is not finite
// (a NaN or an infinity among its stats) comes out NaN in every bin; the
// channel's stats are not quantised. ops/histogram.py
// `hist_*_fixed_point_reference` repeat this arithmetic in plain torch.
//
// Why not tensor cores: the TPU kernels build a (B x R) one-hot and
// contract it on the MXU because the TPU has no fast scatter; on Hopper
// that is 256x the work of a scatter, and TF32 would round the stats to a
// 10-bit mantissa. The bin codes are a gather, so plain coalesced 16-byte
// loads serve and TMA is not needed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gpb {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 4096;             // one feature's histogram: 96 KB
// hist_segment takes more bins (an EFB bundle of many features) in
// windows of at most kMaxBins: each block owns one window of its features'
// bins and skips the codes outside it
constexpr int kWindowBins = kMaxBins;
constexpr int kMaxSegmentBins = 1 << 20;
constexpr int kHistBudget = 48 * 1024;     // shared histogram bytes a block
constexpr int kBlocksPerSm = 2;
// bins a launch may flush to the global accumulator: row blocks per
// feature group <= kFlushBudget / (p * 3 * B), 33 at p = 50, B = 255
constexpr long long kFlushBudget = 1280000;

typedef unsigned long long u64;

// Per-channel scale of one launch, in shared memory.
struct Scale {
  double up[3];     // 2^k_c
  double down[3];   // 2^-k_c
  int finite[3];
};

// Threads 0-2 fill channel threadIdx.x; the caller syncs before use.
__device__ inline void load_scale(Scale* s, const float* amax,
                                  int log2_rows) {
  const int c = threadIdx.x;
  if (c < 3) {
    const float a = fabsf(amax[c]);
    const int fin = isfinite(a) ? 1 : 0;
    int e = 0;
    if (fin) frexp((double)a, &e);
    const int k = 62 - log2_rows - e;
    s->up[c] = ldexp(1.0, k);
    s->down[c] = ldexp(1.0, -k);
    s->finite[c] = fin;
  }
}

__device__ inline long long quantize(float v, const Scale& s, int c) {
  return s.finite[c] ? __double2ll_rn((double)v * s.up[c]) : 0LL;
}

// Shared memory holds the block's histograms as 32-bit words, for each
// feature and channel the B low words, then the B high words of the int64
// sums: the low words, which take the atomics that return, spread over
// all 32 banks. hist_words(g, B) words in all.
__host__ __device__ inline int hist_words(int g, int num_bins) {
  return g * 3 * 2 * num_bins;
}

__device__ inline void zero_hist(unsigned* h, int words) {
  for (int j = threadIdx.x; j < words; j += blockDim.x) h[j] = 0;
}

// Adds v to the int64 held as (*lo, *hi) in shared memory with native
// 32-bit atomics (a 64-bit shared atomicAdd is a compare-and-swap loop):
// the low word's atomicAdd returns the old word, which gives its carry
// exactly, and the high word takes v's high word plus that carry. Every
// carry is counted once, so the pair holds the sum mod 2^64 for any order
// of the adds.
__device__ inline void add_shared64(unsigned* lo, unsigned* hi, long long v) {
  const unsigned vl = (unsigned)v;
  unsigned vh = (unsigned)((u64)v >> 32);
  if (vl) {
    const unsigned old = atomicAdd(lo, vl);
    vh += old + vl < old ? 1u : 0u;
  }
  if (vh) atomicAdd(hi, vh);
}

// Adds one row to one feature's histogram h (3 x 2 x num_bins words);
// codes outside [0, num_bins) count nowhere, as in the one-hot reference.
__device__ inline void add_row(unsigned* h, int num_bins, int b,
                               long long q0, long long q1, long long q2) {
  if ((unsigned)b >= (unsigned)num_bins) return;
  const int B = num_bins;
  if (q0) add_shared64(&h[b], &h[B + b], q0);
  if (q1) add_shared64(&h[2 * B + b], &h[3 * B + b], q1);
  if (q2) add_shared64(&h[4 * B + b], &h[5 * B + b], q2);
}

// Called by every thread of every block after its last add (and a
// __syncthreads). Adds the block's non-zero bins of features
// [f0, f0 + g), bins [w0, w0 + wn) of num_bins, into acc, then takes a
// ticket on its (feature group, window)'s counter. The last block of the
// group and window converts that part of the accumulator to f32 into out
// and zeroes it and the counter again, so the cached scratch is ready for
// the next launch on the stream. s_hist holds wn bins a channel.
__device__ inline void finish_window(const unsigned* s_hist, bool has_rows,
                                     int f0, int g, int w0, int wn,
                                     int num_bins, long long* acc,
                                     int* counter, int blocks_in_group,
                                     const Scale& sc, float* out) {
  __shared__ int s_last;
  const int len = g * 3 * wn;
  // entry j of the window: row j / wn of the group's (feature, channel)
  // rows, bin w0 + j % wn
  long long* acc_g = acc + (long long)f0 * 3 * num_bins + w0;
  if (has_rows) {
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      const int r = j / wn, b = j - r * wn;
      const int w = r * 2 * wn + b;
      const u64 v = (u64)s_hist[w] | ((u64)s_hist[w + wn] << 32);
      if (v) atomicAdd((u64*)&acc_g[(long long)r * num_bins + b], v);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(counter, 1) == blocks_in_group - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* out_g = out + (long long)f0 * 3 * num_bins + w0;
  constexpr int kUnroll = 8;                 // loads in flight per thread
  for (int j0 = 0; j0 < len; j0 += kUnroll * blockDim.x) {
    long long v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x + threadIdx.x;
      const int r = j / wn;
      v[u] = j < len ? __ldcg(&acc_g[(long long)r * num_bins + j - r * wn])
                     : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * blockDim.x + threadIdx.x;
      if (j >= len) break;
      const int r = j / wn;
      const long long at = (long long)r * num_bins + j - r * wn;
      const int c = r % 3;
      out_g[at] = sc.finite[c]
                      ? __double2float_rn(__ll2double_rn(v[u]) * sc.down[c])
                      : __int_as_float(0x7fc00000);   // quiet NaN
      acc_g[at] = 0;
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

// finish_window over all num_bins bins of the features.
__device__ inline void finish(const unsigned* s_hist, bool has_rows,
                              int f0, int g, int num_bins, long long* acc,
                              int* counter, int blocks_in_group,
                              const Scale& sc, float* out) {
  finish_window(s_hist, has_rows, f0, g, 0, num_bins, num_bins, acc,
                counter, blocks_in_group, sc, out);
}

// Bin windows of a histogram of num_bins bins: (count, bins per window),
// one window up to kWindowBins, else as few as hold at most kWindowBins
// each, evenly sized.
inline int plan_windows(int num_bins, int* win_bins) {
  const int windows = (num_bins + kWindowBins - 1) / kWindowBins;
  *win_bins = (num_bins + windows - 1) / windows;
  return windows;
}

// Features per block: as many whole histograms as kHistBudget holds,
// spread evenly over the groups. Returns the group count.
inline int plan_groups(int p, int num_bins, int* group_feats) {
  int g = kHistBudget / (24 * num_bins);
  g = g < 1 ? 1 : (g > p ? p : g);
  const int groups = (p + g - 1) / g;
  *group_feats = (p + groups - 1) / groups;
  return groups;
}

inline int sm_count(int device) {
  static int sms[64] = {0};
  int* s = device >= 0 && device < 64 ? &sms[device] : nullptr;
  int count = s ? *s : 0;
  if (count == 0) {
    if (cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || count < 1)
      count = 132;
    if (s) *s = count;
  }
  return count;
}

// Rows per tile (a multiple of quantum, at most tile_max) and row blocks
// per feature group for `rows` rows: enough blocks for kBlocksPerSm on
// every SM, no more than kFlushBudget allows, and at most one per tile, so
// a small input is spread over many small tiles and a large one walks
// large tiles.
inline void plan_rows(int device, int groups, int p, int num_bins,
                      long long rows, int quantum, int tile_max, int* tile,
                      int* row_blocks) {
  long long r = (kBlocksPerSm * (long long)sm_count(device) + groups - 1)
                / groups;
  const long long cap = kFlushBudget / ((long long)p * 3 * num_bins);
  if (r > cap) r = cap;
  if (r < 1) r = 1;
  long long t = (rows + r - 1) / r;
  t = (t + quantum - 1) / quantum * quantum;
  if (t > tile_max) t = tile_max;
  if (t < quantum) t = quantum;
  const long long tiles = (rows + t - 1) / t;
  if (r > tiles) r = tiles;
  *tile = (int)t;
  *row_blocks = r < 1 ? 1 : (int)r;
}

// Raises a kernel's dynamic shared memory limit where a launch needs more
// than the default 48 KB; `limit` remembers what was set on each device.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int device, size_t bytes,
                              size_t* limit) {
  size_t* l = device >= 0 && device < 64 ? &limit[device] : nullptr;
  if (bytes <= 48 * 1024 || (l && bytes <= *l)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && l) *l = bytes;
  return err;
}

}  // namespace gpb
