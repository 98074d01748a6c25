// Batched Needleman-Wunsch ScanMatch score with gap 0, for Hopper (sm_90a).
//
// Replaces scanpaths_tpu/ops/pallas_nw.py::nw_scores_bins (body
// _nw_kernel).  For each pair, with symbols raster-ordered on xbin
// columns, bin coordinates (s mod xbin, s div xbin) and la, lb clamped
// to [0, Ta] and [0, Tb]:
//
//   s[i, j] = threshold - sqrt((ax_i - bx_j)^2 + (ay_i - by_j)^2)
//   F[i, j] = max(0, max_{k <= j} max(F[i-1, k-1] + s[i, k], F[i-1, k]))
//             with F[-1, .] = F[., -1] = 0
//   out     = max F / (threshold * max(la, lb)),  NaN when that is <= 0
//
// over i < la, j < lb.  The TPU kernel runs the full padded table with
// the cells outside the lengths at -3.4e38.  Stopping at the lengths is
// an exact shortcut: a masked cell gives diag + (-3.4e38) = -3.4e38, so
// cand = up; a row at or beyond la then reproduces the previous row
// (already a running max, and >= 0), and a column at or beyond lb only
// carries the running max of the columns before it.  Neither can raise
// max F.
//
// What bounds it on the H100: the DP cells, about 11 float operations
// each (the substitution score, one add, four max) on the CUDA cores,
// and the la rows of a pair, which depend on each other.  The bytes are
// negligible: the symbols are read once and one float is written per
// pair.  At the device sweep's shapes (3600 pairs, tables of 256
// symbols a side) the full tables would be 2.4e8 cells, 2.6e9
// operations, 0.04 ms at the 67 TFLOP/s float32 peak; the real lengths
// need fewer.  The row chain is the longer bound: each of up to 256
// rows waits on a shuffle scan of the row before it.
//
// The design: one warp per pair (the sweep scores thousands of pairs,
// so the card fills); lane l holds columns [l*CH, l*CH + CH) of the
// current row in registers, with B's bin coordinates beside them.  The
// row loop runs inside the kernel; A's coordinates for 32 rows are
// loaded one per lane and broadcast by shuffle.  The in-row prefix max
// is a sequential max over the lane's chunk, then a __shfl_up_sync scan
// of the lane totals, then a combine.  F[i-1, j-1] for the first column
// of a chunk comes from the lane on the left by shuffle.  The TPU
// kernel's lane rolls and 128-lane padding are TPU layout and are not
// carried over.
//
// Why the result is bit-exact with the TPU kernel and the plain
// version: (1) the bin coordinates are small non-negative integers, so
// their differences, squares and the sum of squares are exact in float
// (the products are also written __fmul_rn/__fadd_rn so that no FMA
// contraction applies), and sqrtf and the final division are IEEE
// round-to-nearest, since the library is built without fast math; so
// every s is the same float.  (2) Each F cell is a max over floats that
// are each one float add (F[i-1, k-1] + s) or an F of the row above.
// max is exact, associative and commutative, so the chunk / scan /
// combine grouping gives the same value as the row-by-row running max.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;  // pairs per block, one warp each
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void bin_xy(int s, int xbin, float& x, float& y) {
  // floor division and modulo (Python's // and %, as the TPU kernel and
  // the plain version compute them)
  int q = s / xbin;
  int r = s - q * xbin;
  if (r < 0) {
    r += xbin;
    q -= 1;
  }
  x = static_cast<float>(r);
  y = static_cast<float>(q);
}

template <int CH>
__global__ void __launch_bounds__(32 * kWarps)
    nw_kernel(const int* __restrict__ seq_a, const int* __restrict__ len_a,
              const int* __restrict__ seq_b, const int* __restrict__ len_b,
              float* __restrict__ out, int B, int Ta, int Tb, int xbin,
              float threshold) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= B) return;  // the whole warp leaves together
  const int la_raw = len_a[pair];
  const int lb_raw = len_b[pair];
  const int la = min(max(la_raw, 0), Ta);
  const int lb = min(max(lb_raw, 0), Tb);
  const int j0 = lane * CH;

  float bx[CH], by[CH], f[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int j = j0 + c;
    bin_xy(j < lb ? seq_b[(size_t)pair * Tb + j] : 0, xbin, bx[c], by[c]);
    f[c] = 0.f;  // F[-1, j]
  }

  float best = 0.f;
  for (int i0 = 0; i0 < la; i0 += 32) {
    float ax_l, ay_l;
    const int ia = i0 + lane;
    bin_xy(ia < la ? seq_a[(size_t)pair * Ta + ia] : 0, xbin, ax_l, ay_l);
    const int rows = min(32, la - i0);
    for (int r = 0; r < rows; ++r) {
      const float ax = __shfl_sync(kFull, ax_l, r);
      const float ay = __shfl_sync(kFull, ay_l, r);
      // F[i-1, j0-1], the last column of the left lane's chunk
      float diag = __shfl_up_sync(kFull, f[CH - 1], 1);
      if (lane == 0) diag = 0.f;
      float run = 0.f;  // the floor max(., 0) enters as the running max's start
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (j0 + c < lb) {
          const float dx = ax - bx[c];
          const float dy = ay - by[c];
          const float s =
              threshold - sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
          const float up = f[c];
          run = fmaxf(run, fmaxf(diag + s, up));
          diag = up;
          f[c] = run;
        }
      }
      // running max of the lane totals, exclusive of this lane
      float incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl = fmaxf(incl, o);
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (j0 + c < lb) {
          f[c] = fmaxf(f[c], excl);
          best = fmaxf(best, f[c]);
        }
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    best = fmaxf(best, __shfl_xor_sync(kFull, best, d));
  if (lane == 0) {
    const float scale = threshold * static_cast<float>(max(la_raw, lb_raw));
    out[pair] = scale > 0.f ? best / scale : nanf("");
  }
}

template <int CH>
int launch(const void* seq_a, const void* len_a, const void* seq_b,
           const void* len_b, void* out, int B, int Ta, int Tb, int xbin,
           float threshold, cudaStream_t stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  nw_kernel<CH><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const int*>(seq_a), static_cast<const int*>(len_a),
      static_cast<const int*>(seq_b), static_cast<const int*>(len_b),
      static_cast<float*>(out), B, Ta, Tb, xbin, threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// seq_a [B, Ta], seq_b [B, Tb], len_a, len_b [B]: int32; out [B] float32.
// Tb <= 1024 (32 columns a lane).  Returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int sp_nw_scores_bins(const void* seq_a, const void* len_a,
                                 const void* seq_b, const void* len_b,
                                 void* out, int B, int Ta, int Tb, int xbin,
                                 float threshold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (xbin <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int per_lane = (Tb + 31) / 32;
#define SP_NW_LAUNCH(CH)                                                     \
  if (per_lane <= CH)                                                        \
    return launch<CH>(seq_a, len_a, seq_b, len_b, out, B, Ta, Tb, xbin,      \
                      threshold, st);
  SP_NW_LAUNCH(1)
  SP_NW_LAUNCH(2)
  SP_NW_LAUNCH(4)
  SP_NW_LAUNCH(8)
  SP_NW_LAUNCH(16)
  SP_NW_LAUNCH(32)
#undef SP_NW_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
