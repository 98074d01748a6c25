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
// the cells outside the lengths at -3.4e38.  A masked cell gives
// diag + (-3.4e38) = -3.4e38, so cand = up: a row at or beyond la
// repeats the row above and a column at or beyond lb repeats the column
// on its left.  F never falls along a row (a running max) or down a
// column (cand >= up), so max F is F[la-1, lb-1], and the kernel stops
// at the lengths and reads that one cell.
//
// What bounds it on the H100: by the count of chip_smoke.py, the DP
// cells at 11 float operations each (the substitution score, one add,
// three max) on the CUDA cores, 0.0056 ms at the test driver's human
// baseline (3600 pairs, about 9,400 cells each); the bytes are
// negligible.  In practice: the instructions the SMs issue for a large
// batch, and for a small one (240 pairs, a warp or two an SM) the
// latency of the longest pair's chain of steps.  PR 3's kernel (one row
// at a time: a 5-round shuffle scan and a second pass a row, every lane
// over ceil(Tb / 32) columns, an IEEE sqrtf a cell) ran at 2% of the
// bound there; this design at about 13% (PERF.md).
//
// The design, one warp per pair:
// * A wavefront across lanes.  Lane l holds nc adjacent columns and at
//   step t works row t - l, so one pair takes la + lanes - 1 steps.
//   From the lane on its left it receives, by one __shfl_up_sync a
//   step, F at that lane's last column for the same row, and keeps the
//   value received a step earlier as the diagonal of its first column.
//   Within the step it takes max(diag + s, up) for each column, their
//   running max, and only then the max with the received value, so the
//   chain from lane to lane is one shuffle and one max a step.  A row
//   outside [0, la) scores -3.4e38 as in the plain version, which leaves
//   a lane's F as it is (cand = up), so no step branches.
// * Columns a lane from the pair's own lb, nc = ceil(lb / 32) (an
//   unrolled instance for each nc up to the launch's maximum), lanes =
//   ceil(lb / nc): no step walks the padding of the table.
// * The substitution score from a table in shared memory, indexed by
//   the signed bin offset: code(a) - code(b), in bytes, with code(a) =
//   4 ((ay + ybin - 1)(2 xbin - 1) + ax + xbin - 1) and code(b) =
//   4 (by (2 xbin - 1) + bx): one integer subtraction and one load a
//   cell in place of a sqrtf.  The wrapper builds the table with the
//   plain version's own expression, so each entry is the float the plain
//   version computes, and puts -3.4e38 entries behind it for the code of
//   a masked row.  A pair with a symbol outside [0, xbin * ybin) (there
//   the offset leaves the table) computes s as the plain version does,
//   sqrtf and all; so does every pair when the wrapper passes no table.
// * A's row codes reach each lane through a 64-entry ring in shared
//   memory, two 32-row windows filled a window ahead, and the next
//   step's scores are loaded at the start of each step, so the loads
//   overlap the step's max chain.
// * One warp a block for a small batch, four for a large one (the
//   wrapper chooses), so a small batch spreads over the SMs.
//
// Why the result is bit-exact with the TPU kernel and the plain
// version: (1) every s is the same float: the table's entries are the
// plain version's own expression on the same small integer
// coordinates, and the direct path writes it with __fmul_rn/__fadd_rn
// (no FMA contraction) and IEEE sqrtf, since the library is built
// without fast math; the final division is IEEE too.  (2) Each F cell
// is a max over floats that are each one float add (F[i-1, k-1] + s)
// or an F of the row above.  max is exact, associative and commutative,
// so the wavefront's grouping gives the value of the row-by-row running
// max.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;       // pairs a block, one warp each
constexpr int kRing = 64;          // A's row codes staged a warp
constexpr int kTableCap = 1536;    // floats of the shared score table
constexpr float kNeg = -3.4e38f;   // a masked cell's score

struct NwArgs {
  const int* seq_a;
  const int* len_a;
  const int* seq_b;
  const int* len_b;
  const float* table;  // ops/nw.py::kernel_table, or null
  float* out;
  int B, Ta, Tb, xbin, ybin;
  int table_len;  // floats of the table (a multiple of 4), 0 without one
  float threshold;
};

__device__ __forceinline__ void bin_xy(int s, int xbin, int& x, int& y) {
  // floor division and modulo (Python's // and %, as the TPU kernel and
  // the plain version compute them)
  int q = s / xbin;
  int r = s - q * xbin;
  if (r < 0) {
    r += xbin;
    q -= 1;
  }
  x = r;
  y = q;
}

// The table path's codes, in bytes: code_a(a) - code_b(b) is the byte
// offset of s(a, b) in the table; code_b lies in [0, 4 c0], c0 = (n - 1)
// / 2 for the n = (2 ybin - 1)(2 xbin - 1) scores, and the code of a
// masked row, 4 (n + c0), reaches only the -3.4e38 entries behind them.
__device__ __forceinline__ int code_a(int s, const NwArgs& p) {
  int x, y;
  bin_xy(s, p.xbin, x, y);
  return 4 * ((y + p.ybin - 1) * (2 * p.xbin - 1) + x + p.xbin - 1);
}

__device__ __forceinline__ int code_b(int s, const NwArgs& p) {
  int x, y;
  bin_xy(s, p.xbin, x, y);
  return 4 * (y * (2 * p.xbin - 1) + x);
}

__device__ __forceinline__ int masked_row_code(const NwArgs& p) {
  const int n = (2 * p.ybin - 1) * (2 * p.xbin - 1);
  return 4 * (n + (n - 1) / 2);
}

__device__ __forceinline__ float direct_score(float ax, float ay, float bx,
                                              float by, float threshold) {
  const float dx = ax - bx;
  const float dy = ay - by;
  return threshold - sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// F[la-1, lb-1] of one pair, on every lane; NC columns a lane,
// lb <= 32 * NC.  kTable: s from the shared table (every symbol of the
// pair in range); else computed.
template <bool kTable, int NC>
__device__ float pair_dp(const NwArgs& p, const float* tab, int* ring,
                         int pair, int la, int lb, int lane) {
  const int lanes = (lb + NC - 1) / NC;
  const int j0 = lane * NC;
  const int* sa = p.seq_a + static_cast<size_t>(pair) * p.Ta;
  const int* sb = p.seq_b + static_cast<size_t>(pair) * p.Tb;
  // The ring holds A's code (table) or symbol (direct) of row i at
  // i % kRing.  A row outside [0, la) scores -3.4e38, the plain version's
  // mask: there cand = up, so a lane before its first row keeps
  // F[-1, .] = 0 and no step needs a branch.  The table path gets that
  // from the masked row's code, the direct path from a select.
  const int pad = kTable ? masked_row_code(p) : 0;
  auto a_of = [&](int sym) { return kTable ? code_a(sym, p) : sym; };

  int bc[NC];            // table: B's codes
  float bx[NC], by[NC];  // direct: B's coordinates
  float f[NC], s[NC], sn[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int j = j0 + c;
    // a column at or beyond lb takes symbol 0: its F is never read
    const int sym = j < lb ? sb[j] : 0;
    if constexpr (kTable) {
      bc[c] = code_b(sym, p);
    } else {
      int x, y;
      bin_xy(sym, p.xbin, x, y);
      bx[c] = static_cast<float>(x);
      by[c] = static_cast<float>(y);
    }
    f[c] = 0.f;  // F[-1, j]
  }
  auto scores = [&](int i, float* out) {
    const int a = ring[i & (kRing - 1)];
    if constexpr (kTable) {
      const char* base = reinterpret_cast<const char*>(tab);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        out[c] = *reinterpret_cast<const float*>(base + (a - bc[c]));
    } else {
      const bool row = static_cast<unsigned>(i) < static_cast<unsigned>(la);
      int x, y;
      bin_xy(a, p.xbin, x, y);
      const float ax = static_cast<float>(x), ay = static_cast<float>(y);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        out[c] = row ? direct_score(ax, ay, bx[c], by[c], p.threshold) : kNeg;
    }
  };

  // rows 0..31 and the rows before 0; the next window waits in `next`
  __syncwarp();
  ring[lane] = lane < la ? a_of(sa[lane]) : pad;
  ring[32 + lane] = pad;
  int next = 32 + lane < la ? sa[32 + lane] : 0;
  __syncwarp();
  scores(0 - lane, s);

  float left_prev = 0.f;  // F[i-1, j0-1]
  float left_cur = 0.f;   // F[i, j0-1]
  const int steps = la + lanes - 1;
#pragma unroll 2
  for (int t = 0; t < steps; ++t) {
    // row i = t - lane now; the next row's scores load meanwhile
    scores(t + 1 - lane, sn);
    float cand[NC];
    float diag = left_prev;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      cand[c] = fmaxf(diag + s[c], f[c]);
      diag = f[c];
    }
#pragma unroll
    for (int c = 1; c < NC; ++c) cand[c] = fmaxf(cand[c - 1], cand[c]);
#pragma unroll
    for (int c = 0; c < NC; ++c) f[c] = fmaxf(left_cur, cand[c]);
    left_prev = left_cur;
    left_cur = __shfl_up_sync(kFull, f[NC - 1], 1);
    if (lane == 0) left_cur = 0.f;  // F[i, -1] = 0, the floor of the max
    if ((t & 31) == 30) {
      // rows t+2..t+33 replace rows t-62..t-31, which no lane reads again
      const int r = t + 2 + lane;
      __syncwarp();
      ring[r & (kRing - 1)] = r < la ? a_of(next) : pad;
      next = r + 32 < la ? sa[r + 32] : 0;
      __syncwarp();
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] = sn[c];
  }

  // the last lane did row la - 1 in the last step
  const int col = lb - 1 - (lanes - 1) * NC;
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (c == col) v = f[c];
  return __shfl_sync(kFull, v, lanes - 1);
}

// pair_dp with the fewest columns a lane that hold lb, up to CHMAX.
template <int CHMAX>
__device__ float dispatch(const NwArgs& p, const float* tab, int* ring,
                          int pair, int la, int lb, int lane, bool table) {
  if (!table) return pair_dp<false, CHMAX>(p, tab, ring, pair, la, lb, lane);
  const int nc = (lb + 31) / 32;
#define SP_NW_CASE(N)                                                  \
  if (N <= CHMAX && nc <= N)                                           \
    return pair_dp<true, (N <= CHMAX ? N : CHMAX)>(p, tab, ring, pair, \
                                                   la, lb, lane);
  SP_NW_CASE(1)
  SP_NW_CASE(2)
  SP_NW_CASE(3)
  SP_NW_CASE(4)
  SP_NW_CASE(5)
  SP_NW_CASE(6)
  SP_NW_CASE(7)
  SP_NW_CASE(8)
  SP_NW_CASE(12)
  SP_NW_CASE(16)
  SP_NW_CASE(24)
#undef SP_NW_CASE
  return pair_dp<true, CHMAX>(p, tab, ring, pair, la, lb, lane);
}

template <int CHMAX>
__global__ void __launch_bounds__(32 * kMaxWarps) nw_kernel(NwArgs p) {
  __shared__ __align__(16) float tab[kTableCap];
  __shared__ int rings[kMaxWarps][kRing];
#pragma unroll 4
  for (int k = threadIdx.x; k < p.table_len / 4; k += blockDim.x)
    reinterpret_cast<float4*>(tab)[k] =
        reinterpret_cast<const float4*>(p.table)[k];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.x * (blockDim.x >> 5) + warp;
  if (pair >= p.B) return;  // the whole warp leaves together
  const int la_raw = p.len_a[pair];
  const int lb_raw = p.len_b[pair];
  const int la = min(max(la_raw, 0), p.Ta);
  const int lb = min(max(lb_raw, 0), p.Tb);
  float best = 0.f;
  if (la > 0 && lb > 0) {
    // the table holds the offsets of in-range bins only
    bool ok = p.table_len > 0;
    const long long bins = static_cast<long long>(p.xbin) * p.ybin;
    const int* sa = p.seq_a + static_cast<size_t>(pair) * p.Ta;
    const int* sb = p.seq_b + static_cast<size_t>(pair) * p.Tb;
    // (no early exit, so the loads of a lane overlap)
#pragma unroll 8
    for (int k = lane; k < la; k += 32) ok &= sa[k] >= 0 && sa[k] < bins;
#pragma unroll 8
    for (int k = lane; k < lb; k += 32) ok &= sb[k] >= 0 && sb[k] < bins;
    best = dispatch<CHMAX>(p, tab, rings[warp], pair, la, lb, lane,
                           __all_sync(kFull, ok));
  }
  if (lane == 0) {
    const float scale = p.threshold * static_cast<float>(max(la_raw, lb_raw));
    p.out[pair] = scale > 0.f ? best / scale : nanf("");
  }
}

}  // namespace

// seq_a [B, Ta], seq_b [B, Tb], len_a, len_b [B]: int32; table: null or
// the (2 ybin - 1)(2 xbin - 1) scores by bin offset followed by -3.4e38
// entries (ops/nw.py::kernel_table), table_len floats; out [B] float32;
// all on CUDA device `device`.  chmax (1, 8 or 32) bounds the columns a
// lane, Tb <= 32 * chmax; warps (1-4) pairs a block.  Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int sp_nw_scores_bins(const void* seq_a, const void* len_a,
                                 const void* seq_b, const void* len_b,
                                 const void* table, void* out, int B, int Ta,
                                 int Tb, int xbin, int ybin, int table_len,
                                 int chmax, int warps, int device,
                                 float threshold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const long long n = (2LL * ybin - 1) * (2LL * xbin - 1);
  if (!table) table_len = 0;
  if (xbin <= 0 || warps < 1 || warps > kMaxWarps || Ta < 0 || Tb < 0 ||
      Tb > 32 * chmax || table_len < 0 || table_len % 4 ||
      table_len > kTableCap ||
      (table_len && (ybin <= 0 || table_len < n + (n + 1) / 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  NwArgs p{static_cast<const int*>(seq_a), static_cast<const int*>(len_a),
           static_cast<const int*>(seq_b), static_cast<const int*>(len_b),
           static_cast<const float*>(table), static_cast<float*>(out),
           B, Ta, Tb, xbin, ybin, table_len, threshold};
  const int blocks = (B + warps - 1) / warps;
  // launch on the tensors' device (the wrapper passes its current stream)
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (chmax) {
    case 1:
      nw_kernel<1><<<blocks, 32 * warps, 0, st>>>(p);
      break;
    case 8:
      nw_kernel<8><<<blocks, 32 * warps, 0, st>>>(p);
      break;
    case 32:
      nw_kernel<32><<<blocks, 32 * warps, 0, st>>>(p);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
