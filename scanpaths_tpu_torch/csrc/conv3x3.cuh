// Implicit-GEMM convolution tile shared by cell.cu and block.cu.
//
// One thread block computes a kRows<T> x BN tile of  out[p, col] =
// sum_{tap, k} in[pixel p shifted by tap, k] * w[tap * Cin + k, col]
// over a dense NHWC input, where the tap set is either the 3x3 window
// (TAPS = 9, dilation `dil`, zero fill outside the image) or the single
// centre tap (TAPS = 1: a 1x1 convolution, i.e. a plain GEMM over the
// pixels).  The weight is a row-major [TAPS * Cin, ldw] matrix: the HWIO
// kernel flattened tap-major.  Sums accumulate in float, and the
// caller's epilogue receives the finished accumulators.
//
// Two inner loops, chosen by the element type:
// * float: CUDA-core FMAs on tiles staged in shared memory as float, so
//   results match a float32 reference computed without TF32;
// * bf16: tensor cores (WMMA 16x16x16, float accumulation) on tiles of
//   128 rows, 8 warps on a 4 x 2 grid of 32x32 warp tiles, the next K
//   chunk's global loads prefetched into registers while the current
//   chunk computes; the accumulators are staged through shared memory
//   (reusing the tile memory) to reach the epilogue in the same
//   per-thread layout as the float path.
//
// Epilogue layout: 256 threads as 16 (tx) x 16 (ty).  Thread (tx, ty)
// receives tile rows 64*r + 4*ty .. 64*r + 4*ty+3 (r < kRows<T> / 64)
// and the four column slots 4*tx .. 4*tx+3.  A column map (DenseCols /
// GateCols) says which weight column each local column l of the tile
// reads and which slot it lands in, so one routine serves the plain GEMMs of the bottleneck and the
// gate-interleaved GEMM of the ConvLSTM cell (all four gates of one
// channel reach one thread).
//
// Requirements (checked by the Python wrappers): Cin % 32 == 0, the
// weight columns a tile reads lie in groups of 8 contiguous columns,
// ldw % 8 == 0, and every pointer 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace sp {

constexpr int BN = 64;   // weight columns per tile
constexpr int BK = 32;   // contraction chunk, inside one tap
constexpr int NTHREADS = 256;

// pixels (GEMM rows) per tile: 64 on the CUDA cores, 128 on the tensor
// cores
template <typename T>
constexpr int kRows = std::is_same<T, __nv_bfloat16>::value ? 128 : 64;

static __device__ __forceinline__ float to_f32(float v) { return v; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 8 contiguous elements as one register value (32 bytes of float or
// 16 bytes of bf16)
template <typename T>
struct Vec8;
template <>
struct Vec8<float> {
  float4 lo, hi;
};
template <>
struct Vec8<__nv_bfloat16> {
  uint4 v;
};

// Local column l -> weight column n0 + l, slot l (thread tx owns weight
// columns n0 + 4*tx .. n0 + 4*tx + 3).  Columns at or past `ncols` read
// as zero and are never handed to the epilogue as valid.
struct DenseCols {
  static constexpr bool kContiguous = true;  // slot(l + e) == slot(l) + e
  int n0, ncols;
  __device__ int col(int l) const { return n0 + l; }
  __device__ bool valid(int l) const { return n0 + l < ncols; }
  __device__ int slot(int l) const { return l; }
};

// Local column l = g*16 + j -> weight column g*C + c0 + j (gate g of
// channel c0 + j), slot 4*j + g: thread tx holds the four gates of
// channel c0 + tx.
struct GateCols {
  static constexpr bool kContiguous = false;
  int c0, C;
  __device__ int col(int l) const { return (l >> 4) * C + c0 + (l & 15); }
  __device__ bool valid(int) const { return true; }
  __device__ int slot(int l) const { return (l & 15) * 4 + (l >> 4); }
};

template <typename T>
struct ConvArgs {
  const T* __restrict__ in;  // [N, H, W, Cin]
  const T* __restrict__ w;   // [TAPS * Cin, ldw]
  int N, H, W, Cin, dil, ldw;
};

// Per-thread global loads of one K chunk: 8 channels of kRows<T>/64
// pixel rows of the A tile, and 8 columns of one contraction row of the
// B tile.
template <typename T, int TAPS, typename Cols>
struct ChunkLoader {
  static constexpr int RA = kRows<T> / 64;
  const ConvArgs<T>& a;
  int ar, ak, an[RA], ay[RA], ax[RA], bk, bl, bcol;
  bool arow[RA], bvalid;

  __device__ ChunkLoader(const ConvArgs<T>& args, int p0, const Cols& cols,
                         int tid)
      : a(args) {
    ar = tid & 63;
    ak = (tid >> 6) * 8;
    const int hw = a.H * a.W;
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int p = p0 + ar + 64 * r;
      arow[r] = p < a.N * hw;
      an[r] = ay[r] = ax[r] = 0;
      if (arow[r]) {
        an[r] = p / hw;
        const int rem = p - an[r] * hw;
        ay[r] = rem / a.W;
        ax[r] = rem - ay[r] * a.W;
      }
    }
    bk = tid >> 3;
    bl = (tid & 7) * 8;
    bvalid = cols.valid(bl);
    bcol = cols.col(bl);
  }

  __device__ int chunks() const { return TAPS * (a.Cin / BK); }

  __device__ void load(int c, Vec8<T>* av, Vec8<T>& bv) const {
    const int per_tap = a.Cin / BK;
    const int tap = c / per_tap;
    const int k0 = (c - tap * per_tap) * BK;
    const int dy = TAPS == 9 ? (tap / 3 - 1) * a.dil : 0;
    const int dx = TAPS == 9 ? (tap % 3 - 1) * a.dil : 0;
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int yy = ay[r] + dy, xx = ax[r] + dx;
      if (arow[r] && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) {
        av[r] = *reinterpret_cast<const Vec8<T>*>(
            a.in + ((size_t)(an[r] * a.H + yy) * a.W + xx) * a.Cin + k0 + ak);
      } else {
        av[r] = Vec8<T>{};
      }
    }
    if (bvalid) {
      bv = *reinterpret_cast<const Vec8<T>*>(
          a.w + ((size_t)tap * a.Cin + k0 + bk) * a.ldw + bcol);
    } else {
      bv = Vec8<T>{};
    }
  }
};

// float: CUDA-core FMAs, A staged transposed (As[k][row]).
template <int TAPS, typename Cols, typename Epi>
__device__ __forceinline__ void conv_igemm_simt(const ConvArgs<float>& a,
                                                int p0, const Cols& cols,
                                                Epi epi) {
  constexpr int BM = kRows<float>;
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const ChunkLoader<float, TAPS, Cols> ld(a, p0, cols, tid);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nchunks = ld.chunks();
  for (int c = 0; c < nchunks; ++c) {
    Vec8<float> av, bv;
    ld.load(c, &av, bv);
    __syncthreads();  // the previous chunk's reads are done
    const float* ae = reinterpret_cast<const float*>(&av);
    const float* be = reinterpret_cast<const float*>(&bv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      As[ld.ak + e][ld.ar] = ae[e];
      Bs[ld.bk][cols.slot(ld.bl + e)] = be[e];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 x4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 w4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float xa[4] = {x4.x, x4.y, x4.z, x4.w};
      const float wb[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
    }
  }

  const int P = a.N * a.H * a.W;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p < P) epi(p, tx, acc[i]);
  }
}

// bf16: tensor cores.  Warp w computes tile rows 32*(w%4) .. +32 and
// column slots 32*(w/4) .. +32 as 2 x 2 WMMA 16x16 accumulators.
template <int TAPS, typename Cols, typename Epi>
__device__ __forceinline__ void conv_igemm_tc(
    const ConvArgs<__nv_bfloat16>& a, int p0, const Cols& cols, Epi epi) {
  namespace wmma = nvcuda::wmma;
  using bf16 = __nv_bfloat16;
  constexpr int BM = kRows<bf16>;
  constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  // the A/B tiles during the K loop, the float accumulators after it
  __shared__ __align__(128)
      unsigned char smem[AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES];
  auto As = reinterpret_cast<bf16(*)[LDA]>(smem);
  auto Bs = reinterpret_cast<bf16(*)[LDB]>(smem + BM * LDA * 2);
  auto Cs = reinterpret_cast<float(*)[LDC]>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, wr = warp & 3, wc = warp >> 2;
  const ChunkLoader<bf16, TAPS, Cols> ld(a, p0, cols, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  Vec8<bf16> av[2], bv;
  const int nchunks = ld.chunks();
  ld.load(0, av, bv);
  for (int c = 0; c < nchunks; ++c) {
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint4*>(&As[ld.ar + 64 * r][ld.ak]) = av[r].v;
    if constexpr (Cols::kContiguous) {
      *reinterpret_cast<uint4*>(&Bs[ld.bk][cols.slot(ld.bl)]) = bv.v;
    } else {
      const bf16* be = reinterpret_cast<const bf16*>(&bv.v);
#pragma unroll
      for (int e = 0; e < 8; ++e) Bs[ld.bk][cols.slot(ld.bl + e)] = be[e];
    }
    __syncthreads();
    if (c + 1 < nchunks) ld.load(c + 1, av, bv);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wr * 32 + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &Bs[kk][wc * 32 + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  __syncthreads();  // every warp is done with As/Bs, which Cs reuses
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wr * 32 + i * 16][wc * 32 + j * 16],
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  const int tx = tid & 15, ty = tid >> 4;
  const int P = a.N * a.H * a.W;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 64 * r + ty * 4 + i;
      const float4 v4 = *reinterpret_cast<const float4*>(&Cs[row][tx * 4]);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      if (p0 + row < P) epi(p0 + row, tx, v);
    }
}

// Computes the kRows<T>-row tile whose first row is pixel p0 and calls
// epi(p, tx, acc[4]) for each of the thread's rows p < N*H*W.
template <typename T, int TAPS, typename Cols, typename Epi>
__device__ __forceinline__ void conv_igemm(const ConvArgs<T>& a, int p0,
                                           const Cols& cols, Epi epi) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    conv_igemm_tc<TAPS>(a, p0, cols, epi);
  } else {
    conv_igemm_simt<TAPS>(a, p0, cols, epi);
  }
}

}  // namespace sp
