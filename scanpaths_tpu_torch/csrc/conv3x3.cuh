// Implicit-GEMM convolution tiles shared by cell.cu and block.cu (the
// float32 cell kernel has a loop of its own in cell.cu, over the TMA and
// barrier helpers here).
//
// One thread block computes a 128-pixel x BN tile of
//   out[p, n] = sum_{tap, k} in[pixel p shifted by tap, k] * wt[n, tap*Cin + k]
// over a dense NHWC input, where the tap set is either the 3x3 window
// (TAPS = 9, dilation `dil`, zero fill outside the image: the conv's
// padding) or the single centre tap (TAPS = 1: a 1x1 convolution, i.e. a
// plain GEMM over the pixels).  The weight is packed K-contiguous: row n
// of `wt` [ncols, TAPS * Cin] holds output column n's taps, tap-major (the
// HWIO kernel flattened to [TAPS * Cin, ncols] and transposed).  Sums
// accumulate in float and the caller's epilogue gets the accumulators.
//
// Two main loops, chosen by the element type:
//
// * float (conv_igemm_f32): CUDA-core FMAs, so that results match a
//   float32 reference computed without TF32.  256 threads, a TM x BN
//   tile with a TM/16 x BN/16 register micro-tile, and a 3-stage cp.async
//   ring with one barrier per 32-deep K chunk.  The stage's products
//   run 64 x 64 (4 x 4 at three blocks an SM, which measured faster at
//   the stage's shapes than the wider tiles).  A and B both sit
//   K-contiguous in shared memory (row stride 36 floats), so the copies
//   land without transposing stores and each thread reads 16-byte
//   vectors along K from rows that fall in distinct banks.  Each
//   accumulator sums its K terms in one chain, in order (tap-major, then
//   channel).
//
// * bf16 (conv_igemm_wgmma): tensor cores through wgmma, warp
//   specialised.  384 threads: warpgroup 0 produces, warpgroups 1 and 2
//   each own 64 of the 128 pixel rows and issue wgmma.mma_async m64nBNk16
//   with f32 accumulators in registers (setmaxnreg moves registers from
//   the producer to them).  A ring of 4-8 stages (as many as fit 192 KB)
//   of a 128 x 64 A tile and a BN x 64 B tile, both 128-byte swizzled,
//   with mbarriers per stage (TMA landed, fixed up = full, released =
//   empty):
//   - B (the packed weight) comes in by TMA through a 3-D tensor map
//     [Cin, TAPS, ncols] built on the host per call (box 64 x 1 x rows;
//     out-of-range K and rows read as zero);
//   - A, the im2col rows of one tap and 64 channels, is one TMA box of the
//     activations seen as a [pixels, Cin] matrix, shifted by the tap: a
//     tap moves every pixel by the same number of rows.  The rows whose
//     tap leaves the image (the conv's zero padding, and the wrap into
//     the neighbouring image row) are then zeroed in shared memory by
//     three producer warps as soon as the stage lands, while one thread
//     of the fourth keeps the TMA ring full.  This serves any pixel
//     count, any width and the dilated taps, which TMA's tiled 4-D mode
//     would only for tiles of whole image rows.
//   After the last chunk the drained ring holds the epilogue's operands
//   (the cell's xg, c and signal weights), staged by TMA and cp.async, so
//   the epilogue reads shared memory instead of waiting on scattered
//   global loads.
//
// Requirements (checked by the Python wrappers): Cin % 32 == 0 (float) or
// % 8 == 0 (bf16), ncols % 2 == 0, pointers 16-byte aligned.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (header only, no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace sp {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;  // pixels (GEMM rows) per tile, both paths

static __device__ __forceinline__ float to_f32(float v) { return v; }
static __device__ __forceinline__ float to_f32(bf16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// V consecutive elements to and from float (V = 2 as one bf16x2 access)
template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float (&v)[V]) {
  if constexpr (std::is_same<T, bf16>::value && V == 2) {
    const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(x);
    v[1] = __high2float(x);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = to_f32(p[e]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_f32(T* p, const float (&v)[V]) {
  if constexpr (std::is_same<T, bf16>::value && V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = from_f32<T>(v[e]);
  }
}

template <typename T>
struct ConvArgs {
  const T* __restrict__ in;  // [N, H, W, Cin]
  const T* __restrict__ w;   // [ncols, TAPS * Cin] (the float path)
  int N, H, W, Cin, dil, ncols;
};

// Pixel p's (y, x) packed as y << 16 | x; past the last pixel, a y that
// no tap brings inside the image.
template <typename T>
__device__ __forceinline__ int pixel_yx(const ConvArgs<T>& a, int p) {
  if (p >= a.N * a.H * a.W) return 0x40000000;
  const int rem = p % (a.H * a.W);
  return (rem / a.W) << 16 | (rem % a.W);
}

// Whether tap (dy, dx) of a pixel lies inside the image.  Then its row in
// the input is p + dy * W + dx (the same image).
__device__ __forceinline__ bool tap_inside(int yx, int dy, int dx, int H,
                                           int W) {
  return static_cast<unsigned>((yx >> 16) + dy) < static_cast<unsigned>(H) &&
         static_cast<unsigned>((yx & 0xffff) + dx) < static_cast<unsigned>(W);
}

template <int TAPS>
__device__ __forceinline__ void tap_shift(int tap, int dil, int& dy, int& dx) {
  dy = TAPS == 9 ? (tap / 3 - 1) * dil : 0;
  dx = TAPS == 9 ? (tap % 3 - 1) * dil : 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- float

// The column map of the float path: tile column (slot) l reads weight row
// row(l).  Thread tx of the 16 x 16 thread grid owns slots tx + 16 v.
struct DenseCols {
  int n0, ncols;
  __device__ int row(int l) const { return n0 + l; }
  __device__ bool valid(int l) const { return n0 + l < ncols; }
};

constexpr int F32_BK = 32, F32_LD = F32_BK + 4, F32_STAGES = 3;
constexpr int F32_THREADS = 256;

template <int TM, int BN>
__host__ __device__ constexpr int f32_smem_bytes() {
  return F32_STAGES * (TM + BN) * F32_LD * 4;
}

// Computes the TM x BN tile (TM = 128 or 64, BN a multiple of 16) whose
// first row is pixel p0 and calls epi(p, tx, acc[BN / 16]) for each of
// the thread's rows p0 + ty + 16 i below N*H*W; acc[v] is tile column
// tx + 16 v.
template <int TAPS, int TM, int BN, typename Cols, typename Epi>
__device__ __forceinline__ void conv_igemm_f32(const ConvArgs<float>& a,
                                               int p0, const Cols& cols,
                                               Epi epi) {
  constexpr int BK = F32_BK, LD = F32_LD, NS = F32_STAGES;
  constexpr int MI = TM / 16, NV = BN / 16;
  extern __shared__ float4 smem_f4[];
  float* As = reinterpret_cast<float*>(smem_f4);
  float* Bs = As + NS * TM * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // the copies: rows lr + RS r of A and B, 4 floats at kq
  constexpr int RS = F32_THREADS * 4 / BK, RA = TM / RS, NB = BN / RS;
  const int lr = tid / (BK / 4), kq = (tid % (BK / 4)) * 4;
  int yx[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) yx[r] = pixel_yx(a, p0 + lr + RS * r);
  // where the thread's copies start: A row lr of the tile (row lr + RS r
  // is RS r pixels on), B weight row cols.row(lr + RS b) (-1: past ncols)
  const float* a0 = a.in + (size_t)(p0 + lr) * a.Cin + kq;
  int boff[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b)
    boff[b] = cols.valid(lr + RS * b)
                  ? cols.row(lr + RS * b) * TAPS * a.Cin + kq
                  : -1;
  const int nk = TAPS * (a.Cin / BK);

  int tap = 0, k0 = 0;  // of the next chunk to load (chunks load in order)
  auto load = [&](int kc) {
    int dy, dx;
    tap_shift<TAPS>(tap, a.dil, dy, dx);
    const int shift = (dy * a.W + dx) * a.Cin + k0;
    float* as = As + (kc % NS) * TM * LD + kq;
    float* bs = Bs + (kc % NS) * BN * LD + kq;
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const bool ok = tap_inside(yx[r], dy, dx, a.H, a.W);
      cp_async16(smem_addr(as + (lr + RS * r) * LD),
                 ok ? a0 + (size_t)r * RS * a.Cin + shift : a.in, ok);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
      cp_async16(smem_addr(bs + (lr + RS * b) * LD),
                 boff[b] >= 0 ? a.w + boff[b] + kc * BK : a.w, boff[b] >= 0);
    if ((k0 += BK) == a.Cin) k0 = 0, ++tap;
  };

  float acc[MI][NV];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int v = 0; v < NV; ++v) acc[i][v] = 0.f;

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<NS - 2>();
    // chunk kc is in for every thread, and chunk kc - 1's buffer is free
    __syncthreads();
    if (kc + NS - 1 < nk) load(kc + NS - 1);
    cp_async_commit();
    const float* as = As + (kc % NS) * TM * LD;
    const float* bs = Bs + (kc % NS) * BN * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[MI];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * LD + kk);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const float4 b =
            *reinterpret_cast<const float4*>(bs + (tx + 16 * v) * LD + kk);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          float t = fmaf(av[i].x, b.x, acc[i][v]);
          t = fmaf(av[i].y, b.y, t);
          t = fmaf(av[i].z, b.z, t);
          acc[i][v] = fmaf(av[i].w, b.w, t);
        }
      }
    }
  }

  const int P = a.N * a.H * a.W;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int p = p0 + ty + 16 * i;
    if (p < P) epi(p, tx, acc[i]);
  }
}

// ----------------------------------------------------------------- bf16

constexpr int WG_BK = 64;            // K chunk: one 128-byte swizzle row
constexpr int WG_THREADS = 384;      // producer + two consumer warpgroups
constexpr int WG_A_BYTES = BM * WG_BK * 2;

template <int BN>
__host__ __device__ constexpr int wg_b_bytes() {
  return BN * WG_BK * 2;
}
template <int BN>
__host__ __device__ constexpr int wg_stages() {
  return 196608 / (WG_A_BYTES + wg_b_bytes<BN>());  // 4, 6, 8
}
template <int BN>
__host__ __device__ constexpr int wg_smem_bytes() {  // + alignment, barriers
  return wg_stages<BN>() * (WG_A_BYTES + wg_b_bytes<BN>()) + 1024 +
         24 * wg_stages<BN>() + 8;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}
// Waits for the phase of the given parity to complete.  A wait that
// never ends is a lost arrival: trap, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t spins = 0; !mbar_try_wait(addr, parity); ++spins)
    if (spins == (1u << 24)) __trap();
}

// TMA: box of the 2-D or 3-D tensor map at (c0, c1[, c2]) -> shared
// memory, completing its bytes on the barrier
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows,
// 128-byte swizzle, 8-row groups 1024 bytes apart (tile base 1024-aligned;
// a K step of 16 elements adds 32 bytes to the start address)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 | static_cast<uint64_t>(1024 >> 4)
                                              << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across the
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// An epilogue that needs no operands staged in shared memory
struct NoPrefetch {
  static constexpr bool kOn = false;
  static constexpr uint32_t kBytes = 0;
  __device__ void issue(uint8_t*, uint64_t*, int, int) const {}
};

// Computes the 128 x BN tile whose first row is pixel p0.
// - A: tap (dy, dx) of K chunk k0 is one TMA box of the activations seen as
//   a [P, Cin] matrix (amap), rows p0 + dy*W + dx .. + 127: rows outside
//   [0, P) and channels past Cin arrive as zeros, and the producer then
//   zeroes the rows whose tap falls outside the image (the conv's padding
//   and the wrap into the neighbouring image row) before handing the stage
//   on.
// - B (wmap): with GATES, four boxes of BN/4 rows at g*C + n0 (gate g of
//   channels n0 .. n0 + BN/4), else one box of BN rows at n0.
// Per stage, TMA completes on `landed`, the producer's fix-up on `full`,
// and the consumers release it on `empty`.  After the last chunk the
// fix-up threads stage the epilogue's operands in the drained ring
// (pre.issue(smem, bar, u, nu), thread u of nu: TMA of pre.kBytes on the
// epilogue barrier by u = 0, cp.async by any).  Each consumer thread then calls
// epi(acc, row, q, smem) once: acc[4 j + 2 h + e] is tile row row + 8 h,
// column 8 j + 2 q + e (the wgmma accumulator fragment).
template <int TAPS, int BN, bool GATES, typename Pre, typename Epi>
__device__ __forceinline__ void conv_igemm_wgmma(const ConvArgs<bf16>& a,
                                                 const CUtensorMap* amap,
                                                 const CUtensorMap* wmap,
                                                 int p0, int n0, int C,
                                                 const Pre& pre, Epi epi) {
  constexpr int NS = wg_stages<BN>();
  constexpr int BB = wg_b_bytes<BN>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* As = smem;
  uint8_t* Bs = smem + NS * WG_A_BYTES;
  uint64_t* landed = reinterpret_cast<uint64_t*>(Bs + NS * BB);
  uint64_t* full = landed + NS;
  uint64_t* empty = full + NS;
  uint64_t* epi_bar = empty + NS;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&landed[s], 1);  // the TMA thread + the bytes
      // the fix-up threads; a 1x1 product needs none: TMA lands on full
      mbar_init(&full[s], TAPS == 9 ? 96 : 1);
      mbar_init(&empty[s], 8);   // one per consumer warp
    }
    mbar_init(epi_bar, 97);      // the fix-up threads + the TMA bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int per_tap = (a.Cin + WG_BK - 1) / WG_BK, nk = TAPS * per_tap;

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (tid == 0) {
      // the TMA thread: every chunk's A and B as soon as its stage is free
      for (int kc = 0; kc < nk; ++kc) {
        const int s = kc % NS;
        if (kc >= NS) mbar_wait(&empty[s], ((kc / NS) + 1) & 1);
        const int tap = kc / per_tap, k0 = (kc - tap * per_tap) * WG_BK;
        int dy, dx;
        tap_shift<TAPS>(tap, a.dil, dy, dx);
        uint64_t* bar = TAPS == 9 ? &landed[s] : &full[s];
        mbar_arrive_expect_tx(bar, WG_A_BYTES + BB);
        tma_load_2d(As + s * WG_A_BYTES, amap, bar, k0, p0 + dy * a.W + dx);
        if constexpr (GATES) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            tma_load_3d(Bs + s * BB + g * (BB / 4), wmap, bar, k0, tap,
                        g * C + n0);
        } else {
          tma_load_3d(Bs + s * BB, wmap, bar, k0, tap, n0);
        }
      }
    } else if (tid >= 32) {
      // warps 1-3 fix each stage up as soon as it lands: thread u zeroes
      // 16-byte chunk u % 8 of rows u / 8 + 12 i where the tap leaves the
      // image
      const int u = tid - 32, chunk = u & 7, r0 = u >> 3;
      int yx[11];
#pragma unroll
      for (int i = 0; i < 11; ++i) yx[i] = pixel_yx(a, p0 + r0 + 12 * i);
      for (int kc = 0; kc < (TAPS == 9 ? nk : 0); ++kc) {
        const int s = kc % NS;
        int dy, dx;
        tap_shift<TAPS>(kc / per_tap, a.dil, dy, dx);
        mbar_wait(&landed[s], (kc / NS) & 1);
#pragma unroll
        for (int i = 0; i < 11; ++i) {
          const int r = r0 + 12 * i;
          if (r < BM && !tap_inside(yx[i], dy, dx, a.H, a.W))
            *reinterpret_cast<uint4*>(As + s * WG_A_BYTES + r * 128 +
                                      ((chunk ^ (r & 7)) << 4)) = uint4{};
        }
        // hand the stage (TMA's bytes and these zeros) to wgmma
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full[s]);
      }
      if constexpr (Pre::kOn) {
        // the ring is drained once every stage's last use is released
        for (int kc = nk > NS ? nk - NS : 0; kc < nk; ++kc)
          mbar_wait(&empty[kc % NS], (kc / NS) & 1);
        if (u == 0) mbar_arrive_expect_tx(epi_bar, Pre::kBytes);
        pre.issue(smem, epi_bar, u, 96);
        cp_async_commit();
        cp_async_wait<0>();
        mbar_arrive(epi_bar);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int cw = (tid >> 7) - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      const int s = kc % NS;
      mbar_wait(&full[s], (kc / NS) & 1);
      const uint32_t a0 = smem_addr(As + s * WG_A_BYTES + cw * (WG_A_BYTES / 2));
      const uint32_t b0 = smem_addr(Bs + s * BB);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wgmma<BN>(acc, wgmma_desc(a0 + 32 * kk), wgmma_desc(b0 + 32 * kk));
      wgmma_commit();
      fence_acc(acc);
      // chunk kc - 1's products are done: its stage is free
      wgmma_wait<1>();
      fence_acc(acc);
      if (kc > 0 && lane == 0) mbar_arrive(&empty[(kc - 1) % NS]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(nk - 1) % NS]);
    if constexpr (Pre::kOn) mbar_wait(epi_bar, 0);
    epi(acc, cw * 64 + warp * 16 + lane / 4, lane & 3, smem);
  }
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded (no
// link against libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 (or, with f32, float32) matrix [rows, cols]
// (row-major, rows 16-byte aligned), box box_cols x box_rows, zeros
// outside; `swizzle` (128-byte) for an operand read in 128-byte rows
// (box_cols = 64 bf16 or 32 floats), plain for an epilogue operand.
// Returns a cudaError_t value (0 = success).
inline int matrix_map(CUtensorMap* map, const void* ptr, int cols, int rows,
                      int box_cols, int box_rows, bool swizzle,
                      bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(
      map,
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tensor map of a packed bf16 (or, with f32, float32) weight wt
// [nrows, taps * cin] seen as [cin, taps, nrows] (innermost first), box
// (64 bf16 or 32 floats: 128 bytes) x 1 x box_rows, 128-byte swizzle,
// zeros outside.  Returns a cudaError_t value (0 = success).
inline int weight_map(CUtensorMap* map, const void* wt, int cin, int taps,
                      int nrows, int box_rows, bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cin, (cuuint64_t)taps,
                              (cuuint64_t)nrows};
  const cuuint64_t strides[2] = {(cuuint64_t)cin * esize,
                                 (cuuint64_t)taps * cin * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), 1,
                             (cuuint32_t)box_rows};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map,
                        f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        3,
                        const_cast<void*>(wt), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Opts a kernel into `bytes` of dynamic shared memory (once per kernel).
template <auto Kernel>
inline int allow_smem(int bytes) {
  static const int err = static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(Kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  return err;
}

// {grid x, grid y, blocks per SM} of a launch, for the wrappers' reports
// (the launches themselves never ask)
template <auto Kernel>
inline int grid_report(dim3 grid, int threads, int smem, int* out) {
  out[0] = static_cast<int>(grid.x);
  out[1] = static_cast<int>(grid.y);
  out[2] = 0;
  int err = allow_smem<Kernel>(smem);
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], Kernel, threads, smem));
  return err ? err : out[2] > 0 ? 0
                                : static_cast<int>(cudaErrorInvalidConfiguration);
}

}  // namespace sp
