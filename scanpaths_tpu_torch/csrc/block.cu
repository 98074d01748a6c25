// One uniform ResNet bottleneck block (BN folded), for Hopper (sm_90a).
//
// Replaces the per-block body of scanpaths_tpu/ops/pallas_block.py::
// stage_apply (_stage_kernel).  The Python wrapper (ops/block.py) calls
// sp_bottleneck once per block of a stage, ping-ponging the output:
//
//   t1 = relu(x @ W1 + b1)                        1x1 reduce, C -> M
//   t2 = relu(conv3x3_dil(t1, W2) + b2)           3x3 dilated, M -> M
//   y  = relu(t2 @ W3 + b3 + x)                   1x1 expand + residual
//
// with x, t1, t2, y dense NHWC in the compute type (float or bf16), the
// biases float, and every product accumulated in float.  The weights come
// packed K-contiguous (W1t [M, C], W2t [M, 9M], W3t [C, M]; ops/block.py).
//
// What bounds it on the H100: at the main path's shapes the early stages
// move more bytes than they compute.  Layer 1 at batch 8 (60x80, C = 256,
// M = 64) does ~5.3 GFLOP per block against ~60 MB of activation traffic
// in bf16, about 90 FLOP per byte, well under the ~295 FLOP/byte at which
// the bf16 tensor cores become the limit; layer 2 (C = 512, M = 128) is
// similar.  Layer 3 (30x40, C = 1024, M = 256, dilation 2) is closer to
// balanced.
//
// What the design does about it: each of the three products is one
// launch of the shared implicit GEMM of conv3x3.cuh with its bias, ReLU
// and (for the expand) residual applied to the accumulators before the
// single store, so no pre-activation is ever written.  bf16 products run
// on wgmma fed by a TMA ring with the tile width fitted to the product
// (64, 128 or 256 columns); float32 ones on the pipelined
// CUDA-core GEMM (64 x 64 tiles).  t1 and t2 are stored in the
// compute type, as the TPU kernel's VMEM scratch held them.  Keeping
// t1/t2 on chip across the three products, as the TPU kernel did in VMEM,
// is later work.
#include "conv3x3.cuh"

namespace {

using sp::bf16;

enum Epi { kBiasRelu = 0, kBiasResidualRelu = 1 };

template <typename T>
struct EpiArgs {
  const float* __restrict__ bias;
  const T* __restrict__ residual;
  T* __restrict__ out;
  int ncols;
};

// V consecutive columns col.. (all below ncols) of output pixel p
template <typename T, int EPI, int V>
__device__ __forceinline__ void finish(const EpiArgs<T>& e, int p, int col,
                                       float (&v)[V]) {
  const size_t q = (size_t)p * e.ncols + col;
  float r[V];
  if (EPI == kBiasResidualRelu) sp::load_f32<T, V>(e.residual + q, r);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] += e.bias[col + i];
    if (EPI == kBiasResidualRelu) v[i] += r[i];
    v[i] = fmaxf(v[i], 0.f);
  }
  sp::store_f32<T, V>(e.out + q, v);
}

// The float32 tile of every product: 64 pixels x 64 columns (4 x 4
// registers a thread), three blocks an SM, which leaves the tile 80
// registers.  At the main path's shapes it measured faster than four
// blocks an SM at 64 registers (spilling) and than 128 x 64 tiles (8 x 4
// registers) at two.
constexpr int F32_TM = 64, F32_BN = 64;
constexpr int F32_SMEM = sp::f32_smem_bytes<F32_TM, F32_BN>();

template <int TAPS, int EPI>
__global__ void __launch_bounds__(sp::F32_THREADS, 3)
    conv_f32(const sp::ConvArgs<float> conv, const EpiArgs<float> e) {
  const int p0 = blockIdx.x * F32_TM, n0 = blockIdx.y * F32_BN;
  const sp::DenseCols cols{n0, e.ncols};
  sp::conv_igemm_f32<TAPS, F32_TM, F32_BN>(
      conv, p0, cols, [&](int p, int tx, const float (&acc)[F32_BN / 16]) {
#pragma unroll
        for (int v = 0; v < F32_BN / 16; ++v) {
          const int col = n0 + tx + 16 * v;
          float r[1] = {acc[v]};
          if (col < e.ncols) finish<float, EPI, 1>(e, p, col, r);
        }
      });
}

// The residual tile [128][BN] of a bf16 expand, staged by TMA in the
// drained ring for the epilogue
template <int BN>
struct ResidualPrefetch {
  static constexpr bool kOn = true;
  static constexpr uint32_t kBytes = sp::BM * BN * 2;
  const CUtensorMap* rmap;
  int n0, p0;
  __device__ void issue(uint8_t* smem, uint64_t* bar, int u, int) const {
    if (u == 0) sp::tma_load_2d(smem, rmap, bar, n0, p0);
  }
};

template <int TAPS, int BN, int EPI>
__global__ void __launch_bounds__(sp::WG_THREADS, 1)
    conv_bf16(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap rmap,
              const sp::ConvArgs<bf16> conv, const EpiArgs<bf16> e) {
  const int p0 = blockIdx.x * sp::BM, n0 = blockIdx.y * BN;
  const int P = conv.N * conv.H * conv.W;
  auto epi = [&](const float (&acc)[BN / 2], int row, int q,
                 const uint8_t* smem) {
    const bf16* rs = reinterpret_cast<const bf16*>(smem);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h, p = p0 + r;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * q, col = n0 + cl;
        if (col >= e.ncols) continue;
        float v[2] = {acc[4 * j + 2 * h] + e.bias[col],
                      acc[4 * j + 2 * h + 1] + e.bias[col + 1]};
        if constexpr (EPI == kBiasResidualRelu) {
          float res[2];
          sp::load_f32<bf16, 2>(rs + r * BN + cl, res);
          v[0] += res[0];
          v[1] += res[1];
        }
        v[0] = fmaxf(v[0], 0.f);
        v[1] = fmaxf(v[1], 0.f);
        sp::store_f32<bf16, 2>(e.out + (size_t)p * e.ncols + col, v);
      }
    }
  };
  if constexpr (EPI == kBiasResidualRelu)
    sp::conv_igemm_wgmma<TAPS, BN, false>(conv, &amap, &wmap, p0, n0, 0,
                                          ResidualPrefetch<BN>{&rmap, n0, p0},
                                          epi);
  else
    sp::conv_igemm_wgmma<TAPS, BN, false>(conv, &amap, &wmap, p0, n0, 0,
                                          sp::NoPrefetch{}, epi);
}

// The bf16 tile width of a product with ncols output columns: the widest
// that covers the columns (with one block an SM, a wide tile beats more
// waves of narrow ones).
int bf16_width(int ncols) { return ncols <= 64 ? 64 : ncols <= 128 ? 128 : 256; }

template <int TAPS, int EPI>
int conv_f32_launch(const sp::ConvArgs<float>& a, const EpiArgs<float>& e,
                    cudaStream_t stream, int* report) {
  const dim3 grid((a.N * a.H * a.W + F32_TM - 1) / F32_TM,
                  (a.ncols + F32_BN - 1) / F32_BN);
  if (report)
    return sp::grid_report<conv_f32<TAPS, EPI>>(grid, sp::F32_THREADS,
                                                F32_SMEM, report);
  const int err = sp::allow_smem<conv_f32<TAPS, EPI>>(F32_SMEM);
  if (err) return err;
  conv_f32<TAPS, EPI><<<grid, sp::F32_THREADS, F32_SMEM, stream>>>(a, e);
  return static_cast<int>(cudaGetLastError());
}

template <int TAPS, int BN, int EPI>
int conv_bf16_bn(const sp::ConvArgs<bf16>& a, const EpiArgs<bf16>& e,
                 cudaStream_t stream, int* report) {
  constexpr int smem = sp::wg_smem_bytes<BN>();
  const dim3 grid((a.N * a.H * a.W + sp::BM - 1) / sp::BM,
                  (a.ncols + BN - 1) / BN);
  if (report)
    return sp::grid_report<conv_bf16<TAPS, BN, EPI>>(grid, sp::WG_THREADS,
                                                     smem, report);
  const int P = a.N * a.H * a.W;
  CUtensorMap amap, wmap, rmap{};
  int err = sp::matrix_map(&amap, a.in, a.Cin, P, sp::WG_BK, sp::BM, true);
  if (!err) err = sp::weight_map(&wmap, a.w, a.Cin, TAPS, a.ncols, BN);
  if (!err && EPI == kBiasResidualRelu)
    err = sp::matrix_map(&rmap, e.residual, a.ncols, P, BN, sp::BM, false);
  if (!err) err = sp::allow_smem<conv_bf16<TAPS, BN, EPI>>(smem);
  if (err) return err;
  conv_bf16<TAPS, BN, EPI><<<grid, sp::WG_THREADS, smem, stream>>>(
      amap, wmap, rmap, a, e);
  return static_cast<int>(cudaGetLastError());
}

// One product: launches it, or with `report` fills {grid x, grid y,
// blocks per SM} instead.
template <typename T, int TAPS, int EPI>
int conv(const T* in, const T* wt, const float* bias, const T* residual,
         T* out, int N, int H, int W, int Cin, int dil, int ncols,
         cudaStream_t stream, int* report) {
  const sp::ConvArgs<T> a{in, wt, N, H, W, Cin, dil, ncols};
  const EpiArgs<T> e{bias, residual, out, ncols};
  if constexpr (std::is_same<T, float>::value) {
    return conv_f32_launch<TAPS, EPI>(a, e, stream, report);
  } else {
    const int bn = bf16_width(ncols);
    if (bn == 64) return conv_bf16_bn<TAPS, 64, EPI>(a, e, stream, report);
    if (bn == 128) return conv_bf16_bn<TAPS, 128, EPI>(a, e, stream, report);
    return conv_bf16_bn<TAPS, 256, EPI>(a, e, stream, report);
  }
}

template <typename T>
int bottleneck(const void* xv, void* yv, void* t1v, void* t2v,
               const void* w1v, const float* b1, const void* w2v,
               const float* b2, const void* w3v, const float* b3, int N,
               int H, int W, int C, int M, int dil, cudaStream_t stream,
               int* report) {
  const T* x = static_cast<const T*>(xv);
  T* t1 = static_cast<T*>(t1v);
  T* t2 = static_cast<T*>(t2v);
  const int P = N * H * W;
  // the 1x1 products see the pixels as one [P, 1, 1] column of images
  int err = conv<T, 1, kBiasRelu>(x, static_cast<const T*>(w1v), b1, nullptr,
                                  t1, P, 1, 1, C, 1, M, stream, report);
  if (err) return err;
  err = conv<T, 9, kBiasRelu>(t1, static_cast<const T*>(w2v), b2, nullptr, t2,
                              N, H, W, M, dil, M, stream,
                              report ? report + 3 : nullptr);
  if (err) return err;
  return conv<T, 1, kBiasResidualRelu>(
      t2, static_cast<const T*>(w3v), b3, x, static_cast<T*>(yv), P, 1, 1, M,
      1, C, stream, report ? report + 6 : nullptr);
}

int dispatch(const void* x, void* y, void* t1, void* t2, const void* w1,
             const void* b1, const void* w2, const void* b2, const void* w3,
             const void* b3, int N, int H, int W, int C, int M, int dil,
             int dtype, void* stream, int* report) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fb3 = static_cast<const float*>(b3);
  if (dtype == 0)
    return bottleneck<float>(x, y, t1, t2, w1, fb1, w2, fb2, w3, fb3, N, H, W,
                             C, M, dil, st, report);
  if (dtype == 1)
    return bottleneck<bf16>(x, y, t1, t2, w1, fb1, w2, fb2, w3, fb3, N, H, W,
                            C, M, dil, st, report);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: [N, H, W, C]; t1, t2: [N, H, W, M] scratch; the packed weights
// w1t [M, C], w2t [M, 9M] (row m holds the HWIO kernel's column m,
// tap-major), w3t [C, M] in the compute type; b1, b2 [M] and b3 [C]
// float.  dtype: 0 = float32, 1 = bfloat16.  y must not alias x.
// Returns the first non-zero cudaGetLastError() of the three launches.
extern "C" int sp_bottleneck(const void* x, void* y, void* t1, void* t2,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3,
                             int N, int H, int W, int C, int M, int dil,
                             int dtype, void* stream) {
  return dispatch(x, y, t1, t2, w1, b1, w2, b2, w3, b3, N, H, W, C, M, dil,
                  dtype, stream, nullptr);
}

// out[3 i .. 3 i + 2] = {grid x, grid y, blocks per SM} of product i
// (reduce, 3x3, expand) of sp_bottleneck at this shape
extern "C" int sp_bottleneck_grid(int* out, int N, int H, int W, int C, int M,
                                  int dtype) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, nullptr, nullptr, N, H, W, C, M, 1, dtype,
                  nullptr, out);
}
