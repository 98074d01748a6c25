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
// biases float, and every product accumulated in float.
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
// on the tensor cores (WMMA), float32 ones on the CUDA cores.  t1 and t2
// are stored in the compute type, as the TPU kernel's VMEM scratch held
// them.  Keeping t1/t2 on chip across the three products, as the TPU
// kernel did in VMEM, is later work.
#include "conv3x3.cuh"

namespace {

enum Epi { kBiasRelu = 0, kBiasResidualRelu = 1 };

template <typename T, int TAPS, int EPI>
__global__ void __launch_bounds__(sp::NTHREADS)
    conv_kernel(sp::ConvArgs<T> args, const float* __restrict__ bias,
                const T* __restrict__ residual, T* __restrict__ out,
                int ncols) {
  const int p0 = blockIdx.x * sp::kRows<T>;
  const sp::DenseCols cols{static_cast<int>(blockIdx.y) * sp::BN, ncols};
  sp::conv_igemm<T, TAPS>(args, p0, cols, [&](int p, int tx, const float* v) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cols.n0 + tx * 4 + j;
      if (col >= ncols) continue;
      const size_t q = (size_t)p * ncols + col;
      float r = v[j] + bias[col];
      if (EPI == kBiasResidualRelu) r += sp::to_f32(residual[q]);
      out[q] = sp::from_f32<T>(fmaxf(r, 0.f));
    }
  });
}

template <typename T, int TAPS, int EPI>
int conv(const T* in, const T* w, const float* bias, const T* residual,
         T* out, int N, int H, int W, int Cin, int dil, int ncols,
         cudaStream_t stream) {
  const sp::ConvArgs<T> args{in, w, N, H, W, Cin, dil, ncols};
  const int P = N * H * W;
  const dim3 grid((P + sp::kRows<T> - 1) / sp::kRows<T>,
                  (ncols + sp::BN - 1) / sp::BN);
  conv_kernel<T, TAPS, EPI><<<grid, sp::NTHREADS, 0, stream>>>(
      args, bias, residual, out, ncols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bottleneck(const void* xv, void* yv, void* t1v, void* t2v,
               const void* w1v, const float* b1, const void* w2v,
               const float* b2, const void* w3v, const float* b3, int N,
               int H, int W, int C, int M, int dil, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* t1 = static_cast<T*>(t1v);
  T* t2 = static_cast<T*>(t2v);
  const int P = N * H * W;
  // the 1x1 products see the pixels as one [P, 1, 1] column of images
  int err = conv<T, 1, kBiasRelu>(x, static_cast<const T*>(w1v), b1, nullptr,
                                  t1, P, 1, 1, C, 1, M, stream);
  if (err) return err;
  err = conv<T, 9, kBiasRelu>(t1, static_cast<const T*>(w2v), b2, nullptr, t2,
                              N, H, W, M, dil, M, stream);
  if (err) return err;
  return conv<T, 1, kBiasResidualRelu>(t2, static_cast<const T*>(w3v), b3, x,
                                       static_cast<T*>(yv), P, 1, 1, M, 1, C,
                                       stream);
}

}  // namespace

// x, y: [N, H, W, C]; t1, t2: [N, H, W, M] scratch; w1 [C, M],
// w2 [9M, M] (tap-major), w3 [M, C] in the compute type; b1, b2 [M] and
// b3 [C] float.  dtype: 0 = float32, 1 = bfloat16.  y must not alias x.
// Returns the first non-zero cudaGetLastError() of the three launches.
extern "C" int sp_bottleneck(const void* x, void* y, void* t1, void* t2,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* w3, const void* b3,
                             int N, int H, int W, int C, int M, int dil,
                             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* fb3 = static_cast<const float*>(b3);
  if (dtype == 0)
    return bottleneck<float>(x, y, t1, t2, w1, fb1, w2, fb2, w3, fb3, N, H, W,
                             C, M, dil, st);
  if (dtype == 1)
    return bottleneck<__nv_bfloat16>(x, y, t1, t2, w1, fb1, w2, fb2, w3, fb3,
                                     N, H, W, C, M, dil, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
