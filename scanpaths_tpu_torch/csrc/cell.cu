// One ConvLSTM decode step, fused, for Hopper (sm_90a).
//
// Replaces scanpaths_tpu/ops/pallas_cell.py::cell_step (body
// _cell_kernel).  Per pixel p and channel c:
//
//   pre[g] = sum_{tap, k} h[p + tap, k] * kh[tap, k, g*C + c]      (3x3 conv)
//          + [g < 3] sum_{s, tap} smap[p + tap, s] * kp[n, s, tap, g*C + c]
//          + xg[p, g*C + c]                           (biases folded in)
//   i, f, o = sigmoid(pre[0..2]);  g = tanh(pre[3])
//   c' = f * c + i * g;  h' = o * c'                   (no tanh on c')
//
// What bounds it on the H100: the 3x3 C -> 4C gate conv.  At the main
// path's shape (batch 8, 30x40 grid, C = 512) one step is
// 2 * 9600 * 4608 * 2048 = 181 GFLOP against ~70 MB of h, c, xg and
// weight traffic, so the step is compute-bound, ~16 x 181 GFLOP =
// 2.9 TFLOP per forward.
//
// What the design does about it: each block owns a tile of pixels (64
// in float32, 128 in bf16) and the channel slice [c0, c0 + 16) in ALL
// FOUR gates, so the gate nonlinearities and the state update run on
// the finished accumulators and the [N, H, W, 4C] pre-activation never
// reaches device memory.  The conv is the shared implicit GEMM of
// conv3x3.cuh (zero fill at the border, K = 9 taps x C, float
// accumulation): bf16 on the tensor cores through WMMA (mma.sync),
// float32 on the CUDA cores so that it matches a float32 reference
// computed without TF32.  wgmma with TMA-fed multi-stage pipelines is
// later work.
//
// h' goes to a separate buffer: other blocks read h's neighbours while
// this block writes, so h cannot be updated in place.  c IS updated in
// place: each element of c is read and written by exactly one thread.
#include "conv3x3.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(sp::NTHREADS)
    cell_kernel(const T* __restrict__ h, T* __restrict__ c,
                const T* __restrict__ xg, const T* __restrict__ smap,
                const T* __restrict__ kp, const T* __restrict__ kh,
                T* __restrict__ h_out, int N, int H, int W, int C, int S) {
  const int p0 = blockIdx.x * sp::kRows<T>;
  const int c0 = blockIdx.y * 16;
  const sp::ConvArgs<T> args{h, kh, N, H, W, C, 1, 4 * C};
  const sp::GateCols cols{c0, C};

  sp::conv_igemm<T, 9>(args, p0, cols, [&](int p, int tx, const float* v) {
    const int ch = c0 + tx;
    const int hw = H * W;
    const int n = p / hw;
    const int rem = p - n * hw;
    const int y = rem / W;
    const int x = rem - y * W;
    // factorized task-signal taps, i/f/o only, summed over the streams
    float sig[3] = {0.f, 0.f, 0.f};
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
        const float sv = sp::to_f32(smap[((size_t)(n * H + yy) * W + xx) * S + s]);
        const T* kq = kp + ((size_t)(n * S + s) * 9 + t) * 3 * C + ch;
        sig[0] = fmaf(sv, sp::to_f32(kq[0]), sig[0]);
        sig[1] = fmaf(sv, sp::to_f32(kq[C]), sig[1]);
        sig[2] = fmaf(sv, sp::to_f32(kq[2 * C]), sig[2]);
      }
    }
    const T* xq = xg + (size_t)p * 4 * C + ch;
    const float pi = v[0] + sig[0] + sp::to_f32(xq[0]);
    const float pf = v[1] + sig[1] + sp::to_f32(xq[C]);
    const float po = v[2] + sig[2] + sp::to_f32(xq[2 * C]);
    const float pg = v[3] + sp::to_f32(xq[3 * C]);
    const float ig = 1.f / (1.f + expf(-pi));
    const float fg = 1.f / (1.f + expf(-pf));
    const float og = 1.f / (1.f + expf(-po));
    const float gg = tanhf(pg);
    const size_t q = (size_t)p * C + ch;
    const float cn = fg * sp::to_f32(c[q]) + ig * gg;
    c[q] = sp::from_f32<T>(cn);
    h_out[q] = sp::from_f32<T>(og * cn);
  });
}

template <typename T>
int launch(const void* h, void* c, const void* xg, const void* smap,
           const void* kp, const void* kh, void* h_out, int N, int H, int W,
           int C, int S, cudaStream_t stream) {
  const int P = N * H * W;
  const dim3 grid((P + sp::kRows<T> - 1) / sp::kRows<T>, C / 16);
  cell_kernel<T><<<grid, sp::NTHREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<T*>(c), static_cast<const T*>(xg),
      static_cast<const T*>(smap), static_cast<const T*>(kp),
      static_cast<const T*>(kh), static_cast<T*>(h_out), N, H, W, C, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 = cudaSuccess).
extern "C" int sp_cell_step(const void* h, void* c, const void* xg,
                            const void* smap, const void* kp, const void* kh,
                            void* h_out, int N, int H, int W, int C, int S,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(h, c, xg, smap, kp, kh, h_out, N, H, W, C, S, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, c, xg, smap, kp, kh, h_out, N, H, W, C,
                                 S, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
