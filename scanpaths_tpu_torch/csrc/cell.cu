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
// weight traffic, so the step is compute-bound.
//
// What the design does about it: each block owns a tile of 128 pixels and
// a slice of channels in ALL FOUR gates, so the gate nonlinearities and
// the state update run on the finished accumulators and the
// [N, H, W, 4C] pre-activation never reaches device memory.  The conv is
// the shared implicit GEMM of conv3x3.cuh over the gate kernel packed
// K-contiguous, kt [4C, 9C] (ops/cell.py packs it once per kh tensor):
// - bf16: wgmma fed by a TMA ring, 64 channels x 4 gates = 256 columns a
//   block (32 x 4 when C % 64 != 0).  The wgmma fragment gives each
//   thread the same 16 channels in each of the four 64-column gate
//   blocks, so no column permutation of the weight or of xg is needed.
//   The epilogue reads xg, c and the signal weights from shared memory,
//   where TMA and cp.async staged them once the mainloop was done;
// - float32: the pipelined CUDA-core GEMM, 32 channels x 4 gates a block,
//   each thread holding all four gates of two channels.
// Both evaluate the gates in full float32 precision (expf, tanhf).
//
// h' goes to a separate buffer: other blocks read h's neighbours while
// this block writes, so h cannot be updated in place.  c IS updated in
// place: each element of c is read and written by exactly one thread.
#include "conv3x3.cuh"

namespace {

using sp::bf16;

template <typename T>
struct CellArgs {
  T* __restrict__ c;
  const T* __restrict__ xg;
  const T* __restrict__ smap;
  const T* __restrict__ kp;
  T* __restrict__ h_out;
  int N, H, W, C, S;
};

// Pixel p's image n; hands its signal-map taps to out(9 s + t, value)
// (0 outside the image and for s >= S)
template <typename T, typename Out>
__device__ __forceinline__ int signal_taps(const CellArgs<T>& a, int p,
                                           Out out) {
  const int hw = a.H * a.W, n = p / hw, rem = p - n * hw;
  const int y = rem / a.W, x = rem - y * a.W;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
      const bool in = s < a.S && yy >= 0 && yy < a.H && xx >= 0 && xx < a.W;
      out(9 * s + t,
          in ? sp::to_f32(a.smap[((size_t)(n * a.H + yy) * a.W + xx) * a.S + s])
             : 0.f);
    }
  return n;
}

// The factorized task-signal taps of one float32 channel (i/f/o only,
// summed over the streams): kq points at its weights for stream 0, tap 0,
// gate 0 in its image's kp [S][9][3][C].
__device__ __forceinline__ void signal_sum(const float* kq, int C, int S,
                                           const float (&sv)[18],
                                           float (&sig)[3]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s >= S) break;
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int g = 0; g < 3; ++g)
        sig[g] = fmaf(sv[9 * s + t], kq[((s * 9 + t) * 3 + g) * C], sig[g]);
  }
}

// The state update of V channels in full float32 precision:
// i, f, o = sigmoid, g = tanh, c' = f c + i g, h' = o c'.
template <int V>
__device__ __forceinline__ void lstm_update(const float (&pre)[4][V],
                                            float (&c)[V], float (&h)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float ig = 1.f / (1.f + expf(-pre[0][e]));
    const float fg = 1.f / (1.f + expf(-pre[1][e]));
    const float og = 1.f / (1.f + expf(-pre[2][e]));
    const float gg = tanhf(pre[3][e]);
    c[e] = fg * c[e] + ig * gg;
    h[e] = og * c[e];
  }
}

constexpr int F32_CH = 32;  // channels per block, float32

__global__ void __launch_bounds__(sp::F32_THREADS, 2)
    cell_f32(const sp::ConvArgs<float> conv, const CellArgs<float> a) {
  const int p0 = blockIdx.x * sp::BM, c0 = blockIdx.y * F32_CH;
  const sp::GateCols<F32_CH> cols{c0, a.C};
  sp::conv_igemm_f32<9, sp::BM, 4 * F32_CH>(
      conv, p0, cols, [&](int p, int tx, const float (&v)[8]) {
        float sv[18];
        const int n = signal_taps(a, p, [&](int i, float v) { sv[i] = v; });
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // slot tx + 16 v is gate v / 2 of channel c0 + 16 (v % 2) + tx
          const int ch = c0 + 16 * e + tx;
          // (conv + signal) + xg in the plain version's order: the signal
          // taps summed apart, then added to the conv's sum in one rounding
          float sig[3] = {0.f, 0.f, 0.f};
          signal_sum(a.kp + (size_t)n * a.S * 27 * a.C + ch, a.C, a.S, sv,
                     sig);
          const float* xq = a.xg + (size_t)p * 4 * a.C + ch;
          float pre[4][1];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[g][0] = (v[2 * g + e] + (g < 3 ? sig[g] : 0.f)) + xq[g * a.C];
          const size_t q = (size_t)p * a.C + ch;
          float cv[1] = {a.c[q]}, hv[1];
          lstm_update<1>(pre, cv, hv);
          a.c[q] = cv[0];
          a.h_out[q] = hv[0];
        }
      });
}

// The bf16 epilogue's operands, staged in the drained ring: xg [4][128][CH]
// and c [128][CH] of the tile (TMA, row-major), the signal weights of the
// tile's first two images [2][S][9][3][CH] (cp.async; zeros past the last
// image), and each row's signal-map taps [128][18] as float.
template <int CH>
struct CellPrefetch {
  static constexpr bool kOn = true;
  static constexpr uint32_t kBytes = 5 * sp::BM * CH * 2;
  static constexpr int kXg = 0, kC = 4 * sp::BM * CH * 2, kKp = kBytes;
  static constexpr int kSv = kKp + 2 * 2 * 27 * CH * 2;
  const CUtensorMap* xmap;
  const CUtensorMap* cmap;
  const CellArgs<bf16>* a;
  int c0, p0, n0;  // n0: the tile's first image
  __device__ void issue(uint8_t* smem, uint64_t* bar, int u, int nu) const {
    const int S = a->S, C = a->C;
    const bf16* kp = a->kp;
    if (u == 0) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        sp::tma_load_2d(smem + kXg + g * sp::BM * CH * 2, xmap, bar,
                        g * C + c0, p0);
      sp::tma_load_2d(smem + kC, cmap, bar, c0, p0);
    }
    constexpr int per = CH / 8;  // 16-byte chunks of a weight row
    for (int i = u; i < 2 * S * 27 * per; i += nu) {
      const int row = i / per, g = row % 3, t = (row / 3) % 9;
      const int s = (row / 27) % S, n = n0 + row / (27 * S);
      const bool ok = n < a->N;
      const bf16* src = ok ? kp + ((size_t)(n * S + s) * 9 + t) * 3 * C +
                                 g * C + c0 + (i % per) * 8
                           : kp;
      sp::cp_async16(sp::smem_addr(smem + kKp + i * 16), src, ok);
    }
    float* sv = reinterpret_cast<float*>(smem + kSv);
    for (int r = u; r < sp::BM; r += nu) {
      float* row = sv + r * 18;
      if (p0 + r < a->N * a->H * a->W) {
        signal_taps(*a, p0 + r, [&](int i, float v) { row[i] = v; });
      } else {
        for (int i = 0; i < 18; ++i) row[i] = 0.f;
      }
    }
  }
};

template <int BN>
__global__ void __launch_bounds__(sp::WG_THREADS, 1)
    cell_bf16(const __grid_constant__ CUtensorMap hmap,
              const __grid_constant__ CUtensorMap wmap,
              const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap cmap,
              const sp::ConvArgs<bf16> conv, const CellArgs<bf16> a) {
  constexpr int CH = BN / 4, JG = CH / 8;  // channels, n8 blocks a gate
  using Pre = CellPrefetch<CH>;
  const int p0 = blockIdx.x * sp::BM, c0 = blockIdx.y * CH;
  const int P = a.N * a.H * a.W, n0 = p0 / (a.H * a.W);
  const Pre pre{&xmap, &cmap, &a, c0, p0, n0};
  sp::conv_igemm_wgmma<9, BN, true>(
      conv, &hmap, &wmap, p0, c0, a.C, pre,
      [&](float (&acc)[BN / 2], int row, int q, const uint8_t* smem) {
        // column 8 (g JG + j) + 2 q + e: gate g of channel c0 + 8 j + 2 q + e
        const bf16* xs = reinterpret_cast<const bf16*>(smem + Pre::kXg);
        const bf16* cs = reinterpret_cast<const bf16*>(smem + Pre::kC);
        const bf16* ks = reinterpret_cast<const bf16*>(smem + Pre::kKp);
        const float* svs = reinterpret_cast<const float*>(smem + Pre::kSv);
        // the thread's rows row and row + 8: where their image's signal
        // weights are (staged, or in kp for a tile over more than two
        // small images)
        const bf16* kq[2];
        int kstride[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = min(p0 + row + 8 * h, P - 1) / (a.H * a.W);
          kq[h] = ks + (n - n0) * a.S * 27 * CH;
          kstride[h] = CH;
          if (n - n0 >= 2) {
            kq[h] = a.kp + (size_t)n * a.S * 27 * a.C + c0;
            kstride[h] = a.C;
          }
        }
        // the signal taps into the i, f, o accumulators, in place
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (s >= a.S) break;
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            const float sv[2] = {svs[row * 18 + 9 * s + t],
                                 svs[(row + 8) * 18 + 9 * s + t]};
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
              for (int j = 0; j < JG; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float k[2];
                  sp::load_f32<bf16, 2>(
                      kq[h] + ((s * 9 + t) * 3 + g) * kstride[h] + 8 * j + 2 * q,
                      k);
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    float& v = acc[4 * (g * JG + j) + 2 * h + e];
                    v = fmaf(sv[h], k[e], v);
                  }
                }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h, p = p0 + r;
          if (p >= P) continue;
#pragma unroll
          for (int j = 0; j < JG; ++j) {
            const int cl = 8 * j + 2 * q;
            float pre_act[4][2];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              float x[2];
              sp::load_f32<bf16, 2>(xs + (g * sp::BM + r) * CH + cl, x);
#pragma unroll
              for (int e = 0; e < 2; ++e)
                pre_act[g][e] = acc[4 * (g * JG + j) + 2 * h + e] + x[e];
            }
            float cv[2], hv[2];
            sp::load_f32<bf16, 2>(cs + r * CH + cl, cv);
            lstm_update<2>(pre_act, cv, hv);
            const size_t qo = (size_t)p * a.C + c0 + cl;
            sp::store_f32<bf16, 2>(a.c + qo, cv);
            sp::store_f32<bf16, 2>(a.h_out + qo, hv);
          }
        }
      });
}

template <typename T>
struct Launch {
  sp::ConvArgs<T> conv;
  CellArgs<T> cell;
  dim3 grid;
};

template <typename T>
Launch<T> plan(const void* h, void* c, const void* xg, const void* smap,
               const void* kp, const void* kt, void* h_out, int N, int H,
               int W, int C, int S, int ch) {
  const int P = N * H * W;
  return {{static_cast<const T*>(h), static_cast<const T*>(kt), N, H, W, C, 1,
           4 * C},
          {static_cast<T*>(c), static_cast<const T*>(xg),
           static_cast<const T*>(smap), static_cast<const T*>(kp),
           static_cast<T*>(h_out), N, H, W, C, S},
          dim3((P + sp::BM - 1) / sp::BM, C / ch)};
}

constexpr int F32_SMEM = sp::f32_smem_bytes<sp::BM, 4 * F32_CH>();

template <int BN>
int launch_bf16(const Launch<bf16>& l, cudaStream_t stream) {
  constexpr int CH = BN / 4;
  const int C = l.conv.Cin, P = l.conv.N * l.conv.H * l.conv.W;
  CUtensorMap hmap, wmap, xmap, cmap;
  int err = sp::matrix_map(&hmap, l.conv.in, C, P, sp::WG_BK, sp::BM, true);
  if (!err) err = sp::weight_map(&wmap, l.conv.w, C, 9, 4 * C, CH);
  if (!err) err = sp::matrix_map(&xmap, l.cell.xg, 4 * C, P, CH, sp::BM, false);
  if (!err) err = sp::matrix_map(&cmap, l.cell.c, C, P, CH, sp::BM, false);
  if (!err) err = sp::allow_smem<cell_bf16<BN>>(sp::wg_smem_bytes<BN>());
  if (err) return err;
  cell_bf16<BN><<<l.grid, sp::WG_THREADS, sp::wg_smem_bytes<BN>(), stream>>>(
      hmap, wmap, xmap, cmap, l.conv, l.cell);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kt: the packed gate kernel [4C, 9C] (row g*C + c holds kh[:, :, :, g*C + c]
// tap-major).  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int sp_cell_step(const void* h, void* c, const void* xg,
                            const void* smap, const void* kp, const void* kt,
                            void* h_out, int N, int H, int W, int C, int S,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto l = plan<float>(h, c, xg, smap, kp, kt, h_out, N, H, W, C, S,
                               F32_CH);
    const int err = sp::allow_smem<cell_f32>(F32_SMEM);
    if (err) return err;
    cell_f32<<<l.grid, sp::F32_THREADS, F32_SMEM, st>>>(l.conv, l.cell);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 1) {
    if (C % 64 == 0)
      return launch_bf16<256>(
          plan<bf16>(h, c, xg, smap, kp, kt, h_out, N, H, W, C, S, 64), st);
    return launch_bf16<128>(
        plan<bf16>(h, c, xg, smap, kp, kt, h_out, N, H, W, C, S, 32), st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// out = {grid x, grid y, blocks per SM} of sp_cell_step at this shape
extern "C" int sp_cell_grid(int* out, int N, int H, int W, int C, int dtype) {
  const int P = N * H * W, tiles = (P + sp::BM - 1) / sp::BM;
  if (dtype == 0)
    return sp::grid_report<cell_f32>(dim3(tiles, C / F32_CH), sp::F32_THREADS,
                                     F32_SMEM, out);
  if (C % 64 == 0)
    return sp::grid_report<cell_bf16<256>>(dim3(tiles, C / 64), sp::WG_THREADS,
                                           sp::wg_smem_bytes<256>(), out);
  return sp::grid_report<cell_bf16<128>>(dim3(tiles, C / 32), sp::WG_THREADS,
                                         sp::wg_smem_bytes<128>(), out);
}

extern "C" const char* sp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
