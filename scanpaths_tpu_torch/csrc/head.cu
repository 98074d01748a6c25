// The decoder's per-step composed conditioner+head, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves these convs to XLA
// (scanpaths_tpu/models/components.py::apply_fused_cond_head).  It was added
// because cuDNN ran them at ~0.5% of their bound: with 2 and 1 output
// channels its implicit GEMM has a handful of output tiles, each walking the
// 12,800-deep reduction (25 taps x 512 channels) alone, and the time did not
// fall with the batch.
//
// What it computes, per sample, from h [N, H, W, C] (zero outside the image)
// and the fields of models/components.py::fuse_cond_head, as
// ops/head.py::cond_head_plain does:
//
//   sa[y, x, o] = sum_{dy, dx < 5, c} h[y + dy - 2, x + dx - 2, c] k_sa[dy, dx, c, o]
//   stop        = mean_{y, x} sa[y, x, 0] + b_sa[0]
//   amap[y, x]  = relu(sa[y, x, 1] + b_sa[1])
//   d[i, j]     = sum_{p, q < 11, c} h[5i + p - 4, 5j + q - 4, c] keff[p, q, c]
//               - [i = 0] sum_{y < 2, q < 11, c} h[y, 5j + q - 4, c] wr[y, q, c]
//               - [j = 0] sum_{p < 11, x < 2, c} h[5i + p - 4, x, c] wc[p, x, c]
//               + [i = j = 0] sum_{y, x < 2, c} h[y, x, c] wcc[y, x, c]
//               + b1map[i, j] + bd
//
// Fields with a leading [N] axis (COCO's bank, one entry a sample) are read
// at a per-sample stride, 0 when the fields are shared.  h is float32 or
// bfloat16 (widened to float32 as it is loaded); the fields, the sums and
// the outputs are float32.
//
// What bounds it on the H100: at N = 16, 30x40, C = 512 the 5x5 C->2 conv is
// 0.98 GFLOP and the 11x11 stride-5 C->1 conv 0.095 GFLOP, 16 us at the
// float32 peak of 67 TFLOP/s (TF32 off, so FFMA on the CUDA cores), against
// 11.7 us to read h's 39.3 MB once: operations, with the bytes close behind.
//
// The design:
// * The reduction over C is split across blocks.  A block owns a 6 x 40
//   pixel tile of one sample and a slice of 16 channels, so at 30x40 and
//   C = 512 N = 1 launches 160 blocks (5 tiles x 32 slices) and N = 16 2560:
//   enough blocks in flight at both.  The block reads its tile of h, with
//   the 2-pixel halo of the 5x5, from device memory once, 16 bytes at a time
//   along C, and holds it channel-major in shared memory; its weights arrive
//   16 bytes at a time too.  At N = 1 a block's time is mostly waiting on
//   device memory, so the loads go out in batches before any is stored.
// * The 5x5: each of the four warps takes 4 of the 16 channels; a lane holds
//   2 x 4 output pixels and both output channels in 16 accumulators, and
//   reads each of its 6 input rows as two float4 and each tap row's
//   weights as float4 broadcasts: 400 FFMA a channel for 42 shared loads.
// * The 11x11/5 and the border corrections: a thread per (window, channel)
//   walks the window's pixels inside the tile, a row's 11 taps unrolled
//   into two chains; wr, wc and wcc enter where the formula above has them,
//   so the corrections stay in the kernel.
// * No atomics: a block sums its four warps' channels in a fixed order and
//   writes its partials (the action map per pixel, the stop map's sum, each
//   window's sum); a second kernel adds the slices' and tiles' partials in a
//   fixed order and applies the biases, so the result does not change from
//   run to run.  The two kernels are one launch of the op, on the caller's
//   stream, with no synchronisation; the wrapper allocates the outputs and
//   the partials (sp_cond_head_plan gives their size).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TY = 6, TX = 40;            // a block's tile of output pixels
constexpr int IR = TY + 4, IC = TX + 4;   // its input rows and columns
constexpr int PL = IR * IC + 4;           // a channel's plane in smem, floats
constexpr int CS = 16;                    // channels a block
constexpr int WARPS = 4, CW = CS / WARPS; // channels a warp (5x5)
constexpr int THREADS = 32 * WARPS;
constexpr int LANES = (TY / 2) * (TX / 4);  // lanes holding the tile
constexpr int WSA = 12;                   // a tap row's 10 weights, padded
constexpr int KT = 121;                   // 11 x 11 taps
constexpr int NB = 48;                    // wr 22, wc 22, wcc 4 a channel
constexpr int MAXWIN = 4 * 10;            // windows a tile touches, at most
constexpr int FIN_THREADS = 256;

// the fuse_cond_head fields, float32, contiguous
struct Fields {
  const float *k_sa, *b_sa, *keff, *wr, *wc, *wcc, *b1map, *bd;
};

template <typename T>
struct Args {
  const T* __restrict__ h;
  Fields f;
  float* __restrict__ part_a;  // [N][slices][H * W]  action-map partials
  float* __restrict__ part_d;  // [N][slices * tiles][h5 * w5]
  float* __restrict__ part_s;  // [N][slices * tiles]  stop-map sums
  int N, H, W, C, h5, w5, tiles_x, tiles, slices, per_sample;
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(b[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// Loads go out in batches of B, all issued before any is stored to shared
// memory, so a block waits on device memory a few times, not once a load.
constexpr int B = 4;

// The block's tile of h with its halo, channels c0..c0+CS, into
// hs[c * PL + ry * IC + rx] (input row y0 - 2 + ry, column x0 - 2 + rx).
template <typename T>
__device__ __forceinline__ void stage_h(const Args<T>& a, float* hs, int n,
                                        int y0, int x0, int c0) {
  constexpr int V = 16 / sizeof(T), VPP = CS / V, NV = IR * IC * VPP;
  for (int i0 = threadIdx.x; i0 < NV; i0 += B * THREADS) {
    float v[B][V];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * THREADS, pix = i / VPP, cv = i - pix * VPP;
      const int ry = pix / IC, rx = pix - ry * IC;
      const int y = y0 - 2 + ry, x = x0 - 2 + rx;
      if (i < NV && y >= 0 && y < a.H && x >= 0 && x < a.W) {
        load16(a.h + ((size_t)(n * a.H + y) * a.W + x) * a.C + c0 + cv * V,
               v[b]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) v[b][k] = 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * THREADS, pix = i / VPP, cv = i - pix * VPP;
      if (i < NV) {
#pragma unroll
        for (int k = 0; k < V; ++k) hs[(cv * V + k) * PL + pix] = v[b][k];
      }
    }
  }
}

// The slice's weights, each tap's 16 channels (32 values of k_sa) as float4
// loads: wsa[c][dy][dx * 2 + o] (rows padded to WSA), wk[c][p * 11 + q],
// wb[c][wr y * 11 + q | 22 + wc p * 2 + x | 44 + wcc y * 2 + x].
constexpr int Q_SA = 25 * CS * 2 / 4, Q_K = KT * CS / 4, Q_B = NB * CS / 4;
constexpr int Q_ALL = Q_SA + Q_K + Q_B;

__device__ __forceinline__ const float* weight_quad(const Fields& f, int C,
                                                    int c0, int i) {
  if (i < Q_SA) {  // tap t, channels 2 j, 2 j + 1, both outputs
    const int t = i / (CS / 2), j = i - t * (CS / 2);
    return f.k_sa + ((size_t)t * C + c0) * 2 + 4 * j;
  }
  i -= Q_SA;
  const int t = i / (CS / 4), j = i - t * (CS / 4);
  if (i < Q_K) return f.keff + (size_t)t * C + c0 + 4 * j;
  const int u = t - KT;
  const float* src = u < 22 ? f.wr + (size_t)u * C
                   : u < 44 ? f.wc + (size_t)(u - 22) * C
                            : f.wcc + (size_t)(u - 44) * C;
  return src + c0 + 4 * j;
}

__device__ __forceinline__ void store_quad(int i, const float4& q, float* wsa,
                                           float* wk, float* wb) {
  if (i < Q_SA) {
    const int t = i / (CS / 2), c = 2 * (i - t * (CS / 2));
    float* d = wsa + c * 5 * WSA + (t / 5) * WSA + (t % 5) * 2;
    d[0] = q.x; d[1] = q.y; d[5 * WSA] = q.z; d[5 * WSA + 1] = q.w;
    return;
  }
  i -= Q_SA;
  const int t = i / (CS / 4), c = 4 * (i - t * (CS / 4));
  float* d = i < Q_K ? wk + c * KT + t : wb + c * NB + (t - KT);
  const int st = i < Q_K ? KT : NB;
  d[0] = q.x; d[st] = q.y; d[2 * st] = q.z; d[3 * st] = q.w;
}

__device__ __forceinline__ void stage_w(const Fields& f, int C, int c0,
                                        float* wsa, float* wk, float* wb) {
  for (int i0 = threadIdx.x; i0 < Q_ALL; i0 += B * THREADS) {
    float4 q[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int i = i0 + b * THREADS;
      q[b] = i < Q_ALL ? __ldg(reinterpret_cast<const float4*>(
                             weight_quad(f, C, c0, i)))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < B; ++b)
      if (i0 + b * THREADS < Q_ALL) store_quad(i0 + b * THREADS, q[b], wsa, wk, wb);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) head_part(const Args<T> a) {
  __shared__ __align__(16) float hs[CS * PL];
  __shared__ __align__(16) float wsa[CS * 5 * WSA];
  __shared__ float wk[CS * KT];
  __shared__ float wb[CS * NB];
  __shared__ float kred[MAXWIN * CS];
  __shared__ float sred[WARPS];

  const int tile = blockIdx.x, slice = blockIdx.y, n = blockIdx.z;
  const int ty = tile / a.tiles_x, tx = tile - ty * a.tiles_x;
  const int y0 = ty * TY, x0 = tx * TX, c0 = slice * CS;
  const int ye = min(y0 + TY, a.H), xe = min(x0 + TX, a.W);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Fields f = a.f;
  if (a.per_sample) {
    f.k_sa += (size_t)n * 50 * a.C;
    f.keff += (size_t)n * KT * a.C;
    f.wr += (size_t)n * 22 * a.C;
    f.wc += (size_t)n * 22 * a.C;
    f.wcc += (size_t)n * 4 * a.C;
  }
  stage_h(a, hs, n, y0, x0, c0);
  stage_w(f, a.C, c0, wsa, wk, wb);
  __syncthreads();

  // the 5x5 C->2 conv: lane (rp, sx) holds output rows y0 + 2 rp + r,
  // columns x0 + 4 sx + k; input row y0 + 2 rp + ry - 2 is smem row
  // 2 rp + ry, and its columns x - 2 + dx smem columns 4 sx + k + dx
  const int rp = lane / (TX / 4), sx = lane - rp * (TX / 4);
  float acc0[2][4] = {}, acc1[2][4] = {};
  if (lane < LANES) {
#pragma unroll 1
    for (int cl = 0; cl < CW; ++cl) {
      const int c = warp * CW + cl;
      const float* hp = hs + c * PL + 2 * rp * IC + 4 * sx;
      const float* wp = wsa + c * 5 * WSA;
#pragma unroll
      for (int ry = 0; ry < 6; ++ry) {
        const float4 lo = *reinterpret_cast<const float4*>(hp + ry * IC);
        const float4 hi = *reinterpret_cast<const float4*>(hp + ry * IC + 4);
        const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int dy = ry - r;
          if (dy < 0 || dy > 4) continue;
          const float4 w0 = *reinterpret_cast<const float4*>(wp + dy * WSA);
          const float4 w1 = *reinterpret_cast<const float4*>(wp + dy * WSA + 4);
          const float4 w2 = *reinterpret_cast<const float4*>(wp + dy * WSA + 8);
          const float w[10] = {w0.x, w0.y, w0.z, w0.w, w1.x,
                               w1.y, w1.z, w1.w, w2.x, w2.y};
#pragma unroll
          for (int dx = 0; dx < 5; ++dx)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc0[r][k] = fmaf(v[k + dx], w[2 * dx], acc0[r][k]);
              acc1[r][k] = fmaf(v[k + dx], w[2 * dx + 1], acc1[r][k]);
            }
        }
      }
    }
  }
  // the stop map's sum over the tile's pixels and the warp's channels
  float stop = 0.f;
  if (lane < LANES) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (y0 + 2 * rp + r < a.H && x0 + 4 * sx + k < a.W) stop += acc0[r][k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) stop += __shfl_xor_sync(0xffffffffu, stop, o);
  if (lane == 0) sred[warp] = stop;

  // the 11x11/5 windows that meet the tile: i with 5i - 4 <= ye - 1 and
  // 5i + 6 >= y0, likewise j
  const int i_lo = y0 <= 6 ? 0 : (y0 - 2) / 5;
  const int i_hi = min(a.h5 - 1, (ye + 3) / 5);
  const int j_lo = x0 <= 6 ? 0 : (x0 - 2) / 5;
  const int j_hi = min(a.w5 - 1, (xe + 3) / 5);
  const int nwi = max(0, i_hi - i_lo + 1), nwj = max(0, j_hi - j_lo + 1);
  // hs index of image pixel (y, x): hrow(y) + x
  auto hrow = [&](int c, int y) { return c * PL + (y - y0 + 2) * IC + 2 - x0; };
  for (int pr = threadIdx.x; pr < nwi * nwj * CS; pr += THREADS) {
    const int c = pr % CS, w = pr / CS;
    const int wi = i_lo + w / nwj, wj = j_lo + w % nwj;
    const int ra = max(5 * wi - 4, y0), rb = min(5 * wi + 7, ye);
    const int ca = max(5 * wj - 4, x0), cb = min(5 * wj + 7, xe);
    const float* kc = wk + c * KT;
    const float* bc = wb + c * NB;
    // a window row's 11 taps unrolled and predicated, in two chains
    float s = 0.f, s1 = 0.f;
    for (int y = ra; y < rb; ++y) {
      const int hb = hrow(c, y) + 5 * wj - 4, kb = (y - 5 * wi + 4) * 11;
#pragma unroll
      for (int q = 0; q < 11; ++q) {
        const int x = 5 * wj - 4 + q;
        if (x >= ca && x < cb) {
          if (q & 1) s1 = fmaf(hs[hb + q], kc[kb + q], s1);
          else s = fmaf(hs[hb + q], kc[kb + q], s);
        }
      }
    }
    s += s1;
    if (wi == 0)  // image rows 0 and 1 under the window
      for (int y = y0; y < min(ye, 2); ++y) {
        const int hb = hrow(c, y), kb = y * 11 + 4 - 5 * wj;
        for (int x = ca; x < cb; ++x) s = fmaf(-hs[hb + x], bc[kb + x], s);
      }
    if (wj == 0)  // image columns 0 and 1 under the window
      for (int y = ra; y < rb; ++y) {
        const int hb = hrow(c, y), kb = 22 + (y - 5 * wi + 4) * 2;
        for (int x = x0; x < min(xe, 2); ++x) s = fmaf(-hs[hb + x], bc[kb + x], s);
      }
    if (wi == 0 && wj == 0)  // the corner, subtracted twice above
      for (int y = y0; y < min(ye, 2); ++y)
        for (int x = x0; x < min(xe, 2); ++x)
          s = fmaf(hs[hrow(c, y) + x], bc[44 + y * 2 + x], s);
    kred[w * CS + c] = s;
  }
  __syncthreads();  // kred and sred complete; hs is free

  const int hw5 = a.h5 * a.w5, blk = slice * a.tiles + tile;
  const size_t row = (size_t)n * a.slices * a.tiles + blk;
  for (int q = threadIdx.x; q < hw5; q += THREADS) {
    const int i = q / a.w5, j = q - i * a.w5;
    float s = 0.f;
    if (i >= i_lo && i <= i_hi && j >= j_lo && j <= j_hi) {
      const float* kr = kred + ((i - i_lo) * nwj + (j - j_lo)) * CS;
#pragma unroll
      for (int c = 0; c < CS; ++c) s += kr[c];
    }
    a.part_d[row * hw5 + q] = s;
  }
  if (threadIdx.x == 0) a.part_s[row] = sred[0] + sred[1] + sred[2] + sred[3];

  // the action map's partial: the four warps' channels, summed in order
  float* red = hs;
  if (lane < LANES) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        red[warp * TY * TX + (2 * rp + r) * TX + 4 * sx + k] = acc1[r][k];
  }
  __syncthreads();
  float* pa = a.part_a + ((size_t)n * a.slices + slice) * a.H * a.W;
  for (int i = threadIdx.x; i < TY * TX; i += THREADS) {
    const int ly = i / TX, lx = i - ly * TX, y = y0 + ly, x = x0 + lx;
    if (y < a.H && x < a.W)
      pa[y * a.W + x] = ((red[i] + red[TY * TX + i]) + red[2 * TY * TX + i]) +
                        red[3 * TY * TX + i];
  }
}

// The slices' and tiles' partials summed in a fixed order, with the biases:
// block (bx, n) writes amap's pixels bx * FIN_THREADS...; then warp 0 of
// block (0, n) the stop logit, and the sample's other warps d, a window a
// warp in turn.
__global__ void __launch_bounds__(FIN_THREADS)
head_finish(const Fields f, const float* __restrict__ part_a,
            const float* __restrict__ part_d, const float* __restrict__ part_s,
            float* __restrict__ stop, float* __restrict__ amap,
            float* __restrict__ d, int H, int W, int h5, int w5, int slices,
            int tiles, int per_sample) {
  const int n = blockIdx.y, hw = H * W, hw5 = h5 * w5, K = slices * tiles;
  const float* b_sa = f.b_sa + (per_sample ? 2 * n : 0);
  const int pix = blockIdx.x * FIN_THREADS + threadIdx.x;
  if (pix < hw) {
    const float* pa = part_a + (size_t)n * slices * hw + pix;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < slices; ++k) s += pa[(size_t)k * hw];
    amap[(size_t)n * hw + pix] = fmaxf(s + b_sa[1], 0.f);
  }
  constexpr int WPB = FIN_THREADS / 32;  // warps a block
  const int warp = blockIdx.x * WPB + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (warp == 0) {
    const float* ps = part_s + (size_t)n * K;
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += ps[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) stop[n] = s / hw + b_sa[0];
    return;
  }
  const float* b1map = f.b1map + (per_sample ? (size_t)n * hw5 : 0);
  const float bd = f.bd[per_sample ? n : 0];
  for (int q = warp - 1; q < hw5; q += gridDim.x * WPB - 1) {
    const float* pd = part_d + (size_t)n * K * hw5 + q;
    float s = 0.f;
#pragma unroll 4
    for (int k = lane; k < K; k += 32) s += pd[(size_t)k * hw5];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) d[(size_t)n * hw5 + q] = s + b1map[q] + bd;
  }
}

struct Plan {
  int tiles_x, tiles, slices;
  size_t part_a, part_d, part_s;  // floats of each
};

Plan plan(int N, int H, int W, int C, int h5, int w5) {
  Plan p;
  p.tiles_x = (W + TX - 1) / TX;
  p.tiles = p.tiles_x * ((H + TY - 1) / TY);
  p.slices = C / CS;
  p.part_a = (size_t)N * p.slices * H * W;
  p.part_d = (size_t)N * p.slices * p.tiles * h5 * w5;
  p.part_s = (size_t)N * p.slices * p.tiles;
  return p;
}

template <typename T>
int launch(const void* h, const Fields& f, float* stop, float* amap, float* d,
           float* scratch, int N, int H, int W, int C, int h5, int w5,
           int per_sample, cudaStream_t st) {
  const Plan p = plan(N, H, W, C, h5, w5);
  Args<T> a;
  a.h = static_cast<const T*>(h);
  a.f = f;
  a.part_a = scratch;
  a.part_d = scratch + p.part_a;
  a.part_s = a.part_d + p.part_d;
  a.N = N; a.H = H; a.W = W; a.C = C; a.h5 = h5; a.w5 = w5;
  a.tiles_x = p.tiles_x; a.tiles = p.tiles; a.slices = p.slices;
  a.per_sample = per_sample;
  head_part<T><<<dim3(p.tiles, p.slices, N), THREADS, 0, st>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  head_finish<<<dim3((H * W + FIN_THREADS - 1) / FIN_THREADS, N), FIN_THREADS,
                0, st>>>(f, a.part_a, a.part_d, a.part_s, stop, amap, d, H, W,
                         h5, w5, p.slices, p.tiles, per_sample);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h [N, H, W, C] (dtype 0 = float32, 1 = bfloat16); the fields float32 and
// contiguous, with a leading [N] axis when per_sample; stop [N], amap
// [N, H, W], d [N, h5, w5] float32; scratch: sp_cond_head_plan's out[2]
// floats.  Needs C % 16 == 0 and 16-byte aligned h, k_sa, keff, wr, wc and
// wcc.  Returns
// cudaGetLastError() after the launches (0 = cudaSuccess).
extern "C" int sp_cond_head(const void* h, const void* k_sa, const void* b_sa,
                            const void* keff, const void* wr, const void* wc,
                            const void* wcc, const void* b1map, const void* bd,
                            void* stop, void* amap, void* d, void* scratch,
                            int N, int H, int W, int C, int h5, int w5,
                            int per_sample, int dtype, void* stream) {
  if (C % CS || N < 1 || N > 65535 || h5 < 1 || w5 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Fields f = {static_cast<const float*>(k_sa), static_cast<const float*>(b_sa),
                    static_cast<const float*>(keff), static_cast<const float*>(wr),
                    static_cast<const float*>(wc), static_cast<const float*>(wcc),
                    static_cast<const float*>(b1map), static_cast<const float*>(bd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *so = static_cast<float*>(stop), *ao = static_cast<float*>(amap),
        *dout = static_cast<float*>(d), *sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return launch<float>(h, f, so, ao, dout, sc, N, H, W, C, h5, w5, per_sample, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, f, so, ao, dout, sc, N, H, W, C, h5, w5,
                                 per_sample, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out = {blocks of the first kernel, blocks per SM, scratch floats} at this
// shape
extern "C" int sp_cond_head_plan(int* out, int N, int H, int W, int C, int h5,
                                 int w5) {
  const Plan p = plan(N, H, W, C, h5, w5);
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, head_part<float>, THREADS, 0);
  out[0] = p.tiles * p.slices * N;
  out[1] = per_sm;
  out[2] = static_cast<int>(p.part_a + p.part_d + p.part_s);
  return static_cast<int>(err);
}
