// The conditioner+head compositions of a stack of conditioner kernels, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package composes with XLA's convs and
// einsums (scanpaths_tpu/models/components.py::fuse_cond_head), one entry at
// a time.  It was added because the port's stock-op composition launched
// ~126 small kernels an entry, its 11x11 `keff` conv run by cuDNN as an FFT,
// and COCO's bank composed the batch's distinct target ids behind a host
// sync: the card idled while the host launched.
//
// What it computes, for each of K HWIO conditioner kernels k1 [5, 5, C, C]
// with bias b1 [C], and the head's w2, w3 [C] and kd [7, 7, C] (with their
// biases), as ops/compose.py::fuse_cond_head does: every product is one of
//
//   T[a, b, i, n] = sum_o k1[a, b, i, o] W[o, n],  W = [kd's 49 taps|w2|w3]
//
// (n = 7 p + q for kd[p, q, :], 49 for w2, 50 for w3), folded as
//
//   k_sa[a, b, i, :] = T[a, b, i, 49:51]
//   keff[P, Q, i]    = sum_{a + p = P, b + q = Q} T[a, b, i, 7 p + q]
//   wr[0, q, i]      = sum_{dx + b = q} T[4, dx, i, b] + sum T[3, dx, i, 7 + b]
//   wr[1, q, i]      = sum_{dx + b = q} T[4, dx, i, 7 + b]
//   wc[P, 0, i]      = sum_{a + p = P} T[a, 4, i, 7 p] + sum T[a, 3, i, 7p+1]
//   wc[P, 1, i]      = sum_{a + p = P} T[a, 4, i, 7 p + 1]
//   wcc[y, x, i]     = sum_{j = y..1, k = x..1} T[y+4-j, x+4-k, i, 7 j + k]
//
// and from the biases b_sa = (b1.w2 + w2b, b1.w3 + w3b), bd = kdb and
// b1map[I, J], the sum of (kd . b1)[p, q] over the taps of the 7x7 stride-5
// window (zero padding 2) that fall inside the H x W map.  Float32 FMAs only
// (no TF32), each sum in a fixed order, so the result does not change from
// run to run.
//
// What bounds it on the H100: at C = 512 the products are 0.67 GFLOP an
// entry and the entry's kernel is 26.2 MB read once; K = 18 (COCO's bank) is
// 12.0 GFLOP, 0.18 ms at the float32 peak of 67 TFLOP/s, against 0.14 ms to
// read the 0.47 GB at 3.35 TB/s: operations, with the bytes close behind.
//
// The design:
// * A block owns one entry and 5 input channels i: the 125 rows (i, a, b) of
//   T, which hold every product the folds of those channels need, so T
//   (47 MB at K = 18) never reaches device memory.  At C = 512 an entry is
//   103 blocks and one for its biases, K = 18 1,872: about seven waves of
//   the 132 SMs at two blocks each; K = 1 one wave.
// * The products are a [125 x C] x [C x 51] matrix product in float32 FMAs:
//   rows padded to 128 and columns to 64, each of the 256 threads holds an
//   8 x 4 tile of the sums, and the reduction over o walks 16 channels a
//   stage through two shared-memory stages, the next stage's loads in flight
//   in registers while the current one is multiplied.  The kernel's rows are
//   read at their own strides (a bank entry is HWIO-contiguous, an nn.Conv2d
//   weight's HWIO view has o outermost), neighbouring threads on
//   neighbouring addresses either way; W comes from kd, w2 and w3 as they
//   lie, through L2.
// * The tile of T goes to shared memory, and the block folds it into its
//   channels' 219 outputs; one more block an entry contracts the biases.
// * One launch for up to 32 entries (their addresses in the kernel's
//   parameters), on the caller's stream, with no synchronisation and no
//   scratch: the wrapper allocates the outputs.
#include <cuda_runtime.h>

namespace {

constexpr int MAXK = 32;                  // entries a launch
constexpr int IS = 5;                     // input channels a block
constexpr int ROWS = 25 * IS;             // its rows of T: (i, a, b)
constexpr int BM = 128;                   // rows, padded
constexpr int NT = 51;                    // columns of W: kd's 49 taps, w2, w3
constexpr int BN = 64;                    // columns, padded
constexpr int OK = 16;                    // reduction channels a stage
constexpr int THREADS = 256;
constexpr int AS = BM + 4;                // a stage row of A in smem, floats
constexpr int TS = 52;                    // a row of T in smem, floats
constexpr int LA = (ROWS * OK + THREADS - 1) / THREADS;  // A loads a stage
constexpr int LW = OK * BN / THREADS;     // W loads a stage
constexpr int STAGES = 2 * OK * AS + 2 * OK * BN;
constexpr int SMEM = STAGES > ROWS * TS ? STAGES : ROWS * TS;
constexpr int OUTS = 50 + 121 + 22 + 22 + 4;  // outputs a channel

struct Params {
  const float* k[MAXK];  // the launch's entries [5, 5, C, C] at sa, sb, si, so
  const float* b[MAXK];  // their biases [C], contiguous
  int sa, sb, si, so;
  const float *kd, *w2, *w3, *w2b, *w3b, *kdb;
  int kp, kq, ko, s2, s3;  // kd's strides (p, q, o); w2's and w3's
  float *k_sa, *b_sa, *keff, *wr, *wc, *wcc, *b1map, *bd;
  int k0, C, H, W, h5, w5;  // k0: the launch's first entry in the outputs
};

// W's column n over o: its first element and stride (null for a pad column)
__device__ __forceinline__ const float* w_column(const Params& p, int n,
                                                 int& stride) {
  if (n < 49) {
    stride = p.ko;
    return p.kd + (n / 7) * p.kp + (n % 7) * p.kq;
  }
  stride = n == 49 ? p.s2 : p.s3;
  return n == 49 ? p.w2 : n == 50 ? p.w3 : nullptr;
}

// The entry's bias terms: (kd . b1)[p, q] and b1 . w2, b1 . w3 into sm[0..51)
// (a warp a dot product, lanes over o, summed in a fixed order), then b_sa,
// bd and b1map.
__device__ void bias_block(const Params& p, int kl, int kg, float* sm) {
  const float* b1 = p.b[kl];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int n = warp; n < NT; n += THREADS / 32) {
    int stride;
    const float* col = w_column(p, n, stride);
    float s = 0.f;
    for (int o = lane; o < p.C; o += 32)
      s = fmaf(__ldg(col + (size_t)o * stride), __ldg(b1 + o), s);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) sm[n] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    p.b_sa[2 * kg] = sm[49] + *p.w2b;
    p.b_sa[2 * kg + 1] = sm[50] + *p.w3b;
    p.bd[kg] = *p.kdb;
  }
  const int hw5 = p.h5 * p.w5;
  for (int q = threadIdx.x; q < hw5; q += THREADS) {
    const int I = q / p.w5, J = q - I * p.w5;
    float s = 0.f;
    for (int pp = 0; pp < 7; ++pp) {
      const int y = 5 * I + pp - 2;
      if (y < 0 || y >= p.H) continue;
      for (int qq = 0; qq < 7; ++qq) {
        const int x = 5 * J + qq - 2;
        if (x >= 0 && x < p.W) s += sm[pp * 7 + qq];
      }
    }
    p.b1map[(size_t)kg * hw5 + q] = s;
  }
}

__global__ void __launch_bounds__(THREADS, 2) compose_bank(const Params p) {
  __shared__ __align__(16) float sm[SMEM];
  const int kl = blockIdx.y, kg = p.k0 + kl, t = threadIdx.x;
  const int groups = (p.C + IS - 1) / IS;
  if (blockIdx.x == groups) {
    bias_block(p, kl, kg, sm);
    return;
  }
  const int i0 = blockIdx.x * IS, nch = min(IS, p.C - i0);
  const float* __restrict__ k1 = p.k[kl];

  // This thread's loads of a stage: A element (row m = 25 il + 5 a + b,
  // channel o) from k1 + src + o0 * so into sm[dst] = stage[o][m], with o
  // innermost across threads where o is k1's unit stride, else m; src -1
  // for a channel past C (stored as 0).  W: column n = t % 64, channels
  // t / 64 + 4 r.
  const bool o_inner = p.so == 1;
  int src[LA], dst[LA];
#pragma unroll
  for (int r = 0; r < LA; ++r) {
    const int e = t + r * THREADS;
    const int o = o_inner ? e % OK : e / ROWS;
    const int m = o_inner ? e / OK : e % ROWS;
    const int il = m / 25, ab = m - il * 25;
    dst[r] = e < ROWS * OK ? o * AS + m : -1;
    src[r] = il < nch ? (ab / 5) * p.sa + (ab % 5) * p.sb + (i0 + il) * p.si +
                            o * p.so
                      : -1;
  }
  const int wn = t % BN, wo = t / BN;
  int wstride;
  const float* wcol = w_column(p, wn, wstride);

  float ra[LA], rw[LW];
  auto fetch = [&](int o0) {
    const float* kb = k1 + (size_t)o0 * p.so;
#pragma unroll
    for (int r = 0; r < LA; ++r) {
      ra[r] = 0.f;
      if (dst[r] >= 0 && src[r] >= 0 && o0 + dst[r] / AS < p.C)
        ra[r] = __ldg(kb + src[r]);
    }
#pragma unroll
    for (int r = 0; r < LW; ++r) {
      const int o = o0 + wo + r * (THREADS / BN);
      rw[r] = wcol != nullptr && o < p.C ? __ldg(wcol + (size_t)o * wstride)
                                         : 0.f;
    }
  };
  auto stash = [&](int s) {
    float* as = sm + s * OK * AS;
    float* ws = sm + 2 * OK * AS + s * OK * BN;
#pragma unroll
    for (int r = 0; r < LA; ++r)
      if (dst[r] >= 0) as[dst[r]] = ra[r];
#pragma unroll
    for (int r = 0; r < LW; ++r)
      ws[(wo + r * (THREADS / BN)) * BN + wn] = rw[r];
  };

  // the pad rows ROWS..BM of both stages stay zero
  for (int i = t; i < 2 * OK * (BM - ROWS); i += THREADS) {
    const int row = i / (BM - ROWS), m = ROWS + i % (BM - ROWS);
    sm[row * AS + m] = 0.f;
  }
  fetch(0);
  stash(0);
  __syncthreads();

  const int ty = t / 16, tx = t % 16;  // rows 8 ty.., columns 4 tx..
  float acc[8][4] = {};
  const int chunks = (p.C + OK - 1) / OK;
  for (int ch = 0; ch < chunks; ++ch) {
    const int s = ch & 1;
    if (ch + 1 < chunks) fetch((ch + 1) * OK);
    const float* as = sm + s * OK * AS + ty * 8;
    const float* ws = sm + 2 * OK * AS + s * OK * BN + tx * 4;
#pragma unroll
    for (int kk = 0; kk < OK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * AS);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * AS + 4);
      const float4 w = *reinterpret_cast<const float4*>(ws + kk * BN);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], wv[c], acc[r][c]);
    }
    if (ch + 1 < chunks) stash(s ^ 1);
    __syncthreads();
  }

  // T's tile into smem (the stages are free: the loop ended on a barrier)
  if (tx < (NT + 3) / 4) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int m = ty * 8 + r;
      if (m < ROWS)
        *reinterpret_cast<float4*>(sm + m * TS + tx * 4) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();

  // the folds: output w of channel i0 + il, neighbouring threads on
  // neighbouring channels
  const int C = p.C;
  for (int u = t; u < nch * OUTS; u += THREADS) {
    const int il = u % nch, i = i0 + il;
    int w = u / nch;
    const float* T = sm + il * 25 * TS;
    auto tv = [&](int a, int b, int n) { return T[(a * 5 + b) * TS + n]; };
    if (w < 50) {
      const int ab = w >> 1, o = w & 1;
      p.k_sa[(((size_t)kg * 25 + ab) * C + i) * 2 + o] = T[ab * TS + 49 + o];
      continue;
    }
    w -= 50;
    if (w < 121) {
      const int P = w / 11, Q = w - P * 11;
      float s = 0.f;
      for (int a = max(0, P - 6); a <= min(4, P); ++a)
        for (int b = max(0, Q - 6); b <= min(4, Q); ++b)
          s += tv(a, b, (P - a) * 7 + Q - b);
      p.keff[((size_t)kg * 121 + w) * C + i] = s;
      continue;
    }
    w -= 121;
    if (w < 22) {
      const int y = w / 11, q = w - y * 11;
      float s = 0.f, s3 = 0.f;
      for (int dx = max(0, q - 6); dx <= min(4, q); ++dx) {
        s += tv(4, dx, 7 * y + q - dx);
        if (y == 0) s3 += tv(3, dx, 7 + q - dx);
      }
      p.wr[(((size_t)kg * 2 + y) * 11 + q) * C + i] = s + s3;
      continue;
    }
    w -= 22;
    if (w < 22) {
      const int P = w >> 1, x = w & 1;
      float s = 0.f, s3 = 0.f;
      for (int a = max(0, P - 6); a <= min(4, P); ++a) {
        s += tv(a, 4, (P - a) * 7 + x);
        if (x == 0) s3 += tv(a, 3, (P - a) * 7 + 1);
      }
      p.wc[(((size_t)kg * 11 + P) * 2 + x) * C + i] = s + s3;
      continue;
    }
    w -= 22;
    const int y = w >> 1, x = w & 1;
    float s = 0.f;
    for (int j = y; j < 2; ++j)
      for (int k = x; k < 2; ++k) s += tv(y + 4 - j, x + 4 - k, j * 7 + k);
    p.wcc[(((size_t)kg * 2 + y) * 2 + x) * C + i] = s;
  }
}

}  // namespace

// ks, bs: host arrays of K entry and bias addresses (float32; each entry
// [5, 5, C, C] at strides sa, sb, si, so in elements, each bias [C]
// contiguous); kd [7, 7, C] at kp, kq, ko; w2, w3 [C] at s2, s3; w2b, w3b,
// kdb one float each, on the card.  Outputs contiguous float32: k_sa
// [K, 5, 5, C, 2], b_sa [K, 2], keff [K, 11, 11, C], wr [K, 2, 11, C], wc
// [K, 11, 2, C], wcc [K, 2, 2, C], b1map [K, h5, w5], bd [K].  One launch per
// 32 entries, on `stream`.  Returns cudaGetLastError() after the launches
// (0 = cudaSuccess).
extern "C" int sp_cond_compose(const void* ks, const void* bs, const void* kd,
                               const void* w2, const void* w3, const void* w2b,
                               const void* w3b, const void* kdb, void* k_sa,
                               void* b_sa, void* keff, void* wr, void* wc,
                               void* wcc, void* b1map, void* bd, int K, int C,
                               int H, int W, int h5, int w5, int sa, int sb,
                               int si, int so, int kp, int kq, int ko, int s2,
                               int s3, void* stream) {
  // an entry's offsets within a stage are ints
  const long long span = 4LL * sa + 4LL * sb + (C - 1LL) * si + (OK - 1LL) * so;
  if (K < 1 || C < 1 || h5 < 1 || w5 < 1 || sa < 0 || sb < 0 || si < 0 ||
      so < 0 || span >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* kp_in = static_cast<const float* const*>(ks);
  const float* const* bp_in = static_cast<const float* const*>(bs);
  Params p;
  p.sa = sa; p.sb = sb; p.si = si; p.so = so;
  p.kd = static_cast<const float*>(kd);
  p.w2 = static_cast<const float*>(w2);
  p.w3 = static_cast<const float*>(w3);
  p.w2b = static_cast<const float*>(w2b);
  p.w3b = static_cast<const float*>(w3b);
  p.kdb = static_cast<const float*>(kdb);
  p.kp = kp; p.kq = kq; p.ko = ko; p.s2 = s2; p.s3 = s3;
  p.k_sa = static_cast<float*>(k_sa);
  p.b_sa = static_cast<float*>(b_sa);
  p.keff = static_cast<float*>(keff);
  p.wr = static_cast<float*>(wr);
  p.wc = static_cast<float*>(wc);
  p.wcc = static_cast<float*>(wcc);
  p.b1map = static_cast<float*>(b1map);
  p.bd = static_cast<float*>(bd);
  p.C = C; p.H = H; p.W = W; p.h5 = h5; p.w5 = w5;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (C + IS - 1) / IS;
  for (int k0 = 0; k0 < K; k0 += MAXK) {
    const int n = K - k0 < MAXK ? K - k0 : MAXK;
    p.k0 = k0;
    for (int j = 0; j < n; ++j) {
      p.k[j] = kp_in[k0 + j];
      p.b[j] = bp_in[k0 + j];
    }
    compose_bank<<<dim3(groups + 1, n), THREADS, 0, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
