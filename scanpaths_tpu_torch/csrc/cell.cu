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
// - float32: CUDA-core FFMAs in a persistent kernel of its own, fed by
//   TMA (cell_f32 below), 64 channels x 4 gates a tile (32 x 4 when
//   C % 64 != 0), each thread holding all four gates of its channels.
// Both evaluate the gates in full float32 precision (expf, tanhf).
//
// h' goes to a separate buffer: other blocks read h's neighbours while
// this block writes, so h cannot be updated in place.  c IS updated in
// place: each element of c is read and written by exactly one thread.
#include <algorithm>

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

// ------------------------------------------------------------- float32
//
// cell_f32<CH>: persistent, FFMAs on the CUDA cores, fed by TMA.  A tile
// is 128 pixels x CH channels x 4 gates (CH = 64, or 32 when C % 64 !=
// 0); its K, the 9 taps x C input channels, comes in chunks of 32.  At
// the main path's shape (16 images, 30x40, C = 512) a step is 362 GFLOP
// over 1200 tiles of 144 chunks: bound by the FP32 FMA rate.
// - Schedule (Sched, Range): one wave of CTAs, the SM count times the CTAs
//   an SM holds.  The tiles that do not fill a whole last round, with the
//   round before them, are cut along K: their (tile, chunk) units are dealt
//   in equal ranges, one a CTA, and every CTA then takes the same number
//   of whole tiles.  A cut tile is finished by the CTA holding its first
//   chunk (its owner); each other piece goes to its CTA's workspace slot
//   and raises that CTA's flag, and the owner adds the pieces in K order,
//   so a call's bits depend on its shape alone.  Ranges are dealt in
//   reverse block order: an owner waits only on lower blocks, and only
//   for the first item of their walk (its range, then its whole tiles).
// - Feed: thread 0 keeps F_AHEAD chunks of the item in flight in a ring
//   of mbarrier-tracked stages, each filled by TMA: the tap-shifted
//   [128, 32] box of h seen as [P, C] (A) and four [CH, 32] boxes of the
//   packed gate kernel, one a gate (B), both in 128-byte swizzle.
// - Compute: 8 warps of 32; warp w holds tile rows w + 8 i (i < 16) and
//   lane l channels l + 32 j (j < CH / 32) in each of the four gates: 16
//   x 8 accumulators at CH = 64, each one FFMA chain over K.  A warp reads
//   one A row at a time (a broadcast) and 32 B rows (four wavefronts, the
//   least for 512 bytes), 16-byte vectors through the swizzle, and waits
//   on barriers alone.  Each warp zeroes, in the landed stage, those of
//   its own rows whose tap leaves the image (the conv's padding, and the
//   wrap into the next image row): no other warp reads them, so no
//   block-wide barrier is needed.  A chunk's 8 vector steps walk A's
//   stored order, which leaves every address an immediate offset on two
//   registers and permutes the terms of a chunk per warp; the steps are a
//   loop, not unrolled (a longer body measured slower on the card).
//   Why no producer warp: a CTA's registers are granted four warps at a
//   time, so 9 warps get 168 a thread and spill these accumulators
//   (setmaxnreg did not lift ptxas's allocation), while 8 get 255.
// - The epilogue of a whole or owned tile: once every warp is done with
//   the ring, TMA stages the tile's xg and c in it while the threads add
//   the signal taps into the sums; then xg, and the state update into c
//   and h', and the ring goes to the next item's first chunks.

constexpr int F_BK = 32;          // K chunk: 32 floats, one 128-byte row
constexpr int F_THREADS = 256;    // 8 warps
constexpr int F_AHEAD = 2;        // chunks in flight ahead of the one read
constexpr int F_A_BYTES = sp::BM * F_BK * 4;  // 16 KB
constexpr int F_RING = 196608;    // ring bytes, also the epilogue's staging
constexpr int F_BOX = sp::BM * F_BK;  // floats of a staged [128, 32] box

template <int CH>
struct F32Tile {
  static constexpr int kB = 4 * CH * F_BK * 4;     // B stage bytes
  static constexpr int kStage = F_A_BYTES + kB;    // 48 / 32 KB
  static constexpr int kStages = F_RING / kStage;  // 4 / 6
  static constexpr int kNJ = CH / 32;              // channels a thread
  static constexpr int kAcc = 16 * 4 * kNJ;        // accumulators a thread
  static constexpr int kCBox = 4 * kNJ;            // c's first staged box
  static constexpr int kEpiBytes = 5 * kNJ * F_BOX * 4;
  // after xg and c: each row's signal-map taps [S][9][128], and the
  // signal weights of the tile's first two images [2][S][9][3][CH]
  static constexpr int kTaps = kEpiBytes;
  static constexpr int kKp = kTaps + 2 * 9 * sp::BM * 4;
  static constexpr int kArena = kKp + 2 * 2 * 27 * CH * 4 > F_RING
                                    ? kKp + 2 * 2 * 27 * CH * 4
                                    : F_RING;
  static_assert(F_AHEAD + 2 <= kStages, "a stage is free to issue into");
  // the ring; each warp's masks and rows, the barriers; alignment
  static constexpr int kSmem = kArena + 1600 + 8 * (2 * kStages + 1) + 1024;
};

// The persistent schedule of G CTAs over T tiles of KC chunks: R rounds
// of whole tiles and ST tiles (the first ST in tile order) cut into G
// ranges of their U (tile, chunk) units.  ops/cell.py::cell_schedule
// computes the same.
struct Sched {
  int G, KC, R, ST;
  long long U;
  __host__ __device__ Sched(int g, int t, int kc) : G(g), KC(kc) {
    R = t / G;
    if (t % G != 0 && R > 0) --R;  // the ragged round and the one before
    ST = t - R * G;
    U = static_cast<long long>(ST) * KC;
  }
  // the first unit of range r (r = 0 .. G)
  __host__ __device__ long long lo(int r) const { return U * r / G; }
};

// Block b's range of cut units, range G - 1 - b, as items (tile, first
// chunk, end chunk): at most 3, since a range spans under two tiles' units
struct Range {
  long long u, hi;
  int KC;
  __device__ Range(const Sched& sc, int blk)
      : u(sc.lo(sc.G - 1 - blk)), hi(sc.lo(sc.G - blk)), KC(sc.KC) {}
  __device__ bool next(int& t, int& k0, int& k1) {
    if (u >= hi) return false;
    t = static_cast<int>(u / KC);
    k0 = static_cast<int>(u - static_cast<long long>(t) * KC);
    k1 = static_cast<int>(min(static_cast<long long>(KC), k0 + (hi - u)));
    u += k1 - k0;
    return true;
  }
};

// Tile t's first pixel and channel.  Channel slices go in pairs, the
// pixel tile fastest within a pair: a wave's CTAs share two slices of the
// gate kernel and half as many rows of h as a wave of one slice.
__device__ __forceinline__ void tile_at(int t, int PT, int NSL, int CH,
                                        int& p0, int& c0) {
  const int grp = t / (2 * PT), rem = t - grp * 2 * PT;
  const int w = min(2, NSL - 2 * grp);
  p0 = (rem / w) * sp::BM;
  c0 = (2 * grp + rem % w) * CH;
}

// x, opaque to the compiler: an address built on it stays base +
// immediate, instead of one register per offset hoisted out of a loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm("" : "+r"(x));
  return x;
}

// keeps the compiler from hoisting loads across it (register pressure)
__device__ __forceinline__ void load_fence() {
  asm volatile("" ::: "memory");
}

__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

template <int CH>
__global__ void __launch_bounds__(F_THREADS, 1)
    cell_f32(const __grid_constant__ CUtensorMap hmap,
             const __grid_constant__ CUtensorMap wmap,
             const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap cmap,
             const CellArgs<float> a, float* __restrict__ ws,
             int* __restrict__ flags) {
  using Tl = F32Tile<CH>;
  constexpr int NS = Tl::kStages, NJ = Tl::kNJ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (sp::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sbase = sp::smem_addr(smem);
  // each warp's 9 masks of rows inside the image by tap, and its rows'
  // images; the block's items (below)
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + Tl::kArena);
  int* rows = reinterpret_cast<int*>(smem + Tl::kArena + 288);
  int* tab = reinterpret_cast<int*>(smem + Tl::kArena + 1312);
  uint64_t* landed = reinterpret_cast<uint64_t*>(smem + Tl::kArena + 1600);
  uint64_t* empty = landed + NS;
  uint64_t* epi_full = empty + NS;

  const int C = a.C, P = a.N * a.H * a.W;
  const int PT = (P + sp::BM - 1) / sp::BM, NSL = C / CH;
  const int per_tap = C / F_BK;
  const int tid = threadIdx.x, rg = tid >> 5, cg = tid & 31;
  if (tid == 0) {
    // the block's items, kept in shared memory rather than registers: its
    // range of cut units (at most 3 items: the tail of a tile, a whole
    // one, the head of another), then R whole tiles ST + b + G i
    const Sched sc(gridDim.x, PT * NSL, 9 * per_tap);
    Range range(sc, blockIdx.x);
    int n = 0;
    while (n < 3 && range.next(tab[1 + 3 * n], tab[2 + 3 * n], tab[3 + 3 * n]))
      ++n;
    tab[0] = n;
    tab[10] = sc.R;
    tab[11] = sc.ST + blockIdx.x;
    tab[12] = sc.G;
    tab[13] = sc.KC;
    for (int s = 0; s < NS; ++s) {
      sp::mbar_init(&landed[s], 1);  // thread 0 + the TMA bytes
      sp::mbar_init(&empty[s], 8);   // one per warp
    }
    sp::mbar_init(epi_full, 1);      // thread 0 + the TMA bytes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: chunk k of the tile at (ip0, ic0) into ring chunk qq, once
  // the stage's last reads are done
  auto issue = [&](uint32_t qq, int k, int ip0, int ic0) {
    const int s = qq % NS;
    if (qq >= NS) sp::mbar_wait(&empty[s], ((qq / NS) + 1) & 1);
    const int tap = k / per_tap, kq = (k - tap * per_tap) * F_BK;
    int dy, dx;
    sp::tap_shift<9>(tap, 1, dy, dx);
    uint8_t* st = smem + s * Tl::kStage;
    sp::mbar_arrive_expect_tx(&landed[s], Tl::kStage);
    sp::tma_load_2d(st, &hmap, &landed[s], kq, ip0 + dy * a.W + dx);
#pragma unroll
    for (int g = 0; g < 4; ++g)
      sp::tma_load_3d(st + F_A_BYTES + g * (Tl::kB / 4), &wmap, &landed[s],
                      kq, tap, g * C + ic0);
  };
  int t, k0, k1, p0 = 0, c0 = 0;
  uint32_t q = 0;  // chunks through the ring so far
  uint32_t e = 0;  // staged epilogues so far
  int item = 0;    // items begun so far
  // the next item, and its first chunks in flight
  auto next = [&]() {
    const int it = item++;
    if (it < tab[0]) {
      t = tab[1 + 3 * it];
      k0 = tab[2 + 3 * it];
      k1 = tab[3 + 3 * it];
    } else {
      if (it - tab[0] >= tab[10]) return false;
      t = tab[11] + tab[12] * (it - tab[0]);
      k0 = 0;
      k1 = tab[13];
    }
    tile_at(t, PT, NSL, CH, p0, c0);
    if (tid == 0) {
      // the threads' reads of the ring come before TMA writes it again
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int c = 0; c < F_AHEAD && k0 + c < k1; ++c)
        issue(q + c, k0 + c, p0, c0);
    }
    return true;
  };

  const sp::ConvArgs<float> geo{nullptr, nullptr, a.N, a.H, a.W, C, 1,
                                4 * C};
  // the swizzle: 16-byte chunk k of row r sits at chunk k ^ (r & 7).  The
  // warp's A rows are rg mod 8, its lanes' B rows cg mod 8: the A vector
  // stored at chunk v pairs with the B vector at chunk v ^ xr
  const int xr = (rg ^ cg) & 7;
  float acc[16][4][NJ];
  bool have = next();
  while (have) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][g][j] = 0.f;
    // lane l < 9: bit i of the warp's mask for tap l is whether row i's
    // tap lies inside the image; lane 16 + i: row i's image
    __syncwarp();
    if (cg < 9) {
      int dy, dx;
      sp::tap_shift<9>(cg, 1, dy, dx);
      uint32_t m = 0;
      for (int i = 0; i < 16; ++i)
        m |= static_cast<uint32_t>(sp::tap_inside(
                 sp::pixel_yx(geo, p0 + rg + 8 * i), dy, dx, a.H, a.W))
             << i;
      masks[9 * rg + cg] = m;
    } else if (cg >= 16) {
      rows[16 * rg + cg - 16] = min(p0 + rg + 8 * (cg - 16), P - 1) /
                                (a.H * a.W);
    }
    __syncwarp();
    int tap = k0 / per_tap, kin = k0 - tap * per_tap;
    uint32_t in = masks[9 * rg + tap];
    for (int k = k0; k < k1; ++k) {
      const uint32_t qq = q + (k - k0);
      const int s = qq % NS;
      const uint32_t sa = sbase + s * Tl::kStage + rg * 128;
      const uint32_t sb = sbase + s * Tl::kStage + F_A_BYTES + cg * 128;
      sp::mbar_wait(&landed[s], (qq / NS) & 1);
      if (in != 0xffff) {
        // the warp's rows whose tap leaves the image read zeros: lane l
        // zeroes 16-byte chunk l % 8 of rows l / 8 + 4 m (only this warp
        // reads them)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = (cg >> 3) + 4 * m;
          if (!((in >> i) & 1))
            asm volatile("st.shared.v4.b32 [%0], {%1, %1, %1, %1};\n" ::"r"(
                             sa + i * 1024 + (cg & 7) * 16),
                         "r"(0)
                         : "memory");
        }
        __syncwarp();
      }
#pragma unroll 1
      for (int v = 0; v < F_BK / 4; ++v) {
        // row rg + 8 i of A at av0 + 1024 i, row g CH + 32 j + cg of B at
        // bq + 128 (g CH + 32 j): immediates on two registers
        const uint32_t av0 = opaque(sa + v * 16);
        const uint32_t bq = opaque(sb + ((v ^ xr) << 4));
        float4 b[4][NJ];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            b[g][j] = lds128(bq + (g * CH + 32 * j) * 128);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float4 av = lds128(av0 + i * 1024);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              float x = fmaf(av.x, b[g][j].x, acc[i][g][j]);
              x = fmaf(av.y, b[g][j].y, x);
              x = fmaf(av.z, b[g][j].z, x);
              acc[i][g][j] = fmaf(av.w, b[g][j].w, x);
            }
        }
      }
      // the zeros come before the stage's next TMA
      if (in != 0xffff)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (cg == 0) sp::mbar_arrive(&empty[s]);
      if (tid == 0 && k + F_AHEAD < k1) issue(qq + F_AHEAD, k + F_AHEAD, p0, c0);
      if (++kin == per_tap && k + 1 < k1) {
        kin = 0;
        in = masks[9 * rg + ++tap];
      }
    }
    q += k1 - k0;

    float* f = &acc[0][0][0];
    if (k0 > 0) {
      // a later piece of a cut tile: to this block's slot, then the flag
      float4* slot = reinterpret_cast<float4*>(ws) +
                     static_cast<size_t>(blockIdx.x) * (Tl::kAcc / 4) * 256 +
                     tid;
#pragma unroll
      for (int v = 0; v < Tl::kAcc / 4; ++v)
        __stcg(slot + 256 * v,
               make_float4(f[4 * v], f[4 * v + 1], f[4 * v + 2], f[4 * v + 3]));
      __threadfence();
      __syncthreads();
      if (tid == 0)
        asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(
                         flags + blockIdx.x),
                     "r"(1)
                     : "memory");
      have = next();
      continue;
    }
    // every warp is done with the ring: stage the tile's xg and c in it
    __syncthreads();
    if (tid == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      sp::mbar_arrive_expect_tx(epi_full, Tl::kEpiBytes);
#pragma unroll
      for (int h = 0; h < NJ; ++h) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
          sp::tma_load_2d(smem + (g * NJ + h) * F_BOX * 4, &xmap, epi_full,
                          g * C + c0 + F_BK * h, p0);
        sp::tma_load_2d(smem + (Tl::kCBox + h) * F_BOX * 4, &cmap, epi_full,
                        c0 + F_BK * h, p0);
      }
    }
    // the signal-map taps of the tile's rows, zero outside the image, and
    // the signal weights of its first two images, into shared memory
    float* taps = reinterpret_cast<float*>(smem + Tl::kTaps);
    float* kps = reinterpret_cast<float*>(smem + Tl::kKp);
    const int hw = a.H * a.W, n0 = p0 / hw;
    for (int x = tid; x < a.S * 9 * sp::BM; x += F_THREADS) {
      const int r = x % sp::BM, st = x / sp::BM, tp = st % 9, str = st / 9;
      const int p = p0 + r;
      int dy, dx;
      sp::tap_shift<9>(tp, 1, dy, dx);
      float v = 0.f;
      if (p < P) {
        const int yx = sp::pixel_yx(geo, p);
        if (sp::tap_inside(yx, dy, dx, a.H, a.W))
          v = a.smap[(size_t)(p + dy * a.W + dx) * a.S + str];
      }
      taps[x] = v;
    }
    for (int x = tid; x < 2 * a.S * 27 * (CH / 4); x += F_THREADS) {
      const int col = x % (CH / 4), row = x / (CH / 4);  // row: [2][S][9][3]
      const int n = n0 + row / (27 * a.S), rest = row % (27 * a.S);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < a.N)
        v = *reinterpret_cast<const float4*>(
            a.kp + ((size_t)n * a.S * 27 + rest / 3 * 3) * C +
            (rest % 3) * C + c0 + 4 * col);
      reinterpret_cast<float4*>(kps)[x] = v;
    }
    // the owner of a cut tile adds its later pieces, in K order: range
    // rank + 1 onwards, while a range starts inside the tile
    const Sched sc(gridDim.x, PT * NSL, 9 * per_tap);
    const long long end = static_cast<long long>(t + 1) * sc.KC;
    const int rank = sc.G - 1 - static_cast<int>(blockIdx.x);
    for (int r = rank + 1; k1 < sc.KC && r < sc.G && sc.lo(r) < end; ++r) {
      const int blk = sc.G - 1 - r;
      if (tid == 0) {
        int done = 0;
        for (uint32_t spins = 0;; ++spins) {
          asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                       : "=r"(done)
                       : "l"(flags + blk)
                       : "memory");
          if (done) break;
          if (spins == (1u << 26)) __trap();
          __nanosleep(64);
        }
        flags[blk] = 0;  // ready for the next launch
      }
      __syncthreads();
      const float4* slot = reinterpret_cast<const float4*>(ws) +
                           static_cast<size_t>(blk) * (Tl::kAcc / 4) * 256 +
                           tid;
#pragma unroll
      for (int v = 0; v < Tl::kAcc / 4; ++v) {
        const float4 pv = __ldcg(slot + 256 * v);
        f[4 * v] += pv.x;
        f[4 * v + 1] += pv.y;
        f[4 * v + 2] += pv.z;
        f[4 * v + 3] += pv.w;
        if (v % 8 == 7) load_fence();
      }
    }

    // the epilogue: the signal taps into the i, f, o sums (as cell_bf16
    // does), each row's in order over streams and taps; then xg and the
    // state update.  A warp's rows, and so their images, are the same
    // for all its lanes.
    __syncthreads();
    for (int st = 0; st < a.S; ++st) {
#pragma unroll
      for (int tp = 0; tp < 9; ++tp) {
        int nk = -1;
        float kv[3][NJ];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (p0 + rg + 8 * i >= P) break;
          const int n = rows[16 * rg + i];
          if (n != nk) {
            nk = n;
            // staged for the tile's first two images, else from kp
            const float* kq =
                n - n0 < 2
                    ? kps + (((n - n0) * a.S + st) * 9 + tp) * 3 * CH + cg
                    : a.kp + ((size_t)(n * a.S + st) * 9 + tp) * 3 * C + c0 +
                          cg;
            const int ks = n - n0 < 2 ? CH : C;
#pragma unroll
            for (int g = 0; g < 3; ++g)
#pragma unroll
              for (int j = 0; j < NJ; ++j) kv[g][j] = kq[g * ks + 32 * j];
          }
          const float sv = taps[(st * 9 + tp) * sp::BM + rg + 8 * i];
#pragma unroll
          for (int g = 0; g < 3; ++g)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              acc[i][g][j] = fmaf(sv, kv[g][j], acc[i][g][j]);
        }
        load_fence();
      }
    }
    sp::mbar_wait(epi_full, e & 1);
    ++e;
    // xg into the sums, and the state update into c and h'
    const float* xs = reinterpret_cast<const float*>(smem);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = rg + 8 * i, p = p0 + r;
      if (p >= P) break;
      const int off = r * F_BK + ((((cg >> 2) ^ (r & 7)) << 2) | (cg & 3));
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float pre[4][1], cn[1] = {xs[(Tl::kCBox + j) * F_BOX + off]}, hn[1];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          pre[g][0] = acc[i][g][j] + xs[(g * NJ + j) * F_BOX + off];
        lstm_update<1>(pre, cn, hn);
        const size_t qo = (size_t)p * C + c0 + cg + 32 * j;
        a.c[qo] = cn[0];
        a.h_out[qo] = hn[0];
      }
      load_fence();
    }
    // the staged operands are read: the ring goes to the next item, after
    // this thread's writes to it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    have = next();
  }
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

template <int CH>
int launch_f32(const CellArgs<float>& a, const float* h, const float* kt,
               float* ws, int* flags, int ctas, cudaStream_t stream) {
  using Tl = F32Tile<CH>;
  const int C = a.C, P = a.N * a.H * a.W;
  CUtensorMap hmap, wmap, xmap, cmap;
  int err = sp::matrix_map(&hmap, h, C, P, F_BK, sp::BM, true, true);
  if (!err) err = sp::weight_map(&wmap, kt, C, 9, 4 * C, CH, true);
  if (!err) err = sp::matrix_map(&xmap, a.xg, 4 * C, P, F_BK, sp::BM, true, true);
  if (!err) err = sp::matrix_map(&cmap, a.c, C, P, F_BK, sp::BM, true, true);
  if (!err) err = sp::allow_smem<cell_f32<CH>>(Tl::kSmem);
  if (err) return err;
  cell_f32<CH><<<ctas, F_THREADS, Tl::kSmem, stream>>>(hmap, wmap, xmap, cmap,
                                                      a, ws, flags);
  return static_cast<int>(cudaGetLastError());
}

// out = {CTAs, tiles, tiles cut along K, the largest CTA's (tile, chunk)
// units, all units, CTAs an SM, SMs} of the float32 launch at this shape
template <int CH>
int f32_schedule(int N, int H, int W, int C, int* out) {
  using Tl = F32Tile<CH>;
  int per_sm = 0, dev = 0, sms = 0;
  int err = sp::allow_smem<cell_f32<CH>>(Tl::kSmem);
  if (!err)
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cell_f32<CH>, F_THREADS, Tl::kSmem));
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (!err)
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (N * H * W + sp::BM - 1) / sp::BM * (C / CH);
  const int kc = 9 * C / F_BK;
  const long long units = static_cast<long long>(tiles) * kc;
  const Sched s(static_cast<int>(std::min(
                    static_cast<long long>(sms) * per_sm, units)),
                tiles, kc);
  int cut = 0, last = -1;
  long long most = 0;
  for (int r = 0; r < s.G; ++r) {
    const long long b = s.lo(r);
    if (r > 0 && b % kc != 0 && b / kc != last) {
      last = static_cast<int>(b / kc);
      ++cut;
    }
    most = std::max(most, s.lo(r + 1) - b);
  }
  const int v[7] = {s.G, tiles, cut,
                    static_cast<int>(static_cast<long long>(s.R) * kc + most),
                    static_cast<int>(units), per_sm, sms};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

// kt: the packed gate kernel [4C, 9C] (row g*C + c holds kh[:, :, :, g*C + c]
// tap-major).  dtype: 0 = float32, 1 = bfloat16.  float32 only: ctas, the
// persistent launch's CTAs (ops/cell.py::cell_schedule), and, when its
// schedule cuts tiles along K, ws (ctas x 256 x 2 CH floats) and flags
// (ctas ints, zero, and zero again after every launch).  Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int sp_cell_step(const void* h, void* c, const void* xg,
                            const void* smap, const void* kp, const void* kt,
                            void* h_out, void* ws, void* flags, int N, int H,
                            int W, int C, int S, int dtype, int ctas,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto l = plan<float>(h, c, xg, smap, kp, kt, h_out, N, H, W, C, S,
                               32);
    auto* w = static_cast<float*>(ws);
    auto* f = static_cast<int*>(flags);
    const auto* hf = static_cast<const float*>(h);
    const auto* kf = static_cast<const float*>(kt);
    if (C % 64 == 0) return launch_f32<64>(l.cell, hf, kf, w, f, ctas, st);
    return launch_f32<32>(l.cell, hf, kf, w, f, ctas, st);
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

// float32: out = {CTAs, tiles, tiles cut along K, the largest CTA's (tile,
// chunk) units, all units, CTAs an SM, SMs} (f32_schedule); bfloat16:
// out[0..2] = {grid x, grid y, blocks per SM} of sp_cell_step at this shape
extern "C" int sp_cell_grid(int* out, int N, int H, int W, int C, int dtype) {
  const int P = N * H * W, tiles = (P + sp::BM - 1) / sp::BM;
  if (dtype == 0)
    return C % 64 == 0 ? f32_schedule<64>(N, H, W, C, out)
                       : f32_schedule<32>(N, H, W, C, out);
  if (C % 64 == 0)
    return sp::grid_report<cell_bf16<256>>(dim3(tiles, C / 64), sp::WG_THREADS,
                                           sp::wg_smem_bytes<256>(), out);
  return sp::grid_report<cell_bf16<128>>(dim3(tiles, C / 32), sp::WG_THREADS,
                                         sp::wg_smem_bytes<128>(), out);
}

extern "C" const char* sp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
