// flash_attention_bwd: dQ, dK and dV of K4's function (csrc/
// flash_attention.cu), for LM training.
//
// The gradient of the Pallas kernel's function (src/repro/kernels/
// flash_attention.py:96), which has no backward of its own: `repro`
// trains by differentiating its plain attention (repro/models/lm.py::
// attn_apply calls attention_ref). The plain version here is
// `torch.autograd.grad` of repro_torch.kernels.ref.flash_attention_ref
// (ref.flash_attention_bwd_ref). fp32 only, IEEE FMAs (no tensor cores,
// no TF32); the bf16 backward is its own source, flash_attention_bwd_bf16
// .cu (tensor cores, no scratch of dS). Every mask the forward takes:
// causal or not, a window, ragged Sq and Sk (aligned positions: row i
// sees key j iff j < Sk, j <= i when causal, j > i - window). A masked
// score is -1e30, so its probability is 0, and tiles that no row sees are
// skipped. Every sum runs in a fixed order without atomics, so a repeat
// gives the same bits.
//
// The math (FlashAttention-2): with S = scale Q K^T (masked), the
// forward's row log-sum-exp L and out O, and dO the gradient of O:
//   D  = rowsum(dO o O)                        (a) one warp a row
//   P  = exp(S - L),  dP = dO V^T,  dS = P o (dP - D)
//   dV = P^T dO,  dK = scale dS^T Q            (b) a block per key tile
//   dQ = (scale dS) K                          (c) a block per query tile
// P is recomputed from the saved L. (b) writes scale dS, transposed, to
// an fp32 scratch that (c) reads back: five products, none twice.
//
// What bounds it: operations. Five products over the visible pairs, 10
// hd flops a pair and head: at qwen3-0.6b's training shape (B 8, S 512,
// Hq 16, Hkv 8, hd 128, causal) 10 B Hq hd S(S+1)/2 = 21.5 GFLOP, 0.321146
// ms at the fp32 rate of 67 TFLOP/s, against 101 MB of q, k, v, out, dO
// and the three gradients (0.03 ms at 3.35 TB/s). The scratch adds the
// band's dS once each way: 75 MB (whole 64 x 64 tiles) written and read
// at that shape, 0.045 ms at 3.35 TB/s.
//
// The design, against what held the first one (PR 22) back:
//   1. Eight warps an SM, not four: (b) runs 256 threads a block (one
//   block an SM: 170 KB of shared memory at hd 128, 218 KB at hd 256),
//   (c) 128 threads and two blocks an SM, so each sub-partition has two
//   warps to hide shared-memory and exp latency.
//   2. More FMAs per shared load. An SM moves 128 bytes a clock from
//   shared memory to registers and does 128 FMAs: a thread must use each
//   loaded float in 4 FMAs to keep up. (b)'s halves split by product:
//   threads 0-127 compute S, P and dV += P^T dO, threads 128-255 dP, dS
//   and dK += dS^T Q, so that each holds one S (or dP) tile of 4 queries
//   x 8 keys (2.7 FMAs a float; 4 x 4 from hd 144) and one 8 keys x 8
//   columns of dV (or dK; 4 FMAs a float; 4 x 16 from hd 144). P stays in
//   S's registers and dS in dP's; the P half hands P over through shared
//   memory and a named barrier. (c) holds 8 rows x 8 columns of dQ.
//   3. Five products, not seven: (c) no longer recomputes S and dP; it
//   is the product of the scratch and K, in a fixed key order. The
//   scratch is (B, Hq, query tiles, slab keys, 64): every query tile of a
//   slab of keys. Where the whole key range would take more than the
//   wrapper's budget (256 MiB), (b) and (c) walk the keys in slabs, in
//   order: (c) writes dQ in the first slab a query tile sees and adds in
//   the later ones.
//   4. A full grid at one KV head: (b)'s grid is ((KV head, split),
//   batch, key tile). A split takes Hq / Hkv / splits query heads of its
//   group; with more than one split, each writes its dK and dV to a
//   partial and a last kernel sums the splits in order. The wrapper picks
//   the fewest splits that give two blocks an SM (one at qwen3's training
//   shape; 8 at recurrentgemma's, hd 256 with one KV head). The tile is
//   the slowest axis of (b)'s and (c)'s grids, so under a causal mask the
//   blocks with the most work start first and the short ones fill the
//   tail.
// Shared memory, head splits, slabs and the scratch are the wrapper's
// launch plan (flash_attention.backward_plan), and each slab's grids
// follow from it as the plan lists them; the kernels refuse a plan whose
// tiles or shared memory differ from theirs.
//   (b) One block per (KV head and split, b, 64 keys; 32 from hd 144): K
//   and V stay in shared memory; the block walks, for each query head of
//   its split, the 64-row query tiles inside the causal and window band.
//   Q and dO stream through two stages where shared memory holds them
//   with P and dS (up to hd 112, and at hd 144 and 160), else one.
//   (c) One block per (head, b, 64 rows): tiles of the scratch and of K
//   stream through two stages, and dQ += (scale dS) K runs as the
//   forward's P V.
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

constexpr int kBwdThreads = 256;  // (b) and the split sum: eight warps
constexpr int kPQ = kBQ + 4;      // (c)'s scratch rows in shared memory

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ---- (a) D = rowsum(dO o O): one warp per (b, s, h) row of the
// contiguous (B, Sq, Hq, hd) out and dout, into delta (B, Hq, Sq)

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta_kernel(const float* __restrict__ out,
                                 const float* __restrict__ dout,
                                 float* __restrict__ delta, int64_t rows,
                                 int Sq, int Hq, int hd) {
  const int lane = threadIdx.x % 32;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;  // the whole warp
  const float* o = out + r * hd;
  const float* g = dout + r * hd;
  float acc = 0.0f;
  for (int c = 4 * lane; c < hd; c += 128)
    acc = dot4(*reinterpret_cast<const float4*>(o + c),
               *reinterpret_cast<const float4*>(g + c), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(r % Hq);
    const int64_t bs = r / Hq;
    const int s = static_cast<int>(bs % Sq);
    delta[((bs / Sq) * Hq + h) * Sq + s] = acc;
  }
}

// ---- shared by (b) and (c)

struct Grad {
  const float* dout;   // contiguous (B, Sq, Hq, hd)
  const float* lse;    // (B, Hq, Sq)
  const float* delta;  // (B, Hq, Sq)
};

// one slab of keys: what (b) writes and (c) reads
struct Pass {
  float* ds;        // (B, Hq, n_qt, slab_keys, kBQ): scale dS^T by query tile
  float* dk;        // (B, Sk, Hkv, hd): dK, or split 0's partial
  float* dv;        // the same for dV
  int64_t part;     // elements from one split's partial to the next's
  int splits;       // query-head splits of a GQA group
  int slab_lo;      // the slab's first key
  int slab_keys;    // keys a slab (a multiple of the key tile)
  int n_qt;         // query tiles
};

// (b)'s tiles at head size HD. Each half of the block (128 threads)
// holds, a thread, 4 queries x NJ keys of S (or dP), then KEYS keys x 4
// NCH columns of dV (or dK)
template <int HD>
struct KVTiles {
  static constexpr int kBK = HD <= 128 ? 64 : 32;  // keys a block
  static constexpr int kPitch = HD + 4;            // K, V, Q, dO rows
  static constexpr int kPK = kBK + 4;              // P, dS rows, [q][key]
  static constexpr int kNJ = kBK / 8;              // S, dP keys a thread
  static constexpr int kKeys = kBK / 8;            // dV, dK keys a thread
  static constexpr int kNch = (HD + 63) / 64;      // 64-column chunks
  static constexpr int kFixed = 2 * kBK * kPitch + 2 * kBQ * kPK;
  static constexpr int kStage = 2 * kBQ * kPitch;  // Q and dO
  static constexpr int kStages =
      (kFixed + 2 * kStage) * 4 <= kMaxSmem ? 2 : 1;
  static constexpr int kBytes = (kFixed + kStages * kStage) * 4;
};

// (c)'s tiles: (b)'s key tiles of the scratch and of K, two stages; a
// thread holds 8 rows x 4 NCH columns of dQ
template <int HD>
struct QTiles {
  static constexpr int kBK = KVTiles<HD>::kBK;
  static constexpr int kPitch = HD + 4;        // K rows
  static constexpr int kNch = (HD + 63) / 64;  // 64-column chunks
  static constexpr int kStage = kBK * (kPQ + kPitch);
  static constexpr int kBytes = 2 * kStage * 4;
};

// named barriers of (b) (0 is __syncthreads): P is in shared memory (the
// S half arrives, the dP half waits), and each half's own
constexpr int kBarP = 1;
constexpr int kBarHalf = 2;  // + the half, 0 or 1

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// out[i][j] = sum over d of a[i pitch + d] b[8 j pitch + d], 4 rows x NJ
// keys: S (unscaled) from Q and K, or dP from dO and V
template <int HD, int NJ>
__device__ __forceinline__ void tile_product(const float* a, const float* b,
                                             float (&out)[4][NJ]) {
  constexpr int P = HD + 4;
  // the hd loop unrolled whole at hd 16, 32 and 64, else by 4
  constexpr int kDUnroll = HD <= 64 && (HD & (HD - 1)) == 0 ? HD / 4 : 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[i][j] = 0.0f;
#pragma unroll kDUnroll
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + i * P + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + 8 * j * P + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) out[i][j] = dot4(x[i], y[j], out[i][j]);
  }
}

// acc[i][4 c + e] += sum over the tile's rows r of w[r][key0 + i] x[r][4
// (cg + 16 c) + e]: dV += P^T dO, or dK += dS^T Q, for KEYS keys and 4
// NCH columns of one thread
template <int HD, int KEYS>
__device__ __forceinline__ void accumulate(
    const float* w, const float* x, int key0, int cg,
    float (&acc)[KEYS][KVTiles<HD>::kNch * 4]) {
  constexpr int PK = KVTiles<HD>::kPK;
  constexpr int PITCH = KVTiles<HD>::kPitch;
  constexpr int NCH = KVTiles<HD>::kNch;
#pragma unroll 2
  for (int r = 0; r < kBQ; ++r) {
    float wr[KEYS];
#pragma unroll
    for (int i = 0; i < KEYS; i += 4) {
      const float4 t =
          *reinterpret_cast<const float4*>(w + r * PK + key0 + i);
      wr[i] = t.x;
      wr[i + 1] = t.y;
      wr[i + 2] = t.z;
      wr[i + 3] = t.w;
    }
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = 4 * (cg + 16 * c);
      if (HD % 64 == 0 || col < HD) {
        const float4 xv =
            *reinterpret_cast<const float4*>(x + r * PITCH + col);
#pragma unroll
        for (int i = 0; i < KEYS; ++i) {
          acc[i][4 * c + 0] = fmaf(wr[i], xv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(wr[i], xv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(wr[i], xv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(wr[i], xv.w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

// ---- (b) dK and dV, and scale dS^T to the scratch. The block's two
// halves split the work by product: threads 0-127 compute S, P (to
// shared memory) and dV += P^T dO; threads 128-255 compute dP, read P,
// write dS (to shared memory and the scratch) and dK += dS^T Q.

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dkdv_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v, Grad gr,
                                Pass pass, Problem p) {
  using T = KVTiles<HD>;
  constexpr int BK = T::kBK;
  constexpr int PITCH = T::kPitch;
  constexpr int PK = T::kPK;
  constexpr int NJ = T::kNJ;
  constexpr int KEYS = T::kKeys;
  constexpr int NCH = T::kNch;
  constexpr int ST = T::kStages;
  constexpr int HALF = kBwdThreads / 2;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [BK][PITCH]
  float* v_s = k_s + BK * PITCH;                 // [BK][PITCH]
  float* p_s = v_s + BK * PITCH;                 // [kBQ][PK], P
  float* d_s = p_s + kBQ * PK;                   // [kBQ][PK], dS
  float* q_s = d_s + kBQ * PK;                   // [ST][kBQ][PITCH]
  float* g_s = q_s + ST * kBQ * PITCH;           // [ST][kBQ][PITCH], dO

  // the key tile is the grid's slowest axis: when causal the first keys,
  // which the most query tiles see, start first
  const int k0 = pass.slab_lo + blockIdx.z * BK;
  const int hk = blockIdx.x / pass.splits;
  const int split = blockIdx.x % pass.splits;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int half = tid / HALF;  // 0: S, P, dV; 1: dP, dS, dK
  const int t = tid % HALF;
  // S, dP: queries srg*4 + i, keys skg + 8 j; dV, dK: keys kg*KEYS + i,
  // columns 4 (cg + 16 c) + e
  const int srg = t / 8, skg = t % 8;
  const int kg = t / 16, cg = t % 16;

  // this split's query heads, and the query tiles whose rows see a key
  // of this block
  const int heads = p.rep / pass.splits;
  const int h_first = hk * p.rep + split * heads;
  const int k_end = min(k0 + BK, p.Sk);
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi =
      p.window > 0 ? min(p.Sq, k_end - 1 + min(p.window, p.Sq)) : p.Sq;
  const int q_first = (q_lo / kBQ) * kBQ;
  const int n_q = q_hi > q_first ? (q_hi - q_first + kBQ - 1) / kBQ : 0;
  const int n_it = heads * n_q;

  const int64_t g_row = static_cast<int64_t>(p.Hq) * HD;  // dO's s stride
  auto load_q = [&](int it, int st) {
    const int h = h_first + it / n_q;
    const int q0 = q_first + (it % n_q) * kBQ;
    load_tile<float, HD, kBQ, kBwdThreads>(q_s + st * kBQ * PITCH, PITCH,
                                           q + b * p.qs.b + h * p.qs.h,
                                           p.qs.s, q0, p.Sq);
    load_tile<float, HD, kBQ, kBwdThreads>(
        g_s + st * kBQ * PITCH, PITCH,
        gr.dout + (static_cast<int64_t>(b) * p.Sq * p.Hq + h) * HD, g_row,
        q0, p.Sq);
  };

  load_tile<float, HD, BK, kBwdThreads>(k_s, PITCH,
                                        k + b * p.ks.b + hk * p.ks.h,
                                        p.ks.s, k0, p.Sk);
  load_tile<float, HD, BK, kBwdThreads>(v_s, PITCH,
                                        v + b * p.vs.b + hk * p.vs.h,
                                        p.vs.s, k0, p.Sk);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  // dV in the first half, dK in the second
  float acc[KEYS][NCH * 4];
#pragma unroll
  for (int i = 0; i < KEYS; ++i)
#pragma unroll
    for (int c = 0; c < NCH * 4; ++c) acc[i][c] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int h = h_first + it / n_q;
    const int qt = q_first / kBQ + it % n_q;
    const int q0 = qt * kBQ;
    const int st = ST == 2 ? (it & 1) : 0;
    // this tile's L (first half) or D (second), read before the wait so
    // that it hides them
    const float* rows_in = (half ? gr.delta : gr.lse) +
                           (static_cast<int64_t>(b) * p.Hq + h) * p.Sq;
    float LD[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + srg * 4 + i;
      LD[i] = qp < p.Sq ? rows_in[qp] : 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();  // tile it landed; everyone is done with tile it - 1
    if (ST == 2 && it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      cp_async_commit();
    }
    const float* qt_s = q_s + st * kBQ * PITCH;
    const float* gt_s = g_s + st * kBQ * PITCH;

    float s[4][NJ];  // S, then P (first half); dP, then dS (second)
    if (half == 0) {
      tile_product<HD, NJ>(qt_s + srg * 4 * PITCH, k_s + skg * PITCH, s);
      const bool masked =
          q0 + kBQ > p.Sq || tile_needs_mask(q0, k0, BK, p);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + srg * 4 + i;
        const bool q_in = qp < p.Sq;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = (!masked || (q_in && visible(qp, k0 + skg + 8 * j, p)))
                        ? expf(s[i][j] * p.scale - LD[i])
                        : 0.0f;
          p_s[(srg * 4 + i) * PK + skg + 8 * j] = s[i][j];
        }
      }
      bar_arrive(kBarP, kBwdThreads);   // P is in for the second half
      bar_sync(kBarHalf, HALF);         // and all of it for this half
      accumulate<HD, KEYS>(p_s, gt_s, kg * KEYS, cg, acc);  // dV
    } else {
      tile_product<HD, NJ>(gt_s + srg * 4 * PITCH, v_s + skg * PITCH, s);
      bar_sync(kBarP, kBwdThreads);     // P is in
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] = p_s[(srg * 4 + i) * PK + skg + 8 * j] * (s[i][j] - LD[i]);
          d_s[(srg * 4 + i) * PK + skg + 8 * j] = s[i][j];
        }
      // scale dS^T to the scratch: rows of this tile's keys, 64 queries
      float* ds = pass.ds +
                  ((((static_cast<int64_t>(b) * p.Hq + h) * pass.n_qt + qt) *
                        pass.slab_keys +
                    (k0 - pass.slab_lo)) *
                   kBQ);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        *reinterpret_cast<float4*>(ds + (skg + 8 * j) * kBQ + srg * 4) =
            make_float4(s[0][j] * p.scale, s[1][j] * p.scale,
                        s[2][j] * p.scale, s[3][j] * p.scale);
      bar_sync(kBarHalf + 1, HALF);     // all of dS is in
      accumulate<HD, KEYS>(d_s, qt_s, kg * KEYS, cg, acc);  // dK
    }
    if (ST == 1 && it + 1 < n_it) {
      __syncthreads();  // everyone is done with the only stage
      load_q(it + 1, 0);
      cp_async_commit();
    }
  }

  // dV (first half) and dK = scale dS^T Q (second), contiguous (B, Sk,
  // Hkv, hd), or this split's partials of them; a key that no query sees
  // gets zeros
  const int Hkv = p.Hq / p.rep;
  float* out = (half ? pass.dk : pass.dv) + split * pass.part;
  const float sc = half ? p.scale : 1.0f;
#pragma unroll
  for (int i = 0; i < KEYS; ++i) {
    const int key = k0 + kg * KEYS + i;
    if (key >= p.Sk) continue;
    const int64_t off =
        ((static_cast<int64_t>(b) * p.Sk + key) * Hkv + hk) * HD;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = 4 * (cg + 16 * c);
      if (HD % 64 == 0 || col < HD)
        *reinterpret_cast<float4*>(out + off + col) = make_float4(
            acc[i][4 * c] * sc, acc[i][4 * c + 1] * sc,
            acc[i][4 * c + 2] * sc, acc[i][4 * c + 3] * sc);
    }
  }
}

// ---- (c) dQ = (scale dS) K over this slab's keys: 128 threads, two
// blocks an SM

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bwd_dq_kernel(const float* __restrict__ k, Pass pass,
                              float* __restrict__ dq, Problem p) {
  using T = QTiles<HD>;
  constexpr int BK = T::kBK;
  constexpr int PITCH = T::kPitch;
  constexpr int NCH = T::kNch;
  extern __shared__ float4 smem4[];
  float* d_s = reinterpret_cast<float*>(smem4);  // [2][BK][kPQ], scratch
  float* k_s = d_s + 2 * BK * kPQ;               // [2][BK][PITCH], K

  // the query tile is the grid's slowest axis (the longest rows first when
  // causal); the key tiles of its band that lie in this slab; an earlier
  // slab wrote dQ where the band starts before this one
  const Span span = block_span<BK>(p, static_cast<int>(blockIdx.z),
                                   static_cast<int>(gridDim.z));
  const int lo = max(span.k_first, pass.slab_lo);
  const int hi = min(span.k_first + span.n_tiles * BK,
                     pass.slab_lo + pass.slab_keys);
  if (lo >= hi) return;
  const int n_tiles = (hi - lo) / BK;
  const bool add = span.k_first < pass.slab_lo;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / p.rep;
  // rows rg*8 + i, columns 4 (cg + 16 c) + e
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;

  const float* ds =
      pass.ds + ((static_cast<int64_t>(b) * p.Hq + h) * pass.n_qt +
                 span.q0 / kBQ) *
                    pass.slab_keys * kBQ;
  const float* kb = k + b * p.ks.b + hk * p.ks.h;
  auto load = [&](int t, int st) {
    const int k0 = lo + t * BK;
    load_tile<float, kBQ, BK>(d_s + st * BK * kPQ, kPQ, ds, kBQ,
                              k0 - pass.slab_lo, pass.slab_keys);
    load_tile<float, HD, BK>(k_s + st * BK * PITCH, PITCH, kb, p.ks.s, k0,
                             p.Sk);
  };
  load(0, 0);
  cp_async_commit();

  float acc[8][NCH * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NCH * 4; ++c) acc[i][c] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; everyone is done with tile t - 1
    if (t + 1 < n_tiles) {
      load(t + 1, st ^ 1);
      cp_async_commit();
    }
    const float* dt = d_s + st * BK * kPQ;
    const float* kt = k_s + st * BK * PITCH;
#pragma unroll 2
    for (int key = 0; key < BK; ++key) {
      const float4 p0 =
          *reinterpret_cast<const float4*>(dt + key * kPQ + rg * 8);
      const float4 p1 =
          *reinterpret_cast<const float4*>(dt + key * kPQ + rg * 8 + 4);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = 4 * (cg + 16 * c);
        if (HD % 64 == 0 || col < HD) {
          const float4 kv =
              *reinterpret_cast<const float4*>(kt + key * PITCH + col);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][4 * c + 0] = fmaf(pr[i], kv.x, acc[i][4 * c + 0]);
            acc[i][4 * c + 1] = fmaf(pr[i], kv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(pr[i], kv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(pr[i], kv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
  }

  // dQ, contiguous (B, Sq, Hq, hd): written, or added to an earlier
  // slab's
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = span.q0 + rg * 8 + i;
    if (row >= p.Sq) continue;
    float* drow =
        dq + ((static_cast<int64_t>(b) * p.Sq + row) * p.Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = 4 * (cg + 16 * c);
      if (HD % 64 == 0 || col < HD) {
        float4 r = make_float4(acc[i][4 * c], acc[i][4 * c + 1],
                               acc[i][4 * c + 2], acc[i][4 * c + 3]);
        if (add) {
          const float4 o = *reinterpret_cast<const float4*>(drow + col);
          r = make_float4(o.x + r.x, o.y + r.y, o.z + r.z, o.w + r.w);
        }
        *reinterpret_cast<float4*>(drow + col) = r;
      }
    }
  }
}

// ---- the splits' partials of dK (blockIdx.y 0) and dV (1), summed in
// split order: part is (2, splits, n4) float4

__global__ void __launch_bounds__(kBwdThreads)
flash_attention_bwd_reduce_kernel(const float4* __restrict__ part,
                                  float4* __restrict__ dk,
                                  float4* __restrict__ dv, int64_t n4,
                                  int splits) {
  const float4* src = part + blockIdx.y * splits * n4;
  float4* dst = blockIdx.y ? dv : dk;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kBwdThreads +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * kBwdThreads) {
    float4 s = src[i];
    for (int g = 1; g < splits; ++g) {
      const float4 t = src[g * n4 + i];
      s = make_float4(s.x + t.x, s.y + t.y, s.z + t.z, s.w + t.w);
    }
    dst[i] = s;
  }
}

// ---- launch

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// the wrapper's launch plan (flash_attention.backward_plan's `launch`)
struct Plan {
  int block_keys, splits, slab_keys, n_slabs, dkdv_smem, dq_smem,
      reduce_blocks;
};

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v,
                      const Grad& gr, float* dq, float* dk, float* dv,
                      float* ds, float* part, int B, const Problem& p,
                      const Plan& plan, cudaStream_t stream) {
  using KV = KVTiles<HD>;
  using QT = QTiles<HD>;
  // a plan made for other tiles than these kernels' is refused
  if (plan.block_keys != KV::kBK || plan.dkdv_smem != KV::kBytes ||
      plan.dq_smem != QT::kBytes || plan.slab_keys % KV::kBK)
    return cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem(flash_attention_bwd_dkdv_kernel<HD>, plan.dkdv_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_attention_bwd_dq_kernel<HD>, plan.dq_smem);
  if (err != cudaSuccess) return err;
  const int Hkv = p.Hq / p.rep;
  const int64_t n = static_cast<int64_t>(B) * p.Sk * Hkv * HD;
  const bool split = plan.splits > 1;
  Pass pass{ds,
            split ? part : dk,
            split ? part + plan.splits * n : dv,
            split ? n : 0,
            plan.splits,
            0,
            plan.slab_keys,
            (p.Sq + kBQ - 1) / kBQ};
  for (int s = 0; s < plan.n_slabs; ++s) {
    pass.slab_lo = s * plan.slab_keys;
    const int keys = min(plan.slab_keys, p.Sk - pass.slab_lo);
    const dim3 grid_kv(static_cast<unsigned>(Hkv * plan.splits),
                       static_cast<unsigned>(B),
                       static_cast<unsigned>((keys + KV::kBK - 1) / KV::kBK));
    flash_attention_bwd_dkdv_kernel<HD>
        <<<grid_kv, kBwdThreads, plan.dkdv_smem, stream>>>(q, k, v, gr,
                                                           pass, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid_q(static_cast<unsigned>(p.Hq), static_cast<unsigned>(B),
                      static_cast<unsigned>(pass.n_qt));
    flash_attention_bwd_dq_kernel<HD>
        <<<grid_q, kThreads, plan.dq_smem, stream>>>(k, pass, dq, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!split) return cudaSuccess;
  flash_attention_bwd_reduce_kernel<<<
      dim3(static_cast<unsigned>(plan.reduce_blocks), 2), kBwdThreads, 0,
      stream>>>(reinterpret_cast<const float4*>(part),
                reinterpret_cast<float4*>(dk), reinterpret_cast<float4*>(dv),
                n / 4, plan.splits);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* q, const float* k, const float* v,
                     const float* out, const float* dout, const float* lse,
                     float* delta, float* dq, float* dk, float* dv,
                     float* ds, float* part, int B, int Sq, int Sk, int Hq,
                     int Hkv, int hd, const long long* strides, int causal,
                     int window, float scale, const int* plan_ints,
                     int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hd % 16 || hd < 16 || hd > 256) return cudaErrorInvalidValue;
  const Plan plan{plan_ints[0], plan_ints[1], plan_ints[2], plan_ints[3],
                  plan_ints[4], plan_ints[5], plan_ints[6]};
  if (plan.splits < 1 || (Hq / Hkv) % plan.splits || plan.slab_keys < 1 ||
      plan.n_slabs != (Sk + plan.slab_keys - 1) / plan.slab_keys ||
      plan.reduce_blocks < 1)
    return cudaErrorInvalidValue;
  const Problem p{Sq,
                  Sk,
                  Hq,
                  Hq / Hkv,
                  causal,
                  window,
                  scale,
                  {strides[0], strides[1], strides[2]},
                  {strides[3], strides[4], strides[5]},
                  {strides[6], strides[7], strides[8]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t rows = static_cast<int64_t>(B) * Sq * Hq;
  const int64_t warps = kThreads / 32;
  flash_attention_bwd_delta_kernel<<<
      static_cast<unsigned>((rows + warps - 1) / warps), kThreads, 0, s>>>(
      out, dout, delta, rows, Sq, Hq, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Grad gr{dout, lse, delta};
#define FA_CASE(N)                                                          \
  case N:                                                                   \
    return launch_hd<16 * N>(q, k, v, gr, dq, dk, dv, ds, part, B, p, plan, \
                             s);
  switch (hd / 16) {
    FA_CASE(1)
    FA_CASE(2)
    FA_CASE(3)
    FA_CASE(4)
    FA_CASE(5)
    FA_CASE(6)
    FA_CASE(7)
    FA_CASE(8)
    FA_CASE(9)
    FA_CASE(10)
    FA_CASE(11)
    FA_CASE(12)
    FA_CASE(13)
    FA_CASE(14)
    FA_CASE(15)
    FA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// C entry point, bound with ctypes: the kernels, in order, on `stream`:
// (a), then (b) and (c) for each slab of keys, then the split sum when
// there is more than one split. q, k and v as the forward took them (fp32
// on `device`, `strides` their nine (b, s, h) strides in elements,
// 16-byte aligned); out and dout contiguous (B, Sq, Hq, hd) fp32, 16-byte
// aligned; lse the forward's (B, Hq, Sq); delta a (B, Hq, Sq) fp32
// scratch; ds the (B, Hq, query tiles, slab keys, 64) fp32 scratch; part
// the (2, splits, B, Sk, Hkv, hd) fp32 scratch of the partials (unused
// with one split); dq contiguous (B, Sq, Hq, hd), dk and dv contiguous
// (B, Sk, Hkv, hd); `plan` the launch plan's 7 ints (block keys, splits,
// slab keys, slabs, (b)'s and (c)'s shared bytes, the split sum's
// blocks). hd is a multiple of 16 up to 256, Hq a multiple of Hkv, every
// query row sees a key (the forward's wrapper refuses the rest); window
// <= 0 means none. Returns the first cudaGetLastError() that is not
// cudaSuccess, or cudaErrorInvalidValue for a plan these kernels do not
// match.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* ds, void* part, int B, int Sq, int Sk, int Hq, int Hkv,
    int hd, const long long* strides, int causal, int window, float scale,
    const int* plan, int device, void* stream) {
  return static_cast<int>(dispatch(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<float*>(ds), static_cast<float*>(part), B, Sq, Sk, Hq,
      Hkv, hd, strides, causal, window, scale, plan, device, stream));
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
