// flash_attention_bwd: dQ, dK and dV of K4's function (csrc/
// flash_attention.cu), for LM training.
//
// Has no Pallas counterpart: `repro` trains by differentiating its plain
// attention (repro/models/lm.py::attn_apply calls attention_ref), so this
// is the gradient of the forward's function, whose plain version is
// `torch.autograd.grad` of repro_torch.kernels.ref.flash_attention_ref
// (ref.flash_attention_bwd_ref). fp32 only, IEEE FMAs (no tensor cores,
// no TF32). Every mask the forward takes: causal or not, a window,
// ragged Sq and Sk (aligned positions: row i sees key j iff j < Sk,
// j <= i when causal, j > i - window). A masked score is -1e30, so its
// probability is 0, and tiles that no row sees are skipped. Each sum
// runs in a fixed order without atomics, so a repeat gives the same
// bits.
//
// The math (FlashAttention-2): with S = scale Q K^T (masked), the
// forward's row log-sum-exp L and out O, and dO the gradient of O:
//   D  = rowsum(dO o O)                       (a) one warp a row
//   P  = exp(S - L),  dP = dO V^T,  dS = P o (dP - D)
//   dV = P^T dO,  dK = scale dS^T Q           (b) a block per key tile
//   dQ = scale dS K                           (c) a block per query tile
// P is recomputed from the saved L: the (Sq, Sk) matrices never leave
// the SM.
//
// What bounds it: operations. The least work is five products over the
// visible pairs, 10 hd flops a pair and head: at qwen3-0.6b's training
// shape (B 8, S 512, Hq 16, Hkv 8, hd 128, causal) 10 B Hq hd S(S+1)/2 =
// 21.5 GFLOP, 0.32 ms at the fp32 rate of 67 TFLOP/s, against 101 MB of
// q, k, v, out, dO and the three gradients (0.03 ms at 3.35 TB/s). This
// design recomputes S and dP in both (b) and (c): seven products, 1.4x
// the least work, for no atomics and no (B, Hq, Sq, hd) fp32 scratch of
// partial dQ.
//
// The design follows the forward's fp32 path: 128 threads, products
// register-tiled over float4 rows of shared memory padded by 4 floats
// (conflict-free), cp.async copies (rows past S zero-filled), the tiles
// of one side staged once and the other side's streamed through a ring
// of two stages where shared memory holds two (one stage from hd 176 in
// (b), from hd 224 in (c)).
//   (b) One block per (b, KV head, 32 keys): K and V stay in shared
//   memory; the block walks, for each of the Hq/Hkv query heads of its
//   group, the 64-row query tiles inside the causal and window band, so
//   GQA's sum over heads happens in registers and dK and dV are written
//   once. Per tile each thread computes S and dP for 4 queries x 4 keys
//   (keys k, k + 8, k + 16, k + 24: eight distinct K rows a quarter-warp),
//   P and dS go to shared memory as [query][key], and each thread then
//   owns 8 keys x 4 columns (a chunk of 128 columns per 32 lanes) of dV
//   and dK: per query two broadcast float4 loads of P and of dS and one
//   float4 of dO and of Q per chunk for 64 FMAs per chunk.
//   (c) One block per (b, query head, 64 query rows), longest rows first
//   when causal, as the forward: Q and dO stay, K and V tiles of 32 keys
//   stream; dS^T goes to shared memory as the forward's P^T does, and
//   dQ += dS K runs as the forward's P V (8 rows x 4 columns per chunk of
//   64 columns a thread).
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

constexpr int kBKB = 32;  // keys per (b) block
constexpr int kBKC = 32;  // keys per (c) tile

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

// S (unscaled) and dP of 4 rows x 4 keys: the rows at `i * pitch` past
// a and g (in the Q and dO tiles) against the rows at `8 j * pitch` past
// kk and vv (in the K and V tiles)
template <int HD>
__device__ __forceinline__ void scores(const float* a, const float* g,
                                       const float* kk, const float* vv,
                                       int pitch, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  // the hd loop unrolled whole at hd 16, 32 and 64, else by 4
  constexpr int kDUnroll = HD <= 64 && (HD & (HD - 1)) == 0 ? HD / 4 : 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll kDUnroll
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + i * pitch + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(kk + 8 * j * pitch + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dot4(x[i], y[j], s[i][j]);
  }
#pragma unroll kDUnroll
  for (int d = 0; d < HD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(g + i * pitch + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(vv + 8 * j * pitch + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = dot4(x[i], y[j], dp[i][j]);
  }
}

// ---- (b) dK and dV

template <int HD>
struct KVTiles {
  static constexpr int kPitch = HD + 4;          // K, V, Q, dO rows
  static constexpr int kPK = kBKB + 4;           // P and dS rows, [q][key]
  static constexpr int kNch = (HD + 127) / 128;  // 128-column chunks
  static constexpr int kFixed = 2 * kBKB * kPitch + 2 * kBQ * kPK;
  static constexpr int kStage = 2 * kBQ * kPitch;  // Q and dO
  static constexpr int kStages =
      (kFixed + 2 * kStage) * 4 <= kMaxSmem ? 2 : 1;
  static constexpr int kBytes = (kFixed + kStages * kStage) * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v, Grad gr,
                                float* __restrict__ dk,
                                float* __restrict__ dv, Problem p) {
  using T = KVTiles<HD>;
  constexpr int PITCH = T::kPitch;
  constexpr int PK = T::kPK;
  constexpr int NCH = T::kNch;
  constexpr int ST = T::kStages;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kBKB][PITCH]
  float* v_s = k_s + kBKB * PITCH;               // [kBKB][PITCH]
  float* p_s = v_s + kBKB * PITCH;               // [kBQ][PK], P
  float* d_s = p_s + kBQ * PK;                   // [kBQ][PK], dS
  float* q_s = d_s + kBQ * PK;                   // [ST][kBQ][PITCH]
  float* g_s = q_s + ST * kBQ * PITCH;           // [ST][kBQ][PITCH], dO

  const int k0 = blockIdx.x * kBKB;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  // S, dP: queries srg*4 + i, keys skg + 8 j; dK, dV: keys okg*8 + i,
  // columns 4 (ocg + 32 c) + e
  const int srg = tid / 8, skg = tid % 8;
  const int okg = tid / 32, ocg = tid % 32;

  // the query tiles whose rows see a key of this block, for each head
  const int k_end = min(k0 + kBKB, p.Sk);
  const int q_lo = p.causal ? k0 : 0;
  const int q_hi = p.window > 0 ? min(p.Sq, k_end - 1 + p.window) : p.Sq;
  const int q_first = (q_lo / kBQ) * kBQ;
  const int n_q = q_hi > q_first ? (q_hi - q_first + kBQ - 1) / kBQ : 0;
  const int n_it = p.rep * n_q;

  const int64_t g_row = static_cast<int64_t>(p.Hq) * HD;  // dO's s stride
  auto load_q = [&](int it, int st) {
    const int h = hk * p.rep + it / n_q;
    const int q0 = q_first + (it % n_q) * kBQ;
    load_tile<float, HD, kBQ>(q_s + st * kBQ * PITCH, PITCH,
                              q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.Sq);
    load_tile<float, HD, kBQ>(
        g_s + st * kBQ * PITCH, PITCH,
        gr.dout + (static_cast<int64_t>(b) * p.Sq * p.Hq + h) * HD, g_row,
        q0, p.Sq);
  };

  load_tile<float, HD, kBKB>(k_s, PITCH, k + b * p.ks.b + hk * p.ks.h,
                             p.ks.s, k0, p.Sk);
  load_tile<float, HD, kBKB>(v_s, PITCH, v + b * p.vs.b + hk * p.vs.h,
                             p.vs.s, k0, p.Sk);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  float dk_acc[8][NCH * 4], dv_acc[8][NCH * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NCH * 4; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int h = hk * p.rep + it / n_q;
    const int q0 = q_first + (it % n_q) * kBQ;
    const int st = ST == 2 ? (it & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; everyone is done with tile it - 1
    if (ST == 2 && it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      cp_async_commit();
    }
    const float* qt = q_s + st * kBQ * PITCH;
    const float* gt = g_s + st * kBQ * PITCH;

    float s[4][4], dp[4][4];
    scores<HD>(qt + srg * 4 * PITCH, gt + srg * 4 * PITCH,
               k_s + skg * PITCH, v_s + skg * PITCH, PITCH, s, dp);

    // P = exp(S - L) and dS = P (dP - D), to shared memory as [q][key]
    const bool masked = q0 + kBQ > p.Sq || k0 + kBKB > p.Sk ||
                        (p.causal && k0 + kBKB - 1 > q0) ||
                        (p.window > 0 && k0 <= q0 + kBQ - 1 - p.window);
    const int64_t row_base = (static_cast<int64_t>(b) * p.Hq + h) * p.Sq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + srg * 4 + i;
      const bool q_in = qp < p.Sq;
      const float L = q_in ? gr.lse[row_base + qp] : 0.0f;
      const float D = q_in ? gr.delta[row_base + qp] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + skg + 8 * j;
        const float pr = (!masked || (q_in && visible(qp, kp, p)))
                             ? expf(s[i][j] * p.scale - L)
                             : 0.0f;
        p_s[(srg * 4 + i) * PK + skg + 8 * j] = pr;
        d_s[(srg * 4 + i) * PK + skg + 8 * j] = pr * (dp[i][j] - D);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll 2
    for (int r = 0; r < kBQ; ++r) {
      const float4 p0 = *reinterpret_cast<const float4*>(p_s + r * PK +
                                                         okg * 8);
      const float4 p1 = *reinterpret_cast<const float4*>(p_s + r * PK +
                                                         okg * 8 + 4);
      const float4 d0 = *reinterpret_cast<const float4*>(d_s + r * PK +
                                                         okg * 8);
      const float4 d1 = *reinterpret_cast<const float4*>(d_s + r * PK +
                                                         okg * 8 + 4);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float dr[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = 4 * (ocg + 32 * c);
        if (HD % 128 == 0 || col < HD) {
          const float4 gv = *reinterpret_cast<const float4*>(gt + r * PITCH +
                                                             col);
          const float4 qv = *reinterpret_cast<const float4*>(qt + r * PITCH +
                                                             col);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            dv_acc[i][4 * c + 0] = fmaf(pr[i], gv.x, dv_acc[i][4 * c + 0]);
            dv_acc[i][4 * c + 1] = fmaf(pr[i], gv.y, dv_acc[i][4 * c + 1]);
            dv_acc[i][4 * c + 2] = fmaf(pr[i], gv.z, dv_acc[i][4 * c + 2]);
            dv_acc[i][4 * c + 3] = fmaf(pr[i], gv.w, dv_acc[i][4 * c + 3]);
            dk_acc[i][4 * c + 0] = fmaf(dr[i], qv.x, dk_acc[i][4 * c + 0]);
            dk_acc[i][4 * c + 1] = fmaf(dr[i], qv.y, dk_acc[i][4 * c + 1]);
            dk_acc[i][4 * c + 2] = fmaf(dr[i], qv.z, dk_acc[i][4 * c + 2]);
            dk_acc[i][4 * c + 3] = fmaf(dr[i], qv.w, dk_acc[i][4 * c + 3]);
          }
        }
      }
    }
    if (ST == 1 && it + 1 < n_it) {
      __syncthreads();  // everyone is done with the only stage
      load_q(it + 1, 0);
      cp_async_commit();
    }
  }

  // dK = scale dS^T Q and dV, contiguous (B, Sk, Hkv, hd); a key that no
  // query sees gets zeros
  const int Hkv = p.Hq / p.rep;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + okg * 8 + i;
    if (key >= p.Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * p.Sk + key) * Hkv + hk) *
                        HD;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = 4 * (ocg + 32 * c);
      if (HD % 128 == 0 || col < HD) {
        *reinterpret_cast<float4*>(dk + off + col) = make_float4(
            dk_acc[i][4 * c] * p.scale, dk_acc[i][4 * c + 1] * p.scale,
            dk_acc[i][4 * c + 2] * p.scale, dk_acc[i][4 * c + 3] * p.scale);
        *reinterpret_cast<float4*>(dv + off + col) =
            make_float4(dv_acc[i][4 * c], dv_acc[i][4 * c + 1],
                        dv_acc[i][4 * c + 2], dv_acc[i][4 * c + 3]);
      }
    }
  }
}

// ---- (c) dQ

template <int HD>
struct QTiles {
  static constexpr int kPitch = HD + 4;        // Q, dO, K, V rows
  static constexpr int kNch = (HD + 63) / 64;  // 64-column chunks
  static constexpr int kPP = kBQ + 4;          // dS^T rows, [key][q]
  static constexpr int kFixed = 2 * kBQ * kPitch + kBKC * kPP;
  static constexpr int kStage = 2 * kBKC * kPitch;  // K and V
  static constexpr int kStages =
      (kFixed + 2 * kStage) * 4 <= kMaxSmem ? 2 : 1;
  static constexpr int kBytes = (kFixed + kStages * kStage) * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v, Grad gr,
                              float* __restrict__ dq, Problem p) {
  using T = QTiles<HD>;
  constexpr int PITCH = T::kPitch;
  constexpr int NCH = T::kNch;
  constexpr int PP = T::kPP;
  constexpr int ST = T::kStages;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][PITCH]
  float* g_s = q_s + kBQ * PITCH;                // [kBQ][PITCH], dO
  float* p_s = g_s + kBQ * PITCH;                // [kBKC][PP], dS^T
  float* k_s = p_s + kBKC * PP;                  // [ST][kBKC][PITCH]
  float* v_s = k_s + ST * kBKC * PITCH;          // [ST][kBKC][PITCH]

  const Span span = block_span<kBKC>(p);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.rep;
  const int tid = threadIdx.x;
  // S, dP: rows srg*4 + i, keys skg + 8 j; dQ: rows org*8 + i, columns
  // 4 (ocg + 16 c) + e
  const int srg = tid / 8, skg = tid % 8;
  const int org = tid / 16, ocg = tid % 16;

  const float* kb = k + b * p.ks.b + hk * p.ks.h;
  const float* vb = v + b * p.vs.b + hk * p.vs.h;
  auto load_kv = [&](int t, int st) {
    const int k0 = span.k_first + t * kBKC;
    load_tile<float, HD, kBKC>(k_s + st * kBKC * PITCH, PITCH, kb, p.ks.s,
                               k0, p.Sk);
    load_tile<float, HD, kBKC>(v_s + st * kBKC * PITCH, PITCH, vb, p.vs.s,
                               k0, p.Sk);
  };
  load_tile<float, HD, kBQ>(q_s, PITCH, q + b * p.qs.b + h * p.qs.h, p.qs.s,
                            span.q0, p.Sq);
  load_tile<float, HD, kBQ>(
      g_s, PITCH, gr.dout + (static_cast<int64_t>(b) * p.Sq * p.Hq + h) * HD,
      static_cast<int64_t>(p.Hq) * HD, span.q0, p.Sq);
  if (span.n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  const int64_t row_base = (static_cast<int64_t>(b) * p.Hq + h) * p.Sq;
  float L[4], D[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = span.q0 + srg * 4 + i;
    L[i] = row < p.Sq ? gr.lse[row_base + row] : 0.0f;
    D[i] = row < p.Sq ? gr.delta[row_base + row] : 0.0f;
  }
  float acc[8][NCH * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NCH * 4; ++c) acc[i][c] = 0.0f;

  for (int t = 0; t < span.n_tiles; ++t) {
    const int k0 = span.k_first + t * kBKC;
    const int st = ST == 2 ? (t & 1) : 0;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; everyone is done with tile t - 1
    if (ST == 2 && t + 1 < span.n_tiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_commit();
    }
    const float* kt = k_s + st * kBKC * PITCH;
    const float* vt = v_s + st * kBKC * PITCH;

    float s[4][4], dp[4][4];
    scores<HD>(q_s + srg * 4 * PITCH, g_s + srg * 4 * PITCH,
               kt + skg * PITCH, vt + skg * PITCH, PITCH, s, dp);

    // dS = P (dP - D), P = exp(S - L), to shared memory transposed
    const bool masked = tile_needs_mask(span.q0, k0, kBKC, p);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = span.q0 + srg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = (!masked || visible(qp, k0 + skg + 8 * j, p))
                             ? expf(s[i][j] * p.scale - L[i])
                             : 0.0f;
        ds[i][j] = pr * (dp[i][j] - D[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_s + (skg + 8 * j) * PP + srg * 4) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();

    // dQ += dS K over this tile's keys
#pragma unroll 2
    for (int key = 0; key < kBKC; ++key) {
      const float4 p0 =
          *reinterpret_cast<const float4*>(p_s + key * PP + org * 8);
      const float4 p1 =
          *reinterpret_cast<const float4*>(p_s + key * PP + org * 8 + 4);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = 4 * (ocg + 16 * c);
        if (HD % 64 == 0 || col < HD) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + key * PITCH +
                                                             col);
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
    if (ST == 1 && t + 1 < span.n_tiles) {
      __syncthreads();  // everyone is done with the only stage
      load_kv(t + 1, 0);
      cp_async_commit();
    }
  }

  // dQ = scale dS K, contiguous (B, Sq, Hq, hd)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = span.q0 + org * 8 + i;
    if (row >= p.Sq) continue;
    float* drow = dq + ((static_cast<int64_t>(b) * p.Sq + row) * p.Hq + h) *
                           HD;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = 4 * (ocg + 16 * c);
      if (HD % 64 == 0 || col < HD)
        *reinterpret_cast<float4*>(drow + col) = make_float4(
            acc[i][4 * c] * p.scale, acc[i][4 * c + 1] * p.scale,
            acc[i][4 * c + 2] * p.scale, acc[i][4 * c + 3] * p.scale);
    }
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

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v,
                      const Grad& gr, float* dq, float* dk, float* dv,
                      int B, const Problem& p, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_attention_bwd_dkdv_kernel<HD>,
                               KVTiles<HD>::kBytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_attention_bwd_dq_kernel<HD>, QTiles<HD>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv(static_cast<unsigned>((p.Sk + kBKB - 1) / kBKB),
                     static_cast<unsigned>(p.Hq / p.rep),
                     static_cast<unsigned>(B));
  flash_attention_bwd_dkdv_kernel<HD>
      <<<grid_kv, kThreads, KVTiles<HD>::kBytes, stream>>>(q, k, v, gr, dk,
                                                          dv, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ),
                    static_cast<unsigned>(p.Hq), static_cast<unsigned>(B));
  flash_attention_bwd_dq_kernel<HD>
      <<<grid_q, kThreads, QTiles<HD>::kBytes, stream>>>(q, k, v, gr, dq, p);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* q, const float* k, const float* v,
                     const float* out, const float* dout, const float* lse,
                     float* delta, float* dq, float* dk, float* dv, int B,
                     int Sq, int Sk, int Hq, int Hkv, int hd,
                     const long long* strides, int causal, int window,
                     float scale, int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hd % 16 || hd < 16 || hd > 256) return cudaErrorInvalidValue;
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
#define FA_CASE(N) \
  case N:          \
    return launch_hd<16 * N>(q, k, v, gr, dq, dk, dv, B, p, s);
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

// C entry point, bound with ctypes: the three kernels, in order, on
// `stream`. q, k and v as the forward took them (fp32 on `device`,
// `strides` their nine (b, s, h) strides in elements, 16-byte aligned);
// out and dout contiguous (B, Sq, Hq, hd) fp32, 16-byte aligned; lse
// the forward's (B, Hq, Sq); delta a (B, Hq, Sq) fp32 scratch; dq
// contiguous (B, Sq, Hq, hd), dk and dv contiguous (B, Sk, Hkv, hd).
// hd is a multiple of 16 up to 256, Hq a multiple of Hkv, every query row
// sees a key (the forward's wrapper refuses the rest); window <= 0 means
// none. Returns the first cudaGetLastError() that is not cudaSuccess.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int hd,
    const long long* strides, int causal, int window, float scale,
    int device, void* stream) {
  return static_cast<int>(dispatch(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(out),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), B, Sq, Sk, Hq, Hkv,
      hd, strides, causal, window, scale, device, stream));
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
