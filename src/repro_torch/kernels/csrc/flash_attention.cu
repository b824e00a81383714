// flash_attention: causal grouped-query attention with an optional sliding
// window, for the prefill of every attention layer of the LM substrate.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention. q is (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), read in
// place through their strides (the last axis contiguous; the wrapper
// checks that every address a 16-byte copy starts at is 16-byte aligned);
// out is (B, Sq, Hq, hd), contiguous, in q's dtype. Positions are
// aligned: query row i and key j sit at positions i and j, so row i sees
// the keys j with j <= i (causal) and j > i - window (window > 0). Both
// paths keep the Pallas kernel's online softmax in fp32: masked scores
// are -1e30, each tile rescales by exp(m_prev - m_new), and the output
// divides by max(l, 1e-30). Each sum runs in a fixed order without
// atomics, so a repeated call gives the same bits. Given an lse pointer
// (training), each row's natural log-sum-exp m + log(l) also goes to a
// (B, Hq, Sq) fp32 table, which the backward (flash_attention_bwd.cu)
// reads; given none (serving), nothing else changes. What both kernels
// share with the backward is in flash_attention.cuh.
//
// What bounds it: operations. At the serve shape of qwen3-0.6b (B 4,
// S 512, Hq 16, Hkv 8, hd 128, causal) the work is 4*B*Hq*hd*S(S+1)/2 =
// 4.30 GFLOP against 50.3 MB of q, k, v and out (25.2 MB in bf16): 85
// flops per byte in fp32, far above the H100's fp32 ridge (67 TFLOP/s
// over 3.35 TB/s, 20 flops per byte), so the least time is the flops at
// the fp32 rate outside the tensor cores, 64 us; in bf16 (989 TFLOP/s on
// the tensor cores) 4.3 us of flops sit under 7.5 us of bytes.
//
// What the design does about it. Common to both paths: the (Sq, Sk)
// score matrix never leaves the SM. One block of four warps takes 64
// query rows of one (b, head) and walks the key tiles from the window's
// start to the causal frontier, skipping the tiles that no row of the
// block can see, masking only the tiles that hold a masked pair (the
// ragged ends of Sq and Sk too). Q is staged in shared memory once; K and
// V tiles arrive by cp.async (16-byte copies, rows past Sk zero-filled)
// into a two-stage ring, so tile t+1 is in flight while tile t is
// computed, with one barrier per tile for the ring (and one more in fp32,
// where P passes through shared memory). Blocks start with the longest
// rows (the last query tiles), so the causal triangle's short tiles fill
// the tail of the grid. The head size is a template parameter (16, 32,
// ..., 256), so every loop over it unrolls into registers.
//
// bf16: the tensor cores, in the FlashAttention-2 shape. Each warp owns 16
// query rows; key tiles hold 64 keys. S = Q K^T runs through
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate: the products are exact in
// fp32), with Q and K fragments from ldmatrix; rows are padded by 16
// bytes so ldmatrix's eight rows hit distinct banks. The online softmax
// runs on the accumulator fragments in registers, in base 2 (scores
// pre-scaled by log2 e): a row lives in one quad of threads, so its max
// takes two shuffles, and its sum is kept per thread and reduced once at
// the end. P is rounded to bf16 in registers: the m16n8 accumulator
// layout is the A operand layout of the next m16n8k16, so P V runs on the
// tensor cores without passing through shared memory, V's fragments
// from ldmatrix.trans. Q is read from shared memory at every tile, so hd
// 256 keeps its 16 x 256 fp32 output (128 registers a thread) and the
// 16 x 64 scores and nothing more. Shared memory: Q, two K and two V
// tiles, 87 KB at hd 128 (two blocks an SM), 169 KB at hd 256.
//
// fp32: IEEE fp32 FMAs only (no tensor cores, no TF32), register-tiled.
// Key tiles hold 32 keys. For S each thread computes a 4-row x 4-key
// block (keys k, k + 8, k + 16, k + 24, so the eight threads of a row
// group read eight distinct K rows, conflict-free with rows padded by 4
// floats), reading Q and K as float4 along hd: 64 FMAs per 8 shared
// loads. A row's 32 keys lie in eight adjacent lanes, so its max and sum
// take three shuffles each. P (transposed) and each row's rescale factor
// go through shared memory; for P V each thread owns 8 rows x 4*NCH
// columns (chunks c + 16 j of four columns): per key 2 float4 loads of P
// and NCH of V for 32*NCH FMAs, 16 FMAs per load at hd 128 and 21 at
// hd 256 (the old design did 3.5 to 5). Shared memory: Q, two K and two
// V tiles and P, 110 KB at hd 128 (two blocks an SM), 208 KB at hd 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- bf16: mma.sync on the tensor cores

template <int HD>
struct Bf16Tiles {
  static constexpr int kBK = 64;
  static constexpr int kPitch = HD + 8;  // +16 bytes: ldmatrix conflict-free
  static constexpr int kBytes = (kBQ + 4 * kBK) * kPitch * 2;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, Problem p) {
  using Tiles = Bf16Tiles<HD>;
  constexpr int BK = Tiles::kBK;
  constexpr int PITCH = Tiles::kPitch;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* k_s = q_s + kBQ * PITCH;  // [2][BK][PITCH]
  __nv_bfloat16* v_s = k_s + 2 * BK * PITCH;

  const Span span = block_span<BK>(p);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.rep;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // the fragment row (and row + 8)
  const int tq = lane % 4;  // the fragment column pair
  const int row_a = span.q0 + warp * 16 + g;

  const __nv_bfloat16* qb = q + b * p.qs.b + h * p.qs.h;
  const __nv_bfloat16* kb = k + b * p.ks.b + hk * p.ks.h;
  const __nv_bfloat16* vb = v + b * p.vs.b + hk * p.vs.h;

  load_tile<__nv_bfloat16, HD, kBQ>(q_s, PITCH, qb, p.qs.s, span.q0, p.Sq);
  load_tile<__nv_bfloat16, HD, BK>(k_s, PITCH, kb, p.ks.s, span.k_first,
                                   p.Sk);
  load_tile<__nv_bfloat16, HD, BK>(v_s, PITCH, vb, p.vs.s, span.k_first,
                                   p.Sk);
  cp_async_commit();

  const float sl2 = p.scale * kLog2e;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};  // rows row_a, row_a + 8; base 2
  float l[2] = {0.0f, 0.0f};        // this thread's part of the row sums

  for (int t = 0; t < span.n_tiles; ++t) {
    const int k0 = span.k_first + t * BK;
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < span.n_tiles) {
      load_tile<__nv_bfloat16, HD, BK>(k_s + (st ^ 1) * BK * PITCH, PITCH,
                                       kb, p.ks.s, k0 + BK, p.Sk);
      load_tile<__nv_bfloat16, HD, BK>(v_s + (st ^ 1) * BK * PITCH, PITCH,
                                       vb, p.vs.s, k0 + BK, p.Sk);
      cp_async_commit();
    }
    const __nv_bfloat16* kt = k_s + st * BK * PITCH;
    const __nv_bfloat16* vt = v_s + st * BK * PITCH;

    // S = Q K^T: 16 rows x 64 keys per warp, eight n8 tiles
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (warp * 16 + lane % 16) * PITCH + kk * 16 +
                         (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4(bb, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * PITCH +
                            kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // scale to base 2, mask, and the online softmax step of both rows
    const bool masked = tile_needs_mask(span.q0, k0, BK, p);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (masked &&
            !visible(row_a + (e / 2) * 8, k0 + n * 8 + 2 * tq + (e % 2), p))
          x = kNegInf;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e / 2]);
        l[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P from the score fragments, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vt + (kk * 16 + lane % 8 +
                                    ((lane / 8) % 2) * 8) * PITCH +
                                  np * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * np], a, bb[0], bb[1]);
        mma_bf16(o[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  }

  // out[b, row, h, :] = O / max(l, 1e-30), contiguous (B, Sq, Hq, hd)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row_a + i * 8;
    if (row >= p.Sq) continue;
    if (lse != nullptr && tq == 0)  // m is in base 2
      lse[(static_cast<int64_t>(b) * p.Hq + h) * p.Sq + row] =
          m[i] * kLn2 + logf(l[i]);
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * p.Sq + row) * p.Hq + h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(o[n][2 * i] / denom, o[n][2 * i + 1] / denom);
    }
  }
}

// ---- fp32: register-tiled IEEE FMAs

template <int HD>
struct F32Tiles {
  static constexpr int kBK = 32;
  static constexpr int kPitch = HD + 4;           // Q and K rows, floats
  static constexpr int kNch = (HD + 63) / 64;     // float4 chunks a thread
  static constexpr int kVPitch = kNch * 64;       // V rows, zero past hd
  static constexpr int kPPitch = kBQ + 4;         // P^T rows
  static constexpr int kFloats = kBQ * kPitch + 2 * kBK * kPitch +
                                 2 * kBK * kVPitch + kBK * kPPitch + 2 * kBQ;
  static constexpr int kBytes = kFloats * 4;
};

// one block an SM is all the bound promises: with (kThreads) alone ptxas
// held hd 32 and 48 to 128 registers and spilled
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out,
                           float* __restrict__ lse, Problem p) {
  using Tiles = F32Tiles<HD>;
  constexpr int BK = Tiles::kBK;
  constexpr int PITCH = Tiles::kPitch;
  constexpr int NCH = Tiles::kNch;
  constexpr int VP = Tiles::kVPitch;
  constexpr int PP = Tiles::kPPitch;
  // the hd loop unrolled whole at hd 16, 32 and 64, else by 4
  constexpr int kDUnroll = HD <= 64 && (HD & (HD - 1)) == 0 ? HD / 4 : 4;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][PITCH]
  float* k_s = q_s + kBQ * PITCH;                // [2][BK][PITCH]
  float* v_s = k_s + 2 * BK * PITCH;             // [2][BK][VP]
  float* p_s = v_s + 2 * BK * VP;                // [BK][PP], P^T
  float* c_s = p_s + BK * PP;                    // [kBQ] rescale factors
  float* l_s = c_s + kBQ;                        // [kBQ] row sums

  const Span span = block_span<BK>(p);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.rep;
  const int tid = threadIdx.x;
  // S: rows srg*4 + i, keys skg + 8 j; P V: rows org*8 + i, columns
  // 4 (ocg + 16 j) + c
  const int srg = tid / 8, skg = tid % 8;
  const int org = tid / 16, ocg = tid % 16;

  const float* qb = q + b * p.qs.b + h * p.qs.h;
  const float* kb = k + b * p.ks.b + hk * p.ks.h;
  const float* vb = v + b * p.vs.b + hk * p.vs.h;

  if (VP > HD) {  // V's padding columns, never written by the loads
    for (int i = tid; i < 2 * BK * (VP - HD); i += kThreads) {
      const int r = i / (VP - HD);
      v_s[r * VP + HD + (i - r * (VP - HD))] = 0.0f;
    }
  }
  load_tile<float, HD, kBQ>(q_s, PITCH, qb, p.qs.s, span.q0, p.Sq);
  load_tile<float, HD, BK>(k_s, PITCH, kb, p.ks.s, span.k_first, p.Sk);
  load_tile<float, HD, BK>(v_s, VP, vb, p.vs.s, span.k_first, p.Sk);
  cp_async_commit();

  float m[4], l[4];  // of rows srg*4 + i, the same in the row's 8 lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  float acc[8][NCH * 4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NCH * 4; ++c) acc[i][c] = 0.0f;

  for (int t = 0; t < span.n_tiles; ++t) {
    const int k0 = span.k_first + t * BK;
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t landed; everyone is done with tile t - 1
    if (t + 1 < span.n_tiles) {
      load_tile<float, HD, BK>(k_s + (st ^ 1) * BK * PITCH, PITCH, kb,
                               p.ks.s, k0 + BK, p.Sk);
      load_tile<float, HD, BK>(v_s + (st ^ 1) * BK * VP, VP, vb, p.vs.s,
                               k0 + BK, p.Sk);
      cp_async_commit();
    }
    const float* kt = k_s + st * BK * PITCH;
    const float* vt = v_s + st * BK * VP;

    // scores of 4 rows x 4 keys
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll kDUnroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (srg * 4 + i) * PITCH +
                                                 d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kt + (skg + 8 * j) * PITCH +
                                                 d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
      }
    }

    // mask, the online softmax step, and P^T and the rescale factors to
    // shared memory
    const bool masked = tile_needs_mask(span.q0, k0, BK, p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = span.q0 + srg * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = (!masked || visible(qp, k0 + skg + 8 * j, p))
                      ? s[i][j] * p.scale
                      : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float corr = expf(m[i] - mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mx);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * corr + sum;
      m[i] = mx;
      if (skg == 0) c_s[srg * 4 + i] = corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(p_s + (skg + 8 * j) * PP + srg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc = acc * corr + P V over this tile's keys
    {
      const float4 c0 = *reinterpret_cast<const float4*>(c_s + org * 8);
      const float4 c1 = *reinterpret_cast<const float4*>(c_s + org * 8 + 4);
      const float cr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < NCH * 4; ++c) acc[i][c] *= cr[i];
    }
#pragma unroll 2
    for (int key = 0; key < BK; ++key) {
      const float4 p0 =
          *reinterpret_cast<const float4*>(p_s + key * PP + org * 8);
      const float4 p1 =
          *reinterpret_cast<const float4*>(p_s + key * PP + org * 8 + 4);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float4 vv[NCH];
#pragma unroll
      for (int j = 0; j < NCH; ++j)
        vv[j] = *reinterpret_cast<const float4*>(vt + key * VP +
                                                 4 * (ocg + 16 * j));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < NCH; ++j) {
          acc[i][4 * j + 0] = fmaf(pr[i], vv[j].x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(pr[i], vv[j].y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pr[i], vv[j].z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pr[i], vv[j].w, acc[i][4 * j + 3]);
        }
      }
    }
  }

  // out[b, row, h, :] = acc / max(l, 1e-30), contiguous (B, Sq, Hq, hd);
  // lse[b, h, row] = m + log(l) when asked for
  if (skg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      l_s[srg * 4 + i] = l[i];
      const int row = span.q0 + srg * 4 + i;
      if (lse != nullptr && row < p.Sq)
        lse[(static_cast<int64_t>(b) * p.Hq + h) * p.Sq + row] =
            m[i] + logf(l[i]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = span.q0 + org * 8 + i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l_s[org * 8 + i], 1e-30f);
    float* orow = out + ((static_cast<int64_t>(b) * p.Sq + row) * p.Hq + h) *
                            HD;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int col = 4 * (ocg + 16 * j);
      if (col < HD)
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            acc[i][4 * j] / denom, acc[i][4 * j + 1] / denom,
            acc[i][4 * j + 2] / denom, acc[i][4 * j + 3] / denom);
    }
  }
}

// ---- launch

template <int HD>
cudaError_t launch_hd(bool bf16, const void* q, const void* k, const void* v,
                      void* out, float* lse, int B, const Problem& p,
                      cudaStream_t stream) {
  if (bf16) {
    const int bytes = Bf16Tiles<HD>::kBytes;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_attention_bf16_kernel<HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid(static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ),
                    static_cast<unsigned>(p.Hq), static_cast<unsigned>(B));
    flash_attention_bf16_kernel<HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, p);
  } else {
    const int bytes = F32Tiles<HD>::kBytes;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          flash_attention_f32_kernel<HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
    const dim3 grid(static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ),
                    static_cast<unsigned>(p.Hq), static_cast<unsigned>(B));
    flash_attention_f32_kernel<HD><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, p);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(bool bf16, const void* q, const void* k, const void* v,
                     void* out, void* lse, int B, int Sq, int Sk, int Hq,
                     int Hkv, int hd, const long long* strides, int causal,
                     int window, float scale, int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
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
#define FA_CASE(N) \
  case N:          \
    return launch_hd<16 * N>(bf16, q, k, v, out, static_cast<float*>(lse), \
                             B, p, s);
  if (hd % 16) return cudaErrorInvalidValue;
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

// C entry points, bound with ctypes. q, k, v on `device` in the dtype of
// the name; `strides` holds the (b, s, h) strides of q, k and v in
// elements (nine values; the head axis has stride 1); every base address
// and every stride of a dimension longer than 1 is 16-byte aligned; out
// is contiguous (B, Sq, Hq, hd). lse is null, or a contiguous fp32
// (B, Hq, Sq) that gets each row's natural log-sum-exp of its scaled,
// masked scores (what the backward, flash_attention_bwd.cu, reads). hd
// is a multiple of 16 up to 256, Hq a multiple of Hkv; window <= 0 means
// none. The launch goes on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int hd, const long long* strides,
                                   int causal, int window, float scale,
                                   int device, void* stream) {
  return static_cast<int>(dispatch(false, q, k, v, out, lse, B, Sq, Sk, Hq,
                                   Hkv, hd, strides, causal, window,
                                   scale, device, stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int B, int Sq, int Sk, int Hq, int Hkv,
                                    int hd, const long long* strides,
                                    int causal, int window, float scale,
                                    int device, void* stream) {
  return static_cast<int>(dispatch(true, q, k, v, out, lse, B, Sq, Sk, Hq,
                                   Hkv, hd, strides, causal, window,
                                   scale, device, stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
