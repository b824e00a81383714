// flash_attention_bwd_bf16: dQ, dK and dV of K4's function (csrc/
// flash_attention.cu) at bf16, for LM training at `repro`'s default dtype.
//
// The gradient of the Pallas kernel's function (src/repro/kernels/
// flash_attention.py:96), which has no backward of its own: `repro`
// trains by differentiating its plain attention (repro/models/common.py::
// attention_ref) at bf16. The plain version here is `torch.autograd.grad`
// of repro_torch.kernels.ref.flash_attention_ref on bf16 inputs
// (ref.flash_attention_bwd_ref). Q, K, V, O and dO are bf16, the
// forward's row log-sum-exp L fp32, dQ, dK and dV bf16. Every mask the
// forward takes (causal or not, a window, ragged Sq and Sk; a masked
// score is -1e30, so its probability is 0, and tiles that no row sees are
// skipped). Every sum runs in a fixed order without atomics, so a repeat
// gives the same bits.
//
// The math (FlashAttention-2) at `repro`'s cast points: with S = Q K^T
// (bf16 products summed in fp32), scale = hd^-1/2,
//   D  = rowsum(dO o O)                          (a) one warp a row
//   P  = exp(scale S - L)                        fp32
//   dV = bf16(P)^T dO                            P rounded as the forward
//                                                rounds it before P V
//   dP = bf16(dO V^T)                            the gradient of that
//                                                bf16 P
//   dS = scale P o (dP - D)                      fp32 (the softmax's)
//   dK = dS^T Q,  dQ = dS K                      fp32 dS times bf16 Q, K
// each gradient summed in fp32 and rounded to bf16 once. D reads the bf16
// O, where the plain autograd sums P dP (the difference is within the
// tolerance chip_smoke.py states). The tensor cores take bf16 operands,
// so dS runs as two of them: hi = bf16(dS) and lo = bf16(dS - hi), 16
// significant bits with a remainder of at most 2^-17 |dS|, and each dS
// product is two products, dK += hi^T Q + lo^T Q, dQ += hi K + lo K.
//
// What bounds it: bytes, at the function's five products. At qwen3-0.6b's
// training shape (B 8, S 512, Hq 16, Hkv 8, hd 128, causal) the products
// are 10 B Hq hd S(S+1)/2 = 21.5 GFLOP, 0.0217 ms at the card's dense
// bf16 989 TFLOP/s, under 100.9 MB of q, k, v, out, dout, the three
// gradients and L, 0.0301 ms at 3.35 TB/s. This design runs nine
// tensor-core products (two of them recomputed, two for the dS split),
// 38.7 GFLOP at that shape.
//
// The design, against the first bf16 design (the fp32 kernels of
// flash_attention_bwd.cu run on bf16 tiles converted as they loaded: IEEE
// FMAs, an fp32 scratch of scale dS between its passes, slabs of keys, an
// fp32 dQ scratch and a finish kernel):
//   1. Every product on the tensor cores: mma.sync.m16n8k16 with bf16
//   operands and fp32 sums (flash_attention.cuh's mma_bf16), fragments
//   by ldmatrix (at one address register an operand, the fragments'
//   offsets constants) from bf16 tiles staged by cp.async, rows padded by
//   16 bytes so that ldmatrix's eight rows hit distinct banks.
//   2. No scratch in device memory: (c) recomputes S and dP on the tensor
//   cores (4 hd flops a pair) where the first design wrote and read back
//   scale dS (8 bytes a pair): at the card's ridge of about 295 flops a
//   byte the bytes cost more, even at hd 256. No slabs, no fp32 dQ, no
//   finish kernel.
//   3. No atomics: (b) owns its keys' dK and dV, (c) its rows' dQ; where
//   a GQA group's query heads are split over several (b) blocks, each
//   writes fp32 partials and a last kernel sums them in split order.
//   4. Eight warps a block, each tile in two phases with a barrier
//   between: phase 1 splits the scores of the tile (S, P, dP, dS) among
//   the warps and leaves bf16 P and dS's hi and lo in shared memory;
//   phase 2 splits the gradient's columns among them, each warp reading
//   the A operands it needs back by ldmatrix. So a warp holds at most 64
//   fp32 accumulators a thread (hd 256 included) beside its share of one
//   score tile, and no product is computed twice. (With a warp holding
//   all of 16 keys' dK and dV, 128 accumulators a thread from hd 128,
//   ptxas spilled.)
//   (b) One block per (KV head and split, b, key tile of 64 keys; 32
//   from hd 144). K and V stay in shared memory; the block walks, in
//   order, each query head of its split and each 64-row query tile inside
//   the causal and window band, Q, dO, L and D streaming through two
//   stages. A warp owns 16 keys (FlashAttention-2's transposed layout)
//   and a slice: of the tile's queries in phase 1 (32; 16 from hd 144),
//   of dK's and dV's n8 column tiles in phase 2 (a half; a quarter from
//   hd 144, the last quarter short where hd / 8 is not a multiple of 4).
//   Phase 1: S^T = K Q^T, P^T, dP^T = V dO^T, dS^T. Phase 2: dV += P^T
//   dO, dK += hi^T Q + lo^T Q. dK and dV stay in fp32 registers for the
//   whole walk, rounded to bf16 once (one split) or written as fp32
//   partials. Up to hd 96 two blocks share an SM.
//   (c) One block per (query head, b, 64-row query tile), a warp 16 rows
//   and a half: Q and dO stay in shared memory, K and V tiles of (b)'s
//   key-tile width stream through two stages in ascending order inside
//   the band (the forward's block_span; only tiles that hold a masked
//   pair are masked). Phase 1, its half of the key tile: S = Q K^T, P,
//   dP = dO V^T, dS. Phase 2, its half of dQ's columns: dQ += hi K + lo
//   K, in fp32 registers, rounded to bf16 once.
// The key tile is the slowest axis of (b)'s grid and the query tile of
// (c)'s, so under a causal mask the blocks with the most work start
// first. Tiles, shared memory and head splits are the wrapper's launch
// plan (flash_attention.backward_plan at element size 2); the kernels
// refuse a plan whose tiles or shared memory differ from theirs. Later:
// wgmma and TMA (the H100's full tensor-core rate; mma.sync reaches a
// part of it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBwdWarps = 8;  // (b) and (c)
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kReduceThreads = 256;  // the split sum
constexpr int kSmemPerSM = 233472;   // of which each block reserves 1 KB

// 4 bytes from global to shared memory; zero-filled when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// x rounded to bf16 (round to nearest even), as fp32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int I>
struct Int {
  static constexpr int value = I;
};

// f(Int<0>()), ..., f(Int<N - 1>()): a loop whose index is a constant
template <int N, int I = 0, typename F>
__device__ __forceinline__ void unrolled(F&& f) {
  if constexpr (I < N) {
    f(Int<I>());
    unrolled<N, I + 1>(f);
  }
}

// s = A B^T over HD columns: A the 16 rows at `a`, B the 8 NT rows at
// `b`, both in shared memory at HD + 8 elements a row; s[n][e] is the
// warp's m16n8 fragment (row lane/4 + 8 (e/2), column 8 n + 2 (lane%4) +
// e%2). Each operand's fragments are read at one address register plus
// constant offsets.
template <int HD, int NT>
__device__ __forceinline__ void product_abt(float (&s)[NT][4], const bf16* a,
                                            const bf16* b, int lane) {
  constexpr int PITCH = HD + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
  const uint32_t a0 = smem_u32(a + (lane % 16) * PITCH + (lane / 16) * 8);
  const uint32_t b0 = smem_u32(b + ((lane / 16) * 8 + lane % 8) * PITCH +
                               ((lane / 8) % 2) * 8);
  unrolled<HD / 16>([&](auto kk_) {
    constexpr int kk = decltype(kk_)::value;
    uint32_t af[4];
    ldmatrix_x4<kk * 32>(af, a0);
    unrolled<NT / 2>([&](auto np_) {
      constexpr int np = decltype(np_)::value;
      uint32_t bb[4];
      ldmatrix_x4<(np * 16 * PITCH + kk * 16) * 2>(bb, b0);
      mma_bf16(s[2 * np], af, bb[0], bb[1]);
      mma_bf16(s[2 * np + 1], af, bb[2], bb[3]);
    });
  });
}

// acc += sum over i of A_i B: A_i the 16 x 16 NK tile at a[i] (shared
// memory, AP elements a row), B the 16 NK rows at `b` (BP elements a row)
// and the first n_valid of its 8 NC columns; each fragment of A_i is read
// once by ldmatrix, each of B once by ldmatrix.trans, two k-steps at a
// time. acc[n] sums its k-steps in order, A_0's product before A_1's.
template <int AP, int BP, int NK, int NC, int NA>
__device__ __forceinline__ void product_ab(float (&acc)[NC][4],
                                           const bf16* const (&a)[NA],
                                           const bf16* b, int n_valid,
                                           int lane) {
  uint32_t a0[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i)
    a0[i] = smem_u32(a[i] + (lane % 16) * AP + (lane / 16) * 8);
  const uint32_t b0 = smem_u32(b + lane * BP);
  unrolled<NK / 2>([&](auto k2_) {
    constexpr int k2 = decltype(k2_)::value;
    uint32_t af[NA][2][4];
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      ldmatrix_x4<k2 * 64>(af[i][0], a0[i]);
      ldmatrix_x4<k2 * 64 + 32>(af[i][1], a0[i]);
    }
    unrolled<NC>([&](auto nc_) {
      constexpr int nc = decltype(nc_)::value;
      if (nc < n_valid) {
        uint32_t bb[4];
        ldmatrix_x4_trans<(k2 * 32 * BP + nc * 8) * 2>(bb, b0);
#pragma unroll
        for (int i = 0; i < NA; ++i)
          mma_bf16(acc[nc], af[i][0], bb[0], bb[1]);
#pragma unroll
        for (int i = 0; i < NA; ++i)
          mma_bf16(acc[nc], af[i][1], bb[2], bb[3]);
      }
    });
  });
}

// the fragment s (its row r0 + lane/4 + 8 (e/2), column c0 + 8 n +
// 2 (lane%4) + e%2) as bf16 pairs into a tile of shared memory, XP
// elements a row: hi = bf16(s); with lo, also bf16(s - hi) into `lo`
template <int XP, int NT>
__device__ __forceinline__ void store_pairs(bf16* hi, bf16* lo,
                                            const float (&s)[NT][4], int r0,
                                            int c0, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int at = (r0 + lane / 4 + 8 * i) * XP + c0 + 8 * n + 2 * (lane % 4);
      const uint32_t h = pack_bf16(s[n][2 * i], s[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(hi + at) = h;
      if (lo != nullptr)
        *reinterpret_cast<uint32_t*>(lo + at) = pack_bf16(
            s[n][2 * i] - bf16_lo(h), s[n][2 * i + 1] - bf16_hi(h));
    }
  }
}

// ---- (a) D = rowsum(dO o O): one warp per (b, s, h) row of the
// contiguous (B, Sq, Hq, hd) out and dout, into delta (B, Hq, Sq); the
// fp32 backward's order of sums

__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta_kernel(const bf16* __restrict__ out,
                                 const bf16* __restrict__ dout,
                                 float* __restrict__ delta, int64_t rows,
                                 int Sq, int Hq, int hd) {
  const int lane = threadIdx.x % 32;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (r >= rows) return;  // the whole warp
  const bf16* o = out + r * hd;
  const bf16* g = dout + r * hd;
  float acc = 0.0f;
  for (int c = 4 * lane; c < hd; c += 128) {
    const uint2 x = *reinterpret_cast<const uint2*>(o + c);
    const uint2 y = *reinterpret_cast<const uint2*>(g + c);
    acc = fmaf(bf16_lo(x.x), bf16_lo(y.x), acc);
    acc = fmaf(bf16_hi(x.x), bf16_hi(y.x), acc);
    acc = fmaf(bf16_lo(x.y), bf16_lo(y.y), acc);
    acc = fmaf(bf16_hi(x.y), bf16_hi(y.y), acc);
  }
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
  const bf16* dout;    // contiguous (B, Sq, Hq, hd)
  const float* lse;    // (B, Hq, Sq)
  const float* delta;  // (B, Hq, Sq)
};

// where (b) writes: dk and dv (B, Sk, Hkv, hd) bf16 with one split, else
// part (2, splits, B, Sk, Hkv, hd) fp32, n elements a partial
struct Out {
  bf16* dk;
  bf16* dv;
  float* part;
  int64_t n;
  int splits;
};

// (b)'s tiles at head size HD: eight warps, a 16-key group each, G
// groups and 8 / G warps ("slices") a group. Phase 1: a warp's slice of
// the query tile (QS queries); phase 2: its slice of dK's and dV's n8
// column tiles (at most NCM; the last slice may hold fewer)
template <int HD>
struct KVTiles {
  static constexpr int kBK = HD <= 128 ? 64 : 32;  // keys a block
  static constexpr int kGroups = kBK / 16;
  static constexpr int kSlices = kBwdWarps / kGroups;
  static constexpr int kQS = kBQ / kSlices;
  static constexpr int kNCT = HD / 8;
  static constexpr int kNCM = (kNCT + kSlices - 1) / kSlices;
  static constexpr int kPitch = HD + 8;   // K, V, Q, dO rows, elements
  static constexpr int kXPitch = kBQ + 8; // P^T, dS^T hi, lo rows
  // bytes of a stage: Q and dO tiles, L and D
  static constexpr int kStage = 2 * kBQ * kPitch * 2 + 2 * kBQ * 4;
  static constexpr int kBytes =
      2 * kBK * kPitch * 2 + 2 * kStage + 3 * kBK * kXPitch * 2;
  // two blocks an SM where their shared memory fits (to hd 96): ptxas
  // then holds a thread to 128 registers, which it does without a spill
  static constexpr int kMinBlocks =
      2 * (kBytes + 1024) <= kSmemPerSM ? 2 : 1;
};

// (c)'s tiles: Q and dO, two stages of K and V tiles of (b)'s width, and
// dS hi and lo; eight warps, a 16-row group each and two warps a group
// (phase 1: half of the key tile; phase 2: half of dQ's columns)
template <int HD>
struct QTiles {
  static constexpr int kBK = KVTiles<HD>::kBK;
  static constexpr int kKS = kBK / 2;
  static constexpr int kCW = HD / 2;
  static constexpr int kPitch = HD + 8;
  static constexpr int kXPitch = kBK + 8;  // dS hi, lo rows
  static constexpr int kBytes =
      (2 * kBQ + 4 * kBK) * kPitch * 2 + 2 * kBQ * kXPitch * 2;
};

// ---- (b) dK and dV

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, KVTiles<HD>::kMinBlocks)
flash_attention_bwd_dkdv_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v, Grad gr, Out o,
                                Problem p) {
  using Tiles = KVTiles<HD>;
  constexpr int BK = Tiles::kBK;
  constexpr int PITCH = Tiles::kPitch;
  constexpr int XP = Tiles::kXPitch;
  constexpr int QS = Tiles::kQS;
  constexpr int NCM = Tiles::kNCM;
  constexpr int NT = QS / 8;  // n8 tiles of a warp's S^T, dP^T
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);  // [BK][PITCH]
  bf16* v_s = k_s + BK * PITCH;                // [BK][PITCH]
  // stage st: Q [kBQ][PITCH], dO [kBQ][PITCH], L [kBQ], D [kBQ]
  char* stages = reinterpret_cast<char*>(v_s + BK * PITCH);
  auto q_stage = [&](int st) {
    return reinterpret_cast<bf16*>(stages + st * Tiles::kStage);
  };
  // the tile's P^T, dS^T hi and dS^T lo, [BK][XP] each
  bf16* p_x = reinterpret_cast<bf16*>(stages + 2 * Tiles::kStage);
  bf16* h_x = p_x + BK * XP;
  bf16* l_x = h_x + BK * XP;

  // the key tile is the grid's slowest axis: when causal the first keys,
  // which the most query tiles see, start first
  const int k0 = blockIdx.z * BK;
  const int hk = blockIdx.x / o.splits;
  const int split = blockIdx.x % o.splits;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int kg = warp % Tiles::kGroups;   // the warp's 16 keys
  const int sl = warp / Tiles::kGroups;   // and its slice
  const int key_a = k0 + kg * 16 + lane / 4;  // fragment rows, and + 8
  const int c0 = sl * NCM * 8;                // phase 2's first column
  const int n_valid = min(NCM, Tiles::kNCT - sl * NCM);

  // this split's query heads, and the query tiles whose rows see a key
  // of this block
  const int heads = p.rep / o.splits;
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
    bf16* qs = q_stage(st);
    bf16* gs = qs + kBQ * PITCH;
    float* ls = reinterpret_cast<float*>(gs + kBQ * PITCH);
    load_tile<bf16, HD, kBQ, kBwdThreads>(
        qs, PITCH, q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.Sq);
    load_tile<bf16, HD, kBQ, kBwdThreads>(
        gs, PITCH, gr.dout + (static_cast<int64_t>(b) * p.Sq * p.Hq + h) * HD,
        g_row, q0, p.Sq);
    // threads 0-63 copy the tile's L, 64-127 its D
    if (threadIdx.x < 2 * kBQ) {
      const int t = threadIdx.x % kBQ;
      const bool in = q0 + t < p.Sq;
      const int64_t row =
          (static_cast<int64_t>(b) * p.Hq + h) * p.Sq + (in ? q0 + t : 0);
      if (threadIdx.x < kBQ)
        cp_async4(ls + t, gr.lse + row, in);
      else
        cp_async4(ls + kBQ + t, gr.delta + row, in);
    }
  };

  load_tile<bf16, HD, BK, kBwdThreads>(
      k_s, PITCH, k + b * p.ks.b + hk * p.ks.h, p.ks.s, k0, p.Sk);
  load_tile<bf16, HD, BK, kBwdThreads>(
      v_s, PITCH, v + b * p.vs.b + hk * p.vs.h, p.vs.s, k0, p.Sk);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  float dk[NCM][4], dv[NCM][4];
#pragma unroll
  for (int n = 0; n < NCM; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;
  const float sl2 = p.scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = q_first + (it % n_q) * kBQ;
    const int st = it & 1;
    cp_async_wait_all();
    // tile it landed; every warp is done with tile it - 1 (its stage and
    // the exchange tiles)
    __syncthreads();
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* qs = q_stage(st);
    const bf16* gs = qs + kBQ * PITCH;
    const float* ls = reinterpret_cast<const float*>(gs + kBQ * PITCH);
    const float* ds = ls + kBQ;
    const bool masked = q0 + kBQ > p.Sq || tile_needs_mask(q0, k0, BK, p);

    // phase 1, the warp's 16 keys x QS queries: P^T = exp(scale S^T - L)
    // with S^T = K Q^T; dP^T = V dO^T rounded to bf16; dS^T = scale P^T o
    // (dP^T - D); bf16 P^T and dS^T's hi and lo to the exchange tiles
    {
      const int j0 = sl * QS;
      float s[NT][4];
      product_abt<HD, NT>(s, k_s + kg * 16 * PITCH, qs + j0 * PITCH, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = j0 + n * 8 + 2 * tq;  // the fragment's query column
        const float2 L = *reinterpret_cast<const float2*>(ls + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q0 + c + (e & 1);
          const float l2 = ((e & 1) ? L.y : L.x) * kLog2e;
          s[n][e] = (!masked ||
                     (qp < p.Sq && visible(qp, key_a + (e / 2) * 8, p)))
                        ? exp2f(fmaf(s[n][e], sl2, -l2))
                        : 0.0f;
        }
      }
      store_pairs<XP, NT>(p_x, nullptr, s, kg * 16, j0, lane);
      float dp[NT][4];
      product_abt<HD, NT>(dp, v_s + kg * 16 * PITCH, gs + j0 * PITCH, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 D =
            *reinterpret_cast<const float2*>(ds + j0 + n * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] *
                     (round_bf16(dp[n][e]) - ((e & 1) ? D.y : D.x)) * p.scale;
      }
      store_pairs<XP, NT>(h_x, l_x, dp, kg * 16, j0, lane);
    }
    __syncthreads();  // the tile's P^T and dS^T are in

    // phase 2, the warp's 16 keys x its column tiles over the tile's 64
    // queries: dV += P^T dO, dK += hi^T Q + lo^T Q
    {
      const bf16* const pa[1] = {p_x + kg * 16 * XP};
      product_ab<XP, PITCH, kBQ / 16, NCM, 1>(dv, pa, gs + c0, n_valid,
                                               lane);
      const bf16* const da[2] = {h_x + kg * 16 * XP, l_x + kg * 16 * XP};
      product_ab<XP, PITCH, kBQ / 16, NCM, 2>(dk, da, qs + c0, n_valid,
                                               lane);
    }
  }

  // dK and dV of the warp's keys and columns: bf16 with one split, else
  // this split's fp32 partials; a key that no query sees gets zeros
  const int Hkv = p.Hq / p.rep;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key_a + i * 8;
    if (key >= p.Sk) continue;
    const int64_t off =
        ((static_cast<int64_t>(b) * p.Sk + key) * Hkv + hk) * HD + c0 +
        2 * tq;
#pragma unroll
    for (int n = 0; n < NCM; ++n) {
      if (n >= n_valid) continue;
      if (o.splits == 1) {
        *reinterpret_cast<uint32_t*>(o.dk + off + n * 8) =
            pack_bf16(dk[n][2 * i], dk[n][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(o.dv + off + n * 8) =
            pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
      } else {
        *reinterpret_cast<float2*>(o.part + split * o.n + off + n * 8) =
            make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
        *reinterpret_cast<float2*>(o.part + (o.splits + split) * o.n + off +
                                   n * 8) =
            make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
  }
}

// ---- (c) dQ, S and dP recomputed

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dq_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v, Grad gr,
                              bf16* __restrict__ dq, Problem p) {
  using Tiles = QTiles<HD>;
  constexpr int BK = Tiles::kBK;
  constexpr int KS = Tiles::kKS;
  constexpr int CW = Tiles::kCW;
  constexpr int PITCH = Tiles::kPitch;
  constexpr int XP = Tiles::kXPitch;
  constexpr int NT = KS / 8;   // n8 tiles of a warp's S, dP
  constexpr int NC = CW / 8;   // n8 tiles of a warp's dQ
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // [kBQ][PITCH]
  bf16* g_s = q_s + kBQ * PITCH;               // [kBQ][PITCH], dO
  bf16* k_s = g_s + kBQ * PITCH;               // [2][BK][PITCH]
  bf16* v_s = k_s + 2 * BK * PITCH;            // [2][BK][PITCH]
  bf16* h_x = v_s + 2 * BK * PITCH;            // [kBQ][XP], dS hi
  bf16* l_x = h_x + kBQ * XP;                  // [kBQ][XP], dS lo

  // the query tile is the grid's slowest axis (the longest rows first
  // when causal) and its key tiles
  const Span span = block_span<BK>(p, static_cast<int>(blockIdx.z),
                                   static_cast<int>(gridDim.z));
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / p.rep;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const int rg = warp % 4;    // the warp's 16 rows
  const int half = warp / 4;  // its half of a key tile, then of dQ
  const int row_a = span.q0 + rg * 16 + lane / 4;  // and row_a + 8

  const bf16* kb = k + b * p.ks.b + hk * p.ks.h;
  const bf16* vb = v + b * p.vs.b + hk * p.vs.h;
  auto load_kv = [&](int t, int st) {
    const int k0 = span.k_first + t * BK;
    load_tile<bf16, HD, BK, kBwdThreads>(k_s + st * BK * PITCH, PITCH, kb,
                                         p.ks.s, k0, p.Sk);
    load_tile<bf16, HD, BK, kBwdThreads>(v_s + st * BK * PITCH, PITCH, vb,
                                         p.vs.s, k0, p.Sk);
  };
  load_tile<bf16, HD, kBQ, kBwdThreads>(
      q_s, PITCH, q + b * p.qs.b + h * p.qs.h, p.qs.s, span.q0, p.Sq);
  load_tile<bf16, HD, kBQ, kBwdThreads>(
      g_s, PITCH, gr.dout + (static_cast<int64_t>(b) * p.Sq * p.Hq + h) * HD,
      static_cast<int64_t>(p.Hq) * HD, span.q0, p.Sq);
  load_kv(0, 0);
  cp_async_commit();

  // L (base 2) and D of rows row_a and row_a + 8
  float l2[2], D[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    const int64_t at = (static_cast<int64_t>(b) * p.Hq + h) * p.Sq + row;
    l2[i] = row < p.Sq ? gr.lse[at] * kLog2e : 0.0f;
    D[i] = row < p.Sq ? gr.delta[at] : 0.0f;
  }
  const float sl2 = p.scale * kLog2e;

  float acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int t = 0; t < span.n_tiles; ++t) {
    const int k0 = span.k_first + t * BK;
    const int st = t & 1;
    cp_async_wait_all();
    // tile t landed; every warp is done with tile t - 1 (its stage and the
    // exchange tiles)
    __syncthreads();
    if (t + 1 < span.n_tiles) {
      load_kv(t + 1, st ^ 1);
      cp_async_commit();
    }
    const bf16* kt = k_s + st * BK * PITCH;
    const bf16* vt = v_s + st * BK * PITCH;

    // phase 1, the warp's 16 rows x KS keys: P = exp(scale S - L) with
    // S = Q K^T; dP = dO V^T rounded to bf16; dS = scale P o (dP - D);
    // dS's hi and lo to the exchange tiles
    {
      const int j0 = half * KS;
      float s[NT][4];
      product_abt<HD, NT>(s, q_s + rg * 16 * PITCH, kt + j0 * PITCH, lane);
      const bool masked = tile_needs_mask(span.q0, k0, BK, p);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j0 + n * 8 + 2 * tq + (e & 1);
          s[n][e] = (!masked || visible(row_a + (e / 2) * 8, kp, p))
                        ? exp2f(fmaf(s[n][e], sl2, -l2[e / 2]))
                        : 0.0f;
        }
      }
      float dp[NT][4];
      product_abt<HD, NT>(dp, g_s + rg * 16 * PITCH, vt + j0 * PITCH, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] * (round_bf16(dp[n][e]) - D[e / 2]) * p.scale;
      store_pairs<XP, NT>(h_x, l_x, dp, rg * 16, j0, lane);
    }
    __syncthreads();  // the tile's dS is in

    // phase 2, the warp's 16 rows x its half of dQ's columns over the
    // tile's BK keys: dQ += hi K + lo K
    const bf16* const da[2] = {h_x + rg * 16 * XP, l_x + rg * 16 * XP};
    product_ab<XP, PITCH, BK / 16, NC, 2>(acc, da, kt + half * CW, NC, lane);
  }

  // dQ of the warp's rows and columns, contiguous (B, Sq, Hq, hd) bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + i * 8;
    if (row >= p.Sq) continue;
    bf16* drow = dq + ((static_cast<int64_t>(b) * p.Sq + row) * p.Hq + h) *
                          HD + half * CW;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<uint32_t*>(drow + n * 8 + 2 * tq) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// ---- the splits' fp32 partials of dK (blockIdx.y 0) and dV (1), summed
// in split order and rounded to bf16 once: part is (2, splits, n4) float4

__global__ void __launch_bounds__(kReduceThreads)
flash_attention_bwd_reduce_kernel(const float4* __restrict__ part,
                                  uint2* __restrict__ dk,
                                  uint2* __restrict__ dv, int64_t n4,
                                  int splits) {
  const float4* src = part + blockIdx.y * splits * n4;
  uint2* dst = blockIdx.y ? dv : dk;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads +
                   threadIdx.x;
       i < n4; i += static_cast<int64_t>(gridDim.x) * kReduceThreads) {
    float4 s = src[i];
    for (int g = 1; g < splits; ++g) {
      const float4 t = src[g * n4 + i];
      s = make_float4(s.x + t.x, s.y + t.y, s.z + t.z, s.w + t.w);
    }
    dst[i] = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
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
cudaError_t launch_hd(const bf16* q, const bf16* k, const bf16* v,
                      const Grad& gr, bf16* dq, bf16* dk, bf16* dv,
                      float* part, int B, const Problem& p, const Plan& plan,
                      cudaStream_t stream) {
  using KV = KVTiles<HD>;
  using QT = QTiles<HD>;
  // a plan made for other tiles than these kernels' is refused
  if (plan.block_keys != KV::kBK || plan.dkdv_smem != KV::kBytes ||
      plan.dq_smem != QT::kBytes)
    return cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem(flash_attention_bwd_dkdv_kernel<HD>, plan.dkdv_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_attention_bwd_dq_kernel<HD>, plan.dq_smem);
  if (err != cudaSuccess) return err;
  const int Hkv = p.Hq / p.rep;
  const int64_t n = static_cast<int64_t>(B) * p.Sk * Hkv * HD;
  const Out o{dk, dv, part, n, plan.splits};
  const dim3 grid_kv(static_cast<unsigned>(Hkv * plan.splits),
                     static_cast<unsigned>(B),
                     static_cast<unsigned>((p.Sk + KV::kBK - 1) / KV::kBK));
  flash_attention_bwd_dkdv_kernel<HD>
      <<<grid_kv, kBwdThreads, plan.dkdv_smem, stream>>>(q, k, v, gr, o,
                                                          p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q(static_cast<unsigned>(p.Hq), static_cast<unsigned>(B),
                    static_cast<unsigned>((p.Sq + kBQ - 1) / kBQ));
  flash_attention_bwd_dq_kernel<HD>
      <<<grid_q, kBwdThreads, plan.dq_smem, stream>>>(q, k, v, gr, dq, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.splits == 1) return err;
  flash_attention_bwd_reduce_kernel<<<
      dim3(static_cast<unsigned>(plan.reduce_blocks), 2), kReduceThreads, 0,
      stream>>>(reinterpret_cast<const float4*>(part),
                reinterpret_cast<uint2*>(dk), reinterpret_cast<uint2*>(dv),
                n / 4, plan.splits);
  return cudaGetLastError();
}

cudaError_t dispatch(const bf16* q, const bf16* k, const bf16* v,
                     const bf16* out, const bf16* dout, const float* lse,
                     float* delta, bf16* dq, bf16* dk, bf16* dv, float* part,
                     int B, int Sq, int Sk, int Hq, int Hkv, int hd,
                     const long long* strides, int causal, int window,
                     float scale, const int* plan_ints, int device,
                     void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (hd % 16 || hd < 16 || hd > 256) return cudaErrorInvalidValue;
  const Plan plan{plan_ints[0], plan_ints[1], plan_ints[2], plan_ints[3],
                  plan_ints[4], plan_ints[5], plan_ints[6]};
  if (plan.splits < 1 || (Hq / Hkv) % plan.splits || plan.n_slabs != 1 ||
      plan.slab_keys < Sk || plan.reduce_blocks < 1 ||
      (plan.splits > 1 && part == nullptr))
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
#define FA_CASE(N)                                                        \
  case N:                                                                 \
    return launch_hd<16 * N>(q, k, v, gr, dq, dk, dv, part, B, p, plan, s);
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
// (a), (b), (c), then the split sum when there is more than one split.
// q, k and v as the forward took them (bf16 on `device`, `strides` their
// nine (b, s, h) strides in elements, 16-byte aligned); out and dout
// contiguous (B, Sq, Hq, hd) bf16, 16-byte aligned; lse the forward's
// (B, Hq, Sq) fp32; delta a (B, Hq, Sq) fp32 scratch; dq contiguous (B,
// Sq, Hq, hd), dk and dv contiguous (B, Sk, Hkv, hd), bf16; part the (2,
// splits, B, Sk, Hkv, hd) fp32 scratch of the partials (null with one
// split); `plan` the launch plan's 7 ints (block keys, splits, keys a
// pass (every key: one pass), passes (1), (b)'s and (c)'s shared bytes,
// the split sum's blocks). hd is a multiple of 16 up to 256, Hq a
// multiple of Hkv, every query row sees a key (the forward's wrapper
// refuses the rest); window <= 0 means none. Returns the first
// cudaGetLastError() that is not cudaSuccess, or cudaErrorInvalidValue
// for a plan these kernels do not match.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* part, int B, int Sq, int Sk, int Hq, int Hkv, int hd,
    const long long* strides, int causal, int window, float scale,
    const int* plan, int device, void* stream) {
  return static_cast<int>(dispatch(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(part), B, Sq, Sk, Hq, Hkv, hd, strides, causal,
      window, scale, plan, device, stream));
}

extern "C" const char* flash_attention_bwd_bf16_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
