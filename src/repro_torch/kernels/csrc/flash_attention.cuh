// What the forward (flash_attention.cu) and the backwards
// (flash_attention_bwd.cu in fp32, flash_attention_bwd_bf16.cu in bf16)
// of K4 share: the problem they are given, the cp.async copies that stage
// q, k and v rows in shared memory, the mask and the span of key tiles a
// block of query rows walks; and the tensor-core primitives of the two
// bf16 sources (ldmatrix, mma.sync.m16n8k16 with bf16 inputs and fp32
// sums, the bf16 pair packing).
//
// Positions are aligned: query row i and key j sit at positions i and j,
// so row i sees the keys j with j <= i (causal) and j > i - window
// (window > 0). A masked score is -1e30, as in the Pallas kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // four warps
constexpr int kBQ = 64;                  // query rows per block (tile)
constexpr float kNegInf = -1e30f;        // the Pallas kernel's NEG_INF
constexpr int kMaxSmem = 232448;         // dynamic shared memory a block

struct Strides {
  int64_t b, s, h;  // of q, k or v, in elements; the last axis is 1
};

struct Problem {
  int Sq, Sk, Hq, rep, causal, window;
  float scale;
  Strides qs, ks, vs;
};

// ---- cp.async (sm_80 and later)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zero-filled when !in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + ROWS) of one (b, head) slice of q, k, v (or a gradient
// of the same layout) into shared memory at `pitch` elements a row; rows
// at or past S are zero-filled; a block of THREADS threads
template <typename T, int HD, int ROWS, int THREADS = kThreads>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const T* base,
                                          int64_t stride_s, int r0, int S) {
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = HD / kChunk;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kChunk;
    const bool in = r0 + r < S;
    const T* src = base + (in ? (r0 + r) * stride_s + c : 0);
    cp_async16(dst + r * pitch + c, src, in);
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, const Problem& p) {
  return kp < p.Sk && (!p.causal || kp <= qp) &&
         (p.window <= 0 || kp > qp - p.window);
}

// whether keys [k0, k0 + bk) hold a pair that some row of [q0, q0 + kBQ)
// must not see
__device__ __forceinline__ bool tile_needs_mask(int q0, int k0, int bk,
                                                const Problem& p) {
  return k0 + bk > p.Sk || (p.causal && k0 + bk - 1 > q0) ||
         (p.window > 0 && k0 <= q0 + kBQ - 1 - p.window);
}

// a block's query tile and the key tiles its rows can see
struct Span {
  int q0, k_first, n_tiles;
};

// query tile `tile` of `n_tiles` (the last first when causal: the longest
// rows start first, so the causal triangle's short tiles fill the tail of
// the grid) and its key tiles of BK keys
template <int BK>
__device__ __forceinline__ Span block_span(const Problem& p, int tile,
                                           int n_tiles) {
  const int qt = p.causal ? n_tiles - 1 - tile : tile;
  const int q0 = qt * kBQ;
  const int q_end = min(q0 + kBQ, p.Sq);
  const int lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int hi = p.causal ? min(p.Sk, q_end) : p.Sk;
  const int k_first = (lo / BK) * BK;
  return {q0, k_first, (hi - k_first + BK - 1) / BK};
}

// the query tile of blockIdx.x, of gridDim.x
template <int BK>
__device__ __forceinline__ Span block_span(const Problem& p) {
  return block_span<BK>(p, static_cast<int>(blockIdx.x),
                        static_cast<int>(gridDim.x));
}

// ---- tensor-core primitives (sm_80 and later)

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// the same two at the shared-space address `addr` plus OFF bytes, a
// constant folded into the instruction: one address register serves a
// whole tile, however many fragments the loops over it read
template <int OFF>
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
      "[%4+%5];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr), "n"(OFF));
}

template <int OFF>
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4+%5];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr), "n"(OFF));
}

// c += a b for one m16n8k16 tile: bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace
