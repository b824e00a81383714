// ssd: the Mamba2 chunked SSD scan (state-space duality), for the prefill
// of every layer of the SSM family.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py::ssd. x is
// (b, l, h, p), already scaled by dt; dlogA (b, l, h) is the per-step log
// decay dt * A (<= 0); B and C are (b, l, n), one group shared by all
// heads; h0 (b, h, p, n) is optional (zeros). Each is read in place
// through its strides (the last axis of x, B and C contiguous). Outputs:
// y (b, l, h, p) and h_last (b, h, p, n), contiguous. Chunks of L steps;
// within chunk c, with cum the inclusive prefix sum of dlogA over the
// chunk and h the state entering it:
//   y_i  = sum_{j<=i} (C_i . B_j) e^{cum_i - cum_j} x_j + e^{cum_i} C_i h^T
//   h   <- e^{cum_{L-1}} h + sum_j e^{cum_{L-1} - cum_j} x_j^T B_j
// Every decay is the exponential of a difference of prefix sums (or of a
// prefix sum itself), each <= 0, so no factor overflows: with the model's
// dt a 256-step chunk reaches cum ~ -200, where e^{-cum} is inf in fp32.
// Inputs and outputs are float32; every product is an IEEE fp32 fmaf (no
// tensor cores, no TF32). bf16 is refused by the wrapper: mamba_block
// casts x_dt, B and C to float32 before the scan (repro/models/ssm.py),
// so the model never passes it; a bf16 path belongs with bf16 serving.
//
// What bounds it: operations. At the serve shape of mamba2-370m (b 4,
// l 512, h 32, p 64, n 128, chunk 256) the least work is 2.76 GFLOP (the
// head-independent C B^T of the causal pairs once per (b, chunk), then
// per head the scores times X, the state update, and C h^T in the second
// chunk: the prefill's first chunk carries in no state) against 40 MB of
// inputs and outputs: 69 flops per byte, above the H100's fp32 ridge
// (20), so the least time is the flops at 67 TFLOP/s outside the tensor
// cores, 0.041 ms.
//
// What the design does about it: only the (p, n) state passed from chunk
// to chunk is sequential, so the work is split along Mamba2's own steps
// into three launches on one stream, the chunks in parallel:
//  1. ssd_chunk_kernel. Blocks of two kinds. One block per (b, head,
//     chunk) takes the chunk's prefix sum of dlogA (every warp: a shuffle
//     scan per warp, then the warps' totals in order), writes it to the
//     `cum` workspace, and computes the chunk's own state contribution
//     sum_j e^{cum_last - cum_j} x_j^T B_j, transposed, (n, p), into the
//     `states` workspace: x's rows are scaled by their decays in shared
//     memory, then each of 128 threads accumulates an 8-column-of-p by
//     n/16 (p <= 64) or n/8 tile, fed by two float4s of x and two (four)
//     of B a step.
//     One block per (b, chunk, causal pair of 64-row tiles) computes the
//     scores C B^T once for every head (B and C have one group) into the
//     `scores` workspace, transposed (1.3 MB at the serve shape: it stays
//     in L2).
//  2. ssd_pass_kernel passes the states along the chunks, in place:
//     slot c becomes the state entering chunk c (h0 or zeros first),
//     h <- e^{cum_last} h + state[c]; the last update is h_last. Each
//     chunk's loads are issued before the previous chunk's stores, and
//     h0 and h_last are transposed through shared memory.
//  3. ssd_output_kernel, one block per (b, head, chunk, 64-row query
//     tile), the heaviest tiles first, walks 64-row tiles through one
//     two-stage ring and adds each tile's S X into the register tile of
//     each of its 128 threads (4 rows by 8 columns at p <= 64, else 16):
//     first, where a state enters the chunk (not in the first chunk when
//     h0 is None), C h^T as tiles of C^T (written once per (b, chunk) by
//     pass 1's diagonal score blocks) and of the transposed state; then
//     the key tiles at or before the query tile, transposed scores and
//     x. Off the diagonal the decay factors into a row and a column
//     factor, both exponents <= 0, applied to x's rows and, once, to the
//     sums: 64 exponentials a tile; the diagonal tile is decayed and
//     masked in place, and there each warp stops at its own last row
//     (16-row steps, so 40 of the 64 key rows on average).
// At p <= 64 two blocks of pass 1 and three of pass 3 share an SM
// (98,324 and 68,352 bytes of shared memory each). The wrapper owns the
// grids and each launch's shared memory (ssd.py::launch_plan,
// smem_bytes); the kernels own the decode of blockIdx and the carve-up
// of their shared memory.
// Tiles arrive by cp.async in 16-byte pieces, two stages deep, so the
// next tile's copy runs under this tile's FMAs; inputs off 16-byte
// alignment (a base address or a row stride) take 4-byte pieces instead
// (the wrapper's `vec` flag), with no copy on the host. Sums run in a
// fixed order with no atomics, so a repeated call gives the same bits.
// At the serve shape the kernels do 2.84 GFLOP, as modelled by
// ssd.py::kernel_flops (not counted on the card):
// 0.08 scores over whole tiles, 1.07 states, 1.14 scores times x and
// 0.54 carried-in state (one block per (b, head) walking its chunks in
// order did 6.17). What still bounds them, besides the FMAs: the tiles
// every block copies from L2 (each head's blocks read the same score
// tiles), the decays' exponentials, the barriers around each tile, and
// each launch's fixed cost and tail; mma.sync / wgmma would need TF32,
// which the fp32 contract rules out.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd.cuh"

namespace {

struct Args {
  const float* x;
  const float* dA;
  const float* B;
  const float* C;
  const float* h0;  // nullptr: zeros
  float* y;
  float* hl;
  float* cum;     // (b, H, l): prefix sums of dlogA within each chunk
  float* g;       // (b, nc, ntri, kT, kT): scores of the causal tile pairs
  float* ct;      // (b, nc, nt, n, kT): C transposed, by query tile
  float* st;      // (b, nc, H, n, PW): chunk states, then states entering
  int b, l, L, H, p, n;
  int nc;    // chunks, l / L
  int nt;    // 64-row tiles of a chunk
  int ntri;  // causal tile pairs of a chunk, nt (nt + 1) / 2
  int vec;   // x, B and C copied in 16-byte pieces (1) or 4-byte ones (0)
  int64_t xb, xl, xh;  // strides of x, in elements (the p axis is 1)
  int64_t ab, al, ah;  // of dlogA
  int64_t bb, bl;      // of B (the n axis is 1)
  int64_t cb, cl;      // of C
};

// the chunk's inclusive prefix sum of dlogA (L steps at `stride`) into
// `out` (global, contiguous), by the whole block: segments of kThreads
// steps, a shuffle scan in each warp, the warps' totals added in order,
// each segment carried into the next. Returns out[L - 1] to every thread.
__device__ float chunk_cumsum(const float* dA, int64_t stride, int L,
                              float* out, float* warp_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.0f;
  for (int s0 = 0; s0 < L; s0 += kThreads) {
    const int i = s0 + threadIdx.x;
    float v = i < L ? dA[i * stride] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) warp_s[warp] = v;
    __syncthreads();
    float before = carry, total = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before += warp_s[w];
      total += warp_s[w];
    }
    v += before;
    if (i < L) out[i] = v;
    if (i == L - 1) warp_s[kWarps] = v;
    carry = total;
    __syncthreads();  // warp_s is rewritten by the next segment
  }
  return warp_s[kWarps];
}

// one (b, head, chunk): the prefix sums, and the chunk's own state
// contribution sum_j e^{cum_last - cum_j} x_j^T B_j, written transposed
// (n rows of PW) to the states workspace. Each thread owns 8 columns of
// p (two float4s PW / 2 apart) by 4 NQ of n (float4s NG * 4 apart).
template <int PW>
__device__ __forceinline__ void chunk_state(const Args& a, int c, int bi,
                                            int hh, float* smem) {
  constexpr int PG = PW / 8;          // threads along p
  constexpr int NG = kThreads / PG;   // threads along n
  constexpr int NQ = kN / (4 * NG);   // float4s of n a thread
  constexpr int XF = PW / 4;          // float4s of an x row
  float* b_s = smem;                  // [2][kT][kN]
  float* x_s = b_s + 2 * kT * kN;     // [2][kT][PW]
  float* warp_s = x_s + 2 * kT * PW;  // [kWarps + 1]
  const int tid = threadIdx.x;
  const int pg = tid % PG, ng = tid / PG;
  const int L = a.L;
  const bool vec = a.vec != 0;
  const int64_t t0 = static_cast<int64_t>(c) * L;
  const float* xp = a.x + bi * a.xb + hh * a.xh + t0 * a.xl;
  const float* bp = a.B + bi * a.bb + t0 * a.bl;
  float* cum = a.cum + (static_cast<int64_t>(bi) * a.H + hh) * a.l + t0;

  // the first tile's copies run under the scan
  load_tile<kN>(b_s, kN, bp, a.bl, L, a.n, vec);
  load_tile<PW>(x_s, PW, xp, a.xl, L, a.p, vec);
  cp_async_commit();
  const float cum_last = chunk_cumsum(
      a.dA + bi * a.ab + hh * a.ah + t0 * a.al, a.al, L, cum, warp_s);

  float acc[8][4 * NQ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 4 * NQ; ++k) acc[r][k] = 0.0f;

  for (int kt = 0; kt < a.nt; ++kt) {
    const int j0 = kt * kT;
    const int st = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; tile kt - 1 is done
    if (kt + 1 < a.nt) {
      const int r1 = j0 + kT;
      load_tile<kN>(b_s + (st ^ 1) * kT * kN, kN, bp + r1 * a.bl, a.bl,
                    L - r1, a.n, vec);
      load_tile<PW>(x_s + (st ^ 1) * kT * PW, PW, xp + r1 * a.xl, a.xl,
                    L - r1, a.p, vec);
      cp_async_commit();
    }
    const float* bt = b_s + st * kT * kN;
    float* xt = x_s + st * kT * PW;
    // x_j *= e^{cum_last - cum_j}: float4 tid % XF of rows tid / XF + m
    // kThreads / XF (the scan's writes to cum are visible after its last
    // barrier)
#pragma unroll
    for (int m = 0; m < kT * XF / kThreads; ++m) {
      const int j = tid / XF + m * (kThreads / XF);
      float4* xv = reinterpret_cast<float4*>(xt + j * PW) + tid % XF;
      const float d = j0 + j < L ? expf(cum_last - cum[j0 + j]) : 0.0f;
      float4 v = *xv;
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
      *xv = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kT; ++j) {
      const float4 x0 = *reinterpret_cast<const float4*>(xt + j * PW +
                                                         pg * 4);
      const float4 x1 = *reinterpret_cast<const float4*>(xt + j * PW +
                                                         PW / 2 + pg * 4);
      const float xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 bv = *reinterpret_cast<const float4*>(
            bt + j * kN + (ng + q * NG) * 4);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][4 * q + 0] = fmaf(xs[r], bv.x, acc[r][4 * q + 0]);
          acc[r][4 * q + 1] = fmaf(xs[r], bv.y, acc[r][4 * q + 1]);
          acc[r][4 * q + 2] = fmaf(xs[r], bv.z, acc[r][4 * q + 2]);
          acc[r][4 * q + 3] = fmaf(xs[r], bv.w, acc[r][4 * q + 3]);
        }
      }
    }
  }

  // state^T[k][col]: columns pg * 4 + r and PW / 2 + pg * 4 + r, row
  // (ng + q NG) * 4 + e
  float* out = a.st + ((static_cast<int64_t>(bi) * a.nc + c) * a.H + hh) *
                          a.n * PW;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = (ng + q * NG) * 4 + e;
      if (k >= a.n) continue;
      *reinterpret_cast<float4*>(out + k * PW + pg * 4) =
          make_float4(acc[0][4 * q + e], acc[1][4 * q + e],
                      acc[2][4 * q + e], acc[3][4 * q + e]);
      *reinterpret_cast<float4*>(out + k * PW + PW / 2 + pg * 4) =
          make_float4(acc[4][4 * q + e], acc[5][4 * q + e],
                      acc[6][4 * q + e], acc[7][4 * q + e]);
    }
}

// one (b, chunk, causal pair of tiles qt >= kt): the scores C_i . B_j of
// query rows qt * kT + i and key rows kt * kT + j, shared by every head;
// a diagonal pair also writes its C tile transposed, which pass 3 reads
// for the carried-in state
__device__ __forceinline__ void chunk_scores(const Args& a, int blk,
                                             float* smem) {
  float* c_s = smem;            // [kT][kCP]
  float* b_s = c_s + kT * kCP;  // [kT][kCP]
  const int tile = blk % a.ntri;
  const int bc = blk / a.ntri;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= tile) ++qt;
  const int kt = tile - qt * (qt + 1) / 2;
  const int64_t t0 = static_cast<int64_t>(c) * a.L;
  const bool vec = a.vec != 0;
  load_tile<kN>(c_s, kCP, a.C + bi * a.cb + (t0 + qt * kT) * a.cl, a.cl,
                a.L - qt * kT, a.n, vec);
  load_tile<kN>(b_s, kCP, a.B + bi * a.bb + (t0 + kt * kT) * a.bl, a.bl,
                a.L - kt * kT, a.n, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (qt == kt) {
    float* ct = a.ct + (static_cast<int64_t>(bc) * a.nt + qt) * a.n * kT;
    for (int i = threadIdx.x; i < a.n * kT; i += kThreads)
      ct[i] = c_s[(i % kT) * kCP + i / kT];
  }

  // query rows ty + 16 r, key rows tx + 8 cc: with rows padded to n + 4
  // floats the lanes' float4 reads fall in distinct banks
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float s[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) s[r][cc] = 0.0f;
  for (int k = 0; k < a.n; k += 4) {
    float4 cv[4], bv[8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cv[r] = *reinterpret_cast<const float4*>(c_s + (ty + 16 * r) * kCP + k);
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      bv[cc] = *reinterpret_cast<const float4*>(b_s + (tx + 8 * cc) * kCP + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        float t = s[r][cc];
        t = fmaf(cv[r].x, bv[cc].x, t);
        t = fmaf(cv[r].y, bv[cc].y, t);
        t = fmaf(cv[r].z, bv[cc].z, t);
        s[r][cc] = fmaf(cv[r].w, bv[cc].w, t);
      }
  }
  // transposed, key rows by query columns, as pass 3 reads them
  float* out = a.g + (static_cast<int64_t>(bc) * a.ntri + tile) * kT * kT;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      out[(tx + 8 * cc) * kT + ty + 16 * r] = s[r][cc];
}

// pass 1. Blocks [0, b H nc): chunk states, block i taking chunk
// i / (b H) of (b, head) i % (b H); the b nc ntri blocks after them:
// scores, block j taking tile pair j % ntri of (b, chunk) j / ntri.
template <int PW>
__global__ void __launch_bounds__(kThreads, PW <= 64 ? 2 : 1)
    ssd_chunk_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bh = a.b * a.H;
  const int states = bh * a.nc;
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < states) {
    const int i = blk % bh;
    chunk_state<PW>(a, blk / bh, i / a.H, i % a.H, smem);
  } else {
    chunk_scores(a, blk - states, smem);
  }
}

// pass 2. Grid (b H, ceil(n PW / (kPassThreads kPassVals))): block (head, y)
// carries elements [y, y + 1) * kPassThreads kPassVals of one (b, head)'s
// transposed state, kPassVals / PW rows of it, along the chunks, slot c
// of the states workspace becoming the state entering chunk c; then
// writes them to h_last (b, h, p, n). Each chunk's loads are issued a
// chunk ahead, and h0 and h_last, (p, n) where the slots are (n, PW), go
// through shared memory so that every global access is coalesced.
template <int PW>
__global__ void __launch_bounds__(kPassThreads) ssd_pass_kernel(Args a) {
  constexpr int kVals = kPassThreads * kPassVals;  // elements a block has
  constexpr int KR = kVals / PW;                   // rows of n a block has
  __shared__ float t_s[KR][PW + 1];
  const int bi = blockIdx.x / a.H, hh = blockIdx.x % a.H;
  const int total = a.n * PW;
  const int k0 = blockIdx.y * KR;
  const int64_t head = static_cast<int64_t>(bi) * a.H + hh;
  const int e0 = blockIdx.y * kVals + threadIdx.x;
  // h0 (or zeros) through shared memory: read along n, kept along PW
  for (int i = threadIdx.x; i < kVals; i += kPassThreads) {
    const int col = i / KR, k = k0 + i % KR;
    t_s[i % KR][col] = (a.h0 != nullptr && col < a.p && k < a.n)
                           ? a.h0[(head * a.p + col) * a.n + k]
                           : 0.0f;
  }
  __syncthreads();
  float h[kPassVals], v[kPassVals], vn[kPassVals];
#pragma unroll
  for (int q = 0; q < kPassVals; ++q) {
    const int e = q * kPassThreads + threadIdx.x;
    h[q] = t_s[e / PW][e % PW];
  }
  const int64_t slot = static_cast<int64_t>(a.H) * total;
  float* s = a.st + (static_cast<int64_t>(bi) * a.nc * a.H + hh) * total;
  const float* cum_last = a.cum + head * a.l + a.L - 1;
  float dec = expf(cum_last[0]);
#pragma unroll
  for (int q = 0; q < kPassVals; ++q) {
    const int e = e0 + q * kPassThreads;
    v[q] = e < total ? s[e] : 0.0f;
  }
  for (int c = 0; c < a.nc; ++c) {
    float dn = 0.0f;
#pragma unroll
    for (int q = 0; q < kPassVals; ++q) vn[q] = 0.0f;
    if (c + 1 < a.nc) {  // the next chunk's loads before this one's stores
      dn = expf(cum_last[static_cast<int64_t>(c + 1) * a.L]);
#pragma unroll
      for (int q = 0; q < kPassVals; ++q) {
        const int e = e0 + q * kPassThreads;
        vn[q] = e < total ? s[slot + e] : 0.0f;
      }
    }
#pragma unroll
    for (int q = 0; q < kPassVals; ++q) {
      const int e = e0 + q * kPassThreads;
      if (e < total) s[e] = h[q];
      h[q] = fmaf(dec, h[q], v[q]);
    }
    s += slot;
    dec = dn;
#pragma unroll
    for (int q = 0; q < kPassVals; ++q) v[q] = vn[q];
  }
  // h_last through shared memory: kept along PW, written along n
#pragma unroll
  for (int q = 0; q < kPassVals; ++q) {
    const int e = q * kPassThreads + threadIdx.x;
    t_s[e / PW][e % PW] = h[q];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kVals; i += kPassThreads) {
    const int col = i / KR, k = k0 + i % KR;
    if (col < a.p && k < a.n)
      a.hl[(head * a.p + col) * a.n + k] = t_s[i % KR][col];
  }
}

// pass 3. Block i takes query tile nt - 1 - i / (b H nc) (the heaviest
// first) of chunk (i % (b H nc)) / (b H) of (b, head) i % (b H). It walks
// a sequence of 64-row tiles through one two-stage ring, each tile a
// (64, 64) matrix S^T and a (64, PW) matrix X whose product S X it adds
// to the rows' sums: first, where a state enters the chunk, the carried-
// in product C h^T as ceil(n / 64) tiles of C^T and h^T (rows of n); then
// the key tiles 0 .. qt, transposed scores and x rows. The decays: the
// carried-in sums are scaled by e^{cum_i0} (i0 the tile's first row);
// off the diagonal e^{cum_i - cum_j} = e^{cum_i - cum_i0} e^{cum_i0 -
// cum_j}, both exponents <= 0, so x's rows are scaled by the second
// factor in shared memory and the sums, once, by the first before the
// diagonal tile, whose scores are decayed and masked in place, one
// exponential per visible pair. Each thread owns 4 rows (rg * 4 + r) by
// PW / 8 columns (float4s (cg + 8 q) * 4); a warp, 16 rows by PW / 2.
template <int PW>
__global__ void __launch_bounds__(kThreads, PW <= 64 ? 3 : 2)
    ssd_output_kernel(Args a) {
  constexpr int QC = PW / 32;         // float4s of columns a thread
  constexpr int XF = PW / 4;          // float4s of an X row
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);  // [2][kT][kGP]: S^T
  float* x_s = g_s + 2 * kT * kGP;               // [2][kT][PW]: X
  float* cq_s = x_s + 2 * kT * PW;               // [kT]
  float* ck_s = cq_s + kT;                       // [2][kT]

  const int bh = a.b * a.H;
  const int per_tile = bh * a.nc;
  const int blk = static_cast<int>(blockIdx.x);
  const int qt = a.nt - 1 - blk / per_tile;
  const int rest = blk % per_tile;
  const int c = rest / bh;
  const int bi = (rest % bh) / a.H, hh = (rest % bh) % a.H;
  const int tid = threadIdx.x;
  const int cg = tid % 8, rg = tid / 8;
  const int i0 = qt * kT;
  const int rows_q = min(kT, a.L - i0);
  // carried-in tiles: none in the first chunk without h0
  const int nk = (c > 0 || a.h0 != nullptr) ? (a.n + kT - 1) / kT : 0;
  const int tiles = nk + qt + 1;

  // tile t into stage st
  auto load = [&](int t, int st) {
    float* gd = g_s + st * kT * kGP;
    float* xd = x_s + st * kT * PW;
    const int64_t bc = static_cast<int64_t>(bi) * a.nc + c;
    if (t < nk) {  // the workspaces' rows are 16-byte aligned
      const int k0 = t * kT;
      load_tile<kT>(gd, kGP, a.ct + ((bc * a.nt + qt) * a.n + k0) * kT, kT,
                    a.n - k0, kT, true);
      load_tile<PW>(xd, PW, a.st + ((bc * a.H + hh) * a.n + k0) * PW, PW,
                    a.n - k0, PW, true);
    } else {
      const int kt = t - nk;
      const int64_t j0 = static_cast<int64_t>(c) * a.L + kt * kT;
      load_tile<kT>(gd, kGP,
                    a.g + (bc * a.ntri + qt * (qt + 1) / 2 + kt) * kT * kT,
                    kT, kT, kT, true);
      load_tile<PW>(xd, PW, a.x + bi * a.xb + hh * a.xh + j0 * a.xl, a.xl,
                    a.L - kt * kT, a.p, a.vec != 0);
      if (tid < kT) {
        const float* cum = a.cum + (static_cast<int64_t>(bi) * a.H + hh) *
                                       a.l + j0;
        const bool in = kt * kT + tid < a.L;
        cp_async4(ck_s + st * kT + tid, in ? cum + tid : cum, in);
      }
    }
    cp_async_commit();
  };
  if (tid < kT)
    cq_s[tid] = tid < rows_q
                    ? a.cum[(static_cast<int64_t>(bi) * a.H + hh) * a.l +
                            static_cast<int64_t>(c) * a.L + i0 + tid]
                    : 0.0f;
  load(0, 0);

  float acc[4][4 * QC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4 * QC; ++e) acc[r][e] = 0.0f;
  // this warp's 16 rows end at row_end: on the diagonal tile no key after
  // it is visible to them
  const int row_end = (tid / 32 + 1) * 16;

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; stage st ^ 1 is free
    if (t + 1 < tiles) load(t + 1, st ^ 1);
    const int kt = t - nk;
    float* gt = g_s + st * kT * kGP;
    float* xt = x_s + st * kT * PW;
    int jmax = min(kT, a.n - t * kT);  // a carried-in tile: n rows
    if (kt >= 0) {
      const float* ck = ck_s + st * kT;
      const float c0 = cq_s[0];
      if (kt == 0 && nk > 0) {
        const float d = expf(c0);  // the carried-in sums times e^{cum_i0}
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4 * QC; ++e) acc[r][e] *= d;
      }
      if (kt < qt) {
        // x_j *= e^{cum_i0 - cum_j}: float4 tid % XF of rows tid / XF +
        // m kThreads / XF
#pragma unroll
        for (int m = 0; m < kT * XF / kThreads; ++m) {
          const int j = tid / XF + m * (kThreads / XF);
          float4* xv = reinterpret_cast<float4*>(xt + j * PW) + tid % XF;
          const float d = expf(c0 - ck[j]);
          float4 v = *xv;
          v.x *= d;
          v.y *= d;
          v.z *= d;
          v.w *= d;
          *xv = v;
        }
        jmax = kT;
      } else {
        if (qt > 0 || nk > 0) {
          // the sums so far times e^{cum_i - cum_i0}
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float u = expf(cq_s[rg * 4 + r] - c0);
#pragma unroll
            for (int e = 0; e < 4 * QC; ++e) acc[r][e] *= u;
          }
        }
        // S^T[j][i] of query rows i in [ib 32, ib 32 + 32), decayed and
        // masked in place
        const int j = tid % kT, ib = tid / kT;
        const float cj = ck[j];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int i = ib * 32 + 4 * m;
          float4* gv = reinterpret_cast<float4*>(gt + j * kGP + i);
          float4 v = *gv;
          v.x = (j <= i && i < rows_q) ? v.x * expf(cq_s[i] - cj) : 0.0f;
          v.y = (j <= i + 1 && i + 1 < rows_q)
                    ? v.y * expf(cq_s[i + 1] - cj) : 0.0f;
          v.z = (j <= i + 2 && i + 2 < rows_q)
                    ? v.z * expf(cq_s[i + 2] - cj) : 0.0f;
          v.w = (j <= i + 3 && i + 3 < rows_q)
                    ? v.w * expf(cq_s[i + 3] - cj) : 0.0f;
          *gv = v;
        }
        jmax = min(kT, row_end);
      }
      __syncthreads();
    }
    const float* gc = gt + rg * 4;
    const float* xc = xt + cg * 4;
#pragma unroll 4
    for (int j = 0; j < jmax; ++j) {
      const float4 sv = *reinterpret_cast<const float4*>(gc + j * kGP);
      const float s[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xc + j * PW + q * 32);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][4 * q + 0] = fmaf(s[r], xv.x, acc[r][4 * q + 0]);
          acc[r][4 * q + 1] = fmaf(s[r], xv.y, acc[r][4 * q + 1]);
          acc[r][4 * q + 2] = fmaf(s[r], xv.z, acc[r][4 * q + 2]);
          acc[r][4 * q + 3] = fmaf(s[r], xv.w, acc[r][4 * q + 3]);
        }
      }
    }
  }

  const int64_t y_row = static_cast<int64_t>(a.H) * a.p;
  float* yp = a.y + (static_cast<int64_t>(bi) * a.l +
                     static_cast<int64_t>(c) * a.L + i0) * y_row +
              static_cast<int64_t>(hh) * a.p;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = rg * 4 + r;
    if (i >= rows_q) continue;
    float* yrow = yp + i * y_row;
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      const int col = (cg + 8 * q) * 4;
      if (a.p % 4 == 0) {
        if (col < a.p)
          *reinterpret_cast<float4*>(yrow + col) =
              make_float4(acc[r][4 * q], acc[r][4 * q + 1],
                          acc[r][4 * q + 2], acc[r][4 * q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < a.p) yrow[col + e] = acc[r][4 * q + e];
      }
    }
  }
}

// opt both large kernels in to the device's largest dynamic shared
// memory and shared-memory carveout, so that the blocks their launch
// bounds count on fit an SM (the wrapper sizes each launch:
// ssd.py::smem_bytes); the attributes belong to a function on a device,
// so this is done once per device
template <int PW>
cudaError_t configure(int device) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const void* kernels[2] = {reinterpret_cast<const void*>(
                                &ssd_chunk_kernel<PW>),
                            reinterpret_cast<const void*>(
                                &ssd_output_kernel<PW>)};
  for (const void* k : kernels) {
    err = cudaFuncSetAttribute(k,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return err;
  }
  if (device >= 0 && device < kDevices) done[device] = true;
  return cudaSuccess;
}

// the three launches on one stream, with the wrapper's grids and dynamic
// shared memory (ssd.py::launch_plan)
template <int PW>
cudaError_t launch(const Args& a, const int* grid, int device,
                   cudaStream_t stream) {
  cudaError_t err = configure<PW>(device);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<PW><<<static_cast<unsigned>(grid[0]), kThreads,
                         static_cast<size_t>(grid[1]), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_pass_kernel<PW><<<dim3(static_cast<unsigned>(grid[2]),
                             static_cast<unsigned>(grid[3])),
                        kPassThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_output_kernel<PW><<<static_cast<unsigned>(grid[4]), kThreads,
                          static_cast<size_t>(grid[5]), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. All tensors float32 on `device`;
// `strides` holds, in elements, the (b, l, h) strides of x, the (b, l, h)
// strides of dlogA, and the (b, l) strides of B and of C (ten values; the
// last axis of x, B and C has stride 1). h0 is contiguous (b, h, p, n) or
// null (zeros); y (b, l, h, p) and h_last (b, h, p, n) are contiguous.
// The workspaces (ssd.py::launch_plan) are contiguous float32: cum
// (b, h, l), scores (b, l / L, ntri, 64, 64), C transposed (b, l / L,
// ceil(L / 64), n, 64) and states (b, l / L, h, n, pw), pw = 64 for
// p <= 64, else 128. l is a multiple of the chunk length
// L; p <= 128; n a multiple of 4 up to 128. vec: x, B and C have 16-byte
// aligned base addresses and row strides (else 0: 4-byte copies).
// grid: the launches as ssd.py::launch_plan gives them, ssd_chunk_kernel's
// blocks and dynamic shared memory in bytes, ssd_pass_kernel's grid (x,
// y), ssd_output_kernel's blocks and shared memory. The three launches go
// on `stream`.
// Returns the first cudaGetLastError() that is not cudaSuccess
// (cudaErrorInvalidValue for shapes out of range).
extern "C" int ssd_f32(const void* x, const void* dlogA, const void* B,
                       const void* C, const void* h0, void* y, void* h_last,
                       void* cum, void* scores, void* ct, void* states,
                       int b, int l,
                       int H, int p, int n, int L, int vec,
                       const long long* strides, const int* grid,
                       int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L < 1 || l % L != 0 || p < 1 || p > 128 || n < 4 || n > kN ||
      n % 4 != 0 || grid[0] < 1 || grid[2] < 1 || grid[3] < 1 || grid[4] < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.dA = static_cast<const float*>(dlogA);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.hl = static_cast<float*>(h_last);
  a.cum = static_cast<float*>(cum);
  a.g = static_cast<float*>(scores);
  a.ct = static_cast<float*>(ct);
  a.st = static_cast<float*>(states);
  a.b = b;
  a.l = l;
  a.L = L;
  a.H = H;
  a.p = p;
  a.n = n;
  a.nc = l / L;
  a.nt = (L + kT - 1) / kT;
  a.ntri = a.nt * (a.nt + 1) / 2;
  a.vec = vec;
  a.xb = strides[0];
  a.xl = strides[1];
  a.xh = strides[2];
  a.ab = strides[3];
  a.al = strides[4];
  a.ah = strides[5];
  a.bb = strides[6];
  a.bl = strides[7];
  a.cb = strides[8];
  a.cl = strides[9];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p <= 64) return static_cast<int>(launch<64>(a, grid, device, s));
  return static_cast<int>(launch<128>(a, grid, device, s));
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
