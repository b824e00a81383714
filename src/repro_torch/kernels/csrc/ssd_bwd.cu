// ssd_bwd: the backward of the Mamba2 chunked SSD scan (ssd.cu), for the
// training of every layer of the SSM family.
//
// The Pallas TPU kernel repro/kernels/ssd.py::ssd has no backward: `repro`
// differentiates its oracle (repro/models/ssm.py::ssd_ref). Given the
// forward's inputs, its workspaces `cum` (the prefix sums of dlogA within
// each chunk) and `states` (slot c the state h_in entering chunk c), and
// the gradients dy (of y) and dh_last (of h_last; null is zero), the
// kernels compute dx, d dlogA, dB, dC and dh0. Within chunk c of one
// (b, head), positions i, j < L, S_ij = C_i . B_j, Lam = cum_{L-1}, h_in
// the state entering the chunk and g the gradient of the state leaving it
// (dh_last for the last chunk, dh_in of the next one otherwise):
//   dh_in = sum_i e^{cum_i} dy_i C_i^T + e^{Lam} g
//   dx_j  = sum_{i>=j} S_ij e^{cum_i - cum_j} dy_i + e^{Lam - cum_j} g B_j
//   dC_i  = sum_heads [sum_{j<=i} W_ij B_j + e^{cum_i} v_i],  v_i = h_in^T dy_i
//   dB_j  = sum_heads [sum_{i>=j} W_ij C_i + e^{Lam - cum_j} w_j],  w_j = g^T x_j
// with W_ij = e^{cum_i - cum_j} (dy_i . x_j) for j <= i; and with
// M_ij = S_ij W_ij, dcum_i = sum_{j<i} M_ij - sum_{k>i} M_ki
// + e^{cum_i} C_i . v_i - e^{Lam - cum_i} B_i . w_i, and dcum_{L-1} also
// gains d Lam = sum_j e^{Lam - cum_j} B_j . w_j + e^{Lam} <g, h_in>;
// d dlogA_k = sum_{i>=k} dcum_i, a suffix sum within the chunk. Every
// decay is the exponential of a difference that is <= 0, or of a prefix
// sum itself, as in the forward: a 256-step chunk reaches cum ~ -200.
// fp32 throughout, IEEE fmaf (no tensor cores, no TF32); sums in a fixed
// order with no atomics, so a repeated call gives the same bits.
//
// What bounds it: operations. At the train shape of mamba2-370m (b 8,
// l 512, h 32, p 64, n 128, chunk 256, no h0, no dh_last) the least work
// is 9.01 GFLOP (ssd.py::backward_work): per head, dx's scores times dy
// and W's dy . x over the causal pairs (2.16 each), and one (L, p, n)
// product each for dx's state term, v, w and the chunk's dh_in term where
// a state enters or leaves (1.07 each); once per (b, chunk), since B and C
// are shared by the heads, the scores and the two W products of dB and
// dC (0.40). Against some 127 MB of inputs and outputs that is above the
// H100's fp32 ridge: 0.134 ms at 67 TFLOP/s.
//
// What the design does about it: four launches on one stream, the chunks
// and heads in parallel, the grids and shared memory of ssd.py::
// backward_plan:
//  1. ssd_bwd_chunk_kernel. Per (b, head, chunk) the chunk's own dh_in
//     term sum_i e^{cum_i} dy_i^T C_i, transposed, into `dst` (the
//     forward's state blocks with dy for x and C for B); per (b, chunk,
//     causal pair of 64-row tiles) the scores S, query rows by key
//     columns, into `sc`, once for every head, and B transposed by tile.
//  2. ssd_bwd_pass_kernel walks the chunks backward: slot c of `dst`
//     becomes g of chunk c, g <- e^{Lam} g + term; the last is dh0. Each
//     block's share of e^{Lam} <g, h_in> goes to `lam`.
//  3. ssd_bwd_main_kernel. Blocks of two kinds. Per (b, head, chunk, key
//     tile) dx: the forward's output blocks with the roles of query and
//     key swapped (state tiles of B^T and g^T first, then the query
//     tiles after this one with dy scaled by e^{cum_i - cum_jl}, jl the
//     tile's last row, then the sums times e^{cum_jl - cum_j} and the
//     diagonal tile decayed in place); then the tile's v and w, (64, p)
//     by (p, n) products, whose e^{cum} and e^{Lam - cum} multiples go to
//     `vs` and `ws` (b, l, h, n) for the head sums, and whose dots with C
//     and B to `sv` (dcum's state terms) and `lw` (d Lam's). Per (b,
//     chunk, causal tile pair, group of 8 heads) W summed over the
//     group's heads in order into `wp`, and per head the row and column
//     sums of M (the diagonal left out: it cancels) into `mp`.
//  4. ssd_bwd_final_kernel. Per (b, chunk, tile) dC (rows i: the groups'
//     W tiles summed in order, transposed, times B) and dB (rows j: W
//     times C), each then plus its head sum of `vs` or `ws`; the n-wide
//     products are taken once per (b, chunk), not per head. Per (b, head,
//     chunk) dcum from `sv`, `mp`, `lam` and `lw` in a fixed order, then
//     its suffix sum into d dlogA.
// Tiles arrive by cp.async (16-byte pieces where x, B, C and dy allow it,
// else 4-byte ones: the wrapper's `vec`), one or two stages deep. What
// still costs beyond the bound: every head's dx blocks read the same score
// tiles, the W blocks read dy and x once per tile pair, the head sums read
// `vs` and `ws` (134 MB at the train shape), and each launch's tail.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd.cuh"

namespace {

constexpr int kGroupHeads = 8;  // heads a W block sums (ssd.py::BWD_GROUP_HEADS)
constexpr int kSP = kT + 8;     // padded row of a W block's score tile

struct Args {
  const float* x;
  const float* B;
  const float* C;
  const float* dy;   // (b, l, H, p), contiguous
  const float* dhl;  // (b, H, p, n) or nullptr: zeros
  const float* cum;  // the forward's (b, H, l)
  const float* st;   // the forward's (b, nc, H, n, PW): slot c = h_in of c
  float* dx;         // (b, l, H, p)
  float* dA;         // (b, l, H)
  float* dB;         // (b, l, n)
  float* dC;         // (b, l, n)
  float* dh0;        // (b, H, p, n), or nullptr: not wanted
  float* dst;        // (b, nc, H, n, PW): dh_in terms, then g of chunk c
  float* sc;         // (b, nc, ntri, kT, kT): scores, query rows by keys
  float* bt;         // (b, nc, nt, n, kT): B transposed, by key tile
  float* lam;        // (b, H, nc, ny): pass 2's share of d Lam
  float* wp;         // (b, nc, G, ntri, kT, kT): W per head group
  float* mp;         // (b, nc, ntri, H, 2, kT): M's row and column sums
  float* vs;         // (b, l, H, n): e^{cum_i} v_i
  float* ws;         // (b, l, H, n): e^{Lam - cum_j} w_j
  float* sv;         // (b, H, l): dcum's state terms, then dcum
  float* lw;         // (b, H, nc, nt): the dx blocks' share of d Lam
  int b, l, L, H, p, n;
  int nc, nt, ntri;
  int G;        // head groups, ceil(H / kGroupHeads)
  int ny;       // pass 2's blocks per (b, head)
  int has_h0;   // the forward had an h0 (slot 0 of st holds it)
  int vec;      // x, B, C and dy copied in 16-byte pieces (1) or 4-byte (0)
  int64_t xb, xl, xh;  // strides of x, in elements (the p axis is 1)
  int64_t bb, bl;      // of B
  int64_t cb, cl;      // of C
};

// whether a state enters chunk c (h_in != 0), and whether one leaves it
// with a gradient (g != 0)
__device__ __forceinline__ bool has_h(const Args& a, int c) {
  return c > 0 || a.has_h0 != 0;
}
__device__ __forceinline__ bool has_g(const Args& a, int c) {
  return c < a.nc - 1 || a.dhl != nullptr;
}

// row stride of dy, in elements
__device__ __forceinline__ int64_t dy_row(const Args& a) {
  return static_cast<int64_t>(a.H) * a.p;
}

// ---- pass 1

// one (b, head, chunk): sum_i e^{cum_i} dy_i^T C_i, written transposed (n
// rows of PW) to dst: the forward's chunk_state with dy for x, C for B and
// e^{cum_i} for its decay. Each thread owns 8 columns of p by 4 NQ of n.
template <int PW>
__device__ __forceinline__ void chunk_dstate(const Args& a, int c, int bi,
                                             int hh, float* smem) {
  constexpr int PG = PW / 8;
  constexpr int NG = kThreads / PG;
  constexpr int NQ = kN / (4 * NG);
  constexpr int XF = PW / 4;
  float* c_s = smem;               // [2][kT][kN]
  float* y_s = c_s + 2 * kT * kN;  // [2][kT][PW]
  const int tid = threadIdx.x;
  const int pg = tid % PG, ng = tid / PG;
  const int L = a.L;
  const bool vec = a.vec != 0;
  const int64_t t0 = static_cast<int64_t>(c) * L;
  const int64_t yl = dy_row(a);
  const float* yp = a.dy + (bi * static_cast<int64_t>(a.l) + t0) * yl +
                    static_cast<int64_t>(hh) * a.p;
  const float* cp = a.C + bi * a.cb + t0 * a.cl;
  const float* cum = a.cum + (static_cast<int64_t>(bi) * a.H + hh) * a.l + t0;

  load_tile<kN>(c_s, kN, cp, a.cl, L, a.n, vec);
  load_tile<PW>(y_s, PW, yp, yl, L, a.p, vec);
  cp_async_commit();

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
      load_tile<kN>(c_s + (st ^ 1) * kT * kN, kN, cp + r1 * a.cl, a.cl,
                    L - r1, a.n, vec);
      load_tile<PW>(y_s + (st ^ 1) * kT * PW, PW, yp + r1 * yl, yl, L - r1,
                    a.p, vec);
      cp_async_commit();
    }
    const float* ct = c_s + st * kT * kN;
    float* yt = y_s + st * kT * PW;
    // dy_i *= e^{cum_i}
#pragma unroll
    for (int m = 0; m < kT * XF / kThreads; ++m) {
      const int j = tid / XF + m * (kThreads / XF);
      float4* yv = reinterpret_cast<float4*>(yt + j * PW) + tid % XF;
      const float d = j0 + j < L ? expf(cum[j0 + j]) : 0.0f;
      float4 v = *yv;
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
      *yv = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kT; ++j) {
      const float4 y0 = *reinterpret_cast<const float4*>(yt + j * PW +
                                                         pg * 4);
      const float4 y1 = *reinterpret_cast<const float4*>(yt + j * PW +
                                                         PW / 2 + pg * 4);
      const float ys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 cv = *reinterpret_cast<const float4*>(
            ct + j * kN + (ng + q * NG) * 4);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          acc[r][4 * q + 0] = fmaf(ys[r], cv.x, acc[r][4 * q + 0]);
          acc[r][4 * q + 1] = fmaf(ys[r], cv.y, acc[r][4 * q + 1]);
          acc[r][4 * q + 2] = fmaf(ys[r], cv.z, acc[r][4 * q + 2]);
          acc[r][4 * q + 3] = fmaf(ys[r], cv.w, acc[r][4 * q + 3]);
        }
      }
    }
  }

  float* out = a.dst + ((static_cast<int64_t>(bi) * a.nc + c) * a.H + hh) *
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
// query rows qt * kT + i and key rows kt * kT + j, shared by every head,
// written query rows by key columns; a diagonal pair also writes its B
// tile transposed, which pass 3 reads for dx's state term
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
    float* bt = a.bt + (static_cast<int64_t>(bc) * a.nt + kt) * a.n * kT;
    for (int i = threadIdx.x; i < a.n * kT; i += kThreads)
      bt[i] = b_s[(i % kT) * kCP + i / kT];
  }
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
  float* out = a.sc + (static_cast<int64_t>(bc) * a.ntri + tile) * kT * kT;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      out[(ty + 16 * r) * kT + tx + 8 * cc] = s[r][cc];
}

// pass 1. Blocks [0, b H nc): dh_in terms, block i taking chunk i / (b H)
// of (b, head) i % (b H) (none for chunk 0 when dh0 is not wanted); the
// b nc ntri blocks after them: scores, block j taking tile pair j % ntri
// of (b, chunk) j / ntri.
template <int PW>
__global__ void __launch_bounds__(kThreads, PW <= 64 ? 2 : 1)
    ssd_bwd_chunk_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bh = a.b * a.H;
  const int states = bh * a.nc;
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < states) {
    const int i = blk % bh, c = blk / bh;
    if (c == 0 && a.dh0 == nullptr) return;
    chunk_dstate<PW>(a, c, i / a.H, i % a.H, smem);
  } else {
    chunk_scores(a, blk - states, smem);
  }
}

// ---- pass 2

// grid (b H, ny): block (head, y) carries elements [y, y + 1) * kPassThreads
// kPassVals of one (b, head)'s transposed state gradient backward along
// the chunks, slot c of dst becoming g of chunk c (dh_last or zeros for
// the last); then dh0, (p, n) where the slots are (n, PW), through shared
// memory as the forward's pass does for h0 and h_last. Per chunk the
// block's share of e^{Lam} <g, h_in> is summed in a fixed order (lanes by
// xor shuffles, then the warps in turn) into lam.
template <int PW>
__global__ void __launch_bounds__(kPassThreads) ssd_bwd_pass_kernel(Args a) {
  constexpr int kVals = kPassThreads * kPassVals;
  constexpr int KR = kVals / PW;
  constexpr int kPassWarps = kPassThreads / 32;
  __shared__ float t_s[KR][PW + 1];
  __shared__ float red_s[kPassWarps];
  const int bi = blockIdx.x / a.H, hh = blockIdx.x % a.H;
  const int total = a.n * PW;
  const int k0 = blockIdx.y * KR;
  const int64_t head = static_cast<int64_t>(bi) * a.H + hh;
  const int e0 = blockIdx.y * kVals + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kVals; i += kPassThreads) {
    const int col = i / KR, k = k0 + i % KR;
    t_s[i % KR][col] = (a.dhl != nullptr && col < a.p && k < a.n)
                           ? a.dhl[(head * a.p + col) * a.n + k]
                           : 0.0f;
  }
  __syncthreads();
  float g[kPassVals];
#pragma unroll
  for (int q = 0; q < kPassVals; ++q) {
    const int e = q * kPassThreads + threadIdx.x;
    g[q] = t_s[e / PW][e % PW];
  }
  const float* cum_last = a.cum + head * a.l + a.L - 1;
  for (int c = a.nc - 1; c >= 0; --c) {
    const int64_t off = ((static_cast<int64_t>(bi) * a.nc + c) * a.H + hh) *
                        total;
    float* ds = a.dst + off;
    const float* hs = a.st + off;
    const bool term = c > 0 || a.dh0 != nullptr;
    const float dec = expf(cum_last[static_cast<int64_t>(c) * a.L]);
    float v[kPassVals], hin[kPassVals];
#pragma unroll
    for (int q = 0; q < kPassVals; ++q) {
      const int e = e0 + q * kPassThreads;
      v[q] = (term && e < total) ? ds[e] : 0.0f;
      hin[q] = e < total ? hs[e] : 0.0f;
    }
    float part = 0.0f;
#pragma unroll
    for (int q = 0; q < kPassVals; ++q) {
      const int e = e0 + q * kPassThreads;
      part = fmaf(g[q], hin[q], part);
      if (e < total) ds[e] = g[q];
      g[q] = fmaf(dec, g[q], v[q]);
    }
#pragma unroll
    for (int off2 = 16; off2 > 0; off2 >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off2);
    if (lane == 0) red_s[warp] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kPassWarps; ++w) s += red_s[w];
      a.lam[(head * a.nc + c) * a.ny + blockIdx.y] = dec * s;
    }
    __syncthreads();  // red_s is rewritten for the next chunk
  }
  if (a.dh0 == nullptr) return;
#pragma unroll
  for (int q = 0; q < kPassVals; ++q) {
    const int e = q * kPassThreads + threadIdx.x;
    t_s[e / PW][e % PW] = g[q];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kVals; i += kPassThreads) {
    const int col = i / KR, k = k0 + i % KR;
    if (col < a.p && k < a.n)
      a.dh0[(head * a.p + col) * a.n + k] = t_s[i % KR][col];
  }
}

// ---- pass 3

// the shared memory a dx block carves out: its two-stage ring, the key
// and query prefix sums, and, after the ring, its v and w tiles; then 64
// floats for the per-row shares of d Lam
template <int PW>
__host__ __device__ constexpr int dx_red_offset() {
  return 2 * kT * kGP + 2 * kT * PW + 3 * kT > (kT + kN) * (PW + 4)
             ? 2 * kT * kGP + 2 * kT * PW + 3 * kT
             : (kT + kN) * (PW + 4);
}

// one (b, head, chunk, key tile jt): dx_j for the tile's rows, the mirror
// of the forward's output block. It walks a sequence of 64-row tiles
// through one two-stage ring, each a (64, 64) matrix A, k-major, and a
// (64, PW) matrix X, whose product it adds into the rows' sums: first,
// where a gradient leaves the chunk, the state term e^{Lam - cum_j} g B_j
// as ceil(n / 64) tiles of B^T and g^T (rows of n), the sums then scaled
// by e^{Lam - cum_jl} (jl the tile's last row); then the query tiles
// nt - 1 .. jt + 1, scores S[i][j] and dy rows scaled by e^{cum_i -
// cum_jl} in shared memory (both exponents <= 0, 0 past L); then the sums
// times e^{cum_jl - cum_j}, and the diagonal tile, decayed and masked in
// place (each warp's rows j start at its first, so its keys before it are
// skipped). Each thread owns 4 rows (rg * 4 + r) by PW / 8 columns.
// Then the tile's v_j = h_in^T dy_j and w_j = g^T x_j, (64, p) by (p, n)
// products with both operands row-major (rows padded to PW + 4 floats),
// in two halves of 64 columns of n, each thread 4 rows (ty + 16 r) by 8
// columns (tx + 8 cc) of a half.
template <int PW>
__device__ __forceinline__ void dx_block(const Args& a, int blk,
                                         float* smem) {
  constexpr int QC = PW / 32;
  constexpr int XF = PW / 4;
  constexpr int FP = PW + 4;
  float* g_s = smem;               // [2][kT][kGP]: A, k-major
  float* x_s = g_s + 2 * kT * kGP;  // [2][kT][PW]: X
  float* cq_s = x_s + 2 * kT * PW;  // [kT]: cum of the key rows j
  float* ck_s = cq_s + kT;          // [2][kT]: cum of each tile's rows
  float* red_s = smem + dx_red_offset<PW>();  // [kT]

  const int bh = a.b * a.H;
  const int per_tile = bh * a.nc;
  const int jt = blk / per_tile;  // key tile 0, the heaviest, first
  const int rest = blk % per_tile;
  const int c = rest / bh;
  const int bi = (rest % bh) / a.H, hh = (rest % bh) % a.H;
  const int tid = threadIdx.x;
  const int cg = tid % 8, rg = tid / 8;
  const int j0 = jt * kT;
  const int rows_j = min(kT, a.L - j0);
  const bool vec = a.vec != 0;
  const bool with_g = has_g(a, c);
  const int nk = with_g ? (a.n + kT - 1) / kT : 0;
  const int nq = a.nt - 1 - jt;  // query tiles after this one
  const int tiles = nk + nq + 1;
  const int64_t bc = static_cast<int64_t>(bi) * a.nc + c;
  const int64_t head = static_cast<int64_t>(bi) * a.H + hh;
  const int64_t c0 = static_cast<int64_t>(c) * a.L;  // the chunk's first row
  const float* cumc = a.cum + head * a.l + c0;
  const int64_t yl = dy_row(a);
  const float* dyc = a.dy + (bi * static_cast<int64_t>(a.l) + c0) * yl +
                     static_cast<int64_t>(hh) * a.p;
  const float* slot_g = a.dst + (bc * a.H + hh) * a.n * PW;
  const float* slot_h = a.st + (bc * a.H + hh) * a.n * PW;

  auto load = [&](int t, int st) {
    float* gd = g_s + st * kT * kGP;
    float* xd = x_s + st * kT * PW;
    if (t < nk) {  // the workspaces' rows are 16-byte aligned
      const int k0 = t * kT;
      load_tile<kT>(gd, kGP, a.bt + ((bc * a.nt + jt) * a.n + k0) * kT, kT,
                    a.n - k0, kT, true);
      load_tile<PW>(xd, PW, slot_g + k0 * PW, PW, a.n - k0, PW, true);
    } else {
      const int it = t < nk + nq ? a.nt - 1 - (t - nk) : jt;
      const int i0 = it * kT;
      load_tile<kT>(gd, kGP,
                    a.sc + (bc * a.ntri + it * (it + 1) / 2 + jt) * kT * kT,
                    kT, kT, kT, true);
      load_tile<PW>(xd, PW, dyc + i0 * yl, yl, a.L - i0, a.p, vec);
      if (tid < kT) {
        const bool in = i0 + tid < a.L;
        cp_async4(ck_s + st * kT + tid, in ? cumc + i0 + tid : cumc, in);
      }
    }
    cp_async_commit();
  };
  if (tid < kT) cq_s[tid] = tid < rows_j ? cumc[j0 + tid] : 0.0f;
  load(0, 0);
  const float lam = cumc[a.L - 1];

  float acc[4][4 * QC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4 * QC; ++e) acc[r][e] = 0.0f;
  // this warp's 16 rows j begin at row_begin: on the diagonal tile no
  // query row before it sees them
  const int row_begin = (tid / 32) * 16;

  for (int t = 0; t < tiles; ++t) {
    const int st = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; stage st ^ 1 is free
    if (t + 1 < tiles) load(t + 1, st ^ 1);
    float* gt = g_s + st * kT * kGP;
    float* xt = x_s + st * kT * PW;
    int kmin = 0;
    int kmax = min(kT, a.n - t * kT);  // a state tile: n rows
    if (t >= nk) {
      const float* ck = ck_s + st * kT;
      const float cl = cq_s[rows_j - 1];  // cum of the tile's last row
      if (t == nk && nk > 0) {
        const float d = expf(lam - cl);  // the state sums times e^{Lam - cl}
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4 * QC; ++e) acc[r][e] *= d;
      }
      if (t < nk + nq) {
        const int i0 = (a.nt - 1 - (t - nk)) * kT;
        // dy_i *= e^{cum_i - cl}: float4 tid % XF of rows tid / XF + m
        // kThreads / XF; rows past L are zeros
#pragma unroll
        for (int m = 0; m < kT * XF / kThreads; ++m) {
          const int i = tid / XF + m * (kThreads / XF);
          float4* xv = reinterpret_cast<float4*>(xt + i * PW) + tid % XF;
          const float d = i0 + i < a.L ? expf(ck[i] - cl) : 0.0f;
          float4 v = *xv;
          v.x *= d;
          v.y *= d;
          v.z *= d;
          v.w *= d;
          *xv = v;
        }
        kmax = kT;
      } else {
        if (nk > 0 || nq > 0) {
          // the sums so far times e^{cl - cum_j}
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float u = expf(cl - cq_s[rg * 4 + r]);
#pragma unroll
            for (int e = 0; e < 4 * QC; ++e) acc[r][e] *= u;
          }
        }
        // S[i][j] of key columns j in [jb 32, jb 32 + 32), decayed and
        // masked in place
        const int i = tid % kT, jb = tid / kT;
        const float ci = ck[i];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int j = jb * 32 + 4 * m;
          float4* gv = reinterpret_cast<float4*>(gt + i * kGP + j);
          float4 v = *gv;
          const bool row = i < rows_j;
          v.x = (row && j <= i) ? v.x * expf(ci - cq_s[j]) : 0.0f;
          v.y = (row && j + 1 <= i) ? v.y * expf(ci - cq_s[j + 1]) : 0.0f;
          v.z = (row && j + 2 <= i) ? v.z * expf(ci - cq_s[j + 2]) : 0.0f;
          v.w = (row && j + 3 <= i) ? v.w * expf(ci - cq_s[j + 3]) : 0.0f;
          *gv = v;
        }
        kmin = row_begin;
        kmax = kT;
      }
      __syncthreads();
    }
    const float* gc = gt + rg * 4;
    const float* xc = xt + cg * 4;
#pragma unroll 4
    for (int k = kmin; k < kmax; ++k) {
      const float4 sv = *reinterpret_cast<const float4*>(gc + k * kGP);
      const float s[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xc + k * PW + q * 32);
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

  const int64_t row_el = static_cast<int64_t>(a.H) * a.p;
  float* dxp = a.dx + (bi * static_cast<int64_t>(a.l) + c0 + j0) * row_el +
               static_cast<int64_t>(hh) * a.p;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = rg * 4 + r;
    if (j >= rows_j) continue;
    float* drow = dxp + j * row_el;
#pragma unroll
    for (int q = 0; q < QC; ++q) {
      const int col = (cg + 8 * q) * 4;
      if (a.p % 4 == 0) {
        if (col < a.p)
          *reinterpret_cast<float4*>(drow + col) =
              make_float4(acc[r][4 * q], acc[r][4 * q + 1],
                          acc[r][4 * q + 2], acc[r][4 * q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < a.p) drow[col + e] = acc[r][4 * q + e];
      }
    }
  }

  // v_j = h_in^T dy_j (phase 0) and w_j = g^T x_j (phase 1) of the tile's
  // rows: rows j = ty + 16 r, columns k = tx + 8 cc of n
  const int tx = tid % 8, ty = tid / 8;
  float* a_s = smem;           // [kT][FP]: dy or x rows
  float* m_s = a_s + kT * FP;  // [kN][FP]: h_in^T or g^T, rows of n
  float sv_r[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // dcum's state terms
  float lw_r[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // d Lam's share
  for (int phase = 0; phase < 2; ++phase) {
    if (phase == 0 ? !has_h(a, c) : !with_g) continue;
    __syncthreads();  // the ring (or the last phase's tiles) is done
    if (phase == 0)
      load_tile<PW>(a_s, FP, dyc + j0 * yl, yl, rows_j, a.p, vec);
    else
      load_tile<PW>(a_s, FP,
                    a.x + bi * a.xb + hh * a.xh + (c0 + j0) * a.xl, a.xl,
                    rows_j, a.p, vec);
    const float* slot = phase == 0 ? slot_h : slot_g;
    load_tile<PW>(m_s, FP, slot, PW, a.n, PW, true);
    if (a.n > kT)
      load_tile<PW>(m_s + kT * FP, FP, slot + kT * PW, PW, a.n - kT, PW, true);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    // the n columns in two halves of 64, each thread 8 columns a half
    float dots[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float* out = phase == 0 ? a.vs : a.ws;
    for (int half = 0; half < 2; ++half) {
      const int col0 = half * 64;
      if (col0 >= a.n) break;
      float f[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) f[r][cc] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < PW; k += 4) {
        float4 av[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          av[r] = *reinterpret_cast<const float4*>(a_s + (ty + 16 * r) * FP +
                                                   k);
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const float4 bv = *reinterpret_cast<const float4*>(
              m_s + (col0 + tx + 8 * cc) * FP + k);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float t = f[r][cc];
            t = fmaf(av[r].x, bv.x, t);
            t = fmaf(av[r].y, bv.y, t);
            t = fmaf(av[r].z, bv.z, t);
            f[r][cc] = fmaf(av[r].w, bv.w, t);
          }
        }
      }
      // e^{cum_j} v_j into vs (phase 0), e^{Lam - cum_j} w_j into ws
      // (phase 1); the dots with C_j or B_j summed over the columns
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty + 16 * r;
        if (j >= rows_j) continue;
        const float cj = cumc[j0 + j];
        const float scale = phase == 0 ? expf(cj) : expf(lam - cj);
        const int64_t row = bi * static_cast<int64_t>(a.l) + c0 + j0 + j;
        const float* vrow = phase == 0
                                ? a.C + bi * a.cb + (c0 + j0 + j) * a.cl
                                : a.B + bi * a.bb + (c0 + j0 + j) * a.bl;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const int col = col0 + tx + 8 * cc;
          if (col < a.n) {
            dots[r] = fmaf(f[r][cc], vrow[col], dots[r]);
            out[(row * a.H + hh) * a.n + col] = scale * f[r][cc];
          }
        }
      }
    }
    // e^{cum_j} C_j . v_j into dcum_j (phase 0); e^{Lam - cum_j} B_j . w_j
    // out of dcum_j and into d Lam (phase 1)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      const bool in = j < rows_j;
      const float cj = in ? cumc[j0 + j] : 0.0f;
      const float scale = in ? (phase == 0 ? expf(cj) : expf(lam - cj))
                             : 0.0f;
      float dot = dots[r];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      const float term = scale * dot;
      if (phase == 0) {
        sv_r[r] += term;
      } else {
        sv_r[r] -= term;
        lw_r[r] = term;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = ty + 16 * r;
      if (j < rows_j) a.sv[head * a.l + c0 + j0 + j] = sv_r[r];
      red_s[j] = j < rows_j ? lw_r[r] : 0.0f;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int j = 0; j < kT; ++j) s += red_s[j];
    a.lw[(head * a.nc + c) * a.nt + jt] = s;
  }
}

// one (b, chunk, causal tile pair it >= jt, group of kGroupHeads heads):
// per head the (64, 64) products dy_i . x_j of the pair (both operands
// row-major, rows padded to PW + 4 floats), decayed by e^{cum_i - cum_j}
// and masked (j <= i, rows before L), added over the group's heads in
// order into W; and per head the row and column sums of M = S W, the
// diagonal left out, into mp (rows: over the tx lanes by xor shuffles;
// columns: over each warp's rows by xor shuffles, then the warps in turn).
template <int PW>
__device__ __forceinline__ void w_block(const Args& a, int blk,
                                        float* smem) {
  constexpr int FP = PW + 4;
  float* q_s = smem;             // [kT][FP]: dy rows of the query tile
  float* k_s = q_s + kT * FP;    // [kT][FP]: x rows of the key tile
  float* s_s = k_s + kT * FP;    // [kT][kSP]: the pair's scores
  float* ci_s = s_s + kT * kSP;  // [kT]
  float* cj_s = ci_s + kT;       // [kT]
  float* red_s = cj_s + kT;      // [kWarps][kT]
  const int tile = blk % a.ntri;
  const int rest = blk / a.ntri;
  const int grp = rest % a.G;
  const int bc = rest / a.G;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= tile) ++it;
  const int jt = tile - it * (it + 1) / 2;
  const int i0 = it * kT, j0 = jt * kT;
  const int rows_i = min(kT, a.L - i0), rows_j = min(kT, a.L - j0);
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int lane = tid & 31, warp = tid >> 5;
  const bool vec = a.vec != 0;
  const int64_t c0 = static_cast<int64_t>(c) * a.L;
  const int64_t yl = dy_row(a);

  const float* sct = a.sc + (static_cast<int64_t>(bc) * a.ntri + tile) * kT *
                                kT;
  for (int e = tid; e < kT * kT / 4; e += kThreads) {
    const int i = e / (kT / 4), j = (e % (kT / 4)) * 4;
    *reinterpret_cast<float4*>(s_s + i * kSP + j) =
        *reinterpret_cast<const float4*>(sct + i * kT + j);
  }
  float wacc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) wacc[r][cc] = 0.0f;
  const int h_end = min(a.H, (grp + 1) * kGroupHeads);
  for (int h = grp * kGroupHeads; h < h_end; ++h) {
    __syncthreads();  // the last head is done with the tiles and red_s
    load_tile<PW>(q_s, FP,
                  a.dy + (bi * static_cast<int64_t>(a.l) + c0 + i0) * yl +
                      static_cast<int64_t>(h) * a.p,
                  yl, rows_i, a.p, vec);
    load_tile<PW>(k_s, FP, a.x + bi * a.xb + h * a.xh + (c0 + j0) * a.xl,
                  a.xl, rows_j, a.p, vec);
    cp_async_commit();
    const float* cum = a.cum + (static_cast<int64_t>(bi) * a.H + h) * a.l +
                       c0;
    if (tid < kT) {
      ci_s[tid] = tid < rows_i ? cum[i0 + tid] : 0.0f;
      cj_s[tid] = tid < rows_j ? cum[j0 + tid] : 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();
    float pr[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) pr[r][cc] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < PW; k += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * r) * FP + k);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        kv[cc] = *reinterpret_cast<const float4*>(k_s + (tx + 8 * cc) * FP + k);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          float t = pr[r][cc];
          t = fmaf(qv[r].x, kv[cc].x, t);
          t = fmaf(qv[r].y, kv[cc].y, t);
          t = fmaf(qv[r].z, kv[cc].z, t);
          pr[r][cc] = fmaf(qv[r].w, kv[cc].w, t);
        }
    }
    float rs[4], cs[8];
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) cs[cc] = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const float ci = ci_s[i];
      rs[r] = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int j = tx + 8 * cc;
        const bool in = i < rows_i && j < rows_j && (it > jt || j <= i);
        const float w = in ? pr[r][cc] * expf(ci - cj_s[j]) : 0.0f;
        wacc[r][cc] += w;
        const float m =
            (it > jt || j < i) ? s_s[i * kSP + j] * w : 0.0f;
        rs[r] += m;
        cs[cc] += m;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 4);
    }
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      cs[cc] += __shfl_xor_sync(0xffffffffu, cs[cc], 8);
      cs[cc] += __shfl_xor_sync(0xffffffffu, cs[cc], 16);
    }
    float* mp = a.mp + ((static_cast<int64_t>(bc) * a.ntri + tile) * a.H + h) *
                           2 * kT;
    if (tx == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) mp[ty + 16 * r] = rs[r];
    }
    if (lane < 8) {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) red_s[warp * kT + tx + 8 * cc] = cs[cc];
    }
    __syncthreads();
    if (tid < kT) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red_s[w * kT + tid];
      mp[kT + tid] = v;
    }
  }
  float* out = a.wp + ((static_cast<int64_t>(bc) * a.G + grp) * a.ntri +
                       tile) * kT * kT;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      out[(ty + 16 * r) * kT + tx + 8 * cc] = wacc[r][cc];
}

// pass 3. Blocks [0, b H nc nt): dx, block i taking key tile i / (b H nc)
// (tile 0, the heaviest, first) of chunk (i % (b H nc)) / (b H) of
// (b, head) i % (b H); the b nc ntri G blocks after them: W, block j
// taking tile pair j % ntri of group (j / ntri) % G of (b, chunk)
// j / (ntri G).
template <int PW>
__global__ void __launch_bounds__(kThreads, PW <= 64 ? 2 : 1)
    ssd_bwd_main_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dx_blocks = a.b * a.H * a.nc * a.nt;
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < dx_blocks)
    dx_block<PW>(a, blk, smem);
  else
    w_block<PW>(a, blk - dx_blocks, smem);
}

// ---- pass 4

// one (b, chunk, tile t) of dC (which 0: rows i of query tile t, the
// groups' W tiles (t, u), u <= t, summed in order and transposed in
// shared memory, times B's rows of tile u) or of dB (which 1: rows j of
// key tile t, W tiles (u, t), u >= t, times C's rows of tile u); then its
// head sum of vs (dC, where a state enters the chunk) or ws (dB, where a
// gradient leaves it), heads in order. Each thread owns 4 rows (rg * 4 +
// r) by 4 float4s of n ((cg + 8 q) * 4).
__device__ __forceinline__ void bc_block(const Args& a, int blk,
                                         float* smem) {
  float* w_s = smem;           // [kT][kGP]: W, k-major
  float* m_s = w_s + kT * kGP;  // [kT][kN]: B or C rows
  const int which = blk & 1;
  const int rest = blk >> 1;
  const int t = rest % a.nt;
  const int bc = rest / a.nt;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const int tid = threadIdx.x;
  const int cg = tid % 8, rg = tid / 8;
  const int t0 = t * kT;
  const int rows = min(kT, a.L - t0);
  const bool vec = a.vec != 0;
  const int64_t c0 = static_cast<int64_t>(c) * a.L;
  const int64_t gstride = static_cast<int64_t>(a.ntri) * kT * kT;
  const float* wbase = a.wp + static_cast<int64_t>(bc) * a.G * gstride;

  float acc[4][16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[r][e] = 0.0f;
  const int u_lo = which == 0 ? 0 : t;
  const int u_hi = which == 0 ? t : a.nt - 1;
  for (int u = u_lo; u <= u_hi; ++u) {
    const int pair = which == 0 ? t * (t + 1) / 2 + u : u * (u + 1) / 2 + t;
    __syncthreads();  // the last tile is done
    if (which == 0)
      load_tile<kN>(m_s, kN, a.B + bi * a.bb + (c0 + u * kT) * a.bl, a.bl,
                    a.L - u * kT, a.n, vec);
    else
      load_tile<kN>(m_s, kN, a.C + bi * a.cb + (c0 + u * kT) * a.cl, a.cl,
                    a.L - u * kT, a.n, vec);
    cp_async_commit();
    const float* wt = wbase + static_cast<int64_t>(pair) * kT * kT;
    for (int e = tid; e < kT * kT / 4; e += kThreads) {
      const int i = e / (kT / 4), j = (e % (kT / 4)) * 4;
      float4 v = *reinterpret_cast<const float4*>(wt + i * kT + j);
      for (int g = 1; g < a.G; ++g) {
        const float4 o =
            *reinterpret_cast<const float4*>(wt + g * gstride + i * kT + j);
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      if (which == 0) {  // k = j: transposed
        w_s[(j + 0) * kGP + i] = v.x;
        w_s[(j + 1) * kGP + i] = v.y;
        w_s[(j + 2) * kGP + i] = v.z;
        w_s[(j + 3) * kGP + i] = v.w;
      } else {  // k = i
        *reinterpret_cast<float4*>(w_s + i * kGP + j) = v;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const float* wc = w_s + rg * 4;
    const float* mc = m_s + cg * 4;
#pragma unroll 4
    for (int k = 0; k < kT; ++k) {
      const float4 sv = *reinterpret_cast<const float4*>(wc + k * kGP);
      const float s[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 mv =
            *reinterpret_cast<const float4*>(mc + k * kN + q * 32);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][4 * q + 0] = fmaf(s[r], mv.x, acc[r][4 * q + 0]);
          acc[r][4 * q + 1] = fmaf(s[r], mv.y, acc[r][4 * q + 1]);
          acc[r][4 * q + 2] = fmaf(s[r], mv.z, acc[r][4 * q + 2]);
          acc[r][4 * q + 3] = fmaf(s[r], mv.w, acc[r][4 * q + 3]);
        }
      }
    }
  }
  const bool heads = which == 0 ? has_h(a, c) : has_g(a, c);
  const float* hsum = which == 0 ? a.vs : a.ws;
  float* out = which == 0 ? a.dC : a.dB;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = rg * 4 + r;
    if (i >= rows) continue;
    const int64_t row = bi * static_cast<int64_t>(a.l) + c0 + t0 + i;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = (cg + 8 * q) * 4;
      if (col >= a.n) continue;
      float4 o = make_float4(acc[r][4 * q], acc[r][4 * q + 1],
                             acc[r][4 * q + 2], acc[r][4 * q + 3]);
      if (heads) {
        for (int h = 0; h < a.H; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              hsum + (row * a.H + h) * a.n + col);
          o.x += v.x;
          o.y += v.y;
          o.z += v.z;
          o.w += v.w;
        }
      }
      *reinterpret_cast<float4*>(out + row * a.n + col) = o;
    }
  }
}

// one (b, head, chunk): dcum_i = sv_i (the state terms) + M's row sums of
// the pairs (tile(i), jt <= tile(i)) - its column sums of the pairs
// (it >= tile(i), tile(i)), and for the last row d Lam (lam's ny shares,
// then lw's nt), in this order; written over sv, then suffix-summed within
// the chunk into d dlogA (segments of kThreads steps from the chunk's
// end, a shuffle scan in each warp, the warps' totals added in order).
__device__ __forceinline__ void dlogA_block(const Args& a, int blk,
                                            float* smem) {
  float* warp_s = smem;  // [kWarps]
  const int bh = a.b * a.H;
  const int c = blk / bh;
  const int bi = (blk % bh) / a.H, hh = (blk % bh) % a.H;
  const int64_t head = static_cast<int64_t>(bi) * a.H + hh;
  const int64_t bc = static_cast<int64_t>(bi) * a.nc + c;
  const int64_t c0 = static_cast<int64_t>(c) * a.L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* dc = a.sv + head * a.l + c0;
  float dlam = 0.0f;
  for (int y = 0; y < a.ny; ++y) dlam += a.lam[(head * a.nc + c) * a.ny + y];
  for (int t = 0; t < a.nt; ++t) dlam += a.lw[(head * a.nc + c) * a.nt + t];
  for (int i = threadIdx.x; i < a.L; i += kThreads) {
    const int t = i / kT, r = i % kT;
    float v = dc[i];
    for (int jt = 0; jt <= t; ++jt)
      v += a.mp[((bc * a.ntri + t * (t + 1) / 2 + jt) * a.H + hh) * 2 * kT +
                r];
    for (int it = t; it < a.nt; ++it)
      v -= a.mp[((bc * a.ntri + it * (it + 1) / 2 + t) * a.H + hh) * 2 * kT +
                kT + r];
    if (i == a.L - 1) v += dlam;
    dc[i] = v;
  }
  __syncthreads();
  float carry = 0.0f;
  for (int s0 = 0; s0 < a.L; s0 += kThreads) {
    const int k = a.L - 1 - (s0 + static_cast<int>(threadIdx.x));
    float v = k >= 0 ? dc[k] : 0.0f;
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
    if (k >= 0) a.dA[((bi * static_cast<int64_t>(a.l)) + c0 + k) * a.H + hh] = v;
    carry = total;
    __syncthreads();  // warp_s is rewritten by the next segment
  }
}

// pass 4. Blocks [0, 2 b nc nt): dC and dB, block i taking tile
// (i / 2) % nt of (b, chunk) i / (2 nt), dC for even i; the b H nc blocks
// after them: d dlogA, block j taking chunk j / (b H) of (b, head)
// j % (b H).
__global__ void __launch_bounds__(kThreads) ssd_bwd_final_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bc_blocks = 2 * a.b * a.nc * a.nt;
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < bc_blocks)
    bc_block(a, blk, smem);
  else
    dlogA_block(a, blk - bc_blocks, smem);
}

// opt the three large kernels in to the device's largest dynamic shared
// memory and carveout (the wrapper sizes each launch: ssd.py::
// backward_plan), once per device
template <int PW>
cudaError_t configure(int device) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const void* kernels[3] = {
      reinterpret_cast<const void*>(&ssd_bwd_chunk_kernel<PW>),
      reinterpret_cast<const void*>(&ssd_bwd_main_kernel<PW>),
      reinterpret_cast<const void*>(&ssd_bwd_final_kernel)};
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

// the four launches on one stream, with the wrapper's grids and dynamic
// shared memory (ssd.py::backward_plan)
template <int PW>
cudaError_t launch(const Args& a, const int* grid, int device,
                   cudaStream_t stream) {
  cudaError_t err = configure<PW>(device);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_kernel<PW><<<static_cast<unsigned>(grid[0]), kThreads,
                             static_cast<size_t>(grid[1]), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_pass_kernel<PW><<<dim3(static_cast<unsigned>(grid[2]),
                                 static_cast<unsigned>(grid[3])),
                            kPassThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_main_kernel<PW><<<static_cast<unsigned>(grid[4]), kThreads,
                            static_cast<size_t>(grid[5]), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_final_kernel<<<static_cast<unsigned>(grid[6]), kThreads,
                         static_cast<size_t>(grid[7]), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. All tensors float32 on `device`. x,
// B and C as the forward read them, through `strides` (in elements: the
// (b, l, h) strides of x, then the (b, l) strides of B and of C; seven
// values); dy (b, l, h, p) contiguous; dh_last (b, h, p, n) contiguous or
// null (zeros); cum and states the forward's workspaces (ssd.py::
// launch_plan), the states after its pass (slot c the state entering
// chunk c). Outputs, contiguous: dx (b, l, h, p), d dlogA (b, l, h), dB
// and dC (b, l, n), dh0 (b, h, p, n) or null (not wanted). The ten
// workspaces as ssd.py::backward_plan shapes them, in its order (dst, sc,
// bt, lam, wp, mp, vs, ws, sv, lw). has_h0: the forward had an h0. vec:
// x, B, C and dy have 16-byte aligned base addresses and row strides.
// grid: ssd.py::backward_plan's launch values, each kernel's blocks (the
// pass's as x, y) and dynamic shared memory in bytes. Returns the first
// cudaGetLastError() that is not cudaSuccess (cudaErrorInvalidValue for
// shapes or a plan out of range).
extern "C" int ssd_bwd_f32(const void* x, const void* B, const void* C,
                           const void* dy, const void* dh_last,
                           const void* cum, const void* states, void* dx,
                           void* ddlogA, void* dB, void* dC, void* dh0,
                           void* const* work, int b, int l, int H, int p,
                           int n, int L, int groups, int has_h0, int vec,
                           const long long* strides, const int* grid,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = (L + kT - 1) / kT;
  const int pw = p <= 64 ? 64 : 128;
  const int ny = (n * pw + kPassThreads * kPassVals - 1) /
                 (kPassThreads * kPassVals);
  if (L < 1 || l % L != 0 || p < 1 || p > 128 || n < 4 || n > kN ||
      n % 4 != 0 || groups != (H + kGroupHeads - 1) / kGroupHeads ||
      grid[2] != b * H || grid[3] != ny ||
      grid[0] != b * H * (l / L) + b * (l / L) * nt * (nt + 1) / 2 ||
      grid[4] != b * H * (l / L) * nt +
                     b * (l / L) * nt * (nt + 1) / 2 * groups ||
      grid[6] != 2 * b * (l / L) * nt + b * H * (l / L))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.dy = static_cast<const float*>(dy);
  a.dhl = static_cast<const float*>(dh_last);
  a.cum = static_cast<const float*>(cum);
  a.st = static_cast<const float*>(states);
  a.dx = static_cast<float*>(dx);
  a.dA = static_cast<float*>(ddlogA);
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.dh0 = static_cast<float*>(dh0);
  a.dst = static_cast<float*>(work[0]);
  a.sc = static_cast<float*>(work[1]);
  a.bt = static_cast<float*>(work[2]);
  a.lam = static_cast<float*>(work[3]);
  a.wp = static_cast<float*>(work[4]);
  a.mp = static_cast<float*>(work[5]);
  a.vs = static_cast<float*>(work[6]);
  a.ws = static_cast<float*>(work[7]);
  a.sv = static_cast<float*>(work[8]);
  a.lw = static_cast<float*>(work[9]);
  a.b = b;
  a.l = l;
  a.L = L;
  a.H = H;
  a.p = p;
  a.n = n;
  a.nc = l / L;
  a.nt = nt;
  a.ntri = nt * (nt + 1) / 2;
  a.G = groups;
  a.ny = ny;
  a.has_h0 = has_h0;
  a.vec = vec;
  a.xb = strides[0];
  a.xl = strides[1];
  a.xh = strides[2];
  a.bb = strides[3];
  a.bl = strides[4];
  a.cb = strides[5];
  a.cl = strides[6];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p <= 64) return static_cast<int>(launch<64>(a, grid, device, s));
  return static_cast<int>(launch<128>(a, grid, device, s));
}

extern "C" const char* ssd_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
