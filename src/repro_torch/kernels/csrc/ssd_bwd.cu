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
// is 9.01 GFLOP (ssd.py::backward_flops): per head, dx's scores times dy
// and W's dy . x over the causal pairs (2.16 each), and one (L, p, n)
// product each for dx's state term, v, w and the chunk's dh_in term where
// a state enters or leaves (1.07 each); once per (b, chunk), since B and C
// are shared by the heads, the scores and the two W products of dB and
// dC (0.40). Against some 127 MB of inputs and outputs that is above the
// H100's fp32 ridge: 0.134 ms at 67 TFLOP/s.
//
// What the design does about it: six launches on one stream, the chunks
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
//  3. Three kernels of 256 threads, at most 128 registers a thread at
//     p <= 64 so that two blocks (16 warps) share an SM; each block kind
//     is its own kernel, since in one kernel their registers' union
//     spilled. Each walks its heads two stages deep (cp.async), one or
//     two barriers a head:
//     - ssd_bwd_state_kernel, per (b, chunk, 64-row tile, group of 8
//       heads, 64 columns of n) and kind: dC's state term
//       sum_h e^{cum_h,i} v_h,i where a state enters the chunk, dB's
//       sum_h e^{Lam_h - cum_h,j} w_h,j where a gradient leaves it, a
//       (64, p) by (p, 64) product per head, summed over the group's heads
//       in registers and written once into `sd` (2, groups, b, l, n), so
//       no per-head (b, l, H, n) v or w goes through device memory (at
//       the train shape that would be 268 MB written and read). Per head
//       the rows' dots with C or B over the block's columns into `sv`
//       (dcum's state terms, and d Lam's share).
//     - ssd_bwd_dx_kernel, per (b, chunk, key tile, pair of heads): the
//       forward's output blocks with the roles of query and key swapped,
//       the halves of the block taking one head each and sharing every
//       staged tile of B^T (the state term, then the sums times
//       e^{Lam - cum_jl}, jl the tile's last row) and of scores (the query
//       tiles after this one, each half's dy scaled by its head's
//       e^{cum_i - cum_jl}; then its sums times e^{cum_jl - cum_j}; then
//       the diagonal tile, decayed for both heads in one pass: half 0's in
//       place, half 1's into the free stage). Each thread owns 4 rows by
//       PW / 8 columns.
//     - ssd_bwd_w_kernel, per (b, chunk, causal tile pair, group of 8
//       heads): per head one (64, 64) product dy_i . x_j, its p split
//       between the halves (4 x 8 register tiles, the halves' sums then
//       exchanged through shared memory), decayed (off the diagonal as
//       e^{cum_i - cum_r} e^{cum_r - cum_j}, r the key tile's last row,
//       both <= 1) and masked, summed over the group in order into `wp`;
//       per head the row and column sums of M = S W (the diagonal left
//       out: it cancels) into `mp`.
//  4. ssd_bwd_final_kernel. Per (b, chunk, tile, 64 columns of n) dC (rows
//     i: the groups' W tiles summed in order, transposed, times B) and dB
//     (rows j: W times C), each plus its rows of `sd`, the groups in
//     order; the n-wide products are taken once per (b, chunk), not per
//     head. Per (b, head, chunk) dcum from `sv`, `mp` and `lam` in a
//     fixed order, then its suffix sum into d dlogA.
// Tiles arrive by cp.async (16-byte pieces where x, B, C and dy allow it,
// else 4-byte ones: the wrapper's `vec`), one or two stages deep. What
// still costs beyond the bound (PERF.md): the three pass-3 kernels run
// their 64 x 64 products at 30-40 % of the fp32 rate, and W's diagonal
// pairs compute the masked half.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd.cuh"

namespace {

// heads a W block sums (ssd.py::BWD_GROUP_HEADS), and a state block
// (ssd.py::BWD_STATE_HEADS)
constexpr int kGroupHeads = 8;
constexpr int kStateHeads = 8;
constexpr int kMainThreads = 256;  // a block of the state, dx and W kernels
constexpr int kHalf = 128;         // threads of a half
constexpr int kNH = 64;  // columns of n a state or dC / dB block takes
constexpr int kSP = kT + 8;        // padded row of a W block's score tile
constexpr int kXP = kT + 8;        // padded row of the halves' exchange tile

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
  float* sd;         // (2, SG, b, l, n): dC's and dB's state terms summed
                     // over each group of kStateHeads heads
  float* sv;         // (b, H, l, 2, nh): dcum's state terms by kind and
                     // column block; then dcum (slot 0)
  int b, l, L, H, p, n;
  int nc, nt, ntri;
  int G;        // W's head groups, ceil(H / kGroupHeads)
  int SG;       // the state blocks' head groups, ceil(H / kStateHeads)
  int ny;       // pass 2's blocks per (b, head)
  int nh;       // blocks of kNH columns of n
  int hp;       // head pairs, ceil(H / 2)
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

// load_tile (ssd.cuh) for NT threads, this one thread `t` of them
template <int W, int NT>
__device__ __forceinline__ void load_rows(float* dst, int pitch,
                                          const float* src, int64_t rs,
                                          int rows, int cols, bool vec,
                                          int t) {
  if (vec) {
    constexpr int kPieces = W / 4;
    for (int i = t; i < kT * kPieces; i += NT) {
      const int r = i / kPieces;
      const int c = (i - r * kPieces) * 4;
      const int left = r < rows ? min(4, cols - c) : 0;
      const int bytes = left > 0 ? 4 * left : 0;
      cp_async16(dst + r * pitch + c, bytes ? src + r * rs + c : src, bytes);
    }
  } else {
    for (int i = t; i < kT * W; i += NT) {
      const int r = i / W;
      const int c = i - r * W;
      const bool in = r < rows && c < cols;
      cp_async4(dst + r * pitch + c, in ? src + r * rs + c : src, in);
    }
  }
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

// one (kind, b, chunk, tile t, group of kStateHeads heads, block q of kNH
// columns of n): kind 0 (where a state enters the chunk) sum_h e^{cum_h,i}
// v_h,i with v_h,i = h_in,h^T dy_h,i; kind 1 (where a gradient leaves it)
// sum_h e^{Lam_h - cum_h,j} w_h,j with w_h,j = g_h^T x_h,j; the group's
// heads in order, in registers, into the group's slot of `sd`. Per head a
// (64, p) by (p, 64) product, dy or x rows by rows of h_in^T or g^T (both
// row-major, rows padded to PW + 4 floats), two stages deep, one barrier
// a head; then each row's dot with C_i (kind 0) or B_j (kind 1), held in
// registers, over the block's columns into `sv`. Each thread owns 4 rows
// (ty + 16 r) by 4 columns (tx + 16 cc).
template <int PW>
__device__ __forceinline__ void state_block(const Args& a, int blk,
                                            float* smem) {
  constexpr int FP = PW + 4;
  constexpr int kStage = 2 * kT * FP + kT;  // A, M and the rows' cum
  const int q = blk % a.nh;
  int rest = blk / a.nh;
  const int t = rest % a.nt;
  rest /= a.nt;
  const int sg = rest % a.SG;
  rest /= a.SG;
  const int kind = rest & 1;
  const int bc = rest >> 1;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  if (kind == 0 ? !has_h(a, c) : !has_g(a, c)) return;
  const int h_lo = sg * kStateHeads;
  const int h_end = min(a.H, h_lo + kStateHeads);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = t * kT;
  const int rows = min(kT, a.L - t0);
  const int col0 = q * kNH;
  const int cols = min(kNH, a.n - col0);
  const bool vec = a.vec != 0;
  const int64_t c0 = static_cast<int64_t>(c) * a.L;
  const int64_t yl = dy_row(a);
  const int64_t slot = static_cast<int64_t>(a.n) * PW;  // a head's slot
  const float* slots = (kind == 0 ? a.st : a.dst) +
                       static_cast<int64_t>(bc) * a.H * slot + col0 * PW;
  const float* cumc = a.cum + static_cast<int64_t>(bi) * a.H * a.l + c0;

  auto load = [&](int h, int s) {
    float* as = smem + s * kStage;
    float* ms = as + kT * FP;
    float* cs = ms + kT * FP;
    if (kind == 0)
      load_rows<PW, kMainThreads>(
          as, FP,
          a.dy + (bi * static_cast<int64_t>(a.l) + c0 + t0) * yl +
              static_cast<int64_t>(h) * a.p,
          yl, rows, a.p, vec, tid);
    else
      load_rows<PW, kMainThreads>(
          as, FP, a.x + bi * a.xb + h * a.xh + (c0 + t0) * a.xl, a.xl, rows,
          a.p, vec, tid);
    load_rows<PW, kMainThreads>(ms, FP, slots + h * slot, PW, cols, PW, true,
                                tid);
    if (tid < kT) {
      const float* cum = cumc + static_cast<int64_t>(h) * a.l + t0;
      const bool in = tid < rows;
      cp_async4(cs + tid, in ? cum + tid : cum, in);
    }
    cp_async_commit();
  };
  load(h_lo, 0);
  // this thread's C (kind 0) or B (kind 1) values
  float cv[4][4];
  {
    const float* m = kind == 0 ? a.C + bi * a.cb : a.B + bi * a.bb;
    const int64_t ms = kind == 0 ? a.cl : a.bl;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = tx + 16 * cc;
        cv[r][cc] = (i < rows && col < cols)
                        ? m[(c0 + t0 + i) * ms + col0 + col]
                        : 0.0f;
      }
    }
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[r][cc] = 0.0f;
  for (int h = h_lo; h < h_end; ++h) {
    const int s = (h - h_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // head h is in; stage s ^ 1 is free
    if (h + 1 < h_end) load(h + 1, s ^ 1);
    const float* as = smem + s * kStage;
    const float* ms = as + kT * FP;
    const float* cs = ms + kT * FP;
    float f[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) f[r][cc] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < PW; k += 4) {
      float4 av[4], mv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        av[r] = *reinterpret_cast<const float4*>(as + (ty + 16 * r) * FP + k);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        mv[cc] =
            *reinterpret_cast<const float4*>(ms + (tx + 16 * cc) * FP + k);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float u = f[r][cc];
          u = fmaf(av[r].x, mv[cc].x, u);
          u = fmaf(av[r].y, mv[cc].y, u);
          u = fmaf(av[r].z, mv[cc].z, u);
          f[r][cc] = fmaf(av[r].w, mv[cc].w, u);
        }
    }
    const float lam =
        kind == 0 ? 0.0f : cumc[static_cast<int64_t>(h) * a.l + a.L - 1];
    float dot[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ty + 16 * r;
      const float scale =
          i < rows ? (kind == 0 ? expf(cs[i]) : expf(lam - cs[i])) : 0.0f;
      dot[r] = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float u = scale * f[r][cc];
        dot[r] = fmaf(u, cv[r][cc], dot[r]);
        acc[r][cc] += u;
      }
    }
    // each row's dot over its 16 column threads (lanes of one warp)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 4);
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 8);
    }
    if (tx == 0) {
      float* svp = a.sv + ((static_cast<int64_t>(bi) * a.H + h) * a.l + c0 +
                           t0) * 2 * a.nh + kind * a.nh + q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i < rows) svp[i * 2 * a.nh] = dot[r];
      }
    }
  }
  float* out = a.sd + (((static_cast<int64_t>(kind) * a.SG + sg) * a.b + bi) *
                           a.l + c0 + t0) * a.n + col0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = ty + 16 * r;
    if (i >= rows) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int col = tx + 16 * cc;
      if (col < cols) out[i * a.n + col] = acc[r][cc];
    }
  }
}

// one (b, chunk, key tile jt, pair of heads): dx_j for the tile's rows,
// the mirror of the forward's output block, half 0 (threads 0-127) for
// head 2 pair, half 1 for head 2 pair + 1 (none past H). It walks a
// sequence of 64-row tiles through one two-stage ring, each a (64, 64)
// matrix A, k-major, that the halves share, and per half a (64, PW)
// matrix X, whose product the half adds into its rows' sums: first,
// where a gradient leaves the chunk, the state term e^{Lam - cum_j} g B_j
// as ceil(n / 64) tiles of B^T and g^T (rows of n), the sums then scaled
// by e^{Lam - cum_jl} (jl the tile's last row); then the query tiles
// nt - 1 .. jt + 1, scores S[i][j] and dy rows scaled by e^{cum_i -
// cum_jl} in shared memory (both exponents <= 0, 0 past L); then the sums
// times e^{cum_jl - cum_j}, and the diagonal tile, decayed and masked for
// each head (each warp's rows j start at its first, so its keys before it
// are skipped). Each thread owns 4 rows (rg * 4 + r) by PW / 8 columns.
template <int PW>
__device__ __forceinline__ void dx_block(const Args& a, int blk,
                                         float* smem) {
  constexpr int QC = PW / 32;
  constexpr int XF = PW / 4;
  float* g_s = smem;                // [2][kT][kGP]: A, k-major, by stage
  float* x_s = g_s + 2 * kT * kGP;  // [2][2][kT][PW]: X, by stage and half
  float* ck_s = x_s + 4 * kT * PW;  // [2][2][kT]: cum of each tile's rows
  float* cq_s = ck_s + 4 * kT;      // [2][kT]: cum of the key rows j

  const int per_tile = a.b * a.nc * a.hp;
  const int jt = blk / per_tile;  // key tile 0, the heaviest, first
  int rest = blk % per_tile;
  const int c = rest / (a.b * a.hp);
  rest %= a.b * a.hp;
  const int bi = rest / a.hp;
  const int h0 = (rest % a.hp) * 2;
  const bool pair = h0 + 1 < a.H;  // the block has a second head
  const int tid = threadIdx.x;
  const int half = tid / kHalf, ht = tid % kHalf;
  const int hh = half == 0 || pair ? h0 + half : h0;
  const bool active = half == 0 || pair;
  const int cg = ht % 8, rg = ht / 8;
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

  auto load = [&](int t, int s) {
    float* gd = g_s + s * kT * kGP;
    float* xd = x_s + (s * 2 + half) * kT * PW;
    if (t < nk) {  // the workspaces' rows are 16-byte aligned
      const int k0 = t * kT;
      load_rows<kT, kMainThreads>(
          gd, kGP, a.bt + ((bc * a.nt + jt) * a.n + k0) * kT, kT, a.n - k0,
          kT, true, tid);
      if (active)
        load_rows<PW, kHalf>(xd, PW, slot_g + k0 * PW, PW, a.n - k0, PW,
                             true, ht);
    } else {
      const int it = t < nk + nq ? a.nt - 1 - (t - nk) : jt;
      const int i0 = it * kT;
      load_rows<kT, kMainThreads>(
          gd, kGP, a.sc + (bc * a.ntri + it * (it + 1) / 2 + jt) * kT * kT,
          kT, kT, kT, true, tid);
      if (active) {
        load_rows<PW, kHalf>(xd, PW, dyc + i0 * yl, yl, a.L - i0, a.p, vec,
                             ht);
        if (ht < kT) {
          const bool in = i0 + ht < a.L;
          cp_async4(ck_s + (s * 2 + half) * kT + ht,
                    in ? cumc + i0 + ht : cumc, in);
        }
      }
    }
    cp_async_commit();
  };
  if (ht < kT)
    cq_s[half * kT + ht] = active && ht < rows_j ? cumc[j0 + ht] : 0.0f;
  load(0, 0);
  const float lam = cumc[a.L - 1];

  float acc[4][4 * QC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4 * QC; ++e) acc[r][e] = 0.0f;
  // this warp's 16 rows j begin at row_begin: on the diagonal tile no
  // query row before it sees them
  const int row_begin = (ht / 32) * 16;
  const float* cq = cq_s + half * kT;

  for (int t = 0; t < tiles; ++t) {
    const int s = t & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; stage s ^ 1 is free
    if (t + 1 < tiles) load(t + 1, s ^ 1);
    const float* gt = g_s + s * kT * kGP;
    float* xt = x_s + (s * 2 + half) * kT * PW;
    int kmin = 0;
    int kmax = min(kT, a.n - t * kT);  // a state tile: n rows
    if (t >= nk) {
      const float cl = cq[rows_j - 1];  // cum of the tile's last row
      if (t == nk && nk > 0) {
        const float d = expf(lam - cl);  // the state sums times e^{Lam - cl}
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4 * QC; ++e) acc[r][e] *= d;
      }
      if (t < nk + nq) {
        const int i0 = (a.nt - 1 - (t - nk)) * kT;
        const float* ck = ck_s + (s * 2 + half) * kT;
        // dy_i *= e^{cum_i - cl}: float4 ht % XF of rows ht / XF + m
        // kHalf / XF; rows past L are zeros
        if (active) {
#pragma unroll
          for (int m = 0; m < kT * XF / kHalf; ++m) {
            const int i = ht / XF + m * (kHalf / XF);
            float4* xv = reinterpret_cast<float4*>(xt + i * PW) + ht % XF;
            const float d = i0 + i < a.L ? expf(ck[i] - cl) : 0.0f;
            float4 v = *xv;
            v.x *= d;
            v.y *= d;
            v.z *= d;
            v.w *= d;
            *xv = v;
          }
        }
        kmax = kT;
      } else {
        if (nk > 0 || nq > 0) {
          // the sums so far times e^{cl - cum_j}
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float u = expf(cl - cq[rg * 4 + r]);
#pragma unroll
            for (int e = 0; e < 4 * QC; ++e) acc[r][e] *= u;
          }
        }
        // S[i][j] of key columns j in [jb 16, jb 16 + 16), decayed and
        // masked for head h0 in place and for head h0 + 1 into stage s ^ 1
        // (free: the diagonal is the last tile)
        const int i = tid % kT, jb = tid / kT;
        const float* ck0 = ck_s + (s * 2) * kT;
        const float* ck1 = ck0 + kT;
        const float c0i = ck0[i], c1i = ck1[i];
        float* g0 = g_s + s * kT * kGP;
        float* g1 = g_s + (s ^ 1) * kT * kGP;
        const bool row = i < rows_j;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = jb * 16 + 4 * m;
          const float4 v = *reinterpret_cast<const float4*>(g0 + i * kGP + j);
          const float sv[4] = {v.x, v.y, v.z, v.w};
          float o0[4], o1[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = row && j + e <= i;
            o0[e] = in ? sv[e] * expf(c0i - cq_s[j + e]) : 0.0f;
            o1[e] = (in && pair) ? sv[e] * expf(c1i - cq_s[kT + j + e])
                                 : 0.0f;
          }
          *reinterpret_cast<float4*>(g0 + i * kGP + j) =
              make_float4(o0[0], o0[1], o0[2], o0[3]);
          *reinterpret_cast<float4*>(g1 + i * kGP + j) =
              make_float4(o1[0], o1[1], o1[2], o1[3]);
        }
        kmin = row_begin;
        kmax = kT;
        gt = half == 0 ? g0 : g1;
      }
      __syncthreads();
    }
    if (!active) continue;
    const float* gc = gt + rg * 4;
    const float* xc = xt + cg * 4;
#pragma unroll 4
    for (int k = kmin; k < kmax; ++k) {
      const float4 sv = *reinterpret_cast<const float4*>(gc + k * kGP);
      const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int qq = 0; qq < QC; ++qq) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xc + k * PW + qq * 32);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][4 * qq + 0] = fmaf(s4[r], xv.x, acc[r][4 * qq + 0]);
          acc[r][4 * qq + 1] = fmaf(s4[r], xv.y, acc[r][4 * qq + 1]);
          acc[r][4 * qq + 2] = fmaf(s4[r], xv.z, acc[r][4 * qq + 2]);
          acc[r][4 * qq + 3] = fmaf(s4[r], xv.w, acc[r][4 * qq + 3]);
        }
      }
    }
  }
  if (!active) return;

  const int64_t row_el = static_cast<int64_t>(a.H) * a.p;
  float* dxp = a.dx + (bi * static_cast<int64_t>(a.l) + c0 + j0) * row_el +
               static_cast<int64_t>(hh) * a.p;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = rg * 4 + r;
    if (j >= rows_j) continue;
    float* drow = dxp + j * row_el;
#pragma unroll
    for (int qq = 0; qq < QC; ++qq) {
      const int col = (cg + 8 * qq) * 4;
      if (a.p % 4 == 0) {
        if (col < a.p)
          *reinterpret_cast<float4*>(drow + col) =
              make_float4(acc[r][4 * qq], acc[r][4 * qq + 1],
                          acc[r][4 * qq + 2], acc[r][4 * qq + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < a.p) drow[col + e] = acc[r][4 * qq + e];
      }
    }
  }
}

// one (b, chunk, causal tile pair it >= jt, group of kGroupHeads heads):
// the pair's scores staged once; then per head, two stages deep, the
// (64, 64) products dy_i . x_j of the pair (both operands row-major, rows
// padded to PW + 4 floats), their p split between the block's halves
// (each thread 4 rows (ty + 16 r) by 8 columns (tx + 8 cc) over half of
// p, then the halves' sums exchanged so that each thread holds 2 of its
// rows whole: half 0 rows 0-31, half 1 rows 32-63), decayed by
// e^{cum_i - cum_j} (off the diagonal as the row factor e^{cum_i - cum_r}
// times the column factor e^{cum_r - cum_j}, r the key tile's last row:
// both <= 1) and masked (j <= i, rows before L), added over the group's
// heads in order into W; and per head the row and column sums of M = S W,
// the diagonal left out, into mp (rows: over the tx lanes by xor
// shuffles; columns: over each warp's row groups by xor shuffles, then
// the warps in turn).
template <int PW>
__device__ __forceinline__ void w_block(const Args& a, int blk,
                                        float* smem) {
  constexpr int FP = PW + 4;
  constexpr int kStage = 2 * kT * FP + 2 * kT;  // dy, x and both rows' cum
  constexpr int kMainWarps = kMainThreads / 32;
  constexpr int KH = PW / 2;                    // p a half takes
  float* s_s = smem;                      // [kT][kSP]: the pair's scores
  float* red_s = s_s + kT * kSP;          // [kMainWarps][kT]: column sums
  float* x_s = red_s + kMainWarps * kT;   // [kT][kXP]: the halves' exchange
  float* ring = x_s + kT * kXP;           // [2][kStage]
  const int tile = blk % a.ntri;
  const int rest = blk / a.ntri;
  const int grp = rest % a.G;
  const int bc = rest / a.G;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= tile) ++it;
  const int jt = tile - it * (it + 1) / 2;
  const bool diag = it == jt;
  const int i0 = it * kT, j0 = jt * kT;
  const int rows_i = min(kT, a.L - i0), rows_j = min(kT, a.L - j0);
  const int tid = threadIdx.x;
  const int kh = tid / kHalf, ht = tid % kHalf;
  const int tx = ht % 8, ty = ht / 8;
  const int lane = tid & 31, warp = tid >> 5;
  const bool vec = a.vec != 0;
  const int64_t c0 = static_cast<int64_t>(c) * a.L;
  const int64_t yl = dy_row(a);
  const int h_lo = grp * kGroupHeads;
  const int h_end = min(a.H, h_lo + kGroupHeads);

  auto load = [&](int h, int s) {
    float* qd = ring + s * kStage;
    float* kd = qd + kT * FP;
    float* cd = kd + kT * FP;
    load_rows<PW, kMainThreads>(
        qd, FP,
        a.dy + (bi * static_cast<int64_t>(a.l) + c0 + i0) * yl +
            static_cast<int64_t>(h) * a.p,
        yl, rows_i, a.p, vec, tid);
    load_rows<PW, kMainThreads>(
        kd, FP, a.x + bi * a.xb + h * a.xh + (c0 + j0) * a.xl, a.xl, rows_j,
        a.p, vec, tid);
    const float* cum =
        a.cum + (static_cast<int64_t>(bi) * a.H + h) * a.l + c0;
    if (tid < 2 * kT) {  // the query rows' cum, then the key rows'
      const int r = tid % kT;
      const int r0 = tid < kT ? i0 : j0;
      const bool in = r < (tid < kT ? rows_i : rows_j);
      cp_async4(cd + tid, in ? cum + r0 + r : cum, in);
    }
    cp_async_commit();
  };
  load_rows<kT, kMainThreads>(
      s_s, kSP, a.sc + (static_cast<int64_t>(bc) * a.ntri + tile) * kT * kT,
      kT, kT, kT, true, tid);
  load(h_lo, 0);  // one group with the scores

  float wacc[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) wacc[r][cc] = 0.0f;
  for (int h = h_lo; h < h_end; ++h) {
    const int s = (h - h_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // head h is in; stage s ^ 1, x_s and red_s are free
    if (h + 1 < h_end) load(h + 1, s ^ 1);
    const float* q_s = ring + s * kStage + kh * KH;
    const float* k_s = ring + s * kStage + kT * FP + kh * KH;
    const float* ci_s = ring + s * kStage + 2 * kT * FP;
    const float* cj_s = ci_s + kT;
    float pr[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) pr[r][cc] = 0.0f;
#pragma unroll 1
    for (int k = 0; k < KH; k += 4) {
      float4 qv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * r) * FP + k);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float4 kv =
            *reinterpret_cast<const float4*>(k_s + (tx + 8 * cc) * FP + k);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float u = pr[r][cc];
          u = fmaf(qv[r].x, kv.x, u);
          u = fmaf(qv[r].y, kv.y, u);
          u = fmaf(qv[r].z, kv.z, u);
          pr[r][cc] = fmaf(qv[r].w, kv.w, u);
        }
      }
    }
    // the rows the other half keeps, through x_s
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc)
        x_s[(ty + 16 * (2 * (1 - kh) + rr)) * kXP + tx + 8 * cc] =
            kh ? pr[rr][cc] : pr[2 + rr][cc];
    __syncthreads();
    // the factors off the diagonal (0 past L)
    const float cr = cj_s[rows_j - 1];
    float fi[2], fj[8];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = ty + 16 * (2 * kh + rr);
      fi[rr] = (!diag && i < rows_i) ? expf(ci_s[i] - cr) : 0.0f;
    }
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int j = tx + 8 * cc;
      fj[cc] = (!diag && j < rows_j) ? expf(cr - cj_s[j]) : 0.0f;
    }
    float rs[2], cs[8];
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) cs[cc] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = ty + 16 * (2 * kh + rr);
      rs[rr] = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const int j = tx + 8 * cc;
        const float own = kh ? pr[2 + rr][cc] : pr[rr][cc];  // half 0's first
        const float p = kh ? x_s[i * kXP + j] + own : own + x_s[i * kXP + j];
        float w;
        if (diag) {
          const bool in = i < rows_i && j <= i;
          w = in ? p * expf(ci_s[i] - cj_s[j]) : 0.0f;
        } else {
          w = p * fi[rr] * fj[cc];
        }
        wacc[rr][cc] += w;
        const float m = (!diag || j < i) ? s_s[i * kSP + j] * w : 0.0f;
        rs[rr] += m;
        cs[cc] += m;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 1);
      rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 2);
      rs[rr] += __shfl_xor_sync(0xffffffffu, rs[rr], 4);
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
      for (int rr = 0; rr < 2; ++rr) mp[ty + 16 * (2 * kh + rr)] = rs[rr];
    }
    if (lane < 8) {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) red_s[warp * kT + tx + 8 * cc] = cs[cc];
    }
    __syncthreads();
    if (tid < kT) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kMainWarps; ++w) v += red_s[w * kT + tid];
      mp[kT + tid] = v;
    }
  }
  float* out = a.wp + ((static_cast<int64_t>(bc) * a.G + grp) * a.ntri +
                       tile) * kT * kT;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc)
      out[(ty + 16 * (2 * kh + rr)) * kT + tx + 8 * cc] = wacc[rr][cc];
}

// pass 3, three kernels of 256 threads, each block kind its own kernel so
// that each gets its own registers (at most 128 a thread at p <= 64: two
// blocks, 16 warps, an SM; in one kernel their union spilled). State
// blocks: block i takes column block i % nh of tile (i / nh) % nt, head
// group (i / (nh nt)) % SG and kind (i / (nh nt SG)) % 2 of (b, chunk)
// i / (2 nh nt SG) (a kind with no state in the chunk returns). dx
// blocks: block j takes key tile j / (b nc hp) (tile 0, the heaviest,
// first) of chunk (j % (b nc hp)) / (b hp) of b (j % (b hp)) / hp and head
// pair j % hp. W blocks: block k takes tile pair k % ntri of group
// (k / ntri) % G of (b, chunk) k / (ntri G).
template <int PW>
__global__ void __launch_bounds__(kMainThreads, PW <= 64 ? 2 : 1)
    ssd_bwd_state_kernel(Args a) {
  extern __shared__ float4 smem4[];
  state_block<PW>(a, static_cast<int>(blockIdx.x),
                  reinterpret_cast<float*>(smem4));
}

template <int PW>
__global__ void __launch_bounds__(kMainThreads, PW <= 64 ? 2 : 1)
    ssd_bwd_dx_kernel(Args a) {
  extern __shared__ float4 smem4[];
  dx_block<PW>(a, static_cast<int>(blockIdx.x),
               reinterpret_cast<float*>(smem4));
}

template <int PW>
__global__ void __launch_bounds__(kMainThreads, PW <= 64 ? 2 : 1)
    ssd_bwd_w_kernel(Args a) {
  extern __shared__ float4 smem4[];
  w_block<PW>(a, static_cast<int>(blockIdx.x),
              reinterpret_cast<float*>(smem4));
}

// ---- pass 4

// one (b, chunk, tile t, block q of kNH columns of n) of dC (which 0: rows
// i of query tile t, the groups' W tiles (t, u), u <= t, summed in order
// and transposed in shared memory, times B's rows of tile u) or of dB
// (which 1: rows j of key tile t, W tiles (u, t), u >= t, times C's rows
// of tile u); then its rows of `sd`, the head groups in order (dC, where a
// state enters the chunk; dB, where a gradient leaves it). Each thread
// owns 4 rows (rg * 4 + r) by 2 float4s of the block's columns
// ((cg + 8 q2) * 4).
__device__ __forceinline__ void bc_block(const Args& a, int blk,
                                         float* smem) {
  float* w_s = smem;            // [kT][kGP]: W, k-major
  float* m_s = w_s + kT * kGP;  // [kT][kNH]: B or C rows, the block's columns
  const int which = blk & 1;
  int rest = blk >> 1;
  const int q = rest % a.nh;
  rest /= a.nh;
  const int t = rest % a.nt;
  const int bc = rest / a.nt;
  const int bi = bc / a.nc, c = bc - bi * a.nc;
  const int tid = threadIdx.x;
  const int cg = tid % 8, rg = tid / 8;
  const int t0 = t * kT;
  const int rows = min(kT, a.L - t0);
  const int col0 = q * kNH;
  const int cols = min(kNH, a.n - col0);
  const bool vec = a.vec != 0;
  const int64_t c0 = static_cast<int64_t>(c) * a.L;
  const int64_t gstride = static_cast<int64_t>(a.ntri) * kT * kT;
  const float* wbase = a.wp + static_cast<int64_t>(bc) * a.G * gstride;

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;
  const int u_lo = which == 0 ? 0 : t;
  const int u_hi = which == 0 ? t : a.nt - 1;
  for (int u = u_lo; u <= u_hi; ++u) {
    const int pair = which == 0 ? t * (t + 1) / 2 + u : u * (u + 1) / 2 + t;
    __syncthreads();  // the last tile is done
    if (which == 0)
      load_tile<kNH>(m_s, kNH, a.B + bi * a.bb + (c0 + u * kT) * a.bl + col0,
                     a.bl, a.L - u * kT, cols, vec);
    else
      load_tile<kNH>(m_s, kNH, a.C + bi * a.cb + (c0 + u * kT) * a.cl + col0,
                     a.cl, a.L - u * kT, cols, vec);
    cp_async_commit();
    // the groups' W tiles summed in order, each group's 8 float4s a thread
    // loaded together
    const float4* wt = reinterpret_cast<const float4*>(
        wbase + static_cast<int64_t>(pair) * kT * kT);
    constexpr int kPer = kT * kT / 4 / kThreads;
    float4 ws[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) ws[m] = wt[tid + m * kThreads];
    for (int g = 1; g < a.G; ++g) {
      float4 o[kPer];
#pragma unroll
      for (int m = 0; m < kPer; ++m)
        o[m] = wt[g * gstride / 4 + tid + m * kThreads];
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        ws[m].x += o[m].x;
        ws[m].y += o[m].y;
        ws[m].z += o[m].z;
        ws[m].w += o[m].w;
      }
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int e = tid + m * kThreads;
      const int i = e / (kT / 4), j = (e % (kT / 4)) * 4;
      const float4 v = ws[m];
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
      for (int q2 = 0; q2 < 2; ++q2) {
        const float4 mv =
            *reinterpret_cast<const float4*>(mc + k * kNH + q2 * 32);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][4 * q2 + 0] = fmaf(s[r], mv.x, acc[r][4 * q2 + 0]);
          acc[r][4 * q2 + 1] = fmaf(s[r], mv.y, acc[r][4 * q2 + 1]);
          acc[r][4 * q2 + 2] = fmaf(s[r], mv.z, acc[r][4 * q2 + 2]);
          acc[r][4 * q2 + 3] = fmaf(s[r], mv.w, acc[r][4 * q2 + 3]);
        }
      }
    }
  }
  // the rows of sd, the head groups in order, each group's loaded together
  const bool state = which == 0 ? has_h(a, c) : has_g(a, c);
  float* out = which == 0 ? a.dC : a.dB;
  const int64_t part = static_cast<int64_t>(a.b) * a.l * a.n;  // a group's
  const float* sd = a.sd + static_cast<int64_t>(which) * a.SG * part;
  const int64_t row0 = (bi * static_cast<int64_t>(a.l) + c0 + t0) * a.n +
                       col0;
  if (state) {
    for (int g = 0; g < a.SG; ++g) {
      float4 v[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) {
          const int i = rg * 4 + r, col = (cg + 8 * q2) * 4;
          v[r][q2] = i < rows && col < cols
                         ? *reinterpret_cast<const float4*>(
                               sd + g * part + row0 + i * a.n + col)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) {
          acc[r][4 * q2 + 0] += v[r][q2].x;
          acc[r][4 * q2 + 1] += v[r][q2].y;
          acc[r][4 * q2 + 2] += v[r][q2].z;
          acc[r][4 * q2 + 3] += v[r][q2].w;
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = rg * 4 + r;
    if (i >= rows) continue;
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int col = (cg + 8 * q2) * 4;
      if (col < cols)
        *reinterpret_cast<float4*>(out + row0 + i * a.n + col) =
            make_float4(acc[r][4 * q2], acc[r][4 * q2 + 1],
                        acc[r][4 * q2 + 2], acc[r][4 * q2 + 3]);
    }
  }
}

// one (b, head, chunk): dcum_i = the state terms (`sv`: kind 0's column
// blocks in order where a state enters, less kind 1's where a gradient
// leaves) + M's row sums of the pairs (tile(i), jt <= tile(i)) - its
// column sums of the pairs (it >= tile(i), tile(i)), and for the last row
// d Lam (lam's ny shares, then the chunk's kind-1 terms: each thread its
// rows in order, the lanes by xor shuffles, the warps in turn), in this
// order; written over slot 0 of sv, then suffix-summed within the chunk
// into d dlogA (segments of kThreads steps from the chunk's end, a shuffle
// scan in each warp, the warps' totals added in order).
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
  const int sw = 2 * a.nh;  // sv's row stride
  float* dc = a.sv + (head * a.l + c0) * sw;
  const bool with_h = has_h(a, c), with_g = has_g(a, c);
  float wsum = 0.0f;
  for (int i = threadIdx.x; i < a.L; i += kThreads) {
    const int t = i / kT, r = i % kT;
    float v = 0.0f;
    if (with_h)
      for (int q = 0; q < a.nh; ++q) v += dc[i * sw + q];
    if (with_g) {
      float w = 0.0f;
      for (int q = 0; q < a.nh; ++q) w += dc[i * sw + a.nh + q];
      v -= w;
      wsum += w;
    }
    for (int jt = 0; jt <= t; ++jt)
      v += a.mp[((bc * a.ntri + t * (t + 1) / 2 + jt) * a.H + hh) * 2 * kT +
                r];
    for (int it = t; it < a.nt; ++it)
      v -= a.mp[((bc * a.ntri + it * (it + 1) / 2 + t) * a.H + hh) * 2 * kT +
                kT + r];
    dc[i * sw] = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
  if (lane == 0) warp_s[warp] = wsum;
  __syncthreads();  // the warps' totals, and dc, are written
  if (threadIdx.x == 0) {
    float dlam = 0.0f;
    for (int y = 0; y < a.ny; ++y)
      dlam += a.lam[(head * a.nc + c) * a.ny + y];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) dlam += warp_s[w];
    dc[(a.L - 1) * sw] += dlam;
  }
  __syncthreads();  // dc's last row is final; warp_s is free
  float carry = 0.0f;
  for (int s0 = 0; s0 < a.L; s0 += kThreads) {
    const int k = a.L - 1 - (s0 + static_cast<int>(threadIdx.x));
    float v = k >= 0 ? dc[k * sw] : 0.0f;
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

// pass 4. Blocks [0, 2 nh b nc nt): dC and dB, block i taking column block
// (i / 2) % nh of tile (i / (2 nh)) % nt of (b, chunk) i / (2 nh nt), dC
// for even i; the b H nc blocks after them: d dlogA, block j taking chunk
// j / (b H) of (b, head) j % (b H).
__global__ void __launch_bounds__(kThreads) ssd_bwd_final_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int bc_blocks = 2 * a.nh * a.b * a.nc * a.nt;
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < bc_blocks)
    bc_block(a, blk, smem);
  else
    dlogA_block(a, blk - bc_blocks, smem);
}

// opt the five large kernels in to the device's largest dynamic shared
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
  const void* kernels[5] = {
      reinterpret_cast<const void*>(&ssd_bwd_chunk_kernel<PW>),
      reinterpret_cast<const void*>(&ssd_bwd_state_kernel<PW>),
      reinterpret_cast<const void*>(&ssd_bwd_dx_kernel<PW>),
      reinterpret_cast<const void*>(&ssd_bwd_w_kernel<PW>),
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

// the six launches on one stream, with the wrapper's grids and dynamic
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
  ssd_bwd_state_kernel<PW><<<static_cast<unsigned>(grid[4]), kMainThreads,
                             static_cast<size_t>(grid[5]), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dx_kernel<PW><<<static_cast<unsigned>(grid[6]), kMainThreads,
                          static_cast<size_t>(grid[7]), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_w_kernel<PW><<<static_cast<unsigned>(grid[8]), kMainThreads,
                         static_cast<size_t>(grid[9]), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_final_kernel<<<static_cast<unsigned>(grid[10]), kThreads,
                         static_cast<size_t>(grid[11]), stream>>>(a);
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
// and dC (b, l, n), dh0 (b, h, p, n) or null (not wanted). The eight
// workspaces as ssd.py::backward_plan shapes them, in its order (dst, sc,
// bt, lam, wp, mp, sd, sv). has_h0: the forward had an h0. vec: x, B, C
// and dy have 16-byte aligned base addresses and row strides. grid:
// ssd.py::backward_plan's launch values, each kernel's blocks (the pass's
// as x, y) and dynamic shared memory in bytes. Returns the first
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
  const int nh = (n + kNH - 1) / kNH;
  const int hp = (H + 1) / 2;
  const int sg = (H + kStateHeads - 1) / kStateHeads;
  const int nc = L >= 1 ? l / L : 0;
  if (L < 1 || l % L != 0 || p < 1 || p > 128 || n < 4 || n > kN ||
      n % 4 != 0 || groups != (H + kGroupHeads - 1) / kGroupHeads ||
      grid[2] != b * H || grid[3] != ny ||
      grid[0] != b * H * nc + b * nc * nt * (nt + 1) / 2 ||
      grid[4] != 2 * b * nc * nt * sg * nh || grid[6] != b * nc * nt * hp ||
      grid[8] != b * nc * nt * (nt + 1) / 2 * groups ||
      grid[10] != 2 * nh * b * nc * nt + b * H * nc)
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
  a.sd = static_cast<float*>(work[6]);
  a.sv = static_cast<float*>(work[7]);
  a.b = b;
  a.l = l;
  a.L = L;
  a.H = H;
  a.p = p;
  a.n = n;
  a.nc = nc;
  a.nt = nt;
  a.ntri = nt * (nt + 1) / 2;
  a.G = groups;
  a.SG = sg;
  a.ny = ny;
  a.nh = nh;
  a.hp = hp;
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
