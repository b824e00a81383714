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
// The prefix sum is taken in fp32 by one warp: each lane sums a run of
// L/32 consecutive steps left to right, then a shuffle scan adds the runs'
// totals in order (the plain version's cumsum adds strictly left to
// right; the two differ by rounding only). Inputs and outputs are float32;
// every product is an IEEE fp32 fmaf (no tensor cores, no TF32). bf16 is
// refused by the wrapper: mamba_block casts x_dt, B and C to float32
// before the scan (repro/models/ssm.py), so the model never passes it;
// a bf16 path belongs with bf16 serving.
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
// What the design does about it: the chunk axis is sequential, and
// blocks carry nothing between them, so one block of 256 threads owns
// one (b, head) and walks its chunks in order, the (p, n) state resident
// in shared memory for the whole sequence; only h_last is written. A
// chunk does not fit in shared memory (one chunk of B alone is 128 KB at
// the serve shape), so the intra-chunk product is a causal blocked loop,
// K4's structure without the softmax: 64 query rows of C stay staged
// while the 64-row tiles of B and X at or before them stream through;
// each thread holds a 4 x 4 register tile of the scores and a 4 x p/16
// tile of y, the decayed and masked scores pass through shared memory
// (float4 broadcasts), and C, B and the state rows are padded to n + 4
// floats so the lanes' float4 reads hit distinct banks. The state update
// streams the chunk's B and decayed X tiles once more, each thread
// owning a 2p/16 x 4 slice of the (p, n) state. The kernel does 6.17
// GFLOP at the serve shape: every head recomputes the scores C B^T, over
// whole diagonal tiles (2.68 GFLOP of it, against 0.07 needed), and the
// first chunk multiplies its zero state. Sharing the scores across heads,
// mma.sync/wgmma and TMA are left for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads; 8 warps
constexpr int kT = 64;          // rows of a query tile and of a key tile
constexpr int kSS = kT + 4;     // padded row of the score tile
constexpr int kMaxN = 128;      // state width n, a multiple of 4
constexpr int kNM = kMaxN / 32; // state columns per lane in the update

struct Args {
  const float* x;
  const float* dA;
  const float* B;
  const float* C;
  const float* h0;  // nullptr: zeros
  float* y;
  float* hl;
  int l, L, H, p, n;
  int64_t xb, xl, xh;  // strides of x, in elements (the p axis is 1)
  int64_t ab, al, ah;  // of dlogA
  int64_t bb, bl;      // of B (the n axis is 1)
  int64_t cb, cl;      // of C
};

// shared memory of one block, in floats: the state [PW][n + 4], C and B
// tiles [kT][n + 4] each, X tile [kT][PW], scores [kT][kSS], cum [L]
__host__ __device__ inline int64_t smem_floats(int pw, int n, int L) {
  const int64_t ns = n + 4;
  return pw * ns + 2 * kT * ns + static_cast<int64_t>(kT) * pw +
         kT * kSS + L;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// rows row0 .. row0 + kT - 1 of a (l, n) matrix into dst [kT][ns]; rows
// at or past `valid` are zero
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t row_stride, int row0,
                                          int valid, int n, int ns) {
  for (int i = threadIdx.x; i < kT * n; i += kThreads) {
    const int r = i / n;
    const int k = i - r * n;
    dst[r * ns + k] =
        r < valid ? src[static_cast<int64_t>(row0 + r) * row_stride + k]
                  : 0.0f;
  }
}

// PC = ceil(p / 16) rounded up to 1, 2, 4 or 8: y columns per thread
template <int PC>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args a) {
  constexpr int PW = 16 * PC;  // padded p
  extern __shared__ float4 smem4[];
  const int p = a.p, n = a.n, L = a.L;
  const int ns = n + 4;
  float* h_s = reinterpret_cast<float*>(smem4);  // [PW][ns]
  float* c_s = h_s + PW * ns;                    // [kT][ns]
  float* b_s = c_s + kT * ns;                    // [kT][ns]
  float* x_s = b_s + kT * ns;                    // [kT][PW]
  float* s_s = x_s + kT * PW;                    // [kT][kSS]
  float* cum = s_s + kT * kSS;                   // [L]

  const int hh = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;

  const float* xbh = a.x + bi * a.xb + hh * a.xh;
  const float* abh = a.dA + bi * a.ab + hh * a.ah;
  const float* bbp = a.B + bi * a.bb;
  const float* cbp = a.C + bi * a.cb;
  const int64_t hoff = (static_cast<int64_t>(bi) * a.H + hh) * p * n;
  float* ybh = a.y + (static_cast<int64_t>(bi) * a.l * a.H + hh) * p;
  const int64_t y_row = static_cast<int64_t>(a.H) * p;

  // the state entering the first chunk; rows past p and the padding stay 0
  for (int i = tid; i < PW * ns; i += kThreads) {
    const int r = i / ns;
    const int k = i - r * ns;
    h_s[i] = (a.h0 != nullptr && r < p && k < n) ? a.h0[hoff + r * n + k]
                                                 : 0.0f;
  }
  const int nt = (L + kT - 1) / kT;

  for (int t0 = 0; t0 < a.l; t0 += L) {
    __syncthreads();  // the previous chunk's state update is complete
    for (int i = tid; i < L; i += kThreads)
      cum[i] = abh[static_cast<int64_t>(t0 + i) * a.al];
    __syncthreads();
    if (warp == 0) {
      // inclusive prefix sum: each lane sums its run of consecutive steps
      // left to right, a shuffle scan adds up the lanes' totals, and each
      // lane adds the total of the lanes before it
      const int seg = (L + 31) / 32;
      const int lo = min(L, lane * seg), hi = min(L, lo + seg);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) {
        run += cum[i];
        cum[i] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, tot, off);
        if (lane >= off) tot += v;
      }
      float before = __shfl_up_sync(0xffffffffu, tot, 1);
      if (lane == 0) before = 0.0f;
      for (int i = lo; i < hi; ++i) cum[i] += before;
    }
    __syncthreads();
    const float cum_last = cum[L - 1];

    // ---- y, one query tile of 64 rows at a time
    for (int qt = 0; qt < nt; ++qt) {
      const int i0 = qt * kT;
      __syncthreads();  // c_s free
      load_rows(c_s, cbp, a.cl, t0 + i0, L - i0, n, ns);
      __syncthreads();

      // carried-in state: acc = e^{cum_i} C_i h^T
      float acc[4][PC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] = 0.0f;
      for (int k = 0; k < n; k += 4) {
        float4 cv[4], hv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(c_s + (ty + 16 * r) * ns
                                                   + k);
#pragma unroll
        for (int c = 0; c < PC; ++c)
          hv[c] = *reinterpret_cast<const float4*>(h_s + (tx + 16 * c) * ns
                                                   + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < PC; ++c) acc[r][c] = dot4(cv[r], hv[c],
                                                        acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float d = i < L ? expf(cum[i]) : 0.0f;
#pragma unroll
        for (int c = 0; c < PC; ++c) acc[r][c] *= d;
      }

      // the causal key tiles at or before this query tile
      for (int kt = 0; kt <= qt; ++kt) {
        const int j0 = kt * kT;
        __syncthreads();  // b_s, x_s, s_s free
        load_rows(b_s, bbp, a.bl, t0 + j0, L - j0, n, ns);
        for (int i = tid; i < kT * PW; i += kThreads) {
          const int j = i / PW;
          const int col = i - j * PW;
          x_s[i] = (j < L - j0 && col < p)
                       ? xbh[static_cast<int64_t>(t0 + j0 + j) * a.xl + col]
                       : 0.0f;
        }
        __syncthreads();

        // scores C_i . B_j, decayed and masked
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
        for (int k = 0; k < n; k += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            cv[r] = *reinterpret_cast<const float4*>(c_s + (ty + 16 * r) * ns
                                                     + k);
            bv[r] = *reinterpret_cast<const float4*>(b_s + (tx + 16 * r) * ns
                                                     + k);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = dot4(cv[r], bv[c], s[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ri = ty + 16 * r;
          const int i = i0 + ri;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int cj = tx + 16 * c;
            const int j = j0 + cj;
            s_s[ri * kSS + cj] = (i < L && j <= i)
                                     ? s[r][c] * expf(cum[i] - cum[j])
                                     : 0.0f;
          }
        }
        __syncthreads();

        // acc += scores X
        for (int j = 0; j < kT; j += 4) {
          float4 sv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            sv[r] = *reinterpret_cast<const float4*>(s_s + (ty + 16 * r) * kSS
                                                     + j);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float xv[PC];
#pragma unroll
            for (int c = 0; c < PC; ++c) xv[c] = x_s[(j + jj) * PW + tx
                                                     + 16 * c];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float sr = comp(sv[r], jj);
#pragma unroll
              for (int c = 0; c < PC; ++c) acc[r][c] = fmaf(sr, xv[c],
                                                            acc[r][c]);
            }
          }
        }
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= L) continue;
        float* yrow = ybh + static_cast<int64_t>(t0 + i) * y_row;
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          const int col = tx + 16 * c;
          if (col < p) yrow[col] = acc[r][c];
        }
      }
    }

    // ---- the state leaving the chunk
    float sacc[2 * PC][kNM];
#pragma unroll
    for (int q = 0; q < 2 * PC; ++q)
#pragma unroll
      for (int m = 0; m < kNM; ++m) sacc[q][m] = 0.0f;
    for (int kt = 0; kt < nt; ++kt) {
      const int j0 = kt * kT;
      __syncthreads();  // b_s, x_s free
      load_rows(b_s, bbp, a.bl, t0 + j0, L - j0, n, ns);
      for (int i = tid; i < kT * PW; i += kThreads) {
        const int j = i / PW;
        const int col = i - j * PW;
        x_s[i] = (j < L - j0 && col < p)
                     ? xbh[static_cast<int64_t>(t0 + j0 + j) * a.xl + col] *
                           expf(cum_last - cum[j0 + j])
                     : 0.0f;
      }
      __syncthreads();
      const int rows = min(kT, L - j0);
      for (int j = 0; j < rows; ++j) {
        float bv[kNM];
#pragma unroll
        for (int m = 0; m < kNM; ++m) {
          const int k = lane + 32 * m;
          bv[m] = k < n ? b_s[j * ns + k] : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < 2 * PC; ++q) {
          const float xv = x_s[j * PW + warp + 8 * q];
#pragma unroll
          for (int m = 0; m < kNM; ++m) sacc[q][m] = fmaf(xv, bv[m],
                                                          sacc[q][m]);
        }
      }
    }
    // each (row, column) of the state has one owner; no thread reads the
    // state again before the next chunk's first barrier
    const float dec = expf(cum_last);
#pragma unroll
    for (int q = 0; q < 2 * PC; ++q) {
      const int r = warp + 8 * q;
#pragma unroll
      for (int m = 0; m < kNM; ++m) {
        const int k = lane + 32 * m;
        if (r < p && k < n) h_s[r * ns + k] = fmaf(h_s[r * ns + k], dec,
                                                   sacc[q][m]);
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < p * n; i += kThreads) {
    const int r = i / n;
    a.hl[hoff + i] = h_s[r * ns + (i - r * n)];
  }
}

template <int PC>
cudaError_t launch(const Args& a, int b, cudaStream_t stream) {
  const int64_t bytes = smem_floats(16 * PC, a.n, a.L) *
                        static_cast<int64_t>(sizeof(float));
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (bytes > limit) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(ssd_kernel<PC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(a.H), static_cast<unsigned>(b));
  ssd_kernel<PC><<<grid, kThreads, static_cast<size_t>(bytes), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. All tensors float32 on `device`;
// `strides` holds, in elements, the (b, l, h) strides of x, the (b, l, h)
// strides of dlogA, and the (b, l) strides of B and of C (ten values; the
// last axis of x, B and C has stride 1). h0 is contiguous (b, h, p, n) or
// null (zeros); y (b, l, h, p) and h_last (b, h, p, n) are contiguous.
// l is a multiple of the chunk length L; p <= 128; n a multiple of 4 up
// to 128. The launch goes on `stream`. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for shapes out of range).
extern "C" int ssd_f32(const void* x, const void* dlogA, const void* B,
                       const void* C, const void* h0, void* y, void* h_last,
                       int b, int l, int H, int p, int n, int L,
                       const long long* strides, int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L < 1 || l % L != 0 || p < 1 || p > 128 || n < 4 || n > kMaxN ||
      n % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const float*>(x);
  a.dA = static_cast<const float*>(dlogA);
  a.B = static_cast<const float*>(B);
  a.C = static_cast<const float*>(C);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.hl = static_cast<float*>(h_last);
  a.l = l;
  a.L = L;
  a.H = H;
  a.p = p;
  a.n = n;
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
  const int pc = (p + 15) / 16;
  if (pc <= 1) return static_cast<int>(launch<1>(a, b, s));
  if (pc <= 2) return static_cast<int>(launch<2>(a, b, s));
  if (pc <= 4) return static_cast<int>(launch<4>(a, b, s));
  return static_cast<int>(launch<8>(a, b, s));
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
