// flash_attention: causal grouped-query attention with an optional sliding
// window, for the prefill of every attention layer of the LM substrate.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention. q is (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), read in
// place through their strides (the last axis contiguous); out is
// (B, Sq, Hq, hd), contiguous, in q's dtype. Positions are aligned: query
// row i and key j sit at positions i and j, so row i sees the keys j with
// j <= i (causal) and j > i - window (window > 0). Inputs are fp32 or
// bf16, widened to fp32; every product is an IEEE fp32 fmaf (no tensor
// cores, no TF32). The online softmax keeps fp32 m, l and acc per row and
// takes the Pallas kernel's steps: masked scores are -1e30, each tile
// rescales by exp(m_prev - m_new), and the output divides by
// max(l, 1e-30).
//
// What bounds it: operations. At the serve shape of qwen3-0.6b (B 4,
// S 512, Hq 16, Hkv 8, hd 128, causal) the work is 4*B*Hq*hd*S(S+1)/2 =
// 4.30 GFLOP against 50.3 MB of q, k, v and out: 85 flops per byte, far
// above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 flops per
// byte), so the least time is the flops at the fp32 rate outside the
// tensor cores, 64 us.
//
// What the design does about it: the (Sq, Sk) score matrix never leaves
// the SM. One block of four warps takes 32 query rows of one (b, head),
// stages them in shared memory once, and walks the key tiles (32 keys
// each) from the window's start to the causal frontier, skipping the
// tiles that no row of the block can see. A tile's K and V are staged in
// shared memory; each warp owns 8 query rows and each lane one key for
// the scores (Q read as float4 broadcasts, K rows padded to hd + 4 floats
// so the lanes' float4 reads hit distinct banks), then one output column
// in every 32 for P V (P through shared memory as float4 broadcasts).
// Blocks start with the longest rows (the last query tiles), so the
// causal triangle's short tiles fill the tail of the grid. Tails of Sq and
// Sk are masked here, where the Pallas wrapper demands whole blocks.
// wgmma, TMA and mma.sync bf16 are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;               // query rows per warp
constexpr int kBQ = kWarps * kRows;    // query rows per block
constexpr int kBK = 32;                // keys per tile, one per lane
constexpr float kNegInf = -1e30f;      // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Strides {
  int64_t b, s, h;  // of q, k or v, in elements; the last axis is 1
};

// shared memory of one block, in floats: Q [kBQ][hd], K [kBK][hd + 4],
// V [kBK][NJ * 32] (columns past hd stay 0), P [kWarps][kRows][kBK]
__host__ __device__ constexpr int smem_floats(int hd, int nj) {
  return kBQ * hd + kBK * (hd + 4) + kBK * nj * 32 + kWarps * kRows * kBK;
}

// NJ = ceil(hd / 32): output columns per lane
template <int NJ, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hq, int rep, int hd, Strides qs,
                       Strides ks, Strides vs, int causal, int window,
                       float scale) {
  extern __shared__ float4 smem4[];
  constexpr int VW = NJ * 32;
  const int kw = hd + 4;  // padded K row: hd is a multiple of 16
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * hd;
  float* v_s = k_s + kBK * kw;
  float* p_s = v_s + kBK * VW;

  const int qt = causal ? static_cast<int>(gridDim.x - 1 - blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / rep;
  const int q0 = qt * kBQ;
  const int q_end = min(q0 + kBQ, Sq);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRows;  // this warp's first row in the tile

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  // Q tile, rows past Sq zero; V's padding columns zero once (the tile
  // loads below never write them)
  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd;
    const int d = i - r * hd;
    q_s[i] = (q0 + r < Sq) ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.0f;
  }
  if (VW > hd) {
    for (int i = tid; i < kBK * (VW - hd); i += kThreads) {
      const int key = i / (VW - hd);
      v_s[key * VW + hd + (i - key * (VW - hd))] = 0.0f;
    }
  }

  // the keys any row of this block can see
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk, q_end) : Sk;

  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.0f;
  }

  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();  // Q staged / the previous tile consumed
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int key = i / hd;
      const int d = i - key * hd;
      const bool in = k0 + key < Sk;
      k_s[key * kw + d] = in ? to_f32(kb[(k0 + key) * ks.s + d]) : 0.0f;
      v_s[key * VW + d] = in ? to_f32(vb[(k0 + key) * vs.s + d]) : 0.0f;
    }
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float* krow = k_s + lane * kw;
#pragma unroll 2
    for (int d = 0; d < hd; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (row0 + r) * hd + d);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    // mask, then the online softmax step of each row
    const int kp = k0 + lane;
    float* p_w = p_s + warp * kRows * kBK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + row0 + r;
      const bool valid = kp < Sk && (!causal || kp <= qp) &&
                         (window <= 0 || kp > qp - window);
      const float sr = valid ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= corr;
      p_w[r * kBK + lane] = p;
    }
    __syncwarp();

    // acc += P V: this lane's columns lane + 32 j
#pragma unroll 2
    for (int key = 0; key < kBK; key += 4) {
      float vv[4][NJ];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          vv[t][j] = v_s[(key + t) * VW + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(p_w + r * kBK + key);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[r][j] = fmaf(pv.x, vv[0][j], acc[r][j]);
          acc[r][j] = fmaf(pv.y, vv[1][j], acc[r][j]);
          acc[r][j] = fmaf(pv.z, vv[2][j], acc[r][j]);
          acc[r][j] = fmaf(pv.w, vv[3][j], acc[r][j]);
        }
      }
    }
  }

  // out[b, row, h, :] = acc / max(l, 1e-30), contiguous (B, Sq, Hq, hd)
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + row0 + r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + ((static_cast<int64_t>(b) * Sq + row) * Hq + h) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) store_out(orow + d, acc[r][j] / denom);
    }
  }
}

template <int NJ, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int B, int Sq,
                   int Sk, int Hq, int Hkv, int hd, const Strides& qs,
                   const Strides& ks, const Strides& vs, int causal,
                   int window, float scale, cudaStream_t stream) {
  const int bytes = smem_floats(hd, NJ) * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<NJ, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(Hq), static_cast<unsigned>(B));
  flash_attention_kernel<NJ, T><<<grid, kThreads, bytes, stream>>>(
      q, k, v, out, Sq, Sk, Hq, Hq / Hkv, hd, qs, ks, vs, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int Hq, int Hkv, int hd,
                     const long long* strides, int causal, int window,
                     float scale, int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_CASE(NJ)                                                         \
  case NJ:                                                                  \
    return launch<NJ, T>(qp, kp, vp, op, B, Sq, Sk, Hq, Hkv, hd, qs, ks, vs, \
                         causal, window, scale, s);
  switch ((hd + 31) / 32) {
    FA_CASE(1)
    FA_CASE(2)
    FA_CASE(3)
    FA_CASE(4)
    FA_CASE(5)
    FA_CASE(6)
    FA_CASE(7)
    FA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// C entry points, bound with ctypes. q, k, v on `device` in the dtype of
// the name; `strides` holds the (b, s, h) strides of q, k and v in
// elements (nine values; the head axis has stride 1); out is contiguous
// (B, Sq, Hq, hd). hd is a multiple of 16 up to 256, Hq a multiple of
// Hkv; window <= 0 means none. The launch goes on `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int Hq, int Hkv, int hd,
                                   const long long* strides, int causal,
                                   int window, float scale, int device,
                                   void* stream) {
  return static_cast<int>(dispatch<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv,
                                          hd, strides, causal, window, scale,
                                          device, stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Sk, int Hq, int Hkv, int hd,
                                    const long long* strides, int causal,
                                    int window, float scale, int device,
                                    void* stream) {
  return static_cast<int>(dispatch<__nv_bfloat16>(
      q, k, v, out, B, Sq, Sk, Hq, Hkv, hd, strides, causal, window, scale,
      device, stream));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
