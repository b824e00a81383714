// sparse_graph_mix: the neighbor-list Eq.-4 mix of DPFL,
//
//   out[n, :] = self_w[n] * W_self[n, :] + sum_b nbr_w[n, b] * W_peers[idx[n, b], :]
//
// Replaces the Pallas TPU kernel
// repro/kernels/sparse_graph_mix.py::sparse_graph_mix. idx is the (N, B)
// int32 neighbor table of the budget-constrained greedy (B = budget, -1 an
// empty slot), self_w (N,) and nbr_w (N, B) the Eq.-4 row weights, W_self
// and W_peers (N, P) client-stacked flattened parameters (the same table
// without a codec; the decoded payloads under one, while the self term
// reads the exact local rows). Accumulates in IEEE fp32 (fmaf) and writes
// W_self's dtype (fp32 or bf16).
//
// What bounds it: memory. The work is 2*N*(B+1)*P flops against, at the
// least, one read of the table(s) and one write of the output: with
// W_peers == W_self and (N, B, P) = (32, 4, 62006) fp32 that is 15.9 MB,
// 4.7 us at 3.35 TB/s (23.8 MB, 7.1 us, with a separate W_peers). Reading
// every gathered row from HBM would be 47.6 MB; the table is 7.9 MB and
// fits in the 50 MB L2, so the rows gathered by several clients are meant
// to come from L2.
//
// What the design does about it: the Pallas grid walks (panel, client,
// slot) in order and DMAs one peer panel per step. Here the grid is
// parallel over (P tiles, clients): each block owns kThreads * kCols
// columns of one output row, each thread kCols columns kThreads apart, so
// every load of W is a coalesced 128-byte warp access and each thread has
// kCols independent loads in flight per slot; the blocks of one P tile
// that gather the same peer row run close together in time and share it
// through L2. A block stages its row's slot indices (clamped to [0, N),
// as the Pallas wrapper does) and weights (0 for an empty slot) in shared
// memory, kChunk slots at a time, so any B >= 1 works, B > N included.
// Each thread starts from self_w[n] * W_self[n, col] and adds the slots in
// order b = 0..B-1 with fmaf: a fixed order, so the result is the same
// from run to run. No (N, B, P) intermediate exists. Vector loads (rows
// of P = 62006 fp32 are not 16-byte aligned) and fusing clients that share
// peers into one block are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kCols = 4;       // output columns per thread, kThreads apart
constexpr int kChunk = 64;     // slots staged in shared memory per pass

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_graph_mix_kernel(const float* __restrict__ self_w,
                        const float* __restrict__ nbr_w,
                        const int32_t* __restrict__ nbr_idx,
                        const T* __restrict__ W_self,
                        const T* __restrict__ W_peers, T* __restrict__ out,
                        int N, int B, int64_t P) {
  __shared__ int64_t row_s[kChunk];  // element offset of each slot's row
  __shared__ float w_s[kChunk];
  const int n = blockIdx.y;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kThreads * kCols +
                       threadIdx.x;
  const int64_t self_row = static_cast<int64_t>(n) * P;
  const float sw = self_w[n];

  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int64_t col = col0 + c * kThreads;
    acc[c] = col < P ? sw * load_w(W_self + self_row + col) : 0.0f;
  }

  for (int b0 = 0; b0 < B; b0 += kChunk) {
    const int bc = min(kChunk, B - b0);
    for (int i = threadIdx.x; i < bc; i += kThreads) {
      const int64_t at = static_cast<int64_t>(n) * B + b0 + i;
      const int j = nbr_idx[at];
      const int safe = j < 0 ? 0 : (j >= N ? N - 1 : j);
      row_s[i] = static_cast<int64_t>(safe) * P;
      w_s[i] = j >= 0 ? nbr_w[at] : 0.0f;
    }
    __syncthreads();
    for (int b = 0; b < bc; ++b) {
      const T* row = W_peers + row_s[b];
      const float w = w_s[b];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int64_t col = col0 + c * kThreads;
        if (col < P) acc[c] = fmaf(w, load_w(row + col), acc[c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int64_t col = col0 + c * kThreads;
    if (col < P) store_out(out + self_row + col, acc[c]);
  }
}

template <typename T>
cudaError_t launch(const void* self_w, const void* nbr_w, const void* nbr_idx,
                   const void* W_self, const void* W_peers, void* out, int N,
                   int B, int64_t P, int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int64_t kSpan = static_cast<int64_t>(kThreads) * kCols;
  const dim3 grid(static_cast<unsigned>((P + kSpan - 1) / kSpan),
                  static_cast<unsigned>(N));
  sparse_graph_mix_kernel<T><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(self_w), static_cast<const float*>(nbr_w),
      static_cast<const int32_t*>(nbr_idx), static_cast<const T*>(W_self),
      static_cast<const T*>(W_peers), static_cast<T*>(out), N, B, P);
  return cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. self_w is (N,) fp32, nbr_w (N, B)
// fp32, nbr_idx (N, B) int32, W_self, W_peers and out (N, P) in one
// dtype, all contiguous on `device`; the launch goes on `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int sparse_graph_mix_f32(const void* self_w, const void* nbr_w,
                                    const void* nbr_idx, const void* W_self,
                                    const void* W_peers, void* out, int N,
                                    int B, long long P, int device,
                                    void* stream) {
  return static_cast<int>(launch<float>(self_w, nbr_w, nbr_idx, W_self,
                                        W_peers, out, N, B, P, device,
                                        stream));
}

extern "C" int sparse_graph_mix_bf16(const void* self_w, const void* nbr_w,
                                     const void* nbr_idx, const void* W_self,
                                     const void* W_peers, void* out, int N,
                                     int B, long long P, int device,
                                     void* stream) {
  return static_cast<int>(launch<__nv_bfloat16>(self_w, nbr_w, nbr_idx,
                                                W_self, W_peers, out, N, B,
                                                P, device, stream));
}

extern "C" const char* sparse_graph_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
