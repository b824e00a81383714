// graph_mix: out = A @ W for the DPFL Eq.-4 mix and the greedy set sums.
//
// Replaces the Pallas TPU kernel repro/kernels/graph_mix.py::graph_mix.
// A is the (M, N) mixing operator (M = N clients for the Eq.-4 mix,
// a batch of mask-weight rows for weighted_sum), W the (N, P) client-
// stacked flattened parameters, P the model size (62,006 for PaperCNN).
// Accumulates in IEEE fp32 (fmaf, no tensor cores, no TF32) and writes
// W's dtype (fp32 or bf16); A is read as fp32.
//
// What bounds it: memory. The work is 2*M*N*P flops against
// 4*(M*N + N*P + M*P) bytes (fp32); at M = N = 32 that is 8 flops per
// byte, below the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 flops
// per byte without tensor cores), so the least time is the bytes over
// HBM bandwidth (about 15.9 MB, some 4.7 us at 3.35 TB/s). At that size
// the launch latency is of the same order.
//
// What the design does about it: every element of W is read from device
// memory exactly once per block of up to 32 output rows (one block row
// covers M <= 32), and every output element is written once. Each thread
// owns one column of W: a warp reads 32 consecutive fp32 words (128 B,
// coalesced) per inner step and keeps one fp32 accumulator per output
// row in registers. The rows of A are staged in shared memory in chunks
// of kChunk along N and read as broadcasts. The row count is a template
// parameter (1, 4, 8, 16 or 32), so the M = 1 and small-batch calls do
// not pay for 32 accumulators. The ragged edge of P is masked. wgmma and
// TMA are left for a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // columns of W per block, one per thread
constexpr int kChunk = 32;     // entries of the inner N axis staged per pass

__device__ __forceinline__ float load_w(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int ROWS, typename T>
__global__ void __launch_bounds__(kThreads)
graph_mix_kernel(const float* __restrict__ A, const T* __restrict__ W,
                 T* __restrict__ out, int M, int N, int64_t P) {
  __shared__ float a_s[ROWS][kChunk];
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int row0 = blockIdx.y * ROWS;

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int kc = min(kChunk, N - n0);
    // stage A[row0:row0+ROWS, n0:n0+kc]; rows past M and entries past kc
    // are zero so the unrolled row loop below needs no masks
    for (int i = threadIdx.x; i < ROWS * kChunk; i += kThreads) {
      const int r = i / kChunk;
      const int n = i % kChunk;
      a_s[r][n] = (row0 + r < M && n < kc)
                      ? A[static_cast<int64_t>(row0 + r) * N + n0 + n]
                      : 0.0f;
    }
    __syncthreads();
    if (col < P) {
      const T* w_col = W + static_cast<int64_t>(n0) * P + col;
#pragma unroll 4
      for (int n = 0; n < kc; ++n) {
        const float w = load_w(w_col + static_cast<int64_t>(n) * P);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(a_s[r][n], w, acc[r]);
      }
    }
    __syncthreads();
  }

  if (col < P) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (row0 + r < M) {
        store_out(out + static_cast<int64_t>(row0 + r) * P + col, acc[r]);
      }
    }
  }
}

template <int ROWS, typename T>
cudaError_t launch(const float* A, const T* W, T* out, int M, int N,
                   int64_t P, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((P + kThreads - 1) / kThreads),
                  static_cast<unsigned>((M + ROWS - 1) / ROWS));
  graph_mix_kernel<ROWS, T><<<grid, kThreads, 0, stream>>>(A, W, out, M, N, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* A, const void* W, void* out, int M, int N,
                     int64_t P, int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* a = static_cast<const float*>(A);
  const T* w = static_cast<const T*>(W);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch<1, T>(a, w, o, M, N, P, s);
  if (M <= 4) return launch<4, T>(a, w, o, M, N, P, s);
  if (M <= 8) return launch<8, T>(a, w, o, M, N, P, s);
  if (M <= 16) return launch<16, T>(a, w, o, M, N, P, s);
  return launch<32, T>(a, w, o, M, N, P, s);
}

}  // namespace

// C entry points, bound with ctypes. A is (M, N) fp32, W is (N, P) and
// out is (M, P) in W's dtype, all contiguous on `device`; the launch goes
// on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int graph_mix_f32(const void* A, const void* W, void* out, int M,
                             int N, long long P, int device, void* stream) {
  return static_cast<int>(
      dispatch<float>(A, W, out, M, N, P, device, stream));
}

extern "C" int graph_mix_bf16(const void* A, const void* W, void* out, int M,
                              int N, long long P, int device, void* stream) {
  return static_cast<int>(
      dispatch<__nv_bfloat16>(A, W, out, M, N, P, device, stream));
}

extern "C" const char* graph_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
