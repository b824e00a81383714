// graph_mix: out = A @ W for the DPFL Eq.-4 mix and the greedy set sums.
//
// Replaces the Pallas TPU kernel repro/kernels/graph_mix.py::graph_mix.
// A is the (M, N) mixing operator (M = N clients for the Eq.-4 mix,
// a batch of mask-weight rows for weighted_sum), W the (N, P) client-
// stacked flattened parameters, P the model size (62,006 for PaperCNN).
// Accumulates in IEEE fp32 (fmaf, no tensor cores, no TF32), each output
// in the order n = 0, 1, ..., N - 1, so a repeated call gives the same
// bits; writes W's dtype (fp32 or bf16); A is read as fp32.
//
// What bounds it: memory. The work is 2*M*N*P flops against
// 4*(M*N + N*P + M*P) bytes (fp32); at M = N = 32 that is 8 flops per
// byte, below the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 flops
// per byte without tensor cores), so the least time is the bytes over
// HBM bandwidth (about 15.9 MB, some 4.7 us at 3.35 TB/s). At that size
// the launch latency is of the same order.
//
// What the design does about it: the kernel is built to keep W in
// flight and the stores of out moving. Each thread owns COLS adjacent
// columns (2 or 1; the wrapper picks 2 where P is even and W's and out's
// base addresses are aligned to two elements, graph_mix.py::vector_width)
// and reads them with one vector load per row: 8 or 4 bytes in fp32, 4
// or 2 in bf16 (four columns as float4 were slower on the card: with 32
// accumulators of four columns a pass holds only 16 rows, PERF.md). A
// pass first asks for its (ROWS, kNB) panel of A (a few values a thread,
// L2 hits after the first block), then issues the loads of kNB = 32 rows
// of W (all of the Eq.-4 mix's) into registers before any FMA, and only
// then stages A in shared memory behind a barrier, so neither the
// barrier nor A holds a W load back, and A, asked for first, is there
// before W; at PaperCNN's shape every thread has its whole column strip
// (256 bytes) in flight at once, the whole of W across the card; these
// loads skip L1, since W is read once. (Asking for A after W put its
// round trip behind W's on the critical path.) The sums then run kRG = 8
// output rows at a time (16 independent sums a thread, A read from
// shared memory as float4 broadcasts), and in the last pass each group
// of rows is stored (streaming stores: out is written once) as soon as
// it is summed, so the stores leave while the later rows are computed
// instead of after them all. Every element of W is read from
// device memory once per block row of ROWS outputs (one block row covers
// M <= 32) and every output element is written once. ROWS is a template
// parameter (1, 4, 8, 16 or 32), so the M = 1 and small-batch calls do
// not pay for 32 accumulators. Since P is a multiple of COLS, a vector
// never straddles the end of P, and the ragged edge is masked by whole
// vectors. Blocks of 128 threads: 243 blocks at the main shape, about two
// per SM of the 132.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 128;  // column vectors of W per block
constexpr int kNB = 32;        // rows of W per pass
constexpr int kRG = 8;         // output rows summed together

// one vector of W, which is read once: not kept in L1, and L2 asked to
// fetch the 256 bytes around it
template <typename V>
__device__ __forceinline__ V load_once(const void* p) {
  V v;
  if constexpr (sizeof(V) == 8) {
    uint32_t* u = reinterpret_cast<uint32_t*>(&v);
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v2.u32 {%0, %1}, [%2];\n"
        : "=r"(u[0]), "=r"(u[1])
        : "l"(p));
  } else if constexpr (sizeof(V) == 4) {
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.u32 %0, [%1];\n"
                 : "=r"(*reinterpret_cast<uint32_t*>(&v))
                 : "l"(p));
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.u16 %0, [%1];\n"
                 : "=h"(*reinterpret_cast<unsigned short*>(&v))
                 : "l"(p));
  }
  return v;
}

// one vector of out, written once: a streaming (evict-first) store
template <int COLS>
__device__ __forceinline__ void store_out(float* p, const float* f) {
  typename Vec<float, COLS>::type v;
  float* q = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int c = 0; c < COLS; ++c) q[c] = f[c];
  __stcs(reinterpret_cast<typename Vec<float, COLS>::type*>(p), v);
}

template <int COLS>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* f) {
  typename Vec<__nv_bfloat16, COLS>::type v;
  __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int c = 0; c < COLS; ++c) q[c] = __float2bfloat16(f[c]);
  __stcs(reinterpret_cast<typename Vec<__nv_bfloat16, COLS>::type*>(p), v);
}

template <int ROWS, int COLS, typename T>
__global__ void __launch_bounds__(kThreads, 1)
graph_mix_kernel(const float* __restrict__ A, const T* __restrict__ W,
                 T* __restrict__ out, int M, int N, int64_t P) {
  using V = typename Vec<T, COLS>::type;
  __shared__ __align__(16) float a_s[ROWS][kNB];

  const int64_t col =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * COLS;
  const bool live = col < P;
  const int row0 = blockIdx.y * ROWS;

  float acc[ROWS][COLS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[r][c] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kNB) {
    const int nb = min(kNB, N - n0);
    const bool last = n0 + kNB >= N;
    // this pass's panel of A, A[row0:row0+ROWS, n0:n0+nb], asked for
    // first (rows past M and entries past nb are zero), then its rows of
    // W, all in flight before the barrier below; rows past nb are zero
    constexpr int kA = (ROWS * kNB + kThreads - 1) / kThreads;
    float a_reg[kA];
#pragma unroll
    for (int k = 0; k < kA; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / kNB;
      const int n = i - r * kNB;
      a_reg[k] = (i < ROWS * kNB && row0 + r < M && n < nb)
                     ? __ldg(A + static_cast<int64_t>(row0 + r) * N + n0 + n)
                     : 0.0f;
    }
    V w[kNB];
    const T* w_col = W + static_cast<int64_t>(n0) * P + col;
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      if (live && n < nb)
        w[n] = load_once<V>(w_col + static_cast<int64_t>(n) * P);
      else
        w[n] = V{};
    }
    if (n0 > 0) __syncthreads();  // the previous pass has read a_s
#pragma unroll
    for (int k = 0; k < kA; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < ROWS * kNB) a_s[i / kNB][i % kNB] = a_reg[k];
    }
    __syncthreads();
    float wf[kNB][COLS];
#pragma unroll
    for (int n = 0; n < kNB; ++n) widen<COLS>(w[n], wf[n]);
    // kRG output rows at a time (kRG * COLS independent sums), each group
    // stored in the last pass as soon as it is summed, so the stores
    // leave while the later groups are computed
    constexpr int RG = ROWS < kRG ? ROWS : kRG;
#pragma unroll
    for (int r0 = 0; r0 < ROWS; r0 += RG) {
      if (row0 + r0 >= M) break;
#pragma unroll
      for (int g = 0; g < kNB; g += 4) {
        if (g >= nb) break;
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(&a_s[r0 + rr][g]);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < COLS; ++c)
              acc[r0 + rr][c] = fmaf(av[j], wf[g + j][c], acc[r0 + rr][c]);
        }
      }
      if (last && live) {
#pragma unroll
        for (int rr = 0; rr < RG; ++rr)
          if (row0 + r0 + rr < M)
            store_out<COLS>(
                out + static_cast<int64_t>(row0 + r0 + rr) * P + col,
                acc[r0 + rr]);
      }
    }
  }
}

template <int ROWS, int COLS, typename T>
cudaError_t launch(const float* A, const T* W, T* out, int M, int N,
                   int64_t P, cudaStream_t stream) {
  const int64_t vecs = (P + COLS - 1) / COLS;
  const dim3 grid(static_cast<unsigned>((vecs + kThreads - 1) / kThreads),
                  static_cast<unsigned>((M + ROWS - 1) / ROWS));
  graph_mix_kernel<ROWS, COLS, T>
      <<<grid, kThreads, 0, stream>>>(A, W, out, M, N, P);
  return cudaGetLastError();
}

template <int COLS, typename T>
cudaError_t launch_rows(const float* A, const T* W, T* out, int M, int N,
                        int64_t P, cudaStream_t s) {
  if (M <= 1) return launch<1, COLS, T>(A, W, out, M, N, P, s);
  if (M <= 4) return launch<4, COLS, T>(A, W, out, M, N, P, s);
  if (M <= 8) return launch<8, COLS, T>(A, W, out, M, N, P, s);
  if (M <= 16) return launch<16, COLS, T>(A, W, out, M, N, P, s);
  return launch<32, COLS, T>(A, W, out, M, N, P, s);
}

template <typename T>
cudaError_t dispatch(const void* A, const void* W, void* out, int M, int N,
                     int64_t P, int cols, int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* a = static_cast<const float*>(A);
  const T* w = static_cast<const T*>(W);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the wrapper guarantees P % cols == 0 and cols * sizeof(T)-aligned
  // rows of W and out
  switch (cols) {
    case 2:
      return launch_rows<2, T>(a, w, o, M, N, P, s);
    case 1:
      return launch_rows<1, T>(a, w, o, M, N, P, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points, bound with ctypes. A is (M, N) fp32, W is (N, P) and
// out is (M, P) in W's dtype, all contiguous on `device`; `cols` (2 or 1)
// divides P, and W's and out's base addresses are aligned to
// cols * sizeof(element). The launch goes on `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int graph_mix_f32(const void* A, const void* W, void* out, int M,
                             int N, long long P, int cols, int device,
                             void* stream) {
  return static_cast<int>(
      dispatch<float>(A, W, out, M, N, P, cols, device, stream));
}

extern "C" int graph_mix_bf16(const void* A, const void* W, void* out, int M,
                              int N, long long P, int cols, int device,
                              void* stream) {
  return static_cast<int>(
      dispatch<__nv_bfloat16>(A, W, out, M, N, P, cols, device, stream));
}

extern "C" const char* graph_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
