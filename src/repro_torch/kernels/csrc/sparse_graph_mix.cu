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
// parallel over (clients, P tiles), clients on x, so the blocks of one P
// tile are launched one after another and the peer rows they gather are
// read from HBM once and from L2 after (a block's place in the grid is
// only its launch order: at N = 32 the whole table sits in L2 anyway;
// the order matters at the large N the sparse path exists for). y covers
// the tiles with a stride, so any P fits the grid (the wrapper's
// sparse_graph_mix.py::launch_grid). A block owns kThreads * kVecs vectors
// of one output row; a thread kVecs vectors kThreads apart, each COLS
// (2 or 1) adjacent columns moved as one load, float2 (two bf16 in one
// word) where P is even and every base address is aligned to it
// (graph_mix.py::vector_width), else one column. A block first asks for
// its self row, then stages its row's slot offsets (clamped to [0, N), as
// the Pallas wrapper does) and weights (0 for an empty slot) in shared
// memory, kChunk slots at a time, so any B works, B > N and B = 0
// included; then issues the loads of up to kSlots peer rows into
// registers before its first FMA, so a thread makes one round trip to
// memory per kSlots slots, not one per slot. kSlots is 4, the main path's
// budget: 8 holds more registers, which cost resident blocks. All loads
// are cacheable (a row is the self row of one client and a peer row of up
// to B others), and the output is written with plain stores: kSlots 8,
// L1-bypassing self loads and streaming stores each read slower on the
// H100 in variant runs whose script is not kept (PERF.md §6). The sum
// starts from self_w[n] * W_self[n, col] and adds the slots in order
// b = 0..B-1 with fmaf: a fixed order, so a repeated call gives the same
// bits. No (N, B, P) intermediate exists.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kVecs = 2;       // vectors per thread, kThreads apart
constexpr int kSlots = 4;      // peer rows a thread has in flight
constexpr int kChunk = 64;     // slots staged in shared memory per pass
static_assert(kChunk % kSlots == 0, "a pass holds whole groups of slots");

// one vector of out, from its COLS fp32 sums (a plain store)
template <int COLS>
__device__ __forceinline__ void store_out(float* p, const float* f) {
  typename Vec<float, COLS>::type v;
  float* q = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int c = 0; c < COLS; ++c) q[c] = f[c];
  *reinterpret_cast<typename Vec<float, COLS>::type*>(p) = v;
}

template <int COLS>
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* f) {
  typename Vec<__nv_bfloat16, COLS>::type v;
  __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int c = 0; c < COLS; ++c) q[c] = __float2bfloat16(f[c]);
  *reinterpret_cast<typename Vec<__nv_bfloat16, COLS>::type*>(p) = v;
}

template <int COLS, typename T>
__global__ void __launch_bounds__(kThreads)
sparse_graph_mix_kernel(const float* __restrict__ self_w,
                        const float* __restrict__ nbr_w,
                        const int32_t* __restrict__ nbr_idx,
                        const T* __restrict__ W_self,
                        const T* __restrict__ W_peers, T* __restrict__ out,
                        int N, int B, int64_t P) {
  using V = typename Vec<T, COLS>::type;
  __shared__ int64_t row_s[kChunk];  // element offset of each slot's row
  __shared__ float w_s[kChunk];
  const int n = blockIdx.x;
  const int64_t self_row = static_cast<int64_t>(n) * P;
  const int64_t span = static_cast<int64_t>(kThreads) * kVecs * COLS;
  const int64_t tiles = (P + span - 1) / span;
  const float sw = self_w[n];

  for (int64_t tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    int64_t col[kVecs];
    bool live[kVecs];
    V self[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      col[k] = tile * span + (k * kThreads + threadIdx.x) * COLS;
      live[k] = col[k] < P;  // P % COLS == 0: a live vector is whole
      self[k] = live[k] ? __ldg(reinterpret_cast<const V*>(
                              W_self + self_row + col[k]))
                        : V{};
    }
    float acc[kVecs][COLS];
    for (int b0 = 0; b0 < B; b0 += kChunk) {
      const int bc = min(kChunk, B - b0);
      __syncthreads();  // the previous pass has read row_s and w_s
      for (int i = threadIdx.x; i < bc; i += kThreads) {
        const int64_t at = static_cast<int64_t>(n) * B + b0 + i;
        const int j = nbr_idx[at];
        const int safe = j < 0 ? 0 : (j >= N ? N - 1 : j);
        row_s[i] = static_cast<int64_t>(safe) * P;
        w_s[i] = j >= 0 ? nbr_w[at] : 0.0f;
      }
      __syncthreads();
      for (int g = 0; g < bc; g += kSlots) {
        // every load of this group in flight before the first FMA
        V peer[kSlots][kVecs];
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
#pragma unroll
          for (int k = 0; k < kVecs; ++k) {
            peer[s][k] = (g + s < bc && live[k])
                             ? __ldg(reinterpret_cast<const V*>(
                                   W_peers + row_s[g + s] + col[k]))
                             : V{};
          }
        }
        if (b0 == 0 && g == 0) {
#pragma unroll
          for (int k = 0; k < kVecs; ++k) {
            widen<COLS>(self[k], acc[k]);
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[k][c] = sw * acc[k][c];
          }
        }
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (g + s >= bc) break;
          const float w = w_s[g + s];
#pragma unroll
          for (int k = 0; k < kVecs; ++k) {
            float f[COLS];
            widen<COLS>(peer[s][k], f);
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[k][c] = fmaf(w, f[c], acc[k][c]);
          }
        }
      }
    }
    if (B == 0) {  // no slots: the self term alone
#pragma unroll
      for (int k = 0; k < kVecs; ++k) {
        widen<COLS>(self[k], acc[k]);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[k][c] = sw * acc[k][c];
      }
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      if (live[k]) store_out<COLS>(out + self_row + col[k], acc[k]);
    }
  }
}

template <int COLS, typename T>
cudaError_t launch(const void* self_w, const void* nbr_w, const void* nbr_idx,
                   const void* W_self, const void* W_peers, void* out, int N,
                   int B, int64_t P, int grid_y, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(N), static_cast<unsigned>(grid_y));
  sparse_graph_mix_kernel<COLS, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(self_w), static_cast<const float*>(nbr_w),
      static_cast<const int32_t*>(nbr_idx), static_cast<const T*>(W_self),
      static_cast<const T*>(W_peers), static_cast<T*>(out), N, B, P);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* self_w, const void* nbr_w,
                     const void* nbr_idx, const void* W_self,
                     const void* W_peers, void* out, int N, int B, int64_t P,
                     int cols, int grid_y, int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (grid_y < 1 || grid_y > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the wrapper guarantees P % cols == 0 and cols * sizeof(T)-aligned
  // W_self, W_peers and out
  switch (cols) {
    case 2:
      return launch<2, T>(self_w, nbr_w, nbr_idx, W_self, W_peers, out, N, B,
                          P, grid_y, s);
    case 1:
      return launch<1, T>(self_w, nbr_w, nbr_idx, W_self, W_peers, out, N, B,
                          P, grid_y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points, bound with ctypes. self_w is (N,) fp32, nbr_w (N, B)
// fp32, nbr_idx (N, B) int32, W_self, W_peers and out (N, P) in one
// dtype, all contiguous on `device`; `cols` (2 or 1) divides P and
// W_self's, W_peers' and out's base addresses are aligned to
// cols * sizeof(element); the grid is (N, grid_y), grid_y in [1, 65535]
// (sparse_graph_mix.py::launch_grid). The launch goes on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int sparse_graph_mix_f32(const void* self_w, const void* nbr_w,
                                    const void* nbr_idx, const void* W_self,
                                    const void* W_peers, void* out, int N,
                                    int B, long long P, int cols, int grid_y,
                                    int device, void* stream) {
  return static_cast<int>(dispatch<float>(self_w, nbr_w, nbr_idx, W_self,
                                          W_peers, out, N, B, P, cols, grid_y,
                                          device, stream));
}

extern "C" int sparse_graph_mix_bf16(const void* self_w, const void* nbr_w,
                                     const void* nbr_idx, const void* W_self,
                                     const void* W_peers, void* out, int N,
                                     int B, long long P, int cols, int grid_y,
                                     int device, void* stream) {
  return static_cast<int>(dispatch<__nv_bfloat16>(
      self_w, nbr_w, nbr_idx, W_self, W_peers, out, N, B, P, cols, grid_y,
      device, stream));
}

extern "C" const char* sparse_graph_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
