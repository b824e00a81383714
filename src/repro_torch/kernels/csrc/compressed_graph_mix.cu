// compressed_graph_mix: out = A @ densify(vals, idx) for the top-k codec's
// Eq.-4 off-diagonal mix.
//
// Replaces the Pallas TPU kernel
// repro/kernels/compressed_graph_mix.py::compressed_graph_mix. A is the
// (M, N) mixing operator with its diagonal zeroed by the caller (the self
// term stays exact and is added outside), (vals, idx) the (N, K) top-k
// payloads of the clients' flattened parameters, K = ceil(frac * P).
// densify scatters row n's K values to the columns idx[n, :] of a P-wide
// row: duplicate indices add, and an idx outside [0, P) (the -1 pad) lands
// nowhere. Accumulates in IEEE fp32 (fmaf) and writes fp32.
//
// What bounds it: memory. The least traffic is one read of the payload
// (8 bytes per entry) and of A and one write of the (M, P) output: at
// (M, N, K, P) = (32, 32, 6201, 62006) that is 1.59 MB + 7.94 MB = 9.5 MB,
// 2.8 us at 3.35 TB/s, against 12.7 MFLOP (2*M*N*K), far below the ridge.
//
// What the design does about it: the Pallas kernel one-hot-expands each
// payload chunk against a resident output panel on a sequential grid; on
// Hopper the grid is parallel over P tiles and nothing densified ever
// reaches device memory. The wrapper first sorts each row's (idx, vals)
// by index with a stable sort (pads sort first). A block owns kTile
// columns and up to kRows output rows, keeps one fp32 accumulator per row
// in registers, and stages A in shared memory kChunk clients at a time.
// For the clients of a chunk it binary-searches, in parallel (two threads
// per client), each sorted row for the tile's range, so every payload
// entry is read by exactly one block. Then each of the block's kWarps
// warps densifies one client's range into its own shared-memory row (the
// first entry of each run of equal indices sums the run in payload order,
// so duplicates add in a fixed order), kWarps clients at once, and every
// thread adds A[m, n] * row[col] to its accumulators, client by client in
// order. No atomics: the result is the same from run to run. Merging the
// sort into the kernel, wider stores and tensor-core products are left
// for later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;   // output columns per block, one per thread
constexpr int kRows = 32;    // output rows per block (grid.y covers M)
constexpr int kChunk = 32;   // clients staged per pass (2*kChunk <= kTile)
constexpr int kWarps = kTile / 32;  // clients densified at once

// first position e in the sorted row with row[e] >= target
__device__ __forceinline__ int lower_bound(const int32_t* row, int K,
                                           int64_t target) {
  int lo = 0, hi = K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(row[mid]) < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kTile)
compressed_graph_mix_kernel(const float* __restrict__ A,
                            const float* __restrict__ vals,
                            const int32_t* __restrict__ idx,
                            float* __restrict__ out, int M, int N, int K,
                            int64_t P) {
  __shared__ float a_s[kRows][kChunk];
  __shared__ float rows_s[kWarps][kTile];
  __shared__ int seg_s[kChunk][2];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t col = p0 + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int nc = min(kChunk, N - n0);
    // stage A[row0:row0+kRows, n0:n0+nc] (zero elsewhere) and find each
    // client's range [lo, hi) of sorted entries inside this tile
    for (int i = threadIdx.x; i < kRows * kChunk; i += kTile) {
      const int r = i / kChunk;
      const int c = i % kChunk;
      a_s[r][c] = (row0 + r < M && c < nc)
                      ? A[static_cast<int64_t>(row0 + r) * N + n0 + c]
                      : 0.0f;
    }
    if (threadIdx.x < 2 * nc) {
      const int c = threadIdx.x >> 1;
      const int side = threadIdx.x & 1;
      seg_s[c][side] = lower_bound(idx + static_cast<int64_t>(n0 + c) * K, K,
                                   p0 + side * kTile);
    }

    for (int c0 = 0; c0 < nc; c0 += kWarps) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) rows_s[w][threadIdx.x] = 0.0f;
      __syncthreads();
      // warp w densifies client c0 + w of the chunk into rows_s[w]
      const int c = c0 + warp;
      if (c < nc) {
        const int64_t base = static_cast<int64_t>(n0 + c) * K;
        const int lo = seg_s[c][0];
        const int hi = seg_s[c][1];
        for (int e = lo + lane; e < hi; e += 32) {
          const int32_t j = idx[base + e];
          if (e == lo || idx[base + e - 1] != j) {
            float s = 0.0f;
            for (int f = e; f < hi && idx[base + f] == j; ++f) {
              s += vals[base + f];
            }
            rows_s[warp][j - p0] = s;
          }
        }
      }
      __syncthreads();
      const int cw = min(kWarps, nc - c0);
      for (int w = 0; w < cw; ++w) {
        const float v = rows_s[w][threadIdx.x];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r] = fmaf(a_s[r][c0 + w], v, acc[r]);
        }
      }
      __syncthreads();
    }
  }

  if (col < P) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r < M) out[static_cast<int64_t>(row0 + r) * P + col] = acc[r];
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. A is (M, N) fp32; vals (N, K) fp32 and
// idx (N, K) int32 hold each row's entries sorted by index; out is (M, P)
// fp32; all contiguous on `device`, and the launch goes on `stream`.
// Returns cudaGetLastError() after the launch.
extern "C" int compressed_graph_mix_f32(const void* A, const void* vals,
                                        const void* idx, void* out, int M,
                                        int N, int K, long long P, int device,
                                        void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((P + kTile - 1) / kTile),
                  static_cast<unsigned>((M + kRows - 1) / kRows));
  compressed_graph_mix_kernel<<<grid, kTile, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(vals),
      static_cast<const int32_t*>(idx), static_cast<float*>(out), M, N, K, P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* compressed_graph_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
