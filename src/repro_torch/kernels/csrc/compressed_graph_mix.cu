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
// Hopper the grid is parallel over P tiles of kTile columns and nothing
// densified ever reaches device memory. A tile needs only its own entries
// of each client, in payload order (duplicates add in that order); no
// total order. So the op is two launches on one stream:
//
// 1. compressed_graph_mix_bucket_kernel groups each payload row by tile,
//    stably. A block of kBucketWarps warps owns one row and a window of
//    kWindow tiles (one window covers P <= kWindow * kTile = 65,536: the
//    main shape's 243 tiles; a larger P takes more windows, each reading
//    the row again); warp w owns the w-th contiguous run of 32-entry
//    steps of the row. A count walk counts each warp's entries per tile
//    in shared memory; a scan turns the counts into each warp's start in
//    each tile's bucket, and the tiles' starts into the (N, T + 1) int32
//    offset table (T = ceil(P / kTile); entries of earlier windows
//    counted first); a second walk, in the same order, puts each entry at
//    its start plus its rank among the step's entries of its tile
//    (match_key: the lanes with an equal key, from one warp ballot per
//    key bit). Payload order is kept: warps own consecutive runs, steps
//    go in order, ranks follow lanes. The window's entries are put in
//    shared memory (up to kStageMax of them) and written out in order, so
//    the row leaves in whole lines, not one scattered word per entry
//    through the row's one SM. Pads and indices outside [0, P) are
//    dropped; the row's tail behind its last bucket is filled with
//    (0, -1). One block per row (32 blocks at N = 32, no cross-block
//    pass): the pass is two reads of a 50 KB row and a few dependent
//    round trips, latency and not throughput, and the rows' blocks run
//    at once.
// 2. compressed_graph_mix_kernel, the mix: a block owns one tile of kTile
//    columns and up to kRows output rows, keeps one fp32 accumulator per
//    row in registers, and stages A in shared memory kChunk clients at a
//    time. Each client's bucket is [offsets[n, t], offsets[n, t + 1]):
//    two loads where the sorted layout took two binary searches. Each of
//    the kWarps warps densifies kChunk / kWarps clients into their
//    shared-memory rows, all of their first 32-entry steps loaded before
//    the first is added; in a step, match_key groups equal columns, and
//    the lowest lane of a group adds the group's values to the row in
//    lane order; steps go in order. So every column's duplicates add in
//    payload order (from 0.0) with no atomics: a repeated call gives the
//    same bits. Then every thread adds A[m, n] * row[col] to its
//    accumulators, client by client in order, and the sums leave by
//    streaming stores (out is written once).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;   // output columns per mix block, one per thread
constexpr int kRows = 32;    // output rows per mix block (grid.y covers M)
constexpr int kChunk = 32;   // clients densified per pass of the mix
constexpr int kWarps = kTile / 32;         // warps of a mix block
constexpr int kPerWarp = kChunk / kWarps;  // clients a warp densifies
constexpr int kBucketWarps = 32;           // warps of a bucketing block
constexpr int kWindow = 256;   // tiles one bucketing block counts
constexpr int kAhead = 8;      // steps a bucketing warp loads at once
// entries of a window staged in shared memory (8 bytes each) before they
// are written out; a window with more is written to device memory
// directly (227 KB a block, less the 33 KB of static shared memory)
constexpr int kStageMax = 24 * 1024;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWindow < 511 && kTile < 511,
              "match_key's 9 bits hold a window's tile and a tile's column");

// the lanes of the warp whose key equals this lane's, for keys in
// [-1, 256): one ballot per bit of the key's low 9 bits (-1 is 511).
// __match_any_sync gives the same mask; the ballots were chosen after it
// read slower on the H100 in variant runs whose script is not kept
// (PERF.md §6)
__device__ __forceinline__ unsigned match_key(int key) {
  const unsigned k = static_cast<unsigned>(key) & 0x1ffu;
  unsigned group = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const unsigned bit = (k >> b) & 1u;
    const unsigned ones = __ballot_sync(kFull, bit);
    group &= bit ? ones : ~ones;
  }
  return group;
}

// entry e of a payload row: its tile relative to the window [t0, t0 + tw),
// or -1 (pad, outside [0, P), another window, or past K); `below` counts
// the valid entries of earlier windows
__device__ __forceinline__ int window_tile(int32_t j, int64_t P, int t0,
                                           int tw, int& below) {
  if (j < 0 || j >= P) return -1;
  const int t = j / kTile;
  if (t < t0) {
    ++below;
    return -1;
  }
  return t < t0 + tw ? t - t0 : -1;
}

// (..., 1): under the block size alone ptxas capped this kernel at 32
// registers (two blocks an SM) and spilled
__global__ void __launch_bounds__(kBucketWarps * 32, 1)
compressed_graph_mix_bucket_kernel(const float* __restrict__ vals,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ bvals,
                                   int32_t* __restrict__ bidx,
                                   int32_t* __restrict__ offsets, int K,
                                   int64_t P, int T, int stage_cap) {
  __shared__ int cursor_s[kBucketWarps][kWindow];  // counts, then starts
  __shared__ int warp_sum_s[kBucketWarps];
  __shared__ int below_s;  // valid entries of earlier windows
  __shared__ int end_s;    // one past this window's last entry
  __shared__ int valid_s;  // the row's valid entries (last window only)
  extern __shared__ __align__(16) unsigned char stage_raw[];
  float* stage_v = reinterpret_cast<float*>(stage_raw);
  int32_t* stage_j = reinterpret_cast<int32_t*>(stage_raw) + stage_cap;
  const int n = blockIdx.x;
  const int t0 = blockIdx.y * kWindow;
  const int tw = min(kWindow, T - t0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const unsigned lanes_below = (1u << lane) - 1;
  const int64_t row = static_cast<int64_t>(n) * K;
  // warp w walks steps [w * steps, (w + 1) * steps) of the row's
  // ceil(K / 32) 32-entry steps
  const int steps = ((K + 31) / 32 + kBucketWarps - 1) / kBucketWarps;
  const int e0 = warp * steps * 32 + lane;

  for (int i = threadIdx.x; i < kBucketWarps * kWindow; i += blockDim.x)
    (&cursor_s[0][0])[i] = 0;
  if (threadIdx.x == 0) {
    below_s = 0;
    valid_s = K;
  }
  __syncthreads();

  // 1. count each warp's entries per tile (integer atomics: a count does
  // not depend on their order)
  int below = 0;
  for (int s0 = 0; s0 < steps; s0 += kAhead) {
    int32_t j[kAhead];
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int e = e0 + (s0 + s) * 32;
      j[s] = (s0 + s < steps && e < K) ? idx[row + e] : -1;
    }
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      if (s0 + s >= steps) break;
      const int t = window_tile(j[s], P, t0, tw, below);
      if (t >= 0) atomicAdd(&cursor_s[warp][t], 1);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) below += __shfl_xor_sync(kFull, below, o);
  if (lane == 0 && below) atomicAdd(&below_s, below);
  __syncthreads();

  // 2. scan: thread t < kWindow takes tile t; its warps' counts become
  // their starts within the tile's bucket, then the tiles' totals are
  // scanned across the block (8 warps of 32 tiles)
  int total = 0;
  if (threadIdx.x < kWindow) {
    for (int w = 0; w < kBucketWarps; ++w) {
      const int c = cursor_s[w][threadIdx.x];
      cursor_s[w][threadIdx.x] = total;
      total += c;
    }
  }
  int incl = total;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum_s[warp] = incl;
  __syncthreads();
  if (threadIdx.x < kWindow) {
    const int t = threadIdx.x;
    int start = below_s + incl - total;
    for (int w = 0; w < warp; ++w) start += warp_sum_s[w];
    for (int w = 0; w < kBucketWarps; ++w) cursor_s[w][t] += start;
    int32_t* off = offsets + static_cast<int64_t>(n) * (T + 1) + t0;
    if (t < tw) off[t] = start;
    if (t == tw - 1) {
      end_s = start + total;
      if (t0 + tw == T) {  // the last window closes the row
        off[tw] = start + total;
        valid_s = start + total;
      }
    }
  }
  __syncthreads();
  for (int e = valid_s + threadIdx.x; e < K; e += blockDim.x) {
    bvals[row + e] = 0.0f;  // the tail behind the last bucket
    bidx[row + e] = -1;
  }
  // the window's entries fill [below_s, end_s) of the row: sorted in
  // shared memory and written out in order where they fit
  const int first = below_s;
  const bool staged = end_s - first <= stage_cap;

  // 3. scatter, walking the entries as the count did
  int unused = 0;
  for (int s0 = 0; s0 < steps; s0 += kAhead) {
    int32_t j[kAhead];
    float v[kAhead];
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      const int e = e0 + (s0 + s) * 32;
      const bool in = s0 + s < steps && e < K;
      j[s] = in ? idx[row + e] : -1;
      v[s] = in ? vals[row + e] : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kAhead; ++s) {
      if (s0 + s >= steps) break;
      const int t = window_tile(j[s], P, t0, tw, unused);
      const unsigned group = match_key(t);
      if (t >= 0) {
        const int at = cursor_s[warp][t] + __popc(group & lanes_below);
        if (staged) {
          stage_v[at - first] = v[s];
          stage_j[at - first] = j[s];
        } else {
          bvals[row + at] = v[s];
          bidx[row + at] = j[s];
        }
      }
      __syncwarp();
      if (t >= 0 && (group & lanes_below) == 0)
        cursor_s[warp][t] += __popc(group);
      __syncwarp();
    }
  }
  if (staged) {
    __syncthreads();
    for (int e = threadIdx.x; e < end_s - first; e += blockDim.x) {
      bvals[row + first + e] = stage_v[e];
      bidx[row + first + e] = stage_j[e];
    }
  }
}

// one 32-entry step of a bucket into a shared-memory row of kTile
// columns: `col` is the entry's column within the tile, -1 for none
__device__ __forceinline__ void add_step(float* row, int col, float v,
                                         float* v_s, int lane) {
  const unsigned group = match_key(col);
  v_s[lane] = v;
  __syncwarp();
  if (col >= 0 && (group & ((1u << lane) - 1)) == 0) {
    float s = row[col];
    for (unsigned g = group; g; g &= g - 1) s += v_s[__ffs(g) - 1];
    row[col] = s;
  }
  __syncwarp();
}

// (..., 1): under the block size alone ptxas capped this kernel at 80
// registers and spilled
__global__ void __launch_bounds__(kTile, 1)
compressed_graph_mix_kernel(const float* __restrict__ A,
                            const float* __restrict__ bvals,
                            const int32_t* __restrict__ bidx,
                            const int32_t* __restrict__ offsets,
                            float* __restrict__ out, int M, int N, int K,
                            int64_t P, int T) {
  __shared__ __align__(16) float a_s[kRows][kChunk];
  __shared__ float rows_s[kChunk][kTile];
  __shared__ float v_s[kWarps][32];
  const int t = blockIdx.x;
  const int64_t p0 = static_cast<int64_t>(t) * kTile;
  const int64_t col = p0 + threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;

  for (int n0 = 0; n0 < N; n0 += kChunk) {
    const int nc = min(kChunk, N - n0);
    // the bucket bounds of the warp's clients warp + q * kWarps: lane
    // 2q + side loads offsets[n, t + side]
    int bound = 0;
    if (lane < 2 * kPerWarp) {
      const int c = warp + (lane / 2) * kWarps;
      if (c < nc)
        bound = offsets[static_cast<int64_t>(n0 + c) * (T + 1) + t +
                        lane % 2];
    }
    // A[row0:row0+kRows, n0:n0+nc] (zero elsewhere), asked for meanwhile
    constexpr int kA = kRows * kChunk / kTile;
    float a_reg[kA];
#pragma unroll
    for (int k = 0; k < kA; ++k) {
      const int i = threadIdx.x + k * kTile;
      const int r = i / kChunk;
      const int c = i % kChunk;
      a_reg[k] = (row0 + r < M && c < nc)
                     ? __ldg(A + static_cast<int64_t>(row0 + r) * N + n0 + c)
                     : 0.0f;
    }
    // the first step of each of the warp's buckets, all in flight
    int lo[kPerWarp], hi[kPerWarp], cj[kPerWarp];
    float cv[kPerWarp];
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      lo[q] = __shfl_sync(kFull, bound, 2 * q);
      hi[q] = __shfl_sync(kFull, bound, 2 * q + 1);
      const int64_t base =
          static_cast<int64_t>(n0 + warp + q * kWarps) * K;
      const int e = lo[q] + lane;
      cj[q] = e < hi[q] ? bidx[base + e] - static_cast<int>(p0) : -1;
      cv[q] = e < hi[q] ? bvals[base + e] : 0.0f;
    }
    if (n0 > 0) __syncthreads();  // the previous pass has read a_s, rows_s
#pragma unroll
    for (int k = 0; k < kA; ++k) {
      const int i = threadIdx.x + k * kTile;
      a_s[i / kChunk][i % kChunk] = a_reg[k];
    }
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      float* row = rows_s[warp + q * kWarps];
      for (int i = lane; i < kTile; i += 32) row[i] = 0.0f;
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kPerWarp; ++q) {
      float* row = rows_s[warp + q * kWarps];
      add_step(row, cj[q], cv[q], v_s[warp], lane);
      // the rest of a bucket longer than one step, in order
      const int64_t base =
          static_cast<int64_t>(n0 + warp + q * kWarps) * K;
      for (int e0 = lo[q] + 32; e0 < hi[q]; e0 += 32) {
        const int e = e0 + lane;
        const int j = e < hi[q] ? bidx[base + e] - static_cast<int>(p0) : -1;
        const float v = e < hi[q] ? bvals[base + e] : 0.0f;
        add_step(row, j, v, v_s[warp], lane);
      }
    }
    __syncthreads();
    for (int c = 0; c < nc; c += 4) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = rows_s[c + k][threadIdx.x];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 a4 = *reinterpret_cast<const float4*>(&a_s[r][c]);
        acc[r] = fmaf(a4.x, v[0], acc[r]);
        acc[r] = fmaf(a4.y, v[1], acc[r]);
        acc[r] = fmaf(a4.z, v[2], acc[r]);
        acc[r] = fmaf(a4.w, v[3], acc[r]);
      }
    }
  }

  if (col < P) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (row0 + r < M)
        __stcs(out + static_cast<int64_t>(row0 + r) * P + col, acc[r]);
    }
  }
}

}  // namespace

// C entry points, bound with ctypes; each launch goes on `stream` and
// returns cudaGetLastError() after it.
//
// The bucketing pass: vals (N, K) fp32 and idx (N, K) int32 as the codec
// emits them; writes bvals (N, K) and bidx (N, K), each row's valid
// entries grouped by kTile-column tile in payload order and its tail
// (0, -1), and offsets (N, T + 1) int32, T = ceil(P / kTile): tile t of
// row n is bvals[n, offsets[n, t]:offsets[n, t + 1]]. All contiguous on
// `device`.
extern "C" int compressed_graph_mix_bucket(const void* vals, const void* idx,
                                           void* bvals, void* bidx,
                                           void* offsets, int N, int K,
                                           long long P, int device,
                                           void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long T = (P + kTile - 1) / kTile;
  const long long windows = (T + kWindow - 1) / kWindow;
  if (T >= (1LL << 31) - 1 || windows > 65535) return cudaErrorInvalidValue;
  // a window's entries are staged in shared memory when they fit
  const int cap = K < kStageMax ? K : kStageMax;
  const size_t smem = static_cast<size_t>(cap) * 8;
  err = cudaFuncSetAttribute(compressed_graph_mix_bucket_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(N), static_cast<unsigned>(windows));
  compressed_graph_mix_bucket_kernel<<<grid, kBucketWarps * 32, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(idx),
      static_cast<float*>(bvals), static_cast<int32_t*>(bidx),
      static_cast<int32_t*>(offsets), K, P, static_cast<int>(T), cap);
  return static_cast<int>(cudaGetLastError());
}

// The mix: A (M, N) fp32; bvals, bidx and offsets as the bucketing pass
// wrote them; out (M, P) fp32. All contiguous on `device`.
extern "C" int compressed_graph_mix_f32(const void* A, const void* bvals,
                                        const void* bidx, const void* offsets,
                                        void* out, int M, int N, int K,
                                        long long P, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long T = (P + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(T),
                  static_cast<unsigned>((M + kRows - 1) / kRows));
  compressed_graph_mix_kernel<<<grid, kTile, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(bvals),
      static_cast<const int32_t*>(bidx),
      static_cast<const int32_t*>(offsets), static_cast<float*>(out), M, N,
      K, P, static_cast<int>(T));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* compressed_graph_mix_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
