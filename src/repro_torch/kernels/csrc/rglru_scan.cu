// rglru_scan: the RG-LRU first-order linear recurrence
//   h_t = a_t * h_{t-1} + b_t   over the time axis,
// for the prefill of every recurrent block of the hybrid family
// (RecurrentGemma / Griffin).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py::rglru_scan.
// a and b are (B, S, W) float32, contiguous; h0 (B, W) is optional
// (zeros). Outputs: h (B, S, W) and h_last (B, W), float32. Each step is
// the product, rounded, then the sum, rounded (__fmul_rn, __fadd_rn: no
// FMA contraction), in time order: the Pallas kernel's order and that of
// the plain version (kernels/ref.py::linear_scan_ref), which the kernel
// matches bit for bit. Any S >= 1 and W >= 1: the ragged tail of the
// channels is masked, and so is a last tile of fewer than kU steps.
// bf16 is refused by the wrapper: the model casts the scan's inputs to
// float32 (repro/models/rglru.py).
//
// What bounds it: memory. Two flops per element against 12 bytes (read a
// and b once, write h once): at the serve shape of recurrentgemma-9b
// (B 4, S 512, W 4096) 100.7 MB, 0.030 ms at 3.35 TB/s.
//
// What the design does about it: channels are independent and time is
// sequential, so each thread owns one channel (b, w) and walks its S steps
// with h in a register; neighbouring threads own neighbouring w, so each
// load and store of a warp is 128 contiguous bytes. There are only B * W
// channels (16,384 at the serve shape: 128 blocks of 128 threads, about
// one per SM), too few threads to hide the latency of device memory by
// occupancy, and a thread's steps depend on each other. Its loads do not:
// a thread issues the loads of a and b for the next kU = 32 steps before
// it runs the current 32 dependent steps (two register buffers), so each
// thread keeps 256 bytes in flight and the card some 4 MB, above what
// 3.35 TB/s times the latency of device memory asks for. Loads and stores
// are streaming (ld.global.cs, st.global.cs): every element is touched
// once. A chunked scan over time (local scans, a carry pass, a fix-up)
// would give a small B * W more parallelism at the price of a second pass
// over h; it is left for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block, one per thread
constexpr int kU = 32;         // steps whose loads are issued together

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int S, int W, int64_t BW) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= BW) return;
  const int64_t bi = c / W;
  const int64_t w = c - bi * W;
  const int64_t base = bi * S * W + w;  // element (bi, 0, w)
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float state = h0 != nullptr ? h0[c] : 0.0f;

  float ra[kU], rb[kU], na[kU], nb[kU];
  const int full = S / kU * kU;  // the steps of whole tiles
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      ra[u] = __ldcs(ap + static_cast<int64_t>(u) * W);
      rb[u] = __ldcs(bp + static_cast<int64_t>(u) * W);
    }
  }
  for (int t0 = 0; t0 < full; t0 += kU) {
    const bool more = t0 + kU < full;
    if (more) {  // the next tile's loads, in flight during this tile
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int64_t off = static_cast<int64_t>(t0 + kU + u) * W;
        na[u] = __ldcs(ap + off);
        nb[u] = __ldcs(bp + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      state = __fadd_rn(__fmul_rn(ra[u], state), rb[u]);
      __stcs(hp + static_cast<int64_t>(t0 + u) * W, state);
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        ra[u] = na[u];
        rb[u] = nb[u];
      }
    }
  }
  // the last S - full (< kU) steps
  const int rem = S - full;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (u < rem) {
      const int64_t off = static_cast<int64_t>(full + u) * W;
      ra[u] = __ldcs(ap + off);
      rb[u] = __ldcs(bp + off);
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (u < rem) {
      state = __fadd_rn(__fmul_rn(ra[u], state), rb[u]);
      __stcs(hp + static_cast<int64_t>(full + u) * W, state);
    }
  }
  h_last[c] = state;
}

}  // namespace

// C entry point, bound with ctypes. a, b and h are (B, S, W) float32,
// h0 (B, W) float32 or null (zeros), h_last (B, W) float32, all
// contiguous on `device`; the launch goes on `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int rglru_scan_f32(const void* a, const void* b, const void* h0,
                              void* h, void* h_last, int B, int S, int W,
                              int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t BW = static_cast<int64_t>(B) * W;
  const unsigned blocks = static_cast<unsigned>((BW + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h),
      static_cast<float*>(h_last), S, W, BW);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
