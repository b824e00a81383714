// rglru_scan_bwd: the backward of the RG-LRU recurrence
//   h_t = a_t * h_{t-1} + b_t   (rglru_scan.cu),
// for the training of every recurrent block of the hybrid family.
//
// The Pallas TPU kernel repro/kernels/rglru_scan.py::rglru_scan has no
// backward: `repro` differentiates its oracle (repro/models/rglru.py::
// linear_scan_ref). Given the forward's a, its output h, the optional h0
// and the gradients dy (of h) and dh_last (of h_last; null is zero), the
// kernel walks time backward:
//   g_{S-1} = dy_{S-1} + dh_last,   g_t = dy_t + a_{t+1} g_{t+1},
//   db_t = g_t,   da_t = g_t h_{t-1}   (h_{-1} = h0, or zeros),
//   dh0 = a_0 g_0.
// Each product is rounded, then each sum (__fmul_rn, __fadd_rn: no FMA
// contraction), as autograd rounds them through the plain version
// (kernels/ref.py::linear_scan_bwd_ref); every sum has two terms, so the
// order in which autograd adds them cannot differ, and the kernel matches
// the plain version bit for bit. a, h, dy, da and db are (B, S, W) float32,
// contiguous; h0, dh_last and dh0 (B, W).
//
// What bounds it: memory. Three flops per element against 20 bytes (read
// a, h and dy once, write da and db once): at the train shape of
// recurrentgemma-9b (B 4, S 512, W 4096) 167.8 MB, 0.050 ms at 3.35 TB/s.
//
// What the design does about it: the forward's, run backward in time. Each
// thread owns one channel (b, w) and carries g in a register; neighbouring
// threads own neighbouring w, so each load and store of a warp is 128
// contiguous bytes. A thread's steps depend on each other, its loads do
// not: it issues the loads of a_t, h_{t-1} and dy_t for the next kU = 32
// steps before it runs the current 32 (two register buffers), some 384
// bytes in flight a thread. Loads and stores are streaming (ld.global.cs,
// st.global.cs). h_{t-1} is read from the forward's saved output, one step
// behind; the first step's comes from h0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block, one per thread
constexpr int kU = 32;         // steps whose loads are issued together

// steps [t0, t0 + n) of one channel, n <= kU, into ra, rh and rd (a_t,
// h_{t-1} and dy_t at u = t - t0); h_{-1} is `first`
__device__ __forceinline__ void load_steps(const float* ap, const float* hp,
                                           const float* dp, int64_t W,
                                           int t0, int n, float first,
                                           float* ra, float* rh, float* rd) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (u < n) {
      const int64_t off = static_cast<int64_t>(t0 + u) * W;
      ra[u] = __ldcs(ap + off);
      rd[u] = __ldcs(dp + off);
      rh[u] = t0 + u > 0 ? __ldcs(hp + off - W) : first;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_scan_bwd_kernel(const float* __restrict__ a,
                      const float* __restrict__ h,
                      const float* __restrict__ h0,
                      const float* __restrict__ dy,
                      const float* __restrict__ dh_last,
                      float* __restrict__ da, float* __restrict__ db,
                      float* __restrict__ dh0, int S, int W, int64_t BW) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (c >= BW) return;
  const int64_t bi = c / W;
  const int64_t w = c - bi * W;
  const int64_t base = bi * S * W + w;  // element (bi, 0, w)
  const float* ap = a + base;
  const float* hp = h + base;
  const float* dp = dy + base;
  float* dap = da + base;
  float* dbp = db + base;
  const float first = h0 != nullptr ? h0[c] : 0.0f;
  // a_{t+1} g_{t+1}, or dh_last above the last step
  float carry = dh_last != nullptr ? dh_last[c] : 0.0f;
  const bool add_last = dh_last != nullptr;

  float ra[kU], rh[kU], rd[kU], na[kU], nh[kU], nd[kU];
  const int full = S / kU * kU;  // the steps of whole tiles
  const int rem = S - full;
  // the ragged top tile [full, S) first: time runs backward
  load_steps(ap, hp, dp, W, full, rem, first, ra, rh, rd);
#pragma unroll
  for (int u = kU - 1; u >= 0; --u) {
    if (u < rem) {
      const int t = full + u;
      const float g = (t == S - 1 && !add_last) ? rd[u]
                                                : __fadd_rn(rd[u], carry);
      const int64_t off = static_cast<int64_t>(t) * W;
      __stcs(dbp + off, g);
      __stcs(dap + off, __fmul_rn(g, rh[u]));
      carry = __fmul_rn(ra[u], g);
    }
  }
  if (full > 0) load_steps(ap, hp, dp, W, full - kU, kU, first, ra, rh, rd);
  for (int t0 = full - kU; t0 >= 0; t0 -= kU) {
    const bool more = t0 > 0;
    if (more)  // the next (earlier) tile's loads, in flight during this one
      load_steps(ap, hp, dp, W, t0 - kU, kU, first, na, nh, nd);
#pragma unroll
    for (int u = kU - 1; u >= 0; --u) {
      const int t = t0 + u;
      const float g = (t == S - 1 && !add_last) ? rd[u]
                                                : __fadd_rn(rd[u], carry);
      const int64_t off = static_cast<int64_t>(t) * W;
      __stcs(dbp + off, g);
      __stcs(dap + off, __fmul_rn(g, rh[u]));
      carry = __fmul_rn(ra[u], g);
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        ra[u] = na[u];
        rh[u] = nh[u];
        rd[u] = nd[u];
      }
    }
  }
  if (dh0 != nullptr) dh0[c] = carry;  // a_0 g_0
}

}  // namespace

// C entry point, bound with ctypes. a, h, dy, da and db are (B, S, W)
// float32, h0, dh_last and dh0 (B, W) float32, each of the three null
// where there is none (h0 and dh_last: zeros; dh0: not wanted), all
// contiguous on `device`. `blocks` is the grid the wrapper planned
// (rglru_scan.py::backward_blocks), checked against the kernel's own
// count. The launch goes on `stream`. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a grid the kernel does not take).
extern "C" int rglru_scan_bwd_f32(const void* a, const void* h,
                                  const void* h0, const void* dy,
                                  const void* dh_last, void* da, void* db,
                                  void* dh0, int B, int S, int W, int blocks,
                                  int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t BW = static_cast<int64_t>(B) * W;
  if (S < 1 || BW < 1 || blocks != (BW + kThreads - 1) / kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  rglru_scan_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(dy),
      static_cast<const float*>(dh_last), static_cast<float*>(da),
      static_cast<float*>(db), static_cast<float*>(dh0), S, W, BW);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
