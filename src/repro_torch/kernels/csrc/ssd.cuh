// What the forward (ssd.cu) and the backward (ssd_bwd.cu) of K5 share:
// the tile shapes and the cp.async copies that stage rows of x, B, C (and
// of the backward's dy) in shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // 4 warps: passes 1 and 3
constexpr int kPassThreads = 256;  // pass 2
constexpr int kT = 64;             // rows of a query or key tile
constexpr int kN = 128;            // state width n, padded (a multiple of 4)
constexpr int kCP = kN + 4;        // padded C / B row of a scores block
constexpr int kGP = kT + 4;        // padded row of a score tile
constexpr int kPassVals = 8;       // state values a thread carries in pass 2
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, of which the first `bytes` are
// read and the rest zero-filled (src 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes, or a zero when !in
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [0, kT) and columns [0, W) of a tile whose row r starts at
// src + r * rs, into dst at `pitch` floats a row; rows at or past `rows`
// and columns at or past `cols` are zero-filled. vec: 16-byte pieces (src
// and rs 16-byte aligned), else 4-byte ones.
template <int W>
__device__ __forceinline__ void load_tile(float* dst, int pitch,
                                          const float* src, int64_t rs,
                                          int rows, int cols, bool vec) {
  if (vec) {
    constexpr int kPieces = W / 4;
    for (int i = threadIdx.x; i < kT * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int c = (i - r * kPieces) * 4;
      const int left = r < rows ? min(4, cols - c) : 0;
      const int bytes = left > 0 ? 4 * left : 0;
      cp_async16(dst + r * pitch + c, bytes ? src + r * rs + c : src, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < kT * W; i += kThreads) {
      const int r = i / W;
      const int c = i - r * W;
      const bool in = r < rows && c < cols;
      cp_async4(dst + r * pitch + c, in ? src + r * rs + c : src, in);
    }
  }
}

}  // namespace
