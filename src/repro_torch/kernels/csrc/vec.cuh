// vec.cuh: the vector types of one row segment and their widening to
// fp32, shared by the column-parallel mixes (graph_mix.cu,
// sparse_graph_mix.cu).
//
// A thread owns COLS (2 or 1) adjacent columns of a row of fp32 or bf16
// and moves them as one vector: 8 or 4 bytes in fp32, 4 or 2 in bf16.
// The wrappers pick COLS from P and the base addresses
// (graph_mix.py::vector_width), so a vector never straddles a row end
// and every row start is aligned to it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// COLS consecutive elements of type T, loaded as one vector
template <typename T, int COLS>
struct Vec;
template <>
struct Vec<float, 2> {
  using type = float2;
};
template <>
struct Vec<float, 1> {
  using type = float;
};
template <>
struct Vec<__nv_bfloat16, 2> {
  using type = uint32_t;
};
template <>
struct Vec<__nv_bfloat16, 1> {
  using type = unsigned short;
};

// the COLS values of a vector as fp32
template <int COLS, typename V>
__device__ __forceinline__ void widen(const V& v, float* f) {
  static_assert(sizeof(V) == COLS * 4 || sizeof(V) * 2 == COLS * 4,
                "vector size");
  if constexpr (sizeof(V) == COLS * 4) {  // fp32
    const float* p = reinterpret_cast<const float*>(&v);
#pragma unroll
    for (int c = 0; c < COLS; ++c) f[c] = p[c];
  } else {  // bf16: the high half of an fp32 word
    const unsigned short* p = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      f[c] = __uint_as_float(static_cast<uint32_t>(p[c]) << 16);
  }
}

}  // namespace
