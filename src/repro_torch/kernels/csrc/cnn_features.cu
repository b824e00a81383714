// cnn_features: PaperCNN's convolution stack for G models at once,
//   conv1 -> + bias -> ReLU -> 2x2 max-pool -> conv2 -> + bias -> ReLU
//   -> 2x2 max-pool,
// writing each (model, image)'s features flattened in NHWC order, the
// (G, B, P2h * P2w * C2) rows that fc1's batched matmul reads.
//
// Replaces no TPU kernel: `repro` leaves PaperCNN's convolutions to XLA
// (repro/models/classifier.py `PaperCNN.features`). It was added for the
// GGC refresh's reward probes (fl/engine.py `make_reward_fn`), where the
// port ran the stack as grouped cuDNN convolutions, one group a model:
// 400 probe models of 50 validation images a call, 100 calls a round at
// the paper's size, and cuDNN's kernels at about 4 % of the fp32 rate.
// The models' inference forwards (grad mode off, or no parameter that
// needs a gradient) run through it; training keeps cuDNN's forward and
// backward (models/classifier.py).
//
// x is (G, B, H, W, CIN) fp32, each image contiguous (any stride
// between models and between images); conv1_w (G, 5, 5, CIN, C1) and
// conv2_w (G, 5, 5, C1, C2) in `repro`'s HWIO, biases (G, C1), (G, C2),
// each model's leaf contiguous (any stride between models: the greedy's
// probe rows are views of one (G, P) panel). IEEE fp32 FMAs on the CUDA
// cores, no TF32, no tensor cores. Each output is summed in one fixed
// order (conv1 over ky, kx, ci; conv2 over ky, ci, kx), by one thread,
// with no atomics, so a model's features are the same bits whatever G,
// B or the other models of the launch. Pooling floors as max_pool2d
// does. Pooling before the bias and the ReLU is exact: rounding a + b is
// monotone in a, so max_i relu(a_i + b) = relu(max_i a_i + b) bit for
// bit.
//
// What bounds it: operations. Per (model, image) at the cell's 32 x 32 x
// 3 input, conv1 is 28 * 28 * 6 * 75 = 352,800 multiply-adds and conv2
// 10 * 10 * 16 * 150 = 240,000: 1.186 MFLOP, 23.7 GFLOP a reward call of
// 400 models x 50 images, 0.354 ms at the H100's 67 TFLOP/s of fp32
// FFMA. The bytes are far less: the 246 MB of inputs, 4.6 MB of weights
// and 32 MB of features take 0.083 ms at 3.35 TB/s.
//
// What the design does about it: every operand of an FFMA comes from a
// register or a shared-memory broadcast, and the input is read from
// device memory once. A block owns one model and a tile of its images
// (cnn_features.py::launch_plan; 4 at the cell's size, the images spread
// evenly over the tiles), stages the model's weights (11.5 KB) and the
// tile's images in shared memory (16-byte loads where the images allow),
// and then runs the two convolutions out of shared memory, conv1's
// pooled maps staying there for conv2. A thread owns one pooled output
// pixel and all its channels in conv1, half of them in conv2 (two
// neighbouring threads a pixel, reading the same input words), and sums
// the four pre-pool positions in registers (4 * C1 or 4 * C2 / 2 sums),
// so a weight broadcast from shared memory (float4s) feeds 4 FFMAs a
// channel and an input value C1 or C2 / 2.
// conv1 keeps two input rows of the 6 x 6 patch in registers and slides
// them down the five kernel rows: each input value is read once a
// thread. The plan pads the staged rows and images so that consecutive
// threads read consecutive 8-byte words (conv1's 64-bit loads free of
// bank conflicts) and conv2's channel planes so that the 16 pixels of a
// warp's scalar loads fall on 16 distinct banks. 256 threads a block,
// two blocks an SM (up to 113 KB of shared memory and 128 registers a
// thread each). conv2 splits a pixel's channels over two threads
// because all C2 of them would be 64 sums a thread, which spill at 128
// registers, and would leave half the block's threads without a pixel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kK = 5;  // PaperCNN's kernels are 5 x 5

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

template <int CIN, int C1, int C2>
struct Shape {
  static constexpr int C1P = round4(C1);  // conv1's taps padded to float4s
  static constexpr int W1 = kK * kK * CIN * C1P;
  static constexpr int W2 = kK * kK * C1 * C2;
  // floats of the staged weights: w1 | b1 | w2 | b2, each 16-byte aligned
  static constexpr int WEIGHTS = W1 + C1P + W2 + C2;
  static_assert(C2 % 8 == 0, "conv2's halves are read as float4s");
};

// The plan of one launch (cnn_features.py::launch_plan), in floats.
struct Plan {
  int B, H, W;
  int tiles;  // blocks along the images of a model
  int rs;     // a staged input row
  int is;     // a staged input image
  int rs2;    // a row of a pooled conv1 plane
  int cs2;    // a pooled conv1 plane (one channel)
  int is2;    // a pooled conv1 image
  int vec;    // stage the images with float4 loads
};

template <int CIN>
__device__ __forceinline__ void load_row(const float* p,
                                         float (&r)[6 * CIN]) {
  // 6 columns of CIN channels, 8-byte aligned (the plan's even strides)
#pragma unroll
  for (int i = 0; i < 3 * CIN; ++i) {
    const float2 v = reinterpret_cast<const float2*>(p)[i];
    r[2 * i] = v.x;
    r[2 * i + 1] = v.y;
  }
}

// conv1 at the four positions of pooled pixel (py, px) of one image:
// `xi` is the staged image at row 2 py, column 2 px; writes the pooled,
// biased, rectified C1 channels into the CHW planes at `out`
template <int CIN, int C1, int C2>
__device__ __forceinline__ void conv1_pixel(const float* __restrict__ xi,
                                            int rs,
                                            const float* __restrict__ w1s,
                                            const float* __restrict__ b1s,
                                            float* __restrict__ out,
                                            int cs2) {
  using S = Shape<CIN, C1, C2>;
  float acc[4][C1];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < C1; ++c) acc[p][c] = 0.0f;
  float top[6 * CIN], bot[6 * CIN];
  load_row<CIN>(xi, top);
#pragma unroll 1
  for (int ky = 0; ky < kK; ++ky) {
    load_row<CIN>(xi + (ky + 1) * rs, bot);
    const float* wk = w1s + ky * kK * CIN * S::C1P;
#pragma unroll
    for (int kx = 0; kx < kK; ++kx) {
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        float w[S::C1P];
#pragma unroll
        for (int q = 0; q < S::C1P / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(
              wk + (kx * CIN + ci) * S::C1P)[q];
          w[4 * q] = v.x;
          w[4 * q + 1] = v.y;
          w[4 * q + 2] = v.z;
          w[4 * q + 3] = v.w;
        }
        const float v00 = top[kx * CIN + ci], v01 = top[(kx + 1) * CIN + ci];
        const float v10 = bot[kx * CIN + ci], v11 = bot[(kx + 1) * CIN + ci];
#pragma unroll
        for (int c = 0; c < C1; ++c) {
          acc[0][c] = fmaf(v00, w[c], acc[0][c]);
          acc[1][c] = fmaf(v01, w[c], acc[1][c]);
          acc[2][c] = fmaf(v10, w[c], acc[2][c]);
          acc[3][c] = fmaf(v11, w[c], acc[3][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 6 * CIN; ++i) top[i] = bot[i];
  }
#pragma unroll
  for (int c = 0; c < C1; ++c) {
    const float m =
        fmaxf(fmaxf(acc[0][c], acc[1][c]), fmaxf(acc[2][c], acc[3][c]));
    out[c * cs2] = fmaxf(m + b1s[c], 0.0f);
  }
}

// conv2 at the four positions of pooled pixel (py, px) of one image, for
// half of its C2 channels: `pj` is the image's pooled conv1 planes at row
// 2 py, column 2 px; `w2s`, `b2s` and `o` start at the half's first
// channel; writes the pooled, biased, rectified C2 / 2 channels to `o`
// (float4s)
template <int CIN, int C1, int C2>
__device__ __forceinline__ void conv2_pixel(const float* __restrict__ pj,
                                            int rs2, int cs2,
                                            const float* __restrict__ w2s,
                                            const float* __restrict__ b2s,
                                            float* __restrict__ o) {
  constexpr int CH = C2 / 2;
  float acc[4][CH];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[p][c] = 0.0f;
#pragma unroll 1
  for (int ky = 0; ky < kK; ++ky) {
#pragma unroll 1
    for (int ci = 0; ci < C1; ++ci) {
      const float* r = pj + ci * cs2 + ky * rs2;
      float t[6], u[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        t[c] = r[c];
        u[c] = r[rs2 + c];
      }
      const float4* wk =
          reinterpret_cast<const float4*>(w2s + (ky * kK * C1 + ci) * C2);
#pragma unroll
      for (int kx = 0; kx < kK; ++kx) {
#pragma unroll
        for (int q = 0; q < CH / 4; ++q) {
          const float4 v = wk[kx * C1 * C2 / 4 + q];
          const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * q + e;
            acc[0][c] = fmaf(t[kx], w[e], acc[0][c]);
            acc[1][c] = fmaf(t[kx + 1], w[e], acc[1][c]);
            acc[2][c] = fmaf(u[kx], w[e], acc[2][c]);
            acc[3][c] = fmaf(u[kx + 1], w[e], acc[3][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < CH / 4; ++q) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * q + e;
      const float m =
          fmaxf(fmaxf(acc[0][c], acc[1][c]), fmaxf(acc[2][c], acc[3][c]));
      v[e] = fmaxf(m + b2s[c], 0.0f);
    }
    reinterpret_cast<float4*>(o)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int CIN, int C1, int C2>
__global__ void __launch_bounds__(kThreads, 2)
cnn_features_kernel(const float* __restrict__ x, int64_t sxg, int64_t sxb,
                    const float* __restrict__ w1, int64_t sw1,
                    const float* __restrict__ b1, int64_t sb1,
                    const float* __restrict__ w2, int64_t sw2,
                    const float* __restrict__ b2, int64_t sb2,
                    float* __restrict__ out, const Plan plan) {
  using S = Shape<CIN, C1, C2>;
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;
  float* b1s = w1s + S::W1;
  float* w2s = b1s + S::C1P;
  float* b2s = w2s + S::W2;
  float* xs = b2s + C2;
  const int B = plan.B, H = plan.H, W = plan.W;
  const int p1h = (H - 4) / 2, p1w = (W - 4) / 2;
  const int p2h = (p1h - 4) / 2, p2w = (p1w - 4) / 2;
  const int g = blockIdx.x;
  const int b0 = static_cast<int>(static_cast<int64_t>(blockIdx.y) * B /
                                  plan.tiles);
  const int n = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * B /
                                 plan.tiles) - b0;
  float* p1s = xs + n * plan.is;  // this block's images only
  const int tid = threadIdx.x;

  // the model's weights, conv1's taps padded to C1P channels with zeros
  const float* w1g = w1 + g * sw1;
  for (int i = tid; i < S::W1; i += kThreads) {
    const int tap = i / S::C1P, c = i - tap * S::C1P;
    w1s[i] = c < C1 ? w1g[tap * C1 + c] : 0.0f;
  }
  for (int i = tid; i < S::C1P; i += kThreads)
    b1s[i] = i < C1 ? b1[g * sb1 + i] : 0.0f;
  const float* w2g = w2 + g * sw2;
  for (int i = tid; i < S::W2; i += kThreads) w2s[i] = w2g[i];
  for (int i = tid; i < C2; i += kThreads) b2s[i] = b2[g * sb2 + i];

  // the tile's images, each row at a stride of rs floats
  const int row = W * CIN;
  const float* xg = x + g * sxg + b0 * sxb;
  if (plan.vec) {
    const int r4 = row / 4, per = H * r4;
    for (int i = tid; i < n * per; i += kThreads) {
      const int j = i / per, k = i - j * per;
      const int y = k / r4, c = k - y * r4;
      const float4 v = __ldg(reinterpret_cast<const float4*>(
                                 xg + j * sxb + y * row) + c);
      float2* d = reinterpret_cast<float2*>(xs + j * plan.is + y * plan.rs +
                                            4 * c);
      d[0] = make_float2(v.x, v.y);
      d[1] = make_float2(v.z, v.w);
    }
  } else {
    const int per = H * row;
    for (int i = tid; i < n * per; i += kThreads) {
      const int j = i / per, k = i - j * per;
      const int y = k / row, c = k - y * row;
      xs[j * plan.is + y * plan.rs + c] = __ldg(xg + j * sxb + k);
    }
  }
  __syncthreads();

  // conv1: a thread a pooled pixel of an image, all C1 channels
  const int n1 = p1h * p1w;
  for (int i = tid; i < n * n1; i += kThreads) {
    const int j = i / n1, k = i - j * n1;
    const int py = k / p1w, px = k - py * p1w;
    conv1_pixel<CIN, C1, C2>(
        xs + j * plan.is + 2 * py * plan.rs + 2 * px * CIN, plan.rs, w1s,
        b1s, p1s + j * plan.is2 + py * plan.rs2 + px, plan.cs2);
  }
  __syncthreads();

  // conv2: two neighbouring threads a pooled pixel of an image, each
  // half of its C2 channels; the two read the same inputs (one
  // shared-memory word serves both) and their halves of each tap's
  // weights (one wavefront)
  const int n2 = p2h * p2w;
  const int F = n2 * C2;
  for (int i = tid; i < 2 * n * n2; i += kThreads) {
    const int h = (i & 1) * (C2 / 2), m = i >> 1;
    const int j = m / n2, k = m - j * n2;
    const int py = k / p2w, px = k - py * p2w;
    conv2_pixel<CIN, C1, C2>(
        p1s + j * plan.is2 + 2 * py * plan.rs2 + 2 * px, plan.rs2, plan.cs2,
        w2s + h, b2s + h,
        out + (static_cast<int64_t>(g) * B + b0 + j) * F + k * C2 + h);
  }
}

template <int CIN, int C1, int C2>
cudaError_t launch(const float* x, int64_t sxg, int64_t sxb,
                   const float* w1, int64_t sw1, const float* b1,
                   int64_t sb1, const float* w2, int64_t sw2,
                   const float* b2, int64_t sb2, float* out, int G,
                   const Plan& plan, int tile_images, int smem_bytes,
                   cudaStream_t stream) {
  using S = Shape<CIN, C1, C2>;
  // the plan's shared memory must hold what the kernel carves out of it
  const int64_t need =
      4 * (static_cast<int64_t>(S::WEIGHTS) +
           static_cast<int64_t>(tile_images) * (plan.is + plan.is2));
  if (smem_bytes != need || plan.rs % 2 || plan.is % 2 ||
      plan.rs < plan.W * CIN || plan.is < plan.H * plan.rs ||
      plan.rs2 < (plan.W - 4) / 2 || plan.cs2 < (plan.H - 4) / 2 * plan.rs2 ||
      plan.is2 < C1 * plan.cs2 ||
      (plan.B + plan.tiles - 1) / plan.tiles > tile_images)
    return cudaErrorInvalidValue;
  auto kernel = cnn_features_kernel<CIN, C1, C2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(G),
                  static_cast<unsigned>(plan.tiles));
  kernel<<<grid, kThreads, smem_bytes, stream>>>(x, sxg, sxb, w1, sw1, b1,
                                                 sb1, w2, sw2, b2, sb2, out,
                                                 plan);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Pointers as the kernel's note says;
// strides in elements; (cin, c1, c2) one of (3, 6, 16), (3, 4, 8),
// (1, 6, 16), (1, 4, 8); the plan's values from cnn_features.py::
// launch_plan (refused with cudaErrorInvalidValue where they do not
// hold the kernel's carve-up). The launch goes on `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int cnn_features_f32(
    const void* x, long long sxg, long long sxb, const void* w1,
    long long sw1, const void* b1, long long sb1, const void* w2,
    long long sw2, const void* b2, long long sb2, void* out, int G, int B,
    int H, int W, int cin, int c1, int c2, int tiles, int tile_images,
    int rs, int is, int rs2, int cs2, int is2, int vec, int smem_bytes,
    int device, void* stream) {
  // this library carries its own (static) CUDA runtime, whose current
  // device is set here to the one the tensors live on
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan plan{B, H, W, tiles, rs, is, rs2, cs2, is2, vec};
  const float* xp = static_cast<const float*>(x);
  const float* w1p = static_cast<const float*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  const float* w2p = static_cast<const float*>(w2);
  const float* b2p = static_cast<const float*>(b2);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CNN_FEATURES_CASE(CI, A, Z)                                         \
  if (cin == CI && c1 == A && c2 == Z)                                      \
    return static_cast<int>(launch<CI, A, Z>(                               \
        xp, sxg, sxb, w1p, sw1, b1p, sb1, w2p, sw2, b2p, sb2, o, G, plan,   \
        tile_images, smem_bytes, s));
  CNN_FEATURES_CASE(3, 6, 16)
  CNN_FEATURES_CASE(3, 4, 8)
  CNN_FEATURES_CASE(1, 6, 16)
  CNN_FEATURES_CASE(1, 4, 8)
#undef CNN_FEATURES_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cnn_features_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
