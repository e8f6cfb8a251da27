// The cost split of the fused rotate-and-sum (K4, csrc/rotfused.cu), for
// sm_90a: four stripped-down variants of it, each over N float32 images of
// (S, S) with per-image coefficients alpha[d], beta[d], each writing ONE
// (S, S) sum over all N images, taken in image order (no atomics).
//
// Replaces the Pallas kernels of runs/prof_rotfused.py::run_variant
// (pallas_call at :38), whose bodies are the four variants:
//   V1 copy+accum   (:78-89)   out = sum_d img[d]; the read floor.
//   V2 2x transpose (:92-105)  each image transposed into a scratch plane
//                              and back, then summed.
//   V3 1 shear      (:108-125) out = sum_d X_alpha[d](img[d]).
//   V4 3 shears     (:128-157) out = sum_d X_a(X_b(X_a(img[d]))), a = alpha[d],
//                              b = beta[d], all three along x (no
//                              transposes: the wrong rotation, the right cost).
// X_c shifts row y by c * (y + 0.5 - S/2) texels with a two-tap lerp, a tap
// outside [0, S) counting 0: ops/rotate.py::_shear_block_dyn of the JAX
// package (:301-339), as K2 computes it.
//
// Bound: bytes for all four. Each reads every input image once and writes one
// plane: N*S*S*4 + S*S*4 bytes (629 MB at N=384, S=640: 0.19 ms at
// 3.35 TB/s). V2 moves three times that through its scratch planes; that
// extra traffic is what it prices.
//
// Designs:
//   V1: one thread per float4 of the plane, the image loop unrolled by 8 so
//       that eight 16-byte loads are in flight per thread.
//   V2: two kernels. A writes the transpose of every image into its scratch
//       plane through a 32x33 shared tile (the pad avoids bank conflicts);
//       B, one block per 32x32 output tile, reads each scratch plane's tile
//       back through a shared tile, transposed, and sums over the images in
//       order in registers.
//   V3: one thread per output texel, two taps of each image's row in image
//       order (the lanes of a warp read one row, coalesced).
//   V4: one block per row y. The row of image d is staged in shared memory
//       (S floats, 2.5 KB at S=640); the three shears run shared memory to
//       shared memory, the last into a register accumulator; the next
//       image's row is loaded into registers while the current one is
//       sheared. Set beside K4, which evaluates its composite as 8 taps per
//       texel through L1 and stages nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;          // threads per tile column in the transposes
constexpr int kThreads = 256;
constexpr int kRowThreads = 256;  // V4 block
constexpr int kRowVals = 4;       // V4: values of a row per thread, S <= 1024

__global__ void __launch_bounds__(kThreads)
copy_accum_kernel(const float4* __restrict__ img, float4* __restrict__ out,
                  int n, long long plane4) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= plane4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int d = 0;
  for (; d + 8 <= n; d += 8) {
    float4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __ldg(img + (d + k) * plane4 + i);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc.x += v[k].x; acc.y += v[k].y; acc.z += v[k].z; acc.w += v[k].w;
    }
  }
  for (; d < n; ++d) {
    const float4 v = __ldg(img + d * plane4 + i);
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  out[i] = acc;
}

// scratch[d][x][y] = img[d][y][x], tile by tile.
__global__ void __launch_bounds__(kTile * kRows)
transpose_kernel(const float* __restrict__ img, float* __restrict__ scratch, int s) {
  __shared__ float tile[kTile][kTile + 1];
  const size_t plane = (size_t)blockIdx.z * s * s;
  const int x = blockIdx.x * kTile + threadIdx.x;
  const int y0 = blockIdx.y * kTile;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int y = y0 + j;
    if (x < s && y < s) tile[j][threadIdx.x] = __ldg(img + plane + (size_t)y * s + x);
  }
  __syncthreads();
  const int ox = y0 + threadIdx.x;        // output column = input row
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int oy = blockIdx.x * kTile + j;  // output row = input column
    if (ox < s && oy < s) scratch[plane + (size_t)oy * s + ox] = tile[threadIdx.x][j];
  }
}

// out[y][x] = sum_d scratch[d][x][y], each tile read back transposed.
__global__ void __launch_bounds__(kTile * kRows)
transpose_accum_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                       int n, int s) {
  __shared__ float tile[kTile][kTile + 1];
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  float acc[kTile / kRows] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < n; ++d) {
    const float* plane = scratch + (size_t)d * s * s;
    // Rows x0.. of the scratch plane hold columns x0.. of the image.
    for (int j = threadIdx.y; j < kTile; j += kRows) {
      const int sr = x0 + j, sc = y0 + threadIdx.x;
      tile[j][threadIdx.x] = (sr < s && sc < s) ? __ldg(plane + (size_t)sr * s + sc) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTile / kRows; ++k)
      acc[k] += tile[threadIdx.x][threadIdx.y + k * kRows];
    __syncthreads();
  }
  const int x = x0 + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kTile / kRows; ++k) {
    const int y = y0 + threadIdx.y + k * kRows;
    if (x < s && y < s) out[(size_t)y * s + x] = acc[k];
  }
}

__device__ __forceinline__ float lerp_taps(float a, float b, float f) {
  return a * (1.f - f) + b * f;
}

__global__ void __launch_bounds__(kThreads)
shear1_accum_kernel(const float* __restrict__ img, const float* __restrict__ alpha,
                    float* __restrict__ out, int n, int s) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= s) return;
  const float yc = (float)y + 0.5f - 0.5f * (float)s;
  float acc = 0.f;
#pragma unroll 4
  for (int d = 0; d < n; ++d) {
    const float sh = __ldg(alpha + d) * yc;
    const float fi = floorf(sh);
    const int x0 = x + (int)fi;
    const float f = sh - fi;
    const float* row = img + ((size_t)d * s + y) * s;
    const float v0 = (x0 >= 0 && x0 < s) ? __ldg(row + x0) : 0.f;
    const float v1 = (x0 + 1 >= 0 && x0 + 1 < s) ? __ldg(row + x0 + 1) : 0.f;
    acc += lerp_taps(v0, v1, f);
  }
  out[(size_t)y * s + x] = acc;
}

// One x-shear of a staged row: dst[x] for the threads' columns.
__device__ __forceinline__ float row_shear(const float* __restrict__ src, int x,
                                           float sh, int s) {
  const float fi = floorf(sh);
  const int x0 = x + (int)fi;
  const float f = sh - fi;
  const float v0 = (x0 >= 0 && x0 < s) ? src[x0] : 0.f;
  const float v1 = (x0 + 1 >= 0 && x0 + 1 < s) ? src[x0 + 1] : 0.f;
  return lerp_taps(v0, v1, f);
}

__global__ void __launch_bounds__(kRowThreads)
shear3_accum_kernel(const float* __restrict__ img, const float* __restrict__ alpha,
                    const float* __restrict__ beta, float* __restrict__ out,
                    int n, int s) {
  extern __shared__ float smem[];
  float* b0 = smem;
  float* b1 = smem + s;
  const int y = blockIdx.x;
  const float yc = (float)y + 0.5f - 0.5f * (float)s;
  float acc[kRowVals] = {0.f, 0.f, 0.f, 0.f};
  float next[kRowVals];
#pragma unroll
  for (int k = 0; k < kRowVals; ++k) {
    const int x = threadIdx.x + k * kRowThreads;
    next[k] = (x < s && n > 0) ? __ldg(img + (size_t)y * s + x) : 0.f;
  }
  for (int d = 0; d < n; ++d) {
#pragma unroll
    for (int k = 0; k < kRowVals; ++k) {
      const int x = threadIdx.x + k * kRowThreads;
      if (x < s) b0[x] = next[k];
    }
    __syncthreads();
    if (d + 1 < n) {  // the next image's row, in flight during the shears
      const float* row = img + ((size_t)(d + 1) * s + y) * s;
#pragma unroll
      for (int k = 0; k < kRowVals; ++k) {
        const int x = threadIdx.x + k * kRowThreads;
        if (x < s) next[k] = __ldg(row + x);
      }
    }
    const float sa = __ldg(alpha + d) * yc;
    const float sb = __ldg(beta + d) * yc;
#pragma unroll
    for (int k = 0; k < kRowVals; ++k) {
      const int x = threadIdx.x + k * kRowThreads;
      if (x < s) b1[x] = row_shear(b0, x, sa, s);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowVals; ++k) {
      const int x = threadIdx.x + k * kRowThreads;
      if (x < s) b0[x] = row_shear(b1, x, sb, s);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowVals; ++k) {
      const int x = threadIdx.x + k * kRowThreads;
      if (x < s) acc[k] += row_shear(b0, x, sa, s);
    }
    __syncthreads();  // b0 is overwritten by the next image
  }
#pragma unroll
  for (int k = 0; k < kRowVals; ++k) {
    const int x = threadIdx.x + k * kRowThreads;
    if (x < s) out[(size_t)y * s + x] = acc[k];
  }
}

}  // namespace

// img (n, s, s) and out (s, s) float32; s * s must be a multiple of 4 and
// both pointers 16-byte aligned.
extern "C" int litbox_prof_copy_accum(const float* img, float* out, int n, int s,
                                      void* stream) {
  const long long plane4 = (long long)s * s / 4;
  if (plane4 > 0) {
    const unsigned blocks = (unsigned)((plane4 + kThreads - 1) / kThreads);
    copy_accum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)img, (float4*)out, n, plane4);
  }
  return (int)cudaGetLastError();
}

// scratch: (n, s, s) float32 workspace.
extern "C" int litbox_prof_transpose2_accum(const float* img, float* scratch,
                                            float* out, int n, int s, void* stream) {
  const unsigned tiles = (unsigned)((s + kTile - 1) / kTile);
  const dim3 block(kTile, kRows);
  if (n > 0 && s > 0) {
    transpose_kernel<<<dim3(tiles, tiles, n), block, 0, (cudaStream_t)stream>>>(
        img, scratch, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (s > 0) {
    transpose_accum_kernel<<<dim3(tiles, tiles), block, 0, (cudaStream_t)stream>>>(
        scratch, out, n, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int litbox_prof_shear1_accum(const float* img, const float* alpha,
                                        float* out, int n, int s, void* stream) {
  if (s > 0) {
    const dim3 grid((unsigned)((s + kThreads - 1) / kThreads), (unsigned)s);
    shear1_accum_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(img, alpha, out, n, s);
  }
  return (int)cudaGetLastError();
}

// s <= kRowThreads * kRowVals (1024).
extern "C" int litbox_prof_shear3_accum(const float* img, const float* alpha,
                                        const float* beta, float* out, int n,
                                        int s, void* stream) {
  if (s > kRowThreads * kRowVals) return (int)cudaErrorInvalidValue;
  if (s > 0) {
    shear3_accum_kernel<<<(unsigned)s, kRowThreads, 2 * s * sizeof(float),
                          (cudaStream_t)stream>>>(img, alpha, beta, out, n, s);
  }
  return (int)cudaGetLastError();
}
