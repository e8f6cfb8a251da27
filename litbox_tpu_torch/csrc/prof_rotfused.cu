// The cost split of the fused rotate-and-sum (K4, csrc/rotfused.cu), for
// sm_90a: four stripped-down variants of it, each over N float32 images of
// (S, S) with per-image coefficients alpha[d], beta[d], each writing ONE
// (S, S) sum over all N images, taken in image order (no atomics).
//
// Replaces the Pallas kernels of runs/prof_rotfused.py::run_variant
// (pallas_call at :38), whose bodies are the four variants:
//   V1 copy+accum   (:74-85)   out = sum_d img[d]; the read floor.
//   V2 2x transpose (:88-101)  each image transposed twice in fast memory
//                              (the script's VMEM scratch planes t1, t2),
//                              then summed.
//   V3 1 shear      (:104-124) out = sum_d X_alpha[d](img[d]).
//   V4 3 shears     (:127-158) out = sum_d X_a(X_b(X_a(img[d]))), a = alpha[d],
//                              b = beta[d], all three along x (no
//                              transposes: the wrong rotation, the right cost).
// X_c shifts row y by c * (y + 0.5 - S/2) texels with a two-tap lerp, a tap
// outside [0, S) counting 0: ops/rotate.py::_shear_block_dyn of the JAX
// package (:301-339), as K2 computes it.
//
// Bound: bytes for all four. Each reads every input image once and writes one
// plane: N*S*S*4 + S*S*4 bytes (629 MB at N=384, S=640: 0.19 ms at
// 3.35 TB/s). V2 keeps both transposes on chip, so it moves the same bytes
// as V1: what it prices is the two transposes' shared-memory work.
//
// Designs:
//   V1: one thread per float4 of the plane, the image loop unrolled by 8 so
//       that eight 16-byte loads are in flight per thread.
//   V2: one kernel, no scratch in device memory. One block per 32x32 output
//       tile (400 blocks at S=640) walks the images in order with a register
//       accumulator. A ring of kStages 4 KB shared stages, filled by
//       cp.async (16-byte copies, 4-byte ones where S % 4 != 0 or the
//       images are not 16-byte aligned; zero-filled outside the image),
//       keeps the next 5 images' tiles in flight a block (8 MB over the
//       400) while the current tile is transposed into a 32x33 shared tile
//       and read back transposed into the accumulator. One barrier an
//       image (two t1 buffers). The stages are XOR-swizzled at float4
//       granularity (tile_ring.cuh), so the 16-byte copies land
//       conflict-free and the first transpose reads them conflict-free; the
//       padded tile keeps the second one so. Same order of additions as V1:
//       the two agree bit for bit. Rings of 4 or 8 stages, or two barriers
//       an image, measured slower on an H100 80GB HBM3 at 700 W.
//   V3: one thread per output texel, two taps of each image's row in image
//       order (the lanes of a warp read one row, coalesced).
//   V4: one block per row y. The row of image d is staged in shared memory
//       (S floats, 2.5 KB at S=640); the three shears run shared memory to
//       shared memory, the last into a register accumulator; the next
//       image's row is loaded into registers while the current one is
//       sheared. Set beside K4, which evaluates its composite as 8 taps per
//       texel through L1 and stages nothing.

#include <cuda_runtime.h>

#include "tile_ring.cuh"

namespace {

constexpr int kTile = litbox::kRingTile;
constexpr int kRows = litbox::kRingRows;  // threads per tile column in V2
constexpr int kStages = 6;        // V2's ring: 5 images' tiles in flight a block
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

// out = sum_d (img[d]^T)^T for one 32x32 output tile per block, the images
// in order. Image d's tile is staged by cp.async into ring stage d % kStages
// (swizzled, tile_ring.cuh), kStages - 1 images ahead of the one being
// summed; it is transposed into t1[d % 2], and that is read back transposed
// into the accumulator. Both transposes are shared memory to shared memory
// (or registers). One __syncthreads an image: between the two transposes,
// after each thread has also waited for image d + 1's copies, so the same
// barrier publishes the next stage; the two t1 buffers let image d + 1's
// first transpose start while image d's second is still being read.
template <bool kVec>
__global__ void __launch_bounds__(kTile * kRows)
transpose2_accum_kernel(const float* __restrict__ img, float* __restrict__ out, int n,
                        int s) {
  __shared__ __align__(16) float stage[kStages][litbox::kRingTileFloats];
  __shared__ float t1[2][kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const size_t plane = (size_t)s * s;
  // Image d's tile into its stage; one commit group per image, empty past
  // the last image, so that the waits below count images.
  auto load = [&](int d) {
    if (d < n) litbox::stage_tile<kVec>(stage[d % kStages], img + d * plane, x0, y0, s);
    litbox::cp_async_commit();
  };
  for (int d = 0; d < kStages - 1; ++d) load(d);
  litbox::cp_async_wait<kStages - 2>();  // image 0's copies have landed
  __syncthreads();
  float acc[kTile / kRows] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < n; ++d) {
    float (*t)[kTile + 1] = t1[d & 1];
    // Transpose 1, t = tile^T: warp ty takes chunk column ty; lane tx reads
    // the 16 bytes of row tx there (conflict-free by the swizzle) and writes
    // them down column tx of t's rows 4ty..4ty+3 (stride 33: conflict-free).
    const float4 v = *reinterpret_cast<const float4*>(
        stage[d % kStages] + litbox::swizzled(tx, 4 * ty));
    t[4 * ty][tx] = v.x;
    t[4 * ty + 1][tx] = v.y;
    t[4 * ty + 2][tx] = v.z;
    t[4 * ty + 3][tx] = v.w;
    litbox::cp_async_wait<kStages - 3>();  // image d + 1's copies have landed
    __syncthreads();  // t is whole; stage (d - 1) % kStages is read and free
    load(d + kStages - 1);
    // Transpose 2, acc += t^T at (row ty + 8k, column tx): lane tx reads
    // row tx of t (stride 33: conflict-free).
#pragma unroll
    for (int k = 0; k < kTile / kRows; ++k) acc[k] += t[tx][ty + k * kRows];
  }
  const int x = x0 + tx;
#pragma unroll
  for (int k = 0; k < kTile / kRows; ++k) {
    const int y = y0 + ty + k * kRows;
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

// img (n, s, s) and out (s, s) float32, any s: 16-byte copies where s % 4 == 0
// and img is 16-byte aligned, 4-byte copies otherwise.
extern "C" int litbox_prof_transpose2_accum(const float* img, float* out, int n, int s,
                                            void* stream) {
  if (s > 0) {
    const unsigned tiles = (unsigned)((s + kTile - 1) / kTile);
    const dim3 grid(tiles, tiles), block(kTile, kRows);
    if (s % 4 == 0 && litbox::aligned16(img))
      transpose2_accum_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(img, out, n, s);
    else
      transpose2_accum_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(img, out, n, s);
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
