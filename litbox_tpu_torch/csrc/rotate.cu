// Row shears of the RBT rotate-back, for sm_90a.
//
// shear replaces the Pallas kernel litbox_tpu/ops/rotate.py::shear
// (pallas_call at :163, _shear_kernel_factory :82, _shear_math :38);
// shear_reduce replaces rotate.py::shear_reduce (pallas_call at :210,
// _shear_reduce_kernel_factory :103). Both compute, for image d and row r,
//     s = coef[d] * (r / row_div + 0.5 - n_texels / 2),  i = floor(s), f = s - i
//     out[d, r, l] = (1 - f) * img[d, r, l + i*e] + f * img[d, r, l + (i+1)*e]
// with e = elem_scale lanes per texel, and a tap whose texel l/e + i (or
// + i + 1) lies outside [0, n_texels) contributes 0. shear_reduce applies
// this to rows [row_lo, row_hi) only and sums each contiguous group of
// n / groups images.
//
// Bound: bytes. shear reads and writes each element once; shear_reduce reads
// rows [row_lo, row_hi) of every image once and writes one plane per group.
//
// Design: one thread per output element, 128 threads across the lane axis
// and one block row per image row, so both taps are coalesced loads of one
// row (the second mostly hits L1). The shift is computed exactly from coef,
// with no bound on |coef|: the Pallas kernel's static coef_bound, its k_max
// roll loop and its 128-lane padding are TPU artifacts. shear_reduce gives
// each thread one output element and loops over the images of its group in
// order, so there are no atomics and the sum order is fixed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float shear_taps(const float* __restrict__ row,
                                            float s, int l, int elem_scale,
                                            int n_texels) {
  const float fi = floorf(s);
  const int i = (int)fi;
  const float f = s - fi;
  const int texel = l / elem_scale + i;
  float acc = 0.f;
  if (texel >= 0 && texel < n_texels) acc = __ldg(row + l + i * elem_scale) * (1.f - f);
  if (texel + 1 >= 0 && texel + 1 < n_texels)
    acc += __ldg(row + l + (i + 1) * elem_scale) * f;
  return acc;
}

__device__ __forceinline__ float row_offset(int r, int row_div, float center) {
  return ((float)(r / row_div) + 0.5f) - center;
}

__global__ void __launch_bounds__(kThreads)
shear_kernel(const float* __restrict__ img, const float* __restrict__ coef,
             float* __restrict__ out, int rows, int width, int row_div,
             int elem_scale, int n_texels, float center) {
  const int l = blockIdx.y * kThreads + threadIdx.x;
  if (l >= width) return;
  const long long dr = blockIdx.x;  // image * rows + row
  const int d = (int)(dr / rows);
  const int r = (int)(dr % rows);
  const float s = __ldg(coef + d) * row_offset(r, row_div, center);
  out[dr * width + l] = shear_taps(img + dr * width, s, l, elem_scale, n_texels);
}

__global__ void __launch_bounds__(kThreads)
shear_reduce_kernel(const float* __restrict__ img,
                    const float* __restrict__ coef, float* __restrict__ out,
                    int n_per, int rows, int width, int row_div,
                    int elem_scale, int n_texels, float center, int row_lo,
                    int out_rows) {
  const int l = blockIdx.y * kThreads + threadIdx.x;
  if (l >= width) return;
  const int g = blockIdx.x / out_rows;
  const int o = blockIdx.x % out_rows;
  const int r = row_lo + o;
  const float rc = row_offset(r, row_div, center);
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < n_per; ++k) {
    const int d = g * n_per + k;
    const float* row = img + ((size_t)d * rows + r) * width;
    acc += shear_taps(row, __ldg(coef + d) * rc, l, elem_scale, n_texels);
  }
  out[((size_t)g * out_rows + o) * width + l] = acc;
}

}  // namespace

extern "C" int litbox_shear(const float* img, const float* coef, float* out,
                            int n, int rows, int width, int row_div,
                            int elem_scale, int n_texels, void* stream) {
  const long long row_blocks = (long long)n * rows;
  const dim3 grid((unsigned)row_blocks, (width + kThreads - 1) / kThreads);
  if (row_blocks > 0 && width > 0) {
    shear_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        img, coef, out, rows, width, row_div, elem_scale, n_texels,
        n_texels / 2.0f);
  }
  return (int)cudaGetLastError();
}

extern "C" int litbox_shear_reduce(const float* img, const float* coef,
                                   float* out, int n, int rows, int width,
                                   int row_div, int elem_scale, int n_texels,
                                   int row_lo, int row_hi, int groups,
                                   void* stream) {
  const int out_rows = row_hi - row_lo;
  const dim3 grid((unsigned)(groups * out_rows), (width + kThreads - 1) / kThreads);
  if (out_rows > 0 && groups > 0 && width > 0) {
    shear_reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        img, coef, out, n / groups, rows, width, row_div, elem_scale,
        n_texels, n_texels / 2.0f, row_lo, out_rows);
  }
  return (int)cudaGetLastError();
}
