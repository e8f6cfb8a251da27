// Whole-image three-shear rotation summed per quadrant run, for sm_90a.
//
// Replaces the Pallas kernel litbox_tpu/ops/rotate.py::rotate_planar_sum_fused
// (pallas_call at :458; body _rot3sum_kernel_factory :342, shear
// _shear_block_dyn :301). For one channel plane img (D, S, S), the bin
// coefficients alpha[d], beta[d] and R contiguous runs of bins, it writes
//     P[r] = sum over d in run r, in bin order, of X_a(Y_b(X_a(img[d])))
// where, with c = S/2,
//     X_a(I)[y, x] = (1 - f) I[y, x + i] + f I[y, x + i + 1],
//                    i + f = a (y + 0.5 - c)   (shift along x, by row)
//     Y_b(I)[y, x] = (1 - f) I[y + i, x] + f I[y + i + 1, x],
//                    i + f = b (x + 0.5 - c)   (shift along y, by column)
// and every tap outside [0, S) counts 0. The rot90 of each run's partial and
// the sum over runs stay outside the kernel, as in the JAX package.
//
// Bound: bytes. The work reads every input plane once and writes R partial
// planes per channel. Per image and output texel it does 7 two-tap lerps
// (3 operations each) and 7 shift evaluations (4 each): 49 float operations,
// under the float32 rate's share at these sizes.
//
// Design: the Pallas kernel keeps the whole (S, S) image in VMEM between the
// three shears. A 640^2 float32 plane (1.6 MB) does not fit in a block's
// 227 KB of shared memory, so nothing is staged: one thread per output
// texel (r, y, x) loops over its run's images in order and evaluates the
// composite of the three shears directly as 8 taps of img[d] (2 x-taps of
// the last shear, 2 y-taps of the middle shear for each, 2 x-taps of the
// first shear for each of those), with the zero-outside rule at every
// stage. There are no intermediate planes in device memory, no atomics,
// and the sum order is fixed. Neighbouring threads' taps overlap, so L1 and
// L2 serve most reads. There is no static coefficient bound: the shifts are
// exact for any alpha, beta.

#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kMaxRuns = 8;

struct RunTable {
  int start[kMaxRuns + 1];
};

// The first shear's value at (yt, xt): an x-shear of row yt.
__device__ __forceinline__ float first_shear(const float* __restrict__ plane,
                                             int yt, int xt, float a, int s,
                                             float center) {
  const float sh = a * ((float)yt + 0.5f - center);
  const float fi = floorf(sh);
  const int x0 = xt + (int)fi;
  const float f = sh - fi;
  const float* row = plane + (size_t)yt * s;
  float v = 0.f;
  if (x0 >= 0 && x0 < s) v = __ldg(row + x0) * (1.f - f);
  if (x0 + 1 >= 0 && x0 + 1 < s) v += __ldg(row + x0 + 1) * f;
  return v;
}

// The middle (y) shear's value at (y, xt), from two first-shear values.
__device__ __forceinline__ float middle_shear(const float* __restrict__ plane,
                                              int y, int xt, float a, float b,
                                              int s, float center) {
  const float sh = b * ((float)xt + 0.5f - center);
  const float fi = floorf(sh);
  const int y0 = y + (int)fi;
  const float f = sh - fi;
  float v = 0.f;
  if (y0 >= 0 && y0 < s) v = first_shear(plane, y0, xt, a, s, center) * (1.f - f);
  if (y0 + 1 >= 0 && y0 + 1 < s)
    v += first_shear(plane, y0 + 1, xt, a, s, center) * f;
  return v;
}

__global__ void __launch_bounds__(kTileX * kTileY)
rot3sum_kernel(const float* __restrict__ img, const float* __restrict__ alpha,
               const float* __restrict__ beta, float* __restrict__ out, int s,
               RunTable runs) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  const int r = blockIdx.z;
  if (x >= s || y >= s) return;
  const float center = 0.5f * (float)s;
  const float yc = (float)y + 0.5f - center;
  float acc = 0.f;
  for (int d = runs.start[r]; d < runs.start[r + 1]; ++d) {
    const float a = __ldg(alpha + d);
    const float b = __ldg(beta + d);
    const float* plane = img + (size_t)d * s * s;
    // The last (x) shear, row y.
    const float sh = a * yc;
    const float fi = floorf(sh);
    const int x0 = x + (int)fi;
    const float f = sh - fi;
    float v = 0.f;
    if (x0 >= 0 && x0 < s) v = middle_shear(plane, y, x0, a, b, s, center) * (1.f - f);
    if (x0 + 1 >= 0 && x0 + 1 < s)
      v += middle_shear(plane, y, x0 + 1, a, b, s, center) * f;
    acc += v;
  }
  out[((size_t)r * s + y) * s + x] = acc;
}

}  // namespace

// imgs: host array of `channels` device pointers, each (d, s, s) float32.
// run_starts: host array of n_runs + 1 bin indices, increasing, from 0 to d.
// out: (channels, n_runs, s, s) float32.
extern "C" int litbox_rot3sum(const float* const* imgs, const float* alpha,
                              const float* beta, float* out, int channels,
                              int d, int s, int n_runs, const int* run_starts,
                              void* stream) {
  if (n_runs < 1 || n_runs > kMaxRuns || run_starts[0] != 0 ||
      run_starts[n_runs] != d)
    return (int)cudaErrorInvalidValue;
  RunTable runs;
  for (int r = 0; r <= n_runs; ++r) runs.start[r] = run_starts[r];
  for (int r = n_runs + 1; r <= kMaxRuns; ++r) runs.start[r] = d;
  const dim3 block(kTileX, kTileY);
  const dim3 grid((s + kTileX - 1) / kTileX, (s + kTileY - 1) / kTileY, n_runs);
  for (int c = 0; c < channels && s > 0; ++c) {
    rot3sum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        imgs[c], alpha, beta, out + (size_t)c * n_runs * s * s, s, runs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
