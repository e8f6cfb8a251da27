// KPCN's reconstruction, for sm_90a: each pixel's colour is the softmax of
// its K * K predicted logits applied to the K x K window of the colour
// centred on it (zero outside the image),
//   out[c][p] = sum over taps q of softmax(z[.][p])_q * x[c][p + q],
// forward and backward to the logits, in float32, NCHW.
//
// Replaces no TPU kernel: the JAX package has no KPCN. Added because the
// plain composition unfolds the colour into a (N, C * K * K, H * W) tensor
// (1.43 GB at the cell's 64 patches of 65^2 with K = 21) and multiplies it
// with the softmax, in each direction.
//
// Bound: bytes. The forward reads the logits (N * K * K * H * W floats) and
// the colour once, and writes the colour out and each pixel's log-sum-exp;
// the backward reads the logits, the colour, the log-sum-exp, the output and
// its gradient, and writes the logits' gradient. The logits dominate: 477 MB
// a pass at the cell's shape, about 1.43 GB a step over both directions.
// The arithmetic (an exp and four FMAs a tap) is far below that line.
//
// Design. A block takes kPixels consecutive pixels of one image (flattened
// row-major, so a warp's logit reads of one tap are consecutive floats) and
// stages the rows of the colour its windows reach, zero-padded by K / 2 on
// every side, in shared memory. Its kGroups thread groups each take a band
// of the window's rows for every pixel, so a pixel's taps are read by
// kGroups threads at once and the grid holds more, smaller blocks. Forward:
// each thread makes one pass over its taps' logits with an online maximum
// and sum (rescaling its sum and its colour sums when the maximum rises);
// the groups' partial states are merged in group order through shared
// memory. Backward: with the log-sum-exp l and the output o kept from the
// forward, dz_q = exp(z_q - l) * (g . x_{p+q} - g . o_p), g the output's
// gradient; no gradient goes to the colour (it is data). Every sum is taken
// in a fixed order and no output is written twice: a run repeats bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kC = 3;          // colour channels
constexpr int kPixels = 64;    // pixels a block
constexpr int kGroups = 3;     // thread groups a block, each a band of the window's rows
constexpr int kThreads = kPixels * kGroups;

// The image rows a block's pixels [p0, p0 + kPixels) lie on: the first, and
// how many. The staged window holds rows y0 - r .. y0 + rows - 1 + r.
struct Band {
  int y0, rows;
};

__device__ Band band(int p0, int hw, int w) {
  const int last = min(p0 + kPixels, hw) - 1;
  return Band{p0 / w, last / w - p0 / w + 1};
}

// Stage the colour rows of `b` with a margin of r on every side, zero
// outside the image: win[c][row][col], col = x + r, row = y - b.y0 + r.
__device__ void stage(const float* __restrict__ x, float* win, Band b, int h, int w, int r) {
  const int sw = w + 2 * r, sr = b.rows + 2 * r, plane = sr * sw;
  for (int e = threadIdx.x; e < kC * plane; e += kThreads) {
    const int c = e / plane, rest = e - c * plane;
    const int row = rest / sw, col = rest - row * sw;
    const int y = b.y0 - r + row, xx = col - r;
    win[e] = (y >= 0 && y < h && xx >= 0 && xx < w) ? x[(size_t)c * h * w + y * w + xx] : 0.0f;
  }
}

// The rows [k0, k1) of the window that group g takes.
__device__ void rows_of(int g, int k, int& k0, int& k1) {
  const int per = (k + kGroups - 1) / kGroups;
  k0 = min(g * per, k);
  k1 = min(k0 + per, k);
}

// Grid (ceil(hw / kPixels), n). z (n, k * k, h, w), x (n, kC, h, w); out
// (n, kC, h, w), lse (n, h, w).
__global__ void __launch_bounds__(kThreads)
kpn_forward_kernel(const float* __restrict__ z, const float* __restrict__ x,
                   float* __restrict__ out, float* __restrict__ lse, int h, int w, int k) {
  extern __shared__ float win[];
  const int hw = h * w, r = k / 2, n = blockIdx.y;
  const int p0 = blockIdx.x * kPixels;
  const Band b = band(p0, hw, w);
  const int sw = w + 2 * r, plane = (b.rows + 2 * r) * sw;
  stage(x + (size_t)n * kC * hw, win, b, h, w, r);
  __syncthreads();

  const int t = threadIdx.x % kPixels, g = threadIdx.x / kPixels;
  const int p = p0 + t;
  float m = -INFINITY, s = 0.0f, a[kC] = {0.0f, 0.0f, 0.0f};
  if (p < hw) {
    const int y = p / w, xx = p - y * w;
    int k0, k1;
    rows_of(g, k, k0, k1);
    const float* zp = z + (size_t)n * k * k * hw + p;
    for (int ky = k0; ky < k1; ++ky) {
      const float* row = win + (y - b.y0 + ky) * sw + xx;
      const float* zr = zp + (size_t)ky * k * hw;
#pragma unroll 7
      for (int kx = 0; kx < k; ++kx) {
        const float zq = zr[(size_t)kx * hw];
        if (zq > m) {
          const float scale = expf(m - zq);
          s *= scale;
#pragma unroll
          for (int c = 0; c < kC; ++c) a[c] *= scale;
          m = zq;
        }
        const float e = expf(zq - m);
        s += e;
#pragma unroll
        for (int c = 0; c < kC; ++c) a[c] = fmaf(e, row[c * plane + kx], a[c]);
      }
    }
  }
  // The groups' states merged in group order by group 0, through the
  // shared memory the window held.
  __syncthreads();
  float* part = win;  // [kGroups - 1][2 + kC][kPixels]
  if (g > 0) {
    float* q = part + (g - 1) * (2 + kC) * kPixels + t;
    q[0] = m;
    q[kPixels] = s;
#pragma unroll
    for (int c = 0; c < kC; ++c) q[(2 + c) * kPixels] = a[c];
  }
  __syncthreads();
  if (g > 0 || p >= hw) return;
  float mm = m;
  for (int j = 0; j < kGroups - 1; ++j) mm = fmaxf(mm, part[j * (2 + kC) * kPixels + t]);
  const float own = expf(m - mm);
  float ss = s * own, aa[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) aa[c] = a[c] * own;
  for (int j = 0; j < kGroups - 1; ++j) {
    const float* q = part + j * (2 + kC) * kPixels + t;
    const float f = expf(q[0] - mm);  // a group with no taps holds -inf: f = 0
    ss = fmaf(q[kPixels], f, ss);
#pragma unroll
    for (int c = 0; c < kC; ++c) aa[c] = fmaf(q[(2 + c) * kPixels], f, aa[c]);
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) out[((size_t)n * kC + c) * hw + p] = aa[c] / ss;
  lse[(size_t)n * hw + p] = mm + logf(ss);
}

// Grid as the forward's. dz (n, k * k, h, w) from the output's gradient g
// (n, kC, h, w), the output and the log-sum-exp of the forward.
__global__ void __launch_bounds__(kThreads)
kpn_backward_kernel(const float* __restrict__ z, const float* __restrict__ x,
                    const float* __restrict__ lse, const float* __restrict__ out,
                    const float* __restrict__ gout, float* __restrict__ dz, int h, int w, int k) {
  extern __shared__ float win[];
  const int hw = h * w, r = k / 2, n = blockIdx.y;
  const int p0 = blockIdx.x * kPixels;
  const Band b = band(p0, hw, w);
  const int sw = w + 2 * r, plane = (b.rows + 2 * r) * sw;
  stage(x + (size_t)n * kC * hw, win, b, h, w, r);
  __syncthreads();

  const int t = threadIdx.x % kPixels, g = threadIdx.x / kPixels;
  const int p = p0 + t;
  if (p >= hw) return;
  const int y = p / w, xx = p - y * w;
  float gc[kC], go = 0.0f;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const size_t at = ((size_t)n * kC + c) * hw + p;
    gc[c] = gout[at];
    go = fmaf(gc[c], out[at], go);
  }
  const float l = lse[(size_t)n * hw + p];
  int k0, k1;
  rows_of(g, k, k0, k1);
  const size_t base = (size_t)n * k * k * hw + p;
  for (int ky = k0; ky < k1; ++ky) {
    const float* row = win + (y - b.y0 + ky) * sw + xx;
    const size_t at = base + (size_t)ky * k * hw;
#pragma unroll 7
    for (int kx = 0; kx < k; ++kx) {
      const float wq = expf(z[at + (size_t)kx * hw] - l);
      float gx = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) gx = fmaf(gc[c], row[c * plane + kx], gx);
      dz[at + (size_t)kx * hw] = wq * (gx - go);
    }
  }
}

// Shared memory floats of a block at width w and window k: the colour rows
// its pixels' windows reach (the forward's merge reuses them; it needs
// fewer). 0 where k is even or below 1. ops/kpn.py smem_bytes mirrors it.
long long smem_floats(int w, int k) {
  if (k < 1 || k % 2 == 0 || w < 1) return 0;
  const int rows = (kPixels - 1 + w - 1) / w + 1;  // most image rows kPixels pixels span
  const long long staged = (long long)kC * (rows + k - 1) * (w + k - 1);
  const long long merge = (long long)(kGroups - 1) * (2 + kC) * kPixels;
  return staged > merge ? staged : merge;
}

int launch_dims(int n, int h, int w, int k, dim3& grid, size_t& smem) {
  const long long floats = smem_floats(w, k);
  if (n < 1 || h < 1 || floats == 0) return (int)cudaErrorInvalidValue;
  smem = sizeof(float) * (size_t)floats;
  grid = dim3((h * w + kPixels - 1) / kPixels, n);
  return 0;
}

}  // namespace

// The forward: out (n, 3, h, w) and lse (n, h, w) from z (n, k * k, h, w)
// and x (n, 3, h, w); k odd.
extern "C" int litbox_kpn_forward(const float* z, const float* x, float* out, float* lse, int n,
                                  int h, int w, int k, void* stream) {
  dim3 grid;
  size_t smem;
  if (int code = launch_dims(n, h, w, k, grid, smem)) return code;
  cudaError_t err = cudaFuncSetAttribute(kpn_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kpn_forward_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(z, x, out, lse, h, w, k);
  return (int)cudaGetLastError();
}

// The backward: dz (n, k * k, h, w) from the forward's inputs, its lse and
// out, and the output's gradient gout (n, 3, h, w).
extern "C" int litbox_kpn_backward(const float* z, const float* x, const float* lse,
                                   const float* out, const float* gout, float* dz, int n, int h,
                                   int w, int k, void* stream) {
  dim3 grid;
  size_t smem;
  if (int code = launch_dims(n, h, w, k, grid, smem)) return code;
  cudaError_t err = cudaFuncSetAttribute(kpn_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kpn_backward_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(z, x, lse, out, gout, dz,
                                                                      h, w, k);
  return (int)cudaGetLastError();
}
