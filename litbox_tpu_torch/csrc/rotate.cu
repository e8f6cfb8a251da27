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
// n / groups images in image order. The shift is exact for any coefficient:
// the Pallas kernel's static coef_bound, its k_max roll loop and its
// 128-lane padding are TPU artifacts.
//
// Bound: bytes. shear reads the floats of each row that its taps reach
// once and writes each output once; shear_reduce reads the reached floats of
// rows [row_lo, row_hi) of every image once and writes one plane per group.
//
// Design. A warp owns one output row segment, so the row's shift and its
// floor are computed once a row and image, and each lane owns a few of the
// segment's 16-byte output chunks, 32 chunks apart, so that a warp reads
// and writes whole 512-byte runs. The taps of output chunk c lie in the
// two 16-byte source chunks from c + floor(j / 4) on (j the row's shift in
// floats): two 16-byte reads, taken j mod 4 floats in, give the chunk's
// four outputs, and a source chunk outside the row is zero and never read.
//   shear_kernel (one image, e = 1, 16-byte rows: shear on the main path):
//     five chunks a lane (640 floats a warp), both source chunks of each
//     loaded straight into registers (the second mostly an L1 hit), every
//     load issued before the first store, one 16-byte store a chunk.
//   shear_reduce_kernel (shear_reduce; shear on odd widths, unaligned rows
//     or e > 1): two chunks a lane. The warp walks its group's images in
//     order through a ring of kRing windows in shared memory, each the
//     run of source chunks its taps reach, copied by 16-byte cp.async
//     (4-byte copies and stores where rows are not 16-byte aligned), so
//     two images are in flight while one is added. The warps are
//     independent: a __syncwarp an image, no block barrier. The
//     coefficients come by shuffles from lane registers loaded 32 images
//     ahead, so no copy waits on a load of its shift.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py): shear 0.406 ms at
// (384, 640, 640), 88% of its bound (one thread an output before: 0.80 ms);
// shear_reduce 0.137 ms at (384, 640, 640), rows [128, 512), 3 groups, 80%
// of its bound (0.21 ms before). Deeper rings (4, 6, 8 windows) and wider
// lanes (3 or 5 chunks) moved more bytes in flight and ran slower there;
// with the arithmetic removed, the copies alone took as long as the kernel.
// Both kernels round through row_tap and lerp_tap, with the rounding
// pinned, and shear_reduce adds its taps in image order, so shear_reduce
// equals the in-order sum of shear's outputs bit for bit.

#include <cuda_runtime.h>

#include "tile_ring.cuh"

namespace {

constexpr int kWarps = 2;             // warps (row segments) a block
constexpr int kShearLaneChunks = 5;   // shear_kernel: 16-byte output chunks a lane
constexpr int kReduceLaneChunks = 2;  // shear_reduce_kernel: the same
constexpr int kRing = 3;              // staged windows a warp in shear_reduce_kernel

using litbox::cp_async16_l2;
using litbox::lerp_tap;
using litbox::Coefs;

struct ShearArgs {
  const float* img;
  const float* coef;
  float* out;
  int n_per;        // images a group, summed in order
  int rows;         // rows of an image
  int width;        // floats a row: n_texels * elem_scale
  int row_div, elem_scale, n_texels;
  int row_lo;       // first output row
  int out_rows;     // output rows a group
  int chunks;       // output chunks a row, ceil(width / 4)
  int lane_chunks;  // output chunks a lane
  int segs;         // warps a row
  int window;       // staged 16-byte chunks a warp and stage
  int jobs;         // groups * out_rows * segs
  float center;     // n_texels / 2
};

// The lane shift j = i * e of the taps of a row sheared by coef, and the
// fraction f, rounded alike in both kernels. rc = r / row_div + 0.5 -
// n_texels / 2 is the row's offset from the centre, computed once a warp.
// |i| is clamped to n_texels + 2, where every tap already lies outside the
// row.
struct Tap {
  int j;
  float f;
};

__device__ __forceinline__ float row_center(int r, const ShearArgs& p) {
  return litbox::offset_of(r / p.row_div, p.center);
}

__device__ __forceinline__ Tap row_tap(float coef, float rc, const ShearArgs& p) {
  const litbox::Shift s = litbox::shift_of(coef, rc, (float)(p.n_texels + 2));
  return {s.j * p.elem_scale, s.f};
}

// x[m] = v[k + m] for m < 5, where v[0..7] is lo then hi and 0 <= k < 4.
__device__ __forceinline__ void funnel(float4 lo, float4 hi, int k, float x[5]) {
  const bool two = k & 2, one = k & 1;
  const float w0 = two ? lo.z : lo.x, w1 = two ? lo.w : lo.y;
  const float w2 = two ? hi.x : lo.z, w3 = two ? hi.y : lo.w;
  const float w4 = two ? hi.z : hi.x, w5 = two ? hi.w : hi.y;
  x[0] = one ? w1 : w0;
  x[1] = one ? w2 : w1;
  x[2] = one ? w3 : w2;
  x[3] = one ? w4 : w3;
  x[4] = one ? w5 : w4;
}

// The four outputs of a chunk whose first tap starts k floats into `lo`,
// for e = 1: both taps come from lo and hi.
__device__ __forceinline__ float4 lerp_chunk(float4 lo, float4 hi, int k, float f) {
  float x[5];
  funnel(lo, hi, k, x);
  return make_float4(lerp_tap(x[0], x[1], f), lerp_tap(x[1], x[2], f),
                     lerp_tap(x[2], x[3], f), lerp_tap(x[3], x[4], f));
}

// Stage image row `row`'s window for a warp whose first output chunk is c0
// and whose taps start j lanes off: window chunk w holds the row's floats
// 4 * (c0 + floor(j / 4) + w) .. + 3, zero outside the row.
template <bool kVec>
__device__ __forceinline__ void stage_window(float4* win, const float* row, int c0,
                                             int j, int lane, const ShearArgs& p) {
  const int a0 = c0 + (j >> 2);  // arithmetic shift: floor(j / 4)
  if (kVec) {
    for (int w = lane; w < p.window; w += 32) {
      const int a = a0 + w;
      const bool ok = a >= 0 && a < p.chunks;
      cp_async16_l2(win + w, ok ? row + 4 * a : row, ok);
    }
  } else {
    float* dst = reinterpret_cast<float*>(win);
    for (int v = lane; v < 4 * p.window; v += 32) {
      const int x = 4 * a0 + v;
      const bool ok = x >= 0 && x < p.width;
      litbox::cp_async4(dst + v, ok ? row + x : row, ok);
    }
  }
}

// The four outputs of window chunk m for any e: taps at window floats
// 4m + k + (0..3) and, e floats on, 4m + k + e + (0..3), with k = j mod 4.
__device__ __forceinline__ float4 window_chunk(const float4* win, int m, int k, int e,
                                               float f) {
  float a[5], b[5];
  funnel(win[m], win[m + 1], k, a);
  const int k1 = k + e;
  funnel(win[m + (k1 >> 2)], win[m + (k1 >> 2) + 1], k1 & 3, b);
  return make_float4(lerp_tap(a[0], b[0], f), lerp_tap(a[1], b[1], f),
                     lerp_tap(a[2], b[2], f), lerp_tap(a[3], b[3], f));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// Add one image's taps (e = 1) to a lane's output chunks, the row's lane
// offset mod 4 a template argument: the taps are fixed floats of each chunk
// pair, with no selects (the offset is the same for the whole warp).
template <int kK>
__device__ __forceinline__ void add_image(float4* acc, const float4* win, int lane,
                                          int lane_chunks, float f, bool first) {
#pragma unroll
  for (int u = 0; u < kReduceLaneChunks; ++u) {
    if (u < lane_chunks) {
      const float4 o = litbox::lerp4<kK>(win[lane + 32 * u], win[lane + 32 * u + 1], f);
      acc[u] = first ? o : add4(acc[u], o);
    }
  }
}

// A warp's job: output row o of group g, output chunks from c0.
struct Job {
  int g, o, c0;
};

__device__ __forceinline__ Job job_of(int job, const ShearArgs& p) {
  const int seg = job % p.segs, row_job = job / p.segs;
  return {row_job / p.out_rows, row_job % p.out_rows, seg * 32 * p.lane_chunks};
}

template <bool kVec>
__device__ __forceinline__ void store_chunk(float* dst, int c, float4 v, const ShearArgs& p) {
  if (kVec) {
    *reinterpret_cast<float4*>(dst + 4 * c) = v;
  } else {
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * c + q < p.width) dst[4 * c + q] = x[q];
  }
}

// One image a group, e = 1 and 16-byte rows (shear on the main path): a warp
// per output row segment loads the two 16-byte chunks each of its output
// chunks taps straight into registers, every load before the first store.
__global__ void __launch_bounds__(32 * kWarps) shear_kernel(ShearArgs p) {
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (job >= p.jobs) return;
  const Job jb = job_of(job, p);
  const int r = p.row_lo + jb.o;
  const Tap t = row_tap(__ldg(p.coef + jb.g), row_center(r, p), p);
  const float4* row =
      reinterpret_cast<const float4*>(p.img + ((size_t)jb.g * p.rows + r) * p.width);
  const int a0 = jb.c0 + (t.j >> 2);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 lo[kShearLaneChunks], hi[kShearLaneChunks];
#pragma unroll
  for (int u = 0; u < kShearLaneChunks; ++u) {
    const int a = a0 + lane + 32 * u;
    const bool on = u < p.lane_chunks;
    lo[u] = on && a >= 0 && a < p.chunks ? __ldg(row + a) : zero;
    hi[u] = on && a + 1 >= 0 && a + 1 < p.chunks ? __ldg(row + a + 1) : zero;
  }
  float* dst = p.out + ((size_t)jb.g * p.out_rows + jb.o) * p.width;
#pragma unroll
  for (int u = 0; u < kShearLaneChunks; ++u) {
    const int c = jb.c0 + lane + 32 * u;
    if (u < p.lane_chunks && c < p.chunks)
      store_chunk<true>(dst, c, lerp_chunk(lo[u], hi[u], t.j & 3, t.f), p);
  }
}

// Everything else (shear_reduce; shear on odd widths, unaligned rows or
// e > 1): a warp per (group, output row, row segment) walks the group's
// images through a ring of kRing staged windows; see the design note.
template <bool kVec, bool kE1>
__global__ void __launch_bounds__(32 * kWarps) shear_reduce_kernel(ShearArgs p) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int job = blockIdx.x * kWarps + warp;
  if (job >= p.jobs) return;  // whole warps: nothing below syncs the block
  const Job jb = job_of(job, p);
  const int r = p.row_lo + jb.o;
  const float rc = row_center(r, p);
  const int d0 = jb.g * p.n_per;
  const size_t image = (size_t)p.rows * p.width;
  const float* row0 = p.img + ((size_t)d0 * p.rows + r) * p.width;
  float4* ring = smem + (size_t)warp * kRing * p.window;
  Coefs coefs(p.coef + d0, p.n_per, lane);

  // taps[i]: the tap of image k + i, whose window is staged or in flight.
  Tap taps[kRing - 1];
  auto issue = [&](int q) {
    const Tap t = row_tap(coefs.at(q, lane), rc, p);
    stage_window<kVec>(ring + (q % kRing) * p.window, row0 + q * image, jb.c0, t.j,
                       lane, p);
    return t;
  };
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (q < p.n_per) taps[q] = issue(q);
    litbox::cp_async_commit();
  }
  float4 acc[kReduceLaneChunks];
  for (int k = 0; k < p.n_per; ++k) {
    litbox::cp_async_wait<kRing - 2>();
    __syncwarp();  // image k's window is visible, and image k - 1's stage free
    const Tap t = taps[0];
#pragma unroll
    for (int i = 0; i + 1 < kRing - 1; ++i) taps[i] = taps[i + 1];
    if (k + kRing - 1 < p.n_per) taps[kRing - 2] = issue(k + kRing - 1);
    litbox::cp_async_commit();
    const float4* win = ring + (k % kRing) * p.window;
    if constexpr (kE1) {
      switch (t.j & 3) {
        case 0: add_image<0>(acc, win, lane, p.lane_chunks, t.f, k == 0); break;
        case 1: add_image<1>(acc, win, lane, p.lane_chunks, t.f, k == 0); break;
        case 2: add_image<2>(acc, win, lane, p.lane_chunks, t.f, k == 0); break;
        default: add_image<3>(acc, win, lane, p.lane_chunks, t.f, k == 0); break;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kReduceLaneChunks; ++u) {
        if (u < p.lane_chunks) {
          const float4 v = window_chunk(win, lane + 32 * u, t.j & 3, p.elem_scale, t.f);
          acc[u] = k == 0 ? v : add4(acc[u], v);
        }
      }
    }
  }
  float* dst = p.out + ((size_t)jb.g * p.out_rows + jb.o) * p.width;
#pragma unroll
  for (int u = 0; u < kReduceLaneChunks; ++u) {
    const int c = jb.c0 + lane + 32 * u;
    if (u < p.lane_chunks && c < p.chunks) store_chunk<kVec>(dst, c, acc[u], p);
  }
}

template <bool kVec, bool kE1>
int launch_reduce(const ShearArgs& p, cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * kRing * p.window * sizeof(float4);
  const auto kernel = shear_reduce_kernel<kVec, kE1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(p.jobs + kWarps - 1) / kWarps, 32 * kWarps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Sum each group of n / groups images' shears of rows [row_lo, row_hi) into
// out (groups, row_hi - row_lo, width).
int shear_rows(const float* img, const float* coef, float* out, int n, int rows,
               int width, int row_div, int elem_scale, int n_texels, int row_lo,
               int row_hi, int groups, cudaStream_t stream) {
  ShearArgs p;
  p.img = img;
  p.coef = coef;
  p.out = out;
  p.n_per = n / groups;
  p.rows = rows;
  p.width = width;
  p.row_div = row_div;
  p.elem_scale = elem_scale;
  p.n_texels = n_texels;
  p.row_lo = row_lo;
  p.out_rows = row_hi - row_lo;
  p.chunks = (width + 3) / 4;
  const bool vec = width % 4 == 0 && litbox::aligned16(img) && litbox::aligned16(out);
  const bool in_registers = vec && elem_scale == 1 && p.n_per == 1;
  const int cap = in_registers ? kShearLaneChunks : kReduceLaneChunks;
  p.segs = (p.chunks + 32 * cap - 1) / (32 * cap);
  p.lane_chunks = (p.chunks + 32 * p.segs - 1) / (32 * p.segs);
  // Window chunks past the segment's 32 * lane_chunks: the taps reach
  // k + e + 3 < 8 floats past a chunk's start for e = 1, otherwise the
  // second tap's two chunks start (k + e) / 4 chunks on.
  p.window = 32 * p.lane_chunks + (elem_scale == 1 ? 1 : 1 + (3 + elem_scale) / 4);
  p.center = n_texels / 2.0f;
  if (p.n_per == 0)  // empty groups sum to zero
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * groups * p.out_rows * width, stream);
  const long long jobs = (long long)groups * p.out_rows * p.segs;
  if (jobs > 0x7fffffffLL - kWarps) return (int)cudaErrorInvalidValue;
  p.jobs = (int)jobs;
  if (in_registers) {
    shear_kernel<<<(p.jobs + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(p);
    return (int)cudaGetLastError();
  }
  if (vec) return elem_scale == 1 ? launch_reduce<true, true>(p, stream)
                                  : launch_reduce<true, false>(p, stream);
  return elem_scale == 1 ? launch_reduce<false, true>(p, stream)
                         : launch_reduce<false, false>(p, stream);
}

}  // namespace

extern "C" int litbox_shear(const float* img, const float* coef, float* out,
                            int n, int rows, int width, int row_div,
                            int elem_scale, int n_texels, void* stream) {
  if (n <= 0 || rows <= 0 || width <= 0) return (int)cudaGetLastError();
  return shear_rows(img, coef, out, n, rows, width, row_div, elem_scale, n_texels, 0,
                    rows, n, (cudaStream_t)stream);
}

extern "C" int litbox_shear_reduce(const float* img, const float* coef,
                                   float* out, int n, int rows, int width,
                                   int row_div, int elem_scale, int n_texels,
                                   int row_lo, int row_hi, int groups,
                                   void* stream) {
  if (row_hi <= row_lo || groups <= 0 || width <= 0)
    return (int)cudaGetLastError();
  return shear_rows(img, coef, out, n, rows, width, row_div, elem_scale, n_texels,
                    row_lo, row_hi, groups, (cudaStream_t)stream);
}
