// Per-row attenuation scan of the RBT resolve, for sm_90a.
//
// Replaces the Pallas kernel litbox_tpu/ops/attnscan.py::attenuation_scan_rows
// (pallas_call at :97, kernel body _scan_kernel_factory :36). For every row
// of a (D, S, S) rotated field it computes, for three colour channels in one
// pass,
//     O[x] = t[x] * O[x-1] + src_c[x] * sqrt(t[x]),   O[-1] = 0.
// Bins are selected as d = group + i * n_groups (output bin i), and the
// sources are read at bin src_offset + d, so a tracer block of a (T*D, S, S)
// source buffer is scanned without a copy.
//
// Bound: bytes. One read of t, one read of each source, one write of each
// output: 7 planes of 4 bytes per cell. The arithmetic is a handful of
// flops per cell.
//
// Design: every load of a row is issued before any carry is known. A row is
// split over the warps of a block, one warp per 128 columns (ceil(S / 128)
// warps, at most 8), and each thread owns 4 consecutive columns: it loads t
// and the three sources as float4 (scalar loads where S % 4 != 0 or a plane
// is not 16-byte aligned), and composes its 4 columns' affine maps
// O -> a * O + b_c in registers. The warp scans its 32 lanes' maps with
// shuffles (5 steps of 4 values: one ladder per 128 columns), and lane 31
// writes the warp's aggregate map to shared memory. After one barrier each
// warp composes the aggregates of the warps before it, in warp order, into
// its carry, each lane applies the maps of the lanes before it and walks its
// 4 columns, and the outputs are stored as float4. A block holds 1-8 rows
// (128-256 threads for rows of more than 96 columns). A row wider than a
// block's span (4 * blockDim.x columns, 1024 at 8 warps) is walked span by
// span, the carry composed through every warp's aggregate; the aggregates
// are double-buffered, so one barrier a span suffices. The TPU kernel's
// 128-row VMEM blocks and lane rolls have no counterpart here. Blocks of up
// to 16 or 32 warps (more rows a block, fewer blocks) measured the same or
// slower (PERF.md, section 6).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;    // warps a row at most: a span of 8 * 128 = 1024 columns
constexpr int kBlockWarps = 8;  // warps a block at most

// O -> a * O + b_c, for the three channels c.
struct Map {
  float a, b0, b1, b2;
};

// f, then g.
__device__ __forceinline__ Map then(const Map& f, const Map& g) {
  return {g.a * f.a, fmaf(g.a, f.b0, g.b0), fmaf(g.a, f.b1, g.b1), fmaf(g.a, f.b2, g.b2)};
}

__device__ __forceinline__ Map shfl_up(const Map& m, int off) {
  return {__shfl_up_sync(kFull, m.a, off), __shfl_up_sync(kFull, m.b0, off),
          __shfl_up_sync(kFull, m.b1, off), __shfl_up_sync(kFull, m.b2, off)};
}

// Columns x .. x + 3 of a row; `fill` past the row's width. kVec: x is a
// multiple of 4 and so is the width, and the row is 16-byte aligned.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, int x, int width, float fill) {
  if (kVec) {
    return x < width ? __ldg(reinterpret_cast<const float4*>(row + x))
                     : make_float4(fill, fill, fill, fill);
  }
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = x + k < width ? __ldg(row + x + k) : fill;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int x, int width, const float (&v)[4]) {
  if (kVec) {
    if (x < width) *reinterpret_cast<float4*>(row + x) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (x + k < width) row[x + k] = v[k];
}

// Thread (x, y) of a (32 * warps, rows_per_block) block scans columns
// 4x .. 4x + 3 of each span of the block's row y; see the design note.
template <bool kVec>
__global__ void __launch_bounds__(32 * kBlockWarps)
attnscan_rows_kernel(const float* __restrict__ t,
                     const float* __restrict__ s0,
                     const float* __restrict__ s1,
                     const float* __restrict__ s2,
                     float* __restrict__ o0, float* __restrict__ o1,
                     float* __restrict__ o2, int n_out, int rows, int width,
                     int group, int n_groups, int src_offset) {
  __shared__ Map agg[2][kBlockWarps];  // by span parity: each warp's aggregate
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const long long row_id = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  // A row past the last one loads and stores nothing (its width reads as
  // 0), but takes part in the block's barriers.
  const bool live = row_id < (long long)n_out * rows;
  const int live_width = live ? width : 0;
  const int i = live ? (int)(row_id / rows) : 0;
  const int r = live ? (int)(row_id % rows) : 0;
  const int bin = group + i * n_groups;
  const size_t plane = (size_t)rows * width;
  const float* tr = t + (size_t)bin * plane + (size_t)r * width;
  const size_t src_row = (size_t)(src_offset + bin) * plane + (size_t)r * width;
  const size_t out_row = (size_t)i * plane + (size_t)r * width;
  Map* const row_agg = &agg[0][0] + threadIdx.y * warps;  // this row's, parity 0

  float c0 = 0.f, c1 = 0.f, c2 = 0.f;  // O at the column before the span
  int parity = 0;
  for (int x0 = 0; x0 < width; x0 += 4 * blockDim.x, parity ^= 1) {
    const int x = x0 + 4 * threadIdx.x;
    // Past the row: t = 1 and sources 0, the identity map.
    const float4 tv = load4<kVec>(tr, x, live_width, 1.f);
    const float4 v0 = load4<kVec>(s0 + src_row, x, live_width, 0.f);
    const float4 v1 = load4<kVec>(s1 + src_row, x, live_width, 0.f);
    const float4 v2 = load4<kVec>(s2 + src_row, x, live_width, 0.f);
    const float ta[4] = {tv.x, tv.y, tv.z, tv.w};
    const float va0[4] = {v0.x, v0.y, v0.z, v0.w};
    const float va1[4] = {v1.x, v1.y, v1.z, v1.w};
    const float va2[4] = {v2.x, v2.y, v2.z, v2.w};
    Map col[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float st = sqrtf(ta[k]);
      col[k] = {ta[k], va0[k] * st, va1[k] * st, va2[k] * st};
    }
    Map m = col[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) m = then(m, col[k]);
    // Inclusive scan over the lanes: compose the lanes before this one.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Map left = shfl_up(m, off);
      if (lane >= off) m = then(left, m);
    }
    Map before = shfl_up(m, 1);  // the lanes before this one; lane 0: none
    if (lane == 0) before = {1.f, 0.f, 0.f, 0.f};
    Map* const span_agg = row_agg + parity * kBlockWarps;
    if (lane == 31) span_agg[warp] = m;
    __syncthreads();
    // The carry at the warp's first column: the span's carry through the
    // aggregates of the warps before it, in warp order. The span's carry
    // out: on through the rest.
    float d0 = c0, d1 = c1, d2 = c2;
    for (int k = 0; k < warps; ++k) {
      if (k == warp) {
        const float e0 = fmaf(before.a, d0, before.b0);
        const float e1 = fmaf(before.a, d1, before.b1);
        const float e2 = fmaf(before.a, d2, before.b2);
        float out0[4], out1[4], out2[4];
        float p0 = e0, p1 = e1, p2 = e2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p0 = fmaf(col[j].a, p0, col[j].b0);
          p1 = fmaf(col[j].a, p1, col[j].b1);
          p2 = fmaf(col[j].a, p2, col[j].b2);
          out0[j] = p0;
          out1[j] = p1;
          out2[j] = p2;
        }
        store4<kVec>(o0 + out_row, x, live_width, out0);
        store4<kVec>(o1 + out_row, x, live_width, out1);
        store4<kVec>(o2 + out_row, x, live_width, out2);
      }
      const Map g = span_agg[k];
      d0 = fmaf(g.a, d0, g.b0);
      d1 = fmaf(g.a, d1, g.b1);
      d2 = fmaf(g.a, d2, g.b2);
    }
    c0 = d0;
    c1 = d1;
    c2 = d2;
  }
}

__global__ void empty_kernel() {}

// The launch of a (n_out, rows, width) scan: ceil(width / 128) warps a row,
// at most kRowWarps, and as many rows a block as kBlockWarps allows.
void scan_launch(int n_out, int rows, int width, dim3* grid, dim3* block) {
  const int quads = (width + 3) / 4;
  const int need = (quads + 31) / 32;
  const int warps = need < 1 ? 1 : need > kRowWarps ? kRowWarps : need;
  const int per_block = kBlockWarps / warps;
  const long long total = (long long)n_out * rows;
  *block = dim3(32 * warps, per_block);
  *grid = dim3((unsigned)((total + per_block - 1) / per_block));
}

bool aligned16(const void* p) { return ((unsigned long long)p & 15ull) == 0; }

}  // namespace

extern "C" int litbox_attnscan_rows(const float* t, const float* s0,
                                    const float* s1, const float* s2,
                                    float* o0, float* o1, float* o2,
                                    int n_out, int rows, int width, int group,
                                    int n_groups, int src_offset,
                                    void* stream) {
  if ((long long)n_out * rows == 0 || width == 0) return (int)cudaGetLastError();
  dim3 grid, block;
  scan_launch(n_out, rows, width, &grid, &block);
  const bool vec = width % 4 == 0 && aligned16(t) && aligned16(s0) && aligned16(s1) &&
                   aligned16(s2) && aligned16(o0) && aligned16(o1) && aligned16(o2);
  const auto kernel = vec ? attnscan_rows_kernel<true> : attnscan_rows_kernel<false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(t, s0, s1, s2, o0, o1, o2, n_out, rows,
                                                   width, group, n_groups, src_offset);
  return (int)cudaGetLastError();
}

// An empty kernel on the grid and blocks of a (n_out, rows, width) scan: its
// time is the launch latency under the scan's time.
extern "C" int litbox_attnscan_empty(int n_out, int rows, int width, void* stream) {
  if ((long long)n_out * rows == 0 || width == 0) return (int)cudaGetLastError();
  dim3 grid, block;
  scan_launch(n_out, rows, width, &grid, &block);
  empty_kernel<<<grid, block, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* litbox_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
