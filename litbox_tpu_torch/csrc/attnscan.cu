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
// Design: one warp per (bin, row). The row is walked in chunks of 32
// columns; each lane loads one column of t and of the three sources
// (coalesced 128-byte loads), the warp composes the affine maps
// (a, b) -> A*O + B with a 5-step shuffle scan, applies the carry from the
// previous chunk, stores, and broadcasts the last lane's value as the next
// carry. The TPU kernel's 128-row VMEM blocks and lane rolls have no
// counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
attnscan_rows_kernel(const float* __restrict__ t,
                     const float* __restrict__ s0,
                     const float* __restrict__ s1,
                     const float* __restrict__ s2,
                     float* __restrict__ o0, float* __restrict__ o1,
                     float* __restrict__ o2, int n_out, int rows, int width,
                     int group, int n_groups, int src_offset) {
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)n_out * rows) return;  // uniform across the warp
  const int i = (int)(warp / rows);
  const int r = (int)(warp % rows);
  const int bin = group + i * n_groups;
  const size_t plane = (size_t)rows * width;
  const float* tr = t + (size_t)bin * plane + (size_t)r * width;
  const size_t src_row = (size_t)(src_offset + bin) * plane + (size_t)r * width;
  const size_t out_row = (size_t)i * plane + (size_t)r * width;

  float c0 = 0.f, c1 = 0.f, c2 = 0.f;  // O at the column before the chunk
  for (int x0 = 0; x0 < width; x0 += 32) {
    const int x = x0 + lane;
    float a = 1.f, b0 = 0.f, b1 = 0.f, b2 = 0.f;  // identity map past the row
    if (x < width) {
      const float tv = __ldg(tr + x);
      const float st = sqrtf(tv);
      a = tv;
      b0 = __ldg(s0 + src_row + x) * st;
      b1 = __ldg(s1 + src_row + x) * st;
      b2 = __ldg(s2 + src_row + x) * st;
    }
    // Inclusive scan: compose the left neighbour's map (a_l, b_l) before
    // this lane's (a, b): A = a * a_l, B = a * b_l + b.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float al = __shfl_up_sync(kFull, a, off);
      const float bl0 = __shfl_up_sync(kFull, b0, off);
      const float bl1 = __shfl_up_sync(kFull, b1, off);
      const float bl2 = __shfl_up_sync(kFull, b2, off);
      if (lane >= off) {
        b0 = a * bl0 + b0;
        b1 = a * bl1 + b1;
        b2 = a * bl2 + b2;
        a = a * al;
      }
    }
    const float v0 = a * c0 + b0;
    const float v1 = a * c1 + b1;
    const float v2 = a * c2 + b2;
    if (x < width) {
      o0[out_row + x] = v0;
      o1[out_row + x] = v1;
      o2[out_row + x] = v2;
    }
    c0 = __shfl_sync(kFull, v0, 31);
    c1 = __shfl_sync(kFull, v1, 31);
    c2 = __shfl_sync(kFull, v2, 31);
  }
}

}  // namespace

extern "C" int litbox_attnscan_rows(const float* t, const float* s0,
                                    const float* s1, const float* s2,
                                    float* o0, float* o1, float* o2,
                                    int n_out, int rows, int width, int group,
                                    int n_groups, int src_offset,
                                    void* stream) {
  const long long warps = (long long)n_out * rows;
  const int threads = kWarpsPerBlock * 32;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    attnscan_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        t, s0, s1, s2, o0, o1, o2, n_out, rows, width, group, n_groups,
        src_offset);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* litbox_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
