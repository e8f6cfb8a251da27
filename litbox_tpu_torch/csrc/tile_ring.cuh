// Helpers for kernels that stage float32 rows or tiles from device memory in
// shared memory with cp.async (sm_80 and later): the copies (16-byte, with an
// L2 prefetch hint, or 4-byte; zero-filled where invalid), their
// commit/wait groups, the swizzled layout a staged 32x32 tile lands in, and
// the two-tap shear arithmetic with its rounding pinned. Used by
// csrc/rotate.cu (K2, K3), csrc/rotfused.cu (K4), csrc/prof_rotfused.cu (V2's
// ring of tiles, V4's ring of rows) and csrc/prof_microops.cu (transpose2).
//
// Layout of a staged tile: row r holds its eight 16-byte chunks in the
// order chunk ^ (r % 8) (an XOR swizzle at float4 granularity). A 16-byte
// cp.async cannot land in the usual 33-float padded row, whose stride is
// not a multiple of 16 bytes; with the swizzle, the eight lanes of a
// quarter-warp that read one chunk column of eight consecutive rows hit
// eight different groups of four banks, and the 32 texels of one row stay
// a permutation of the 32 banks.

#pragma once

#include <cuda_runtime.h>

namespace litbox {

constexpr int kRingTile = 32;                        // tile side, floats
constexpr int kRingTileFloats = kRingTile * kRingTile;  // 4 KB a stage

__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kRingTile + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

// Copy 16 (or 4) bytes from device memory to shared memory without going
// through registers; when `valid` is false nothing is read and the
// destination is filled with zeros (the src-size operand is 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

// A 16-byte cp.async that also asks L2 to fetch the 256-byte block around
// it, for copies of contiguous runs of chunks.
__device__ __forceinline__ void cp_async16_l2(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's committed groups are in
// flight; a __syncthreads after it makes every thread's copies visible.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Thread (x, y) of a (32, 8) block issues its share of the copies of the
// tile at (x0, y0) of one (s, s) plane into `stage` (swizzled); texels
// outside the plane become 0. kVec: one 16-byte copy a thread, for s % 4 == 0
// and a 16-byte aligned plane (a row's chunk then lies wholly inside or
// wholly outside the plane); otherwise four 4-byte copies a thread. Either
// way a warp reads whole 128-byte row segments.
constexpr int kRingRows = 8;  // blockDim.y

template <bool kVec>
__device__ __forceinline__ void stage_tile(float* stage, const float* plane, int x0,
                                           int y0, int s) {
  if (kVec) {
    const int t = threadIdx.y * kRingTile + threadIdx.x;
    const int r = t >> 3, c = (t & 7) << 2;
    const bool ok = y0 + r < s && x0 + c < s;
    cp_async16(stage + swizzled(r, c), ok ? plane + (size_t)(y0 + r) * s + x0 + c : plane,
               ok);
  } else {
    const int c = threadIdx.x;
#pragma unroll
    for (int r = threadIdx.y; r < kRingTile; r += kRingRows) {
      const bool ok = y0 + r < s && x0 + c < s;
      cp_async4(stage + swizzled(r, c), ok ? plane + (size_t)(y0 + r) * s + x0 + c : plane,
                ok);
    }
  }
}

// The shear of a row (or column) at offset rc = p + 0.5 - n / 2 from the
// centre: shift s = coef * rc, taps at floor(s) and floor(s) + 1 with weights
// 1 - f and f, f = s - floor(s). The shift is clamped to +-lim (n + 2 for n
// texels), where every tap already lies outside [0, n).
struct Shift {
  int j;
  float f;
};

__device__ __forceinline__ Shift shift_of(float coef, float rc, float lim) {
  const float s = __fmul_rn(coef, rc);
  const float fi = floorf(s);
  return {(int)fminf(fmaxf(fi, -lim), lim), __fsub_rn(s, fi)};
}

// p + 0.5 - center, rounded as the plain versions round it.
__device__ __forceinline__ float offset_of(int p, float center) {
  return __fsub_rn(__fadd_rn((float)p, 0.5f), center);
}

// (1 - f) * a + f * b with its rounding pinned, so that kernels sharing it
// agree bit for bit.
__device__ __forceinline__ float lerp_tap(float a, float b, float f) {
  return __fmaf_rn(b, f, __fmul_rn(a, __fsub_rn(1.f, f)));
}

// The four outputs of a 16-byte chunk whose taps start kK floats into lo
// (then hi), for a shift that is the same for the whole warp.
template <int kK>
__device__ __forceinline__ float4 lerp4(float4 lo, float4 hi, float f) {
  const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_float4(lerp_tap(v[kK], v[kK + 1], f), lerp_tap(v[kK + 1], v[kK + 2], f),
                     lerp_tap(v[kK + 2], v[kK + 3], f), lerp_tap(v[kK + 3], v[kK + 4], f));
}

// coef[q] for q = 0, 1, 2, ... in turn, for a warp: lane l holds coef[base + l]
// and the next 32, so a coefficient costs a shuffle, and each load is issued
// 32 images before it is read.
struct Coefs {
  const float* c;
  int n, base;
  float cur, nxt;
  __device__ __forceinline__ Coefs(const float* coef, int n_per, int lane)
      : c(coef), n(n_per), base(0) {
    cur = lane < n ? __ldg(c + lane) : 0.f;
    nxt = 32 + lane < n ? __ldg(c + 32 + lane) : 0.f;
  }
  __device__ __forceinline__ float at(int q, int lane) {
    if (q >= base + 32) {  // warp-uniform: q grows by one a call
      base += 32;
      cur = nxt;
      nxt = base + 32 + lane < n ? __ldg(c + base + 32 + lane) : 0.f;
    }
    return __shfl_sync(0xffffffffu, cur, q & 31);
  }
};

// Adds every thread's v to *counter, one atomic a warp (all 32 lanes must
// call it): for kernels that count the work they did when asked to.
__device__ __forceinline__ void count_add(unsigned long long* counter, unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(counter, v);
}

inline bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0;
}

}  // namespace litbox
