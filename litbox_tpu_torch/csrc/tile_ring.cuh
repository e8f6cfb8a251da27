// Helpers for kernels that stage 32x32 float32 tiles from device memory in
// shared memory with cp.async (sm_80 and later): the copies, their
// commit/wait groups, and the swizzled layout a staged tile lands in. Used
// by csrc/prof_rotfused.cu (V2's ring of stages) and csrc/prof_microops.cu
// (transpose2's one stage).
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

inline bool aligned16(const void* p) {
  return ((unsigned long long)p & 15ull) == 0;
}

}  // namespace litbox
