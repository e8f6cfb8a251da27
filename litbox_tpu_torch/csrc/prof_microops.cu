// Data-movement micro-kernels for sm_90a, each over N float32 images of
// (S, S), each writing an (N, S, S) output: the prices of the transposes,
// rolls and flips that a rotate built from shears moves its planes with.
//
// Replaces the Pallas kernels of runs/prof_microops.py (one image per grid
// step there):
//   transpose  (:55,  k_transpose)   out[d] = x[d]^T
//   transpose2 (:72,  k_transpose2)  out[d] = ((x[d]^T) * 2)^T, through two
//                                    transposes kept on chip (= 2 * x[d],
//                                    exactly)
//   roll_rows  (:95,  k_subroll)     out[d][y][x] = x[d][(y - sh) mod S][x]
//   roll_cols  (:119, k_laneroll)    out[d][y][x] = x[d][y][(x - sh) mod S]
//   flip2      (:145, k_flip)        out[d][y][x] = x[d][S-1-y][S-1-x]
// with sh = shifts[d] reduced by floor modulo (jnp's `%`, torch.roll's
// shift), so a negative shift or one >= S rolls as jnp.roll does. The TPU's
// 128-lane strips and 8-row blocks are its tiling, not carried over: any S
// works.
//
// Bound: bytes for all five. Each reads every input texel once and writes
// every output texel once: 2 * 4 * N * S * S bytes (0.3756 ms at N=384,
// S=640, at 3.35 TB/s). transpose2's multiply is one operation a texel.
//
// Designs:
//   transpose: one block per 32x32 tile and image, a 32x33 shared tile (the
//     pad column keeps the transposed read free of bank conflicts); the
//     warps read rows of the input and write rows of the output, coalesced.
//   transpose2: one block per 32x32 tile and image, as transpose. The tile
//     arrives by one 16-byte cp.async copy a thread (no registers on the
//     way) in a shared stage XOR-swizzled at float4 granularity
//     (tile_ring.cuh), so the copies land, and the first transpose reads
//     them, free of bank conflicts; it is transposed into a 32x33 shared
//     tile while scaled by 2 and read back transposed into one 16-byte
//     store a thread: two in-shared-memory transposes, one pass through
//     device memory. Eight blocks resident an SM (8.3 KB of shared memory
//     each) keep eight tiles' copies in flight while the others transpose:
//     the block scheduler overlaps one tile's load with another's work.
//     What bounds it is the memory's rate for this access pattern (32 rows
//     of 128 bytes a tile). Designs that overlap inside a block, a cp.async
//     ring over 2-8 images or 2 tiles a block, moved the same bytes slower
//     on an H100 80GB HBM3 at 700 W. Rows that are not 16-byte aligned
//     (S % 4 != 0) take 4-byte copies and stores.
//   roll_rows, roll_cols, flip2: eight output texels a thread, 256 apart,
//     the image from blockIdx.y; all eight loads are issued before the
//     stores, so enough bytes are in flight to cover the memory's latency
//     (one texel a thread reached 51-64% of the bound on an H100 80GB HBM3
//     at 700 W). The lanes of a warp write consecutive texels of a row and
//     read consecutive (roll) or reversed (flip) texels of one source row,
//     so both sides are coalesced except at the roll's wrap.

#include <cuda_runtime.h>

#include "tile_ring.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;       // threads per tile column in the transposes
constexpr int kThreads = 256;  // the per-texel kernels
constexpr int kPer = 8;        // texels per thread in the per-texel kernels
constexpr int kMaxImages = 65535;  // grid.y / grid.z

__global__ void __launch_bounds__(kTile * kRows)
transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int s) {
  __shared__ float tile[kTile][kTile + 1];
  const size_t plane = (size_t)blockIdx.z * s * s;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int x = x0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int y = y0 + j;
    if (x < s && y < s) tile[j][threadIdx.x] = __ldg(in + plane + (size_t)y * s + x);
  }
  __syncthreads();
  const int ox = y0 + threadIdx.x;  // output column = input row
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int oy = x0 + j;          // output row = input column
    if (ox < s && oy < s) out[plane + (size_t)oy * s + ox] = tile[threadIdx.x][j];
  }
}

// One block per 32x32 tile and image, as for transpose. The tile arrives by
// cp.async in a swizzled stage `a` (tile_ring.cuh), is transposed into `b`
// while scaled by 2, and `b` is read back transposed into the output tile at
// its own position: two transposes in shared memory, each behind a
// __syncthreads.
template <bool kVec>
__global__ void __launch_bounds__(kTile * kRows)
transpose2_kernel(const float* __restrict__ in, float* __restrict__ out, int s) {
  __shared__ __align__(16) float a[litbox::kRingTileFloats];  // the tile as read
  __shared__ float b[kTile][kTile + 1];                       // its transpose, scaled
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t plane = (size_t)blockIdx.z * s * s;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  litbox::stage_tile<kVec>(a, in + plane, x0, y0, s);
  litbox::cp_async_commit();
  litbox::cp_async_wait<0>();
  __syncthreads();
  // Transpose 1, b = 2 * a^T: warp ty takes chunk column ty; lane tx reads
  // the 16 bytes of row tx there (conflict-free by the swizzle) and writes
  // them down column tx of b's rows 4ty..4ty+3 (stride 33: conflict-free).
  const float4 v = *reinterpret_cast<const float4*>(a + litbox::swizzled(tx, 4 * ty));
  b[4 * ty][tx] = v.x * 2.f;
  b[4 * ty + 1][tx] = v.y * 2.f;
  b[4 * ty + 2][tx] = v.z * 2.f;
  b[4 * ty + 3][tx] = v.w * 2.f;
  __syncthreads();
  // Transpose 2, the output tile = b^T.
  float* dst = out + plane;
  if (kVec) {
    // Thread (row r, chunk k) gathers b[4k..4k+3][r] (the banks 4k + r + i
    // mod 32 differ across a warp) into one 16-byte store.
    const int u = ty * kTile + tx, r = u >> 3, c = (u & 7) << 2;
    if (y0 + r < s && x0 + c < s)
      *reinterpret_cast<float4*>(dst + (size_t)(y0 + r) * s + x0 + c) =
          make_float4(b[c][r], b[c + 1][r], b[c + 2][r], b[c + 3][r]);
  } else {
#pragma unroll
    for (int r = ty; r < kTile; r += kRows)
      if (y0 + r < s && x0 + tx < s) dst[(size_t)(y0 + r) * s + x0 + tx] = b[tx][r];
  }
}

__device__ __forceinline__ int floor_mod(int v, int s) {
  const int r = v % s;  // C's % truncates toward zero
  return r < 0 ? r + s : r;
}

// kMode 0: roll rows (axis 0), 1: roll columns (axis 1), 2: flip both axes.
// A block covers kThreads * kPer consecutive texels of one image; thread t
// takes texels t, t + kThreads, ..., so each of its kPer loads is part of
// a coalesced warp access, and all of them are issued before the stores.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
move_kernel(const float* __restrict__ in, const int* __restrict__ shifts,
            float* __restrict__ out, int s) {
  const int texels = s * s;
  const size_t plane = (size_t)blockIdx.y * texels;
  const int first = blockIdx.x * (kThreads * kPer) + threadIdx.x;
  const int sh = kMode == 2 ? 0 : floor_mod(__ldg(shifts + blockIdx.y), s);
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = first + k * kThreads;
    if (i >= texels) break;
    const int y = i / s, x = i - y * s;
    int sy = y, sx = x;
    if (kMode == 2) {
      sy = s - 1 - y;
      sx = s - 1 - x;
    } else if (kMode == 0) {
      sy = y - sh;
      if (sy < 0) sy += s;
    } else {
      sx = x - sh;
      if (sx < 0) sx += s;
    }
    v[k] = __ldg(in + plane + (size_t)sy * s + sx);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = first + k * kThreads;
    if (i >= texels) break;
    out[plane + i] = v[k];
  }
}

int launch_tiles(const float* in, float* out, int n, int s, cudaStream_t stream) {
  if (n > kMaxImages) return (int)cudaErrorInvalidValue;
  if (n > 0 && s > 0) {
    const unsigned tiles = (unsigned)((s + kTile - 1) / kTile);
    const dim3 grid(tiles, tiles, n), block(kTile, kRows);
    transpose_kernel<<<grid, block, 0, stream>>>(in, out, s);
  }
  return (int)cudaGetLastError();
}

template <bool kVec>
int launch_transpose2(const float* in, float* out, int n, int s, cudaStream_t stream) {
  const unsigned tiles = (unsigned)((s + kTile - 1) / kTile);
  transpose2_kernel<kVec><<<dim3(tiles, tiles, n), dim3(kTile, kRows), 0, stream>>>(
      in, out, s);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_move(const float* in, float* out, const int* shifts, int n, int s,
                cudaStream_t stream) {
  constexpr int span = kThreads * kPer;
  if (n > kMaxImages || (long long)s * s + span > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n > 0 && s > 0) {
    const dim3 grid((unsigned)(((long long)s * s + span - 1) / span), (unsigned)n);
    move_kernel<kMode><<<grid, kThreads, 0, stream>>>(in, shifts, out, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// in, out: (n, s, s) float32, n <= 65535; shifts: (n,) int32 on the device.
extern "C" int litbox_prof_transpose(const float* in, float* out, int n, int s,
                                     void* stream) {
  return launch_tiles(in, out, n, s, (cudaStream_t)stream);
}

// transpose2 takes any s: 16-byte copies and stores where s % 4 == 0 and
// both pointers are 16-byte aligned, 4-byte ones otherwise.
extern "C" int litbox_prof_transpose2(const float* in, float* out, int n, int s,
                                      void* stream) {
  if (n > kMaxImages) return (int)cudaErrorInvalidValue;
  if (n == 0 || s == 0) return (int)cudaGetLastError();
  if (s % 4 == 0 && litbox::aligned16(in) && litbox::aligned16(out))
    return launch_transpose2<true>(in, out, n, s, (cudaStream_t)stream);
  return launch_transpose2<false>(in, out, n, s, (cudaStream_t)stream);
}

extern "C" int litbox_prof_roll_rows(const float* in, float* out, const int* shifts,
                                     int n, int s, void* stream) {
  return launch_move<0>(in, out, shifts, n, s, (cudaStream_t)stream);
}

extern "C" int litbox_prof_roll_cols(const float* in, float* out, const int* shifts,
                                     int n, int s, void* stream) {
  return launch_move<1>(in, out, shifts, n, s, (cudaStream_t)stream);
}

extern "C" int litbox_prof_flip2(const float* in, float* out, int n, int s,
                                 void* stream) {
  return launch_move<2>(in, out, nullptr, n, s, (cudaStream_t)stream);
}
