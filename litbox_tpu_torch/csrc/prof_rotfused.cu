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
//   V3 and V4: one kernel, templated on the number of shears (1 or 3). A
//       block per row y, W warps each summing a contiguous range of the
//       images (images [g * ceil(N/W), (g + 1) * ceil(N/W)) for warp g) in
//       image order; the block adds the W partials in warp order,
//       ((p0 + p1) + p2) + ..., so the sum order is fixed and two calls
//       agree bit for bit. V4 takes W = 4; V3 chooses W from N
//       (shear1_warps): with one shear a warp's work an image is its row's
//       copy and one pass of taps, and a few images a warp leave the
//       copies' latency exposed. All three shears are along x, so each
//       shift is uniform over the row: computed once a row and image, its
//       floor j splits into a chunk offset j >> 2 and a float offset j & 3
//       (a template argument: the taps are fixed floats of each chunk
//       pair). A warp
//       keeps its next image's row in flight through a ring of two windows
//       in shared memory, filled by 16-byte cp.async copies (4-byte ones
//       where rows are not 16-byte aligned), each window the row shifted by
//       the first shear's chunk offset, zero outside the row. The three
//       shears run in place in the window, the last into registers (each
//       lane takes its taps before any lane writes), lane l owning L
//       consecutive 16-byte chunks (L odd, so that the lanes' 16-byte reads
//       and writes are conflict-free): L + 1 16-byte reads give its L output
//       chunks. Each shear's output window is pre-shifted by the next
//       shear's chunk offset, and the zero-outside rule is a valid chunk
//       range, applied by predicates and selects (no branches). Only
//       __syncwarp inside the image loop; one block barrier before the
//       partials are added. S <= 1024: a window stages one whole row.
//       V3 runs only the last step, the shear by alpha from the staged
//       window into registers. For V4 a ring of three windows, eight or two
//       warps a row, a separate window for the first shear's output and
//       per-chunk branches all measured slower (PERF.md, section 6).

#include <cuda_runtime.h>

#include "tile_ring.cuh"

namespace {

constexpr int kTile = litbox::kRingTile;
constexpr int kRows = litbox::kRingRows;  // threads per tile column in V2
constexpr int kStages = 6;        // V2's ring: 5 images' tiles in flight a block
constexpr int kThreads = 256;
constexpr int kV4Warps = 4;   // V4: warps a row, each summing a quarter of the images
constexpr int kMaxRowWarps = 16;  // V3: warps a row at most
constexpr int kV4Ring = 2;    // staged rows a warp, one in flight while one is sheared
constexpr int kV4MaxS = 1024;

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

struct ShearArgs {
  const float* img;
  const float* alpha;
  const float* beta;  // V4 only
  float* out;
  int n, s;
  int chunks;  // C = ceil(S / 4): 16-byte chunks a row
  int window;  // C + 1: chunks a window (the last shear's taps reach chunk C)
  float center, lim;  // S / 2; S + 2, the shift clamp
  unsigned long long* counts;  // kStats: counts[0] += bytes the copies read
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// One x-shear of a warp's window, in place. Window chunks c and c + 1 hold
// the floats the shear's output chunk c taps, kK floats in; window chunk w
// then gets output chunk c = w + q (q: the next shear's chunk offset), zero
// where c lies outside [0, C) (and, for kVec false, at floats >= S). Lane l
// writes window chunks [L l, L l + L), lane 31 also chunk 32 L (the
// window's last when C = 32 L): L + 1 (+ 1) 16-byte reads, strided by L
// (odd) across lanes, all taken before any lane writes. No branches: the
// range checks are predicates and selects.
template <int L, int kK, bool kVec>
__device__ __forceinline__ void shear_window(float4* win, int q, float f, int lane,
                                             const ShearArgs& p) {
  const int w0 = L * lane;
  float4 v[L + 2];
#pragma unroll
  for (int u = 0; u < L + 2; ++u) {
    const int c = w0 + q + u;
    v[u] = (unsigned)c <= (unsigned)p.chunks && (u <= L || lane == 31) ? win[c] : zero4();
  }
  __syncwarp();  // every lane holds its taps: the window is rewritten in place
#pragma unroll
  for (int u = 0; u <= L; ++u) {
    const int w = w0 + u, c = w + q;
    float4 o = litbox::lerp4<kK>(v[u], v[u + 1], f);
    const bool in = (unsigned)c < (unsigned)p.chunks;
    o.x = in ? o.x : 0.f;
    o.y = in ? o.y : 0.f;
    o.z = in ? o.z : 0.f;
    o.w = in ? o.w : 0.f;
    if (!kVec) {  // floats of chunk c past the row's end
      const int rem = p.s - 4 * c;
      if (rem < 4) o.w = 0.f;
      if (rem < 3) o.z = 0.f;
      if (rem < 2) o.y = 0.f;
    }
    if (w < p.window && (u < L || lane == 31)) win[w] = o;
  }
}

// The last x-shear of a warp's window, added to the lane's L output chunks.
template <int L, int kK>
__device__ __forceinline__ void shear_add(const float4* src, float4* acc, float f, int lane,
                                          const ShearArgs& p) {
  const int w0 = L * lane;
  float4 v[L + 1];
#pragma unroll
  for (int u = 0; u <= L; ++u) v[u] = w0 + u <= p.chunks ? src[w0 + u] : zero4();
#pragma unroll
  for (int u = 0; u < L; ++u) {
    const float4 o = litbox::lerp4<kK>(v[u], v[u + 1], f);
    acc[u] = make_float4(__fadd_rn(acc[u].x, o.x), __fadd_rn(acc[u].y, o.y),
                         __fadd_rn(acc[u].z, o.z), __fadd_rn(acc[u].w, o.w));
  }
}

template <int L, bool kVec>
__device__ __forceinline__ void shear_window_k(int k, float4* win, int q, float f, int lane,
                                               const ShearArgs& p) {
  switch (k) {  // warp-uniform
    case 0: shear_window<L, 0, kVec>(win, q, f, lane, p); break;
    case 1: shear_window<L, 1, kVec>(win, q, f, lane, p); break;
    case 2: shear_window<L, 2, kVec>(win, q, f, lane, p); break;
    default: shear_window<L, 3, kVec>(win, q, f, lane, p); break;
  }
}

template <int L>
__device__ __forceinline__ void shear_add_k(int k, const float4* src, float4* acc, float f,
                                            int lane, const ShearArgs& p) {
  switch (k) {
    case 0: shear_add<L, 0>(src, acc, f, lane, p); break;
    case 1: shear_add<L, 1>(src, acc, f, lane, p); break;
    case 2: shear_add<L, 2>(src, acc, f, lane, p); break;
    default: shear_add<L, 3>(src, acc, f, lane, p); break;
  }
}

// Stage row `row` shifted by q chunks: window chunk w holds the row's floats
// 4 (q + w) .. + 3, zero outside the row. Returns the bytes the lane's copies
// read from the row (zero-fills read none).
template <bool kVec>
__device__ __forceinline__ int stage_row(float4* win, const float* row, int q, int lane,
                                         const ShearArgs& p) {
  int bytes = 0;
  if (kVec) {
    for (int w = lane; w < p.window; w += 32) {
      const int a = q + w;
      const bool ok = (unsigned)a < (unsigned)p.chunks;
      litbox::cp_async16_l2(win + w, row + 4 * min(max(a, 0), p.chunks - 1), ok);
      bytes += ok ? 16 : 0;
    }
  } else {
    float* dst = reinterpret_cast<float*>(win);
    for (int v = lane; v < 4 * p.window; v += 32) {
      const int x = 4 * q + v;
      const bool ok = (unsigned)x < (unsigned)p.s;
      litbox::cp_async4(dst + v, row + min(max(x, 0), p.s - 1), ok);
      bytes += ok ? 4 : 0;
    }
  }
  return bytes;
}

// out[y] = sum_d X_a(X_b(X_a(img[d])))[y] (kShears 3, V4) or
// sum_d X_a(img[d])[y] (kShears 1, V3): a block per row y; see the design
// note. Shared memory: per warp kV4Ring windows of C + 1 chunks.
template <int kShears, bool kVec, int L, bool kStats>
__global__ void __launch_bounds__(kShears == 3 ? 32 * kV4Warps : 32 * kMaxRowWarps)
shear_accum_kernel(ShearArgs p) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = kShears == 3 ? kV4Warps : blockDim.x >> 5;
  const int y = blockIdx.x;
  const int per = (p.n + warps - 1) / warps;
  const int lo = min(p.n, warp * per), cnt = min(p.n, lo + per) - lo;
  const float rc = litbox::offset_of(y, p.center);
  const size_t plane = (size_t)p.s * p.s;
  const float* row0 = p.img + (size_t)lo * plane + (size_t)y * p.s;
  float4* ring = smem + (size_t)warp * kV4Ring * p.window;
  litbox::Coefs alphas(p.alpha + lo, cnt, lane);
  // V3 reads no beta: a Coefs of no coefficients loads nothing.
  litbox::Coefs betas(kShears == 3 ? p.beta + lo : p.alpha, kShears == 3 ? cnt : 0, lane);

  // taps[i]: the first (and last) shear's shift of image k + i, whose row
  // is staged or in flight.
  litbox::Shift taps[kV4Ring - 1];
  unsigned long long copied = 0;  // kStats only
  auto issue = [&](int q) {
    const litbox::Shift t = litbox::shift_of(alphas.at(q, lane), rc, p.lim);
    copied += stage_row<kVec>(ring + (q % kV4Ring) * p.window, row0 + q * plane, t.j >> 2,
                              lane, p);
    return t;
  };
#pragma unroll
  for (int q = 0; q < kV4Ring - 1; ++q) {
    if (q < cnt) taps[q] = issue(q);
    litbox::cp_async_commit();
  }
  float4 acc[L];
#pragma unroll
  for (int u = 0; u < L; ++u) acc[u] = zero4();
  for (int k = 0; k < cnt; ++k) {
    litbox::cp_async_wait<kV4Ring - 2>();
    __syncwarp();  // image k's row is visible, and image k - 1's slot free
    const litbox::Shift ta = taps[0];
#pragma unroll
    for (int i = 0; i + 1 < kV4Ring - 1; ++i) taps[i] = taps[i + 1];
    if (k + kV4Ring - 1 < cnt) taps[kV4Ring - 2] = issue(k + kV4Ring - 1);
    litbox::cp_async_commit();
    float4* win = ring + (k % kV4Ring) * p.window;
    if (kShears == 3) {
      const litbox::Shift tb = litbox::shift_of(betas.at(k, lane), rc, p.lim);
      shear_window_k<L, kVec>(ta.j & 3, win, tb.j >> 2, ta.f, lane, p);
      __syncwarp();
      shear_window_k<L, kVec>(tb.j & 3, win, ta.j >> 2, tb.f, lane, p);
      __syncwarp();
    }
    shear_add_k<L>(ta.j & 3, win, acc, ta.f, lane, p);
  }
  // The warps' partials, added in warp order.
  __syncwarp();  // the last window is read
  const int w0 = L * lane;
#pragma unroll
  for (int u = 0; u < L; ++u)
    if (w0 + u < p.chunks) ring[w0 + u] = acc[u];
  __syncthreads();
  const float* part = reinterpret_cast<const float*>(smem);
  const size_t stride = (size_t)kV4Ring * p.window * 4;  // floats between partials
  for (int x = threadIdx.x; x < p.s; x += blockDim.x) {
    float sum = part[x];
#pragma unroll 4
    for (int g = 1; g < warps; ++g) sum = __fadd_rn(sum, part[g * stride + x]);
    p.out[(size_t)y * p.s + x] = sum;
  }
  if (kStats) litbox::count_add(p.counts, copied);
}

template <int kShears, bool kVec, int L>
int launch_shears(const ShearArgs& p, int warps, cudaStream_t stream) {
  const size_t smem = (size_t)warps * kV4Ring * p.window * sizeof(float4);
  const auto kernel = p.counts ? shear_accum_kernel<kShears, kVec, L, true>
                               : shear_accum_kernel<kShears, kVec, L, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)p.s, 32 * warps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int kShears, bool kVec>
int launch_shears_vec(const ShearArgs& p, int warps, cudaStream_t stream) {
  // L: the least odd number with 32 L >= C.
  switch (((p.chunks + 31) / 32) | 1) {
    case 1: return launch_shears<kShears, kVec, 1>(p, warps, stream);
    case 3: return launch_shears<kShears, kVec, 3>(p, warps, stream);
    case 5: return launch_shears<kShears, kVec, 5>(p, warps, stream);
    case 7: return launch_shears<kShears, kVec, 7>(p, warps, stream);
    default: return launch_shears<kShears, kVec, 9>(p, warps, stream);
  }
}

template <int kShears>
int launch_shears_for(const float* img, const float* alpha, const float* beta, float* out,
                      int n, int s, int warps, unsigned long long* counts,
                      cudaStream_t stream) {
  ShearArgs p;
  p.img = img;
  p.alpha = alpha;
  p.beta = beta;
  p.out = out;
  p.n = n;
  p.s = s;
  p.chunks = (s + 3) / 4;
  p.window = p.chunks + 1;
  p.center = s / 2.0f;
  p.lim = (float)(s + 2);
  p.counts = counts;
  if (s % 4 == 0 && litbox::aligned16(img))
    return launch_shears_vec<kShears, true>(p, warps, stream);
  return launch_shears_vec<kShears, false>(p, warps, stream);
}

// V3's warps a row for N images: two images a warp, from 4 to 16 warps, up
// to 32 images, so that a small N still keeps several rows' copies in
// flight a block; V4's four beyond, where a block of 16 warps (82 KB of
// windows at S=640) leaves room for only two blocks an SM.
int shear1_warps(int n) {
  if (n > 32) return kV4Warps;
  return max(kV4Warps, min(kMaxRowWarps, (n + 1) / 2));
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

// s <= 1024; any s, as V4.
extern "C" int litbox_prof_shear1_accum(const float* img, const float* alpha,
                                        float* out, int n, int s, void* stream) {
  if (s > kV4MaxS || n < 0) return (int)cudaErrorInvalidValue;
  if (s == 0) return (int)cudaGetLastError();
  return launch_shears_for<1>(img, alpha, nullptr, out, n, s, shear1_warps(n), nullptr,
                              (cudaStream_t)stream);
}

// s <= 1024; any s: 16-byte copies where s % 4 == 0 and img is 16-byte
// aligned, 4-byte copies otherwise. counts: null, or one device uint64 to
// which the kernel adds the bytes its copies read (a separate instance: the
// counting costs the plain launch nothing).
extern "C" int litbox_prof_shear3_accum(const float* img, const float* alpha,
                                        const float* beta, float* out, int n,
                                        int s, unsigned long long* counts, void* stream) {
  if (s > kV4MaxS || n < 0) return (int)cudaErrorInvalidValue;
  if (s == 0) return (int)cudaGetLastError();
  return launch_shears_for<3>(img, alpha, beta, out, n, s, kV4Warps, counts,
                              (cudaStream_t)stream);
}
