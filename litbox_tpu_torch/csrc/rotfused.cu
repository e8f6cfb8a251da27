// Whole-image three-shear rotation summed per quadrant run, for sm_90a.
//
// Replaces the Pallas kernel litbox_tpu/ops/rotate.py::rotate_planar_sum_fused
// (pallas_call at :458; body _rot3sum_kernel_factory :342, shear
// _shear_block_dyn :301). For each channel plane img (D, S, S), the bin
// coefficients alpha[d], beta[d] and R contiguous runs of bins, it writes
//     P[r] = sum over d in run r, in bin order, of X_a(Y_b(X_a(img[d])))
// where, with c = S/2,
//     X_a(I)[y, x] = (1 - f) I[y, x + i] + f I[y, x + i + 1],
//                    i + f = a (y + 0.5 - c)   (shift along x, by row)
//     Y_b(I)[y, x] = (1 - f) I[y + i, x] + f I[y + i + 1, x],
//                    i + f = b (x + 0.5 - c)   (shift along y, by column)
// and every tap outside [0, S) counts 0, at every stage. The rot90 of each
// run's partial and the sum over runs stay outside the kernel, as in the JAX
// package.
//
// Bound: bytes. The work reads every input plane once and writes R partial
// planes per channel. Per image and output texel it does 7 two-tap lerps
// (3 operations each) and 7 shift evaluations (4 each): 49 float operations,
// under the float32 rate's share at these sizes.
//
// Design: one launch for all channels and runs. A block owns a 32x32 output
// tile of one channel and one run and walks the run's images in bin order
// with four register accumulators a thread. For each image it stages, in
// shared memory, the source window the tile's composite reaches: the last
// (x) shear of rows [Y0, Y0 + 32) reaches the middle shear's columns
// [xl, xl + wt2), computed from a at the tile's first and last rows (the
// shift is monotone in the row); the middle (y) shear of those columns
// reaches the first shear's rows [yl, yl + h), computed from b at the first
// and last column; and the first shear of row y' reaches source columns
// xl + ja(y') .. + wt2 of that row. So the window is h rows of wt2 + 1
// floats, each row shifted by its own ja(y'), copied as 16-byte cp.async
// chunks (4-byte copies where rows are not 16-byte aligned) into a row of
// 64 floats, zero-filled outside the plane: rows past the plane read 0,
// never the neighbouring image. Over the bins' residuals (|a| <= tan(pi/8),
// |b| <= sin(pi/4)) a window is at most 68 x 48 floats; a stage holds 72 rows
// of up to 60 middle-shear columns. The three shears then run:
//   first + middle, fused a column at a time: thread (group g, column i)
//     computes the 9 first-shear values its column's middle shear taps for
//     t2 rows [8g, 8g + 8) (a uniform shift a row, read from a per-row table
//     written with the copies) and the 8 middle-shear values from them in
//     registers (a uniform shift a column), into a 32 x 60 shared tile t2;
//     a column outside [0, S) writes zeros;
//   last: thread (row, lane) adds the lerp of two t2 values at the row's
//     uniform shift (a per-row table) to its accumulator.
// Intermediate positions outside [0, S) count 0 as in the plain version:
// first-shear rows outside the plane come from zero rows, middle-shear
// columns outside it are written as 0, and source columns outside it are
// zero-filled chunks. A ring of two stages keeps the next image's window in
// flight while one is sheared; t2 is double-buffered and the last shear of
// image d runs after the first two of image d + 1 are issued, so one
// __syncthreads an image suffices. One lane computes each window two images
// ahead into a small ring of headers; the copies are issued from the last
// warp down and the column pass from the first warp up, so that the block's
// slowest warp carries as little as possible. An image whose window does
// not fit a stage (coefficients beyond the residuals: any alpha, beta are
// exact) is taken, in the same kernel and in its place in the sum, by
// evaluating the composite directly as 8 taps of the image per output texel
// through L1, chosen per block and image on the device. The sum order is the
// bin order in both paths; the taps round through the same lerp, so the two
// paths agree bit for bit and two calls give equal bits. Given a counts
// array, a separate instance also counts the windows it took, those it
// staged, their texels and the bytes their copies read.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py): 0.61 ms at 3 x (128, 640,
// 640), 32% of the bound (one thread a texel, 8 taps through L1, before:
// 1.32 ms). Its staged copies read 7.39 bytes per output texel and image
// there (its own counts), 1.85x the bound's 4. The kernel is bound by the
// instructions and latencies of its per-image steps, not by bytes: removing
// the copies or the column pass each takes off little, a third stage at the
// same four blocks an SM or a fifth block an SM (one t2 tile) changes
// nothing, and 512 threads a block or two t2 row groups were slower.

#include <cuda_runtime.h>

#include <atomic>

#include "tile_ring.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kThreads = 256;           // 8 warps: 4 output rows a thread
constexpr int kRowsPerThread = kTile / (kThreads / 32);
constexpr int kGroups = 4;              // t2 row groups of the column pass
constexpr int kGroupRows = kTile / kGroups;
constexpr int kPitch = 64;              // floats a staged row (16 chunks)
constexpr int kStageRows = 72;
constexpr int kMidCols = 60;            // t2 columns a stage can serve
constexpr int kStages = 2;
constexpr int kRowThreads = 4;          // threads copying one staged row
constexpr int kMaxRuns = 8;
constexpr int kMaxChannels = 8;

struct Rot3Args {
  const float* img[kMaxChannels];
  const float* alpha;
  const float* beta;
  float* out;
  int s, chunks, n_runs;
  int start[kMaxRuns + 1];
  float center, lim;
  // kStats: counts[0..3] += (image, tile) windows, staged windows, their
  // output texels, and the bytes their copies read from device memory.
  unsigned long long* counts;
};

// One image's window for one tile, computed once a block and image.
struct Header {
  int xl, wt2, yl, h;
  float a, b;
  int staged;
};

// A staged row's first shear: middle column i taps the stage at p + i and
// p + i + 1 with weights g = 1 - f and f.
struct RowTap {
  int p;
  float f, g;
  int pad;
};

// A t2 row's last shear: output lane l taps t2 at off + l and off + l + 1.
struct LastTap {
  int off;
  float f, g;
  int pad;
};

struct alignas(16) Stage {
  float rows[kStageRows * kPitch];
  RowTap tap[kStageRows];
};

struct Smem {
  Stage stage[kStages];
  float t2[2][kTile * kMidCols];
  LastTap last[2][kTile];
  Header hdr[kStages + 1];  // images d .. d + kStages: in use, staged, next
};

__device__ __forceinline__ litbox::Shift shift_at(float coef, int p, const Rot3Args& a) {
  return litbox::shift_of(coef, litbox::offset_of(p, a.center), a.lim);
}

// lerp_tap with 1 - f given: the same bits.
__device__ __forceinline__ float lerp_fg(float a, float b, float f, float g) {
  return __fmaf_rn(b, f, __fmul_rn(a, g));
}

__device__ __forceinline__ Header window_of(float a, float b, int x0, int y0,
                                            const Rot3Args& p) {
  Header h;
  h.a = a;
  h.b = b;
  const int ja0 = shift_at(a, y0, p).j, ja1 = shift_at(a, y0 + kTile - 1, p).j;
  h.xl = x0 + min(ja0, ja1);
  const int xh = x0 + kTile + max(ja0, ja1);  // last middle-shear column tapped
  h.wt2 = xh - h.xl + 1;
  const int jb0 = shift_at(b, h.xl, p).j, jb1 = shift_at(b, xh, p).j;
  h.yl = y0 + min(jb0, jb1);
  h.h = y0 + kTile + max(jb0, jb1) - h.yl + 1;
  // A row of the window spans wt2 + 1 floats from offset 0..3 of a chunk.
  h.staged = h.wt2 <= kMidCols && (h.wt2 + 3) / 4 + 1 <= kPitch / 4 && h.h <= kStageRows;
  return h;
}

// Issue the copies of one image's window into `st`, with its row table:
// kRowThreads threads a row, each every kRowThreads-th chunk (or float),
// taken from the last warp down, so that the copies fall mostly to the
// warps that the column pass (from the first warp up) leaves idle. Returns
// the bytes this thread's copies read from the plane (zero-fills read none).
template <bool kVec>
__device__ __forceinline__ int stage_window(Stage& st, const float* plane, const Header& h,
                                            const Rot3Args& p) {
  const int nch = (h.wt2 + 3) / 4 + 1;
  int bytes = 0;
  const int tr = kThreads - 1 - threadIdx.x;  // from the last warp down
  const int t = tr % kRowThreads;
  for (int r = tr / kRowThreads; r < h.h; r += kThreads / kRowThreads) {
    const int y = h.yl + r;
    const litbox::Shift ja = shift_at(h.a, y, p);
    const int cs = (h.xl + ja.j) >> 2;  // floor: the row's first chunk
    const bool row_ok = y >= 0 && y < p.s;
    const float* row = plane + (size_t)(row_ok ? y : 0) * p.s;
    float* dst = st.rows + r * kPitch;
    if (kVec) {
      const float* src = row + 4 * (cs + t);  // dereferenced only where in the row
#pragma unroll
      for (int k = 0; k < kPitch / 4 / kRowThreads; ++k) {
        const int e = t + kRowThreads * k, c = cs + e;
        const bool ok = row_ok && (unsigned)c < (unsigned)p.chunks;
        if (e < nch) {
          litbox::cp_async16_l2(dst + 4 * e, ok ? src + 4 * kRowThreads * k : row, ok);
          bytes += ok ? 16 : 0;
        }
      }
    } else {
      const float* src = row + 4 * cs + t;
#pragma unroll
      for (int k = 0; k < kPitch / kRowThreads; ++k) {
        const int e = t + kRowThreads * k, x = 4 * cs + e;
        const bool ok = row_ok && (unsigned)x < (unsigned)p.s;
        if (e < 4 * nch) {
          litbox::cp_async4(dst + e, ok ? src + kRowThreads * k : row, ok);
          bytes += ok ? 4 : 0;
        }
      }
    }
    if (t == 0) st.tap[r] = {r * kPitch + h.xl + ja.j - 4 * cs, ja.f, __fsub_rn(1.f, ja.f), 0};
  }
  return bytes;
}

// First and middle shear, a column at a time, into t2 (32 rows x kMidCols).
__device__ __forceinline__ void column_pass(const Stage& st, const Header& h, float* t2,
                                            int y0, const Rot3Args& p) {
  const int t = threadIdx.x;
  if (t >= kGroups * h.wt2) return;
  int g = 0;
#pragma unroll
  for (int k = 1; k < kGroups; ++k) g += t >= k * h.wt2;
  const int i = t - g * h.wt2;
  const int x = h.xl + i;
  float* dst = t2 + g * kGroupRows * kMidCols + i;
  if (x < 0 || x >= p.s) {
#pragma unroll
    for (int m = 0; m < kGroupRows; ++m) dst[m * kMidCols] = 0.f;
    return;
  }
  const litbox::Shift jb = shift_at(h.b, x, p);
  const float gb = __fsub_rn(1.f, jb.f);
  const int r0 = y0 + g * kGroupRows + jb.j - h.yl;
  float v[kGroupRows + 1];
#pragma unroll
  for (int m = 0; m <= kGroupRows; ++m) {
    const RowTap rt = st.tap[r0 + m];
    v[m] = lerp_fg(st.rows[rt.p + i], st.rows[rt.p + i + 1], rt.f, rt.g);
  }
#pragma unroll
  for (int m = 0; m < kGroupRows; ++m) dst[m * kMidCols] = lerp_fg(v[m], v[m + 1], jb.f, gb);
}

// The last shear's taps of the tile's 32 rows, a lane a row.
__device__ __forceinline__ void last_taps(LastTap* last, const Header& h, int x0, int y0,
                                          const Rot3Args& p) {
  const int r = threadIdx.x & 31;
  const litbox::Shift ja = shift_at(h.a, y0 + r, p);
  last[r] = {r * kMidCols + x0 + ja.j - h.xl, ja.f, __fsub_rn(1.f, ja.f), 0};
}

// The last (x) shear of t2 into the accumulators.
__device__ __forceinline__ void last_pass(const float* t2, const LastTap* last, float* acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const LastTap lt = last[warp + k * (kThreads / 32)];
    const float* src = t2 + lt.off + lane;
    acc[k] = __fadd_rn(acc[k], lerp_fg(src[0], src[1], lt.f, lt.g));
  }
}

// The general path: the composite as 8 taps of the image through L1.
__device__ __forceinline__ float first_tap(const float* plane, int yt, int xt, float a,
                                           const Rot3Args& p) {
  const litbox::Shift t = shift_at(a, yt, p);
  const int x0 = xt + t.j;
  const float* row = plane + (size_t)yt * p.s;
  const float v0 = x0 >= 0 && x0 < p.s ? __ldg(row + x0) : 0.f;
  const float v1 = x0 + 1 >= 0 && x0 + 1 < p.s ? __ldg(row + x0 + 1) : 0.f;
  return litbox::lerp_tap(v0, v1, t.f);
}

__device__ __forceinline__ float middle_tap(const float* plane, int y, int xt, float a,
                                            float b, const Rot3Args& p) {
  const litbox::Shift t = shift_at(b, xt, p);
  const int y0 = y + t.j;
  const float v0 = y0 >= 0 && y0 < p.s ? first_tap(plane, y0, xt, a, p) : 0.f;
  const float v1 = y0 + 1 >= 0 && y0 + 1 < p.s ? first_tap(plane, y0 + 1, xt, a, p) : 0.f;
  return litbox::lerp_tap(v0, v1, t.f);
}

__device__ __forceinline__ void tap_pass(const float* plane, float a, float b, float* acc,
                                         int x0, int y0, const Rot3Args& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = x0 + lane;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int y = y0 + warp + k * (kThreads / 32);
    if (x >= p.s || y >= p.s) continue;
    const litbox::Shift t = shift_at(a, y, p);
    const int xs = x + t.j;
    const float v0 = xs >= 0 && xs < p.s ? middle_tap(plane, y, xs, a, b, p) : 0.f;
    const float v1 = xs + 1 >= 0 && xs + 1 < p.s ? middle_tap(plane, y, xs + 1, a, b, p) : 0.f;
    acc[k] = __fadd_rn(acc[k], litbox::lerp_tap(v0, v1, t.f));
  }
}

template <bool kVec, bool kStats>
__global__ void __launch_bounds__(kThreads) rot3sum_kernel(Rot3Args p) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int ch = blockIdx.z / p.n_runs, run = blockIdx.z % p.n_runs;
  const int d0 = p.start[run], n = p.start[run + 1] - d0;
  const size_t plane = (size_t)p.s * p.s;
  const float* img = p.img[ch] + (size_t)d0 * plane;
  const float* alpha = p.alpha + d0;
  const float* beta = p.beta + d0;
  constexpr int kHdrs = kStages + 1;

  // The last warp's first lane computes each image's window kStages images
  // ahead of its use, the coefficients loaded one image before that (the
  // last warp has the least other work); its lanes q < kStages compute the
  // first kStages windows.
  const bool header_lane = tid == kThreads - 32;
  float na = 0.f, nb = 0.f;
  if (tid >= kThreads - 32) {
    const int q = tid - (kThreads - 32);
    if (q < kStages && q < n) sm.hdr[q] = window_of(__ldg(alpha + q), __ldg(beta + q), x0, y0, p);
    if (header_lane && kStages < n) {
      na = __ldg(alpha + kStages);
      nb = __ldg(beta + kStages);
    }
  }
  __syncthreads();
  unsigned long long copied = 0, staged = 0;  // kStats only
  auto issue = [&](int q) {
    if (q < n) {
      const Header& h = sm.hdr[q % kHdrs];
      if (h.staged) copied += stage_window<kVec>(sm.stage[q % kStages], img + q * plane, h, p);
    }
    litbox::cp_async_commit();
  };
  for (int q = 0; q < kStages - 1; ++q) issue(q);

  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;
  bool pending = false;  // t2[(d - 1) & 1] holds image d - 1's middle shear
  for (int d = 0; d < n; ++d) {
    litbox::cp_async_wait<kStages - 2>();
    __syncthreads();  // image d's window is visible; image d - 1's stage is free
    const Header h = sm.hdr[d % kHdrs];
    if (header_lane && d + kStages < n) {
      sm.hdr[(d + kStages) % kHdrs] = window_of(na, nb, x0, y0, p);
      if (d + kStages + 1 < n) {
        na = __ldg(alpha + d + kStages + 1);
        nb = __ldg(beta + d + kStages + 1);
      }
    }
    issue(d + kStages - 1);
    staged += h.staged;
    if (pending) last_pass(sm.t2[(d - 1) & 1], sm.last[(d - 1) & 1], acc);
    if (h.staged) {
      column_pass(sm.stage[d % kStages], h, sm.t2[d & 1], y0, p);
      if (tid >= kThreads - 64 && tid < kThreads - 32) last_taps(sm.last[d & 1], h, x0, y0, p);
      pending = true;
    } else {
      tap_pass(img + d * plane, h.a, h.b, acc, x0, y0, p);
      pending = false;
    }
  }
  if (pending) {
    __syncthreads();
    last_pass(sm.t2[(n - 1) & 1], sm.last[(n - 1) & 1], acc);
  }
  const int lane = tid & 31, warp = tid >> 5;
  float* out = p.out + ((size_t)blockIdx.z * p.s) * p.s;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int x = x0 + lane, y = y0 + warp + k * (kThreads / 32);
    if (x < p.s && y < p.s) out[(size_t)y * p.s + x] = acc[k];
  }
  if (kStats) {
    litbox::count_add(p.counts + 3, copied);
    if (tid == 0) {
      atomicAdd(p.counts, (unsigned long long)n);
      atomicAdd(p.counts + 1, staged);
      atomicAdd(p.counts + 2, staged * min(kTile, p.s - x0) * min(kTile, p.s - y0));
    }
  }
}

template <bool kVec, bool kStats>
int launch(const Rot3Args& p, int channels, cudaStream_t stream) {
  const size_t smem = sizeof(Smem);
  const auto kernel = rot3sum_kernel<kVec, kStats>;
  // Smem is over 48 KB: the kernel's limit is raised once a device (bit
  // `device` of `raised`), not on every launch.
  static std::atomic<unsigned long long> raised{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const unsigned tiles = (unsigned)((p.s + kTile - 1) / kTile);
  kernel<<<dim3(tiles, tiles, (unsigned)(channels * p.n_runs)), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// imgs: host array of `channels` device pointers, each (d, s, s) float32.
// run_starts: host array of n_runs + 1 bin indices, increasing, from 0 to d.
// out: (channels, n_runs, s, s) float32. One launch for up to 8 channels.
// counts: null, or 4 device uint64 to which the kernel adds (image, tile)
// windows, staged windows, their output texels and the bytes their copies
// read (a separate instance: the counting costs the plain launch nothing).
extern "C" int litbox_rot3sum(const float* const* imgs, const float* alpha,
                              const float* beta, float* out, int channels,
                              int d, int s, int n_runs, const int* run_starts,
                              unsigned long long* counts, void* stream) {
  if (n_runs < 1 || n_runs > kMaxRuns || run_starts[0] != 0 ||
      run_starts[n_runs] != d || channels < 0)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < n_runs; ++r)
    if (run_starts[r + 1] < run_starts[r]) return (int)cudaErrorInvalidValue;
  if (s <= 0 || channels == 0) return (int)cudaGetLastError();
  Rot3Args p;
  p.alpha = alpha;
  p.beta = beta;
  p.s = s;
  p.chunks = (s + 3) / 4;
  p.n_runs = n_runs;
  for (int r = 0; r <= kMaxRuns; ++r) p.start[r] = run_starts[r <= n_runs ? r : n_runs];
  p.center = 0.5f * (float)s;
  p.lim = (float)(s + 2);
  p.counts = counts;
  for (int c0 = 0; c0 < channels; c0 += kMaxChannels) {
    const int nc = channels - c0 < kMaxChannels ? channels - c0 : kMaxChannels;
    bool vec = s % 4 == 0;
    for (int c = 0; c < kMaxChannels; ++c) {
      p.img[c] = c < nc ? imgs[c0 + c] : imgs[c0];
      if (c < nc) vec = vec && litbox::aligned16(imgs[c0 + c]);
    }
    p.out = out + (size_t)c0 * n_runs * s * s;
    const cudaStream_t st = (cudaStream_t)stream;
    const int err = counts ? (vec ? launch<true, true>(p, nc, st)
                                  : launch<false, true>(p, nc, st))
                           : (vec ? launch<true, false>(p, nc, st)
                                  : launch<false, false>(p, nc, st));
    if (err) return err;
  }
  return (int)cudaGetLastError();
}
