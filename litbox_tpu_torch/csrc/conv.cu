// The training step's convolutions, for sm_90a: float32 implicit GEMMs over
// the whole batch in NCHW, stride 1, kernel 1x1, 3x3 or 5x5, zero padding.
// One launch for the forward, one for the data gradient and one for the
// weight gradient (with one for the bias gradient's partial sums), each
// followed by a reduction launch where the sum is split across blocks.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA
// (litbox_tpu/nn/unet.py). On the card a training step runs with cuDNN off
// (its float32 gradients strayed up to 1.15e-3 of their maximum from
// float64), so PyTorch's fallback convolution ran instead: a loop over the
// batch, one item at a time, that copies each item's input into a column
// buffer (im2col; col2im back for the data gradient) and multiplies the
// columns with a GEMM. The copies were the top two device operations of the
// step and the per-item GEMMs were thin. These kernels read the input in
// place and take the whole batch at once.
//
// Bound: operations, 2 * (N * Ho * Wo) * Cout * (Cin * k * k) a direction,
// in float32 FFMA only (67 TFLOP/s on an H100 SXM): no TF32 and no tensor
// cores. The bytes (each tensor once) are far below that line for every
// layer of the nets.
//
// Design. Each direction is a GEMM whose operands are gathered from the
// tensors as their tiles are staged, with no column buffer:
// - forward: rows the N * Ho * Wo output pixels, columns the Cout output
//   channels, depth the k * k taps times the Cin input channels, tap-major.
//   A[pixel][(tap, ci)] is the input at the pixel shifted by the tap, zero
//   outside (the padding); B[(tap, ci)][co] the weight w[co][ci][tap], laid
//   out first [tap][ci][co] (co padded to a multiple of 4) by a tiled
//   transpose in shared memory (conv_weight_layout_kernel).
// - data gradient: the same kernel on the output's gradient, its B the
//   weight laid out [tap][co][ci] and read with its taps reversed
//   (w[co][ci][k*k-1-tap]), the padding k - 1 - pad: the gradient of the
//   tensor the convolution saw.
// - weight gradient: rows the Cin * k * k taps, columns the Cout channels,
//   depth the N * Ho * Wo pixels, walked a plane at a time (unpadded: the
//   wrapper pads). The bias gradient: a tree sum of each plane's chunks.
// A block of 256 threads stages BK deep slices of its (BM x BN) tile's two
// operands in shared memory with cp.async copies (zero-filled where
// invalid; the gathers 4 bytes a thread, consecutive threads on consecutive
// pixels, the weights 16), two or three stages deep (as many as leave room
// for two blocks an SM), so the copies of the next slices overlap the
// products of this one. A forward step takes one tap of BK input channels, so its
// offsets and the padding's test are the block's and not each element's.
// The nine taps of a 3x3 convolution (25 of a 5x5) read the same input
// lines, which stay in L1.
// Each thread accumulates an 8 x 8 register tile with FFMA from two float4
// reads of each operand a depth row. Every flush depth (the direction's:
// 128 rows, 64, or one tap's channels for the data gradient, as PyTorch
// sums them; in the weight gradient also every plane) the tile is added to
// the thread's running total in shared memory and restarts from zero: the
// float32 sums run in blocks and stay as close to float64 as PyTorch's own.
// Where a tile is too small for 256 threads (the weight gradient of thin
// layers), the block's threads form G groups that each take 1/G of every
// staged slice and add their tiles through shared memory in group order at
// the end.
// The tile follows the layer's shape (the wrapper, ops/conv.py, chooses):
// thin layers (16 or 32 output channels) cover all of them with a wide
// strip of pixels; wide layers take 128 x 128 tiles; where the tiles are
// too few to fill the card (small images, deep layers), the depth is split
// across blocks, whose partial tiles a second launch adds in split order.
// No float atomics: a run repeats bit for bit.

#include <cuda_runtime.h>

#include "tile_ring.cuh"

namespace {

using litbox::cp_async16;
using litbox::cp_async4;
using litbox::cp_async_commit;
using litbox::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kPad = 4;          // floats after each staged row: 16-byte rows, no bank conflicts
// Depth rows a register tile sums before it joins the total: the forward's,
// the data gradient's (at most: PyTorch sums each tap's Cout channels apart
// there, and so does the kernel where they are fewer) and the weight
// gradient's.
constexpr int kFlushForward = 128, kFlushDataGrad = 64, kFlushWeightGrad = 64;
constexpr int kTotal = 64 * kThreads;  // floats of the running totals
constexpr int kBiasChunk = 16384;      // gradient floats a bias block sums (256 threads x 64)

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery): l = ceil(log2 d), mul = floor(2^32 (2^l - d) / d) + 1, and
// n / d = (umulhi(n, mul) + n) >> l, which cannot overflow since
// umulhi(n, mul) <= n < 2^31.
struct FastDiv {
  unsigned mul;
  int shift;

  static FastDiv of(int d) {
    if (d < 1) return FastDiv{0, 0};
    int l = 0;
    while ((1ll << l) < d) ++l;
    return FastDiv{(unsigned)((((1ull << 32) * (unsigned long long)((1ll << l) - d)) / d) + 1),
                   l};
  }
  __device__ int operator()(int n) const {
    return (int)((__umulhi((unsigned)n, mul) + (unsigned)n) >> shift);
  }
};

// One convolution: in (n, cin, hi, wi), out (n, cout, ho, wo), weights
// (cout, cin, KS, KS), ho = hi + 2 pad - KS + 1; by_wo and by_hos divide by
// wo and by ho * wo.
struct Shape {
  int n, cin, hi, wi, cout, ho, wo, pad;
  FastDiv by_wo, by_hos;
};

// The register tile of one thread: rows tm*4 + {0..3} and + BM/2, columns
// tn*4 + {0..3} and + BN/2, of its group's (BM x BN) tile. A warp takes a
// (kWarpM x kWarpN) block of (tm, tn), so that its reads of a staged row
// are few distinct float4s: 128 bytes of A and 64 of B where the tile
// allows.
template <int BM, int BN>
struct Tile {
  static constexpr int kGroupThreads = (BM / 8) * (BN / 8);
  static constexpr int kGroups = kThreads / kGroupThreads;
  static_assert(kGroups * kGroupThreads == kThreads, "a tile's threads must divide the block");
  static constexpr int kWarpN = BN / 8 < 4 ? BN / 8 : 4;
  static constexpr int kWarpM = 32 / kWarpN;
  static constexpr bool kWarpTiles = kGroupThreads >= 32 && (BM / 8) % kWarpM == 0;
  static constexpr int kWarpRows = kWarpTiles ? BM / 8 / kWarpM : 1;  // warps along BM
  float acc[8][8];

  __device__ int group() const { return threadIdx.x / kGroupThreads; }
  __device__ int tm() const {
    const int t = threadIdx.x % kGroupThreads;
    if (!kWarpTiles) return t % (BM / 8);
    return ((t >> 5) % kWarpRows) * kWarpM + (t & 31) % kWarpM;
  }
  __device__ int tn() const {
    const int t = threadIdx.x % kGroupThreads;
    if (!kWarpTiles) return t / (BM / 8);
    return ((t >> 5) / kWarpRows) * kWarpN + (t & 31) / kWarpM;
  }
  __device__ static int row(int tm, int i) { return tm * 4 + (i & 3) + (i >> 2) * (BM / 2); }
  __device__ static int col(int tn, int j) { return tn * 4 + (j & 3) + (j >> 2) * (BN / 2); }

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  // kRows depth rows from k0 of the staged A [depth][BM + kPad] and
  // B [depth][BN + kPad].
  template <int kRows>
  __device__ void multiply(const float* As, const float* Bs, int k0) {
    const int m = tm() * 4, n = tn() * 4;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int k = k0 + r;
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * (BM + kPad) + m);
      const float4 a1 = *reinterpret_cast<const float4*>(As + k * (BM + kPad) + m + BM / 2);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * (BN + kPad) + n);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * (BN + kPad) + n + BN / 2);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // The tile joins the thread's running total (kTotal floats of shared
  // memory, float4 q of thread t at q * kThreads + t, so a warp's accesses
  // are contiguous) and restarts from zero; `first` sets the total.
  __device__ void flush(float* total, bool first) {
    float4* t4 = reinterpret_cast<float4*>(total) + threadIdx.x;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      float* a = acc[q >> 1] + (q & 1) * 4;
      float4 v = make_float4(a[0], a[1], a[2], a[3]);
      if (!first) {
        const float4 o = t4[q * kThreads];
        v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
      }
      t4[q * kThreads] = v;
      a[0] = a[1] = a[2] = a[3] = 0.0f;
    }
  }

  // The tile becomes the total plus the tile.
  __device__ void finish(const float* total) {
    const float4* t4 = reinterpret_cast<const float4*>(total) + threadIdx.x;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      float* a = acc[q >> 1] + (q & 1) * 4;
      const float4 o = t4[q * kThreads];
      a[0] = o.x + a[0];
      a[1] = o.y + a[1];
      a[2] = o.z + a[2];
      a[3] = o.w + a[3];
    }
  }

  // The groups' tiles added in group order into the last group's
  // registers, through `red` (BM * BN floats of shared memory that no copy
  // is writing). Every thread of the block must call it.
  __device__ void add_groups(float* red) {
    if (kGroups == 1) return;
    const int g = group(), m = tm(), n = tn();
    for (int turn = 0; turn < kGroups - 1; ++turn) {
      if (g == turn) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float* r = red + row(m, i) * BN + col(n, j);
            *r = turn == 0 ? acc[i][j] : *r + acc[i][j];
          }
      }
      __syncthreads();
    }
    if (g == kGroups - 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = red[row(m, i) * BN + col(n, j)] + acc[i][j];
    }
  }
};

// The main loop of both kernels, S stages deep: stage(buf, step) issues
// the copies of a step into stage buffer buf (called for kb, kb + 1, ... in
// order), the tile multiplies each staged slice, kRows rows a group,
// flushing every flush_steps steps. One barrier a step: the buffer a step
// refills is the one every thread finished multiplying before it.
template <int kRows, int S, class T, class Stage>
__device__ void run_steps(T& tile, Stage&& stage, float* As, int a_stage, float* Bs,
                          int b_stage, float* total, int kb, int ke, int flush_steps) {
  const int k0 = tile.group() * kRows;
  tile.zero();
  bool first = true;
  int since = 0;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (kb + i < ke) stage(i, kb + i);
    cp_async_commit();
  }
  for (int step = kb; step < ke; ++step) {
    const int buf = (step - kb) % S;
    cp_async_wait<S - 2>();
    __syncthreads();
    if (step + S - 1 < ke) stage((buf + S - 1) % S, step + S - 1);
    cp_async_commit();
    tile.template multiply<kRows>(As + buf * a_stage, Bs + buf * b_stage, k0);
    if (++since == flush_steps && step + 1 < ke) {
      tile.flush(total, first);
      first = false;
      since = 0;
    }
  }
  if (!first) tile.finish(total);
}

template <int BM, int BN, int BK, int S>
__host__ __device__ constexpr int stage_floats() {
  return S * BK * (BM + kPad) + S * BK * (BN + kPad);
}

// ---------------------------------------------------------------------------
// The weight w (A, B, KK) laid out for the forward kernel, rows of a
// multiple of 4 floats with zeros past the last column: by_b (the forward,
// A = cout, B = cin) out[t][b][a] in rows of A4; else (the data gradient)
// out[t][a][b] in rows of B4. A block moves a 32 x 32 tile of (a, b), all
// taps, through shared memory: reads and writes of consecutive floats.
__global__ void __launch_bounds__(kThreads)
conv_weight_layout_kernel(const float* __restrict__ w, float* __restrict__ out, int A, int B,
                          int KK, bool by_b) {
  extern __shared__ float4 smem4[];
  float* const tile = reinterpret_cast<float*>(smem4);  // [32][32 * KK + 1]
  const int row = 32 * KK + 1;
  const int a0 = blockIdx.y * 32, b0 = blockIdx.x * 32;
  for (int e = threadIdx.x; e < 32 * 32 * KK; e += kThreads) {
    const int ai = e / (32 * KK), rest = e - ai * 32 * KK;
    const bool ok = a0 + ai < A && b0 + rest / KK < B;
    tile[ai * row + rest] = ok ? w[((size_t)(a0 + ai) * B + b0) * KK + rest] : 0.0f;
  }
  __syncthreads();
  const int A4 = (A + 3) & ~3, B4 = (B + 3) & ~3;
  for (int e = threadIdx.x; e < 32 * 32 * KK; e += kThreads) {
    const int fast = e & 31, slow = (e >> 5) & 31, t = e >> 10;
    if (by_b) {  // out[t][b0 + slow][a0 + fast]
      if (a0 + fast < A4 && b0 + slow < B)
        out[((size_t)t * B + b0 + slow) * A4 + a0 + fast] = tile[fast * row + slow * KK + t];
    } else {     // out[t][a0 + slow][b0 + fast]
      if (b0 + fast < B4 && a0 + slow < A)
        out[((size_t)t * A + a0 + slow) * B4 + b0 + fast] = tile[slow * row + fast * KK + t];
    }
  }
}

// Forward and data gradient: out[pixel][c] = sum over (tap, c') of
// A[pixel][(tap, c')] * bt[tap or, for the data gradient, KS*KS-1-tap][c'][c]
// (+ bias[c]).
//
// s is the product's own shape: for the data gradient, in is the output's
// gradient (s.cin = the layer's cout), out the input's gradient (s.cout =
// the layer's cin) and s.pad = KS - 1 - the layer's padding. bt is
// [KS * KS][s.cin][cout4], cout4 = s.cout rounded up to 4. Depth step t
// takes tap t / cblocks and input channels from (t % cblocks) * BK,
// cblocks = ceil(s.cin / BK); the tile joins its total every flush_steps
// steps.
// Grid: (pixel tiles, channel tiles, splits); split z takes steps
// [z * steps, (z + 1) * steps). With one split the block writes out (bias
// added); else its partial tile goes to ws[z] in out's layout.
template <int BM, int BN, int BK, int S, int KS>
__global__ void __launch_bounds__(kThreads, 2)
conv_fwd_kernel(const float* __restrict__ in, const float* __restrict__ bt,
                const float* __restrict__ bias, float* __restrict__ out, float* __restrict__ ws,
                Shape s, bool data_grad, int steps_per_split, int flush_steps) {
  // A is staged a pixel a lane: consecutive threads, consecutive pixels.
  constexpr int kRowThreads = BM < kThreads ? BM : kThreads;
  constexpr int kPix = BM / kRowThreads;                // pixels a thread
  constexpr int kRowsA = BK * kRowThreads / kThreads;   // depth rows a thread
  constexpr int kChunksB = BK * BN / 4;                 // 16-byte copies of a B slice
  constexpr int kSlotsB = (kChunksB + kThreads - 1) / kThreads;
  using T = Tile<BM, BN>;
  static_assert(T::kGroups == 1, "the forward's tiles take the whole block");

  extern __shared__ float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);  // [S][BK][BM + kPad]
  float* const Bs = As + S * BK * (BM + kPad);        // [S][BK][BN + kPad]
  float* const total = As + stage_floats<BM, BN, BK, S>();

  const int hos = s.ho * s.wo, his = s.hi * s.wi;
  const int pixels = s.n * hos;
  const int cout4 = (s.cout + 3) & ~3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cblocks = (s.cin + BK - 1) / BK;
  const int steps = KS * KS * cblocks;
  const int kb = blockIdx.z * steps_per_split;
  const int ke = min(kb + steps_per_split, steps);

  // Each staged pixel's offset (the input at its top-left tap) and the taps
  // that fall inside the input (bit ky * KS + kx; none past the last pixel).
  int base[kPix];
  unsigned mask[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int m = m0 + threadIdx.x % kRowThreads + kRowThreads * j;
    base[j] = 0;
    mask[j] = 0;
    if (m < pixels) {
      const int img = s.by_hos(m), p = m - img * hos, row = s.by_wo(p);
      const int y = row - s.pad, x = p - row * s.wo - s.pad;
      base[j] = img * s.cin * his + y * s.wi + x;
#pragma unroll
      for (int ky = 0; ky < KS; ++ky)
#pragma unroll
        for (int kx = 0; kx < KS; ++kx)
          if (y + ky >= 0 && y + ky < s.hi && x + kx >= 0 && x + kx < s.wi)
            mask[j] |= 1u << (ky * KS + kx);
    }
  }
  const int krow = threadIdx.x / kRowThreads;  // the thread's first depth row of A

  // The next step's tap and first channel, advanced a step a call.
  int tap = kb / cblocks;
  int c0 = (kb - tap * cblocks) * BK;
  auto stage = [&](int buf, int) {
    float* a = As + buf * BK * (BM + kPad);
    float* b = Bs + buf * BK * (BN + kPad);
    const int tap_off = (tap / KS) * s.wi + tap % KS;
    const int b_tap = data_grad ? KS * KS - 1 - tap : tap;
#pragma unroll
    for (int q = 0; q < kRowsA; ++q) {
      const int kr = krow + (kThreads / kRowThreads) * q;
      const int c = c0 + kr;
      const int off = c * his + tap_off;
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        const bool ok = c < s.cin && ((mask[j] >> tap) & 1u);
        cp_async4(a + kr * (BM + kPad) + threadIdx.x % kRowThreads + kRowThreads * j,
                  ok ? in + base[j] + off : in, ok);
      }
    }
#pragma unroll
    for (int q = 0; q < kSlotsB; ++q) {
      const int e = threadIdx.x + kThreads * q;
      if (kChunksB % kThreads != 0 && e >= kChunksB) break;
      const int r = e / (BN / 4), col = (e % (BN / 4)) * 4;
      const bool ok = c0 + r < s.cin && n0 + col < cout4;
      cp_async16(b + r * (BN + kPad) + col,
                 ok ? bt + ((size_t)(b_tap * s.cin + c0 + r) * cout4 + n0 + col) : bt, ok);
    }
    c0 += BK;
    if (c0 >= s.cin) {
      c0 = 0;
      ++tap;
    }
  };

  T tile;
  run_steps<BK, S>(tile, stage, As, BK * (BM + kPad), Bs, BK * (BN + kPad), total, kb, ke,
                   flush_steps);

  const int tm = tile.tm(), tn = tile.tn();
  float* dst = gridDim.z == 1 ? out : ws + (size_t)blockIdx.z * pixels * s.cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + T::row(tm, i);
    if (m >= pixels) continue;
    const int img = s.by_hos(m);
    const int o = img * s.cout * hos + (m - img * hos);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + T::col(tn, j);
      if (c >= s.cout) continue;
      float v = tile.acc[i][j];
      if (gridDim.z == 1 && bias != nullptr) v += bias[c];
      dst[o + c * hos] = v;
    }
  }
}

// out = the splits' partial outputs added in split order, then the bias.
__global__ void __launch_bounds__(kThreads)
conv_fwd_reduce_kernel(const float* __restrict__ ws, const float* __restrict__ bias,
                       float* __restrict__ out, int splits, int numel, int hos, int cout) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= numel) return;
  float v = ws[i];
  for (int z = 1; z < splits; ++z) v += ws[(size_t)z * numel + i];
  if (bias != nullptr) v += bias[(i / hos) % cout];
  out[i] = v;
}

// ---------------------------------------------------------------------------
// Weight gradient: G[(ci, tap)][co] = sum over pixels of
// X[pixel][(ci, tap)] * dY[pixel][co], X the unpadded input (s.pad 0).
//
// The depth (pixels) is walked a plane at a time, BK pixels a step, a
// plane's last step ragged: step t is plane t / plane_steps (by_plane),
// pixels from (t % plane_steps) * BK. Both operands are staged a pixel a
// lane: warp w stages pixels (w % (BK / 8)) * 8 + lane % 8 of every column
// group it takes, so a thread decodes one pixel a step. Grid: (tap tiles,
// channel tiles, splits); split z takes steps [z * steps, (z + 1) * steps)
// and writes its partial tile to ws[z], laid out as dw [cout][cin * KS * KS];
// with one split the block writes dw.
template <int BM, int BN, int BK, int S, int KS>
__global__ void __launch_bounds__(kThreads, 2)
conv_wgrad_kernel(const float* __restrict__ in, const float* __restrict__ dy,
                  float* __restrict__ dw, float* __restrict__ ws, Shape s, FastDiv by_plane,
                  int steps_per_split) {
  constexpr int KK = KS * KS;
  constexpr int kPixGroups = BK / 8;                 // warps along the pixels
  constexpr int kSlotsA = BM * BK / kThreads;        // columns (taps) a thread stages
  constexpr int kSlotsB = BN * BK / kThreads;        // columns (channels) a thread stages
  using T = Tile<BM, BN>;
  static_assert(kPixGroups >= 1 && kPixGroups <= 8 && kSlotsB >= 1, "a tile's staging");
  static_assert(BK % T::kGroups == 0, "each group takes whole depth rows");

  extern __shared__ float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);  // [S][BK][BM + kPad]
  float* const Bs = As + S * BK * (BM + kPad);        // [S][BK][BN + kPad]
  constexpr int kStages = stage_floats<BM, BN, BK, S>();
  float* const total = As + (kStages > BM * BN ? kStages : BM * BN);

  const int depth = s.cin * KK;
  const int hos = s.ho * s.wo, his = s.hi * s.wi;
  const int plane_steps = (hos + BK - 1) / BK;
  const int steps = s.n * plane_steps;
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * steps_per_split;
  const int ke = min(kb + steps_per_split, steps);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pix = (warp % kPixGroups) * 8 + (lane & 7);  // the thread's pixel of a step
  const int colg = warp / kPixGroups;                   // its first column group
  auto col_of = [&](int q) { return (colg + (8 / kPixGroups) * q) * 4 + (lane >> 3); };

  // The thread's taps: their offsets from a pixel (-1 past the last).
  int off[kSlotsA];
#pragma unroll
  for (int q = 0; q < kSlotsA; ++q) {
    const int r = r0 + col_of(q);
    const int ci = r / KK, tap = r - ci * KK;
    off[q] = r < depth ? ci * his + (tap / KS) * s.wi + tap % KS : -1;
  }

  auto stage = [&](int buf, int step) {
    float* a = As + buf * BK * (BM + kPad);
    float* b = Bs + buf * BK * (BN + kPad);
    const int img = by_plane(step);
    const int p = (step - img * plane_steps) * BK + pix;
    const bool inside = p < hos;
    const int row = s.by_wo(p);
    const int x_at = img * s.cin * his + row * s.wi + (p - row * s.wo);
    const int dy_at = img * s.cout * hos + p;
#pragma unroll
    for (int q = 0; q < kSlotsA; ++q) {
      const bool ok = inside && off[q] >= 0;
      cp_async4(a + pix * (BM + kPad) + col_of(q), ok ? in + x_at + off[q] : in, ok);
    }
#pragma unroll
    for (int q = 0; q < kSlotsB; ++q) {
      const int c = n0 + col_of(q);
      const bool ok = inside && c < s.cout;
      cp_async4(b + pix * (BN + kPad) + col_of(q), ok ? dy + dy_at + c * hos : dy, ok);
    }
  };

  T tile;
  constexpr int kRows = BK / T::kGroups;  // depth rows a group takes a step
  // A flush at least once a plane: PyTorch sums each image's plane apart,
  // and a plane of a few pixels takes one step of mostly zero rows.
  run_steps<kRows, S>(tile, stage, As, BK * (BM + kPad), Bs, BK * (BN + kPad), total, kb, ke,
                      min(kFlushWeightGrad / kRows, plane_steps));
  __syncthreads();      // every group is done with the stages
  tile.add_groups(As);
  if (tile.group() != T::kGroups - 1) return;

  const int tm = tile.tm(), tn = tile.tn();
  float* dst = gridDim.z == 1 ? dw : ws + (size_t)blockIdx.z * s.cout * depth;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + T::row(tm, i);
    if (r >= depth) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + T::col(tn, j);
      if (c < s.cout) dst[c * depth + r] = tile.acc[i][j];
    }
  }
}

// A float32 sum and the rounding error it carries (Knuth's two-sum): the
// bias gradient's sums of up to millions of terms stay within an ulp or so.
struct Sum2 {
  float s, c;
};

__device__ Sum2 add2(Sum2 a, Sum2 b) {
  const float s = a.s + b.s;
  const float bp = s - a.s;
  const float e = (a.s - (s - bp)) + (b.s - bp);
  return Sum2{s, (a.c + b.c) + e};
}

// The bias gradient's partial sums: block (k, img, c) sums dY[img][c] at
// pixels [k * kBiasChunk, (k + 1) * kBiasChunk), each thread its 64 floats,
// then the block's 256 sums in a fixed tree, all by two-sums; the sum and
// its error go to part[c][img * chunks_per_plane + k].
__global__ void __launch_bounds__(kThreads)
conv_bias_part_kernel(const float* __restrict__ dy, float2* __restrict__ part, int cout,
                      int hos) {
  __shared__ Sum2 red[kThreads];
  const int k = blockIdx.x, img = blockIdx.y, c = blockIdx.z;
  const float* plane = dy + ((size_t)img * cout + c) * hos;
  const int p0 = k * kBiasChunk;
  Sum2 sum{0.0f, 0.0f};
#pragma unroll 8
  for (int u = 0; u < kBiasChunk / kThreads; ++u) {
    const int p = p0 + u * kThreads + threadIdx.x;
    if (p < hos) sum = add2(sum, Sum2{plane[p], 0.0f});
  }
  red[threadIdx.x] = sum;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] = add2(red[threadIdx.x], red[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0)
    part[((size_t)c * gridDim.y + img) * gridDim.x + k] = make_float2(red[0].s, red[0].c);
}

// The sum of x[0], x[stride], ... x[(n - 1) * stride]: eight running sums
// of every eighth term, then added pairwise.
__device__ float sum_strided(const float* x, int n, size_t stride) {
  float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < n; ++k) v[k & 7] += x[k * stride];
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// dw[co][(ci, tap)] from the splits' partial tiles (with more than one);
// then, past them, db[co] from its `parts` partial sums.
__global__ void __launch_bounds__(kThreads)
conv_wgrad_reduce_kernel(const float* __restrict__ ws, const float2* __restrict__ part,
                         float* __restrict__ dw, float* __restrict__ db, int splits, int cout,
                         int depth, int parts) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int numel = splits > 1 ? cout * depth : 0;
  if (i < numel) {
    dw[i] = sum_strided(ws + i, splits, (size_t)numel);
  } else if (db != nullptr && i < numel + cout) {
    const float2* p = part + (size_t)(i - numel) * parts;
    Sum2 v{0.0f, 0.0f};
    for (int k = 0; k < parts; ++k) v = add2(v, Sum2{p[k].x, p[k].y});
    db[i - numel] = v.s + v.c;
  }
}

// ---------------------------------------------------------------------------

template <int BM, int BN, int BK, int S, int KS>
cudaError_t fwd(const float* in, const float* bt, const float* bias, float* out, float* ws,
                const Shape& s, bool data_grad, int splits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (stage_floats<BM, BN, BK, S>() + kTotal);
  auto kernel = conv_fwd_kernel<BM, BN, BK, S, KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int pixels = s.n * s.ho * s.wo;
  const int cblocks = (s.cin + BK - 1) / BK;
  const int steps = KS * KS * cblocks;
  const int per = (steps + splits - 1) / splits;
  const int flush = data_grad ? min(kFlushDataGrad / BK, cblocks) : kFlushForward / BK;
  const dim3 grid((pixels + BM - 1) / BM, (s.cout + BN - 1) / BN, (steps + per - 1) / per);
  kernel<<<grid, kThreads, smem, stream>>>(in, bt, bias, out, ws, s, data_grad, per, flush);
  err = cudaGetLastError();
  if (err != cudaSuccess || grid.z == 1) return err;
  const int numel = pixels * s.cout;
  conv_fwd_reduce_kernel<<<(numel + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ws, bias, out, (int)grid.z, numel, s.ho * s.wo, s.cout);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int S, int KS>
cudaError_t wgrad(const float* in, const float* dy, float* dw, float* db, float* ws,
                  const Shape& s, int splits, cudaStream_t stream) {
  constexpr int kStages = stage_floats<BM, BN, BK, S>();
  const size_t smem = sizeof(float) * ((kStages > BM * BN ? kStages : BM * BN) + kTotal);
  auto kernel = conv_wgrad_kernel<BM, BN, BK, S, KS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int depth = s.cin * KS * KS;
  const int hos = s.ho * s.wo;
  const int plane_steps = (hos + BK - 1) / BK;
  const int steps = s.n * plane_steps;
  const int per = (steps + splits - 1) / splits;
  const dim3 grid((depth + BM - 1) / BM, (s.cout + BN - 1) / BN, (steps + per - 1) / per);
  kernel<<<grid, kThreads, smem, stream>>>(in, dy, dw, ws, s, FastDiv::of(plane_steps), per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The bias's partial sums follow the weight's partial tiles in ws.
  float2* part = reinterpret_cast<float2*>(ws + (grid.z > 1 ? (size_t)grid.z * s.cout * depth : 0));
  const int chunks = (hos + kBiasChunk - 1) / kBiasChunk;
  if (db != nullptr) {
    conv_bias_part_kernel<<<dim3(chunks, s.n, s.cout), kThreads, 0, stream>>>(dy, part, s.cout,
                                                                              hos);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int numel = (grid.z > 1 ? s.cout * depth : 0) + (db != nullptr ? s.cout : 0);
  if (numel == 0) return cudaSuccess;
  conv_wgrad_reduce_kernel<<<(numel + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ws, part, dw, db, (int)grid.z, s.cout, depth, chunks * s.n);
  return cudaGetLastError();
}

template <int KS>
cudaError_t fwd_tile(int tile, const float* in, const float* bt, const float* bias, float* out,
                     float* ws, const Shape& s, bool data_grad, int splits, cudaStream_t stream) {
  switch (tile) {
    case 0: return fwd<128, 128, 16, 2, KS>(in, bt, bias, out, ws, s, data_grad, splits, stream);
    case 1: return fwd<256, 64, 16, 2, KS>(in, bt, bias, out, ws, s, data_grad, splits, stream);
    case 2: return fwd<512, 32, 8, 2, KS>(in, bt, bias, out, ws, s, data_grad, splits, stream);
    case 3: return fwd<1024, 16, 4, 2, KS>(in, bt, bias, out, ws, s, data_grad, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int KS>
cudaError_t wgrad_tile(int tile, const float* in, const float* dy, float* dw, float* db,
                       float* ws, const Shape& s, int splits, cudaStream_t stream) {
  switch (tile) {
    case 0: return wgrad<128, 128, 16, 2, KS>(in, dy, dw, db, ws, s, splits, stream);
    case 1: return wgrad<128, 64, 16, 3, KS>(in, dy, dw, db, ws, s, splits, stream);
    case 2: return wgrad<64, 32, 32, 3, KS>(in, dy, dw, db, ws, s, splits, stream);
    case 3: return wgrad<64, 16, 64, 2, KS>(in, dy, dw, db, ws, s, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool valid(const Shape& s, int ks, int splits) {
  return (ks == 1 || ks == 3 || ks == 5) && s.n > 0 && s.cin > 0 && s.cout > 0 && s.ho > 0 &&
         s.wo > 0 && s.pad >= 0 && s.pad < ks && s.ho == s.hi + 2 * s.pad - ks + 1 &&
         s.wo == s.wi + 2 * s.pad - ks + 1 && splits >= 1;
}

Shape shape(int n, int cin, int hi, int wi, int cout, int ho, int wo, int pad) {
  return Shape{n, cin, hi, wi, cout, ho, wo, pad, FastDiv::of(wo), FastDiv::of(ho * wo)};
}

}  // namespace

// The forward (data_grad 0) or the data gradient (1) of a convolution, as
// conv_fwd_kernel states it: in (n, cin, hi, wi) to out (n, cout, ho, wo),
// w the layer's weight ((cout, cin, ks, ks) for the forward, (cin, cout, ks,
// ks) for the data gradient), laid out first into bt (ks * ks * cin * cout
// rounded up to 4 floats); bias may be null; ws holds splits partial
// outputs when splits > 1. tile: 0 (128 pixels x 128 channels), 1 (256 x
// 64), 2 (512 x 32), 3 (1024 x 16).
extern "C" int litbox_conv_fwd(const float* in, const float* w, float* bt, const float* bias,
                               float* out, float* ws, int n, int cin, int hi, int wi, int cout,
                               int ho, int wo, int pad, int ks, int data_grad, int tile,
                               int splits, void* stream) {
  const Shape s = shape(n, cin, hi, wi, cout, ho, wo, pad);
  if (!valid(s, ks, splits) || (splits > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // The weight (A, B, KK): (cout, cin) for the forward, (cin, cout) for the
  // data gradient, whose layout is [tap][A][B4].
  const int KK = ks * ks, A = data_grad ? cin : cout, B = data_grad ? cout : cin;
  const size_t smem = sizeof(float) * (32 * (32 * KK + 1));
  cudaError_t err = cudaFuncSetAttribute(conv_weight_layout_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  conv_weight_layout_kernel<<<dim3((B + 31) / 32, (A + 31) / 32), kThreads, smem, st>>>(
      w, bt, A, B, KK, data_grad == 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool dg = data_grad != 0;
  return (int)(ks == 1   ? fwd_tile<1>(tile, in, bt, bias, out, ws, s, dg, splits, st)
               : ks == 3 ? fwd_tile<3>(tile, in, bt, bias, out, ws, s, dg, splits, st)
                         : fwd_tile<5>(tile, in, bt, bias, out, ws, s, dg, splits, st));
}

// The weight gradient dw (cout, cin, ks, ks) and the bias gradient db (cout,
// or null) of an unpadded convolution of in (n, cin, hi, wi) whose output's
// gradient is dy (n, cout, ho, wo). ws: with splits > 1, splits * cout * cin
// * ks * ks floats, then 2 * cout * n * ceil(ho * wo / 16384) for the bias's
// partial sums and their errors.
// tile: 0 (128 taps x 128 channels, 16 pixels a step), 1 (128 x 64, 16),
// 2 (64 x 32, 32), 3 (64 x 16, 64).
extern "C" int litbox_conv_wgrad(const float* in, const float* dy, float* dw, float* db,
                                 float* ws, int n, int cin, int hi, int wi, int cout, int ho,
                                 int wo, int ks, int tile, int splits, void* stream) {
  const Shape s = shape(n, cin, hi, wi, cout, ho, wo, 0);
  if (!valid(s, ks, splits) || ws == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(ks == 1   ? wgrad_tile<1>(tile, in, dy, dw, db, ws, s, splits, st)
               : ks == 3 ? wgrad_tile<3>(tile, in, dy, dw, db, ws, s, splits, st)
                         : wgrad_tile<5>(tile, in, dy, dw, db, ws, s, splits, st));
}
