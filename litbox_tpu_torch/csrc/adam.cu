// The training step's optimizer update, for sm_90a: optax.chain(
// clip_by_global_norm(clip), add_decayed_weights(wd), adam(lr)) over every
// parameter tensor of a net, in place, in two launches (one without the clip).
//
// Replaces no TPU kernel: the JAX package runs optax's chain through XLA
// (litbox_tpu/nn/train.py), which fuses it. On the card the same chain
// written as tensor ops runs 3,430 device operations a step (4,550 with the
// clip) for TrainConfig()'s 180 tensors; on an H100 machine the host took
// 61-77 ms a step to issue them, longer than the card took to run them, so
// the host's issue and not the card paced the training step. This kernel
// takes their place.
//
// Bound: bytes. One read of the gradients for the global norm (4 B a
// parameter), then one pass that reads p, g, mu and nu and writes p, mu and
// nu (28 B a parameter): 10.24 GB for TrainConfig()'s 320 M parameters, 3.06
// ms at the H100's 3.35 TB/s. The arithmetic is about 60 instructions an
// element (three IEEE divisions and a square root).
//
// Design. The tensors are cut into chunks of kChunk floats, a tensor's last
// chunk ragged; a device table (the wrapper's, made once) holds each
// tensor's p, mu and nu pointers, its size and its first chunk. The
// gradients are new tensors every step, so their pointers travel by value in
// the launch's parameters (kMaxTensors of them, within the 4 KB the
// parameters may take). A block finds its chunk's tensor by a binary search
// of the first chunks, uniform across the block.
// - adam_norm: a fixed grid of at most (slots - 4) blocks walks the chunks
//   in a fixed order, each thread summing squares (float4 loads where the
//   tensor is 16-byte aligned); each block writes one partial, and the block
//   that takes the last ticket (an integer atomic) adds the partials in block
//   order and writes the norm. No float atomics: a run repeats bit for bit.
// - adam_update: a block a chunk. Each block reads the norm, the update
//   count and the learning rate once, then updates its chunk's elements in
//   optax's order, every operation rounded on its own as the plain chain's
//   separate launches round it (no contraction into FMAs): loads of two
//   float4 rows of p, g, mu and nu a thread before any store. The block that
//   takes the last ticket writes count + 1 (and advances the schedule's
//   count): every block has read the count by then, so all see the same
//   bias correction.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 8192;  // floats a chunk: 8 float4 a thread
constexpr int kUnroll = 2;          // float4 rows of each array loaded before a store
constexpr int kMaxTensors = 448;    // gradient pointers in the launch's parameters

struct Grads {
  const float* g[kMaxTensors];
};

// The device table: int64 [p | mu | nu | numel | first chunk (n + 1)].
struct Layout {
  const long long* t;
  int n;

  __device__ float* p(int i) const { return reinterpret_cast<float*>(t[i]); }
  __device__ float* mu(int i) const { return reinterpret_cast<float*>(t[n + i]); }
  __device__ float* nu(int i) const { return reinterpret_cast<float*>(t[2 * n + i]); }
  __device__ long long numel(int i) const { return t[3 * n + i]; }
  __device__ long long first(int i) const { return t[4 * n + i]; }

  // The tensor whose chunks hold `chunk`: the last i with first(i) <= chunk
  // (a tensor of no elements has no chunk and is passed over).
  __device__ int tensor_of(long long chunk) const {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first(mid) <= chunk) lo = mid;
      else hi = mid - 1;
    }
    return lo;
  }
};

struct Hyper {
  float lr, clip, wd, b1, one_minus_b1, b2, one_minus_b2, eps;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The block's sum of v, in a fixed order; the result is thread 0's.
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
adam_norm_kernel(Grads grads, Layout lay, long long n_chunks, float* scratch, int slots) {
  __shared__ float red[kThreads / 32];
  __shared__ bool last;
  float acc = 0.f;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int t = lay.tensor_of(c);
    const long long begin = (c - lay.first(t)) * kChunk;
    const int len = (int)min(kChunk, lay.numel(t) - begin);
    const float* g = grads.g[t] + begin;
    const int n4 = aligned16(g) ? len / 4 : 0;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float part = 0.f;
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 v = __ldg(g4 + i);
      part = __fmaf_rn(v.x, v.x, part);
      part = __fmaf_rn(v.y, v.y, part);
      part = __fmaf_rn(v.z, v.z, part);
      part = __fmaf_rn(v.w, v.w, part);
    }
    for (int i = 4 * n4 + threadIdx.x; i < len; i += kThreads) {
      const float v = __ldg(g + i);
      part = __fmaf_rn(v, v, part);
    }
    acc = __fadd_rn(acc, part);
  }
  const float s = block_sum(acc, red);
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + slots - 3);
  if (threadIdx.x == 0) {
    scratch[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float v = 0.f;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) v = __fadd_rn(v, __ldcg(scratch + i));
  v = block_sum(v, red);
  if (threadIdx.x == 0) {
    scratch[slots - 4] = __fsqrt_rn(v);
    *ticket = 0;
  }
}

struct Coef {
  float bc1, bc2, step, norm;
  bool scale;  // the clip scales the gradient: clip on and norm >= clip
};

// One element, in the plain chain's order and roundings.
__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, const Coef& k,
                                         const Hyper& h) {
  if (k.scale) g = __fmul_rn(__fdiv_rn(g, k.norm), h.clip);
  g = __fadd_rn(g, __fmul_rn(h.wd, p));
  m = __fadd_rn(__fmul_rn(h.one_minus_b1, g), __fmul_rn(h.b1, m));
  v = __fadd_rn(__fmul_rn(h.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
  const float u = __fdiv_rn(__fdiv_rn(m, k.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), h.eps));
  p = __fadd_rn(p, __fmul_rn(k.step, u));
}

__device__ __forceinline__ void adam_four(float4& p, const float4& g, float4& m, float4& v,
                                          const Coef& k, const Hyper& h) {
  adam_one(p.x, g.x, m.x, v.x, k, h);
  adam_one(p.y, g.y, m.y, v.y, k, h);
  adam_one(p.z, g.z, m.z, v.z, k, h);
  adam_one(p.w, g.w, m.w, v.w, k, h);
}

__global__ void __launch_bounds__(kThreads)
adam_update_kernel(Grads grads, Layout lay, float* scratch, int slots, int* count,
                   int* schedule_count, const float* lr_dev, Hyper h) {
  __shared__ Coef coef;
  __shared__ int next_count;
  if (threadIdx.x == 0) {
    const int c = *count + 1;
    next_count = c;
    coef.bc1 = __fsub_rn(1.f, powf(h.b1, (float)c));
    coef.bc2 = __fsub_rn(1.f, powf(h.b2, (float)c));
    coef.step = -(lr_dev != nullptr ? *lr_dev : h.lr);
    coef.norm = h.clip != 0.f ? scratch[slots - 4] : 0.f;
    coef.scale = h.clip != 0.f && !(coef.norm < h.clip);
  }
  __syncthreads();
  const Coef k = coef;

  const long long c = blockIdx.x;
  const int t = lay.tensor_of(c);
  const long long begin = (c - lay.first(t)) * kChunk;
  const int len = (int)min(kChunk, lay.numel(t) - begin);
  float* p = lay.p(t) + begin;
  const float* g = grads.g[t] + begin;
  float* mu = lay.mu(t) + begin;
  float* nu = lay.nu(t) + begin;
  const int n4 = aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu) ? len / 4 : 0;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* mu4 = reinterpret_cast<float4*>(mu);
  float4* nu4 = reinterpret_cast<float4*>(nu);
  for (int i0 = threadIdx.x; i0 < n4; i0 += kUnroll * kThreads) {
    float4 P[kUnroll], G[kUnroll], M[kUnroll], V[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n4) {
        P[u] = p4[i];
        G[u] = __ldg(g4 + i);
        M[u] = mu4[i];
        V[u] = nu4[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n4) {
        adam_four(P[u], G[u], M[u], V[u], k, h);
        p4[i] = P[u];
        mu4[i] = M[u];
        nu4[i] = V[u];
      }
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < len; i += kThreads) {
    float pe = p[i], me = mu[i], ve = nu[i];
    adam_one(pe, __ldg(g + i), me, ve, k, h);
    p[i] = pe;
    mu[i] = me;
    nu[i] = ve;
  }

  if (threadIdx.x == 0) {
    __threadfence();
    unsigned* ticket = reinterpret_cast<unsigned*>(scratch + slots - 2);
    if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
      *count = next_count;
      if (schedule_count != nullptr) *schedule_count += 1;
      *ticket = 0;
    }
  }
}

bool fill(Grads* out, const void* const* grads, int n_tensors) {
  if (n_tensors < 1 || n_tensors > kMaxTensors) return false;
  for (int i = 0; i < n_tensors; ++i) out->g[i] = static_cast<const float*>(grads[i]);
  return true;
}

}  // namespace

// grads: a host array of n_tensors device pointers; layout: the device table
// (see Layout); scratch: `slots` floats, zero at the first launch, of which
// the last four hold the norm and the two launches' tickets.
extern "C" int litbox_adam_norm(const void* const* grads, int n_tensors, const long long* layout,
                                long long n_chunks, float* scratch, int slots, void* stream) {
  Grads g;
  if (!fill(&g, grads, n_tensors) || n_chunks < 1 || slots < 5) return (int)cudaErrorInvalidValue;
  const int blocks = (int)(n_chunks < slots - 4 ? n_chunks : slots - 4);
  adam_norm_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(g, Layout{layout, n_tensors},
                                                                 n_chunks, scratch, slots);
  return (int)cudaGetLastError();
}

// count, schedule_count: int32 device scalars (schedule_count may be null);
// lr_dev: a float32 device scalar read in place of lr, or null.
extern "C" int litbox_adam_update(const void* const* grads, int n_tensors, const long long* layout,
                                  long long n_chunks, float* scratch, int slots, int* count,
                                  int* schedule_count, const float* lr_dev, float lr, float clip,
                                  float wd, float b1, float one_minus_b1, float b2,
                                  float one_minus_b2, float eps, void* stream) {
  Grads g;
  if (!fill(&g, grads, n_tensors) || n_chunks < 1 || n_chunks > 0x7fffffffLL || slots < 5)
    return (int)cudaErrorInvalidValue;
  const Hyper h{lr, clip, wd, b1, one_minus_b1, b2, one_minus_b2, eps};
  adam_update_kernel<<<(unsigned)n_chunks, kThreads, 0, (cudaStream_t)stream>>>(
      g, Layout{layout, n_tensors}, scratch, slots, count, schedule_count, lr_dev, h);
  return (int)cudaGetLastError();
}
