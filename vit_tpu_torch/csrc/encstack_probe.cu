// K24: the whole-encoder probe. K9's cooperative persistent grid, its
// tiling and its five grid-synchronised phases a layer, with each phase's
// body stripped down to a variant's ingredients, so that the time of each
// ingredient shows against K9's 51 us weight-stream bound at B/16 bs=1
// (K9's own times are in PERF.md section 6).
//
// Replaces tools/encstack_minrepro.py:make_variant (pallas_call :216), the
// TPU's bisect of the same kernel with its grid, BlockSpecs and scratch
// kept and the bodies stripped. The variants, per layer (phases 1-5 as in
// encoder_stack.cu: QKV, attention, out-projection, fc1, fc2):
//   dma      every weight byte of the layer read once and summed, nothing
//            else: x comes back unchanged. The JAX kernel's sums are dead
//            stores; here each block writes its sum of each (layer, weight
//            tensor) to `sink`, a buffer the wrapper keeps, so nvcc keeps
//            the reads being timed and the wrapper can hold the stream to
//            the weights' sums.
//   scratch  QKV (x @ Wqkv, no LN, no bias), then in the attention phase
//            x += round(q * 0.001) over all rows, b times (the JAX
//            kernel's b attention steps each touch the whole scratch), then
//            fc1 (no GELU) and fc2 into an fp32 accumulator that is zeroed
//            once, at the start, and never again: each layer's x is the
//            running sum, round(acc) (encstack_minrepro.py:79-82).
//   rows     scratch, with each image's rows updated once (row slices).
//   nodots   rows' GEMMs; the attention phase copies q into the context
//            buffer, and the out-projection phase adds round(LN(q) @ Wout)
//            (LN without scale or bias) into x.
//   lnqkv    nodots with LN before QKV and fc1, and GELU after fc1.
//   nosm     nodots' GEMMs with the attention core in place of the copy,
//            softmax deleted (p = s, attention_core.cuh's kAttnMxu), and
//            no LN before the out-projection.
//   core     nosm with the real core (kAttnFull over all sp keys: the JAX
//            variant masks nothing).
// JAX's `@flat` runs the same bodies on a 1-D grid, to let Mosaic stream
// the weights across the layer boundary. A persistent kernel already walks
// the layers in one loop, so `@flat` is the same launch here.
//
// The GEMM phases are K9's (stack_phase.cuh: in bf16 the wgmma phases of
// stack_wgmma.cuh, LN(x) written once a phase into the context buffer
// before the products, the out-projection and fc2 split over K into the
// QKV buffer; in fp32 gemm_tile's tiles with K6's LN prologue), whose
// tiles do not depend on JAX's (cq, mt) chunking: the pair changes only
// the order of the fp32 sums. JAX's dots here run in fp32 on fp32
// operands (no precision=, so true fp32 on the CPU); on the card the
// products are those of the tensor's type, whose bf16 products are exact
// in fp32 -- except lnqkv's QKV, where the JAX kernel feeds the fp32 LN
// output unrounded and the port rounds it to the type.
//
// Bound on the card: the weight stream at bs <= 2, as K9: B/16 bf16 reads
// 12 x 14.16 MB = 170 MB, 51 us at 3.35 TB/s. `dma` is that stream alone:
// each block reads 16-byte vectors four at a time, grid-strided, so that
// enough loads are in flight to approach the memory rate.

#include <cooperative_groups.h>

#include "stack_phase.cuh"

namespace cg = cooperative_groups;

namespace vit {

enum StackProbeVariant : int {
  kVarDma = 0,
  kVarScratch = 1,
  kVarRows = 2,
  kVarNodots = 3,
  kVarLnqkv = 4,
  kVarNosm = 5,
  kVarCore = 6,
};

template <typename T>
struct ProbeStackArgs {
  T* x;          // (m, D) working activation: the input, then the output
  T* qkv;        // (m, 3D) packed [q|k|v]
  T* ctx;        // (m, D) attention context (or q's copy)
  T* hid;        // (m, mlp) fc1 output
  float* acc;    // (m, D) the running fp32 MLP sum
  float* sink;   // dma: (grid, layers, 4) block sums of the weights
  const T *wqkv, *wout, *w1, *w2;  // stacked along a leading layers axis
  const T *ones, *zeros;           // (D,): the LN's unit scale, zero bias
  int b, sp, d, mlp, heads, layers;
  float scale, eps;
  // bf16: the GEMM phases' tensor maps and split-K workspace (K9's).
  sw::Maps maps;
  float* ws;
};

// out = round(act(acc)): the QKV and fc1 phases.
template <typename T>
struct StoreRounded {
  T* out;
  int n;
  bool gelu_act;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    out[static_cast<size_t>(row) * n + col] =
        from_f32<T>(gelu_act ? gelu(acc) : acc);
  }
};

// x = round(x + round(acc)): the out-projection (`xcur[rows] +=
// out.astype(dtype)`).
template <typename T>
struct AddRounded {
  T* x;
  int n;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    const size_t idx = static_cast<size_t>(row) * n + col;
    x[idx] = from_f32<T>(to_f32(x[idx]) + to_f32(from_f32<T>(acc)));
  }
};

// acc32 += acc; x = round(acc32): fc2 into the never-reset accumulator.
template <typename T>
struct Accumulate {
  float* acc32;
  T* x;
  int n;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    const size_t idx = static_cast<size_t>(row) * n + col;
    const float v = acc32[idx] + acc;
    acc32[idx] = v;
    x[idx] = from_f32<T>(v);
  }
};

// The sum of n values of w, each read once, by the whole grid: 16-byte
// vectors, four loads in flight a thread; this thread's part.
template <typename T>
__device__ __forceinline__ float stream_sum(const T* __restrict__ w,
                                            size_t n) {
  constexpr int kV = 16 / sizeof(T), kUnroll = 4;
  const size_t tid = static_cast<size_t>(blockIdx.x) * kMmThreads +
                     threadIdx.x;
  const size_t threads = static_cast<size_t>(gridDim.x) * kMmThreads;
  float s = 0.f;
  size_t done = 0;
  if (aligned16(w)) {
    const uint4* w4 = reinterpret_cast<const uint4*>(w);
    const size_t nv = n / kV, step = threads * kUnroll;
    size_t i = tid;
    for (; i + (kUnroll - 1) * threads < nv; i += step) {
      uint4 u[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) u[r] = w4[i + r * threads];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const T* e = reinterpret_cast<const T*>(&u[r]);
#pragma unroll
        for (int j = 0; j < kV; ++j) s += to_f32(e[j]);
      }
    }
    for (; i < nv; i += threads) {
      const uint4 u = w4[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kV; ++j) s += to_f32(e[j]);
    }
    done = nv * kV;
  }
  for (size_t i = done + tid; i < n; i += threads) s += to_f32(w[i]);
  return s;
}

// dma's phase: the block's part of the sum of n values of w, written to
// sink[slot] by its thread 0. red: kMmThreads / 32 floats of shared memory.
template <typename T>
__device__ __forceinline__ void stream_phase(const T* __restrict__ w,
                                             size_t n, float* sink,
                                             size_t slot, float* red) {
  const float s = warp_sum(stream_sum(w, n));
  __syncthreads();  // red is free: the last phase's reads are done
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < kMmThreads / 32; ++i) t += red[i];
    sink[slot] = t;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kMmThreads, 1)
    encstack_probe_kernel(const __grid_constant__ ProbeStackArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int D = a.d, m = a.b * a.sp, dh = D / a.heads;
  const size_t tid = static_cast<size_t>(blockIdx.x) * kMmThreads +
                     threadIdx.x;
  const size_t threads = static_cast<size_t>(gridDim.x) * kMmThreads;
  const size_t md = static_cast<size_t>(m) * D;
  constexpr bool kLnQkv = V == kVarLnqkv;
  float* red = reinterpret_cast<float*>(smem);  // dma's block sums

  // The accumulator is zeroed once; phase 5 of layer 0 first reads it,
  // four grid barriers later.
  if constexpr (V != kVarDma)
    for (size_t e = tid; e < md; e += threads) a.acc[e] = 0.f;
  // The JAX kernel's 0.001 is a weakly typed constant: it takes the
  // tensor's type before it multiplies.
  const float c001 = to_f32(from_f32<T>(0.001f));
  const int q_tiles = (a.sp + kAttnQT - 1) / kAttnQT;

  const sw::Maps& mp = a.maps;
  const T* none = nullptr;
  for (int l = 0; l < a.layers; ++l) {
    const size_t lq = static_cast<size_t>(l) * D * 3 * D;
    const size_t lo = static_cast<size_t>(l) * D * D;
    const size_t lm = static_cast<size_t>(l) * D * a.mlp;
    const size_t slot = (static_cast<size_t>(blockIdx.x) * a.layers + l) * 4;
    // 1. QKV.
    if constexpr (V == kVarDma) {
      stream_phase(a.wqkv + lq, static_cast<size_t>(D) * 3 * D, a.sink,
                   slot + 0, red);
      grid.sync();
    } else {
      // With LN, LN(x) goes to the context buffer (free until phase 2).
      stack_phase<kLnQkv>(grid, smem, a.x, a.wqkv + lq,
                          kLnQkv ? &mp.ctx : &mp.x, &mp.wqkv, l * D, m,
                          3 * D, D, a.ones, a.zeros, a.eps,
                          kLnQkv ? a.ctx : nullptr, nullptr,
                          StoreRounded<T>{a.qkv, 3 * D, false});
    }
    // 2. Attention.
    if constexpr (V == kVarScratch || V == kVarRows) {
      const int reps = V == kVarScratch ? a.b : 1;
      for (size_t e = tid; e < md; e += threads) {
        const size_t r = e / D, c = e % D;
        const float dq = to_f32(
            from_f32<T>(to_f32(a.qkv[r * 3 * D + c]) * c001));
        T xv = a.x[e];
        for (int g = 0; g < reps; ++g) xv = from_f32<T>(to_f32(xv) + dq);
        a.x[e] = xv;
      }
    } else if constexpr (V == kVarNodots || V == kVarLnqkv) {
      for (size_t e = tid; e < md; e += threads)
        a.ctx[e] = a.qkv[e / D * 3 * D + e % D];
    } else if constexpr (V == kVarNosm || V == kVarCore) {
      constexpr int kMode = V == kVarNosm ? kAttnMxu : kAttnFull;
      for (int t = blockIdx.x; t < a.b * a.heads * q_tiles; t += gridDim.x) {
        const int img = t / (a.heads * q_tiles);
        const int h = t / q_tiles % a.heads;
        attention_tile<T, kMode>(a.qkv, a.ctx, a.sp, D, dh, a.scale, a.sp,
                                 img, h, t % q_tiles * kAttnQT, smem);
      }
    }
    sw::fence_proxy_async();  // x or the context is read by TMA next
    grid.sync();
    // 3. Out-projection (the QKV buffer, read no more this layer, is the
    // split-K workspace).
    if constexpr (V == kVarDma) {
      stream_phase(a.wout + lo, static_cast<size_t>(D) * D, a.sink,
                   slot + 1, red);
      grid.sync();
    } else if constexpr (V == kVarNodots || V == kVarLnqkv) {
      // LN(q) in place in the context buffer, read no more after this.
      stack_phase<true>(grid, smem, a.ctx, a.wout + lo, &mp.ctx, &mp.wout,
                        l * D, m, D, D, a.ones, a.zeros, a.eps, a.ctx,
                        nullptr, AddRounded<T>{a.x, D});
    } else if constexpr (V == kVarNosm || V == kVarCore) {
      stack_phase<false>(grid, smem, a.ctx, a.wout + lo, &mp.ctx, &mp.wout,
                         l * D, m, D, D, none, none, a.eps, nullptr, a.ws,
                         AddRounded<T>{a.x, D});
    } else {
      grid.sync();
    }
    // 4. fc1.
    if constexpr (V == kVarDma) {
      stream_phase(a.w1 + lm, static_cast<size_t>(D) * a.mlp, a.sink,
                   slot + 2, red);
      grid.sync();
    } else {
      stack_phase<kLnQkv>(grid, smem, a.x, a.w1 + lm,
                          kLnQkv ? &mp.ctx : &mp.x, &mp.w1, l * D, m, a.mlp,
                          D, a.ones, a.zeros, a.eps,
                          kLnQkv ? a.ctx : nullptr, nullptr,
                          StoreRounded<T>{a.hid, a.mlp, kLnQkv});
    }
    // 5. fc2 into the running accumulator.
    if constexpr (V == kVarDma) {
      stream_phase(a.w2 + lm, static_cast<size_t>(a.mlp) * D, a.sink,
                   slot + 3, red);
      grid.sync();
    } else {
      stack_phase<false>(grid, smem, a.hid, a.w2 + lm, &mp.hid, &mp.w2,
                         l * a.mlp, m, D, a.mlp, none, none, a.eps, nullptr,
                         a.ws, Accumulate<T>{a.acc, a.x, D});
    }
  }
}

template <typename T, int V>
cudaError_t launch_encstack_probe(ProbeStackArgs<T> a, int sink_len,
                                  int device, cudaStream_t st) {
  auto kernel = encstack_probe_kernel<T, V>;
  const size_t smem = stack_smem_all<T, T>(a.sp, a.d / a.heads, a.d);
  if (smem == 0) return cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, bf16>) {
    // K9's conditions and maps, and x's map for the phases without LN.
    const int m = a.b * a.sp, L = a.layers, d = a.d, mlp = a.mlp;
    if (mlp % 64 || !aligned16(a.x) || !aligned16(a.ctx) || !a.ws)
      return cudaErrorInvalidValue;
    sw::Maps& mp = a.maps;
    if (!act_map(&mp.x, a.x, m, d) || !act_map(&mp.ctx, a.ctx, m, d) ||
        !act_map(&mp.hid, a.hid, m, mlp) ||
        !weight_map<T>(&mp.wqkv, a.wqkv, L * d, 3 * d) ||
        !weight_map<T>(&mp.wout, a.wout, L * d, d) ||
        !weight_map<T>(&mp.w1, a.w1, L * d, mlp) ||
        !weight_map<T>(&mp.w2, a.w2, L * mlp, d))
      return cudaErrorInvalidValue;
  }
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, smem, device, &grid);
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(grid) * a.layers * 4 > sink_len)
    return cudaErrorInvalidValue;
  return launch_persistent(kernel, a, smem, grid, st);
}

template <typename T>
cudaError_t launch_encstack_probe_variant(int variant, ProbeStackArgs<T> a,
                                          int sink_len, int device,
                                          cudaStream_t st) {
  switch (variant) {
    case kVarDma:
      return launch_encstack_probe<T, kVarDma>(a, sink_len, device, st);
    case kVarScratch:
      return launch_encstack_probe<T, kVarScratch>(a, sink_len, device, st);
    case kVarRows:
      return launch_encstack_probe<T, kVarRows>(a, sink_len, device, st);
    case kVarNodots:
      return launch_encstack_probe<T, kVarNodots>(a, sink_len, device, st);
    case kVarLnqkv:
      return launch_encstack_probe<T, kVarLnqkv>(a, sink_len, device, st);
    case kVarNosm:
      return launch_encstack_probe<T, kVarNosm>(a, sink_len, device, st);
    case kVarCore:
      return launch_encstack_probe<T, kVarCore>(a, sink_len, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_encstack_probe_typed(void* x, void* qkv, void* ctx,
                                        void* hid, float* acc, float* sink,
                                        int sink_len, const void* wqkv,
                                        const void* wout, const void* w1,
                                        const void* w2, const void* ones,
                                        const void* zeros, int b, int sp,
                                        int d, int mlp, int heads, int layers,
                                        float scale, float eps, int variant,
                                        int device, cudaStream_t st) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  ProbeStackArgs<T> a{static_cast<T*>(x), static_cast<T*>(qkv),
                      static_cast<T*>(ctx), static_cast<T*>(hid), acc, sink,
                      c(wqkv), c(wout), c(w1), c(w2), c(ones), c(zeros),
                      b, sp, d, mlp, heads, layers, scale, eps};
  a.ws = static_cast<float*>(qkv);
  return launch_encstack_probe_variant<T>(variant, a, sink_len, device, st);
}

}  // namespace vit

// x (b*sp, d): the working activation, holding the input and, after the
// launch, the output; qkv (b*sp, 3d; in bf16 at least 16 b*sp*d elements,
// its bytes the split-K workspace too), ctx (b*sp, d), hid (b*sp, mlp) and
// acc (b*sp, d) fp32 scratch; sink (sink_len,) fp32, zeroed by the
// caller, at least (grid, L, 4): dma's block sums of wqkv, wout, w1 and w2
// of each layer (the rows past the grid stay zero); the stacked weights
// wqkv (L, d, 3d), wout (L, d, d), w1 (L, d, mlp), w2 (L, mlp, d); ones
// and zeros (d,); variant a StackProbeVariant.
extern "C" int vit_encstack_probe(void* x, void* qkv, void* ctx, void* hid,
                                  void* acc, void* sink, int sink_len,
                                  const void* wqkv, const void* wout,
                                  const void* w1, const void* w2,
                                  const void* ones, const void* zeros, int b,
                                  int sp, int d, int mlp, int heads,
                                  int layers, float scale, float eps,
                                  int variant, int dtype, int device,
                                  void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || sp <= 0 || d <= 0 || mlp <= 0 || heads <= 0 || d % heads ||
      layers <= 0 || !acc || !sink || sink_len <= 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* acc32 = static_cast<float*>(acc);
  auto* sink32 = static_cast<float*>(sink);
  if (dtype == kF32)
    return launch_encstack_probe_typed<float>(
        x, qkv, ctx, hid, acc32, sink32, sink_len, wqkv, wout, w1, w2, ones,
        zeros, b, sp, d, mlp, heads, layers, scale, eps, variant, device, st);
  if (dtype == kBF16)
    return launch_encstack_probe_typed<bf16>(
        x, qkv, ctx, hid, acc32, sink32, sink_len, wqkv, wout, w1, w2, ones,
        zeros, b, sp, d, mlp, heads, layers, scale, eps, variant, device, st);
  return cudaErrorInvalidValue;
}
