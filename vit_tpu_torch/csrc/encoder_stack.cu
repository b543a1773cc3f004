// K9: the whole pre-LN encoder in one launch -- a cooperative persistent
// kernel -- plain, or with the patch embed and the final LN folded in.
//
// Replaces vit_tpu/ops/pallas/block.py:encoder_stack (_encoder_stack_kernel,
// block.py:1926-2000) and, with FOLD, encoder_stack_fused (the same kernel
// with n_tok and fold_ln, block.py:1905-1922, 1994-1998): the small-batch
// route, where the TPU kept the activation, the packed QKV and an fp32 MLP
// accumulator in VMEM for the whole run and walked a sequential (L, T) grid
// while the weights streamed in.
//
// On Hopper that scratch goes to device memory, where it stays in the 50 MB
// L2 (B/16 bs=2: activation 0.64 MB, QKV 1.9 MB, MLP hidden 2.6 MB), and the
// sequential grid becomes a persistent cooperative kernel: as many blocks
// as fit at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor; one an SM
// at sp=208), launched with cudaLaunchCooperativeKernel. Each phase of a
// layer is a loop over work tiles strided by gridDim.x, and a grid-wide
// barrier (cooperative_groups::this_grid().sync()) separates the phases.
// Every block reaches every barrier, with or without a tile in the phase.
// The phase routines (stack_phase, the persistent launch) are in
// stack_phase.cuh, which K9's probe K24 (encstack_probe.cu) shares. In bf16
// the GEMM phases run on stack_wgmma.cuh (wgmma fed by TMA from tensor maps
// over the stacked weights, LN(x) written once a phase before the
// products, 64 x 128 items, the out-projection and fc2 split over K in a
// fixed order; see there); in fp32 on gemm_tile.cuh's FFMA tile, where K6's
// LN prologue normalises while staging. Per layer:
//   1. LN1 + QKV (bf16: LN1 of every row once, into the context buffer,
//      then the products read it; the Pallas kernel recomputed LN1 per
//      chunk).
//   2. Attention, one work item per (image, head, query tile), with
//      _encoder_stack_kernel's row-max softmax (block.py:1953-1968). bf16
//      runs K4's tensor-core core (attention_mma.cuh, mma.sync) on the
//      whole block: a 32-row tile, its keys in four parts, every warp 16
//      rows against one part (84 items at B/16 bs=1); where those tiles
//      would take the grid two rounds, a 64-row tile in two parts (96
//      items at bs=2). fp32 runs the FFMA tile (attention_core.cuh), 64
//      rows on the whole block.
//   3. Out-projection + bout + residual, in place on the activation (bf16:
//      split over K into the workspace, then the slices' sum with the
//      epilogue after one more barrier).
//   4. LN2 + fc1 + GELU into the hidden buffer, in the tensor's type.
//   5. fc2 with the fp32 sum seeded with x + b2 (block.py:1981-1982), cast
//      back into the activation (bf16: split over K as in 3).
// FOLD adds phase 0, the patch projection with the fold's rounding (a):
// (patches @ wemb) in fp32 plus base[1+i] upcast, one cast (block.py:
// 1916-1919); row 0 of each image is base[0], its pad rows base[1+n:]. And
// the last layer's phase 5 writes its fp32 sum unrounded, which a last
// phase normalises with the final LN and casts once, rounding point (b)
// (block.py:1996-1997).
//
// With int8 weights the same kernel replaces vit_tpu/ops/pallas/block.py:
// encoder_stack_q (_encoder_stack_q_kernel, block.py:2400-2508), the int8
// tier's small-batch route: weight-only quantization, so activations stay
// in the tensor's type and every weight tile arrives as int8 and is
// converted, exactly, on chip (bf16: q_convert.cuh on each raw TMA box;
// fp32: as gemm_tile.cuh stages it); each phase's epilogue applies the
// per-column fp32 scale before the bias, (acc * s) + b, in JAX's order
// (block.py:2445, 2483, 2497, 2502). fc2's sum is scaled once over the
// whole K, where JAX scales each mt chunk: the fp32 sum order differs,
// nothing else. There is no FOLD form: the TPU has none for int8. Its
// bound at B/16 bs=1 is the int8 weight stream, 12 x 7.08 MB = 84.9 MB,
// about 25 us at 3.35 TB/s, half of the float kernel's (its bf16 products
// on the tensor cores take 37 us at peak).
//
// fp32 multiplies in true fp32 (FFMA, no TF32). Every sum is taken
// in a fixed order -- bf16's split-K adds its slices in ascending order, no
// atomics -- so two calls agree bit for bit. The kernel reads its inputs
// and writes only the scratch and output buffers that the wrapper
// (vit_tpu_torch/ops/cuda/stack.py) allocates; in bf16 the packed QKV
// buffer is sized to hold the split-K workspace too.
//
// Bound on the card: at bs <= 2 the weight stream. B/16 bf16 reads
// 12 x 14.16 MB = 170 MB of weights, a floor of about 51 us at 3.35 TB/s.
// On an NVIDIA H100 80GB HBM3 at 700 W this kernel takes about 1.04 ms
// at B/16 bs=1 in bf16 (1.11 on int8 weights; queued calls,
// tools/stack_ablate.py), some 20 times the floor: the attention phase
// 0.18 ms of it (1.05 on the FFMA core), most of the rest the GEMM
// phases' reads of each weight slab from L2 once per 64-row tile, their
// split-K reductions and the LN passes. The phase's time a tile barely
// follows the keys a warp walks: 64-row tiles in two parts took 0.20 ms
// at bs=1 and 16-row tiles in eight 0.25, while at bs=2 two parts (one
// round of 96 tiles) beat four (168 tiles, two rounds) by 0.05 ms.

#include <cooperative_groups.h>

#include "attention_mma.cuh"
#include "stack_phase.cuh"

namespace cg = cooperative_groups;

namespace vit {

// The bf16 attention phase's key parts (attention_tile_mma's P): a tile
// of 16 * 8 / P query rows on the block's eight warps. kStackAttnParts
// where its tiles fit the grid in one round, else half as many parts on
// tiles twice as tall (B/16 on 132 blocks: 84 tiles in four parts at
// bs=1, 96 in two at bs=2).
constexpr int kStackAttnParts = 4;

// Shared memory of the bf16 attention phase: K and V, and the parts'
// exchange (the larger at kStackAttnParts parts).
inline size_t stack_attn_smem(int sp, int dh) {
  return attention_mma_smem(sp, dh) +
         attn_mma_xbytes(kMmThreads / 32, kStackAttnParts,
                         attn_mma_nk_of(dh));
}

// K9's dynamic shared memory: fp32 stack_smem_all (the FFMA tile beside
// the GEMM tile); bf16 the wgmma phases' 227 KB, which hold FOLD's phase 0
// and the attention phase, 0 where the phases or the attention phase do
// not take the geometry.
template <typename T, typename W>
inline size_t stack_smem_k9(int sp, int dh, int d) {
  if constexpr (!std::is_same_v<T, bf16>) {
    return stack_smem_all<T, W>(sp, dh, d);
  } else {
    if (d % 64 || d > sw::kMaxK || stack_attn_smem(sp, dh) > kStackMaxSmem)
      return 0;
    const size_t ph0 =
        sizeof(typename Gemm<T>::Smem) + 2 * Gemm<T>::BM * sizeof(float);
    const size_t ph = sw::Layout<W>::kSmem;
    return ph > ph0 ? ph : ph0;
  }
}

template <typename T, typename W = T>
struct StackArgs {
  T* x;          // (m, D) working activation: the output without FOLD
  T* qkv;        // (m, 3D) packed [q|k|v]
  T* ctx;        // (m, D) attention context
  T* hid;        // (m, mlp) GELU hidden
  float* acc;    // (m, D) the last layer's fp32 MLP sum (FOLD)
  T* out;        // (m, D) the final LN's output (FOLD)
  // The encoder's weights, stacked along a leading num_layers axis; the
  // projections in W (the tensor's type, or int8).
  const T *ln1_g, *ln1_b;
  const W* wqkv;
  const T* bqkv;
  const W* wout;
  const T *bout, *ln2_g, *ln2_b;
  const W* w1;
  const T* b1;
  const W* w2;
  const T* b2;
  // FOLD: patches (b*n_tok, pd), wemb (pd, D), base (sp, D), final LN.
  const T *patches, *wemb, *base, *lnf_g, *lnf_b;
  int b, sp, d, mlp, heads, layers, seq_len, n_tok, pd;
  float scale, eps;
  // int8 weights: the per-column fp32 scales, stacked; null for float.
  const float *sqkv, *sout, *s1, *s2;
  // bf16: the phases' tensor maps, and the split-K workspace (the qkv
  // buffer, read as fp32).
  sw::Maps maps;
  float* ws;
};

// (acc * ws[col]) + bias with int8 weights, acc + bias without.
__device__ __forceinline__ float scaled_bias(float acc, const float* ws,
                                             int col, float bias) {
  return ws ? __fadd_rn(__fmul_rn(acc, ws[col]), bias) : acc + bias;
}

// round(act(acc + bias)) into out (ld n): the QKV and fc1 phases.
template <typename T>
struct BiasAct {
  const T* bias;
  T* out;
  int n;
  bool gelu_act;
  const float* ws;  // int8 weights' column scales, or null

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    float v = scaled_bias(acc, ws, col, to_f32(bias[col]));
    if (gelu_act) v = gelu(v);
    out[static_cast<size_t>(row) * n + col] = from_f32<T>(v);
  }
};

// x = round(acc + bias + x), in place: the out-projection (block.py:
// 1973-1975). Each element is read and written by the thread that owns it.
template <typename T>
struct AddResidual {
  const T* bias;
  T* x;
  int n;
  const float* ws;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    const size_t idx = static_cast<size_t>(row) * n + col;
    x[idx] = from_f32<T>(scaled_bias(acc, ws, col, to_f32(bias[col])) +
                         to_f32(x[idx]));
  }
};

// fc2: the sum seeded with x + b2, as the Pallas accumulator is; rounded
// back into x, or kept in fp32 in acc32 (FOLD's last layer).
template <typename T>
struct SeededResidual {
  const T* bias;
  T* x;
  float* acc32;
  int n;
  const float* ws;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    const size_t idx = static_cast<size_t>(row) * n + col;
    const float y = ws ? __fmul_rn(acc, ws[col]) : acc;
    const float v = (to_f32(x[idx]) + to_f32(bias[col])) + y;
    if (acc32)
      acc32[idx] = v;
    else
      x[idx] = from_f32<T>(v);
  }
};

// FOLD's patch projection: patch row g*n_tok + i is token row g*sp + 1 + i,
// round(acc + base[1 + i]) once.
template <typename T>
struct EmbedBase {
  const T* base;
  T* x;
  int n_tok, sp, d;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    const int g = row / n_tok, i = row % n_tok;
    x[(static_cast<size_t>(g) * sp + 1 + i) * d + col] = from_f32<T>(
        acc + to_f32(base[static_cast<size_t>(1 + i) * d + col]));
  }
};

// A layer's slice of a stacked scale vector, or null for float weights.
__device__ __forceinline__ const float* layer_scales(const float* s,
                                                     size_t off) {
  return s ? s + off : nullptr;
}

// Every (image, head, 16 * 8 / P-row query tile) once on the tensor cores
// (attention_tile_mma, the keys in P parts), strided over the grid, on
// the whole block.
template <int P, typename T, typename W>
__device__ __forceinline__ void attention_tiles_mma(const StackArgs<T, W>& a,
                                                    unsigned char* smem) {
  constexpr int qt = 16 * (kMmThreads / 32 / P);
  const int D = a.d, dh = D / a.heads, q_tiles = (a.sp + qt - 1) / qt;
  for (int t = blockIdx.x; t < a.b * a.heads * q_tiles; t += gridDim.x) {
    __syncthreads();  // the block's last tile is done with the smem
    const int img = t / (a.heads * q_tiles);
    const int h = t / q_tiles % a.heads;
    attn_mma_nk(dh, [&](auto nk) {
      attention_tile_mma<decltype(nk)::value, P, kMmThreads>(
          a.qkv, a.ctx, a.sp, D, dh, a.scale, a.seq_len, img, h,
          t % q_tiles * qt, smem);
    });
  }
}

// The attention phase: bf16 on the tensor cores, kStackAttnParts parts
// where their tiles fit the grid in one round, else half as many; fp32 on
// the FFMA tile (attention_tile<float>), 64 rows on the whole block.
template <typename T, typename W>
__device__ __forceinline__ void attention_phase(const StackArgs<T, W>& a,
                                                unsigned char* smem) {
  if constexpr (std::is_same_v<T, bf16>) {
    constexpr int qt = 16 * (kMmThreads / 32 / kStackAttnParts);
    // The QKV phase's TMA writes to these bytes come before this phase's
    // generic and cp.async writes.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (a.b * a.heads * ((a.sp + qt - 1) / qt) <= static_cast<int>(gridDim.x))
      attention_tiles_mma<kStackAttnParts>(a, smem);
    else
      attention_tiles_mma<kStackAttnParts / 2>(a, smem);
  } else {
    const int D = a.d, dh = D / a.heads;
    const int q_tiles = (a.sp + kAttnQT - 1) / kAttnQT;
    for (int t = blockIdx.x; t < a.b * a.heads * q_tiles; t += gridDim.x) {
      const int img = t / (a.heads * q_tiles);
      const int h = t / q_tiles % a.heads;
      attention_tile<T>(a.qkv, a.ctx, a.sp, D, dh, a.scale, a.seq_len, img,
                        h, t % q_tiles * kAttnQT, smem);
    }
  }
}

template <typename T, typename W, bool FOLD>
__global__ void __launch_bounds__(kMmThreads, 1)
    encoder_stack_kernel(const __grid_constant__ StackArgs<T, W> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int D = a.d, m = a.b * a.sp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const sw::Maps& mp = a.maps;

  if (FOLD) {
    // Phase 0: the patch rows, then row 0 and the pad rows from base.
    gemm_phase<false>(a.patches, a.wemb, a.b * a.n_tok, D, a.pd,
                      static_cast<const T*>(nullptr),
                      static_cast<const T*>(nullptr), a.eps,
                      EmbedBase<T>{a.base, a.x, a.n_tok, a.sp, D}, smem);
    const int extra = a.sp - a.n_tok;  // row 0, rows n_tok+1 .. sp-1
    const size_t total = static_cast<size_t>(a.b) * extra * D;
    for (size_t e = static_cast<size_t>(blockIdx.x) * kMmThreads +
                    threadIdx.x;
         e < total; e += static_cast<size_t>(gridDim.x) * kMmThreads) {
      const int c = static_cast<int>(e % D);
      const int r = static_cast<int>(e / D);
      const int g = r / extra, j = r % extra;
      const int row = j == 0 ? 0 : a.n_tok + j;
      a.x[(static_cast<size_t>(g) * a.sp + row) * D + c] =
          a.base[static_cast<size_t>(row) * D + c];
    }
    grid.sync();
  }

  for (int l = 0; l < a.layers; ++l) {
    const size_t lv = static_cast<size_t>(l) * D;
    const size_t lm = static_cast<size_t>(l) * a.mlp;
    // 1. LN1 + QKV.
    // (bf16: LN(x) into the context buffer, free until the attention.)
    stack_phase<true>(grid, smem, a.x, a.wqkv + lv * 3 * D, &mp.ctx,
                      &mp.wqkv, l * D, m, 3 * D, D, a.ln1_g + lv,
                      a.ln1_b + lv, a.eps, a.ctx, nullptr,
                      BiasAct<T>{a.bqkv + lv * 3, a.qkv, 3 * D, false,
                                 layer_scales(a.sqkv, lv * 3)});
    // 2. Attention.
    attention_phase(a, smem);
    sw::fence_proxy_async();  // the context is read by TMA next
    grid.sync();
    // 3. Out-projection + bout + residual, in place (split over K into
    // the workspace: the QKV buffer is read no more this layer).
    stack_phase<false>(grid, smem, a.ctx, a.wout + lv * D, &mp.ctx,
                       &mp.wout, l * D, m, D, D,
                       static_cast<const T*>(nullptr),
                       static_cast<const T*>(nullptr), a.eps, nullptr, a.ws,
                       AddResidual<T>{a.bout + lv, a.x, D,
                                      layer_scales(a.sout, lv)});
    // 4. LN2 + fc1 + GELU.
    stack_phase<true>(grid, smem, a.x, a.w1 + lm * D, &mp.ctx, &mp.w1,
                      l * D, m, a.mlp, D, a.ln2_g + lv, a.ln2_b + lv, a.eps,
                      a.ctx, nullptr,
                      BiasAct<T>{a.b1 + lm, a.hid, a.mlp, true,
                                 layer_scales(a.s1, lm)});
    // 5. fc2, seeded with x + b2.
    const bool last = FOLD && l == a.layers - 1;
    stack_phase<false>(grid, smem, a.hid, a.w2 + lm * D, &mp.hid, &mp.w2,
                       l * a.mlp, m, D, a.mlp,
                       static_cast<const T*>(nullptr),
                       static_cast<const T*>(nullptr), a.eps, nullptr, a.ws,
                       SeededResidual<T>{a.b2 + lv, a.x,
                                         last ? a.acc : nullptr, D,
                                         layer_scales(a.s2, lv)});
  }

  if (FOLD) {
    // The final LN over the fp32 sum, one warp a row, cast once.
    const int warps = gridDim.x * (kMmThreads / 32);
    for (int r = blockIdx.x * (kMmThreads / 32) + warp; r < m; r += warps)
      layernorm_row<float, T>(a.acc + static_cast<size_t>(r) * D, a.lnf_g,
                              a.lnf_b, a.out + static_cast<size_t>(r) * D, D,
                              a.eps, lane);
  }
}

template <typename T, typename W, bool FOLD>
cudaError_t launch_stack(StackArgs<T, W> a, int device, cudaStream_t st) {
  auto kernel = encoder_stack_kernel<T, W, FOLD>;
  const int dh = a.d / a.heads;
  const size_t smem = stack_smem_k9<T, W>(a.sp, dh, a.d);
  if (smem == 0) return cudaErrorInvalidValue;
  if constexpr (std::is_same_v<T, bf16>) {
    // The wgmma phases: D and mlp whole 64-column steps, the activation
    // 16-byte aligned (LN reads 16-byte chunks), every map encoded.
    const int m = a.b * a.sp, L = a.layers, d = a.d, mlp = a.mlp;
    if (mlp % 64 || !aligned16(a.x) || !a.ws) return cudaErrorInvalidValue;
    sw::Maps& mp = a.maps;
    if (!act_map(&mp.ctx, a.ctx, m, d) || !act_map(&mp.hid, a.hid, m, mlp) ||
        !weight_map<W>(&mp.wqkv, a.wqkv, L * d, 3 * d) ||
        !weight_map<W>(&mp.wout, a.wout, L * d, d) ||
        !weight_map<W>(&mp.w1, a.w1, L * d, mlp) ||
        !weight_map<W>(&mp.w2, a.w2, L * mlp, d))
      return cudaErrorInvalidValue;
  }
  int grid = 0;
  cudaError_t err = persistent_grid(kernel, smem, device, &grid);
  if (err != cudaSuccess) return err;
  return launch_persistent(kernel, a, smem, grid, st);
}

template <typename T>
cudaError_t launch_stack_typed(void* x, void* qkv, void* ctx, void* hid,
                               float* acc, void* out,
                               const void* const* w, const void* patches,
                               const void* wemb, const void* base,
                               const void* lnf_g, const void* lnf_b, int b,
                               int sp, int d, int mlp, int heads, int layers,
                               int seq_len, int n_tok, int pd, float scale,
                               float eps, int fold, int device,
                               cudaStream_t st) {
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  StackArgs<T> a{static_cast<T*>(x), static_cast<T*>(qkv),
                 static_cast<T*>(ctx), static_cast<T*>(hid), acc,
                 static_cast<T*>(out),
                 c(w[0]), c(w[1]), c(w[2]), c(w[3]), c(w[4]), c(w[5]),
                 c(w[6]), c(w[7]), c(w[8]), c(w[9]), c(w[10]), c(w[11]),
                 c(patches), c(wemb), c(base), c(lnf_g), c(lnf_b),
                 b, sp, d, mlp, heads, layers, seq_len, n_tok, pd,
                 scale, eps};
  a.ws = static_cast<float*>(qkv);
  return fold ? launch_stack<T, T, true>(a, device, st)
              : launch_stack<T, T, false>(a, device, st);
}

// K9 on int8 weights: w holds the twelve stacked tensors as in
// launch_stack_typed (the four projections int8), sc the four stacked
// fp32 column scales (qkv, out, fc1, fc2).
template <typename T>
cudaError_t launch_stack_q(void* x, void* qkv, void* ctx, void* hid,
                           const void* const* w, const void* const* sc, int b,
                           int sp, int d, int mlp, int heads, int layers,
                           int seq_len, float scale, float eps, int device,
                           cudaStream_t st) {
  using W = signed char;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  auto q = [](const void* p) { return static_cast<const W*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  StackArgs<T, W> a{static_cast<T*>(x), static_cast<T*>(qkv),
                    static_cast<T*>(ctx), static_cast<T*>(hid), nullptr,
                    nullptr,
                    c(w[0]), c(w[1]), q(w[2]), c(w[3]), q(w[4]), c(w[5]),
                    c(w[6]), c(w[7]), q(w[8]), c(w[9]), q(w[10]), c(w[11]),
                    nullptr, nullptr, nullptr, nullptr, nullptr,
                    b, sp, d, mlp, heads, layers, seq_len, 0, 0, scale, eps,
                    f(sc[0]), f(sc[1]), f(sc[2]), f(sc[3])};
  a.ws = static_cast<float*>(qkv);
  return launch_stack<T, W, false>(a, device, st);
}

}  // namespace vit

// x (b*sp, d): the working activation, holding the input without fold and
// the output after the launch; qkv (b*sp, 3d; in bf16 at least 16 b*sp*d
// elements, its bytes the split-K workspace too), ctx (b*sp, d), hid
// (b*sp, mlp): scratch; acc (b*sp, d) fp32 and out (b*sp, d): fold only.
// The twelve stacked weight tensors in the order ln1 scale, ln1 bias, qkv
// kernel, qkv bias, out kernel, out bias, ln2 scale, ln2 bias, fc1 kernel,
// fc1 bias, fc2 kernel, fc2 bias. With fold, patches (b*n_tok, pd), wemb
// (pd, d), base (sp, d) and the final LN's scale and bias.
extern "C" int vit_encoder_stack(
    void* x, void* qkv, void* ctx, void* hid, void* acc, void* out,
    const void* ln1_g, const void* ln1_b, const void* wqkv, const void* bqkv,
    const void* wout, const void* bout, const void* ln2_g, const void* ln2_b,
    const void* w1, const void* b1, const void* w2, const void* b2,
    const void* patches, const void* wemb, const void* base,
    const void* lnf_g, const void* lnf_b, int b, int sp, int d, int mlp,
    int heads, int layers, int seq_len, int n_tok, int pd, float scale,
    float eps, int fold, int dtype, int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || sp <= 0 || d <= 0 || mlp <= 0 || heads <= 0 || d % heads ||
      layers <= 0 || seq_len <= 0 || seq_len > sp ||
      (fold && (n_tok <= 0 || pd <= 0 || sp < n_tok + 1 || !acc || !out ||
                !patches || !wemb || !base || !lnf_g || !lnf_b)))
    return cudaErrorInvalidValue;
  const void* w[12] = {ln1_g, ln1_b, wqkv, bqkv, wout, bout,
                       ln2_g, ln2_b, w1,   b1,   w2,   b2};
  auto st = static_cast<cudaStream_t>(stream);
  auto* acc32 = static_cast<float*>(acc);
  if (dtype == kF32)
    return launch_stack_typed<float>(x, qkv, ctx, hid, acc32, out, w, patches,
                                     wemb, base, lnf_g, lnf_b, b, sp, d, mlp,
                                     heads, layers, seq_len, n_tok, pd, scale,
                                     eps, fold, device, st);
  if (dtype == kBF16)
    return launch_stack_typed<bf16>(x, qkv, ctx, hid, acc32, out, w, patches,
                                    wemb, base, lnf_g, lnf_b, b, sp, d, mlp,
                                    heads, layers, seq_len, n_tok, pd, scale,
                                    eps, fold, device, st);
  return cudaErrorInvalidValue;
}

// K9 on int8 weights (encoder_stack_q): x (b*sp, d) the working activation,
// holding the input and, after the launch, the output; qkv, ctx and hid
// scratch as for vit_encoder_stack; the twelve stacked tensors in
// vit_encoder_stack's order with the qkv, out, fc1 and fc2 kernels int8;
// then their fp32 column scales (L, 3d), (L, d), (L, mlp), (L, d).
extern "C" int vit_encoder_stack_q(
    void* x, void* qkv, void* ctx, void* hid, const void* ln1_g,
    const void* ln1_b, const void* wqkv, const void* bqkv, const void* wout,
    const void* bout, const void* ln2_g, const void* ln2_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* sqkv,
    const void* sout, const void* s1, const void* s2, int b, int sp, int d,
    int mlp, int heads, int layers, int seq_len, float scale, float eps,
    int dtype, int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || sp <= 0 || d <= 0 || mlp <= 0 || heads <= 0 || d % heads ||
      layers <= 0 || seq_len <= 0 || seq_len > sp || !sqkv || !sout || !s1 ||
      !s2)
    return cudaErrorInvalidValue;
  const void* w[12] = {ln1_g, ln1_b, wqkv, bqkv, wout, bout,
                       ln2_g, ln2_b, w1,   b1,   w2,   b2};
  const void* sc[4] = {sqkv, sout, s1, s2};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_stack_q<float>(x, qkv, ctx, hid, w, sc, b, sp, d, mlp,
                                 heads, layers, seq_len, scale, eps, device,
                                 st);
  if (dtype == kBF16)
    return launch_stack_q<bf16>(x, qkv, ctx, hid, w, sc, b, sp, d, mlp, heads,
                                layers, seq_len, scale, eps, device, st);
  return cudaErrorInvalidValue;
}
