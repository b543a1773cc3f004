// K23: the attention-core probe. It takes the attention block apart the
// way tools/attn_core_probe.py does on the TPU: the same block in 18 modes,
// each switching one ingredient of the core off or laying the data out
// another way, so that the time of each ingredient shows.
//
// Replaces tools/attn_core_probe.py:probe (_core_kernel, pallas_call :389)
// and _probe_t (_tcore_kernel :432, _xcore_kernel :447). The TPU kernel is
// the whole block in one grid step per `group` images; on Hopper the block
// is K4's four launches (vit_tpu_torch/ops/cuda/block.py: an image's QKV
// does not fit one SM), and the core takes the mode as a template
// parameter, on the tensor-core tile of K4's core in each dtype:
// - bf16: K4's tile (attention_mma.cuh, mma.sync) on K4's block, built in
//   attn_core_probe_masked.cu and attn_core_probe_all_keys.cu
//   (attn_core_probe.cuh): kAttnFull is K4's bf16 core, its very
//   instantiation, and K9's attention phase's arithmetic; qcore runs its
//   int8 codes on mma.sync m16n8k32;
// - fp32: K4's fp32 tile (attention_tf32.cuh, mma.sync tf32 in three
//   passes, a running max) on K4's block, built in
//   attn_core_probe_tf32_masked.cu and attn_core_probe_tf32_all_keys.cu
//   (attn_core_probe_tf32.cuh): kAttnFull is K4's fp32 core, its very
//   instantiation; qcore runs its int8 codes, exact in TF32, in one pass.
// The other modes change only what the mode names
// (vit_tpu_torch/tools/attn_core_probe.py has each mode's function and
// launches). A work item is (image, head, 64 queries), whatever the TPU's
// `group`.
//
// What the layout modes need beyond K4, each in this file:
// - kt: the K projection written transposed, (D, B*S) -- the QKV GEMM's
//   epilogue stores the k third there (kEpSplitKT), and the core reads k
//   from it, tokens contiguous;
// - tcore: every projection transposed, [qT|kT|vT] (3D, B*S)
//   (kEpAllT), the core head-major (kAttnHeadMajor: reads that buffer,
//   writes the context (D, B*S)), and the out-projection as WoutT @ ctxT,
//   its fp32 sum rounded, then transposed back as bout and x are added
//   (kEpOutT) -- the TPU kernel's one transpose in and one out;
// - xcore: activations (D, B*S) in and out: a column LN (col_layernorm),
//   the QKV projection WqkvT @ xnT with a bias per row (kEpRowBias), the
//   head-major core, and WoutT @ ctxT + bout + x per row (kEpOutX);
// - projonly: the QKV GEMM stores q apart, contiguous (kEpSplitQ), for the
//   out-projection to read as the context: no core launch.
// Each GEMM runs K2's tile where TMA reads both operands (K2's rule,
// ops/cuda/matmul.py:gemm_path): in bf16 gemm_wgmma.cuh's wgmma tile with
// the epilogue form of its XEP parameter (WgXep, ProbeEp's code + 1;
// wgmma_takes), transposed stores through the staging tile written
// transposed; in fp32 gemm_tf32.cuh's tf32 walk (three passes, K2's fp32
// tile; tf32_takes) with ProbeEpilogue's stores as its epilogue
// (Tf32Probe); the operands read as they lie (WqkvT, xnT and ctxT are
// contiguous row-major matrices there). Elsewhere K2's tile loop
// (gemm_tile.cuh) with ProbeEpilogue.
//
// Bound on the card at B/16 bs=32: the core's is K4's, bytes, 0.0122 ms in
// bf16, and in fp32 0.0244 ms (bytes; 4*B*H*S*seq_len*d = 4.0 GFLOP of
// products in three TF32 passes takes as long); each of the block's two
// GEMMs is K2's (the QKV 23.6 GFLOP, 0.0238 ms in bf16, 0.143 ms in
// fp32's three passes; the out-projection a third of that). The probe
// exists to show which of the core's ingredients costs the time, on the
// tiles the port runs.

#include "attn_core_probe.cuh"
#include "attn_core_probe_tf32.cuh"
#include "gemm_tf32.cuh"
#include "gemm_tile.cuh"

namespace vit {

// The probe's GEMM epilogues; m, n are the GEMM's rows and columns, d the
// model width.
enum ProbeEp : int {
  kEpSplitQ = 0,   // qkv row-major, the q third into alt (m, d)
  kEpSplitKT = 1,  // qkv row-major, the k third transposed into alt (d, m)
  kEpAllT = 2,     // all of qkv transposed: out (n, m)
  kEpRowBias = 3,  // out (m, n), the bias per row
  kEpOutX = 4,     // out (m, n) = acc + bias[row] + res (m, n)
  kEpOutT = 5,     // out (n, m) = round(acc) + bias[row] + res (n, m)
};

template <typename T, int EP>
struct ProbeEpilogue {
  const T* bias;
  const T* res;
  T* out;
  T* alt;
  int m, n, d;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    if constexpr (EP == kEpSplitQ || EP == kEpSplitKT || EP == kEpAllT) {
      const T v = from_f32<T>(acc + to_f32(bias[col]));
      if constexpr (EP == kEpAllT) {
        out[static_cast<size_t>(col) * m + row] = v;
      } else if (EP == kEpSplitQ && col < d) {
        alt[static_cast<size_t>(row) * d + col] = v;
      } else if (EP == kEpSplitKT && col >= d && col < 2 * d) {
        alt[static_cast<size_t>(col - d) * m + row] = v;
      } else {
        out[static_cast<size_t>(row) * n + col] = v;
      }
    } else if constexpr (EP == kEpRowBias) {
      out[static_cast<size_t>(row) * n + col] =
          from_f32<T>(acc + to_f32(bias[row]));
    } else if constexpr (EP == kEpOutX) {
      const size_t idx = static_cast<size_t>(row) * n + col;
      out[idx] = from_f32<T>((acc + to_f32(bias[row])) + to_f32(res[idx]));
    } else {
      const size_t idx = static_cast<size_t>(col) * m + row;
      out[idx] = from_f32<T>((to_f32(from_f32<T>(acc)) + to_f32(bias[row])) +
                             to_f32(res[idx]));
    }
  }
};

template <typename T, int EP>
__global__ void __launch_bounds__(kMmThreads)
    probe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      ProbeEpilogue<T, EP> ep, int k, bool vec_x,
                      bool vec_w) {
  __shared__ typename Gemm<T>::Smem sm;
  gemm_tile<false>(x, w, ep.m, ep.n, k, blockIdx.y * Gemm<T>::BM,
                   blockIdx.x * Gemm<T>::BN, vec_x, vec_w, LnPrologue<T>{},
                   ep, sm);
}

template <typename T, int EP>
cudaError_t launch_probe_gemm(const T* x, const T* w, const T* bias,
                              const T* res, T* out, T* alt, int m, int n,
                              int k, int d, cudaStream_t st) {
  const dim3 grid((n + Gemm<T>::BN - 1) / Gemm<T>::BN,
                  (m + Gemm<T>::BM - 1) / Gemm<T>::BM);
  probe_gemm_kernel<T, EP><<<grid, kMmThreads, 0, st>>>(
      x, w, ProbeEpilogue<T, EP>{bias, res, out, alt, m, n, d}, k,
      aligned16(x) && k % 8 == 0, aligned16(w) && n % 8 == 0);
  return cudaGetLastError();
}

// K23's GEMMs on the wgmma tile (matmul_wgmma.cu): the epilogue form
// xep = ProbeEp + 1 (gemm_wgmma.cuh's WgXep).
cudaError_t launch_wgmma_probe(int xep, const void* x, const void* w,
                               const void* bias, const void* res, void* out,
                               void* alt, int m, int n, int k, int d,
                               int device, cudaStream_t st);
bool wgmma_takes(const void* x, const void* w, int n, int k);

// f(std::integral_constant<int, EP>()) for the probe epilogue ep.
template <typename F>
cudaError_t with_probe_ep(int ep, F&& f) {
  switch (ep) {
    case kEpSplitQ: return f(std::integral_constant<int, kEpSplitQ>());
    case kEpSplitKT: return f(std::integral_constant<int, kEpSplitKT>());
    case kEpAllT: return f(std::integral_constant<int, kEpAllT>());
    case kEpRowBias: return f(std::integral_constant<int, kEpRowBias>());
    case kEpOutX: return f(std::integral_constant<int, kEpOutX>());
    case kEpOutT: return f(std::integral_constant<int, kEpOutT>());
    default: return cudaErrorInvalidValue;
  }
}

namespace tf {

// K23's fp32 GEMMs on K2's tf32 walk (gemm_tf32.cuh): ProbeEpilogue<float,
// EP> as the walk's epilogue, passed by value as K2's, K6's and K8's are,
// so that their kernels compile as before. Each thread stores its
// accumulator fragment's elements in ProbeEpilogue::store's order: a row's
// pair of columns, or, transposed, eight rows of a column in 32 contiguous
// bytes a group of eight lanes.
template <int EP>
struct Tf32Probe : ProbeEpilogue<float, EP> {};

template <int EP>
__device__ __forceinline__ void epilogue(const float (&d)[64],
                                         const Tf32Probe<EP>& ep, int m0,
                                         int n0) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = m0 + 16 * warp + lane / 4 + 8 * (i >> 1);
      const int gc = n0 + 8 * j + 2 * (lane % 4) + (i & 1);
      if (gr < ep.m && gc < ep.n) ep.store(gr, gc, d[4 * j + i]);
    }
}

template <int EP>
__device__ __forceinline__ void tile_done(const Tf32Probe<EP>&, int, int) {}

template <int EP>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32_probe(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    Tf32Probe<EP> ep, int k) {
  gemm_tf32_walk<0, 0, false, Tf32Probe<EP>>(map_a, map_b, ep, k,
                                             Tf32Ln{});
}

}  // namespace tf

// matmul_tf32.cu's fp32 tensor maps and K2's fp32 tile rule.
bool tensor_map_f32(CUtensorMap* map, const void* p, int rows, int cols,
                    int ld, int box_rows);
bool tf32_takes(const void* x, const void* w, int n, int k);

// x (m, k) @ w (k, n), contiguous (tf32_takes), on the tf32 walk with
// epilogue EP.
template <int EP>
cudaError_t launch_tf32_probe(const float* x, const float* w,
                              const float* bias, const float* res,
                              float* out, float* alt, int m, int n, int k,
                              int d, int device, cudaStream_t st) {
  CUtensorMap ma, mb;
  if (!tensor_map_f32(&ma, x, m, k, k, tf::kBM) ||
      !tensor_map_f32(&mb, w, k, n, n, 32))
    return cudaErrorInvalidValue;
  static int sm_count[tf::kMaxDevices];  // 0 until the first launch
  if (device < 0 || device >= tf::kMaxDevices)
    return cudaErrorInvalidDevice;
  return tf::launch_walk(tf::gemm_tf32_probe<EP>, sm_count[device], m, n,
                         device, st, ma, mb,
                         tf::Tf32Probe<EP>{{bias, res, out, alt, m, n, d}},
                         k);
}

// xcore's LN over the columns of x (d, m): 32 columns a block, 8 warps
// striding the rows; fp32 mean and centred variance of each column, then
// ((x - mean) * rstd) * g[row] + b[row], rounded to T
// (tools/attn_core_probe.py:364-366).
constexpr int kColLnCols = 32, kColLnRows = 8;

template <typename T>
__global__ void __launch_bounds__(kColLnCols * kColLnRows)
    col_layernorm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const T* __restrict__ b, T* __restrict__ out, int d,
                         int m, float eps) {
  __shared__ float red[kColLnRows][kColLnCols + 1];
  const int tx = threadIdx.x % kColLnCols, ty = threadIdx.x / kColLnCols;
  const int col = blockIdx.x * kColLnCols + tx;
  const bool in = col < m;
  float s = 0.f;
  if (in)
    for (int r = ty; r < d; r += kColLnRows)
      s += to_f32(x[static_cast<size_t>(r) * m + col]);
  red[ty][tx] = s;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < kColLnRows; ++i) tot += red[i][tx];
  const float mean = tot / d;
  __syncthreads();
  float ss = 0.f;
  if (in)
    for (int r = ty; r < d; r += kColLnRows) {
      const float c = to_f32(x[static_cast<size_t>(r) * m + col]) - mean;
      ss += c * c;
    }
  red[ty][tx] = ss;
  __syncthreads();
  float var = 0.f;
  for (int i = 0; i < kColLnRows; ++i) var += red[i][tx];
  const float rstd = rsqrtf(var / d + eps);
  if (in)
    for (int r = ty; r < d; r += kColLnRows) {
      const size_t idx = static_cast<size_t>(r) * m + col;
      const float c = (to_f32(x[idx]) - mean) * rstd;
      out[idx] = from_f32<T>(c * to_f32(g[r]) + to_f32(b[r]));
    }
}

}  // namespace vit

// The core in mode `mode` (AttnMode): qkv the packed (B*S, 3D) buffer (all
// modes but kAttnHeadMajor), tbuf kT (D, ldt) for kAttnKt or [qT|kT|vT]
// (3D, ldt) for kAttnHeadMajor, out (B*S, D) or, head-major, (D, ldt).
// heads is the number of work-item heads (kAttnWide: pairs of heads). Each
// dtype runs K4's tensor-core tile (attn_core_probe.cuh,
// attn_core_probe_tf32.cuh).
extern "C" int vit_attn_probe_core(const void* qkv, const void* tbuf,
                                   void* out, int batch, int s, int d,
                                   int heads, int seq_len, int ldt,
                                   float scale, int mode, int dtype,
                                   int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const bool needs_t = mode == kAttnKt || mode == kAttnHeadMajor;
  if (batch <= 0 || s <= 0 || heads <= 0 || d % heads || seq_len <= 0 ||
      seq_len > s || heads > 65535 || (needs_t && (!tbuf || ldt < batch * s)) ||
      (mode != kAttnHeadMajor && !qkv))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    auto* q = static_cast<const float*>(qkv);
    auto* tb = static_cast<const float*>(tbuf);
    auto* o = static_cast<float*>(out);
    return attn_masked(mode)
               ? launch_probe_core_tf32_masked(mode, q, tb, o, batch, s, d,
                                               heads, seq_len, ldt, scale, st)
               : launch_probe_core_tf32_all_keys(mode, q, tb, o, batch, s, d,
                                                 heads, seq_len, ldt, scale,
                                                 st);
  }
  if (dtype == kBF16) {
    auto* q = static_cast<const bf16*>(qkv);
    auto* tb = static_cast<const bf16*>(tbuf);
    auto* o = static_cast<bf16*>(out);
    return attn_masked(mode)
               ? launch_probe_core_masked(mode, q, tb, o, batch, s, d, heads,
                                          seq_len, ldt, scale, st)
               : launch_probe_core_all_keys(mode, q, tb, o, batch, s, d,
                                            heads, seq_len, ldt, scale, st);
  }
  return cudaErrorInvalidValue;
}

// x (m, k) @ w (k, n) with epilogue `ep` (ProbeEp): bias (n,) or, per row,
// (m,); res the residual of kEpOutX / kEpOutT; alt the split buffer of
// kEpSplitQ / kEpSplitKT; d the model width. x and w contiguous.
extern "C" int vit_attn_probe_gemm(const void* x, const void* w,
                                   const void* bias, const void* res,
                                   void* out, void* alt, int m, int n, int k,
                                   int d, int ep, int dtype, int device,
                                   void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0 || !bias ||
      ((ep == kEpSplitQ || ep == kEpSplitKT) && (!alt || n != 3 * d)) ||
      ((ep == kEpOutX || ep == kEpOutT) && !res))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    auto* xf = static_cast<const float*>(x);
    auto* wf = static_cast<const float*>(w);
    auto* bf = static_cast<const float*>(bias);
    auto* rf = static_cast<const float*>(res);
    auto* of = static_cast<float*>(out);
    auto* af = static_cast<float*>(alt);
    const bool tf32 = tf32_takes(x, w, n, k);
    return with_probe_ep(ep, [&](auto e) {
      constexpr int EP = decltype(e)::value;
      return tf32 ? launch_tf32_probe<EP>(xf, wf, bf, rf, of, af, m, n, k, d,
                                          device, st)
                  : launch_probe_gemm<float, EP>(xf, wf, bf, rf, of, af, m, n,
                                                 k, d, st);
    });
  }
  if (dtype == kBF16) {
    if (wgmma_takes(x, w, n, k))
      return launch_wgmma_probe(ep + 1, x, w, bias, res, out, alt, m, n, k, d,
                                device, st);
    return with_probe_ep(ep, [&](auto e) {
      return launch_probe_gemm<bf16, decltype(e)::value>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
          static_cast<bf16*>(out), static_cast<bf16*>(alt), m, n, k, d, st);
    });
  }
  return cudaErrorInvalidValue;
}

// The tile vit_attn_probe_gemm runs x (m, k) @ w (k, n) on, without
// launching: 1 K2's TMA tile (bf16 wgmma where wgmma_takes, fp32 tf32 where
// tf32_takes: K2's rule), 0 gemm_tile.cuh's
// (vit_tpu_torch/tools/attn_core_probe.py:gemm_tile asks it).
extern "C" int vit_attn_probe_gemm_tile(const void* x, const void* w, int n,
                                        int k, int dtype) {
  return (dtype == vit::kBF16 && vit::wgmma_takes(x, w, n, k)) ||
                 (dtype == vit::kF32 && vit::tf32_takes(x, w, n, k))
             ? 1
             : 0;
}

// xcore's column LN: x and out (d, m), g and b (d,).
extern "C" int vit_attn_probe_colln(const void* x, const void* g,
                                    const void* b, void* out, int d, int m,
                                    float eps, int dtype, int device,
                                    void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (d <= 0 || m <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + kColLnCols - 1) / kColLnCols);
  const int threads = kColLnCols * kColLnRows;
  if (dtype == kF32)
    col_layernorm_kernel<float><<<grid, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<float*>(out), d, m, eps);
  else if (dtype == kBF16)
    col_layernorm_kernel<bf16><<<grid, threads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(b), static_cast<bf16*>(out), d, m, eps);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
