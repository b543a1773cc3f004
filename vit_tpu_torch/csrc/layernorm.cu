// K1: row layernorm, and K5: its row statistics alone.
//
// Replaces vit_tpu/ops/pallas/layernorm.py:layernorm (_layernorm_kernel):
// per row of D values, fp32 mean and biased variance, rsqrt(var + eps) with
// eps inside, scale and bias in fp32, one cast to the tensor's type.
//
// Bound on the card: device memory, 2*M*D*bytes (read x, write out). One
// warp owns one row and reduces it with shuffles, so no shared memory and no
// block-wide barrier are needed; the row is re-read from L1 for the second
// and third pass rather than held in registers, which keeps any D legal.
//
// K5 replaces vit_tpu/ops/pallas/layernorm.py:layernorm_stats
// (_stats_kernel): the fp32 mean and rsqrt(var + eps) of each row, written
// as two (M, 1) fp32 vectors for the LN prologue of fused_linear (K6,
// csrc/matmul.cu). Bound by reading M*D*bytes once (the writes are 8 bytes
// a row); the same one-warp-a-row layout as K1. The variance is the
// centred, biased sum((x - mean)^2) / D of a second pass over the row, not
// E[x^2] - mean^2, which loses digits on rows whose mean is large.
//
// K10: quantize_rows, the per-row symmetric int8 of the int8 tier. It is
// not a TPU kernel of its own: it is the first and the fourth of the five
// launches that attn_block_q (vit_tpu/ops/pallas/block.py:attn_block_q,
// _attn_q_core :1218-1221 and :1252-1254) takes on Hopper, and K12's
// prologue (csrc/mlp_block_i8.cu) runs its device routine, quantize_row
// (common.cuh). With LN, the fp32 normalisation of _ln32, not rounded to
// the tensor's type; then ax = max(max|xn|, 1e-12) / 127 (fp32, M) and xq
// = round(xn / ax) (int8, M x D). Bound by device memory: M*D*(bytes + 1)
// + 4*M (4.6 us with LN at B/16 bs=32, 6656 x 768 bf16, at 3.35 TB/s).
//
// Two forms, chosen by D alone before the launch (ops/cuda/quant.py:
// quantize_rows_form, the entry point's `form`; neither stands in for the
// other when a launch fails):
// - "row" (form 1, D a multiple of 128 up to kQrMaxD = 1280: B/16's 768,
//   L/16's 1024, H/14's 1280, and the shards' 384): quantize_rows_reg. A
//   warp reads each of its rows from device memory once, into registers
//   -- lane l holds elements l + 32 j, j < E = D / 32, the ownership of
//   row_stats, so that the sums, the LN values and the codes are bit for
//   bit those of quantize_row. With LN a warp walks rows grid-strided and
//   issues the next row's loads before the current row's reductions, so
//   that two rows a warp are in flight; without LN it takes one row
//   (kQrStrided). Gamma and beta are read once a warp and kept. The LN
//   value is computed once, kept for the abs max and the codes. The codes
//   go out four bytes a lane: lane l gathers bytes 4l .. 4l + 3 of each
//   128-byte chunk of the row from the four lanes that own them (four
//   shuffles and three byte permutes a chunk), so a warp writes 128
//   contiguous bytes a store. The codes' division by the row's scale runs
//   as FMAs from the scale's reciprocal, the same bits as __fdiv_rn's
//   without its branch (quant_code_rcp).
// - "scalar" (form 0, any other D): quantize_rows_kernel, one warp a row,
//   quantize_row as K12 runs it, the row read three or four times, from
//   L1 after the first, the codes one byte a lane.

#include "common.cuh"

namespace vit {

constexpr int kLnThreads = 256;
constexpr int kLnRowsPerBlock = kLnThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    layernorm_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const T* __restrict__ b, T* __restrict__ out, int rows,
                     int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t off = static_cast<size_t>(row) * d;
  layernorm_row<T, T>(x + off, g, b, out + off, d, eps, lane);
}

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    layernorm_stats_kernel(const T* __restrict__ x, float* __restrict__ mu,
                           float* __restrict__ rstd, int rows, int d,
                           float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const float2 st = row_stats(x + static_cast<size_t>(row) * d, d, eps, lane);
  if (lane == 0) {
    mu[row] = st.x;
    rstd[row] = st.y;
  }
}

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    quantize_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const T* __restrict__ b, signed char* __restrict__ q,
                         float* __restrict__ ax, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kLnRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const size_t off = static_cast<size_t>(row) * d;
  signed char* qr = q + off;
  const float a = quantize_row(x + off, g, b, d, eps, lane,
                               [&](int i, signed char c) { qr[i] = c; });
  if (lane == 0) ax[row] = a;
}

// K10's row form (the header's "row"), E elements a lane (D = 32 E), four
// warps a block. Its launch shape, the faster on the card of the two for
// each (tools/quantize_rows_ablate.py): with LN as many blocks as the SMs
// hold, each warp walking rows grid-strided with the next row's loads in
// flight; without LN a warp a row, the blocks that do not fit waiting for
// the hardware to start them.
constexpr int kQrMaxD = 1280;
constexpr int kQrThreads = 128;
constexpr int kQrWarps = kQrThreads / 32;
template <bool LN>
constexpr bool kQrStrided = LN;

// Whether the row form takes rows of d values.
inline bool quantize_rows_reg_takes(int d) {
  return d % 128 == 0 && d <= kQrMaxD;
}

// quant_code(v, a) with the quotient taken from ra = __frcp_rn(a), the
// reciprocal rounded to nearest, in FMAs and no branch: q0 = v ra is
// within 1.5 ulps of v / a, q1 = q0 + (v - a q0) ra within one, and q2 =
// q1 + (v - a q1) ra is v / a rounded to nearest (Markstein's theorem: a
// reciprocal within half an ulp, a quotient within one, no underflow), so
// the code is quant_code's for finite v. Where |v| >= a / 4 every step is
// a normal number (a >= 1e-12 / 127); below it both codes are 0.
// __fdiv_rn takes a range check and a branch to its slow path for each
// code, which keeps the codes of a lane from overlapping.
__device__ __forceinline__ signed char quant_code_rcp(float v, float a,
                                                      float ra) {
  float q = __fmul_rn(v, ra);
  q = __fmaf_rn(__fmaf_rn(-a, q, v), ra, q);
  q = __fmaf_rn(__fmaf_rn(-a, q, v), ra, q);
  const float r = fminf(fmaxf(rintf(q), -127.f), 127.f);
  return static_cast<signed char>(__float2int_rn(r));
}

template <int E, typename T>
__device__ __forceinline__ void load_row(T (&v)[E], const T* __restrict__ x,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = x[lane + 32 * j];
}

template <typename T, int E, bool LN>
__global__ void __launch_bounds__(kQrThreads)
    quantize_rows_reg(const T* __restrict__ x, const T* __restrict__ g,
                      const T* __restrict__ b, signed char* __restrict__ q,
                      float* __restrict__ ax, int rows, float eps) {
  static_assert(E % 4 == 0, "whole 128-byte chunks of codes");
  constexpr int D = 32 * E;
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * kQrWarps;
  int row = blockIdx.x * kQrWarps + threadIdx.x / 32;
  if (row >= rows) return;
  float gg[LN ? E : 1], bb[LN ? E : 1];
  if constexpr (LN) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      gg[j] = to_f32(g[lane + 32 * j]);
      bb[j] = to_f32(b[lane + 32 * j]);
    }
  }
  T cur[E];
  load_row<E>(cur, x + static_cast<size_t>(row) * D, lane);
  for (; row < rows; row += stride) {
    // The next row's loads go out before this row's reductions.
    T nxt[E];
    if (row + stride < rows)
      load_row<E>(nxt, x + static_cast<size_t>(row + stride) * D, lane);
    float v[E];
#pragma unroll
    for (int j = 0; j < E; ++j) v[j] = to_f32(cur[j]);
    if constexpr (LN) {
      // row_stats and quantize_row's value, in their order.
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) s += v[j];
      const float mean = warp_sum(s) / D;
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float c = v[j] - mean;
        ss += c * c;
      }
      const float rstd = rsqrtf(warp_sum(ss) / D + eps);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float c = __fmul_rn(__fsub_rn(v[j], mean), rstd);
        v[j] = __fadd_rn(__fmul_rn(c, gg[j]), bb[j]);
      }
    }
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) m = fmaxf(m, fabsf(v[j]));
    const float a = quant_scale(warp_max(m)), ra = __frcp_rn(a);
    signed char* qr = q + static_cast<size_t>(row) * D;
    const int src = 4 * lane % 32, u = lane / 8;
    const uint32_t sel = u | (u + 4) << 4;
#pragma unroll
    for (int c = 0; c < E / 4; ++c) {
      // This lane's codes of chunk c (elements 128 c + lane + 32 i), then
      // bytes 4 lane .. 4 lane + 3 of the chunk: byte u of the words of
      // lanes src .. src + 3.
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w |= static_cast<uint32_t>(static_cast<uint8_t>(
                 quant_code_rcp(v[4 * c + i], a, ra)))
             << (8 * i);
      const uint32_t w0 = __shfl_sync(0xffffffffu, w, src);
      const uint32_t w1 = __shfl_sync(0xffffffffu, w, src + 1);
      const uint32_t w2 = __shfl_sync(0xffffffffu, w, src + 2);
      const uint32_t w3 = __shfl_sync(0xffffffffu, w, src + 3);
      *reinterpret_cast<uint32_t*>(qr + 128 * c + 4 * lane) = __byte_perm(
          __byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
    }
    if (lane == 0) ax[row] = a;
#pragma unroll
    for (int j = 0; j < E; ++j) cur[j] = nxt[j];
  }
}

// One launch of the row form (kQrThreads, kQrStrided); the blocks the
// card holds at once are asked for once a device.
template <typename T, int E, bool LN>
cudaError_t launch_quantize_rows_reg(const T* x, const T* g, const T* b,
                                     signed char* q, float* ax, int rows,
                                     float eps, int device, cudaStream_t st) {
  int grid = (rows + kQrWarps - 1) / kQrWarps;  // a warp a row
  if (kQrStrided<LN>) {
    constexpr int kMaxDevices = 64;
    static int resident[kMaxDevices];  // 0 until known
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (resident[device] == 0) {
      int per_sm = 0, sms = 0;
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, quantize_rows_reg<T, E, LN>, kQrThreads, 0);
      if (err != cudaSuccess) return err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (err != cudaSuccess) return err;
      if (per_sm <= 0) return cudaErrorLaunchOutOfResources;
      resident[device] = per_sm * sms;
    }
    if (grid > resident[device]) grid = resident[device];
  }
  quantize_rows_reg<T, E, LN>
      <<<grid, kQrThreads, 0, st>>>(x, g, b, q, ax, rows, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t quantize_rows_reg_form(const void* x, const void* g,
                                   const void* b, signed char* q, float* ax,
                                   int rows, int d, float eps, int device,
                                   cudaStream_t st) {
  const auto* xx = static_cast<const T*>(x);
  const auto* gg = static_cast<const T*>(g);
  const auto* bb = static_cast<const T*>(b);
  switch (d / 32) {
#define VIT_QR_E(E)                                                       \
  case E:                                                                 \
    return g ? launch_quantize_rows_reg<T, E, true>(xx, gg, bb, q, ax,    \
                                                    rows, eps, device, st) \
             : launch_quantize_rows_reg<T, E, false>(xx, gg, bb, q, ax,   \
                                                     rows, eps, device, st);
    VIT_QR_E(4)
    VIT_QR_E(8)
    VIT_QR_E(12)
    VIT_QR_E(16)
    VIT_QR_E(20)
    VIT_QR_E(24)
    VIT_QR_E(28)
    VIT_QR_E(32)
    VIT_QR_E(36)
    VIT_QR_E(40)
#undef VIT_QR_E
  }
  return cudaErrorInvalidValue;
}

}  // namespace vit

extern "C" const char* vit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int vit_layernorm(const void* x, const void* g, const void* b,
                             void* out, int rows, int d, float eps, int dtype,
                             int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const dim3 grid((rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    layernorm_kernel<float><<<grid, kLnThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), static_cast<float*>(out), rows, d, eps);
  } else if (dtype == kBF16) {
    layernorm_kernel<bf16><<<grid, kLnThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(b), static_cast<bf16*>(out), rows, d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int vit_layernorm_stats(const void* x, void* mu, void* rstd,
                                   int rows, int d, float eps, int dtype,
                                   int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  const dim3 grid((rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    layernorm_stats_kernel<float><<<grid, kLnThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(mu),
        static_cast<float*>(rstd), rows, d, eps);
  } else if (dtype == kBF16) {
    layernorm_stats_kernel<bf16><<<grid, kLnThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<float*>(mu),
        static_cast<float*>(rstd), rows, d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K10: x (rows, d) in the dtype; g and b (d,) in the dtype, or both null
// for no LN; q (rows, d) int8 (4-byte aligned) and ax (rows,) fp32 out;
// form 1 the row form (quantize_rows_reg_takes(d), else refused), 0 the
// scalar one.
extern "C" int vit_quantize_rows(const void* x, const void* g, const void* b,
                                 void* q, void* ax, int rows, int d,
                                 float eps, int form, int dtype, int device,
                                 void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || d <= 0 || (g == nullptr) != (b == nullptr) ||
      (form != 0 && form != 1) || (form == 1 && !quantize_rows_reg_takes(d)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<signed char*>(q);
  auto* aa = static_cast<float*>(ax);
  if (form == 1) {
    if (reinterpret_cast<uintptr_t>(q) % 4 != 0) return cudaErrorInvalidValue;
    if (dtype == kF32)
      return quantize_rows_reg_form<float>(x, g, b, qq, aa, rows, d, eps,
                                           device, st);
    if (dtype == kBF16)
      return quantize_rows_reg_form<bf16>(x, g, b, qq, aa, rows, d, eps,
                                          device, st);
    return cudaErrorInvalidValue;
  }
  const dim3 grid((rows + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
  if (dtype == kF32) {
    quantize_rows_kernel<float><<<grid, kLnThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<const float*>(b), qq, aa, rows, d, eps);
  } else if (dtype == kBF16) {
    quantize_rows_kernel<bf16><<<grid, kLnThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(g),
        static_cast<const bf16*>(b), qq, aa, rows, d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
