// K11's tile for Hopper (vit_tpu/ops/pallas/block.py:attn_block_q's int8
// dots, _attn_q_core :1226-1231 and :1255-1258, with the + bout + x of
// :1275-1276; vit_tpu/quant.py:int8_matmul): xq (M, K) int8 @ wq (K, N)
// int8 on s8 wgmma fed by TMA, exact int32 sums, then in fp32 (acc *
// ax[row]) * wscale[col], + bias, GELU, + residual and one cast, in
// I8Epilogue::store's order (matmul.cu), with __fmul_rn / __fadd_rn, so
// that it agrees with its plain version bit for bit without GELU.
//
// Shape. A persistent, warp-specialised block of 384 threads an SM walks
// 128 x 128 output tiles. The walk is column-major (tile t at row t %
// tiles_m, column t / tiles_m) and each block takes one contiguous range
// of it, so consecutive tiles of a block share their 128 weight columns
// (the panel).
//
// - Thread 256 keeps TMA loads in flight: for each K step of 128 bytes the
//   A box (128 rows of xq x 128 K, K-major as it lies) into a ring of kSA
//   stages, and, where the tile needs its panel, the raw box of wq (128 K
//   rows x 128 N, N-major as it lies) into a ring of kSR stages.
// - Warps 9-11 turn each raw box K-major into one of kSB panel slots
//   (i8_wgmma.cuh: transpose_box), as far ahead as the slots allow.
// - Two consumer warpgroups (threads 0-255) each own 64 rows of the tile
//   and keep its 64 x 128 int32 sums in registers: per K step four
//   wgmma.mma_async m64n128k32 .s32.s8.s8, commit, wait for the previous
//   step's group, release its A stage (and its panel slot where the panel
//   is not kept).
// - Where the panel fits its slots (K <= kSB * 128 = 1024: the B/16 and
//   L/16 projections), a block transposes it once and walks the rows under
//   it: the slots are released only by the last tile of the panel. Where
//   K is larger (the composed MLP's fc2, K = mlp) every tile streams its
//   panel through the slots.
//
// Ragged edges: TMA fills a box outside the matrix with zeros (and counts
// its whole bytes), so sums past M, N or K are zeros; the epilogue masks
// rows and columns past M and N. TMA needs 16-byte aligned bases and row
// strides (K and N multiples of 16): the wrapper sends other shapes to
// gemm_tile.cuh's int8 tile (matmul.cu), by shape alone.
//
// Bound on the card: the tensor cores at B/16 bs=32's QKV (6656 x 768 @
// 768 x 2304, 23.6 GOP, 0.0119 ms at 1,979 TOP/s); device memory at the
// out-projection. What this tile still leaves: the epilogue stores from
// the accumulator fragments (4- or 8-byte stores) and is not overlapped
// with the next tile's products; the transposition shares the shared
// memory's bandwidth with wgmma where the panel streams (PERF.md: the
// epilogue and the transposition's shares, by ablation).

#include <type_traits>

#include "i8_wgmma.cuh"

namespace vit {
namespace mi {

using namespace i8;

constexpr int kBM = 128, kBN = 128;
constexpr int kSA = 4, kSR = 2, kSB = 8;
constexpr int kROff = kSA * kBox;
constexpr int kBOff = kROff + kSR * kBox;
constexpr int kBarOff = kBOff + kSB * kBox;
constexpr int kBarBytes = 256;
// + 1024 so that the base can be aligned to a swizzle atom: 230,656 bytes.
constexpr int kSmem = kBarOff + kBarBytes + 1024;
static_assert(kSmem <= 232448, "227 KB a block");
static_assert(2 * (kSA + kSR + kSB) * 8 <= kBarBytes, "barriers");

// The epilogue's operands; O = int is K22's raw form (the int32 sums as
// they stand: ax, wscale, bias and residual null).
template <typename O>
struct Ep {
  const float* ax;
  const float* wscale;
  const O* bias;      // (N,) or null
  const O* residual;  // (M, N) or null
  O* out;             // (M, N)
  int m, n;
  bool vec;  // N even and out 8-byte aligned: a pair is one store
};

// Two neighbouring elements of an O row from fp32.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A block's range [t0, t1) of the column-major tile walk.
struct Walk {
  int t0, t1, tiles_m, nk;
  bool resident;  // the panel fits the slots: transposed once per panel
  // Whether tile t needs its panel loaded, and whether it releases it.
  __device__ bool load_b(int t) const {
    return !resident || t == t0 || t / tiles_m != (t - 1) / tiles_m;
  }
  __device__ bool release_b(int t) const {
    return !resident || t + 1 == t1 || (t + 1) / tiles_m != t / tiles_m;
  }
};

// One consumer warpgroup's rows of the tile at (m0, n0): value 4j + i of a
// thread is row 16 * warp + lane / 4 + 8 * (i / 2), column 8j +
// 2 * (lane % 4) + i % 2. In two halves of the columns, every operand a
// half reads (scales, bias, residual) is loaded before its first store:
// out aliases none of them, but the compiler cannot know, and a load
// after a store waits for it (a form loading per 8 columns took 14% more
// at the QKV on an H100, PERF.md).
template <typename O, bool GELU, bool RES>
__device__ __forceinline__ void epilogue(const int (&d)[64], const Ep<O>& ep,
                                         int m0, int n0) {
  constexpr int J = kBN / 16;  // 8-column groups a half
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = m0 + 16 * warp + lane / 4;
  float ax[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    ax[h] = r0 + 8 * h < ep.m ? __ldg(ep.ax + r0 + 8 * h) : 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c0 = n0 + 8 * J * half + 2 * (lane % 4);
    float ws[2 * J], bs[2 * J], rs[2][2 * J] = {};
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        ws[2 * j + e] = c < ep.n ? __ldg(ep.wscale + c) : 0.f;
        bs[2 * j + e] = ep.bias && c < ep.n ? to_f32(ep.bias[c]) : 0.f;
#pragma unroll
        for (int h = 0; h < 2 && RES; ++h) {
          const int r = r0 + 8 * h;
          rs[h][2 * j + e] =
              r < ep.m && c < ep.n
                  ? to_f32(ep.residual[static_cast<size_t>(r) * ep.n + c])
                  : 0.f;
        }
      }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = c0 + 8 * j;
      if (c >= ep.n) continue;
      const bool two = c + 1 < ep.n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= ep.m) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = dequant(d[4 * (J * half + j) + 2 * h + e], ax[h],
                         ws[2 * j + e]);
          if (ep.bias) v[e] = __fadd_rn(v[e], bs[2 * j + e]);
          if constexpr (GELU) v[e] = gelu(v[e]);
          if constexpr (RES) v[e] = __fadd_rn(v[e], rs[h][2 * j + e]);
        }
        O* o = ep.out + static_cast<size_t>(r) * ep.n + c;
        if (ep.vec && two) {
          store2(o, v[0], v[1]);
        } else {
          o[0] = from_f32<O>(v[0]);
          if (two) o[1] = from_f32<O>(v[1]);
        }
      }
    }
  }
}

// K22's int8 dot (Ep<int>: no scales, bias or residual): one consumer
// warpgroup's rows of the tile at (m0, n0), the int32 sums stored as they
// stand, a pair at a time.
__device__ __forceinline__ void raw_epilogue(const int (&d)[64],
                                             const Ep<int>& ep, int m0,
                                             int n0) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + 16 * warp + lane / 4 + 8 * h;
      if (r >= ep.m || c >= ep.n) continue;
      int* o = ep.out + static_cast<size_t>(r) * ep.n + c;
      if (ep.vec && c + 1 < ep.n) {
        *reinterpret_cast<int2*>(o) = make_int2(d[4 * j + 2 * h],
                                                d[4 * j + 2 * h + 1]);
      } else {
        o[0] = d[4 * j + 2 * h];
        if (c + 1 < ep.n) o[1] = d[4 * j + 2 * h + 1];
      }
    }
  }
}

// GELU and the residual are template parameters: the epilogue is unrolled
// over the tile's 64 values a thread, and an erf GELU and residual loads
// inlined beside each store, where the QKV needs neither, made its kernel
// measurably slower on an H100.
template <typename O, bool GELU, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_i8_wgmma(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w, Ep<O> ep,
                    int k) {
  extern __shared__ uint8_t mi_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(mi_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t afull = base + kBarOff, aempty = afull + 8 * kSA;
  const uint32_t rfull = aempty + 8 * kSA, rempty = rfull + 8 * kSR;
  const uint32_t bfull = rempty + 8 * kSR, bempty = bfull + 8 * kSB;
  const int tiles_m = (ep.m + kBM - 1) / kBM;
  const long long tiles =
      static_cast<long long>(tiles_m) * ((ep.n + kBN - 1) / kBN);
  const int nk = (k + kBK - 1) / kBK;
  const Walk wk{static_cast<int>(tiles * blockIdx.x / gridDim.x),
                static_cast<int>(tiles * (blockIdx.x + 1) / gridDim.x),
                tiles_m, nk, nk <= kSB};

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSA; ++s) {
      mbar_init(afull + 8 * s, 1);   // the producer's arrive + the bytes
      mbar_init(aempty + 8 * s, 2);  // one arrive a consumer warpgroup
    }
    for (int s = 0; s < kSR; ++s) {
      mbar_init(rfull + 8 * s, 1);
      mbar_init(rempty + 8 * s, kTransposers);
    }
    for (int s = 0; s < kSB; ++s) {
      mbar_init(bfull + 8 * s, kTransposers);
      mbar_init(bempty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kTmaThread) {
      int sa = 0, sr = 0;
      uint32_t pa = 0, pr = 0;
      for (int t = wk.t0; t < wk.t1; ++t) {
        const int m0 = (t % tiles_m) * kBM, n0 = (t / tiles_m) * kBN;
        const bool lb = wk.load_b(t);
        for (int kb = 0; kb < nk; ++kb) {
          if (lb) {
            mbar_wait(rempty + 8 * sr, pr ^ 1);
            mbar_expect_tx(rfull + 8 * sr, kBox);
            tma_load(base + kROff + sr * kBox, &map_w, rfull + 8 * sr, n0,
                     kb * kBK);
            if (++sr == kSR) {
              sr = 0;
              pr ^= 1;
            }
          }
          mbar_wait(aempty + 8 * sa, pa ^ 1);
          mbar_expect_tx(afull + 8 * sa, kBox);
          tma_load(base + sa * kBox, &map_x, afull + 8 * sa, kb * kBK, m0);
          if (++sa == kSA) {
            sa = 0;
            pa ^= 1;
          }
        }
      }
    } else if (threadIdx.x >= kTransposer0) {
      const int tt = threadIdx.x - kTransposer0;
      int sr = 0, sb = 0;
      uint32_t pr = 0, pb = 0;
      for (int t = wk.t0; t < wk.t1; ++t) {
        if (!wk.load_b(t)) continue;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(rfull + 8 * sr, pr);
          mbar_wait(bempty + 8 * sb, pb ^ 1);
          transpose_box(base + kROff + sr * kBox, base + kBOff + sb * kBox,
                        tt);
          // wgmma reads the slot through the async proxy.
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(bfull + 8 * sb);
          mbar_arrive(rempty + 8 * sr);
          if (++sr == kSR) {
            sr = 0;
            pr ^= 1;
          }
          if (++sb == kSB) {
            sb = 0;
            pb ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    int d[64];
    int sa = 0, bc = 0, bbase = 0;
    uint32_t pa = 0;
    const bool leader = threadIdx.x % 128 == 0;
    for (int t = wk.t0; t < wk.t1; ++t) {
      const int m0 = (t % tiles_m) * kBM, n0 = (t / tiles_m) * kBN;
      if (wk.load_b(t)) {
        bbase = bc;
        bc += nk;
      }
      const bool rel = wk.release_b(t);
      int prev_a = -1, prev_b = -1;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(afull + 8 * sa, pa);
        // A kept panel's slot has completed its phase and stays there
        // until released, so this wait returns at once for later tiles.
        const int c = bbase + kb, sb = c % kSB;
        mbar_wait(bfull + 8 * sb, (c / kSB) & 1);
        const uint32_t xa = base + sa * kBox + wgi * kHalf;
        const uint32_t wb = base + kBOff + sb * kBox;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk)
          wgmma_s8<128>(d, kmajor_desc(xa + kk * 32),
                        kmajor_desc(wb + kk * 32), kb | kk);
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done
        fence_acc(d);
        if (prev_a >= 0 && leader) {
          mbar_arrive(aempty + 8 * prev_a);
          if (rel) mbar_arrive(bempty + 8 * prev_b);
        }
        prev_a = sa;
        prev_b = sb;
        if (++sa == kSA) {
          sa = 0;
          pa ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (leader) {
        mbar_arrive(aempty + 8 * prev_a);
        if (rel) mbar_arrive(bempty + 8 * prev_b);
      }
      if constexpr (std::is_same<O, int>::value)
        raw_epilogue(d, ep, m0 + 64 * wgi, n0);
      else
        epilogue<O, GELU, RES>(d, ep, m0 + 64 * wgi, n0);
    }
  }
}

constexpr int kMaxDevices = 64;

template <typename O, bool GELU, bool RES>
cudaError_t launch(const void* xq, const float* ax, const void* wq,
                   const float* wscale, const void* bias, const void* residual,
                   void* out, int m, int n, int k, int device,
                   cudaStream_t st) {
  auto kernel = matmul_i8_wgmma<O, GELU, RES>;
  static int sm_count[kMaxDevices];  // 0 until the device's first launch
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int& sms = sm_count[device];
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    // Fewer registers than the setmaxnreg split needs: refuse the launch.
    if (attr.numRegs * kThreads < kPoolRegs)
      return cudaErrorLaunchOutOfResources;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    sms = count;
  }
  CUtensorMap mx, mw;
  // xq (m, k) in boxes of 128 K bytes x 128 rows; wq (k, n) in raw boxes of
  // 128 N bytes x 128 K rows.
  if (!tensor_map_i8(&mx, xq, m, k, k, kBK, kBM) ||
      !tensor_map_i8(&mw, wq, k, n, n, kBN, kBK))
    return cudaErrorInvalidValue;
  auto a8 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 8 == 0;
  };
  const Ep<O> ep{ax, wscale, static_cast<const O*>(bias),
                 static_cast<const O*>(residual), static_cast<O*>(out), m, n,
                 n % 2 == 0 && a8(out)};
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) *
                          ((n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmem, st>>>(mx, mw, ep, k);
  return cudaGetLastError();
}

}  // namespace mi

// K22's int8 dot on this tile (dot_probe.cu, where TMA reads both
// operands: i8_path's rule): xq (m, k) @ wq (k, n) int8, the int32 sums
// into out (m, n) as they stand -- K11's walk with Ep<int>'s raw epilogue.
cudaError_t launch_i8_raw(const void* xq, const void* wq, int* out, int m,
                          int n, int k, int device, cudaStream_t st) {
  return mi::launch<int, false, false>(xq, nullptr, wq, nullptr, nullptr,
                                       nullptr, out, m, n, k, device, st);
}

}  // namespace vit

// K11 on the wgmma tile: the arguments of vit_matmul_i8 (matmul.cu), which
// runs gemm_tile.cuh's int8 tile; the wrapper (ops/cuda/quant.py:i8_path)
// picks one of the two by shape. xq and wq 16-byte aligned, k and n
// multiples of 16.
extern "C" int vit_matmul_i8_wgmma(const void* xq, const void* ax,
                                   const void* wq, const void* wscale,
                                   const void* bias, const void* residual,
                                   void* out, int m, int n, int k,
                                   int gelu_act, int dtype, int device,
                                   void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16 ||
      reinterpret_cast<uintptr_t>(wq) % 16)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<const float*>(ax);
  auto* s = static_cast<const float*>(wscale);
  // The epilogues the main paths run: bias (+ GELU), bias + residual.
#define VIT_K11(O)                                                         \
  return gelu_act                                                          \
             ? (residual ? mi::launch<O, true, true>(xq, a, wq, s, bias,   \
                                                     residual, out, m, n,  \
                                                     k, device, st)        \
                         : mi::launch<O, true, false>(xq, a, wq, s, bias,  \
                                                      residual, out, m, n, \
                                                      k, device, st))      \
             : (residual ? mi::launch<O, false, true>(xq, a, wq, s, bias,  \
                                                      residual, out, m, n, \
                                                      k, device, st)       \
                         : mi::launch<O, false, false>(xq, a, wq, s, bias, \
                                                       residual, out, m,   \
                                                       n, k, device, st));
  if (dtype == kF32) VIT_K11(float)
  if (dtype == kBF16) VIT_K11(bf16)
#undef VIT_K11
  return cudaErrorInvalidValue;
}
