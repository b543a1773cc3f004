// K13: the flash-attention backward. For (B, H, S, d) q, k, v and the
// output gradient g, with keys >= seq_len masked:
//   p  = exp(s - rowmax) / rowsum   from the fp32 scores s = (q k^T) * scale
//   dv = (p in T)^T g               dp = g v^T (fp32)
//   ds = p * (dp - rowsum(dp * p))
//   dq = ((ds in T) k) * scale      dk = ((ds in T)^T q) * scale
// each product summed in fp32 and cast once to T, written into one packed
// (B*S, 3D) buffer [dq | dk | dv] through output strides, so that it is the
// QKV projection's gradient as it stands.
//
// Replaces vit_tpu/ops/pallas/vjp.py:_attention_bwd (pallas_call at :406,
// kernel _flash_bwd_group_kernel :308) with its rounding points: p and ds
// rounded to T only for their products, and delta = rowsum(dp * p), not
// FlashAttention-2's rowsum(dO * O), which differs in bf16.
//
// Design: JAX runs a whole head per grid step with the (S, S) fp32 p in
// VMEM; at 208 tokens that is 173 KB besides q, k, v and g, over an SM's
// 227 KB. So the work is tiled in 64-row tiles, FlashAttention-2's split,
// in two launches, deterministic and without atomics:
//  (a) query-major, grid (B*H, ceil(S/64)): a block keeps its query tile
//      and g rows, and streams the key tiles three times: for the row max
//      and sum (K7's online softmax, flash_tiles.cuh:softmax_row), for
//      delta = rowsum(dp * p), and for ds and dq. It writes dq and the rows'
//      m, l and delta to a (3, B*H, S) fp32 scratch.
//  (b) key-major, grid (B*H, ceil(S/64)): a block keeps its key and value
//      tile and streams every query tile with its g rows and stats,
//      recomputes p, accumulates dv += (p in T)^T g and dk += (ds in T)^T q.
//      Key tiles at or past seq_len hold only masked keys: zero dk and dv.
// Shared memory does not grow with S. bf16 products run on nvcuda::wmma
// 16x16x16 with fp32 sums (four warps of 16 rows); fp32 products on FFMA in
// full fp32 (no TF32: the Pallas dots run at HIGHEST), 256 threads with a
// 4 x N/16 register block each. Accumulators live in shared memory. Not
// pipelined (no cp.async, TMA or wgmma): that is later work.
//
// Bound on the card: 10*B*H*S*seq_len*d operations (JAX's cost estimate,
// vjp.py:414-417, over the real keys), the four inputs read and three
// outputs written once (7*B*H*S*d elements). At B/16 bs=32 (384 heads, 197
// of 208 tokens, d=64) it is bytes-bound in bf16 (71.6 MB, 21.4 us at
// 3.35 TB/s; the 1.0e10 operations take 10.2 us) and operations-bound in
// fp32 (150.3 us at 67 TFLOP/s). This kernel does 10 products of 64x64xd
// per tile pair (three score passes and two dp passes in (a)), twice the
// minimum.
//
// head_dim: any multiple of 16 up to 128. Query rows past S are loaded as
// zeros and not stored.

#include <math.h>
#include <mma.h>

#include "flash_tiles.cuh"

namespace vit {

using namespace nvcuda;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  void* dq;
  void* dk;
  void* dv;
  FaStrides sq, sk, sv, sg, sdq, sdk, sdv;
  float* stats;  // (3, B*H, S): m, l, delta of each query row
  int bh, heads, s, seq_len;
  float scale;
  bool vec;  // bf16 rows of q, k, v and g may be copied in 16-byte chunks
};

// Tile layout by type: row strides (in elements) of the q/k/v/g tiles
// (HD + kPadX), the fp32 score and dp tiles (kLds), the p and ds tiles
// (kLdp) and the fp32 accumulators (HD + kPadA).
template <typename T>
struct BwdTile;

template <>
struct BwdTile<bf16> {
  static constexpr int kThreads = 128;     // four warps, 16 rows each
  static constexpr int kPadX = 8;          // 16-byte rows, shifted banks
  static constexpr int kLds = kFaBK + 4;   // wmma: fp32 ldm a multiple of 4
  static constexpr int kLdp = kFaBK + 8;   // wmma: bf16 ldm a multiple of 8
  static constexpr int kPadA = 4;
  static constexpr bool kOwnP = true;      // p, ds rounded into own tiles
};

template <>
struct BwdTile<float> {
  static constexpr int kThreads = 256;
  static constexpr int kPadX = 1;  // odd strides: conflict-free column reads
  static constexpr int kLds = kFaBK + 1;
  static constexpr int kLdp = kFaBK + 1;
  static constexpr int kPadA = 1;
  static constexpr bool kOwnP = false;  // p, ds overwrite the scores and dp
};

template <int HD, typename T>
constexpr size_t bwd_smem(bool dkv) {
  using L = BwdTile<T>;
  const int acc = dkv ? 2 : 1;
  return 4 * kFaBQ * (HD + L::kPadX) * sizeof(T)             // q, g, k, v
         + 2 * kFaBQ * L::kLds * sizeof(float)                // scores, dp
         + (L::kOwnP ? acc * kFaBQ * L::kLdp * sizeof(T) : 0)  // [p,] ds
         + acc * kFaBQ * (HD + L::kPadA) * sizeof(float)      // accumulators
         + 3 * kFaBQ * sizeof(float);                         // m, l, delta
}

static_assert(bwd_smem<kFaMaxHd, float>(true) <= 232448,
              "K13 (b) in fp32 at head_dim 128 must fit one block");

template <bool COL>
struct WmmaLayout {
  using type = wmma::row_major;
};
template <>
struct WmmaLayout<true> {
  using type = wmma::col_major;
};

// C (64 x N, fp32, row stride ldc) = [C +] A (64 x K) B (K x N) with every
// operand in shared memory: A(r, k) at A[r * lda + k], or at A[k * lda + r]
// with ACOL; B(k, n) at B[k * ldb + n], or at B[n * ldb + k] with BCOL.
// bf16: each of the four warps computes 16 rows on wmma.
template <int N, int K, bool ACOL, bool BCOL>
__device__ __forceinline__ void tile_mm(const bf16* A, int lda, const bf16* B,
                                        int ldb, float* C, int ldc,
                                        bool accumulate) {
  const int r0 = (threadIdx.x / 32) * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[N / 16];
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    if (accumulate)
      wmma::load_matrix_sync(c[j], C + r0 * ldc + j * 16, ldc,
                             wmma::mem_row_major);
    else
      wmma::fill_fragment(c[j], 0.f);
  }
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                   typename WmmaLayout<ACOL>::type> a;
    wmma::load_matrix_sync(a, ACOL ? A + kk * lda + r0 : A + r0 * lda + kk,
                           lda);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                     typename WmmaLayout<BCOL>::type> b;
      wmma::load_matrix_sync(
          b, BCOL ? B + j * 16 * ldb + kk : B + kk * ldb + j * 16, ldb);
      wmma::mma_sync(c[j], a, b, c[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
    wmma::store_matrix_sync(C + r0 * ldc + j * 16, c[j], ldc,
                            wmma::mem_row_major);
}

// fp32: each of 256 threads computes rows ty + 16i (i < 4) and columns
// tx + 16j (j < N/16) in registers, on FFMA.
template <int N, int K, bool ACOL, bool BCOL>
__device__ __forceinline__ void tile_mm(const float* A, int lda,
                                        const float* B, int ldb, float* C,
                                        int ldc, bool accumulate) {
  constexpr int NJ = N / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float c[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      c[i][j] = accumulate ? C[(ty + 16 * i) * ldc + tx + 16 * j] : 0.f;
  for (int k = 0; k < K; ++k) {
    float a[4], b[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = ACOL ? A[k * lda + ty + 16 * i] : A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = BCOL ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      C[(ty + 16 * i) * ldc + tx + 16 * j] = c[i][j];
}

template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, int ldd, const bf16* src,
                                          long long ld, int r0, int s,
                                          bool vec) {
  load_rows_bf16<HD>(dst, ldd, src, ld, r0, s, vec);
}

// Rows [r0, r0 + 64) of a (S, HD) fp32 matrix, rows at or past s zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ldd,
                                          const float* src, long long ld,
                                          int r0, int s, bool) {
  for (int e = threadIdx.x; e < kFaBQ * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD;
    dst[r * ldd + c] = r0 + r < s ? src[(r0 + r) * ld + c] : 0.f;
  }
}

// p of one score: exp(s * scale - m) / l, 0 where the key is masked (or
// the query row is past S). The product is rounded before the subtraction,
// as in JAX (s = dot * scale, then s - max).
__device__ __forceinline__ float prob(float raw, bool keep, float scale,
                                      float m, float l) {
  return keep ? expf(__fmul_rn(raw, scale) - m) / l : 0.f;
}

// The shared-memory tiles of one block, carved in bwd_smem's order.
template <int HD, typename T>
struct BwdSmem {
  using L = BwdTile<T>;
  static constexpr int LDX = HD + L::kPadX, LDA = HD + L::kPadA;
  T *x0, *x1, *x2, *x3;  // (a): q, g, k, v; (b): k, v, q, g
  float *ss, *dps;
  T *pt, *dst;  // p and ds in T (the fp32 tiles themselves in fp32)
  int ldp;
  float *acc0, *acc1, *ms, *ls, *dls;

  __device__ BwdSmem(unsigned char* base, bool dkv) {
    x0 = reinterpret_cast<T*>(base);
    x1 = x0 + kFaBQ * LDX;
    x2 = x1 + kFaBQ * LDX;
    x3 = x2 + kFaBQ * LDX;
    ss = reinterpret_cast<float*>(x3 + kFaBQ * LDX);
    dps = ss + kFaBQ * L::kLds;
    float* rest = dps + kFaBQ * L::kLds;
    if constexpr (L::kOwnP) {
      dst = reinterpret_cast<T*>(rest);
      pt = dkv ? dst + kFaBQ * L::kLdp : nullptr;
      rest = reinterpret_cast<float*>(dst + (dkv ? 2 : 1) * kFaBQ * L::kLdp);
      ldp = L::kLdp;
    } else {
      pt = reinterpret_cast<T*>(ss);
      dst = reinterpret_cast<T*>(dps);
      ldp = L::kLds;
    }
    acc0 = rest;
    acc1 = dkv ? acc0 + kFaBQ * LDA : nullptr;
    ms = acc0 + (dkv ? 2 : 1) * kFaBQ * LDA;
    ls = ms + kFaBQ;
    dls = ls + kFaBQ;
  }
};

// ------------------------------------------------------ (a) query-major --

template <int HD, typename T>
__global__ void __launch_bounds__(BwdTile<T>::kThreads)
    fa_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Sm = BwdSmem<HD, T>;
  constexpr int LDX = Sm::LDX, LDA = Sm::LDA, LDS = BwdTile<T>::kLds;
  Sm sm(smem, false);
  T *qs = sm.x0, *gs = sm.x1, *ks = sm.x2, *vs = sm.x3;
  float* dqa = sm.acc0;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int nw = blockDim.x / 32;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * kFaBQ;
  const T* qg = head_ptr<T>(a.q, a.sq, b, h);
  const T* kg = head_ptr<T>(a.k, a.sk, b, h);
  const T* vg = head_ptr<T>(a.v, a.sv, b, h);
  const T* gg = head_ptr<T>(a.g, a.sg, b, h);

  load_tile<HD>(qs, LDX, qg, a.sq.s, q0, a.s, a.vec);
  load_tile<HD>(gs, LDX, gg, a.sg.s, q0, a.s, a.vec);
  for (int e = t; e < kFaBQ * LDA; e += blockDim.x) dqa[e] = 0.f;
  if (t < kFaBQ) {
    sm.ms[t] = -INFINITY;
    sm.ls[t] = 0.f;
    sm.dls[t] = 0.f;
  }
  const int n_tiles = (a.seq_len + kFaBK - 1) / kFaBK;

  // Pass 1: the row max m and sum l, K7's online recurrence.
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kFaBK;
    __syncthreads();
    load_tile<HD>(ks, LDX, kg, a.sk.s, k0, a.s, a.vec);
    __syncthreads();
    tile_mm<kFaBK, HD, false, true>(qs, LDX, ks, LDX, sm.ss, LDS, false);
    __syncthreads();
    for (int r = warp; r < kFaBQ; r += nw)
      softmax_row<float>(sm.ss + r * LDS, sm.ss + r * LDS, k0, a.seq_len,
                         a.scale, sm.ms + r, sm.ls + r, lane);
  }

  // Pass 2: delta = rowsum(dp * p). Pass 3: ds, and dq += (ds in T) k.
  for (int pass = 2; pass <= 3; ++pass) {
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kFaBK;
      __syncthreads();
      load_tile<HD>(ks, LDX, kg, a.sk.s, k0, a.s, a.vec);
      load_tile<HD>(vs, LDX, vg, a.sv.s, k0, a.s, a.vec);
      __syncthreads();
      tile_mm<kFaBK, HD, false, true>(qs, LDX, ks, LDX, sm.ss, LDS, false);
      tile_mm<kFaBK, HD, false, true>(gs, LDX, vs, LDX, sm.dps, LDS, false);
      __syncthreads();
      for (int r = warp; r < kFaBQ; r += nw) {
        const float m = sm.ms[r], l = sm.ls[r];
        const float* srow = sm.ss + r * LDS;
        const float* drow = sm.dps + r * LDS;
        if (pass == 2) {
          float acc = 0.f;
          for (int c = lane; c < kFaBK; c += 32)
            acc += drow[c] *
                   prob(srow[c], k0 + c < a.seq_len, a.scale, m, l);
          acc = warp_sum(acc);
          if (lane == 0) sm.dls[r] += acc;
        } else {
          const float dl = sm.dls[r];
          for (int c = lane; c < kFaBK; c += 32) {
            const float p = prob(srow[c], k0 + c < a.seq_len, a.scale, m, l);
            sm.dst[r * sm.ldp + c] = from_f32<T>(p * (drow[c] - dl));
          }
        }
      }
      if (pass == 3) {
        __syncthreads();
        tile_mm<HD, kFaBK, false, false>(sm.dst, sm.ldp, ks, LDX, dqa, LDA,
                                         true);
      }
    }
  }
  __syncthreads();

  T* dqg = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  for (int e = t; e < kFaBQ * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD, row = q0 + r;
    if (row < a.s)
      dqg[row * a.sdq.s + c] = from_f32<T>(dqa[r * LDA + c] * a.scale);
  }
  if (t < kFaBQ && q0 + t < a.s) {
    const long long at = static_cast<long long>(bh) * a.s + q0 + t;
    const long long plane = static_cast<long long>(a.bh) * a.s;
    a.stats[at] = sm.ms[t];
    a.stats[plane + at] = sm.ls[t];
    a.stats[2 * plane + at] = sm.dls[t];
  }
}

// -------------------------------------------------------- (b) key-major --

template <int HD, typename T>
__global__ void __launch_bounds__(BwdTile<T>::kThreads)
    fa_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Sm = BwdSmem<HD, T>;
  constexpr int LDX = Sm::LDX, LDA = Sm::LDA, LDS = BwdTile<T>::kLds;
  Sm sm(smem, true);
  T *ks = sm.x0, *vs = sm.x1, *qs = sm.x2, *gs = sm.x3;
  float *dka = sm.acc0, *dva = sm.acc1;

  const int t = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.y * kFaBK;
  T* dkg = static_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  T* dvg = static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h;

  if (k0 >= a.seq_len) {  // only masked keys: p = 0, so dk = dv = 0
    for (int e = t; e < kFaBK * HD; e += blockDim.x) {
      const int r = e / HD, c = e % HD, row = k0 + r;
      if (row < a.s) {
        dkg[row * a.sdk.s + c] = from_f32<T>(0.f);
        dvg[row * a.sdv.s + c] = from_f32<T>(0.f);
      }
    }
    return;
  }
  const T* qg = head_ptr<T>(a.q, a.sq, b, h);
  const T* kg = head_ptr<T>(a.k, a.sk, b, h);
  const T* vg = head_ptr<T>(a.v, a.sv, b, h);
  const T* gg = head_ptr<T>(a.g, a.sg, b, h);
  load_tile<HD>(ks, LDX, kg, a.sk.s, k0, a.s, a.vec);
  load_tile<HD>(vs, LDX, vg, a.sv.s, k0, a.s, a.vec);
  for (int e = t; e < kFaBK * LDA; e += blockDim.x) dka[e] = dva[e] = 0.f;
  const long long plane = static_cast<long long>(a.bh) * a.s;
  const float* st = a.stats + static_cast<long long>(bh) * a.s;

  for (int q0 = 0; q0 < a.s; q0 += kFaBQ) {
    __syncthreads();
    load_tile<HD>(qs, LDX, qg, a.sq.s, q0, a.s, a.vec);
    load_tile<HD>(gs, LDX, gg, a.sg.s, q0, a.s, a.vec);
    if (t < kFaBQ) {
      const bool in = q0 + t < a.s;
      sm.ms[t] = in ? st[q0 + t] : 0.f;
      sm.ls[t] = in ? st[plane + q0 + t] : 1.f;
      sm.dls[t] = in ? st[2 * plane + q0 + t] : 0.f;
    }
    __syncthreads();
    tile_mm<kFaBK, HD, false, true>(qs, LDX, ks, LDX, sm.ss, LDS, false);
    tile_mm<kFaBK, HD, false, true>(gs, LDX, vs, LDX, sm.dps, LDS, false);
    __syncthreads();
    for (int e = t; e < kFaBQ * kFaBK; e += blockDim.x) {
      const int r = e / kFaBK, c = e % kFaBK;
      const float p = prob(sm.ss[r * LDS + c],
                           q0 + r < a.s && k0 + c < a.seq_len, a.scale,
                           sm.ms[r], sm.ls[r]);
      const float ds = p * (sm.dps[r * LDS + c] - sm.dls[r]);
      sm.pt[r * sm.ldp + c] = from_f32<T>(p);
      sm.dst[r * sm.ldp + c] = from_f32<T>(ds);
    }
    __syncthreads();
    tile_mm<HD, kFaBQ, true, false>(sm.pt, sm.ldp, gs, LDX, dva, LDA, true);
    tile_mm<HD, kFaBQ, true, false>(sm.dst, sm.ldp, qs, LDX, dka, LDA, true);
  }
  __syncthreads();

  for (int e = t; e < kFaBK * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD, row = k0 + r;
    if (row < a.s) {
      dkg[row * a.sdk.s + c] = from_f32<T>(dka[r * LDA + c] * a.scale);
      dvg[row * a.sdv.s + c] = from_f32<T>(dva[r * LDA + c]);
    }
  }
}

// ---------------------------------------------------------------- launch --

template <typename K>
cudaError_t launch_bwd_kernel(K kernel, size_t smem, int threads, dim3 grid,
                              const BwdArgs& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const int threads = BwdTile<T>::kThreads;
  const dim3 grid(a.bh, (a.s + kFaBQ - 1) / kFaBQ);
  cudaError_t err = launch_bwd_kernel(fa_bwd_dq_kernel<HD, T>,
                                      bwd_smem<HD, T>(false), threads, grid,
                                      a, st);
  if (err != cudaSuccess) return err;
  return launch_bwd_kernel(fa_bwd_dkv_kernel<HD, T>, bwd_smem<HD, T>(true),
                           threads, grid, a, st);
}

template <int HD>
cudaError_t launch_bwd_dtype(const BwdArgs& a, int dtype, cudaStream_t st) {
  return dtype == kF32 ? launch_bwd<HD, float>(a, st)
                       : launch_bwd<HD, bf16>(a, st);
}

}  // namespace vit

extern "C" int vit_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g, void* dq,
    void* dk, void* dv, long long sq_b, long long sq_h, long long sq_s,
    long long sk_b, long long sk_h, long long sk_s, long long sv_b,
    long long sv_h, long long sv_s, long long sg_b, long long sg_h,
    long long sg_s, long long sdq_b, long long sdq_h, long long sdq_s,
    long long sdk_b, long long sdk_h, long long sdk_s, long long sdv_b,
    long long sdv_h, long long sdv_s, void* stats, int batch, int heads,
    int s, int hd, int seq_len, float scale, int dtype, int device,
    void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || heads <= 0 || s <= 0 || seq_len <= 0 || seq_len > s ||
      hd <= 0 || hd % 16 || hd > kFaMaxHd || (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  BwdArgs a{q, k, v, g, dq, dk, dv,
            {sq_b, sq_h, sq_s}, {sk_b, sk_h, sk_s}, {sv_b, sv_h, sv_s},
            {sg_b, sg_h, sg_s}, {sdq_b, sdq_h, sdq_s}, {sdk_b, sdk_h, sdk_s},
            {sdv_b, sdv_h, sdv_s}, static_cast<float*>(stats),
            batch * heads, heads, s, seq_len, scale, false};
  a.vec = dtype == kBF16 && aligned16_ptr(q) && aligned16_ptr(k) &&
          aligned16_ptr(v) && aligned16_ptr(g) && aligned16_strides(a.sq, 2) &&
          aligned16_strides(a.sk, 2) && aligned16_strides(a.sv, 2) &&
          aligned16_strides(a.sg, 2);
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd / 16) {
    case 1: return launch_bwd_dtype<16>(a, dtype, st);
    case 2: return launch_bwd_dtype<32>(a, dtype, st);
    case 3: return launch_bwd_dtype<48>(a, dtype, st);
    case 4: return launch_bwd_dtype<64>(a, dtype, st);
    case 5: return launch_bwd_dtype<80>(a, dtype, st);
    case 6: return launch_bwd_dtype<96>(a, dtype, st);
    case 7: return launch_bwd_dtype<112>(a, dtype, st);
    case 8: return launch_bwd_dtype<128>(a, dtype, st);
    default: return cudaErrorInvalidValue;
  }
}
