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
// FlashAttention-2's rowsum(dO * O) over the stored output, which differs
// in bf16.
//
// Design: JAX runs a whole head per grid step with the (S, S) fp32 p in
// VMEM; at 208 tokens that is 173 KB besides q, k, v and g, over an SM's
// 227 KB. So the work is tiled in 64-row tiles, FlashAttention-2's split,
// in two launches, deterministic and without atomics, grid (B*H,
// ceil(S/64)) each; shared memory does not grow with S.
//
// bf16, on mma.sync (mma_frag.cuh), four warps of 16 rows, tiles staged
// with cp.async and the streamed tiles double-buffered, every accumulator
// in registers:
//  (a) query-major: a block keeps its query tile and g rows and streams
//      the key tiles twice. Pass 1 runs m and l online and accumulates
//      o = sum exp(s - m) v in fp32, rescaled by each new max, with p split
//      into two bf16 parts (hi + lo) so that o carries p unrounded; then
//      delta = g . o / l, which is JAX's rowsum(dp * p) in exact arithmetic
//      (dp = g v^T). Pass 2 forms p, dp = g v^T, ds and dq += (ds in bf16) k,
//      ds packed where its C fragment left it. It writes dq and the rows'
//      m, l and delta to a (3, B*H, S) fp32 scratch.
//  (b) key-major: a block keeps its key and value tile and streams every
//      query tile with its g rows and stats, computes s^T = k q^T and
//      dp^T = v g^T directly, so that p^T and ds^T come out as C
//      fragments and go in as the A operands of dv += (p in bf16)^T g and
//      dk += (ds in bf16)^T q, g and q through ldmatrix.trans. Key tiles at
//      or past seq_len hold only masked keys: zero dk and dv.
// Per tile pair that is 9 products of 64 x 64 x d (10 with pass 1's lo
// part), every accumulator in registers. Launch (b) walks a query tile in
// two halves of 32, so that the scores and dp fit beside dk and dv (d/2
// fp32 registers a thread each): nvcc -Xptxas -v reports no spills at any
// d, 140 registers at d=64 (three blocks an SM) and 250 at d=128, so both
// accumulators stay in registers there too.
//
// fp32: the same two launches, 64-row tiles, walks and delta, each product
// in three TF32 passes of the split (tf32_split.cuh: x = hi + lo, lo_a
// hi_b + hi_a lo_b + hi_a hi_b), JAX's HIGHEST counterpart, every
// accumulator in registers. At head widths 32 and 64 (B/16's, L/16's) on
// wgmma m64nNk8 tf32, two warpgroups a block, the streamed tiles split once
// a block into K-major operands; at the other widths on mma.sync m16n8k8
// tf32, four warps, operands split as their fragments load (both in
// flash_attention_bwd_tf32.cu, a unit of their own). Measured on the card
// (tools/tf32_probe.py), one accumulator over these products' K of 64-208
// stays within 6.1e-5 of plain fp32 at scores near 51 and 2.2e-5 at the
// outputs' products: no promotion is needed here.
//
// Bound on the card: 10*B*H*S*seq_len*d operations (JAX's cost estimate,
// vjp.py:414-417, over the real keys), the four inputs read and three
// outputs written once (7*B*H*S*d elements). At B/16 bs=32 (384 heads, 197
// of 208 tokens, d=64) it is bytes-bound in bf16 (71.6 MB, 21.4 us at
// 3.35 TB/s; the 1.0e10 operations take 10.2 us at the bf16 peak) and
// operations-bound in fp32 (1.0e10 operations in three TF32 passes, 60.9
// us at 495 TFLOP/s; the 143 MB 42.8 us). The tiles are re-read from L2
// (each key tile once a query tile and pass), so the fragments'
// shared-memory traffic and the two launches' serial tails set the time,
// not device memory.
//
// head_dim: any multiple of 16 up to 128. Query rows past S are loaded as
// zeros and not stored.

#include <math.h>

#include <initializer_list>

#include "flash_bwd.cuh"
#include "flash_tiles.cuh"
#include "mma_frag.cuh"

namespace vit {

// =================================================== bf16 on mma.sync ==

constexpr int kBwdMmaThreads = 128;  // four warps, 16 rows each

// Shared memory of a bf16 launch: six 64-row tiles of HD + 8 columns (the
// 16-byte pad keeps ldmatrix conflict-free): (a) q, g and two buffers of
// [k | v]; (b) k, v and two buffers of [q | g], then two buffers of the
// query rows' m, l and delta.
template <int HD>
constexpr size_t bwd_mma_smem(bool dkv) {
  return 6 * kFaBQ * (HD + 8) * sizeof(bf16) +
         (dkv ? 2 * 3 * kFaBQ * sizeof(float) : 0);
}

// c (16 x N at columns n0 of b's rows) += a[r0 .. r0+15, 0 .. K) b^T for
// two row-major tiles of stride ld: the warp's rows of a against N rows of
// b (s = q k^T, dp = g v^T, and their transposes).
template <int K, int N>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4], const bf16* a,
                                        int r0, const bf16* b, int n0,
                                        int ld, int lane) {
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    uint32_t af[4];
    ldmatrix_a(af, a, ld, r0, k, lane);
#pragma unroll
    for (int n = 0; n < N; n += 16) {
      uint32_t bf[4];
      ldmatrix_b_kmajor(bf, b, ld, n0 + n, k, lane);
      mma_bf16(c[n / 8], af, bf[0], bf[1]);
      mma_bf16(c[n / 8 + 1], af, bf[2], bf[3]);
    }
  }
}

// The A fragment of two C tiles in bf16 (hi) and the bf16 rounding of what
// that rounding left (lo): hi + lo carries each value to about 2^-17.
__device__ __forceinline__ void pack_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c0)[4],
                                             const float (&c1)[4]) {
  float r0[4], r1[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    r0[e] = c0[e] - __bfloat162float(__float2bfloat16_rn(c0[e]));
    r1[e] = c1[e] - __bfloat162float(__float2bfloat16_rn(c1[e]));
  }
  pack_a(hi, c0, c1);
  pack_a(lo, r0, r1);
}

// ------------------------------------------------------ (a) query-major --

template <int HD>
__global__ void __launch_bounds__(kBwdMmaThreads)
    fa_bwd_dq_mma(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = HD + 8, TILE = kFaBQ * LD;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* gs = qs + TILE;
  bf16* kv = gs + TILE;  // two buffers of [k | v]

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = 16 * (threadIdx.x / 32);  // the warp's rows in the tile
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * kFaBQ;
  const bf16* kg = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* vg = head_ptr<bf16>(a.v, a.sv, b, h);
  const int n = (a.seq_len + kFaBK - 1) / kFaBK;
  const float scale = a.scale;

  // Step `it` of the stream: key tile it % n, pass 1 then pass 2; one
  // cp.async group a step, empty past the end.
  auto prefetch = [&](int it) {
    if (it < 2 * n) {
      bf16* buf = kv + 2 * TILE * (it & 1);
      stage_tile<HD>(buf, kg, a.sk.s, (it % n) * kFaBK, a.s, a.vec);
      stage_tile<HD>(buf + TILE, vg, a.sv.s, (it % n) * kFaBK, a.s, a.vec);
    }
    cp_async_commit();
  };
  stage_tile<HD>(qs, head_ptr<bf16>(a.q, a.sq, b, h), a.sq.s, q0, a.s,
                 a.vec);
  stage_tile<HD>(gs, head_ptr<bf16>(a.g, a.sg, b, h), a.sg.s, q0, a.s,
                 a.vec);
  prefetch(0);

  // Pass 1: m, l online and o = sum exp(s - m) v; the lane's rows are
  // r0 + lane/4 (r = 0) and r0 + lane/4 + 8 (r = 1).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int it = 0; it < n; ++it) {
    prefetch(it + 1);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = kv + 2 * TILE * (it & 1);
    const bf16* vs = ks + TILE;
    const int k0 = it * kFaBK;
    float sc[kFaBK / 8][4];
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    mma_abt<HD, kFaBK>(sc, qs, r0, ks, 0, LD, lane);
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool keep = k0 + 8 * j + 2 * t + (e & 1) < a.seq_len;
        sc[j][e] = keep ? __fmul_rn(sc[j][e], scale) : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
      }
    quad_reduce(mt, [](float x, float y) { return fmaxf(x, y); });
    // The first tile holds key 0, so mt is finite and alpha = 0 there.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = expf(m[r] - mt[r]);
      m[r] = mt[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - m[e >> 1]);
        l[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < kFaBK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      pack_a_split(hi, lo, sc[2 * kk], sc[2 * kk + 1]);
      mma_ab<HD>(o, hi, vs, 16 * kk, LD, lane);
      mma_ab<HD>(o, lo, vs, 16 * kk, LD, lane);
    }
    __syncthreads();
  }
  quad_reduce(l, [](float x, float y) { return x + y; });
  // delta = g . o / l over the lane's columns 8j + 2t, + 1.
  float dl[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + lane / 4 + 8 * (e >> 1);
      dl[e >> 1] += __bfloat162float(gs[row * LD + 8 * j + 2 * t + (e & 1)]) *
                    o[j][e];
    }
  quad_reduce(dl, [](float x, float y) { return x + y; });
  dl[0] /= l[0];
  dl[1] /= l[1];

  // Pass 2: p, dp = g v^T, ds = p (dp - delta), dq += (ds in bf16) k.
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int it = n; it < 2 * n; ++it) {
    prefetch(it + 1);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = kv + 2 * TILE * (it & 1);
    const bf16* vs = ks + TILE;
    const int k0 = (it - n) * kFaBK;
    float sc[kFaBK / 8][4], dp[kFaBK / 8][4];
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    mma_abt<HD, kFaBK>(sc, qs, r0, ks, 0, LD, lane);
    mma_abt<HD, kFaBK>(dp, gs, r0, vs, 0, LD, lane);
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            prob(sc[j][e], k0 + 8 * j + 2 * t + (e & 1) < a.seq_len, scale,
                 m[r], l[r]);
        sc[j][e] = p * (dp[j][e] - dl[r]);
      }
#pragma unroll
    for (int kk = 0; kk < kFaBK / 16; ++kk) {
      uint32_t ds[4];
      pack_a(ds, sc[2 * kk], sc[2 * kk + 1]);
      mma_ab<HD>(dq, ds, ks, 16 * kk, LD, lane);
    }
    __syncthreads();
  }

  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  const long long plane = static_cast<long long>(a.bh) * a.s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + lane / 4 + 8 * r;
    if (row >= a.s) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqg + row * a.sdq.s + 8 * j +
                                         2 * t) =
          __floats2bfloat162_rn(dq[j][2 * r] * scale,
                                dq[j][2 * r + 1] * scale);
    if (t == 0) {
      const long long at = static_cast<long long>(bh) * a.s + row;
      a.stats[at] = m[r];
      a.stats[plane + at] = l[r];
      a.stats[2 * plane + at] = dl[r];
    }
  }
}

// -------------------------------------------------------- (b) key-major --

template <int HD>
__global__ void __launch_bounds__(kBwdMmaThreads)
    fa_bwd_dkv_mma(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = HD + 8, TILE = kFaBQ * LD;
  // Queries a step, half a tile: the scores and dp (QN/8 x 4 registers
  // each) beside dk and dv (d/2 each) take 140 registers at d=64, three
  // blocks an SM (a whole tile a step takes 199: two blocks an SM).
  constexpr int QN = kFaBQ / 2;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + TILE;
  bf16* qg2 = vs + TILE;  // two buffers of [q | g]
  float* st2 = reinterpret_cast<float*>(qg2 + 4 * TILE);  // two of m, l, dl

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = 16 * (threadIdx.x / 32);  // the warp's keys in the tile
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.y * kFaBK;
  bf16* dkg = static_cast<bf16*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  bf16* dvg = static_cast<bf16*>(a.dv) + b * a.sdv.b + h * a.sdv.h;

  if (k0 >= a.seq_len) {  // only masked keys: p = 0, so dk = dv = 0
    for (int e = threadIdx.x; e < kFaBK * HD; e += kBwdMmaThreads) {
      const int r = e / HD, c = e % HD, row = k0 + r;
      if (row < a.s) {
        dkg[row * a.sdk.s + c] = __float2bfloat16_rn(0.f);
        dvg[row * a.sdv.s + c] = __float2bfloat16_rn(0.f);
      }
    }
    return;
  }
  const bf16* qg = head_ptr<bf16>(a.q, a.sq, b, h);
  const bf16* gg = head_ptr<bf16>(a.g, a.sg, b, h);
  const int nq = (a.s + kFaBQ - 1) / kFaBQ;
  const long long plane = static_cast<long long>(a.bh) * a.s;
  const float* st = a.stats + static_cast<long long>(bh) * a.s;
  const float scale = a.scale;

  // Query tile qt with its stats: rows past S get m = +inf (p = 0).
  auto prefetch = [&](int qt) {
    if (qt < nq) {
      const int q0 = qt * kFaBQ;
      bf16* buf = qg2 + 2 * TILE * (qt & 1);
      stage_tile<HD>(buf, qg, a.sq.s, q0, a.s, a.vec);
      stage_tile<HD>(buf + TILE, gg, a.sg.s, q0, a.s, a.vec);
      float* sb = st2 + 3 * kFaBQ * (qt & 1);
      const int i = threadIdx.x, row = q0 + i;
      if (i < kFaBQ) {
        const bool in = row < a.s;
        sb[i] = in ? st[row] : INFINITY;
        sb[kFaBQ + i] = in ? st[plane + row] : 1.f;
        sb[2 * kFaBQ + i] = in ? st[2 * plane + row] : 0.f;
      }
    }
    cp_async_commit();
  };
  stage_tile<HD>(ks, head_ptr<bf16>(a.k, a.sk, b, h), a.sk.s, k0, a.s,
                 a.vec);
  stage_tile<HD>(vs, head_ptr<bf16>(a.v, a.sv, b, h), a.sv.s, k0, a.s,
                 a.vec);
  prefetch(0);

  const int key = k0 + r0 + lane / 4;  // the lane's keys: key, key + 8
  const bool keep[2] = {key < a.seq_len, key + 8 < a.seq_len};
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  for (int qt = 0; qt < nq; ++qt) {
    prefetch(qt + 1);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = qg2 + 2 * TILE * (qt & 1);
    const bf16* gs = qs + TILE;
    const float* ms = st2 + 3 * kFaBQ * (qt & 1);
    const float* ls = ms + kFaBQ;
    const float* dls = ls + kFaBQ;
#pragma unroll
    for (int c0 = 0; c0 < kFaBQ; c0 += QN) {
      // s^T = k q^T and dp^T = v g^T: rows are keys, columns queries.
      float sc[QN / 8][4], dp[QN / 8][4];
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      mma_abt<HD, QN>(sc, ks, r0, qs, c0, LD, lane);
      mma_abt<HD, QN>(dp, vs, r0, gs, c0, LD, lane);
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = c0 + 8 * j + 2 * t + (e & 1);
          const float p = prob(sc[j][e], keep[e >> 1], scale, ms[i], ls[i]);
          sc[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dls[i]);
        }
#pragma unroll
      for (int kk = 0; kk < QN / 16; ++kk) {
        uint32_t pa[4], da[4];
        pack_a(pa, sc[2 * kk], sc[2 * kk + 1]);
        pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
        mma_ab<HD>(dv, pa, gs, c0 + 16 * kk, LD, lane);
        mma_ab<HD>(dk, da, qs, c0 + 16 * kk, LD, lane);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key + 8 * r;
    if (row >= a.s) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkg + row * a.sdk.s + c) =
          __floats2bfloat162_rn(dk[j][2 * r] * scale,
                                dk[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvg + row * a.sdv.s + c) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch --

template <int HD>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const dim3 grid(a.bh, (a.s + kFaBQ - 1) / kFaBQ);
  cudaError_t err = launch_bwd_kernel(fa_bwd_dq_mma<HD>,
                                      bwd_mma_smem<HD>(false),
                                      kBwdMmaThreads, grid, a, st);
  if (err != cudaSuccess) return err;
  return launch_bwd_kernel(fa_bwd_dkv_mma<HD>, bwd_mma_smem<HD>(true),
                           kBwdMmaThreads, grid, a, st);
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
  // bf16 writes dq, dk and dv as bf16 pairs: even strides and 4-byte
  // aligned outputs (the wrapper's packed buffer has both).
  if (dtype == kBF16) {
    for (const FaStrides* o : {&a.sdq, &a.sdk, &a.sdv})
      if (o->b % 2 || o->h % 2 || o->s % 2) return cudaErrorInvalidValue;
    for (const void* p : {dq, dk, dv})
      if (reinterpret_cast<uintptr_t>(p) % 4) return cudaErrorInvalidValue;
  }
  // The rows of q, k, v and g may be copied in 16-byte chunks (cp.async).
  const int item = dtype == kBF16 ? 2 : 4;
  a.vec = aligned16_ptr(q) && aligned16_ptr(k) && aligned16_ptr(v) &&
          aligned16_ptr(g) && aligned16_strides(a.sq, item) &&
          aligned16_strides(a.sk, item) && aligned16_strides(a.sv, item) &&
          aligned16_strides(a.sg, item);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_bwd_f32(a, hd, st);
  switch (hd / 16) {
    case 1: return launch_bwd<16>(a, st);
    case 2: return launch_bwd<32>(a, st);
    case 3: return launch_bwd<48>(a, st);
    case 4: return launch_bwd<64>(a, st);
    case 5: return launch_bwd<80>(a, st);
    case 6: return launch_bwd<96>(a, st);
    case 7: return launch_bwd<112>(a, st);
    case 8: return launch_bwd<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
