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
// fp32: products on FFMA in full fp32 (no TF32: the Pallas dots run at
// HIGHEST), 256 threads with a 4 x N/16 register block each, the tiles and
// accumulators in shared memory; launch (a) streams the key tiles three
// times (the stats, delta = rowsum(dp * p), then ds and dq).
//
// Bound on the card: 10*B*H*S*seq_len*d operations (JAX's cost estimate,
// vjp.py:414-417, over the real keys), the four inputs read and three
// outputs written once (7*B*H*S*d elements). At B/16 bs=32 (384 heads, 197
// of 208 tokens, d=64) it is bytes-bound in bf16 (71.6 MB, 21.4 us at
// 3.35 TB/s; the 1.0e10 operations take 10.2 us at the bf16 peak) and
// operations-bound in fp32 (150.3 us at 67 TFLOP/s). In bf16 the tiles
// are re-read from L2 (each key tile once a query tile and pass), so the
// fragments' shared-memory traffic and the two launches' serial tails
// set the time, not device memory.
//
// head_dim: any multiple of 16 up to 128. Query rows past S are loaded as
// zeros and not stored.

#include <math.h>

#include <initializer_list>

#include "flash_tiles.cuh"
#include "mma_frag.cuh"

namespace vit {

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

// p of one score: exp(s * scale - m) / l, 0 where the key is masked (or
// the query row is past S). The product is rounded before the subtraction,
// as in JAX (s = dot * scale, then s - max).
__device__ __forceinline__ float prob(float raw, bool keep, float scale,
                                      float m, float l) {
  return keep ? expf(__fmul_rn(raw, scale) - m) / l : 0.f;
}

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

// ======================================================= fp32 on FFMA ==

constexpr int kBwdF32Threads = 256;
constexpr int kBwdF32Lds = kFaBK + 1;  // odd strides: conflict-free columns

template <int HD>
constexpr size_t bwd_f32_smem(bool dkv) {
  const int acc = dkv ? 2 : 1;
  return 4 * kFaBQ * (HD + 1) * sizeof(float)        // q, g, k, v
         + 2 * kFaBQ * kBwdF32Lds * sizeof(float)    // scores, dp
         + acc * kFaBQ * (HD + 1) * sizeof(float)    // accumulators
         + 3 * kFaBQ * sizeof(float);                // m, l, delta
}

static_assert(bwd_f32_smem<kFaMaxHd>(true) <= 232448,
              "K13 (b) in fp32 at head_dim 128 must fit one block");

// C (64 x N, row stride ldc) = [C +] A (64 x K) B (K x N) with every
// operand in shared memory: A(r, k) at A[r * lda + k], or at A[k * lda + r]
// with ACOL; B(k, n) at B[k * ldb + n], or at B[n * ldb + k] with BCOL.
// Each of 256 threads computes rows ty + 16i (i < 4) and columns tx + 16j
// (j < N/16) in registers, on FFMA.
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

// Rows [r0, r0 + 64) of a (S, HD) fp32 matrix, rows at or past s zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ldd,
                                          const float* src, long long ld,
                                          int r0, int s) {
  for (int e = threadIdx.x; e < kFaBQ * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD;
    dst[r * ldd + c] = r0 + r < s ? src[(r0 + r) * ld + c] : 0.f;
  }
}

// The shared-memory tiles of one fp32 block, carved in bwd_f32_smem's
// order; p and ds overwrite the scores and dp.
template <int HD>
struct BwdSmemF32 {
  static constexpr int LDX = HD + 1;
  float *x0, *x1, *x2, *x3;  // (a): q, g, k, v; (b): k, v, q, g
  float *ss, *dps, *acc0, *acc1, *ms, *ls, *dls;

  __device__ BwdSmemF32(unsigned char* base, bool dkv) {
    x0 = reinterpret_cast<float*>(base);
    x1 = x0 + kFaBQ * LDX;
    x2 = x1 + kFaBQ * LDX;
    x3 = x2 + kFaBQ * LDX;
    ss = x3 + kFaBQ * LDX;
    dps = ss + kFaBQ * kBwdF32Lds;
    acc0 = dps + kFaBQ * kBwdF32Lds;
    acc1 = dkv ? acc0 + kFaBQ * LDX : nullptr;
    ms = acc0 + (dkv ? 2 : 1) * kFaBQ * LDX;
    ls = ms + kFaBQ;
    dls = ls + kFaBQ;
  }
};

// (a) query-major: three passes over the key tiles.
template <int HD>
__global__ void __launch_bounds__(kBwdF32Threads)
    fa_bwd_dq_f32(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Sm = BwdSmemF32<HD>;
  constexpr int LDX = Sm::LDX, LDS = kBwdF32Lds;
  Sm sm(smem, false);
  float *qs = sm.x0, *gs = sm.x1, *ks = sm.x2, *vs = sm.x3;
  float* dqa = sm.acc0;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int nw = blockDim.x / 32;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * kFaBQ;
  const float* qg = head_ptr<float>(a.q, a.sq, b, h);
  const float* kg = head_ptr<float>(a.k, a.sk, b, h);
  const float* vg = head_ptr<float>(a.v, a.sv, b, h);
  const float* gg = head_ptr<float>(a.g, a.sg, b, h);

  load_tile<HD>(qs, LDX, qg, a.sq.s, q0, a.s);
  load_tile<HD>(gs, LDX, gg, a.sg.s, q0, a.s);
  for (int e = t; e < kFaBQ * LDX; e += blockDim.x) dqa[e] = 0.f;
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
    load_tile<HD>(ks, LDX, kg, a.sk.s, k0, a.s);
    __syncthreads();
    tile_mm<kFaBK, HD, false, true>(qs, LDX, ks, LDX, sm.ss, LDS, false);
    __syncthreads();
    for (int r = warp; r < kFaBQ; r += nw)
      softmax_row<float>(sm.ss + r * LDS, sm.ss + r * LDS, k0, a.seq_len,
                         a.scale, sm.ms + r, sm.ls + r, lane);
  }

  // Pass 2: delta = rowsum(dp * p). Pass 3: ds, and dq += ds k.
  for (int pass = 2; pass <= 3; ++pass) {
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kFaBK;
      __syncthreads();
      load_tile<HD>(ks, LDX, kg, a.sk.s, k0, a.s);
      load_tile<HD>(vs, LDX, vg, a.sv.s, k0, a.s);
      __syncthreads();
      tile_mm<kFaBK, HD, false, true>(qs, LDX, ks, LDX, sm.ss, LDS, false);
      tile_mm<kFaBK, HD, false, true>(gs, LDX, vs, LDX, sm.dps, LDS, false);
      __syncthreads();
      for (int r = warp; r < kFaBQ; r += nw) {
        const float m = sm.ms[r], l = sm.ls[r];
        const float* srow = sm.ss + r * LDS;
        float* drow = sm.dps + r * LDS;
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
            drow[c] = p * (drow[c] - dl);
          }
        }
      }
      if (pass == 3) {
        __syncthreads();
        tile_mm<HD, kFaBK, false, false>(sm.dps, LDS, ks, LDX, dqa, LDX,
                                         true);
      }
    }
  }
  __syncthreads();

  float* dqg = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  for (int e = t; e < kFaBQ * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD, row = q0 + r;
    if (row < a.s) dqg[row * a.sdq.s + c] = dqa[r * LDX + c] * a.scale;
  }
  if (t < kFaBQ && q0 + t < a.s) {
    const long long at = static_cast<long long>(bh) * a.s + q0 + t;
    const long long plane = static_cast<long long>(a.bh) * a.s;
    a.stats[at] = sm.ms[t];
    a.stats[plane + at] = sm.ls[t];
    a.stats[2 * plane + at] = sm.dls[t];
  }
}

// (b) key-major: dv += p^T g and dk += ds^T q over every query tile.
template <int HD>
__global__ void __launch_bounds__(kBwdF32Threads)
    fa_bwd_dkv_f32(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using Sm = BwdSmemF32<HD>;
  constexpr int LDX = Sm::LDX, LDS = kBwdF32Lds;
  Sm sm(smem, true);
  float *ks = sm.x0, *vs = sm.x1, *qs = sm.x2, *gs = sm.x3;
  float *dka = sm.acc0, *dva = sm.acc1;

  const int t = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.y * kFaBK;
  float* dkg = static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  float* dvg = static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h;

  if (k0 >= a.seq_len) {  // only masked keys: p = 0, so dk = dv = 0
    for (int e = t; e < kFaBK * HD; e += blockDim.x) {
      const int r = e / HD, c = e % HD, row = k0 + r;
      if (row < a.s) {
        dkg[row * a.sdk.s + c] = 0.f;
        dvg[row * a.sdv.s + c] = 0.f;
      }
    }
    return;
  }
  const float* qg = head_ptr<float>(a.q, a.sq, b, h);
  const float* kg = head_ptr<float>(a.k, a.sk, b, h);
  const float* vg = head_ptr<float>(a.v, a.sv, b, h);
  const float* gg = head_ptr<float>(a.g, a.sg, b, h);
  load_tile<HD>(ks, LDX, kg, a.sk.s, k0, a.s);
  load_tile<HD>(vs, LDX, vg, a.sv.s, k0, a.s);
  for (int e = t; e < kFaBK * LDX; e += blockDim.x) dka[e] = dva[e] = 0.f;
  const long long plane = static_cast<long long>(a.bh) * a.s;
  const float* st = a.stats + static_cast<long long>(bh) * a.s;

  for (int q0 = 0; q0 < a.s; q0 += kFaBQ) {
    __syncthreads();
    load_tile<HD>(qs, LDX, qg, a.sq.s, q0, a.s);
    load_tile<HD>(gs, LDX, gg, a.sg.s, q0, a.s);
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
      sm.dps[r * LDS + c] = p * (sm.dps[r * LDS + c] - sm.dls[r]);
      sm.ss[r * LDS + c] = p;
    }
    __syncthreads();
    tile_mm<HD, kFaBQ, true, false>(sm.ss, LDS, gs, LDX, dva, LDX, true);
    tile_mm<HD, kFaBQ, true, false>(sm.dps, LDS, qs, LDX, dka, LDX, true);
  }
  __syncthreads();

  for (int e = t; e < kFaBK * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD, row = k0 + r;
    if (row < a.s) {
      dkg[row * a.sdk.s + c] = dka[r * LDX + c] * a.scale;
      dvg[row * a.sdv.s + c] = dva[r * LDX + c];
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

template <int HD>
cudaError_t launch_bwd(const BwdArgs& a, int dtype, cudaStream_t st) {
  const dim3 grid(a.bh, (a.s + kFaBQ - 1) / kFaBQ);
  cudaError_t err =
      dtype == kF32
          ? launch_bwd_kernel(fa_bwd_dq_f32<HD>, bwd_f32_smem<HD>(false),
                              kBwdF32Threads, grid, a, st)
          : launch_bwd_kernel(fa_bwd_dq_mma<HD>, bwd_mma_smem<HD>(false),
                              kBwdMmaThreads, grid, a, st);
  if (err != cudaSuccess) return err;
  return dtype == kF32
             ? launch_bwd_kernel(fa_bwd_dkv_f32<HD>, bwd_f32_smem<HD>(true),
                                 kBwdF32Threads, grid, a, st)
             : launch_bwd_kernel(fa_bwd_dkv_mma<HD>, bwd_mma_smem<HD>(true),
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
  a.vec = dtype == kBF16 && aligned16_ptr(q) && aligned16_ptr(k) &&
          aligned16_ptr(v) && aligned16_ptr(g) && aligned16_strides(a.sq, 2) &&
          aligned16_strides(a.sk, 2) && aligned16_strides(a.sv, 2) &&
          aligned16_strides(a.sg, 2);
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd / 16) {
    case 1: return launch_bwd<16>(a, dtype, st);
    case 2: return launch_bwd<32>(a, dtype, st);
    case 3: return launch_bwd<48>(a, dtype, st);
    case 4: return launch_bwd<64>(a, dtype, st);
    case 5: return launch_bwd<80>(a, dtype, st);
    case 6: return launch_bwd<96>(a, dtype, st);
    case 7: return launch_bwd<112>(a, dtype, st);
    case 8: return launch_bwd<128>(a, dtype, st);
    default: return cudaErrorInvalidValue;
  }
}
