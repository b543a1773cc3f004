// K13's fp32 form on the tensor cores (flash_attention_bwd.cu has the
// header comment, the bf16 form and the C entry point, which launches this
// one for fp32): every product in three TF32 passes (tf32_split.cuh), on
// wgmma at head widths 32 and 64 and on mma.sync at the others. Its own
// unit, so that the bf16 kernels compile as they did without it.

#include "flash_bwd.cuh"
#include "flash_tf32.cuh"

namespace vit {

// ================================= fp32 on mma.sync tf32, three passes ==
//
// Head widths other than 32 and 64 (H/14's 80 among them). The bf16 form's
// tiles and walks, with every product on mma.sync m16n8k8 tf32 in three
// passes (flash_tf32.cuh's routines); the streamed tiles double-buffered.

constexpr int kBwdTf32Threads = 128;  // four warps, 16 rows each

// Shared memory of an fp32 launch: six 64-row tiles of HD + 4 floats, as
// bwd_mma_smem's six bf16 tiles, then for (b) two buffers of the query
// rows' m, l and delta.
template <int HD>
constexpr size_t bwd_tf32_smem(bool dkv) {
  return 6 * kFaBQ * (HD + 4) * sizeof(float) +
         (dkv ? 2 * 3 * kFaBQ * sizeof(float) : 0);
}

static_assert(bwd_tf32_smem<kFaMaxHd>(true) <= 232448,
              "K13 (b) in fp32 at head_dim 128 must fit one block");

// ------------------------------------------------------ (a) query-major --

template <int HD>
__global__ void __launch_bounds__(kBwdTf32Threads)
    fa_bwd_dq_tf32(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = HD + 4, TILE = kFaBQ * LD;
  float* qs = reinterpret_cast<float*>(smem);
  float* gs = qs + TILE;
  float* kv = gs + TILE;  // two buffers of [k | v]

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = 16 * (threadIdx.x / 32);  // the warp's rows in the tile
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * kFaBQ;
  const float* kg = head_ptr<float>(a.k, a.sk, b, h);
  const float* vg = head_ptr<float>(a.v, a.sv, b, h);
  const int n = (a.seq_len + kFaBK - 1) / kFaBK;
  const float scale = a.scale;

  // Step `it` of the stream: key tile it % n, pass 1 then pass 2; one
  // cp.async group a step, empty past the end.
  auto prefetch = [&](int it) {
    if (it < 2 * n) {
      float* buf = kv + 2 * TILE * (it & 1);
      stage_tile_f32<HD>(buf, kg, a.sk.s, (it % n) * kFaBK, a.s, a.vec);
      stage_tile_f32<HD>(buf + TILE, vg, a.sv.s, (it % n) * kFaBK, a.s,
                         a.vec);
    }
    cp_async_commit();
  };
  stage_tile_f32<HD>(qs, head_ptr<float>(a.q, a.sq, b, h), a.sq.s, q0, a.s,
                     a.vec);
  stage_tile_f32<HD>(gs, head_ptr<float>(a.g, a.sg, b, h), a.sg.s, q0, a.s,
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
    const float* ks = kv + 2 * TILE * (it & 1);
    const float* vs = ks + TILE;
    const int k0 = it * kFaBK;
    float sc[kFaBK / 8][4];
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    tf32_abt<HD, kFaBK>(sc, qs, r0, ks, 0, LD, lane);
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
    for (int kk = 0; kk < kFaBK / 8; ++kk) {
      uint32_t ph[4], pl[4];
      tf32_a_of_c(ph, pl, sc[kk]);
      tf32_ab_perm<HD>(o, ph, pl, vs, 8 * kk, LD, lane);
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
      dl[e >> 1] += gs[row * LD + 8 * j + 2 * t + (e & 1)] * o[j][e];
    }
  quad_reduce(dl, [](float x, float y) { return x + y; });
  dl[0] /= l[0];
  dl[1] /= l[1];

  // Pass 2: p, dp = g v^T, ds = p (dp - delta), dq += ds k.
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int it = n; it < 2 * n; ++it) {
    prefetch(it + 1);
    cp_async_wait<1>();
    __syncthreads();
    const float* ks = kv + 2 * TILE * (it & 1);
    const float* vs = ks + TILE;
    const int k0 = (it - n) * kFaBK;
    float sc[kFaBK / 8][4], dp[kFaBK / 8][4];
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    tf32_abt<HD, kFaBK>(sc, qs, r0, ks, 0, LD, lane);
    tf32_abt<HD, kFaBK>(dp, gs, r0, vs, 0, LD, lane);
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
    for (int kk = 0; kk < kFaBK / 8; ++kk) {
      uint32_t dh[4], dlo[4];
      tf32_a_of_c(dh, dlo, sc[kk]);
      tf32_ab_perm<HD>(dq, dh, dlo, ks, 8 * kk, LD, lane);
    }
    __syncthreads();
  }

  float* dqg = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  const long long plane = static_cast<long long>(a.bh) * a.s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + lane / 4 + 8 * r;
    if (row >= a.s) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      float* p = dqg + row * a.sdq.s + 8 * j + 2 * t;
      p[0] = dq[j][2 * r] * scale;
      p[1] = dq[j][2 * r + 1] * scale;
    }
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
__global__ void __launch_bounds__(kBwdTf32Threads)
    fa_bwd_dkv_tf32(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = HD + 4, TILE = kFaBQ * LD;
  // Queries a step: half a tile up to d = 64, a quarter above, so that
  // the scores and dp stay in registers beside dk and dv (d/2 each).
  constexpr int QN = HD <= 64 ? kFaBQ / 2 : kFaBQ / 4;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + TILE;
  float* qg2 = vs + TILE;  // two buffers of [q | g]
  float* st2 = qg2 + 4 * TILE;  // two of m, l, dl

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = 16 * (threadIdx.x / 32);  // the warp's keys in the tile
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.y * kFaBK;
  float* dkg = static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  float* dvg = static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h;

  if (k0 >= a.seq_len) {  // only masked keys: p = 0, so dk = dv = 0
    for (int e = threadIdx.x; e < kFaBK * HD; e += kBwdTf32Threads) {
      const int r = e / HD, c = e % HD, row = k0 + r;
      if (row < a.s) {
        dkg[row * a.sdk.s + c] = 0.f;
        dvg[row * a.sdv.s + c] = 0.f;
      }
    }
    return;
  }
  const float* qg = head_ptr<float>(a.q, a.sq, b, h);
  const float* gg = head_ptr<float>(a.g, a.sg, b, h);
  const int nq = (a.s + kFaBQ - 1) / kFaBQ;
  const long long plane = static_cast<long long>(a.bh) * a.s;
  const float* st = a.stats + static_cast<long long>(bh) * a.s;
  const float scale = a.scale;

  // Query tile qt with its stats: rows past S get m = +inf (p = 0).
  auto prefetch = [&](int qt) {
    if (qt < nq) {
      const int q0 = qt * kFaBQ;
      float* buf = qg2 + 2 * TILE * (qt & 1);
      stage_tile_f32<HD>(buf, qg, a.sq.s, q0, a.s, a.vec);
      stage_tile_f32<HD>(buf + TILE, gg, a.sg.s, q0, a.s, a.vec);
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
  stage_tile_f32<HD>(ks, head_ptr<float>(a.k, a.sk, b, h), a.sk.s, k0, a.s,
                     a.vec);
  stage_tile_f32<HD>(vs, head_ptr<float>(a.v, a.sv, b, h), a.sv.s, k0, a.s,
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
    const float* qs = qg2 + 2 * TILE * (qt & 1);
    const float* gs = qs + TILE;
    const float* ms = st2 + 3 * kFaBQ * (qt & 1);
    const float* ls = ms + kFaBQ;
    const float* dls = ls + kFaBQ;
#pragma unroll 1
    for (int c0 = 0; c0 < kFaBQ; c0 += QN) {
      // s^T = k q^T and dp^T = v g^T: rows are keys, columns queries.
      float sc[QN / 8][4], dp[QN / 8][4];
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
      tf32_abt<HD, QN>(sc, ks, r0, qs, c0, LD, lane);
      tf32_abt<HD, QN>(dp, vs, r0, gs, c0, LD, lane);
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
      for (int kk = 0; kk < QN / 8; ++kk) {
        uint32_t ph[4], pl[4], dh[4], dlo[4];
        tf32_a_of_c(ph, pl, sc[kk]);
        tf32_a_of_c(dh, dlo, dp[kk]);
        tf32_ab_perm<HD>(dv, ph, pl, gs, c0 + 8 * kk, LD, lane);
        tf32_ab_perm<HD>(dk, dh, dlo, qs, c0 + 8 * kk, LD, lane);
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
      float* pk = dkg + row * a.sdk.s + c;
      float* pv = dvg + row * a.sdv.s + c;
      pk[0] = dk[j][2 * r] * scale;
      pk[1] = dk[j][2 * r + 1] * scale;
      pv[0] = dv[j][2 * r];
      pv[1] = dv[j][2 * r + 1];
    }
  }
}

// ======================== fp32 on wgmma tf32, head widths 32 and 64 ==
//
// The same launches, walks and arithmetic with every product a warpgroup's
// wgmma.mma_async m64nNk8 tf32 in three passes. A block is two warpgroups, each
// the four warps of the mma.sync form on a 64-row tile of its own (two query
// tiles in (a), two key tiles in (b)), so that one warpgroup's softmax and
// splits run while the other's products hold the tensor cores. The accumulators
// keep mma.sync's C layout a warp, and A comes from registers, split there: the
// rows of a raw fp32 tile, or a C tile in the permuted order (flash_tf32.cuh).
// tf32 wgmma reads B K-major only, so each streamed tile (k and v in (a), q and
// g in (b)), shared by both warpgroups, is split by the block's 256 threads
// into hi and lo K-major operands with the 128-byte swizzle, two ways: as it
// lies (rows the tile's 64 rows, K the head width: the B of s = q k^T, dp = g
// v^T and their transposes) and transposed (rows the head width, K the tile's
// rows in the permuted order: the B of o = p v, dq = ds k, dv = p^T g, dk =
// ds^T q); launch (a) splits k and v only the ways its pass reads them. The
// products then run without a split or a B load on the warps' ALUs -- what
// bounds the mma.sync form (PERF.md section 6) -- and the tensor cores take 64
// x N x 8 a warpgroup instruction. The next tile's 4 x 4 blocks are loaded into
// registers while the current tile's products run. Shared memory (about 199 KB
// at d = 64: the two warpgroups' raw A tiles and the eight operand boxes) holds
// one block an SM. The softmax runs in base 2 (prob_r).

constexpr int kBwdWgThreads = 256;  // two warpgroups

template <int HD>
constexpr size_t bwd_wg_smem(bool dkv) {
  return 1024 + 4 * kFaBQ * (HD + 4) * sizeof(float) + 8 * kWgBox<HD> +
         (dkv ? 2 * 3 * kFaBQ * sizeof(float) : 0);
}

static_assert(bwd_wg_smem<64>(true) <= 232448, "K13 wgmma (b) at d = 64");

// ------------------------------------------------------ (a) query-major --

template <int HD>
__global__ void __launch_bounds__(kBwdWgThreads, 1)
    fa_bwd_dq_wg(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_in[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_in) + 1023) & ~uintptr_t(1023));
  constexpr int LD = HD + 4, TILE = kFaBQ * LD, BOX = kWgBox<HD>;
  const int wgi = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  // Each warpgroup's raw q and g tiles; then k and v split as they lie and
  // transposed, hi and lo each.
  float* qs = reinterpret_cast<float*>(smem) + 2 * wgi * TILE;
  float* gs = qs + TILE;
  const uint32_t kn = wg::smem_u32(smem) + 4 * TILE * 4, kt = kn + 2 * BOX;
  const uint32_t vn = kt + 2 * BOX, vt = vn + 2 * BOX;

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = 16 * warp;  // the warp's rows in its tile
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int q0 = (2 * blockIdx.y + wgi) * kFaBQ;
  const float* kg = head_ptr<float>(a.k, a.sk, b, h);
  const float* vg = head_ptr<float>(a.v, a.sv, b, h);
  const int n = (a.seq_len + kFaBK - 1) / kFaBK;
  const float scale = a.scale, scale2 = a.scale * kLog2e;

  stage_tile_f32<HD>(qs, head_ptr<float>(a.q, a.sq, b, h), a.sq.s, q0, a.s,
                     a.vec, threadIdx.x % 128, 128);
  stage_tile_f32<HD>(gs, head_ptr<float>(a.g, a.sg, b, h), a.sg.s, q0, a.s,
                     a.vec, threadIdx.x % 128, 128);
  cp_async_commit();
  // Step `it`: key tile it % n, pass 1 then pass 2. Its blocks wait in
  // registers while the previous step's products run.
  float4 kb[4], vb[4];
  auto load = [&](int it) {
    wg_load_block<HD>(kb, kg, a.sk.s, (it % n) * kFaBK, a.s, a.vec);
    wg_load_block<HD>(vb, vg, a.sv.s, (it % n) * kFaBK, a.s, a.vec);
  };
  // Pass 1 reads k as it lies (s) and v transposed (o); pass 2 k both ways
  // (s, dq) and v as it lies (dp).
  auto take = [&](int it) {
    __syncthreads();  // both warpgroups are done with the operands
    if (it < n) {
      wg_store_block<HD, true, false>(kb, kn, kt);
      wg_store_block<HD, false, true>(vb, vn, vt);
    } else {
      wg_store_block<HD, true, true>(kb, kn, kt);
      wg_store_block<HD, true, false>(vb, vn, vt);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (it + 1 < 2 * n) load(it + 1);
    cp_async_wait<0>();
    __syncthreads();
  };
  load(0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int it = 0; it < n; ++it) {
    take(it);
    const int k0 = it * kFaBK;
    float sc[kFaBK / 8][4];
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    wg_raw_a<HD, kFaBK>(sc, qs, LD, kn, kn + BOX, warp, lane);
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool keep = k0 + 8 * j + 2 * t + (e & 1) < a.seq_len;
        sc[j][e] = keep ? sc[j][e] * scale2 : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
      }
    quad_reduce(mt, [](float x, float y) { return fmaxf(x, y); });
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = ex2(m[r] - mt[r]);
      m[r] = mt[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = ex2(sc[j][e] - m[e >> 1]);
        l[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    wg_c_a<kFaBK, HD>(o, sc, vt, vt + BOX);
  }
  quad_reduce(l, [](float x, float y) { return x + y; });
  float dl[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + lane / 4 + 8 * (e >> 1);
      dl[e >> 1] += gs[row * LD + 8 * j + 2 * t + (e & 1)] * o[j][e];
    }
  quad_reduce(dl, [](float x, float y) { return x + y; });
  dl[0] /= l[0];
  dl[1] /= l[1];
  const float rl[2] = {1.f / l[0], 1.f / l[1]};

  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  for (int it = n; it < 2 * n; ++it) {
    take(it);
    const int k0 = (it - n) * kFaBK;
    float sc[kFaBK / 8][4], dp[kFaBK / 8][4];
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    wg_raw_a<HD, kFaBK>(sc, qs, LD, kn, kn + BOX, warp, lane);
    wg_raw_a<HD, kFaBK>(dp, gs, LD, vn, vn + BOX, warp, lane);
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            prob_r(sc[j][e], k0 + 8 * j + 2 * t + (e & 1) < a.seq_len,
                   scale2, m[r], rl[r]);
        sc[j][e] = p * (dp[j][e] - dl[r]);
      }
    wg_c_a<kFaBK, HD>(dq, sc, kt, kt + BOX);
  }

  float* dqg = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  const long long plane = static_cast<long long>(a.bh) * a.s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + lane / 4 + 8 * r;
    if (row >= a.s) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      float* p = dqg + row * a.sdq.s + 8 * j + 2 * t;
      p[0] = dq[j][2 * r] * scale;
      p[1] = dq[j][2 * r + 1] * scale;
    }
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
__global__ void __launch_bounds__(kBwdWgThreads, 1)
    fa_bwd_dkv_wg(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_in[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_in) + 1023) & ~uintptr_t(1023));
  constexpr int LD = HD + 4, TILE = kFaBQ * LD, BOX = kWgBox<HD>;
  const int wgi = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  // Each warpgroup's raw k and v tiles; then q and g split as they lie and
  // transposed, hi and lo each; then two buffers of the query rows' m, l
  // and delta.
  float* ks = reinterpret_cast<float*>(smem) + 2 * wgi * TILE;
  float* vs = ks + TILE;
  const uint32_t qn = wg::smem_u32(smem) + 4 * TILE * 4, qt2 = qn + 2 * BOX;
  const uint32_t gn = qt2 + 2 * BOX, gt = gn + 2 * BOX;
  float* st2 = reinterpret_cast<float*>(smem + 4 * TILE * 4 + 8 * BOX);

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = 16 * warp;  // the warp's keys in its tile
  const int bh = blockIdx.x, b = bh / a.heads, h = bh % a.heads;
  const int k0 = (2 * blockIdx.y + wgi) * kFaBK;
  float* dkg = static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  float* dvg = static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
  const float* qg = head_ptr<float>(a.q, a.sq, b, h);
  const float* gg = head_ptr<float>(a.g, a.sg, b, h);
  const int nq = (a.s + kFaBQ - 1) / kFaBQ;
  const long long plane = static_cast<long long>(a.bh) * a.s;
  const float* st = a.stats + static_cast<long long>(bh) * a.s;
  const float scale = a.scale, scale2 = a.scale * kLog2e;

  stage_tile_f32<HD>(ks, head_ptr<float>(a.k, a.sk, b, h), a.sk.s, k0, a.s,
                     a.vec, threadIdx.x % 128, 128);
  stage_tile_f32<HD>(vs, head_ptr<float>(a.v, a.sv, b, h), a.sv.s, k0, a.s,
                     a.vec, threadIdx.x % 128, 128);
  cp_async_commit();
  // Query tile qt's blocks in registers; its stats (rows past S: m = +inf,
  // so p = 0) into buffer qt % 2, which no warp reads until the tile's turn.
  float4 qb[4], gb[4];
  auto load = [&](int qt) {
    const int q0 = qt * kFaBQ;
    wg_load_block<HD>(qb, qg, a.sq.s, q0, a.s, a.vec);
    wg_load_block<HD>(gb, gg, a.sg.s, q0, a.s, a.vec);
    float* sb = st2 + 3 * kFaBQ * (qt & 1);
    const int i = threadIdx.x, row = q0 + i;
    if (i < kFaBQ) {
      const bool in = row < a.s;
      sb[i] = in ? st[row] : INFINITY;
      sb[kFaBQ + i] = in ? 1.f / st[plane + row] : 1.f;  // 1 / l
      sb[2 * kFaBQ + i] = in ? st[2 * plane + row] : 0.f;
    }
  };
  load(0);

  // Keys at or past seq_len get p = 0 (a whole masked tile: dk = dv = 0).
  const int key = k0 + r0 + lane / 4;  // the lane's keys: key, key + 8
  const bool keep[2] = {key < a.seq_len, key + 8 < a.seq_len};
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  for (int qt = 0; qt < nq; ++qt) {
    __syncthreads();  // both warpgroups are done with the operands
    wg_store_block<HD, true, true>(qb, qn, qt2);
    wg_store_block<HD, true, true>(gb, gn, gt);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (qt + 1 < nq) load(qt + 1);
    cp_async_wait<0>();
    __syncthreads();
    const float* ms = st2 + 3 * kFaBQ * (qt & 1);
    const float* rls = ms + kFaBQ;
    const float* dls = rls + kFaBQ;
    // s^T = k q^T and dp^T = v g^T: rows are keys, columns queries.
    float sc[kFaBQ / 8][4], dp[kFaBQ / 8][4];
#pragma unroll
    for (int j = 0; j < kFaBQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    wg_raw_a<HD, kFaBQ>(sc, ks, LD, qn, qn + BOX, warp, lane);
    wg_raw_a<HD, kFaBQ>(dp, vs, LD, gn, gn + BOX, warp, lane);
#pragma unroll
    for (int j = 0; j < kFaBQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * j + 2 * t + (e & 1);
        const float p = prob_r(sc[j][e], keep[e >> 1], scale2, ms[i],
                               rls[i]);
        sc[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dls[i]);
      }
    {
      uint32_t ph[kFaBQ / 8][4], pl[kFaBQ / 8][4];
      uint32_t dh[kFaBQ / 8][4], dlo[kFaBQ / 8][4];
      wg_a_c<kFaBQ>(ph, pl, sc);
      wg_a_c<kFaBQ>(dh, dlo, dp);
      wg_tf32x3_pair<kFaBQ, HD>(dv, ph, pl, gt, gt + BOX, dk, dh, dlo, qt2,
                                qt2 + BOX);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key + 8 * r;
    if (row >= a.s) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + 2 * t;
      float* pk = dkg + row * a.sdk.s + c;
      float* pv = dvg + row * a.sdv.s + c;
      pk[0] = dk[j][2 * r] * scale;
      pk[1] = dk[j][2 * r + 1] * scale;
      pv[0] = dv[j][2 * r];
      pv[1] = dv[j][2 * r + 1];
    }
  }
}

// fp32 at head widths 32 and 64: the wgmma form, two 64-row tiles a block.
template <int HD>
cudaError_t launch_bwd_f32_hd(const BwdArgs& a, cudaStream_t st) {
  if constexpr (HD == 32 || HD == 64) {
    const dim3 grid(a.bh, (a.s + 2 * kFaBQ - 1) / (2 * kFaBQ));
    cudaError_t err = launch_bwd_kernel(
        fa_bwd_dq_wg<HD>, bwd_wg_smem<HD>(false), kBwdWgThreads, grid, a, st);
    if (err != cudaSuccess) return err;
    return launch_bwd_kernel(fa_bwd_dkv_wg<HD>, bwd_wg_smem<HD>(true),
                             kBwdWgThreads, grid, a, st);
  } else {
    const dim3 grid(a.bh, (a.s + kFaBQ - 1) / kFaBQ);
    cudaError_t err =
        launch_bwd_kernel(fa_bwd_dq_tf32<HD>, bwd_tf32_smem<HD>(false),
                          kBwdTf32Threads, grid, a, st);
    if (err != cudaSuccess) return err;
    return launch_bwd_kernel(fa_bwd_dkv_tf32<HD>, bwd_tf32_smem<HD>(true),
                             kBwdTf32Threads, grid, a, st);
  }
}

cudaError_t launch_bwd_f32(const BwdArgs& a, int hd, cudaStream_t st) {
  switch (hd / 16) {
    case 1: return launch_bwd_f32_hd<16>(a, st);
    case 2: return launch_bwd_f32_hd<32>(a, st);
    case 3: return launch_bwd_f32_hd<48>(a, st);
    case 4: return launch_bwd_f32_hd<64>(a, st);
    case 5: return launch_bwd_f32_hd<80>(a, st);
    case 6: return launch_bwd_f32_hd<96>(a, st);
    case 7: return launch_bwd_f32_hd<112>(a, st);
    case 8: return launch_bwd_f32_hd<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vit
