// The bf16 attention core on the tensor cores, K4's (attention.cu) and
// K9's attention phase (encoder_stack.cu): the work of
// attention_tile<bf16> (attention_core.cuh) for one (image, head, query
// tile), with both products on mma.sync (mma_frag.cuh) and _attn_core's
// rounding points (vit_tpu/ops/pallas/block.py:675-692), which are also
// _encoder_stack_kernel's (block.py:1953-1968):
//   s = (q . k) * scale in fp32, keys at index >= seq_len at -inf;
//   the max is the row max over all keys;
//   p = exp(s - max) in fp32, l = the sum of the unrounded p;
//   ctx = (p rounded to bf16) @ v in fp32, then / l, stored once in bf16.
//
// K4: a block of four warps, 16 query rows each (a 64-row tile). K9: the
// whole 256-thread block on a tile of 16 (8 / P) rows with the keys split
// into P parts, warp w taking rows 16 (w % (8 / P)) .. of the tile against
// part w / (8 / P) of the keys; the parts' row maxima, sums and contexts
// meet in shared memory (fp32, summed in the parts' order by part 0's
// warps), so that each warp walks a P-th of the keys. The head's K and V
// rows (the keys below seq_len, zero-padded to a multiple of 16 keys and
// the head width to a multiple of 16 columns) are staged in shared memory
// with cp.async, rows padded by 16 bytes so that ldmatrix is
// conflict-free; K first, so that the first pass runs while V arrives. A
// warp's q rows go straight into A fragments in registers. Two passes over
// 64-key chunks:
//   1. s = q k^T on mma.sync, keeping only the row max (each lane holds
//      two rows' columns; a quad of lanes reduces with __shfl_xor_sync);
//   2. s again, p = exp(s - max), l += p, p packed to bf16 where the C
//      fragment left it and used as the A operand of ctx += p v, v loaded
//      by ldmatrix.trans.
// Not an online softmax: a running max would round p relative to it (K7's
// rounding point); the second q k^T costs about 3 us at B/16 bs=32. The
// registers do not grow with S. Heads wider than 128 columns are walked in
// blocks of 128: q is read again for each block of the scores, and pass 2
// runs once for each block of the context.
//
// Bound on this card at B/16 bs=32 (384 heads, 197 of 208 keys, d=64):
// bytes, 0.0122 ms for q, k, v in and the context out at 3.35 TB/s; the
// three products (two q k^T, one p v) are 7.8 GFLOP, 0.008 ms at the bf16
// peak. Each block reads its head's K and V once from L2 (the four query
// tiles of a head share them); shared memory 2 * ceil16(S) * (dh' + 8) * 2
// bytes (60 KB at S=208, d=64: three blocks an SM), and in K9 the parts'
// exchange beside it (attn_mma_xbytes: 28 KB at d=64, P=4).

#pragma once

#include <math.h>

#include <type_traits>

#include "attention_core.cuh"
#include "mma_frag.cuh"

namespace vit {

constexpr int kAttnMmaThreads = 128;  // four warps of 16 query rows
constexpr int kAttnMmaChunk = 64;     // keys a chunk of the two passes
constexpr int kAttnMmaMaxK = 8;       // 16-column steps of q held at once

// Head width zero-padded to the fragments' 16 columns, and the row stride
// of the staged K and V (16 bytes more: conflict-free ldmatrix).
__host__ __device__ inline int attn_mma_dhp(int dh) {
  return (dh + 15) / 16 * 16;
}
__host__ __device__ inline int attn_mma_ld(int dh) {
  return attn_mma_dhp(dh) + 8;
}

// Dynamic shared memory of one bf16 tile (vit_tpu_torch/ops/cuda/block.py:
// attention_mma_smem_bytes computes the same): K and V, S rows rounded up
// to 16.
__host__ __device__ inline size_t attention_mma_smem(int s, int dh) {
  return 2 * static_cast<size_t>((s + 15) / 16 * 16) * attn_mma_ld(dh) *
         sizeof(bf16);
}

// Scores of a warp's 16 query rows against G groups of 16 keys (2G C
// tiles of 16 x 8, unscaled) at kc, K's rows. qf holds q's A fragments
// for columns [0, 16 NK) when nb == 1; for wider heads (nb blocks of 128
// columns) it is loaded from q, the rows in device memory, block by block.
template <int NK, int G, bool ROUND>
__device__ __forceinline__ void attn_mma_scores(
    float (&sc)[2 * G][4], uint32_t (&qf)[NK][4], const bf16* q, size_t ldg,
    int qrows, int dh, const bf16* kc, int ld, int dhp, int nb, int lane) {
#pragma unroll
  for (int j = 0; j < 2 * G; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
  for (int b = 0; b < nb; ++b) {
    const int c0 = b * 16 * NK;
    if (nb > 1) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        if (c0 + 16 * kk < dhp)
          load_a_global(qf[kk], q, ldg, qrows, c0 + 16 * kk, dh, lane);
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if ((NK == kAttnMmaMaxK || ROUND) && c0 + 16 * kk >= dhp) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        uint32_t bk[4];
        ldmatrix_b_kmajor(bk, kc, ld, 16 * g, c0 + 16 * kk, lane);
        mma_bf16(sc[2 * g], qf[kk], bk[0], bk[1]);
        mma_bf16(sc[2 * g + 1], qf[kk], bk[2], bk[3]);
      }
    }
  }
}

// f(std::integral_constant<int, G>()) for a chunk of G groups of 16 keys
// (the last chunk of a row may hold fewer than four).
template <typename F>
__device__ __forceinline__ void attn_mma_groups(int groups, F&& f) {
  switch (groups) {
    case 1: f(std::integral_constant<int, 1>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    case 3: f(std::integral_constant<int, 3>()); break;
    default: f(std::integral_constant<int, 4>());
  }
}

// The 16-column steps of q K9 holds at once for a head of width dh: 2, 4
// or 8, the least that holds dh' (up to 8), so that K9 builds three forms
// of the core and not eight (K4 builds the exact NK a launch).
__host__ __device__ inline int attn_mma_nk_of(int dh) {
  const int steps = attn_mma_dhp(dh) / 16;
  return steps <= 2 ? 2 : steps <= 4 ? 4 : 8;
}

// f(std::integral_constant<int, NK>()) with NK = attn_mma_nk_of(dh).
template <typename F>
__device__ __forceinline__ void attn_mma_nk(int dh, F&& f) {
  const int nk = attn_mma_nk_of(dh);
  if (nk == 2)
    f(std::integral_constant<int, 2>());
  else if (nk == 4)
    f(std::integral_constant<int, 4>());
  else
    f(std::integral_constant<int, 8>());
}

// Bytes of the key-split exchange (P > 1) past K and V, fp32, one slot a
// lane: every warp's two row maxima, then parts 1 .. P-1's two row sums
// and 8 NK context values (a block of 16 NK columns) a lane.
__host__ __device__ inline size_t attn_mma_xbytes(int warps, int parts,
                                                  int nk) {
  if (parts == 1) return 0;
  const int others = warps / parts * (parts - 1);
  return 4 * 32 * (2 * static_cast<size_t>(warps) +
                   static_cast<size_t>(others) * (2 + 8 * nk));
}

// Query rows q0 .. q0 + 16 (THREADS / 32 / P) - 1 of head h of image img,
// as attention_tile<bf16> (attention_core.cuh) takes them, on the block's
// THREADS threads: K4's 128 with P = 1, NK = min(dh' / 16, 8); K9's 256
// with the keys in P parts (1, 2, 4 or 8) and NK = attn_mma_nk_of(dh),
// whose steps past dh' are skipped. Uses attention_mma_smem(s, dh) +
// attn_mma_xbytes(THREADS / 32, P, NK) bytes of smem; a caller that runs
// several tiles synchronises the block between them.
template <int NK, int P = 1, int THREADS = kAttnMmaThreads>
__device__ __forceinline__ void attention_tile_mma(const bf16* qkv, bf16* out,
                                                   int s, int d, int dh,
                                                   float scale, int seq_len,
                                                   int img, int h, int q0,
                                                   unsigned char* smem) {
  constexpr bool kRound = P > 1;  // K9: NK may pass dh' / 16
  constexpr int kWarps = THREADS / 32, kRowWarps = kWarps / P;
  static_assert(kRowWarps * P == kWarps, "P divides the block's warps");
  const int dhp = attn_mma_dhp(dh), ld = dhp + 8;
  const int kr = (s + 15) / 16 * 16;           // K's rows, V's offset
  const int kend = (seq_len + 15) / 16 * 16;   // keys walked
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + static_cast<size_t>(kr) * ld;
  const size_t ldg = 3 * static_cast<size_t>(d);
  const bf16* base = qkv + static_cast<size_t>(img) * s * ldg +
                     static_cast<size_t>(h) * dh;
  const bool vec = dh % 8 == 0 && d % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(qkv) % 16 == 0;

  stage_rows(ks, ld, base + d, ldg, kend, seq_len, dh, dhp, vec);
  cp_async_commit();
  stage_rows(vs, ld, base + 2 * d, ldg, kend, seq_len, dh, dhp, vec);
  cp_async_commit();

  const int lane = threadIdx.x % 32, t = lane & 3, warp = threadIdx.x / 32;
  const int r0 = q0 + 16 * (warp % kRowWarps);  // the warp's first row
  // The warp's keys [kb, ke): part warp / kRowWarps of kend / 16 steps.
  const int part = P == 1 ? 0 : warp / kRowWarps, steps = kend / 16;
  const int kb = P == 1 ? 0 : 16 * (part * steps / P);
  const int ke = P == 1 ? kend : 16 * ((part + 1) * steps / P);
  const bool active = r0 < s;
  const bf16* q = base + static_cast<size_t>(r0) * ldg;
  const int qrows = s - r0;  // rows at or past S are zero
  const int nb = (dhp + 16 * NK - 1) / (16 * NK);
  uint32_t qf[NK][4];
  if (active && nb == 1) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      if (!kRound || 16 * kk < dhp)
        load_a_global(qf[kk], q, ldg, qrows, 16 * kk, dh, lane);
  }
  // The lane's rows are r0 + lane/4 (index 0) and r0 + lane/4 + 8 (1); its
  // columns of a C tile j are keys (or context columns) 8j + 2t, + 1.
  auto scaled = [&](float raw, int key) {
    return key < seq_len ? __fmul_rn(raw, scale) : -INFINITY;
  };
  // The key-split exchange (P > 1): value v of warp slot w at
  // (w * values + v) * 32 + lane; parts 1 .. P-1 hold sum and context
  // slots warp - kRowWarps.
  float* xmax = reinterpret_cast<float*>(smem + attention_mma_smem(s, dh));
  float* xsum = xmax + 2 * 32 * kWarps;
  float* xctx = xsum + 2 * 32 * (kWarps - kRowWarps);

  cp_async_wait<1>();
  __syncthreads();
  // Pass 1: the row max over the warp's keys.
  float mx[2] = {-INFINITY, -INFINITY};
  if (active) {
    for (int k0 = kb; k0 < ke; k0 += kAttnMmaChunk) {
      attn_mma_groups(min(ke - k0, kAttnMmaChunk) / 16, [&](auto groups) {
        constexpr int G = decltype(groups)::value;
        float sc[2 * G][4];
        attn_mma_scores<NK, G, kRound>(sc, qf, q, ldg, qrows, dh,
                                       ks + k0 * ld, ld, dhp, nb, lane);
#pragma unroll
        for (int j = 0; j < 2 * G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1],
                               scaled(sc[j][e], k0 + 8 * j + 2 * t + (e & 1)));
      });
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], m));
  }
  if constexpr (P > 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) xmax[(warp * 2 + r) * 32 + lane] = mx[r];
  }
  cp_async_wait<0>();
  __syncthreads();
  if constexpr (P == 1) {
    if (!active) return;
  } else {  // the max over every part's keys
    for (int j = 0; j < P; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(
            mx[r], xmax[((j * kRowWarps + warp % kRowWarps) * 2 + r) * 32 +
                        lane]);
  }

  // Pass 2, once for each block of 16 NK context columns: the scores
  // again, p = exp(s - max) summed into l unrounded, and o += (p in bf16) v
  // with p packed where its C fragment left it.
  for (int n0 = 0; n0 < dhp; n0 += 16 * NK) {
    float o[2 * NK][4], l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int k0 = kb; active && k0 < ke; k0 += kAttnMmaChunk) {
      attn_mma_groups(min(ke - k0, kAttnMmaChunk) / 16, [&](auto groups) {
        constexpr int G = decltype(groups)::value;
        float sc[2 * G][4];
        attn_mma_scores<NK, G, kRound>(sc, qf, q, ldg, qrows, dh,
                                       ks + k0 * ld, ld, dhp, nb, lane);
#pragma unroll
        for (int j = 0; j < 2 * G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            sc[j][e] = expf(scaled(sc[j][e], key) - mx[e >> 1]);
            l[e >> 1] += sc[j][e];
          }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          uint32_t pa[4];
          pack_a(pa, sc[2 * g], sc[2 * g + 1]);
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            if ((NK == kAttnMmaMaxK || kRound) && n0 + 16 * kk >= dhp)
              break;
            uint32_t bv[4];
            ldmatrix_b_rowmajor(bv, vs + k0 * ld, ld, 16 * g, n0 + 16 * kk,
                                lane);
            mma_bf16(o[2 * kk], pa, bv[0], bv[1]);
            mma_bf16(o[2 * kk + 1], pa, bv[2], bv[3]);
          }
        }
      });
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], m);
    if constexpr (P > 1) {
      // Parts 1 .. P-1 hand their sums and context to part 0's warps,
      // which add them in the parts' order.
      __syncthreads();  // part 0 is done with the last block's
      if (part > 0) {
        const int w = warp - kRowWarps;
#pragma unroll
        for (int r = 0; r < 2; ++r) xsum[(w * 2 + r) * 32 + lane] = l[r];
#pragma unroll
        for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            xctx[(w * 8 * NK + j * 4 + e) * 32 + lane] = o[j][e];
      }
      __syncthreads();
      if (part > 0 || !active) continue;
      for (int j = 1; j < P; ++j) {
        const int w = (j - 1) * kRowWarps + warp;
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] += xsum[(w * 2 + r) * 32 + lane];
#pragma unroll
        for (int c = 0; c < 2 * NK; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[c][e] += xctx[(w * 8 * NK + c * 4 + e) * 32 + lane];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + lane / 4 + 8 * r;
      if (row >= s) continue;
      bf16* orow = out + (static_cast<size_t>(img) * s + row) * d +
                   static_cast<size_t>(h) * dh;
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c >= dh) continue;
        const float v0 = o[j][2 * r] / l[r], v1 = o[j][2 * r + 1] / l[r];
        if (dh % 2 == 0) {  // c and the row offset even: a 4-byte store
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          orow[c] = __float2bfloat16_rn(v0);
          if (c + 1 < dh) orow[c + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

}  // namespace vit
