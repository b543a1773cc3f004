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
//
// K23, the attention probe (attn_core_probe_mma.cu), runs this tile on
// K4's block (128 threads, P = 1) with the mode as a template parameter
// (attention_core.cuh's AttnMode). Its default, kAttnFull, is the core K4
// and K9 instantiate; each other mode changes only what its name says:
// - the unmasked modes (attn_all_keys) stage and walk ceil16(S) keys, the
//   keys past S scored -inf (mxu: p = 0), addmask adding the mask to each
//   score;
// - mxu skips pass 1 (p = s, no max or exp), vsum sums the rounded p,
//   wide (heads paired by the caller, dh = 2 hd) takes l in a pass of its
//   own between the two and rounds p / l, the context combined as the mode
//   says (attn_combine);
// - kt stages the head's hd x S slab of the transposed K where it lies
//   (features by tokens) and reads the scores' B fragments from it with
//   ldmatrix.trans; head-major stages q's 64-token slab, K's and V's the
//   same way (q's A fragments by ldmatrix.trans, V's B fragments as they
//   lie) and writes the context feature-major;
// - qcore runs both products on int8 codes, mma.sync m16n8k32 s8 x s8 ->
//   s32 (attention_tile_mma_qcore).
// Its bound is K4's at B/16 bs=32 (bytes, 0.0122 ms); qcore's products
// are int8 (half the operations' time), head-major moves the same bytes.

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
// tiles of 16 x 8, unscaled) at kc, K's rows (KT: kc is the first key's
// column of K's feature-major slab, rows of ld). qf holds q's A fragments
// for columns [0, 16 NK) when nb == 1; for wider heads (nb blocks of 128
// columns) it is loaded from q, the rows in device memory, block by block.
template <int NK, int G, bool ROUND, bool KT = false>
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
        if constexpr (KT)
          ldmatrix_b_rowmajor(bk, kc, ld, c0 + 16 * kk, 16 * g, lane);
        else
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

// ---------------------------------------------------------- K23's modes --

// Byte offsets of qcore's shared memory at S tokens, head width dh: K and
// V in bf16 (ceil32(S) rows of dh' + 8), then K's codes key-major
// (ceil32(S) rows of ceil32(dh) + 16 bytes), V's codes feature-major with
// the keys permuted (ceil32(dh) rows of ceil32(S) + 16 bytes), then 8
// floats for the scales' block reduction.
struct AttnQcoreSmem {
  size_t vs, kq, vq, red, total;
};
__host__ __device__ inline AttnQcoreSmem attn_qcore_smem(int s, int dh) {
  const size_t kr = (s + 31) / 32 * 32, dhq = (dh + 31) / 32 * 32;
  AttnQcoreSmem m;
  m.vs = kr * attn_mma_ld(dh) * sizeof(bf16);
  m.kq = 2 * m.vs;
  m.vq = m.kq + kr * (dhq + 16);
  m.red = m.vq + dhq * (kr + 16);
  m.total = m.red + 8 * sizeof(float);
  return m;
}

// Dynamic shared memory of K23's bf16 core in mode `mode`
// (vit_tpu_torch/tools/attn_core_probe.py:core_smem_bytes computes the
// same): K4's, but for kt (K's feature-major slab, dh' rows of ceil16(S)
// + 8, beside V's rows), head-major (K's and V's slabs and q's, dh' rows
// of kAttnQT + 8) and qcore (attn_qcore_smem).
__host__ __device__ inline size_t attn_mma_probe_smem(int mode, int s,
                                                      int dh) {
  const size_t kr = (s + 15) / 16 * 16, dhp = attn_mma_dhp(dh);
  if (mode == kAttnKt)
    return (dhp * (kr + 8) + kr * attn_mma_ld(dh)) * sizeof(bf16);
  if (mode == kAttnHeadMajor)
    return (2 * dhp * (kr + 8) + dhp * (kAttnQT + 8)) * sizeof(bf16);
  if (mode == kAttnQcore) return attn_qcore_smem(s, dh).total;
  return attention_mma_smem(s, dh);
}

// Rows [0, rows) of a bf16 slab in shared memory (row stride ldd, 16-byte
// aligned rows), staged by the block: row r < nvalid holds source row r
// (row stride lds) at columns [0, cols) and zeros at [cols, padded); every
// row >= nvalid is zero. A chunk of 8 columns goes by cp.async (to be
// committed and waited for by the caller) where vec (the source rows
// 16-byte aligned) and the chunk lies below cols, element by element
// elsewhere. K23's kt and head-major slabs: a (D, ldt) buffer's feature
// rows, tokens along the columns, which end where seq_len does, inside a
// chunk (stage_rows copies every chunk below cols whole: its columns are
// a head's, a multiple of 8 wherever it copies 16 bytes).
__device__ __forceinline__ void stage_slab(bf16* dst, int ldd,
                                           const bf16* src, size_t lds,
                                           int rows, int nvalid, int cols,
                                           int padded, bool vec) {
  const int chunks = padded / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, c = (e % chunks) * 8;
    bf16* dp = dst + r * ldd + c;
    if (r < nvalid && c < cols) {
      const bf16* sp = src + r * lds + c;
      if (vec && c + 8 <= cols) {
        cp_async16(dp, sp);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dp[i] = c + i < cols ? sp[i] : __float2bfloat16_rn(0.f);
      }
    } else {
      *reinterpret_cast<uint4*>(dp) = make_uint4(0, 0, 0, 0);
    }
  }
}

// The A fragment of A(i, c) = S(c0 + c, r0 + i), i, c < 16, of a
// feature-major slab S (features along the rows, tokens contiguous):
// ldmatrix.trans of the four 8 x 8 matrices (features c0 .. c0 + 7 or
// + 8 .., tokens r0 .. r0 + 7 or + 8 ..) in a[]'s order (mma_frag.cuh).
__device__ __forceinline__ void ldmatrix_a_trans(uint32_t (&a)[4],
                                                 const bf16* s, int ld,
                                                 int c0, int r0, int lane) {
  ldmatrix_x4_trans(a, s + (c0 + (lane & 7) + ((lane >> 4) << 3)) * ld + r0 +
                           (((lane >> 3) & 1) << 3));
}

// d += a b on the tensor cores in int8: a 16 x 32 s8 A fragment, the two
// registers of a 32 x 8 s8 B fragment, a 16 x 8 s32 accumulator. A lane
// (g = lane / 4, t = lane % 4) holds a[0] = A(g, 4t .. 4t+3), a[1] = A(g+8,
// 4t ..), a[2] = A(g, 16+4t ..), a[3] = A(g+8, 16+4t ..), b[0] = B(4t ..
// 4t+3, g), b[1] = B(16+4t .., g), each 4 bytes a register, the lowest
// index in the lowest byte; C as in mma_bf16.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The bf16 pair in a 32-bit word (lower column in the low half) to fp32.
__device__ __forceinline__ float bf_lo32(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi32(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Four int8 codes in one register, c0 in the lowest byte.
__device__ __forceinline__ uint32_t pack_s8x4(signed char c0, signed char c1,
                                              signed char c2,
                                              signed char c3) {
  return static_cast<uint32_t>(static_cast<uint8_t>(c0)) |
         (static_cast<uint32_t>(static_cast<uint8_t>(c1)) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(c2)) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(c3)) << 24);
}

// The key that position pos of qcore's context contraction holds: within
// each 32-key step, A column 16 hb + 4t + i of the s8 A fragment is the
// key the lane's score C fragments hold there, 16 hb + 2t + (i & 1) +
// 8 (i >> 1) (C tiles 2 hb and 2 hb + 1, columns 2t and 2t + 1), so that
// p's codes pack into A where the scores left them. V's rows are staged in
// the same order; the sums are exact, so the order changes no bit.
__host__ __device__ inline int attn_qcore_key(int pos) {
  const int w = pos & 31, i = w & 3, t = (w >> 2) & 3;
  return (pos & ~31) + (w & 16) + 2 * t + (i & 1) + 8 * (i >> 1);
}

// qcore (K23): attention_tile<T, kAttnQcore>'s function on the tensor
// cores, K4's block of four warps. K and V are staged in bf16 over all S
// rows, whose absmax gives the head's scales; each is then coded into
// int8, K key-major and V feature-major with its keys in
// attn_qcore_key's order. A warp's q rows are coded with a scale a row
// straight into s8 A fragments (16 NK <= 128 columns, 32 a step). Pass 1
// takes the row max of (q . k) * (aq * (ak * scale)) over the keys below
// seq_len (exact int32 sums); pass 2 forms p = exp(s - max), l += p, p's
// codes (scale 1 / 127: the row max of p is exp(0) = 1 exactly, the
// plain version's and the FFMA tile's max) and ctx += codes . v codes,
// exact, then ctx * (ap * av) / l once (attn_combine).
template <int NK>
__device__ __forceinline__ void attention_tile_mma_qcore(
    const bf16* qkv, bf16* out, int s, int d, int dh, float scale,
    int seq_len, int img, int h, int q0, unsigned char* smem) {
  constexpr int KQ = NK / 2;  // 32-column steps of q held at once
  constexpr int kWarps = kAttnMmaThreads / 32;
  const AttnQcoreSmem lay = attn_qcore_smem(s, dh);
  const int dhp = attn_mma_dhp(dh), ld = dhp + 8, dhq = (dh + 31) / 32 * 32;
  const int kr = (s + 31) / 32 * 32, kend = (seq_len + 31) / 32 * 32;
  const int ldkq = dhq + 16, ldvq = kr + 16;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = reinterpret_cast<bf16*>(smem + lay.vs);
  signed char* kq = reinterpret_cast<signed char*>(smem + lay.kq);
  signed char* vq = reinterpret_cast<signed char*>(smem + lay.vq);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const size_t ldg = 3 * static_cast<size_t>(d);
  const bf16* base = qkv + static_cast<size_t>(img) * s * ldg +
                     static_cast<size_t>(h) * dh;
  const bool vec = dh % 8 == 0 && d % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  stage_rows(ks, ld, base + d, ldg, kr, s, dh, dhp, vec);
  stage_rows(vs, ld, base + 2 * d, ldg, kr, s, dh, dhp, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % 32, t = lane & 3, g = lane >> 2;
  const int warp = threadIdx.x / 32;
  // The head's k and v scales over all S rows (padding is zero), 8
  // columns (16 bytes) a thread at a time.
  const int cpr = dhp / 8;  // 16-byte chunks of a staged row
  float mk = 0.f, mv = 0.f;
  for (int e = threadIdx.x; e < s * cpr; e += kAttnMmaThreads) {
    const int off = (e / cpr) * ld + (e % cpr) * 8;
    const uint4 kw = *reinterpret_cast<const uint4*>(ks + off);
    const uint4 vw = *reinterpret_cast<const uint4*>(vs + off);
    const uint32_t kv[4] = {kw.x, kw.y, kw.z, kw.w};
    const uint32_t vv[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mk = fmaxf(mk, fmaxf(fabsf(bf_lo32(kv[i])), fabsf(bf_hi32(kv[i]))));
      mv = fmaxf(mv, fmaxf(fabsf(bf_lo32(vv[i])), fabsf(bf_hi32(vv[i]))));
    }
  }
  mk = warp_max(mk);
  mv = warp_max(mv);
  if (lane == 0) {
    red[warp] = mk;
    red[kWarps + warp] = mv;
  }
  __syncthreads();
  mk = mv = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    mk = fmaxf(mk, red[w]);
    mv = fmaxf(mv, red[kWarps + w]);
  }
  const float ak = quant_scale(mk), av = quant_scale(mv);
  const float qk_scale = __fmul_rn(ak, scale);
  // K's codes: 8 columns of a row a thread, one 8-byte store.
  const int cq = dhq / 8;
  for (int e = threadIdx.x; e < kr * cq; e += kAttnMmaThreads) {
    const int r = e / cq, c = (e % cq) * 8;
    uint32_t w[2] = {0u, 0u};
    if (c < dhp) {
      const uint4 kw = *reinterpret_cast<const uint4*>(ks + r * ld + c);
      const uint32_t kv[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w[i] = pack_s8x4(quant_code(bf_lo32(kv[2 * i]), ak),
                         quant_code(bf_hi32(kv[2 * i]), ak),
                         quant_code(bf_lo32(kv[2 * i + 1]), ak),
                         quant_code(bf_hi32(kv[2 * i + 1]), ak));
    }
    *reinterpret_cast<uint2*>(kq + r * ldkq + c) = make_uint2(w[0], w[1]);
  }
  // V's codes: 8 positions of a feature row a thread (keys in
  // attn_qcore_key's order), one 8-byte store.
  const int pq = kr / 8;
  for (int e = threadIdx.x; e < dhq * pq; e += kAttnMmaThreads) {
    const int c = e / pq, pos = (e % pq) * 8;
    signed char code[8] = {};
    if (c < dhp) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        code[i] = quant_code(
            __bfloat162float(vs[attn_qcore_key(pos + i) * ld + c]), av);
    }
    *reinterpret_cast<uint2*>(vq + c * ldvq + pos) =
        make_uint2(pack_s8x4(code[0], code[1], code[2], code[3]),
                   pack_s8x4(code[4], code[5], code[6], code[7]));
  }
  __syncthreads();

  const int r0 = q0 + 16 * warp;
  if (r0 >= s) return;
  // q's codes: the lane's rows r0 + g (0) and r0 + g + 8 (1), columns
  // 32 kk + 4t + u and 32 kk + 16 + 4t + u, 8 bytes a load where aligned.
  const bool vq8 = dh % 4 == 0 && d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(qkv) % 8 == 0;
  float qv[KQ][2][8], qmax[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + g + 8 * rr;
        const int c0 = 32 * kk + 4 * t + 16 * hf;
        const bf16* src = base + static_cast<size_t>(row) * ldg + c0;
        float* dst = qv[kk][rr] + 4 * hf;
        if (row < s && vq8 && c0 + 4 <= dh) {
          const uint2 w = *reinterpret_cast<const uint2*>(src);
          dst[0] = bf_lo32(w.x);
          dst[1] = bf_hi32(w.x);
          dst[2] = bf_lo32(w.y);
          dst[3] = bf_hi32(w.y);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            dst[u] = row < s && c0 + u < dh ? __bfloat162float(src[u]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) qmax[rr] = fmaxf(qmax[rr], fabsf(dst[u]));
      }
  float aq[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1)
      qmax[rr] = fmaxf(qmax[rr], __shfl_xor_sync(0xffffffffu, qmax[rr], m));
    aq[rr] = quant_scale(qmax[rr]);
  }
  uint32_t qa[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = i & 1, u0 = 4 * (i >> 1);
      qa[kk][i] = pack_s8x4(quant_code(qv[kk][rr][u0], aq[rr]),
                            quant_code(qv[kk][rr][u0 + 1], aq[rr]),
                            quant_code(qv[kk][rr][u0 + 2], aq[rr]),
                            quant_code(qv[kk][rr][u0 + 3], aq[rr]));
    }
  // The scores of the 32 keys at k0: C tile j holds keys k0 + 8j + 2t, +1.
  auto scores = [&](int (&sc)[4][4], int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      if (32 * kk >= dhq) break;
#pragma unroll
      for (int g2 = 0; g2 < 2; ++g2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kq + (k0 + 16 * g2 + (lane & 7) + ((lane >> 4) << 3)) *
                                 ldkq +
                            32 * kk + (((lane >> 3) & 1) << 4));
        mma_s8(sc[2 * g2], qa[kk], bk[0], bk[1]);
        mma_s8(sc[2 * g2 + 1], qa[kk], bk[2], bk[3]);
      }
    }
  };
  auto scaled = [&](int raw, int key, int rr) {
    return key < seq_len
               ? __fmul_rn(__int2float_rn(raw), __fmul_rn(aq[rr], qk_scale))
               : -INFINITY;
  };
  float mx[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < kend; k0 += 32) {
    int sc[4][4];
    scores(sc, k0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], scaled(sc[j][e], k0 + 8 * j + 2 * t +
                                                            (e & 1), e >> 1));
  }
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], m));

  const float ap = quant_scale(1.f);
  int o[2 * NK][4];
#pragma unroll
  for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0;
  float l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < kend; k0 += 32) {
    int sc[4][4];
    scores(sc, k0);
    signed char pc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(scaled(sc[j][e], k0 + 8 * j + 2 * t + (e & 1),
                                    e >> 1) -
                             mx[e >> 1]);
        l[e >> 1] += p;
        pc[j][e] = quant_code(p, ap);
      }
    // Positions 4t .. 4t+3 (+16) of the step: keys 2t, 2t+1, 8+2t, 9+2t.
    uint32_t pa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j0 = 2 * (i >> 1), e0 = 2 * (i & 1);
      pa[i] = pack_s8x4(pc[j0][e0], pc[j0][e0 + 1], pc[j0 + 1][e0],
                        pc[j0 + 1][e0 + 1]);
    }
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      if (16 * kk >= dhp) break;
      uint32_t bv[4];
      ldmatrix_x4(bv, vq + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * ldvq +
                          k0 + (((lane >> 3) & 1) << 4));
      mma_s8(o[2 * kk], pa, bv[0], bv[1]);
      mma_s8(o[2 * kk + 1], pa, bv[2], bv[3]);
    }
  }
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], m);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= s) continue;
    bf16* orow = out + (static_cast<size_t>(img) * s + row) * d +
                 static_cast<size_t>(h) * dh;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      const int c = 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (c + e < dh)
          orow[c + e] = __float2bfloat16_rn(attn_combine<bf16, kAttnQcore>(
              __int2float_rn(o[j][2 * r + e]), l[r], &ap, av));
    }
  }
}

// Query rows q0 .. q0 + 16 (THREADS / 32 / P) - 1 of head h of image img,
// as attention_tile<bf16> (attention_core.cuh) takes them, on the block's
// THREADS threads: K4's 128 with P = 1, NK = min(dh' / 16, 8); K9's 256
// with the keys in P parts (1, 2, 4 or 8) and NK = attn_mma_nk_of(dh),
// whose steps past dh' are skipped. Uses attention_mma_smem(s, dh) +
// attn_mma_xbytes(THREADS / 32, P, NK) bytes of smem; a caller that runs
// several tiles synchronises the block between them. MODE (K23, on K4's
// block; NK = attn_mma_nk_of(dh), steps past dh' skipped) uses
// attn_mma_probe_smem(MODE, s, dh) bytes; tbuf and ldt serve kAttnKt (kT,
// (D, ldt)) and kAttnHeadMajor ([qT|kT|vT], (3D, ldt), out (D, ldt), dh'
// <= 128), as attention_tile takes them.
template <int NK, int P = 1, int THREADS = kAttnMmaThreads,
          int MODE = kAttnFull>
__device__ __forceinline__ void attention_tile_mma(
    const bf16* qkv, bf16* out, int s, int d, int dh, float scale,
    int seq_len, int img, int h, int q0, unsigned char* smem,
    const bf16* tbuf = nullptr, int ldt = 0) {
  static_assert(MODE == kAttnFull || (P == 1 && THREADS == kAttnMmaThreads),
                "K23's modes run on K4's block");
  if constexpr (MODE == kAttnQcore) {
    attention_tile_mma_qcore<NK>(qkv, out, s, d, dh, scale, seq_len, img, h,
                                 q0, smem);
  } else {
  // K9 and K23's modes: NK may pass dh' / 16.
  constexpr bool kRound = P > 1 || MODE != kAttnFull;
  constexpr bool kAll = attn_all_keys(MODE);  // every key of S scored
  constexpr bool kSlabK = MODE == kAttnKt || MODE == kAttnHeadMajor;
  constexpr bool kHm = MODE == kAttnHeadMajor;
  constexpr int kWarps = THREADS / 32, kRowWarps = kWarps / P;
  static_assert(kRowWarps * P == kWarps, "P divides the block's warps");
  const int dhp = attn_mma_dhp(dh), ld = dhp + 8;
  const int kr = (s + 15) / 16 * 16;           // K's rows, V's offset
  const int kvalid = kAll ? s : seq_len;       // keys read
  const int kend = (kvalid + 15) / 16 * 16;    // keys walked
  // K and V: rows of ld (K4, K9), or feature-major slabs of ldsl (kt's
  // K; head-major's K and V, then q's 64 tokens).
  const int ldsl = kr + 8, ldq = kAttnQT + 8;
  const int ldk = kSlabK ? ldsl : ld;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + static_cast<size_t>(kr) * ld;
  if constexpr (kSlabK) vs = ks + static_cast<size_t>(dhp) * ldsl;
  bf16* qsl = vs + static_cast<size_t>(dhp) * ldsl;  // head-major's q
  const size_t ldg = 3 * static_cast<size_t>(d);
  const bf16* base = kHm ? nullptr
                         : qkv + static_cast<size_t>(img) * s * ldg +
                               static_cast<size_t>(h) * dh;
  const bool vec = dh % 8 == 0 && d % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  // The transposed buffers' token rows are 16-byte aligned for cp.async.
  const bool tvec = s % 8 == 0 && ldt % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(tbuf) % 16 == 0;
  const bf16* tcol = tbuf + static_cast<size_t>(h) * dh * ldt +
                     static_cast<size_t>(img) * s;  // q's feature rows

  if constexpr (kSlabK) {
    stage_slab(ks, ldsl, tcol + (kHm ? static_cast<size_t>(d) * ldt : 0),
               ldt, dhp, dh, kvalid, kend, tvec);
    if constexpr (kHm)
      stage_slab(qsl, ldq, tcol + q0, ldt, dhp, dh, min(s - q0, kAttnQT),
                 kAttnQT, tvec);
  } else {
    stage_rows(ks, ld, base + d, ldg, kend, kvalid, dh, dhp, vec);
  }
  cp_async_commit();
  if constexpr (kHm)
    stage_slab(vs, ldsl, tcol + 2 * static_cast<size_t>(d) * ldt, ldt, dhp,
               dh, kvalid, kend, tvec);
  else
    stage_rows(vs, ld, base + 2 * d, ldg, kend, kvalid, dh, dhp, vec);
  cp_async_commit();

  const int lane = threadIdx.x % 32, t = lane & 3, warp = threadIdx.x / 32;
  const int r0 = q0 + 16 * (warp % kRowWarps);  // the warp's first row
  // The warp's keys [kb, ke): part warp / kRowWarps of kend / 16 steps.
  const int part = P == 1 ? 0 : warp / kRowWarps, steps = kend / 16;
  const int kb = P == 1 ? 0 : 16 * (part * steps / P);
  const int ke = P == 1 ? kend : 16 * ((part + 1) * steps / P);
  const bool active = r0 < s;
  const bf16* q = kHm ? nullptr : base + static_cast<size_t>(r0) * ldg;
  const int qrows = s - r0;  // rows at or past S are zero
  const int nb = (dhp + 16 * NK - 1) / (16 * NK);
  uint32_t qf[NK][4];
  if (!kHm && active && nb == 1) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      if (!kRound || 16 * kk < dhp)
        load_a_global(qf[kk], q, ldg, qrows, 16 * kk, dh, lane);
  }
  // The lane's rows are r0 + lane/4 (index 0) and r0 + lane/4 + 8 (1); its
  // columns of a C tile j are keys (or context columns) 8j + 2t, + 1.
  auto scaled = [&](float raw, int key) {
    if constexpr (MODE == kAttnMxu)  // p = s; keys past S add nothing
      return key < s ? __fmul_rn(raw, scale) : 0.f;
    else if constexpr (MODE == kAttnAddMask)  // the mask as a row
      return key < s ? __fadd_rn(__fmul_rn(raw, scale),
                                 key < seq_len ? 0.f : -INFINITY)
                     : -INFINITY;
    else
      return key < kvalid ? __fmul_rn(raw, scale) : -INFINITY;
  };
  // The key-split exchange (P > 1): value v of warp slot w at
  // (w * values + v) * 32 + lane; parts 1 .. P-1 hold sum and context
  // slots warp - kRowWarps.
  float* xmax = reinterpret_cast<float*>(smem + attention_mma_smem(s, dh));
  float* xsum = xmax + 2 * 32 * kWarps;
  float* xctx = xsum + 2 * 32 * (kWarps - kRowWarps);

  cp_async_wait<1>();
  __syncthreads();
  if constexpr (kHm) {  // q's A fragments from its staged slab
    if (active) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        if (16 * kk < dhp)
          ldmatrix_a_trans(qf[kk], qsl, ldq, 16 * kk, r0 - q0, lane);
    }
  }
  // Pass 1: the row max over the warp's keys (mxu has none).
  float mx[2] = {-INFINITY, -INFINITY};
  if (active && MODE != kAttnMxu) {
    for (int k0 = kb; k0 < ke; k0 += kAttnMmaChunk) {
      attn_mma_groups(min(ke - k0, kAttnMmaChunk) / 16, [&](auto groups) {
        constexpr int G = decltype(groups)::value;
        float sc[2 * G][4];
        attn_mma_scores<NK, G, kRound, kSlabK>(
            sc, qf, q, ldg, qrows, dh, kSlabK ? ks + k0 : ks + k0 * ld, ldk,
            dhp, nb, lane);
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
  // wide: l = the sum of the unrounded p, in a pass of its own, before
  // pass 2 rounds p / l.
  float lw[2] = {1.f, 1.f};
  if constexpr (MODE == kAttnWide) {
    lw[0] = lw[1] = 0.f;
    for (int k0 = kb; active && k0 < ke; k0 += kAttnMmaChunk) {
      attn_mma_groups(min(ke - k0, kAttnMmaChunk) / 16, [&](auto groups) {
        constexpr int G = decltype(groups)::value;
        float sc[2 * G][4];
        attn_mma_scores<NK, G, kRound>(sc, qf, q, ldg, qrows, dh,
                                       ks + k0 * ld, ld, dhp, nb, lane);
#pragma unroll
        for (int j = 0; j < 2 * G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            lw[e >> 1] += expf(
                scaled(sc[j][e], k0 + 8 * j + 2 * t + (e & 1)) - mx[e >> 1]);
      });
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lw[r] += __shfl_xor_sync(0xffffffffu, lw[r], m);
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
        attn_mma_scores<NK, G, kRound, kSlabK>(
            sc, qf, q, ldg, qrows, dh, kSlabK ? ks + k0 : ks + k0 * ld, ldk,
            dhp, nb, lane);
#pragma unroll
        for (int j = 0; j < 2 * G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if constexpr (MODE == kAttnMxu) {
              sc[j][e] = scaled(sc[j][e], key);
            } else {
              sc[j][e] = expf(scaled(sc[j][e], key) - mx[e >> 1]);
              if constexpr (MODE == kAttnVsum)  // the sum of the rounded p
                l[e >> 1] += __bfloat162float(__float2bfloat16_rn(sc[j][e]));
              else
                l[e >> 1] += sc[j][e];
              if constexpr (MODE == kAttnWide)
                sc[j][e] = sc[j][e] / lw[e >> 1];
            }
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
            if constexpr (kHm)
              ldmatrix_b_kmajor(bv, vs + k0, ldsl, n0 + 16 * kk, 16 * g,
                                lane);
            else
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
      const float lr = attn_unit_sum(MODE) ? 1.f : l[r];
      if constexpr (kHm) {  // feature-major: out (D, ldt)
        bf16* ocol = out + static_cast<size_t>(h) * dh * ldt +
                     static_cast<size_t>(img) * s + row;
#pragma unroll
        for (int j = 0; j < 2 * NK; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + 8 * j + 2 * t + e;
            if (c < dh)
              ocol[static_cast<size_t>(c) * ldt] = __float2bfloat16_rn(
                  attn_combine<bf16, MODE>(o[j][2 * r + e], lr, nullptr, 0.f));
          }
        continue;
      }
      bf16* orow = out + (static_cast<size_t>(img) * s + row) * d +
                   static_cast<size_t>(h) * dh;
#pragma unroll
      for (int j = 0; j < 2 * NK; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c >= dh) continue;
        const float v0 = attn_combine<bf16, MODE>(o[j][2 * r], lr, nullptr,
                                                  0.f),
                    v1 = attn_combine<bf16, MODE>(o[j][2 * r + 1], lr,
                                                  nullptr, 0.f);
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
}

}  // namespace vit
