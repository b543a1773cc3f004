// The fp32 attention core on the tensor cores as a device routine: the work
// of attention_tile<float> (attention_core.cuh) for one (image, head,
// 64-query tile), both products on mma.sync m16n8k8 tf32 in the three-pass
// split of tf32_split.cuh, through flash_tf32.cuh's routines. K4's fp32 core
// (attention_tf32.cu) is its kAttnFull instantiation; the attention probe
// K23 (attn_core_probe_tf32_*.cu) runs it in each of its modes, a template
// parameter (attention_core.cuh's AttnMode).
//
// _attn_core's function (vit_tpu/ops/pallas/block.py:675-692) in fp32:
//   s = (q . k) * scale, keys at index >= seq_len masked;
//   p = exp(s - max), l = sum(p), ctx = (p v) / l.
// The Pallas fp32 dots run at Precision.HIGHEST; the split keeps about 22
// bits of each operand, and one accumulator a product holds the 1e-4 bar
// at these contractions (head widths and key counts of 16-600; PERF.md
// section 6).
//
// Design: a block of four warps, 16 query rows each (the bf16 core's
// block, attention_mma.cuh). The head's K and V rows below seq_len are
// staged once, fp32, by cp.async, in rows of dh' + 4 floats (dh' the head
// width zero-padded to 8 columns; the 4-float pad makes every fragment
// load touch 32 banks), keys zero-padded to a multiple of 8; K first, so
// that the first scores run while V arrives. A warp's q rows go into split
// A fragments in registers (8 NK <= 64 columns held; wider heads walk
// blocks of 64 columns, q read again from device memory for each block of
// the scores, and the walk repeated for each block of the context). The
// keys are walked in tiles of 64 with the online softmax of flash_tf32.cuh
// (a running max): s on mma.sync, the first tile's while V arrives, p
// split where its C fragment left it (the permuted k order) as the A
// operand of ctx += p v, 8-key tiles past the last real key not
// multiplied; ctx = o / l leaves from registers.
//
// Shared memory 2 * ceil8(S) * (dh' + 4) * 4 bytes (113 KB at S = 208,
// d = 64; two blocks an SM): at every geometry ops.attn_plan admits it is
// at most the FFMA tile's (K, V, Q and the 64 x S scores), which the gate
// reads (tests/test_torch_fp32_attention.py enumerates them).
//
// K23's modes change only what each names (attention_core.cuh gives the
// list; tests/test_torch_probe_tf32.py models each in PyTorch):
// - the unmasked modes (attn_all_keys) stage and walk ceil8(S) keys, the
//   keys past S at -inf (mxu: p = 0); addmask adds the mask to each raw
//   score of the keys below S;
// - mxu takes p = s: no max, no exp, no rescaling; vsum takes l as the sum
//   of the p it multiplies, hi + lo with lo's low 13 bits dropped (what
//   the tensor cores read of the split p); wide (heads paired by the
//   caller, dh = 2 hd) takes the row max and l in a pass of its own over
//   the keys, while V arrives, then walks p / l with the max fixed; the
//   context is combined as the mode says (attn_combine, T = float);
// - kt stages the head's dh x S slab of the transposed K where it lies
//   (features by tokens, rows of ceil16(S) + 8 floats: the scores' B
//   fragments, B(k, n) = K^T(k, n), then touch 32 banks); head-major
//   stages K's and V's slabs the same way (V's B fragments two keys of a
//   feature as one 8-byte load, 32 banks a half-warp), reads q's A
//   fragments from its slab in device memory and writes the context
//   feature-major;
// - qcore (attention_tile_tf32_qcore) codes q, k and v into int8 values
//   held as fp32, exact in TF32 (|code| <= 127), so one TF32 pass a
//   product sums them exactly (the integer sums stay below 2^24 up to
//   about 1000 keys), after a pass for the row max: p's codes take the
//   scale 1 / 127 of the true row max, as the plain version's do.
//
// Bound on the card at B/16 bs=32 (384 heads, 197 of 208 keys, d = 64):
// operations, 4 * B * H * S * seq_len * d = 4.03 GFLOP in three TF32
// passes at 495 TFLOP/s, 0.0244 ms, beside 0.0244 ms for q, k, v in and
// the context out (81.8 MB at 3.35 TB/s).

#pragma once

#include "attention_core.cuh"
#include "flash_tf32.cuh"

namespace vit {

constexpr int kAttnTf32Threads = 128;  // four warps of 16 query rows
constexpr int kAttnTf32MaxK = 8;       // 8-column slices of q held at once

// Row stride (floats) of K23's feature-major slabs at S tokens: ceil16(S) +
// 8, 8 or 24 modulo 32 banks.
__host__ __device__ inline int attn_tf32_ldsl(int s) {
  return (s + 15) / 16 * 16 + 8;
}

// Dynamic shared memory of the fp32 core in `mode` (K4's, kAttnFull:
// attention_tf32_smem; vit_tpu_torch/tools/attn_core_probe.py:
// core_smem_bytes computes the same): kt's K slab beside V's rows, the
// head-major slabs of K and V, qcore's 8 floats more for the scales'
// block reduction.
__host__ __device__ inline size_t attn_tf32_probe_smem(int mode, int s,
                                                       int dh) {
  const size_t kr = (s + 7) / 8 * 8, dhp = attn_tf32_dhp(dh);
  const size_t ld = dhp + 4, ldsl = attn_tf32_ldsl(s);
  size_t floats = 2 * kr * ld;
  if (mode == kAttnKt) floats = dhp * ldsl + kr * ld;
  if (mode == kAttnHeadMajor) floats = 2 * dhp * ldsl;
  if (mode == kAttnQcore) floats += 8;
  return floats * sizeof(float);
}

// Rows [0, rows) of an fp32 slab in shared memory (row stride ldd, 16-byte
// aligned rows): row r < nvalid holds source row r (row stride lds) at
// columns [0, cols) and zeros at [cols, padded); every row >= nvalid is
// zero. A chunk of 4 columns goes by cp.async (to be committed and waited
// for by the caller) where vec and the chunk lies below cols, element by
// element elsewhere: the slabs' columns are tokens, which end at seq_len
// inside a chunk.
__device__ __forceinline__ void stage_slab_f32(float* dst, int ldd,
                                               const float* src, size_t lds,
                                               int rows, int nvalid, int cols,
                                               int padded, bool vec) {
  const int chunks = padded / 4;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, c = (e % chunks) * 4;
    float* dp = dst + r * ldd + c;
    if (r < nvalid && c < cols) {
      const float* sp = src + r * lds + c;
      if (vec && c + 4 <= cols) {
        cp_async16(dp, sp);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[i] = c + i < cols ? sp[i] : 0.f;
      }
    } else {
      *reinterpret_cast<float4*>(dp) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// tf32_a_global's fragment of a feature-major slab in device memory: A(r,
// c) = src[c * ldc + r] (tokens contiguous); rows at or past nrows and
// columns at or past ncols are zero.
__device__ __forceinline__ void tf32_a_cols(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4],
                                            const float* src, size_t ldc,
                                            int nrows, int c0, int ncols,
                                            int lane) {
  const int r = lane / 4, c = c0 + lane % 4;
  const float* p = src + c * ldc + r;
  const bool r0 = r < nrows, r1 = r + 8 < nrows;
  const bool c0k = c < ncols, c1k = c + 4 < ncols;
  split_tf32(r0 && c0k ? p[0] : 0.f, hi[0], lo[0]);
  split_tf32(r1 && c0k ? p[8] : 0.f, hi[1], lo[1]);
  split_tf32(r0 && c1k ? p[4 * ldc] : 0.f, hi[2], lo[2]);
  split_tf32(r1 && c1k ? p[4 * ldc + 8] : 0.f, hi[3], lo[3]);
}

// What the tensor cores read of a split value: hi + lo with lo's low 13
// bits dropped (vsum's p).
__device__ __forceinline__ float tf32_read(uint32_t hi, uint32_t lo) {
  return __uint_as_float(hi) + __uint_as_float(lo & 0xFFFFE000u);
}

// qcore: attention_tile<float, kAttnQcore>'s function on the tensor cores,
// K4's fp32 block. K and V are staged over all S rows, whose absmax gives
// the head's scales, then coded in place; a warp's q rows are coded with a
// scale a row (their absmax over dh) into A fragments. Pass 1 takes the
// row max of (q . k) * (aq * (ak * scale)) over the keys below seq_len;
// pass 2 forms p = exp(s - max), l += p, p's codes (scale 1 / 127: the row
// max of p is exp(0) = 1) and ctx += codes . v codes, then ctx * (ap * av)
// / l once (attn_combine). Every product is one TF32 pass on exact codes.
template <int NK>
__device__ __forceinline__ void attention_tile_tf32_qcore(
    const float* qkv, float* out, int s, int d, int dh, float scale,
    int seq_len, int img, int h, int q0, unsigned char* smem) {
  constexpr int kWarps = kAttnTf32Threads / 32;
  const int dhp = attn_tf32_dhp(dh), ld = dhp + 4;
  const int kr = (s + 7) / 8 * 8, kend = (seq_len + 7) / 8 * 8;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + static_cast<size_t>(kr) * ld;
  float* red = vs + static_cast<size_t>(kr) * ld;
  const size_t ldg = 3 * static_cast<size_t>(d);
  const float* base = qkv + static_cast<size_t>(img) * s * ldg +
                      static_cast<size_t>(h) * dh;
  const bool vec = dh % 4 == 0 && d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  stage_rows_f32(ks, ld, base + d, ldg, kr, s, dh, dhp, vec);
  stage_rows_f32(vs, ld, base + 2 * d, ldg, kr, s, dh, dhp, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x % 32, t = lane & 3, g = lane / 4;
  const int warp = threadIdx.x / 32;
  // The head's k and v scales over its S rows (padding is zero).
  const int cpr = dhp / 4;  // 16-byte chunks of a staged row
  float mk = 0.f, mv = 0.f;
  for (int e = threadIdx.x; e < s * cpr; e += kAttnTf32Threads) {
    const int off = (e / cpr) * ld + (e % cpr) * 4;
    const float4 kw = *reinterpret_cast<const float4*>(ks + off);
    const float4 vw = *reinterpret_cast<const float4*>(vs + off);
    mk = fmaxf(mk, fmaxf(fmaxf(fabsf(kw.x), fabsf(kw.y)),
                         fmaxf(fabsf(kw.z), fabsf(kw.w))));
    mv = fmaxf(mv, fmaxf(fmaxf(fabsf(vw.x), fabsf(vw.y)),
                         fmaxf(fabsf(vw.z), fabsf(vw.w))));
  }
  mk = warp_max(mk);
  mv = warp_max(mv);
  if (lane == 0) {
    red[warp] = mk;
    red[kWarps + warp] = mv;
  }
  __syncthreads();
  mk = 0.f;
  mv = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    mk = fmaxf(mk, red[w]);
    mv = fmaxf(mv, red[kWarps + w]);
  }
  const float ak = quant_scale(mk), av = quant_scale(mv);
  const float qk_scale = __fmul_rn(ak, scale);
  for (int e = threadIdx.x; e < s * cpr; e += kAttnTf32Threads) {
    float* kp = ks + (e / cpr) * ld + (e % cpr) * 4;
    float* vp = vs + (e / cpr) * ld + (e % cpr) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      kp[i] = static_cast<float>(quant_code(kp[i], ak));
      vp[i] = static_cast<float>(quant_code(vp[i], av));
    }
  }
  __syncthreads();

  const int r0 = q0 + 16 * warp;  // the warp's first row
  if (r0 >= s) return;
  const float* q = base + static_cast<size_t>(r0) * ldg;
  const int qrows = s - r0;  // rows at or past S are zero
  // The scales of the lane's rows g and g + 8, over every column.
  float aq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    aq[r] = 0.f;
    if (g + 8 * r < qrows)
      for (int c = t; c < dh; c += 4)
        aq[r] = fmaxf(aq[r], fabsf(q[(g + 8 * r) * ldg + c]));
  }
  quad_reduce(aq, [](float x, float y) { return fmaxf(x, y); });
  aq[0] = quant_scale(aq[0]);
  aq[1] = quant_scale(aq[1]);
  const int ksl = dhp / 8, nb = (ksl + NK - 1) / NK;
  uint32_t qa[NK][4];
  auto load_q = [&](int b) {  // q's codes of column block b
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = g + 8 * (i & 1);
        const int col = 8 * (NK * b + kk) + t + 4 * (i >> 1);
        const float x = row < qrows && col < dh ? q[row * ldg + col] : 0.f;
        qa[kk][i] = __float_as_uint(
            static_cast<float>(quant_code(x, aq[i & 1])));
      }
  };
  if (nb == 1) load_q(0);
  // Raw integer scores of the 64-key tile at k0 (8-key C tiles below
  // kend), one TF32 pass a product.
  auto scores = [&](float (&sc)[8][4], int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const int nt = min(kend - k0, 64) / 8;
    for (int b = 0; b < nb; ++b) {
      if (nb > 1) load_q(b);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        if (NK * b + kk >= ksl) break;
        const float* p = ks + (k0 + g) * ld + 8 * (NK * b + kk) + t;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          if (n < nt)
            mma_tf32(sc[n], qa[kk], __float_as_uint(p[8 * n * ld]),
                     __float_as_uint(p[8 * n * ld + 4]));
      }
    }
  };
  auto scaled = [&](float raw, int key, int r) {
    return key < seq_len ? __fmul_rn(raw, __fmul_rn(aq[r], qk_scale))
                         : -INFINITY;
  };
  float sc[8][4], mx[2] = {-INFINITY, -INFINITY};
  for (int k0 = 0; k0 < kend; k0 += 64) {
    scores(sc, k0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1],
                           scaled(sc[j][e], k0 + 8 * j + 2 * t + (e & 1),
                                  e >> 1));
  }
  quad_reduce(mx, [](float x, float y) { return fmaxf(x, y); });

  const float ap = quant_scale(1.f);
  for (int n0 = 0; n0 < dhp; n0 += 8 * NK) {
    float o[NK][4], l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += 64) {
      scores(sc, k0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(scaled(sc[j][e], k0 + 8 * j + 2 * t + (e & 1),
                                      e >> 1) -
                               mx[e >> 1]);
          l[e >> 1] += p;
          sc[j][e] = static_cast<float>(quant_code(p, ap));
        }
      const int nt = min(kend - k0, 64) / 8;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= nt) break;
        // p's codes in the permuted order (tf32_a_of_c), V's rows k0 + 8kk
        // + 2t and + 1 in their place.
        const uint32_t pa[4] = {
            __float_as_uint(sc[kk][0]), __float_as_uint(sc[kk][2]),
            __float_as_uint(sc[kk][1]), __float_as_uint(sc[kk][3])};
        const float* p = vs + (k0 + 8 * kk + 2 * t) * ld + n0 + g;
#pragma unroll
        for (int j = 0; j < NK; ++j)
          if (n0 + 8 * j < dhp)
            mma_tf32(o[j], pa, __float_as_uint(p[8 * j]),
                     __float_as_uint(p[ld + 8 * j]));
      }
    }
    quad_reduce(l, [](float x, float y) { return x + y; });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= s) continue;
      float* orow = out + (static_cast<size_t>(img) * s + row) * d +
                    static_cast<size_t>(h) * dh;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + 8 * j + 2 * t + e;
          if (c < dh)
            orow[c] = attn_combine<float, kAttnQcore>(o[j][2 * r + e], l[r],
                                                      &ap, av);
        }
    }
  }
}

// Query rows q0 .. q0 + 63 of head h of image img, as attention_tile<float>
// (attention_core.cuh) takes them, on the block's kAttnTf32Threads threads,
// NK 8-column slices of q held at once (K4: min(dh' / 8, 8); K23's other
// modes 8, slices past dh' skipped). Uses attn_tf32_probe_smem(MODE, s,
// dh) bytes of smem. tbuf and ldt serve kAttnKt (kT, (D, ldt)) and
// kAttnHeadMajor ([qT|kT|vT], (3D, ldt), out (D, ldt)), as attention_tile
// takes them.
template <int NK, int MODE = kAttnFull>
__device__ __forceinline__ void attention_tile_tf32(
    const float* qkv, float* out, int s, int d, int dh, float scale,
    int seq_len, int img, int h, int q0, unsigned char* smem,
    const float* tbuf = nullptr, int ldt = 0) {
  if constexpr (MODE == kAttnQcore) {
    attention_tile_tf32_qcore<NK>(qkv, out, s, d, dh, scale, seq_len, img,
                                  h, q0, smem);
  } else {
  constexpr bool kAll = attn_all_keys(MODE);  // every key of S scored
  constexpr bool kSlabK = MODE == kAttnKt || MODE == kAttnHeadMajor;
  constexpr bool kHm = MODE == kAttnHeadMajor;
  const int dhp = attn_tf32_dhp(dh), ld = dhp + 4;
  const int kvalid = kAll ? s : seq_len;   // keys read
  const int kend = (kvalid + 7) / 8 * 8;  // keys staged and walked
  // K and V: rows of ld, or feature-major slabs of ldsl (kt's K;
  // head-major's K and V).
  const int ldsl = attn_tf32_ldsl(s);
  const int ldk = kSlabK ? ldsl : ld, ldv = kHm ? ldsl : ld;
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + static_cast<size_t>((s + 7) / 8 * 8) * ld;
  if constexpr (kSlabK) vs = ks + static_cast<size_t>(dhp) * ldsl;
  const size_t ldg = 3 * static_cast<size_t>(d);
  const float* base = kHm ? nullptr
                          : qkv + static_cast<size_t>(img) * s * ldg +
                                static_cast<size_t>(h) * dh;
  const bool vec = dh % 4 == 0 && d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  // The transposed buffers' token rows are 16-byte aligned for cp.async.
  const bool tvec = s % 4 == 0 && ldt % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(tbuf) % 16 == 0;
  const float* tcol = tbuf + static_cast<size_t>(h) * dh * ldt +
                      static_cast<size_t>(img) * s;  // q's feature rows
  if constexpr (kSlabK)
    stage_slab_f32(ks, ldsl, tcol + (kHm ? static_cast<size_t>(d) * ldt : 0),
                   ldt, dhp, dh, kvalid, kend, tvec);
  else
    stage_rows_f32(ks, ld, base + d, ldg, kend, kvalid, dh, dhp, vec);
  cp_async_commit();
  if constexpr (kHm)
    stage_slab_f32(vs, ldsl, tcol + 2 * static_cast<size_t>(d) * ldt, ldt,
                   dhp, dh, kvalid, kend, tvec);
  else
    stage_rows_f32(vs, ld, base + 2 * d, ldg, kend, kvalid, dh, dhp, vec);
  cp_async_commit();

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = q0 + 16 * (threadIdx.x / 32);  // the warp's first row
  const bool active = r0 < s;
  const float* q = kHm ? tcol + r0 : base + static_cast<size_t>(r0) * ldg;
  const int qrows = s - r0;                // rows at or past S are zero
  const int ksl = dhp / 8;                 // 8-column slices of q
  const int nb = (ksl + NK - 1) / NK;      // blocks of 8 NK columns
  const float scale2 = scale * kLog2e;
  uint32_t qh[NK][4], ql[NK][4];
  // q's split A fragment of slice kk at column c.
  auto load_q = [&](int kk, int c) {
    if constexpr (kHm)
      tf32_a_cols(qh[kk], ql[kk], q, ldt, qrows, c, dh, lane);
    else
      tf32_a_global(qh[kk], ql[kk], q, ldg, qrows, c, dh, lane);
  };
  if (active && nb == 1) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) load_q(kk, 8 * kk);
  }
  // Raw scores of the 64-key tile at k0 (8-key C tiles below kend), q's
  // column blocks summed in order.
  auto scores = [&](float (&sc)[8][4], int k0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const int nt = min(kend - k0, 64) / 8;
    for (int b = 0; b < nb; ++b) {
      const int c0 = 8 * NK * b;
      if (nb > 1) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) load_q(kk, c0 + 8 * kk);
      }
      tf32_qkt<NK, 64, kSlabK>(
          sc,
          [&](int kk, uint32_t(&ah)[4], uint32_t(&al)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[i] = qh[kk][i];
              al[i] = ql[kk][i];
            }
          },
          kSlabK ? ks + static_cast<size_t>(c0) * ldsl + k0
                 : ks + static_cast<size_t>(k0) * ld + c0,
          ldk, nt, min(NK, ksl - NK * b), lane);
    }
  };

  cp_async_wait<1>();
  __syncthreads();  // K has landed
  float sc[8][4];
  if (active) scores(sc, 0);  // while V arrives
  // wide: the row max and l in a pass of their own over the keys, while V
  // arrives (the walk below recomputes the first tile's scores).
  float mw[2] = {-INFINITY, -INFINITY}, lw[2] = {0.f, 0.f};
  if constexpr (MODE == kAttnWide) {
    for (int k0 = 0; active && k0 < kend; k0 += 64) {
      if (k0 > 0) scores(sc, k0);
      float mt[2] = {mw[0], mw[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = k0 + 8 * j + 2 * t + (e & 1) < kvalid
                         ? sc[j][e] * scale2
                         : -INFINITY;
          mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
        }
      quad_reduce(mt, [](float x, float y) { return fmaxf(x, y); });
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lw[r] *= ex2(mw[r] - mt[r]);
        mw[r] = mt[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) lw[e >> 1] += ex2(sc[j][e] - mw[e >> 1]);
    }
    quad_reduce(lw, [](float x, float y) { return x + y; });
  }
  cp_async_wait<0>();
  __syncthreads();  // V has landed
  if (!active) return;

  // The walk, once for each block of 8 NK context columns.
  for (int n0 = 0; n0 < dhp; n0 += 8 * NK) {
    float o[NK][4], l[2] = {0.f, 0.f}, m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += 64) {
      if (n0 > 0 || k0 > 0 || MODE == kAttnWide) scores(sc, k0);
      if constexpr (MODE == kAttnMxu) {  // p = s; keys past S add nothing
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[j][e] = k0 + 8 * j + 2 * t + (e & 1) < s
                           ? __fmul_rn(sc[j][e], scale)
                           : 0.f;
      } else if constexpr (MODE == kAttnWide) {  // p / l, the max fixed
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[j][e] = k0 + 8 * j + 2 * t + (e & 1) < kvalid
                           ? ex2(sc[j][e] * scale2 - mw[e >> 1]) / lw[e >> 1]
                           : 0.f;
      } else {
        if constexpr (MODE == kAttnAddMask) {  // the mask as a row
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[j][e] = __fadd_rn(sc[j][e],
                                   k0 + 8 * j + 2 * t + (e & 1) < seq_len
                                       ? 0.f
                                       : -INFINITY);
        }
        online_step<NK, MODE != kAttnVsum>(sc, o, m, l, scale2, kvalid - k0,
                                           lane);
      }
      const int nt = min(kend - k0, 64) / 8;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= nt) break;
        uint32_t ph[4], pl[4];
        tf32_a_of_c(ph, pl, sc[kk]);
        if constexpr (MODE == kAttnVsum) {  // l of the p multiplied
          l[0] += tf32_read(ph[0], pl[0]) + tf32_read(ph[2], pl[2]);
          l[1] += tf32_read(ph[1], pl[1]) + tf32_read(ph[3], pl[3]);
        }
        tf32_pv<NK, kHm>(o, ph, pl, kHm ? vs + n0 * ldsl : vs + n0,
                         k0 + 8 * kk, ldv, (dhp - n0) / 8, lane);
      }
    }
    quad_reduce(l, [](float x, float y) { return x + y; });
    // A context element of row r from its sum: K4's o / l, or as MODE
    // combines them.
    auto ctx = [&](float acc, int r) {
      if constexpr (MODE == kAttnFull)
        return acc / l[r];
      else
        return attn_combine<float, MODE>(
            acc, attn_unit_sum(MODE) ? 1.f : l[r], nullptr, 0.f);
    };
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + lane / 4 + 8 * r;
      if (row >= s) continue;
      if constexpr (kHm) {  // feature-major: out (D, ldt)
        float* ocol = out + static_cast<size_t>(h) * dh * ldt +
                      static_cast<size_t>(img) * s + row;
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + 8 * j + 2 * t + e;
            if (c < dh)
              ocol[static_cast<size_t>(c) * ldt] = ctx(o[j][2 * r + e], r);
          }
        continue;
      }
      float* orow = out + (static_cast<size_t>(img) * s + row) * d +
                    static_cast<size_t>(h) * dh;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c >= dh) continue;
        const float v0 = ctx(o[j][2 * r], r), v1 = ctx(o[j][2 * r + 1], r);
        if (dh % 2 == 0) {  // c and the row offset even: an 8-byte store
          *reinterpret_cast<float2*>(orow + c) = make_float2(v0, v1);
        } else {
          orow[c] = v0;
          if (c + 1 < dh) orow[c + 1] = v1;
        }
      }
    }
  }
  }
}

}  // namespace vit
