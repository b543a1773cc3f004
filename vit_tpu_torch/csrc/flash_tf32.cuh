// The attention tiles' fp32 routines on the tensor cores, in the three-pass
// TF32 split of tf32_split.cuh: K13's fp32 form (flash_attention_bwd_tf32.cu),
// K7's (flash_attention_tf32.cu) and K4's fp32 core (attention_tf32.cu).
//
// mma.sync m16n8k8 tf32. Each operand is split into hi + lo as its fragment
// is loaded, lo_a hi_b + hi_a lo_b + hi_a hi_b into one fp32 accumulator.
// Tiles stay fp32 in shared memory (rows of HD + 4 floats: every fragment
// load below touches 32 banks) and are staged by cp.async; ldmatrix moves
// only 16-bit elements, so fragments come by ld.shared. A product whose A
// operand is a C fragment (p v, ds k, p^T g, ds^T q) takes its 8-deep
// contraction in a permuted order: the A fragment's k positions t and t + 4
// are the C fragment's columns 2t and 2t + 1, so c[0], c[2], c[1], c[3] are
// the A registers as they stand, and the B fragment reads rows 2t and
// 2t + 1 of its chunk in their place. The sums are the same; no register
// moves between lanes.
//
// wgmma.mma_async m64nNk8 tf32 (head widths 32 and 64): a warpgroup's
// products in three passes, A from registers (the rows of a raw fp32 tile,
// or a C tile in the permuted order), B a split K-major operand in shared
// memory with the 128-byte swizzle, which the block's threads write from a
// streamed tile's 4 x 4 blocks, as it lies or transposed. The softmax of
// the wgmma forms runs in base 2 (ex2, prob_r).

#pragma once

#include <math.h>

#include "flash_tiles.cuh"
#include "gemm_tf32.cuh"
#include "mma_frag.cuh"
#include "tf32_split.cuh"

namespace vit {

// stage_tile's fp32 form: rows [r0, r0 + 64) of a (S, HD) fp32 matrix (row
// stride ld) into a tile of row stride HD + 4, rows at or past s zero; vec:
// cp.async in 16-byte chunks (committed and waited for by the caller). By
// nthreads threads, this one tid among them.
template <int HD>
__device__ __forceinline__ void stage_tile_f32(float* dst, const float* src,
                                               long long ld, int r0, int s,
                                               bool vec, int tid = threadIdx.x,
                                               int nthreads = blockDim.x) {
  constexpr int LD = HD + 4, CH = HD / 4;
  for (int e = tid; e < kFaBQ * CH; e += nthreads) {
    const int r = e / CH, c = (e % CH) * 4;
    float* dp = dst + r * LD + c;
    if (r0 + r < s) {
      const float* sp = src + (r0 + r) * ld + c;
      if (vec) {
        cp_async16(dp, sp);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[i] = sp[i];
      }
    } else {
      *reinterpret_cast<float4*>(dp) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The split A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 7 of a
// row-major fp32 tile of stride ld.
__device__ __forceinline__ void tf32_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* s, int ld, int r0, int k0,
                                       int lane) {
  const float* p = s + (r0 + lane / 4) * ld + k0 + lane % 4;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * ld], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * ld + 4], hi[3], lo[3]);
}

// The split A fragment of two C values' 8-deep chunk in the permuted order
// (k positions t, t + 4 are columns 2t, 2t + 1).
__device__ __forceinline__ void tf32_a_of_c(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4],
                                            const float (&c)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// c[n] += the three passes of a b[n] for the split A fragment (ah, al) and
// the split B fragments of NT tiles, pass by pass over the tiles, so that
// consecutive mma.sync instructions write different accumulators.
template <int NT>
__device__ __forceinline__ void mma_tf32x3_tiles(float (*c)[4],
                                                 const uint32_t (&ah)[4],
                                                 const uint32_t (&al)[4],
                                                 const uint32_t (&bh)[NT][2],
                                                 const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(c[n], ah, bh[n][0], bh[n][1]);
}

// c (16 x N at columns n0 of b's rows) += a[r0 .. r0+15, 0 .. K) b^T for
// two row-major fp32 tiles of stride ld, three passes (mma_abt's form).
template <int K, int N>
__device__ __forceinline__ void tf32_abt(float (&c)[N / 8][4], const float* a,
                                         int r0, const float* b, int n0,
                                         int ld, int lane) {
#pragma unroll
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4], bh[N / 8][2], bl[N / 8][2];
    tf32_a(ah, al, a, ld, r0, k, lane);
#pragma unroll
    for (int n = 0; n < N; n += 8) {
      const float* p = b + (n0 + n + lane / 4) * ld + k + lane % 4;
      split_tf32(p[0], bh[n / 8][0], bl[n / 8][0]);
      split_tf32(p[4], bh[n / 8][1], bl[n / 8][1]);
    }
    mma_tf32x3_tiles<N / 8>(c, ah, al, bh, bl);
  }
}

// c (16 x N) += a b[k0 .. k0+7, 0 .. N): a the split A fragment of a C
// chunk (tf32_a_of_c's permuted order), b a row-major fp32 tile of stride
// ld whose rows k0 + 2t and k0 + 2t + 1 take k positions t and t + 4; up
// to 64 columns at a time (half of them above 64).
template <int N>
__device__ __forceinline__ void tf32_ab_perm(float (&c)[N / 8][4],
                                             const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             const float* b, int k0, int ld,
                                             int lane) {
  constexpr int NC = N <= 64 ? N : N / 2;
  const float* p = b + (k0 + 2 * (lane % 4)) * ld + lane / 4;
#pragma unroll
  for (int c0 = 0; c0 < N; c0 += NC) {
    uint32_t bh[NC / 8][2], bl[NC / 8][2];
#pragma unroll
    for (int n = 0; n < NC; n += 8) {
      split_tf32(p[c0 + n], bh[n / 8][0], bl[n / 8][0]);
      split_tf32(p[ld + c0 + n], bh[n / 8][1], bl[n / 8][1]);
    }
    mma_tf32x3_tiles<NC / 8>(c + c0 / 8, ah, al, bh, bl);
  }
}

// ------------------------------------------------------------ wgmma tf32 --

// Bytes of one split operand box (hi or lo): 64 rows of HD floats.
template <int HD>
constexpr int kWgBox = kFaBQ * HD * 4;

// c (64 x N over the warpgroup, mma.sync's C layout a warp) += the three
// passes of A B for a split K-major B operand (hi at bh, lo at bl: N rows,
// K in blocks of 32 floats, N * 128 bytes each) and A given as ah / al, the
// split A fragments of K / 8 slices.
template <int K, int N>
__device__ __forceinline__ void wg_issue(float (&c)[N / 8][4],
                                         const uint32_t (&ah)[K / 8][4],
                                         const uint32_t (&al)[K / 8][4],
                                         uint32_t bh, uint32_t bl) {
  float(&d)[N / 2] = reinterpret_cast<float(&)[N / 2]>(c);
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint32_t off = (kk >> 2) * N * 128 + (kk & 3) * 32;
    const uint64_t dh = wg::sw128_desc(bh + off, 16, 1024);
    const uint64_t dl = wg::sw128_desc(bl + off, 16, 1024);
    if constexpr (N == 64) {
      wgmma_tf32_n64(d, al[kk], dh);
      wgmma_tf32_n64(d, ah[kk], dl);
      wgmma_tf32_n64(d, ah[kk], dh);
    } else {
      static_assert(N == 32, "K13's wgmma tiles are 64 or 32 wide");
      wgmma_tf32_n32(d, al[kk], dh);
      wgmma_tf32_n32(d, ah[kk], dl);
      wgmma_tf32_n32(d, ah[kk], dh);
    }
  }
}

template <int N>
__device__ __forceinline__ void wg_fence_acc(float (&c)[N / 8][4]) {
  wg::fence_acc(reinterpret_cast<float(&)[N / 2]>(c));
}

// One product: its wgmma group issued, then waited for.
template <int K, int N>
__device__ __forceinline__ void wg_tf32x3(float (&c)[N / 8][4],
                                          const uint32_t (&ah)[K / 8][4],
                                          const uint32_t (&al)[K / 8][4],
                                          uint32_t bh, uint32_t bl) {
  wg_fence_acc<N>(c);
  wg::wgmma_fence();
  wg_issue<K, N>(c, ah, al, bh, bl);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg_fence_acc<N>(c);
}

// Two independent products in one wgmma group: the second's instructions
// queue behind the first's with no wait between them.
template <int K, int N>
__device__ __forceinline__ void wg_tf32x3_pair(
    float (&c1)[N / 8][4], const uint32_t (&ah1)[K / 8][4],
    const uint32_t (&al1)[K / 8][4], uint32_t bh1, uint32_t bl1,
    float (&c2)[N / 8][4], const uint32_t (&ah2)[K / 8][4],
    const uint32_t (&al2)[K / 8][4], uint32_t bh2, uint32_t bl2) {
  wg_fence_acc<N>(c1);
  wg_fence_acc<N>(c2);
  wg::wgmma_fence();
  wg_issue<K, N>(c1, ah1, al1, bh1, bl1);
  wg_issue<K, N>(c2, ah2, al2, bh2, bl2);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg_fence_acc<N>(c1);
  wg_fence_acc<N>(c2);
}

// The split A fragments of a raw fp32 tile's rows 16 warp .. (stride ld),
// K / 8 slices; and of a C tile (64 x K over the warpgroup) in the permuted
// order, which the transposed operands' K order follows.
template <int K>
__device__ __forceinline__ void wg_a_raw(uint32_t (&ah)[K / 8][4],
                                         uint32_t (&al)[K / 8][4],
                                         const float* a, int ld, int warp,
                                         int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk)
    tf32_a(ah[kk], al[kk], a, ld, 16 * warp, 8 * kk, lane);
}

template <int K>
__device__ __forceinline__ void wg_a_c(uint32_t (&ah)[K / 8][4],
                                       uint32_t (&al)[K / 8][4],
                                       const float (&p)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) tf32_a_of_c(ah[kk], al[kk], p[kk]);
}

// The wgmma form's softmax runs in base 2: s2 = (q k^T) * scale * log2(e),
// its row max m2 and p = 2^(s2 - m2) / l, one ex2.approx (relative error
// about 2^-22) in place of expf, and the product by 1 / l (rl) in place of
// the division. m2 is what launch (a) leaves in the stats for (b).
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float prob_r(float raw, bool keep, float scale2,
                                        float m2, float rl) {
  return keep ? ex2(raw * scale2 - m2) * rl : 0.f;
}

// c += A B for A the rows of a raw fp32 tile a (stride ld) or a C tile p.
template <int K, int N>
__device__ __forceinline__ void wg_raw_a(float (&c)[N / 8][4], const float* a,
                                         int ld, uint32_t bh, uint32_t bl,
                                         int warp, int lane) {
  uint32_t ah[K / 8][4], al[K / 8][4];
  wg_a_raw<K>(ah, al, a, ld, warp, lane);
  wg_tf32x3<K, N>(c, ah, al, bh, bl);
}

template <int K, int N>
__device__ __forceinline__ void wg_c_a(float (&c)[N / 8][4],
                                       const float (&p)[K / 8][4],
                                       uint32_t bh, uint32_t bl) {
  uint32_t ah[K / 8][4], al[K / 8][4];
  wg_a_c<K>(ah, al, p);
  wg_tf32x3<K, N>(c, ah, al, bh, bl);
}

// A streamed tile's 4 x 4 blocks, one a thread of the block (threads past
// 16 * HD / 4 take none): block e covers the tile's rows 8c + par + {0, 2,
// 4, 6} and columns 4q .. 4q + 3. With u = e % 8 (bits u0, u1, u2) and w =
// e / 8 (bits w0, w1, ...): par = u1, c = u2 + 2 (w >> (log2(HD / 4) - 1)),
// q = u0 + 2 (u1 ^ w0) + 4 (u2 ^ w1) + 8 (w >> 2 at HD = 64), a map under
// which the eight lanes of every 16-byte store phase, as they lie and
// transposed, hit eight distinct chunks of their rows: no bank conflict
// (tests/test_torch_fp32_split.py checks it). wg_load_block reads them
// from device memory (rows r0 + row of a (S, HD) matrix of row stride ld;
// rows at or past s zero); wg_store_block splits them into hi and lo
// K-major operands with the 128-byte swizzle: as they lie at nat (NAT; row
// r, column k at (k / 32) 64 * 128 + sw128_f32(r, k % 32); hi at nat, lo a
// box later) and transposed at tr (TR; row k, K position p at (p / 32) HD
// * 128 + sw128_f32(k, p % 32)), position 8c + i + 4 par holding tile row
// 8c + 2i + par (the permuted order).
template <int HD>
__device__ __forceinline__ bool wg_block(int& q, int& c, int& par) {
  constexpr int Q = HD / 4, QB = Q == 16 ? 4 : 3;
  static_assert(Q == 8 || Q == 16, "head widths 32 and 64");
  const int e = threadIdx.x;
  if (e >= 16 * Q) return false;
  const int u0 = e & 1, u1 = (e >> 1) & 1, u2 = (e >> 2) & 1, w = e >> 3;
  par = u1;
  c = u2 + 2 * (w >> (QB - 1));
  q = u0 + 2 * (u1 ^ (w & 1)) + 4 * (u2 ^ ((w >> 1) & 1)) +
      8 * ((w >> 2) & (Q / 8 - 1));
  return true;
}

template <int HD>
__device__ __forceinline__ void wg_load_block(float4 (&v)[4], const float* g,
                                              long long ld, int r0, int s,
                                              bool vec) {
  int q, c, par;
  if (!wg_block<HD>(q, c, par)) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + 8 * c + par + 2 * i;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < s) {
      const float* p = g + row * ld + 4 * q;
      if (vec) {
        v[i] = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        v[i] = make_float4(p[0], p[1], p[2], p[3]);
      }
    }
  }
}

template <int HD, bool NAT, bool TR>
__device__ __forceinline__ void wg_store_block(const float4 (&v)[4],
                                               uint32_t nat, uint32_t tr) {
  int q, c, par;
  if (!wg_block<HD>(q, c, par)) return;
  if constexpr (NAT) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tf::st_split4(nat, nat + kWgBox<HD>,
                    (q >> 3) * kFaBQ * 128 +
                        sw128_f32(8 * c + par + 2 * i, 4 * (q & 7)),
                    v[i].x, v[i].y, v[i].z, v[i].w);
  }
  if constexpr (TR) {
    const uint32_t col = (8 * c + 4 * par) & 31, at = (c >> 2) * HD * 128;
    tf::st_split4(tr, tr + kWgBox<HD>, at + sw128_f32(4 * q, col), v[0].x,
                  v[1].x, v[2].x, v[3].x);
    tf::st_split4(tr, tr + kWgBox<HD>, at + sw128_f32(4 * q + 1, col),
                  v[0].y, v[1].y, v[2].y, v[3].y);
    tf::st_split4(tr, tr + kWgBox<HD>, at + sw128_f32(4 * q + 2, col),
                  v[0].z, v[1].z, v[2].z, v[3].z);
    tf::st_split4(tr, tr + kWgBox<HD>, at + sw128_f32(4 * q + 3, col),
                  v[0].w, v[1].w, v[2].w, v[3].w);
  }
}


// ---------------------------------------------- the forwards' mma.sync --
//
// K4's fp32 core and K7's fp32 form (mma.sync) walk a row of keys in tiles
// of up to 64 with the online softmax in base 2 (ex2): s2 = (q . k) *
// scale * log2(e), m2 the running max, p = 2^(s2 - m2), and only the 8-key
// C tiles below the last real key are multiplied.

// Rows [0, rows) of an fp32 tile in shared memory (row stride ld floats,
// 16-byte aligned rows), staged by the block's threads in 4-float chunks:
// row r < nvalid is source row r (row stride ldg) with its columns >= cols
// zero, up to padded columns; every row >= nvalid is zero. vec: cols and
// the source rows allow 16-byte copies (cp.async, to be committed and
// waited for by the caller); otherwise element copies.
__device__ __forceinline__ void stage_rows_f32(float* dst, int ld,
                                               const float* src, size_t ldg,
                                               int rows, int nvalid, int cols,
                                               int padded, bool vec) {
  const int chunks = padded / 4;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, c = (e % chunks) * 4;
    float* dp = dst + r * ld + c;
    if (r < nvalid && c < cols) {
      const float* sp = src + r * ldg + c;
      if (vec) {
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

// tf32_a's fragment read from device memory (row stride ld): rows at or
// past nrows and columns at or past ncols are zero.
__device__ __forceinline__ void tf32_a_global(uint32_t (&hi)[4],
                                              uint32_t (&lo)[4],
                                              const float* src, size_t ld,
                                              int nrows, int c0, int ncols,
                                              int lane) {
  const int r = lane / 4, c = c0 + lane % 4;
  const float* p = src + r * ld + c;
  const bool r0 = r < nrows, r1 = r + 8 < nrows;
  const bool c0k = c < ncols, c1k = c + 4 < ncols;
  split_tf32(r0 && c0k ? p[0] : 0.f, hi[0], lo[0]);
  split_tf32(r1 && c0k ? p[8 * ld] : 0.f, hi[1], lo[1]);
  split_tf32(r0 && c1k ? p[4] : 0.f, hi[2], lo[2]);
  split_tf32(r1 && c1k ? p[8 * ld + 4] : 0.f, hi[3], lo[3]);
}

// c[n] += q b^T for the C tiles n < nt (8 keys each, keys 8n .. of the
// row-major fp32 tile b, stride ld) over the 8-deep slices kk < ks of KS:
// a(kk, hi, lo) gives q's split A fragment of slice kk; three passes, pass
// by pass over the tiles. KT: b is K^T, a feature-major slab (features
// along the rows of stride ld, keys contiguous: K23's kt and head-major
// cores), which is the B operand as it lies.
template <int KS, int N, bool KT = false, typename AF>
__device__ __forceinline__ void tf32_qkt(float (&c)[N / 8][4], AF&& a,
                                         const float* b, int ld, int nt,
                                         int ks, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if (kk >= ks) break;
    uint32_t ah[4], al[4], bh[N / 8][2], bl[N / 8][2];
    a(kk, ah, al);
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      if (n < nt) {
        if constexpr (KT) {
          const float* p = b + (8 * kk + lane % 4) * ld + 8 * n + lane / 4;
          split_tf32(p[0], bh[n][0], bl[n][0]);
          split_tf32(p[4 * ld], bh[n][1], bl[n][1]);
        } else {
          const float* p = b + (8 * n + lane / 4) * ld + 8 * kk + lane % 4;
          split_tf32(p[0], bh[n][0], bl[n][0]);
          split_tf32(p[4], bh[n][1], bl[n][1]);
        }
      }
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      if (n < nt) mma_tf32(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      if (n < nt) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      if (n < nt) mma_tf32(c[n], ah, bh[n][0], bh[n][1]);
  }
}

// c (16 x 8 NT, the context columns [0, 8 NT) of b) += p b[k0 .. k0+7]:
// p's split A fragment of a C chunk in the permuted order (tf32_a_of_c),
// b a row-major fp32 tile (stride ld) whose rows k0 + 2t and k0 + 2t + 1
// take k positions t and t + 4; C tiles at or past nc are skipped. Eight
// tiles' B fragments at a time. VT: b is V^T, a feature-major slab
// (features along the rows of stride ld, keys contiguous: K23's head-major
// core), whose keys k0 + 2t and + 1 are one 8-byte load.
template <int NT, bool VT = false>
__device__ __forceinline__ void tf32_pv(float (&c)[NT][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const float* b, int k0, int ld,
                                        int nc, int lane) {
  constexpr int NC = NT < 8 ? NT : 8;
  const float* p = VT ? b + (lane / 4) * ld + k0 + 2 * (lane % 4)
                      : b + (k0 + 2 * (lane % 4)) * ld + lane / 4;
#pragma unroll
  for (int c0 = 0; c0 < NT; c0 += NC) {
    uint32_t bh[NC][2], bl[NC][2];
    // C tile c0 + n of this group, if the tile exists and is below nc.
    auto on = [&](int n) { return c0 + n < NT && c0 + n < nc; };
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (on(n)) {
        if constexpr (VT) {
          const float2 v =
              *reinterpret_cast<const float2*>(p + 8 * (c0 + n) * ld);
          split_tf32(v.x, bh[n][0], bl[n][0]);
          split_tf32(v.y, bh[n][1], bl[n][1]);
        } else {
          split_tf32(p[8 * (c0 + n)], bh[n][0], bl[n][0]);
          split_tf32(p[ld + 8 * (c0 + n)], bh[n][1], bl[n][1]);
        }
      }
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (on(n)) mma_tf32(c[c0 + n], al, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (on(n)) mma_tf32(c[c0 + n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < NC; ++n)
      if (on(n)) mma_tf32(c[c0 + n], ah, bh[n][0], bh[n][1]);
  }
}

// One online-softmax step of a warp's two rows (m2, l as the C layout's
// rows lane / 4 and + 8) over the 64-key tile's raw scores sc: s2 = raw *
// scale2, keys at or past kend (the tile's real keys) at -inf; m2' =
// max(m2, rowmax(s2)); the context o rescaled by alpha = 2^(m2 - m2');
// sc becomes p = 2^(s2 - m2'), summed into l (the lane's partial sums)
// unless SUM is false (K23's vsum sums p as the products read it). The
// first tile of a row holds key 0, so m2' is finite there.
template <int NO, bool SUM = true>
__device__ __forceinline__ void online_step(float (&sc)[8][4],
                                            float (&o)[NO][4], float (&m2)[2],
                                            float (&l)[2], float scale2,
                                            int kend, int lane) {
  const int t = lane & 3;
  float mt[2] = {m2[0], m2[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = 8 * j + 2 * t + (e & 1) < kend ? sc[j][e] * scale2
                                                : -INFINITY;
      mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
    }
  quad_reduce(mt, [](float x, float y) { return fmaxf(x, y); });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float alpha = ex2(m2[r] - mt[r]);
    m2[r] = mt[r];
    l[r] *= alpha;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][2 * r] *= alpha;
      o[j][2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[j][e] = ex2(sc[j][e] - m2[e >> 1]);
      if constexpr (SUM) l[e >> 1] += sc[j][e];
    }
}

}  // namespace vit
