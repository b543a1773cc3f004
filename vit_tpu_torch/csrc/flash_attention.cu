// K7: flash attention, softmax(q k^T * scale, keys >= seq_len masked) v,
// for (B, H, S, d) operands read and written through explicit strides.
//
// Replaces vit_tpu/ops/pallas/attention.py:flash_attention in all three of
// its regimes with one kernel: the single-tile grouped kernels
// (_flash_group_rows_kernel, _flash_group_kernel; pallas_call at :246), the
// q-tiled kernel with whole K/V (_flash_qtile_kernel, :277) and the online
// FA2 kernel (_flash_kernel, :311). It is the attention of the model's
// composed route (vit_tpu/models/vit.py:212-219), taken when the fused
// attention core (csrc/attention.cu) does not fit: that core holds a head's
// whole K, V and fp32 score rows in shared memory, 313,920 B in bf16 at
// L/16-384's 592 tokens, over the 232,448 B a block may use.
//
// Design: grid (B*H, ceil(S/64)); a block owns a 64-row query tile of one
// (image, head), keeps it in shared memory, and streams K and V through
// shared memory in 64-key tiles, so its shared memory does not grow with S.
// Scores, the running max m and the running sum l are fp32, with the
// online-softmax recurrence of _flash_kernel (attention.py:68-77):
//   m' = max(m, rowmax(s));  alpha = exp(m - m');  p = exp(s - m');
//   l' = l * alpha + rowsum(p);  acc' = acc * alpha + (p in T) @ v;
// and ctx = acc / l is cast to T once at the end. l sums the fp32 p, and p
// is rounded to T only for the PV product (attention.py:73,76). Tiles that
// start at or past seq_len hold only masked keys and are skipped.
//
// The p of this kernel is relative to the running max, the p of the plain
// version (vit_tpu_torch/ops/reference.py:attention) to the row max -- the
// difference between JAX's online regime and its single-tile regimes. In
// fp32 that changes only the sum order; in bf16 it moves where p is rounded,
// by at most one bf16 ulp of p, inside the bf16 bar.
//
// Bound on the card: compute, 4*B*H*S*S*d flops (11.5 GFLOP a layer at
// L/16-384 bs=8); each block reads its head's K and V once per 64 queries.
// bf16 runs QK^T and PV on the tensor cores through nvcuda::wmma 16x16x16
// with fp32 accumulate, four warps of 16 query rows each; a warp owns its
// rows' scores, softmax and accumulator, so only the K/V tile loads need
// the block's barrier. The accumulator's rows are rescaled by alpha through
// a per-warp 16x16 shared tile (the wmma fragment's element order is not
// specified). fp32 multiplies in true fp32 on FFMA (no TF32; the JAX kernel
// runs fp32 at Precision.HIGHEST), 256 threads, each with a 4x4 block of the
// 64x64 score tile and 1/256 of the 64 x d accumulator in registers. Not
// pipelined (no cp.async, TMA or wgmma): the FA2-on-Hopper shape is later
// work.
//
// The output is the input's type, or fp32 (out_f32): the int8 tier's
// attention keeps its context in fp32 for the quantization that follows
// (vit_tpu/ops/pallas/block.py:_attn_q_core, :1249-1250), the third of
// attn_block_q's five launches on Hopper. Only the final store changes.
//
// head_dim: any multiple of 16 up to 128 (64 for L/16-384, 80 for H/14).
// Above 48 KB the dynamic shared memory is enabled with
// cudaFuncSetAttribute. Query rows past S (the last tile's pad) are computed
// on zeros and not stored; pad rows inside S come out finite because key 0
// is never masked.

#include <math.h>
#include <mma.h>

#include "flash_tiles.cuh"

namespace vit {

using namespace nvcuda;

struct FaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  FaStrides sq, sk, sv, so;
  int heads, s, seq_len;
  float scale;
  bool vec;  // q, k and v rows may be copied in 16-byte chunks
};

// ---------------------------------------------------------------- bf16 --

constexpr int kFaThreadsBf16 = 128;  // four warps, 16 query rows each
constexpr int kFaLds = kFaBK + 4;    // fp32 score rows
constexpr int kFaLdp = kFaBK + 8;    // bf16 p rows

template <int HD>
__host__ __device__ constexpr int fa_ldh() {
  return HD + 8;  // bf16 q/k/v rows: 16-byte aligned, shifted banks
}

template <int HD>
constexpr size_t fa_bf16_smem() {
  return 3 * kFaBQ * fa_ldh<HD>() * sizeof(bf16)  // q, k, v tiles
         + kFaBQ * kFaLds * sizeof(float)         // scores
         + kFaBQ * kFaLdp * sizeof(bf16)          // p
         + 4 * 256 * sizeof(float)                // per-warp 16x16 tile
         + 3 * kFaBQ * sizeof(float);             // m, l, alpha
}

template <int HD, typename O>
__global__ void __launch_bounds__(kFaThreadsBf16)
    flash_bf16_kernel(FaArgs a) {
  constexpr int LDH = fa_ldh<HD>(), NF = HD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kFaBQ * LDH;
  bf16* vs = ks + kFaBK * LDH;
  float* ss = reinterpret_cast<float*>(vs + kFaBK * LDH);
  bf16* ps = reinterpret_cast<bf16*>(ss + kFaBQ * kFaLds);
  float* tiles = reinterpret_cast<float*>(ps + kFaBQ * kFaLdp);
  float* ms = tiles + 4 * 256;
  float* ls = ms + kFaBQ;
  float* as = ls + kFaBQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int q0 = blockIdx.y * kFaBQ;
  const bf16* qg = head_ptr<bf16>(a.q, a.sq, b, h);
  const bf16* kg = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* vg = head_ptr<bf16>(a.v, a.sv, b, h);

  load_rows_bf16<HD>(qs, LDH, qg, a.sq.s, q0, a.s, a.vec);
  if (threadIdx.x < kFaBQ) {
    ms[threadIdx.x] = -INFINITY;
    ls[threadIdx.x] = 0.f;
  }

  // This warp's rows [16 * warp, 16 * warp + 16) of everything below.
  const bf16* qw = qs + warp * 16 * LDH;
  float* sw = ss + warp * 16 * kFaLds;
  bf16* pw = ps + warp * 16 * kFaLdp;
  float* tile = tiles + warp * 256;
  float *mw = ms + warp * 16, *lw = ls + warp * 16, *aw = as + warp * 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

  const int n_tiles = (a.seq_len + kFaBK - 1) / kFaBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFaBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows_bf16<HD>(ks, LDH, kg, a.sk.s, k0, a.s, a.vec);
    load_rows_bf16<HD>(vs, LDH, vg, a.sv.s, k0, a.s, a.vec);
    __syncthreads();

    // Scores of the warp's 16 rows against the 64 keys, fp32.
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(sf[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa;
      wmma::load_matrix_sync(qa, qw + kk, LDH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + j * 16 * LDH + kk, LDH);
        wmma::mma_sync(sf[j], qa, kb, sf[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(sw + j * 16, sf[j], kFaLds, wmma::mem_row_major);
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const float alpha = softmax_row(sw + r * kFaLds, pw + r * kFaLdp, k0,
                                      a.seq_len, a.scale, mw + r, lw + r,
                                      lane);
      if (lane == 0) aw[r] = alpha;
    }
    __syncwarp();

    // acc *= alpha, row by row, through the warp's shared tile.
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(tile, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) tile[e] *= aw[e / 16];
      __syncwarp();
      wmma::load_matrix_sync(acc[j], tile, 16, wmma::mem_row_major);
      __syncwarp();
    }

    // acc += p (bf16) @ v.
#pragma unroll
    for (int kk = 0; kk < kFaBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, pw + kk, kFaLdp);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + kk * LDH + j * 16, LDH);
        wmma::mma_sync(acc[j], pa, vb, acc[j]);
      }
    }
  }

  // ctx = acc / l, one cast to O, stored through the output strides.
  O* og = static_cast<O*>(a.out) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    wmma::store_matrix_sync(tile, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, row = q0 + warp * 16 + r;
      if (row < a.s)
        og[row * a.so.s + j * 16 + e % 16] = from_f32<O>(tile[e] / lw[r]);
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------- fp32 --

constexpr int kFaThreadsF32 = 256;
constexpr int kFaLdt = kFaBQ + 1;  // transposed q/k rows: conflict-free stores

template <int HD>
constexpr size_t fa_f32_smem() {
  return (2 * HD * kFaLdt           // q^T, k^T
          + kFaBK * HD              // v
          + kFaBQ * (kFaBK + 1)     // scores, then p
          + 3 * kFaBQ)              // m, l, alpha
         * sizeof(float);
}

// Copy rows [r0, r0 + 64) of a (S, HD) fp32 matrix into shared memory
// transposed, dst[c * kFaLdt + r]; rows at or past s are zero.
template <int HD>
__device__ __forceinline__ void load_rows_t_f32(float* __restrict__ dst,
                                                const float* __restrict__ src,
                                                long long ld, int r0, int s) {
  for (int e = threadIdx.x; e < kFaBQ * HD; e += blockDim.x) {
    const int r = e / HD, c = e % HD;
    dst[c * kFaLdt + r] = r0 + r < s ? src[(r0 + r) * ld + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kFaThreadsF32)
    flash_f32_kernel(FaArgs a) {
  constexpr int LDS = kFaBK + 1, NO = HD / 4;
  extern __shared__ __align__(16) float smf[];
  float* qt = smf;                   // HD x kFaLdt
  float* kt = qt + HD * kFaLdt;      // HD x kFaLdt
  float* vs = kt + HD * kFaLdt;      // kFaBK x HD
  float* ss = vs + kFaBK * HD;       // kFaBQ x LDS
  float* ms = ss + kFaBQ * LDS;
  float* ls = ms + kFaBQ;
  float* as = ls + kFaBQ;

  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int q0 = blockIdx.y * kFaBQ;
  const float* qg = head_ptr<float>(a.q, a.sq, b, h);
  const float* kg = head_ptr<float>(a.k, a.sk, b, h);
  const float* vg = head_ptr<float>(a.v, a.sv, b, h);

  load_rows_t_f32<HD>(qt, qg, a.sq.s, q0, a.s);
  if (t < kFaBQ) {
    ms[t] = -INFINITY;
    ls[t] = 0.f;
  }

  // Scores: rows ty + 16i, keys tx + 16j. Accumulator: row t / 4, columns
  // t % 4 + 4c.
  const int ty = t / 16, tx = t % 16;
  const int orow = t / 4, ocol = t % 4;
  float o[NO];
#pragma unroll
  for (int c = 0; c < NO; ++c) o[c] = 0.f;

  const int n_tiles = (a.seq_len + kFaBK - 1) / kFaBK;
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int k0 = tt * kFaBK;
    __syncthreads();  // the previous tile's k, v and p are no longer read
    load_rows_t_f32<HD>(kt, kg, a.sk.s, k0, a.s);
    for (int e = t; e < kFaBK * HD; e += kFaThreadsF32) {
      const int r = e / HD;
      vs[e] = k0 + r < a.s ? vg[(k0 + r) * a.sv.s + e % HD] : 0.f;
    }
    __syncthreads();

    float sc[4][4] = {};
    for (int c = 0; c < HD; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = qt[c * kFaLdt + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = kt[c * kFaLdt + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ss[(ty + 16 * i) * LDS + tx + 16 * j] = sc[i][j];
    __syncthreads();

    // One warp a row: p replaces the scores in place.
    for (int r = warp; r < kFaBQ; r += kFaThreadsF32 / 32) {
      float* row = ss + r * LDS;
      const float alpha = softmax_row(row, row, k0, a.seq_len, a.scale,
                                      ms + r, ls + r, lane);
      if (lane == 0) as[r] = alpha;
    }
    __syncthreads();

    const float alpha = as[orow];
#pragma unroll
    for (int c = 0; c < NO; ++c) o[c] *= alpha;
    const float* prow = ss + orow * LDS;
    for (int j = 0; j < kFaBK; ++j) {
      const float p = prow[j];
      const float* vr = vs + j * HD + ocol;
#pragma unroll
      for (int c = 0; c < NO; ++c) o[c] = fmaf(p, vr[4 * c], o[c]);
    }
  }

  const int row = q0 + orow;
  if (row < a.s) {
    float* og = static_cast<float*>(a.out) + b * a.so.b + h * a.so.h +
                row * a.so.s + ocol;
    const float l = ls[orow];
#pragma unroll
    for (int c = 0; c < NO; ++c) og[4 * c] = o[c] / l;
  }
}

// ---------------------------------------------------------------- launch --

template <typename K>
cudaError_t launch_fa(K kernel, size_t smem, int threads, int bh,
                      const FaArgs& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.s + kFaBQ - 1) / kFaBQ);
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_flash(const FaArgs& a, int bh, int dtype, bool out_f32,
                         cudaStream_t st) {
  if (dtype == kF32)
    return launch_fa(flash_f32_kernel<HD>, fa_f32_smem<HD>(), kFaThreadsF32,
                     bh, a, st);
  if (out_f32)
    return launch_fa(flash_bf16_kernel<HD, float>, fa_bf16_smem<HD>(),
                     kFaThreadsBf16, bh, a, st);
  return launch_fa(flash_bf16_kernel<HD, bf16>, fa_bf16_smem<HD>(),
                   kFaThreadsBf16, bh, a, st);
}

}  // namespace vit

extern "C" int vit_flash_attention(
    const void* q, const void* k, const void* v, void* out, long long sq_b,
    long long sq_h, long long sq_s, long long sk_b, long long sk_h,
    long long sk_s, long long sv_b, long long sv_h, long long sv_s,
    long long so_b, long long so_h, long long so_s, int batch, int heads,
    int s, int hd, int seq_len, float scale, int out_f32, int dtype,
    int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || heads <= 0 || s <= 0 || seq_len <= 0 || seq_len > s ||
      hd <= 0 || hd % 16 || hd > kFaMaxHd || (dtype != kF32 && dtype != kBF16))
    return cudaErrorInvalidValue;
  const int item = dtype == kF32 ? 4 : 2;
  FaArgs a{q, k, v, out,
           {sq_b, sq_h, sq_s}, {sk_b, sk_h, sk_s},
           {sv_b, sv_h, sv_s}, {so_b, so_h, so_s},
           heads, s, seq_len, scale, false};
  a.vec = aligned16_ptr(q) && aligned16_ptr(k) && aligned16_ptr(v) &&
          aligned16_strides(a.sq, item) && aligned16_strides(a.sk, item) &&
          aligned16_strides(a.sv, item);
  auto st = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (hd / 16) {
    case 1: return launch_flash<16>(a, bh, dtype, out_f32, st);
    case 2: return launch_flash<32>(a, bh, dtype, out_f32, st);
    case 3: return launch_flash<48>(a, bh, dtype, out_f32, st);
    case 4: return launch_flash<64>(a, bh, dtype, out_f32, st);
    case 5: return launch_flash<80>(a, bh, dtype, out_f32, st);
    case 6: return launch_flash<96>(a, bh, dtype, out_f32, st);
    case 7: return launch_flash<112>(a, bh, dtype, out_f32, st);
    case 8: return launch_flash<128>(a, bh, dtype, out_f32, st);
    default: return cudaErrorInvalidValue;
  }
}
