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
// Design: grid (B*H, ceil(S/rows)); a block owns a query tile of one (image,
// head) (rows: 128 in bf16, 128 or 64 in fp32) and streams K and V through
// shared memory in 64-key tiles, so its shared memory does not grow with S.
// Scores, the running max m and the running sum l are fp32, with the
// online-softmax recurrence of _flash_kernel (attention.py:68-77):
//   m' = max(m, rowmax(s));  alpha = exp(m - m');  p = exp(s - m');
//   l' = l * alpha + rowsum(p);  acc' = acc * alpha + (p in T) @ v;
// and ctx = acc / l is cast to T once at the end. s = (q . k) * scale is
// rounded before the max, l sums the fp32 p, and p is rounded to T only
// for the PV product (attention.py:73,76). Tiles that start at or past
// seq_len hold only masked keys and are skipped.
//
// The p of this kernel is relative to the running max, the p of the plain
// version (vit_tpu_torch/ops/reference.py:attention) to the row max -- the
// difference between JAX's online regime and its single-tile regimes. In
// fp32 that changes only the sum order; in bf16 it moves where p is rounded,
// by at most one bf16 ulp of p, inside the bf16 bar.
//
// Bound on the card: bytes, q, k, v read and the context written once,
// against 4*B*H*S*seq_len*d operations over the real keys: at L/16-384
// bs=8, 38.8 MB (11.6 us at 3.35 TB/s) against 11.2 GFLOP (11.3 us at the
// bf16 peak); at B/16 bs=32 (197 of 208 keys), 40.9 MB (12.2 us) against
// 4.0 GFLOP. In fp32, operations: three TF32 passes at 495 TFLOP/s, 0.0678
// ms at L/16-384 bs=8 and 0.0244 ms at B/16 bs=32 (beside 0.0232 and
// 0.0244 ms for the fp32 bytes). Each block reads its head's K and V once
// per query tile, from L2.
//
// bf16: FlashAttention-2's shape on mma.sync (mma_frag.cuh), the walk of
// K13's launch (a) pass 1 (flash_attention_bwd.cu) with p rounded once. Eight
// warps of 16 query rows (a 128-row query tile: each K and V tile staged
// serves twice the rows of a 64-row one, so the blocks stage half as many
// tiles from L2: faster on the card than four warps); a warp's q rows go
// into A fragments in registers once; K and V tiles stream through a ring of
// three buffers with cp.async (rows padded by 16 bytes: conflict-free
// ldmatrix), two tiles ahead, so their copies overlap this tile's products,
// behind one barrier a tile. s = q k^T lands in C fragments, the row max and
// sum reduce over the quad of lanes holding a row, the accumulator is
// rescaled by alpha in registers, p is packed from its C fragments as the A
// operand of p v (v through ldmatrix.trans), and ctx = o / l leaves from
// registers, two columns a store. 16-key groups past seq_len in the last tile
// are not multiplied (B/16's 197 keys: 3 of its 16 groups). Operands that
// fail 16-byte alignment (vec false) are staged by element copies in the same
// kernel. fp32 runs flash_attention_tf32.cu's kernels, a unit of their own:
// the same walk with both products on the tensor cores in three TF32 passes
// (tf32_split.cuh), the counterpart of the JAX kernel's fp32 dots at
// Precision.HIGHEST.
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

#include "flash_tiles.cuh"

namespace vit {

// ---------------------------------------------------------------- bf16 --

constexpr int kFaThreadsBf16 = 256;  // eight warps of 16 query rows
constexpr int kFaBQBf16 = 128;       // query rows a block
constexpr int kFaStages = 3;         // K/V tiles in flight: two ahead

// Dynamic shared memory of a bf16 launch: a ring of kFaStages [k | v]
// buffers, 64-row tiles of HD + 8 columns; the query tile is staged once
// in the last buffer (tests/test_torch_flash_tiles.py holds it under the
// 227 KB a block may use at every head width).
template <int HD>
constexpr size_t fa_bf16_smem() {
  return 2 * kFaStages * kFaBK * (HD + 8) * sizeof(bf16);
}

// Two neighbouring outputs in one store: bf16x2 or float2.
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <int HD, typename O>
__global__ void __launch_bounds__(kFaThreadsBf16)
    flash_bf16_kernel(FaArgs a) {
  constexpr int LD = HD + 8, TILE = kFaBK * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* kv = reinterpret_cast<bf16*>(smem);  // the ring of [k | v]

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = 16 * (threadIdx.x / 32);  // the warp's rows in the tile
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int q0 = blockIdx.y * kFaBQBf16;
  const bf16* kg = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* vg = head_ptr<bf16>(a.v, a.sv, b, h);
  const int n = (a.seq_len + kFaBK - 1) / kFaBK;  // tiles holding real keys
  const float scale = a.scale;

  // Key tile `it` into buffer it % kFaStages; one cp.async group a tile,
  // empty past the end.
  auto prefetch = [&](int it) {
    if (it < n) {
      bf16* buf = kv + 2 * TILE * (it % kFaStages);
      stage_tile<HD>(buf, kg, a.sk.s, it * kFaBK, a.s, a.vec);
      stage_tile<HD>(buf + TILE, vg, a.sv.s, it * kFaBK, a.s, a.vec);
    }
    cp_async_commit();
  };
  bf16* qs = kv + 2 * TILE * (kFaStages - 1);  // 128 rows: k and v tiles
  const bf16* qg = head_ptr<bf16>(a.q, a.sq, b, h);
  stage_tile<HD>(qs, qg, a.sq.s, q0, a.s, a.vec);
  stage_tile<HD>(qs + TILE, qg, a.sq.s, q0 + kFaBK, a.s, a.vec);
#pragma unroll
  for (int i = 0; i < kFaStages - 1; ++i) prefetch(i);
  cp_async_wait<kFaStages - 2>();  // q and key tile 0
  __syncthreads();
  // The warp's q rows as A fragments, held for the whole walk (the loop's
  // first barrier keeps key tile 2 off q until every warp has them).
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_a(qf[kk], qs, LD, r0, 16 * kk, lane);

  // The lane's rows are r0 + lane/4 (r = 0) and r0 + lane/4 + 8 (r = 1);
  // its columns of C tile j are keys (or context columns) 8j + 2t, + 1.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int it = 0; it < n; ++it) {
    // One barrier a tile: tile it has landed for every thread, and every
    // warp is done with tile it - 1, whose buffer the next copy takes.
    cp_async_wait<kFaStages - 2>();
    __syncthreads();
    prefetch(it + kFaStages - 1);
    const bf16* ks = kv + 2 * TILE * (it % kFaStages);
    const bf16* vs = ks + TILE;
    const int k0 = it * kFaBK;
    // Keys of this tile in 16-key groups that hold a real key: the groups
    // past them (the last tile's) are masked, and their products skipped.
    const int kend = min(a.seq_len - k0, kFaBK);
    float sc[kFaBK / 8][4];
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int g = 0; g < kFaBK; g += 16) {
        if (g >= kend) break;
        uint32_t bk[4];
        ldmatrix_b_kmajor(bk, ks, LD, g, 16 * kk, lane);
        mma_bf16(sc[g / 8], qf[kk], bk[0], bk[1]);
        mma_bf16(sc[g / 8 + 1], qf[kk], bk[2], bk[3]);
      }
    // s = (q . k) * scale, rounded before the max and the subtraction;
    // keys at or past seq_len (only in the last tile) at -inf.
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = __fmul_rn(sc[j][e], scale);
    if (kend < kFaBK) {
#pragma unroll
      for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= kend) sc[j][e] = -INFINITY;
    }
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
    quad_reduce(mt, [](float x, float y) { return fmaxf(x, y); });
    // m' = max(m, rowmax(s)); alpha = exp(m - m'); p = exp(s - m'). m' is
    // -inf only while every key so far is masked; exp(-inf - -inf) would
    // be NaN, so such a row subtracts 0 and gets p = alpha = 0.
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      base[r] = mt[r] == -INFINITY ? 0.f : mt[r];
      alpha[r] = expf(m[r] - base[r]);
      m[r] = mt[r];
      l[r] *= alpha[r];
    }
    // l sums the unrounded p (a quad's four partial sums, added at the
    // end); p is rounded to bf16 only as the A operand of p v.
#pragma unroll
    for (int j = 0; j < kFaBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - base[e >> 1]);
        l[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < kFaBK / 16; ++kk) {
      if (16 * kk >= kend) break;
      uint32_t pa[4];
      pack_a(pa, sc[2 * kk], sc[2 * kk + 1]);
      mma_ab<HD>(o, pa, vs, 16 * kk, LD, lane);
    }
  }
  quad_reduce(l, [](float x, float y) { return x + y; });

  // ctx = o / l, one cast to O, two columns a store through the output
  // strides (the wrapper's (B, S, H, d) buffer: even strides).
  O* og = static_cast<O*>(a.out) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + lane / 4 + 8 * r;
    if (row >= a.s) continue;
    O* orow = og + row * a.so.s + 2 * t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(orow + 8 * j, o[j][2 * r] / l[r], o[j][2 * r + 1] / l[r]);
  }
}

// ---------------------------------------------------------------- launch --

template <typename K>
cudaError_t launch_fa(K kernel, size_t smem, int threads, int rows, int bh,
                      const FaArgs& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.s + rows - 1) / rows);
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_flash(const FaArgs& a, int bh, int dtype, bool out_f32,
                         cudaStream_t st) {
  if (dtype == kF32) return launch_flash_f32(a, bh, HD, st);
  if (out_f32)
    return launch_fa(flash_bf16_kernel<HD, float>, fa_bf16_smem<HD>(),
                     kFaThreadsBf16, kFaBQBf16, bh, a, st);
  return launch_fa(flash_bf16_kernel<HD, bf16>, fa_bf16_smem<HD>(),
                   kFaThreadsBf16, kFaBQBf16, bh, a, st);
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
