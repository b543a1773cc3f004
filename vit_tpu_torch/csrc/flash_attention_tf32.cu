// K7's fp32 form on the tensor cores (flash_attention.cu has the header
// comment, the bf16 form and the C entry point, which launches this one for
// fp32): FlashAttention-2's walk with both products in three TF32 passes
// (tf32_split.cuh), through flash_tf32.cuh's routines -- on wgmma at head
// widths 32 and 64, on mma.sync at the others. Its own unit, so that the
// bf16 kernels compile as they did without it.
//
// The function is _flash_kernel's (vit_tpu/ops/pallas/attention.py:68-77)
// in fp32, whose dots run at Precision.HIGHEST: s = (q . k) * scale, keys
// at or past seq_len masked, the online softmax with a running max m and
// sum l, ctx = acc / l. Both forms run the softmax in base 2 (s2 = raw *
// scale * log2(e), p = 2^(s2 - m2) on ex2.approx): it changes only the
// fp32 rounding, inside the 1e-4 bar. Key tiles that start at or past
// seq_len are not walked. Query rows past S (the last tile's pad) are
// computed on zeros and not stored.
//
// Bound on the card: operations in three TF32 passes, 4*B*H*S*seq_len*d at
// 495 TFLOP/s / 3: 0.0678 ms at L/16-384 bs=8 (11.2 GFLOP), 0.0244 ms at
// B/16 bs=32 (4.03 GFLOP), each beside about as long for the fp32 bytes.

#include "flash_tf32.cuh"

namespace vit {

// ================================ mma.sync m16n8k8 tf32, every head width ==
//
// Four warps of 16 query rows (a 64-row tile), as K13's mma.sync form: the
// query tile is staged once; K and V tiles stream through two buffers with
// cp.async, the next tile's copy in flight while this one's products run.
// A warp's q rows are split into A fragments in registers once at head
// widths up to 64, and from the staged tile at each 8-deep slice above
// (the registers then hold the wider context). s = q k^T lands in C
// fragments, the online step (online_step) rescales the context, and p is
// split where its C fragment left it as the A operand of o += p v (the
// permuted k order); 8-key C tiles past seq_len in the last tile are not
// multiplied. Shared memory: the query tile and two [k | v] buffers, rows
// of HD + 4 floats (108 KB at d = 80: two blocks an SM).

constexpr int kFaTf32Threads = 128;

template <int HD>
constexpr size_t fa_tf32_smem() {
  return 5 * kFaBQ * (HD + 4) * sizeof(float);
}

static_assert(fa_tf32_smem<kFaMaxHd>() <= 232448, "K7 fp32 at d = 128");

template <int HD>
__global__ void __launch_bounds__(kFaTf32Threads) flash_tf32_kernel(FaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = HD + 4, TILE = kFaBQ * LD, KS = HD / 8;
  constexpr bool kQReg = HD <= 64;  // q's split fragments in registers
  float* qs = reinterpret_cast<float*>(smem);
  float* kv = qs + TILE;  // two buffers of [k | v]

  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32);  // the warp's rows in the tile
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int q0 = blockIdx.y * kFaBQ;
  const float* kg = head_ptr<float>(a.k, a.sk, b, h);
  const float* vg = head_ptr<float>(a.v, a.sv, b, h);
  const int n = (a.seq_len + kFaBK - 1) / kFaBK;  // tiles holding real keys
  const float scale2 = a.scale * kLog2e;

  // Key tile `it` into buffer it % 2; one cp.async group a tile, empty
  // past the end.
  auto prefetch = [&](int it) {
    if (it < n) {
      float* buf = kv + 2 * TILE * (it & 1);
      stage_tile_f32<HD>(buf, kg, a.sk.s, it * kFaBK, a.s, a.vec);
      stage_tile_f32<HD>(buf + TILE, vg, a.sv.s, it * kFaBK, a.s, a.vec);
    }
    cp_async_commit();
  };
  stage_tile_f32<HD>(qs, head_ptr<float>(a.q, a.sq, b, h), a.sq.s, q0, a.s,
                     a.vec);
  prefetch(0);  // with the query tile

  uint32_t qh[kQReg ? KS : 1][4], ql[kQReg ? KS : 1][4];
  auto q_frag = [&](int kk, uint32_t(&ah)[4], uint32_t(&al)[4]) {
    if constexpr (kQReg) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = qh[kk][i];
        al[i] = ql[kk][i];
      }
    } else {
      tf32_a(ah, al, qs, LD, r0, 8 * kk, lane);
    }
  };
  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int it = 0; it < n; ++it) {
    prefetch(it + 1);
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQReg) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          tf32_a(qh[kk], ql[kk], qs, LD, r0, 8 * kk, lane);
      }
    }
    const float* ks = kv + 2 * TILE * (it & 1);
    const float* vs = ks + TILE;
    const int kend = min(a.seq_len - it * kFaBK, kFaBK);  // real keys
    const int nt = (kend + 7) / 8;
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    tf32_qkt<KS, kFaBK>(sc, q_frag, ks, LD, nt, KS, lane);
    online_step<HD / 8>(sc, o, m2, l, scale2, kend, lane);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (kk >= nt) break;
      uint32_t ph[4], pl[4];
      tf32_a_of_c(ph, pl, sc[kk]);
      tf32_pv<HD / 8>(o, ph, pl, vs, 8 * kk, LD, HD / 8, lane);
    }
    __syncthreads();  // every warp is done with the buffer refilled next
  }
  quad_reduce(l, [](float x, float y) { return x + y; });

  float* og = static_cast<float*>(a.out) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + lane / 4 + 8 * r;
    if (row >= a.s) continue;
    float* orow = og + row * a.so.s + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(o[j][2 * r] / l[r], o[j][2 * r + 1] / l[r]);
  }
}

// =================================== wgmma tf32, head widths 32 and 64 ==
//
// K13's wgmma form, its launch (a) pass 1 alone: a block is two
// warpgroups, each the four warps above on a 64-row query tile of its own
// (128 rows a block), so that one warpgroup's softmax and splits run while
// the other's products hold the tensor cores. Each key tile, shared by
// both, is split by the block's 256 threads into hi and lo K-major
// operands with the 128-byte swizzle (flash_tf32.cuh: wg_store_block): k
// as it lies (the B of s = q k^T), v transposed with its keys in the
// permuted order (the B of o = p v); the next tile's 4 x 4 blocks are
// loaded into registers while this tile's products run. A comes from
// registers: q's rows split from the warpgroup's staged tile, p split
// where its C fragment left it. The tensor cores take 64 x N x 8 a
// warpgroup instruction on whole 64-key tiles (the masked keys of the last
// tile have p = 0). Shared memory (100 KB at d = 64): the two query tiles
// and the four operand boxes.

constexpr int kFaWgThreads = 256;  // two warpgroups

template <int HD>
constexpr size_t fa_wg_smem() {
  return 1024 + 2 * kFaBQ * (HD + 4) * sizeof(float) + 4 * kWgBox<HD>;
}

template <int HD>
__global__ void __launch_bounds__(kFaWgThreads, 1)
    flash_tf32_wg_kernel(FaArgs a) {
  extern __shared__ __align__(128) unsigned char smem_in[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_in) + 1023) & ~uintptr_t(1023));
  constexpr int LD = HD + 4, TILE = kFaBQ * LD, BOX = kWgBox<HD>;
  const int wgi = threadIdx.x / 128, warp = threadIdx.x / 32 % 4;
  // Each warpgroup's raw q tile; then k split as it lies and v transposed,
  // hi and lo each.
  float* qs = reinterpret_cast<float*>(smem) + wgi * TILE;
  const uint32_t kn = wg::smem_u32(smem) + 2 * TILE * 4, vt = kn + 2 * BOX;

  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int q0 = (2 * blockIdx.y + wgi) * kFaBQ;
  const float* kg = head_ptr<float>(a.k, a.sk, b, h);
  const float* vg = head_ptr<float>(a.v, a.sv, b, h);
  const int n = (a.seq_len + kFaBK - 1) / kFaBK;
  const float scale2 = a.scale * kLog2e;

  stage_tile_f32<HD>(qs, head_ptr<float>(a.q, a.sq, b, h), a.sq.s, q0, a.s,
                     a.vec, threadIdx.x % 128, 128);
  cp_async_commit();
  float4 kb[4], vb[4];
  auto load = [&](int it) {
    wg_load_block<HD>(kb, kg, a.sk.s, it * kFaBK, a.s, a.vec);
    wg_load_block<HD>(vb, vg, a.sv.s, it * kFaBK, a.s, a.vec);
  };
  load(0);

  float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int it = 0; it < n; ++it) {
    __syncthreads();  // both warpgroups are done with the operands
    wg_store_block<HD, true, false>(kb, kn, 0);
    wg_store_block<HD, false, true>(vb, 0, vt);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (it + 1 < n) load(it + 1);
    cp_async_wait<0>();
    __syncthreads();
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    wg_raw_a<HD, kFaBK>(sc, qs, LD, kn, kn + BOX, warp, lane);
    online_step<HD / 8>(sc, o, m2, l, scale2, a.seq_len - it * kFaBK, lane);
    wg_c_a<kFaBK, HD>(o, sc, vt, vt + BOX);
  }
  quad_reduce(l, [](float x, float y) { return x + y; });

  float* og = static_cast<float*>(a.out) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    if (row >= a.s) continue;
    float* orow = og + row * a.so.s + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(o[j][2 * r] / l[r], o[j][2 * r + 1] / l[r]);
  }
}

// ------------------------------------------------------------- launch --

template <typename K>
cudaError_t launch_fa_tf32(K kernel, size_t smem, int threads, int rows,
                           int bh, const FaArgs& a, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.s + rows - 1) / rows);
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// Head widths 32 and 64 on the wgmma form, the others on mma.sync.
template <int HD>
cudaError_t launch_flash_f32_hd(const FaArgs& a, int bh, cudaStream_t st) {
  if constexpr (HD == 32 || HD == 64)
    return launch_fa_tf32(flash_tf32_wg_kernel<HD>, fa_wg_smem<HD>(),
                          kFaWgThreads, 2 * kFaBQ, bh, a, st);
  else
    return launch_fa_tf32(flash_tf32_kernel<HD>, fa_tf32_smem<HD>(),
                          kFaTf32Threads, kFaBQ, bh, a, st);
}

cudaError_t launch_flash_f32(const FaArgs& a, int bh, int hd,
                             cudaStream_t st) {
  switch (hd / 16) {
    case 1: return launch_flash_f32_hd<16>(a, bh, st);
    case 2: return launch_flash_f32_hd<32>(a, bh, st);
    case 3: return launch_flash_f32_hd<48>(a, bh, st);
    case 4: return launch_flash_f32_hd<64>(a, bh, st);
    case 5: return launch_flash_f32_hd<80>(a, bh, st);
    case 6: return launch_flash_f32_hd<96>(a, bh, st);
    case 7: return launch_flash_f32_hd<112>(a, bh, st);
    case 8: return launch_flash_f32_hd<128>(a, bh, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vit
