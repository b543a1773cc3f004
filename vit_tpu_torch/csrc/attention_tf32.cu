// K4's fp32 attention core on the tensor cores (attention.cu has the C
// entry point, which launches this one for fp32, and the bf16 core): the
// work of attention_tile<float> (attention_core.cuh) for one (image, head,
// 64-query tile), both products on mma.sync m16n8k8 tf32 in the three-pass
// split of tf32_split.cuh, through flash_tf32.cuh's routines. Its own unit,
// so that the bf16 kernels compile as they did without it.
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
// Bound on the card at B/16 bs=32 (384 heads, 197 of 208 keys, d = 64):
// operations, 4 * B * H * S * seq_len * d = 4.03 GFLOP in three TF32
// passes at 495 TFLOP/s, 0.0244 ms, beside 0.0244 ms for q, k, v in and
// the context out (81.8 MB at 3.35 TB/s).

#include "attention_core.cuh"
#include "flash_tf32.cuh"

namespace vit {

constexpr int kAttnTf32Threads = 128;  // four warps of 16 query rows
constexpr int kAttnTf32MaxK = 8;       // 8-column slices of q held at once

template <int NK>
__global__ void __launch_bounds__(kAttnTf32Threads)
    attention_tf32_kernel(const float* __restrict__ qkv,
                          float* __restrict__ out, int s, int d, int dh,
                          float scale, int seq_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * kAttnQT;
  const int dhp = attn_tf32_dhp(dh), ld = dhp + 4;
  const int kend = (seq_len + 7) / 8 * 8;  // keys staged and walked
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + static_cast<size_t>((s + 7) / 8 * 8) * ld;
  const size_t ldg = 3 * static_cast<size_t>(d);
  const float* base = qkv + static_cast<size_t>(img) * s * ldg +
                      static_cast<size_t>(h) * dh;
  const bool vec = dh % 4 == 0 && d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  stage_rows_f32(ks, ld, base + d, ldg, kend, seq_len, dh, dhp, vec);
  cp_async_commit();
  stage_rows_f32(vs, ld, base + 2 * d, ldg, kend, seq_len, dh, dhp, vec);
  cp_async_commit();

  const int lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = q0 + 16 * (threadIdx.x / 32);  // the warp's first row
  const bool active = r0 < s;
  const float* q = base + static_cast<size_t>(r0) * ldg;
  const int qrows = s - r0;                // rows at or past S are zero
  const int ksl = dhp / 8;                 // 8-column slices of q
  const int nb = (ksl + NK - 1) / NK;      // blocks of 8 NK columns
  const float scale2 = scale * kLog2e;
  uint32_t qh[NK][4], ql[NK][4];
  if (active && nb == 1) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      tf32_a_global(qh[kk], ql[kk], q, ldg, qrows, 8 * kk, dh, lane);
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
        for (int kk = 0; kk < NK; ++kk)
          tf32_a_global(qh[kk], ql[kk], q, ldg, qrows, c0 + 8 * kk, dh,
                        lane);
      }
      tf32_qkt<NK, 64>(
          sc,
          [&](int kk, uint32_t(&ah)[4], uint32_t(&al)[4]) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              ah[i] = qh[kk][i];
              al[i] = ql[kk][i];
            }
          },
          ks + static_cast<size_t>(k0) * ld + c0, ld, nt,
          min(NK, ksl - NK * b), lane);
    }
  };

  cp_async_wait<1>();
  __syncthreads();  // K has landed
  float sc[8][4];
  if (active) scores(sc, 0);  // while V arrives
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
      if (n0 > 0 || k0 > 0) scores(sc, k0);
      online_step<NK>(sc, o, m, l, scale2, seq_len - k0, lane);
      const int nt = min(kend - k0, 64) / 8;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= nt) break;
        uint32_t ph[4], pl[4];
        tf32_a_of_c(ph, pl, sc[kk]);
        tf32_pv<NK>(o, ph, pl, vs + n0, k0 + 8 * kk, ld, (dhp - n0) / 8,
                    lane);
      }
    }
    quad_reduce(l, [](float x, float y) { return x + y; });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + lane / 4 + 8 * r;
      if (row >= s) continue;
      float* orow = out + (static_cast<size_t>(img) * s + row) * d +
                    static_cast<size_t>(h) * dh;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        if (c >= dh) continue;
        const float v0 = o[j][2 * r] / l[r], v1 = o[j][2 * r + 1] / l[r];
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

template <int NK>
cudaError_t launch_attention_tf32_nk(const float* qkv, float* out, int batch,
                                     int s, int d, int heads, int seq_len,
                                     float scale, cudaStream_t st) {
  const size_t smem = attention_tf32_smem(s, d / heads);
  cudaError_t err = cudaFuncSetAttribute(
      attention_tf32_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, heads, (s + kAttnQT - 1) / kAttnQT);
  attention_tf32_kernel<NK><<<grid, kAttnTf32Threads, smem, st>>>(
      qkv, out, s, d, d / heads, scale, seq_len);
  return cudaGetLastError();
}

cudaError_t launch_attention_tf32(const float* qkv, float* out, int batch,
                                  int s, int d, int heads, int seq_len,
                                  float scale, cudaStream_t st) {
  if (attention_tf32_smem(s, d / heads) > 232448)
    return cudaErrorInvalidValue;
  const int nk = attn_tf32_dhp(d / heads) / 8;
#define VIT_ATTN_TF32(K)                                                    \
  case K:                                                                   \
    return launch_attention_tf32_nk<K>(qkv, out, batch, s, d, heads,        \
                                       seq_len, scale, st)
  switch (nk < kAttnTf32MaxK ? nk : kAttnTf32MaxK) {
    VIT_ATTN_TF32(1);
    VIT_ATTN_TF32(2);
    VIT_ATTN_TF32(3);
    VIT_ATTN_TF32(4);
    VIT_ATTN_TF32(5);
    VIT_ATTN_TF32(6);
    VIT_ATTN_TF32(7);
    default: VIT_ATTN_TF32(8);
  }
#undef VIT_ATTN_TF32
}

}  // namespace vit
