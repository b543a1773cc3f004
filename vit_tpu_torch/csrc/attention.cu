// K4's attention core: masked softmax attention, one (image, head, query
// tile) a block, reading q, k and v straight from the packed QKV buffer.
//
// Replaces the attention part of vit_tpu/ops/pallas/block.py:attn_block
// (_attn_kernel -> _attn_core, block.py:675-692). The TPU kernel keeps one
// image's whole (S, 3D) QKV in VMEM; on Hopper that is about 0.96 MB at
// B/16, far over one SM's 227 KB of shared memory, so attn_block runs as
// four launches (vit_tpu_torch/ops/cuda/block.py) and this kernel is the
// third: it takes the (B*S, 3D) [q|k|v] buffer that the QKV GEMM wrote,
// head h at columns h*d of each third -- exactly the layout _attn_core
// slices -- so no head transposes are made, and writes the context into a
// (B*S, D) buffer at the head's columns.
//
// bf16 runs attention_tile_mma (attention_mma.cuh): both products on
// mma.sync tensor-core fragments, two passes over 64-key chunks so that p
// is rounded relative to the row max as _attn_core rounds it, four warps
// of 16 query rows. fp32 runs attention_tf32.cu's core, a unit of its
// own: both products on mma.sync tf32 in three passes (tf32_split.cuh),
// the counterpart of the Pallas fp32 dots at Precision.HIGHEST.
//
// Bound on the card at B/16 bs=32 (384 heads, 197 of 208 keys, d=64):
// bytes in bf16, 0.0122 ms for q, k, v in and the context out at
// 3.35 TB/s, against about 0.008 ms for the three bf16 products at the
// tensor-core peak; in fp32 operations, 4*B*H*S*seq_len*d = 4.03 GFLOP,
// 0.0244 ms in three TF32 passes at 495 TFLOP/s (as long as the fp32
// bytes, 81.8 MB at 3.35 TB/s). The bf16 tile reads each head's K and V
// from L2 once a query tile and keeps the scores in registers, so what it
// moves is the inputs, the fragments' shared-memory traffic and the
// output.
#include "attention_core.cuh"
#include "attention_mma.cuh"

namespace vit {

constexpr size_t kMaxSmem = 232448;  // 227 KB a block on Hopper

// The bf16 tile on mma.sync (attention_mma.cuh), NK 16-column steps of q.
template <typename T, int NK>
__global__ void __launch_bounds__(kAttnMmaThreads)
    attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int s,
                     int d, int dh, float scale, int seq_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  attention_tile_mma<NK>(qkv, out, s, d, dh, scale, seq_len, blockIdx.x,
                         blockIdx.y, blockIdx.z * kAttnQT, smem);
}

template <typename T, int NK>
cudaError_t launch_attention(const T* qkv, T* out, int batch, int s, int d,
                             int heads, int seq_len, float scale,
                             cudaStream_t st) {
  const int dh = d / heads;
  const size_t smem = attention_mma_smem(s, dh);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, heads, (s + kAttnQT - 1) / kAttnQT);
  attention_kernel<T, NK><<<grid, kAttnMmaThreads, smem, st>>>(
      qkv, out, s, d, dh, scale, seq_len);
  return cudaGetLastError();
}

// The bf16 instantiation for head width dh: q's 16-column steps held at
// once, at most kAttnMmaMaxK (wider heads walk blocks of 128 columns).
inline cudaError_t launch_attention_bf16(const bf16* qkv, bf16* out,
                                         int batch, int s, int d, int heads,
                                         int seq_len, float scale,
                                         cudaStream_t st) {
  const int nk = attn_mma_dhp(d / heads) / 16;
#define VIT_ATTN_MMA(K)                                                   \
  case K:                                                                 \
    return launch_attention<bf16, K>(qkv, out, batch, s, d, heads, seq_len, \
                                     scale, st)
  switch (nk < kAttnMmaMaxK ? nk : kAttnMmaMaxK) {
    VIT_ATTN_MMA(1);
    VIT_ATTN_MMA(2);
    VIT_ATTN_MMA(3);
    VIT_ATTN_MMA(4);
    VIT_ATTN_MMA(5);
    VIT_ATTN_MMA(6);
    VIT_ATTN_MMA(7);
    default: VIT_ATTN_MMA(8);
  }
#undef VIT_ATTN_MMA
}

}  // namespace vit

extern "C" int vit_attention(const void* qkv, void* out, int batch, int s,
                             int d, int heads, int seq_len, float scale,
                             int dtype, int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (batch <= 0 || s <= 0 || heads <= 0 || d % heads || seq_len <= 0 ||
      seq_len > s || heads > 65535)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_attention_tf32(static_cast<const float*>(qkv),
                                 static_cast<float*>(out), batch, s, d,
                                 heads, seq_len, scale, st);
  if (dtype == kBF16)
    return launch_attention_bf16(static_cast<const bf16*>(qkv),
                                 static_cast<bf16*>(out), batch, s, d, heads,
                                 seq_len, scale, st);
  return cudaErrorInvalidValue;
}
