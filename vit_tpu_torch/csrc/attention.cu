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
// (B*S, D) buffer at the head's columns. The block's work, with
// _attn_core's rounding points, is the device routine attention_tile
// (attention_core.cuh), which K9 shares.
//
// Bound on the card: neither memory (each block reads its head's K and V,
// 2*S*d values) nor the tensor cores -- it is plain FFMA over shared memory,
// 4*B*H*S*S*d flops, about 4.3 GFLOP a layer at B/16 bs=32. Moving QK^T and
// PV onto the tensor cores and fusing LN+QKV before and the out-projection
// after (FlashAttention-2 on Hopper) is later work.

#include "attention_core.cuh"

namespace vit {

constexpr size_t kMaxSmem = 232448;  // 227 KB a block on Hopper

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int s,
                     int d, int dh, float scale, int seq_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  attention_tile<T>(qkv, out, s, d, dh, scale, seq_len, blockIdx.x,
                    blockIdx.y, blockIdx.z * kAttnQT, smem);
}

template <typename T>
cudaError_t launch_attention(const T* qkv, T* out, int batch, int s, int d,
                             int heads, int seq_len, float scale,
                             cudaStream_t st) {
  const int dh = d / heads;
  const size_t smem = attention_smem<T>(s, dh);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch, heads, (s + kAttnQT - 1) / kAttnQT);
  attention_kernel<T><<<grid, kAttnThreads, smem, st>>>(qkv, out, s, d, dh,
                                                        scale, seq_len);
  return cudaGetLastError();
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
    return launch_attention<float>(static_cast<const float*>(qkv),
                                   static_cast<float*>(out), batch, s, d,
                                   heads, seq_len, scale, st);
  if (dtype == kBF16)
    return launch_attention<bf16>(static_cast<const bf16*>(qkv),
                                  static_cast<bf16*>(out), batch, s, d, heads,
                                  seq_len, scale, st);
  return cudaErrorInvalidValue;
}
