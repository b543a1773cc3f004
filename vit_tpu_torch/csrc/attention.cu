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
// Per query row, with _attn_core's rounding points:
//   s = (q . k) * scale in fp32, keys at index >= seq_len set to -inf;
//   p = exp(s - max), l = sum(p), both fp32;
//   ctx = (p rounded to the tensor's type) @ v in fp32, then / l;
//   ctx is stored in the tensor's type.
//
// Bound on the card: neither memory (each block reads its head's K and V,
// 2*S*d values) nor the tensor cores -- it is plain FFMA over shared memory,
// 4*B*H*S*S*d flops, about 4.3 GFLOP a layer at B/16 bs=32. A 64-row query
// tile keeps the fp32 scores (64 x S) and the head's K, V and Q in shared
// memory: 113 KB at S=208, d=64 in bf16, 173 KB in fp32. Moving QK^T and PV
// onto the tensor cores and fusing LN+QKV before and the out-projection
// after (FlashAttention-2 on Hopper) is later work.

#include <math.h>

#include "common.cuh"

namespace vit {

constexpr int kAttnQT = 64;  // query rows a block
constexpr int kAttnThreads = 256;
constexpr size_t kMaxSmem = 232448;  // 227 KB a block on Hopper

// K rows are padded by one 4-byte word so that threads reading consecutive
// keys hit consecutive banks.
template <typename T>
__host__ __device__ inline int attn_ldk(int dh) {
  return dh + 4 / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ inline size_t attn_t_bytes(int s, int dh) {
  const size_t elems = static_cast<size_t>(s) * attn_ldk<T>(dh) +
                       static_cast<size_t>(s) * dh +
                       static_cast<size_t>(kAttnQT) * dh;
  return (elems * sizeof(T) + 15) / 16 * 16;
}

template <typename T>
inline size_t attention_smem(int s, int dh) {
  return attn_t_bytes<T>(s, dh) +
         (static_cast<size_t>(kAttnQT) * s + kAttnQT) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
    attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int s,
                     int d, int dh, float scale, int seq_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = attn_ldk<T>(dh);
  T* ks = reinterpret_cast<T*>(smem);      // s x ldk
  T* vs = ks + static_cast<size_t>(s) * ldk;  // s x dh
  T* qs = vs + static_cast<size_t>(s) * dh;   // kAttnQT x dh
  float* sc = reinterpret_cast<float*>(smem + attn_t_bytes<T>(s, dh));
  float* lsum = sc + static_cast<size_t>(kAttnQT) * s;

  const int img = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * kAttnQT;
  const size_t ld = 3 * static_cast<size_t>(d);
  const T* base = qkv + static_cast<size_t>(img) * s * ld +
                  static_cast<size_t>(h) * dh;

  for (int e = threadIdx.x; e < s * dh; e += kAttnThreads) {
    const int j = e / dh, c = e % dh;
    ks[j * ldk + c] = base[j * ld + d + c];
    vs[e] = base[j * ld + 2 * d + c];
  }
  for (int e = threadIdx.x; e < kAttnQT * dh; e += kAttnThreads) {
    const int i = e / dh, c = e % dh;
    qs[e] = q0 + i < s ? base[(q0 + i) * ld + c] : from_f32<T>(0.f);
  }
  __syncthreads();

  // Scores, fp32, masked keys at -inf.
  for (int e = threadIdx.x; e < kAttnQT * s; e += kAttnThreads) {
    const int i = e / s, j = e % s;
    float v = -INFINITY;
    if (j < seq_len) {
      const T* qi = qs + i * dh;
      const T* kj = ks + j * ldk;
      float acc = 0.f;
      for (int c = 0; c < dh; ++c) acc = fmaf(to_f32(qi[c]), to_f32(kj[c]), acc);
      v = acc * scale;
    }
    sc[e] = v;
  }
  __syncthreads();

  // Softmax numerators, one warp a row: p = exp(s - max) rounded to T in
  // place, l = sum of the unrounded p.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < kAttnQT; i += kAttnThreads / 32) {
    float* row = sc + static_cast<size_t>(i) * s;
    float mx = -INFINITY;
    for (int j = lane; j < s; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < s; j += 32) {
      const float p = expf(row[j] - mx);
      sum += p;
      row[j] = to_f32(from_f32<T>(p));
    }
    sum = warp_sum(sum);
    if (lane == 0) lsum[i] = sum;
  }
  __syncthreads();

  // Context: (p @ v) / l; masked keys have p == 0 and are skipped.
  for (int e = threadIdx.x; e < kAttnQT * dh; e += kAttnThreads) {
    const int i = e / dh, c = e % dh;
    if (q0 + i >= s) continue;
    const float* p = sc + static_cast<size_t>(i) * s;
    float acc = 0.f;
    for (int j = 0; j < seq_len; ++j) acc = fmaf(p[j], to_f32(vs[j * dh + c]), acc);
    out[(static_cast<size_t>(img) * s + q0 + i) * d +
        static_cast<size_t>(h) * dh + c] = from_f32<T>(acc / lsum[i]);
  }
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
