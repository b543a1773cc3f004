// The FFMA attention core as a device routine: masked softmax attention for
// one (image, head, 64-query tile), reading q, k and v straight from a
// packed (B*S, 3D) [q|k|v] buffer (head h at columns h*d of each third --
// the layout vit_tpu/ops/pallas/block.py:_attn_core slices) and writing the
// context into a (B*S, D) buffer at the head's columns. It serves K9's
// fp32 attention phase (encoder_stack.cu) and K9's probe K24
// (encstack_probe.cu: kAttnFull and, for its nosm variant, kAttnMxu). The
// other cores run on the tensor cores: the bf16 core of K4, K9 and K23 is
// attention_tile_mma (attention_mma.cuh), the fp32 core of K4 and K23
// attention_tile_tf32 (attention_tf32.cuh, three TF32 passes), each with
// K23's modes (AttnMode below) as a template parameter.
//
// Per query row, with _attn_core's rounding points:
//   s = (q . k) * scale in fp32, keys at index >= seq_len set to -inf;
//   p = exp(s - max), l = sum(p), both fp32;
//   ctx = (p rounded to the tensor's type) @ v in fp32, then / l;
//   ctx is stored in the tensor's type.
// The max is the row max over all keys, as in _encoder_stack_kernel
// (block.py:1953-1968), so K9 keeps that kernel's softmax exactly.
//
// A 64-row query tile keeps the fp32 scores (64 x S) and the head's K, V
// and Q in shared memory: 113 KB at S=208, d=64 in bf16, 173 KB in fp32.
// The math is plain FFMA over shared memory, which bounds it by
// operations: 4*S*seq_len*d a head (in fp32 at B/16 bs=32, 4.0 GFLOP:
// 0.060 ms at 67 TFLOP/s).

#pragma once

#include <math.h>

#include "common.cuh"

namespace vit {

constexpr int kAttnQT = 64;  // query rows a tile
constexpr int kAttnThreads = 256;

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

// Dynamic shared memory of one tile (vit_tpu_torch/ops/cuda/block.py:
// attention_smem_bytes computes the same).
template <typename T>
inline size_t attention_smem(int s, int dh) {
  return attn_t_bytes<T>(s, dh) +
         (static_cast<size_t>(kAttnQT) * s + kAttnQT) * sizeof(float);
}

// K4's fp32 core on the tensor cores (attention_tf32.cu): the head width
// zero-padded to 8 columns, its dynamic shared memory (K and V, S rows
// rounded up to 8, rows of dh' + 4 floats; vit_tpu_torch/ops/cuda/block.py:
// attention_tf32_smem_bytes computes the same), and its launch.
__host__ __device__ inline int attn_tf32_dhp(int dh) {
  return (dh + 7) / 8 * 8;
}
inline size_t attention_tf32_smem(int s, int dh) {
  return 2 * static_cast<size_t>((s + 7) / 8 * 8) * (attn_tf32_dhp(dh) + 4) *
         sizeof(float);
}
cudaError_t launch_attention_tf32(const float* qkv, float* out, int batch,
                                  int s, int d, int heads, int seq_len,
                                  float scale, cudaStream_t st);

// Shared memory a block can use on Hopper (227 KB): K23's cores refuse a
// tile past it.
constexpr size_t kProbeMaxSmem = 232448;

// The modes of the attention probe K23 (csrc/attn_core_probe.cu), a
// compile-time parameter of attention_tile_tf32 (fp32, attention_tf32.cuh),
// attention_tile_mma (bf16, attention_mma.cuh) and attention_tile (the
// FFMA tile, which K24 runs in kAttnFull and kAttnMxu). kAttnFull is K4's
// and K9's core, and the only mode they instantiate; each other mode
// changes the tile where
// tools/attn_core_probe.py's _core_kernel changes the core
// (vit_tpu_torch/tools/attn_core_probe.py gives each mode's function).
enum AttnMode : int {
  kAttnFull = 0,
  kAttnMaskOnly = 1,    // l = 1
  kAttnNoSm = 2,        // no mask, l = 1
  kAttnMxu = 3,         // no mask, no max or exp: p = s, l = 1
  kAttnDivOnly = 4,     // no mask
  kAttnRecip = 5,       // no mask, ctx * (1 / l)
  kAttnSumOnly = 6,     // no mask, ctx + 1e-30 * l
  kAttnBf16Div = 7,     // no mask, round(ctx) / round(l)
  kAttnAllDiv = 8,      // as kAttnRecip: a tile holds one head, no concat
  kAttnMxuDiv = 9,      // as kAttnRecip
  kAttnAddMask = 10,    // every key scored, the mask added as a row
  kAttnVsum = 11,       // l = the sum of the rounded p
  kAttnQcore = 12,      // int8 codes: q per row, k and v per head
  kAttnWide = 13,       // no mask, round(p / l) @ v; the caller pairs heads
  kAttnKt = 14,         // k from a transposed (D, ldt) buffer
  kAttnHeadMajor = 15,  // q, k, v from a (3D, ldt) buffer, ctx to (D, ldt)
};

// Modes whose keys at index >= seq_len get p = 0.
__host__ __device__ constexpr bool attn_masked(int mode) {
  return mode == kAttnFull || mode == kAttnMaskOnly ||
         mode == kAttnAddMask || mode == kAttnVsum || mode == kAttnQcore ||
         mode == kAttnKt || mode == kAttnHeadMajor;
}

// Modes that score every key (the others skip the masked ones).
__host__ __device__ constexpr bool attn_all_keys(int mode) {
  return !attn_masked(mode) || mode == kAttnAddMask;
}

// Modes whose context is not divided by a row sum.
__host__ __device__ constexpr bool attn_unit_sum(int mode) {
  return mode == kAttnMaskOnly || mode == kAttnNoSm || mode == kAttnMxu ||
         mode == kAttnWide;
}

// A context element from its fp32 sum acc and the row sum l, as MODE
// combines them; ap points at the row's p scale (kAttnQcore only), av is
// the head's v scale.
template <typename T, int MODE>
__device__ __forceinline__ float attn_combine(float acc, float l,
                                              const float* ap, float av) {
  if constexpr (MODE == kAttnRecip || MODE == kAttnAllDiv ||
                MODE == kAttnMxuDiv || MODE == kAttnAddMask ||
                MODE == kAttnHeadMajor)
    return acc * (1.f / l);
  else if constexpr (MODE == kAttnSumOnly)
    return __fadd_rn(acc, __fmul_rn(1e-30f, l));
  else if constexpr (MODE == kAttnBf16Div)
    return to_f32(from_f32<T>(acc)) / to_f32(from_f32<T>(l));
  else if constexpr (MODE == kAttnQcore)
    return __fdiv_rn(__fmul_rn(acc, __fmul_rn(*ap, av)), l);
  else
    return acc / l;
}

// Query rows q0 .. q0+63 of head h of image img; s is the padded sequence,
// d the model width, dh the head width. Called by all kAttnThreads threads
// of the block; it synchronises the block and uses attention_smem<T>(s, dh)
// bytes of `smem`. MODE is kAttnFull or, K24's nosm variant, kAttnMxu.
template <typename T, int MODE = kAttnFull>
__device__ __forceinline__ void attention_tile(const T* qkv, T* out, int s,
                                               int d, int dh, float scale,
                                               int seq_len, int img, int h,
                                               int q0, unsigned char* smem) {
  static_assert(MODE == kAttnFull || MODE == kAttnMxu,
                "K23's other modes run on the tensor-core tiles");
  const int ldk = attn_ldk<T>(dh);
  T* ks = reinterpret_cast<T*>(smem);         // s x ldk
  T* vs = ks + static_cast<size_t>(s) * ldk;  // s x dh
  T* qs = vs + static_cast<size_t>(s) * dh;   // kAttnQT x dh
  float* sc = reinterpret_cast<float*>(smem + attn_t_bytes<T>(s, dh));
  float* lsum = sc + static_cast<size_t>(kAttnQT) * s;

  const size_t ld = 3 * static_cast<size_t>(d);
  const T* base = qkv + static_cast<size_t>(img) * s * ld +
                  static_cast<size_t>(h) * dh;

  __syncthreads();  // the previous tile's readers of smem are done
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
    if (attn_all_keys(MODE) || j < seq_len) {
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
  // place, l = sum of the unrounded p (mxu: p = s rounded, l = 1).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < kAttnQT; i += kAttnThreads / 32) {
    float* row = sc + static_cast<size_t>(i) * s;
    if constexpr (MODE == kAttnMxu) {
      for (int j = lane; j < s; j += 32) row[j] = to_f32(from_f32<T>(row[j]));
      if (lane == 0) lsum[i] = 1.f;
      continue;
    }
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
    for (int j = 0; j < (attn_masked(MODE) ? seq_len : s); ++j)
      acc = fmaf(p[j], to_f32(vs[j * dh + c]), acc);
    out[(static_cast<size_t>(img) * s + q0 + i) * d +
        static_cast<size_t>(h) * dh + c] = from_f32<T>(acc / lsum[i]);
  }
}

}  // namespace vit
