// K2's fp32 tile for Hopper (vit_tpu/ops/pallas/matmul.py:matmul, its
// pallas_call at :212, with the port's residual; matmul_tf32.cu launches
// it): gemm_wgmma.cuh's persistent, warp-specialised walk with the products
// on wgmma.mma_async m64n128k8 tf32 in the three-pass split of
// tf32_split.cuh. One block of 384 threads an SM walks 128 x 128 output
// tiles (tile t at row t % tiles_m, column t / tiles_m); a tile's K runs in
// steps of kBK = 32 floats (one 128-byte swizzle row) through a ring of
// kStages stages.
//
// - The producer warpgroup (threads 256-383) gives registers up. Thread 256
//   keeps TMA loads in flight: for each K step it waits for the stage to be
//   empty and loads the raw fp32 boxes of A and B (32 KB) on the stage's
//   raw barrier.
// - Its warps 1-3 (threads 288-383) turn each stage's raw B box into the
//   operand tf32 wgmma reads: B K-major in shared memory (the transpose bits
//   exist for 16-bit types alone), split into hi and lo, two 16 KB boxes
//   with the 128-byte swizzle; they fence their writes for the async proxy
//   and arrive on the stage's full barrier, one arrival a warp. A w given
//   as it lies, (K, N) row-major, is N-major: its four 32 x 32 raw boxes
//   are transposed in 4 x 4 blocks, a thread reading four 16-byte rows of K
//   and writing four 16-byte rows of N. Lane group (c, d) of eight lanes
//   takes blocks (k4, n4) = (u, 8c + (u ^ d)), u = lane % 8, so that the
//   eight 16-byte loads and the eight stores of each phase fall in eight
//   distinct chunks of a 128-byte row: no bank conflict
//   (tests/test_torch_fp32_split.py checks the map and the banks). A w
//   given as the view w.t() of an (N, K) matrix arrives K-major and is
//   split where it lies.
// - Two consumer warpgroups (threads 0-255) each own 64 rows of the tile.
//   A comes from registers: each thread loads its A fragments from the raw
//   box (x K-major, or the view x.t() of a (K, M) matrix in four 32 x 32
//   boxes, read where it lies) and splits them. Per K step: four k8
//   slices, each lo_a hi_b, hi_a lo_b, hi_a hi_b, twelve wgmma into a fresh
//   fp32 accumulator (the first with scale-d 0), wait for them, release the
//   stage, and add the step's sums to the tile's fp32 total on the FFMA
//   units. The tensor cores' accumulation drops low bits at each
//   instruction (truncation to the accumulator's exponent): three passes
//   into one accumulator over K = 2304 and 6656 missed the 1e-4 bar
//   (2.0e-4, 2.1e-4), a fresh accumulator a 32-deep step held it (9.1e-6
//   at most), as plain fp32 does (tools/tf32_probe.py, PERF.md section 6).
//   Two consumer warpgroups keep the tensor cores busy while one waits.
// - The epilogue reads each total from the accumulator fragment, adds the
//   bias, applies GELU and adds the residual in fp32 (Epilogue::store's
//   order, matmul.cu) and stores pairs of floats.
//
// Ragged edges: TMA fills a box's elements outside the tensor with zeros,
// so sums past M, N or K are zeros; the epilogue masks rows and columns
// past M and N. Every element is summed in the same order on every call,
// and a row's result does not depend on M.
//
// Bound on the card: at B/16 bs=32's QKV (6656 x 768 @ 768 x 2304, 23.6
// GFLOP) the three passes at the TF32 rate, 23.6 GFLOP x 3 / 495 TFLOP/s
// = 0.143 ms (chip_smoke.py: PEAK_OPS_PER_S["tf32x3"]).
//
// K6's fp32 form (matmul.cu's fused_linear; gemm_tf32_ln_wgmma in
// matmul_tf32.cu) is the same walk with an LN prologue in the A fragments:
// x (m, k) and w (k, n) contiguous, mu and rstd from K5. A consumer thread
// loads its A fragments from x's raw box as K2 does and normalises each
// element before the split, ((x - mu) * rstd) * gamma + beta in fp32
// (gemm_tile.cuh:LnPrologue's order): its two rows' mu and rstd once a
// tile, its eight columns' gamma and beta each K step (from L1, as each
// slice is loaded), columns past K exact zeros (TMA's zero x would give
// beta there, and gamma and beta are not read past K). The helper warps,
// which K6's bf16 form has normalise x in shared memory, already turn and
// split B here; the consumers read every A element once in either place,
// so LN costs them three FFMA-unit operations an element and no
// shared-memory pass.
//
// K8's fp32 form (vit_tpu/ops/pallas/patch_embed.py:_embed_kernel, its
// pallas_call at :96; gemm_tf32_embed_wgmma in matmul_tf32.cu) is K2's
// walk on the contiguous (B*N, K) patches and (K, D) weight with the
// epilogue of Tf32Embed, as gemm_wgmma.cuh's EMB flag is for bf16: z = acc
// + bias, then z + pos[i], both in fp32 (_embed_kernel's rounding, the
// cast a no-op), patch row g*N + i stored as token row g*sp + 1 + i. Each
// image's row 0 (cls_row) and pad rows N+1 .. sp-1 (zeros) are written,
// in a column tile's 128 columns, by the block that walks that column's
// first row tile, after its epilogue: once each. K's steps are K2's, so a
// token row is bit for bit K2's fp32 row on the same operands with the
// bias, + pos.

#pragma once

#include <cuda.h>

#include "common.cuh"
#include "gemm_wgmma.cuh"
#include "tf32_split.cuh"

namespace vit {
namespace tf {

constexpr int kBM = 128;       // two consumer warpgroups of 64 rows
constexpr int kBN = 128;
constexpr int kBK = 32;        // one 128-byte swizzle row of fp32
constexpr int kThreads = 384;  // consumers 0-255, producer 256-383
constexpr int kBox = kBM * kBK * 4;   // 16 KB: a 128 x 32 fp32 box
constexpr int kSub = 32 * kBK * 4;    // 4 KB: a 32 x 32 fp32 box
constexpr int kStages = 3;
// A stage: A's raw box, B's raw box, B's hi and lo (K-major).
constexpr int kStageBytes = 4 * kBox;
constexpr int kRawBytes = 2 * kBox;  // what TMA brings a stage
constexpr int kBarOff = kStages * kStageBytes;
// Three barriers a stage (raw, full, empty), + 1024 so that the base can
// be aligned to a swizzle atom: 197,704 bytes.
constexpr int kSmem = kBarOff + 3 * kStages * 8 + 1024;
// The converting threads: the producer warpgroup's warps 1-3.
constexpr int kConv0 = 288;
constexpr int kConvThreads = 96;
// setmaxnreg as in gemm_wgmma.cuh: the launcher refuses a build whose
// kernel got fewer than kPoolRegs / kThreads registers a thread.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kPoolRegs = 256 * kConsumerRegs + 128 * kProducerRegs;
static_assert(kPoolRegs <= 65536, "one block an SM: 64K registers");

// K6's LN prologue (null in K2's kernels): K5's row statistics mu and rstd
// (M,), gamma and beta (K,).
struct Tf32Ln {
  const float* mu;
  const float* rstd;
  const float* gamma;
  const float* beta;
};

// The epilogue's operands, Epilogue<float>'s (matmul.cu): bias (N,) and
// residual (M, N) may be null; vec: out's and the residual's pairs are
// 8-byte aligned (n even, bases aligned).
struct Tf32Epilogue {
  const float* bias;
  const float* residual;
  float* out;
  int m, n, gelu_act;
  bool vec;
};

__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// hi and lo of four floats, stored as 16 bytes each at hi + off, lo + off.
__device__ __forceinline__ void st_split4(uint32_t hi, uint32_t lo,
                                          uint32_t off, float x0, float x1,
                                          float x2, float x3) {
  uint32_t h[4], l[4];
  split_tf32(x0, h[0], l[0]);
  split_tf32(x1, h[1], l[1]);
  split_tf32(x2, h[2], l[2]);
  split_tf32(x3, h[3], l[3]);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(hi + off),
               "r"(h[0]), "r"(h[1]), "r"(h[2]), "r"(h[3])
               : "memory");
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(lo + off),
               "r"(l[0]), "r"(l[1]), "r"(l[2]), "r"(l[3])
               : "memory");
}

// Converting thread j (0 .. kConvThreads - 1): the stage's raw B box at
// raw into hi and lo, K-major ((n, k) at sw128_f32(n, k)). TB: the raw box
// is K-major already (w.t() of an (N, K) matrix), 16-byte chunk c at 16 c;
// else it is four 32 x 32 boxes of w (K, N), (k, n) at (n / 32) kSub +
// sw128_f32(k, n % 32), transposed in 4 x 4 blocks (the header's map).
template <int TB>
__device__ __forceinline__ void convert_b(uint32_t raw, uint32_t hi,
                                          uint32_t lo, int j) {
  if constexpr (TB) {
    for (int c = j; c < kBox / 16; c += kConvThreads) {
      const float4 v = ld_shared_v4(raw + 16 * c);
      st_split4(hi, lo, 16 * c, v.x, v.y, v.z, v.w);
    }
  } else {
    for (int blk = j; blk < 256; blk += kConvThreads) {
      const int grp = blk >> 3, u = blk & 7;
      const int k4 = u, n4 = 8 * (grp >> 3) + (u ^ (grp & 7));
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = ld_shared_v4(raw + (n4 >> 3) * kSub +
                            sw128_f32(4 * k4 + i, 4 * (n4 & 7)));
      st_split4(hi, lo, sw128_f32(4 * n4 + 0, 4 * k4), v[0].x, v[1].x,
                v[2].x, v[3].x);
      st_split4(hi, lo, sw128_f32(4 * n4 + 1, 4 * k4), v[0].y, v[1].y,
                v[2].y, v[3].y);
      st_split4(hi, lo, sw128_f32(4 * n4 + 2, 4 * k4), v[0].z, v[1].z,
                v[2].z, v[3].z);
      st_split4(hi, lo, sw128_f32(4 * n4 + 3, 4 * k4), v[0].w, v[1].w,
                v[2].w, v[3].w);
    }
  }
}

// A consumer's split A fragments of one K step from the raw A box at sa:
// the warp's rows r = 64 wgi + 16 warp + g (+ 8), columns 8 s + t (+ 4) of
// each k8 slice s. TA: the box is four 32 x 32 boxes of x (K, M), (k, m)
// at (m / 32) kSub + sw128_f32(k, m % 32); else x's rows, sw128_f32(r, k).
template <int TA>
__device__ __forceinline__ void load_a(uint32_t sa, int wgi,
                                       uint32_t (&ah)[4][4],
                                       uint32_t (&al)[4][4]) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 64 * wgi + 16 * warp + g + 8 * (i & 1);
      const int c = 8 * s + q + 4 * (i >> 1);
      const uint32_t at = TA ? sa + (r >> 5) * kSub + sw128_f32(c, r & 31)
                             : sa + sw128_f32(r, c);
      split_tf32(ld_shared_f32(at), ah[s][i], al[s][i]);
    }
}

// K6's form of load_a (x as it lies): each element normalised before the
// split with st[h] = (mu, rstd) of the thread's row g + 8 h and its
// column's gamma and beta (column k0 + 8 s + q + 4 u of the step at k0,
// read from L1 as the slice is loaded: the registers hold the tile's sums
// twice and the fragments); zero where the column is past K.
__device__ __forceinline__ void load_a_ln(uint32_t sa, int wgi,
                                          const float2 (&st)[2],
                                          const Tf32Ln& ln, int k0, int k,
                                          uint32_t (&ah)[4][4],
                                          uint32_t (&al)[4][4]) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int s = 0; s < kBK / 8; ++s)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = 8 * s + q + 4 * u;
      const bool in_k = k0 + c < k;
      const float ga = in_k ? __ldg(ln.gamma + k0 + c) : 0.f;
      const float be = in_k ? __ldg(ln.beta + k0 + c) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wgi + 16 * warp + g + 8 * h;
        const float v = ld_shared_f32(sa + sw128_f32(r, c));
        split_tf32(in_k ? (v - st[h].x) * st[h].y * ga + be : 0.f,
                   ah[s][2 * u + h], al[s][2 * u + h]);
      }
    }
}

// K8's epilogue operands (the walk's EMB form): m = batch * n_tok patch
// rows into out (batch, sp, n) tokens; bias (n,), pos (n_tok, n), cls
// (n,). n is a multiple of 4 (tf32_takes). vec: out's and pos's pairs are
// 8-byte aligned.
struct Tf32Embed {
  const float* bias;
  const float* pos;
  const float* cls;
  float* out;
  int m, n, n_tok, sp, batch;
  bool vec;
};

// One consumer warpgroup's epilogue: its 64 rows of the tile at (m0, n0).
__device__ __forceinline__ void epilogue(const float (&d)[64],
                                         const Tf32Epilogue& ep, int m0,
                                         int n0) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int gc = n0 + 8 * j + 2 * (lane % 4);
    if (gc >= ep.n) continue;
    const bool two = gc + 1 < ep.n;
    float b0 = 0.f, b1 = 0.f;
    if (ep.bias) {
      b0 = ep.bias[gc];
      if (two) b1 = ep.bias[gc + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = m0 + 16 * warp + lane / 4 + 8 * h;
      if (gr >= ep.m) continue;
      float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (ep.bias) {
        v0 += b0;
        v1 += b1;
      }
      if (ep.gelu_act) {
        v0 = gelu(v0);
        v1 = gelu(v1);
      }
      const size_t idx = static_cast<size_t>(gr) * ep.n + gc;
      if (ep.vec && two) {
        if (ep.residual) {
          const float2 r = *reinterpret_cast<const float2*>(ep.residual + idx);
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<float2*>(ep.out + idx) = make_float2(v0, v1);
      } else {
        if (ep.residual) {
          v0 += ep.residual[idx];
          if (two) v1 += ep.residual[idx + 1];
        }
        ep.out[idx] = v0;
        if (two) ep.out[idx + 1] = v1;
      }
    }
  }
}

// K8's epilogue of one consumer warpgroup's 64 rows of the tile at (m0,
// n0): (acc + bias) + pos[i] in fp32 into token row g*sp + 1 + i of patch
// row g*n_tok + i.
__device__ __forceinline__ void epilogue(const float (&d)[64],
                                         const Tf32Embed& ep, int m0,
                                         int n0) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  size_t orow[2], prow[2];
  bool in_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = m0 + 16 * warp + lane / 4 + 8 * h;
    in_m[h] = gr < ep.m;
    const int g = gr / ep.n_tok, i = gr % ep.n_tok;
    orow[h] = (static_cast<size_t>(g) * ep.sp + 1 + i) * ep.n;
    prow[h] = static_cast<size_t>(i) * ep.n;
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int gc = n0 + 8 * j + 2 * (lane % 4);
    if (gc >= ep.n) continue;  // n is even: gc + 1 < n too
    const float b0 = ep.bias[gc], b1 = ep.bias[gc + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!in_m[h]) continue;
      const float* p = ep.pos + prow[h] + gc;
      float* o = ep.out + orow[h] + gc;
      const float v0 = d[4 * j + 2 * h] + b0, v1 = d[4 * j + 2 * h + 1] + b1;
      if (ep.vec) {
        const float2 pv = __ldg(reinterpret_cast<const float2*>(p));
        *reinterpret_cast<float2*>(o) = make_float2(v0 + pv.x, v1 + pv.y);
      } else {
        o[0] = v0 + __ldg(p);
        o[1] = v1 + __ldg(p + 1);
      }
    }
  }
}

// K8: each image's row 0 (cls) and pad rows n_tok+1 .. sp-1 (zeros) in the
// column tile at n0, by the block's 256 consumer threads, four floats a
// store (16 bytes where out and cls are 16-byte aligned; n is a multiple
// of 4, so every row is).
__device__ __forceinline__ void embed_fixed_rows(const Tf32Embed& ep,
                                                 int n0) {
  const int extra = ep.sp - ep.n_tok;  // row 0, rows n_tok+1 .. sp-1
  const int cols = min(kBN, ep.n - n0);
  constexpr int CPR = kBN / 4;  // four-float chunks a row
  const bool vec = reinterpret_cast<uintptr_t>(ep.out) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ep.cls) % 16 == 0;
  for (int e = threadIdx.x; e < ep.batch * extra * CPR; e += 256) {
    const int c = (e % CPR) * 4, r = e / CPR;
    if (c >= cols) continue;
    const int g = r / extra, j = r % extra;
    const int row = j == 0 ? 0 : ep.n_tok + j;
    float* o = ep.out + (static_cast<size_t>(g) * ep.sp + row) * ep.n + n0 + c;
    if (vec) {
      *reinterpret_cast<float4*>(o) =
          j == 0 ? *reinterpret_cast<const float4*>(ep.cls + n0 + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int u = 0; u < 4; ++u) o[u] = j == 0 ? ep.cls[n0 + c + u] : 0.f;
    }
  }
}

// What a consumer thread does after its warpgroup's epilogue of the tile
// at (m0, n0): nothing for K2 and K6; for K8 in the first row tile its
// share of the column tile's fixed rows (rows no epilogue writes).
__device__ __forceinline__ void tile_done(const Tf32Epilogue&, int, int) {}
__device__ __forceinline__ void tile_done(const Tf32Embed& ep, int m0,
                                          int n0) {
  if (m0 == 0) embed_fixed_rows(ep, n0);
}

// (m, k) @ (k, n) in fp32: A through map_a, B through map_b. TA: A is the
// view of a (k, m) matrix (four 32 x 32 boxes a step); TB: B is the view of
// an (n, k) matrix (one 32 x 128 box); else A is one 32 x 128 box of x and
// B four 32 x 32 boxes of w. LN (K6, TA and TB 0): A's elements normalised
// with ln's statistics and parameters as they are loaded. Ep: the
// epilogue, K2's Tf32Epilogue or K8's Tf32Embed (TA and TB 0, no LN). ep
// and ln come by value: so K2's kernels compile to the code they had
// before K6's form shared this walk (tools/sass_count.py --exact).
template <int TA, int TB, bool LN, typename Ep = Tf32Epilogue>
__device__ __forceinline__ void gemm_tf32_walk(const CUtensorMap& map_a,
                                               const CUtensorMap& map_b,
                                               Ep ep, int k, Tf32Ln ln) {
  extern __shared__ uint8_t tf_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tf_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = wg::smem_u32(smem);
  // raw: TMA's bytes have arrived; full: the converters have written hi
  // and lo; empty: both consumer warpgroups are done with the stage.
  const uint32_t raw0 = base + kBarOff, full0 = raw0 + 8 * kStages;
  const uint32_t empty0 = full0 + 8 * kStages;
  const int tiles_m = (ep.m + kBM - 1) / kBM;
  const int tiles = tiles_m * ((ep.n + kBN - 1) / kBN);
  const int nk = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(raw0 + 8 * s, 1);
      wg::mbar_init(full0 + 8 * s, kConvThreads / 32);
      wg::mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
        for (int kb = 0; kb < nk; ++kb) {
          const int k0 = kb * kBK;
          wg::mbar_wait(empty0 + 8 * s, ph ^ 1);
          const uint32_t bar = raw0 + 8 * s;
          wg::mbar_expect_tx(bar, kRawBytes);
          const uint32_t sa = base + s * kStageBytes, sb = sa + kBox;
          if (TA) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wg::tma_load(sa + j * kSub, &map_a, bar, m0 + 32 * j, k0);
          } else {
            wg::tma_load(sa, &map_a, bar, k0, m0);
          }
          if (TB) {
            wg::tma_load(sb, &map_b, bar, k0, n0);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wg::tma_load(sb + j * kSub, &map_b, bar, n0 + 32 * j, k0);
          }
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else if (threadIdx.x >= kConv0) {
      // The converters: each stage's raw B box into hi and lo, in the
      // ring's order.
      const int j = threadIdx.x - kConv0;
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kb = 0; kb < nk; ++kb) {
          wg::mbar_wait(raw0 + 8 * s, ph);
          const uint32_t sb = base + s * kStageBytes + kBox;
          convert_b<TB>(sb, sb + kBox, sb + 2 * kBox, j);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (j % 32 == 0) wg::mbar_arrive(full0 + 8 * s);
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    float d[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
      // LN: this thread's two rows' statistics (zero past M).
      float2 st[2];
      if constexpr (LN) {
        const int r0 = m0 + 64 * wgi + 16 * ((threadIdx.x % 128) / 32) +
                       (threadIdx.x % 32) / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st[h] = r0 + 8 * h < ep.m
                      ? make_float2(ln.mu[r0 + 8 * h], ln.rstd[r0 + 8 * h])
                      : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      for (int kb = 0; kb < nk; ++kb) {
        wg::mbar_wait(raw0 + 8 * s, ph);   // A's raw box
        wg::mbar_wait(full0 + 8 * s, ph);  // B's hi and lo
        const uint32_t sa = base + s * kStageBytes;
        const uint32_t bhi = sa + 2 * kBox, blo = sa + 3 * kBox;
        uint32_t ah[kBK / 8][4], al[kBK / 8][4];
        if constexpr (LN)
          load_a_ln(sa, wgi, st, ln, kb * kBK, k, ah, al);
        else
          load_a<TA>(sa, wgi, ah, al);
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          const uint64_t dh = wg::sw128_desc(bhi + 32 * kk, 16, 1024);
          const uint64_t dl = wg::sw128_desc(blo + 32 * kk, 16, 1024);
          wgmma_tf32(part, al[kk], dh, kk > 0);
          wgmma_tf32(part, ah[kk], dl, 1);
          wgmma_tf32(part, ah[kk], dh, 1);
        }
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_acc(part);
        if (threadIdx.x % 128 == 0) wg::mbar_arrive(empty0 + 8 * s);
#pragma unroll
        for (int i = 0; i < 64; ++i) d[i] += part[i];
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      epilogue(d, ep, m0 + 64 * wgi, n0);
      tile_done(ep, m0, n0);
    }
  }
}

constexpr int kMaxDevices = 64;  // launch_walk's callers' counts of SMs

// One launch of `kernel`, a kernel of this walk (kThreads threads, kSmem
// bytes): on the device's first launch (sms, the caller's count of the
// device's SMs for this kernel, still 0) the shared-memory limit and the
// register check; one persistent block an SM, at most one a tile of the
// (m, n) output.
template <typename Kernel, typename... Args>
cudaError_t launch_walk(Kernel kernel, int& sms, int m, int n, int device,
                        cudaStream_t st, const Args&... args) {
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr{};
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    // Fewer registers than the split needs: setmaxnreg.inc would wait
    // forever, so refuse the launch.
    if (attr.numRegs * kThreads < kPoolRegs)
      return cudaErrorLaunchOutOfResources;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    sms = count;
  }
  const long long tiles = static_cast<long long>((m + kBM - 1) / kBM) *
                          ((n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmem, st>>>(args...);
  return cudaGetLastError();
}

template <int TA, int TB>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tf32_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    Tf32Epilogue ep, int k) {
  gemm_tf32_walk<TA, TB, false>(map_a, map_b, ep, k, Tf32Ln{});
}

}  // namespace tf
}  // namespace vit
