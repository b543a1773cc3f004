// K2's bf16 tile for Hopper (vit_tpu/ops/pallas/matmul.py:matmul, its
// pallas_call at :212, with the port's residual; matmul_wgmma.cu launches
// it): a persistent, warp-specialised GEMM on wgmma fed by TMA. One block
// of 384 threads an SM walks 128 x 128 output tiles (tile t of the grid's
// walk at row t % tiles_m, column t / tiles_m); a tile's K runs in steps
// of kBK = 64 through a ring of kStages shared-memory stages.
//
// - The producer warpgroup (threads 256-383) gives its registers up
//   (setmaxnreg.dec) and one of its threads keeps TMA loads in flight: for
//   each K step it waits for the stage to be empty, arms the stage's full
//   barrier with the bytes to come and issues the A and B box loads. It runs
//   ahead into the next tile while the consumers finish this one.
// - Two consumer warpgroups (threads 0-255) take the registers
//   (setmaxnreg.inc); each owns 64 rows of the tile and keeps its 64 x 128
//   fp32 sums in registers. Per K step: wait for the stage, four
//   wgmma.mma_async m64n128k16 (bf16 in, fp32 sums), commit, wait for the
//   previous step's group, release that step's stage.
// - The epilogue reads each sum from the accumulator fragment, adds the
//   bias, applies GELU, adds the residual, all in fp32, and casts once
//   (Epilogue::store's order, matmul.cu), into a padded staging tile in
//   shared memory; the warpgroup then writes its rows with 16-byte stores.
//
// Why 128 x 128 with both warpgroups on one tile (PERF.md section 6): a
// wider tile halves the tiles (54 for the QKV weight gradient on 132
// SMs), and warpgroups owning whole tiles in turn leave one idle where a
// block has one or two tiles.
//
// Layouts. Every operand arrives through a 2-D tensor map with 128-byte
// swizzle, so one box row is 64 bf16 and 8 box rows form a 1024-byte
// swizzle atom. A K-major operand (A as x, B as the view w.t() of an
// (N, K) matrix) is one box of kBK columns by all its rows: the wgmma
// descriptor's stride between 8-row groups is 1024 bytes, and a k16 step
// moves its start 32 bytes. An MN-major operand (A as the view x.t() of a
// (K, M) matrix, B as w) is boxes of 64 MN columns by kBK K rows, 8 KB
// each: the descriptor's leading offset (one 64-wide MN block to the next)
// is 8 KB, its stride between 8-row K groups 1024 bytes, and a k16 step
// moves its start 16 rows, 2 KB. wgmma reads either major order of a bf16
// operand (its transpose bits), so a transposed operand costs nothing: the
// training backward's x.t() @ g and g @ w.t() read x and w where they lie.
//
// K6, fused_linear (vit_tpu/ops/pallas/matmul.py:fused_linear, its
// pallas_call at :388), runs on this tile in bf16 (template flag LN,
// matmul_wgmma.cu:launch_wgmma_ln) wherever gemm_path would give K2 the
// wgmma tile on its (contiguous) x and w. x's raw box arrives by TMA on a
// third barrier a stage, and the producer warpgroup's three idle warps
// normalise it in place -- ((x - mu) * rstd) * gamma + beta in fp32 with
// K5's row stats (held in registers for the tile), rounded to bf16, zero
// past K -- fence it for the async proxy and arrive on the stage's full
// barrier, one arrival a warp; the consumers then run K2's loop
// unchanged. The pass runs up to the ring's depth ahead of the
// products, off the consumers' path (PERF.md, section 6).
//
// K8, embed_fused (vit_tpu/ops/pallas/patch_embed.py:_embed_kernel, its
// pallas_call at :96), runs on this tile in bf16 (template flag EMB,
// matmul_wgmma.cu:launch_wgmma_embed) wherever gemm_path would give K2 the
// wgmma tile on the contiguous (B*N, K) patches and (K, D) weight: K2's
// loop and sum order unchanged, its epilogue with _embed_kernel's rounding
// -- z = acc + bias in fp32, cast to bf16, then z + pos[i] in bf16 -- and
// patch row g*N + i stored as token row g*sp + 1 + i. Each image's row 0
// (cls_row) and pad rows N+1 .. sp-1 (zeros) are written, in a column
// tile's 128 columns, by the block that walks that column's first row tile
// (m0 = 0), after its epilogue: one tile a column, so once each.
//
// Ragged edges: TMA fills every element of a box outside the tensor with
// zeros and still counts the whole box's bytes, so sums past M, N or K are
// zeros; the epilogue masks rows and columns past M and N. The sum of an
// element runs over K in order, one k16 step after another, so every call
// gives the same bits, and a row's result does not depend on M.
//
// Bound on the card: at B/16 bs=32's QKV (6656 x 768 @ 768 x 2304, 23.6
// GFLOP) the tensor cores, 0.0238 ms at 989 TFLOP/s; K6 at L/16-384's
// LN + QKV (4736 x 1024 @ 1024 x 3072) 0.0301 ms. On an NVIDIA H100 80GB
// HBM3 at 700 W K6 takes about 0.126 ms there on the card
// (tools/turns.py), 1.4 times K1 -> K2 on the same operands, its LN pass
// about 0.034 ms of it (tools/stack_ablate.py k6_no_ln); K8 at L/16-384
// bs=4 (2304 x 768 @ 768 x 1024, 3.6 GFLOP: 0.0037 ms) about 0.020 ms,
// 1.04 times K2 on the same operands, B/16 bs=1 and 4 within 1.03 times.
// What this tile still
// leaves: the epilogue is not overlapped with the next tile's products
// (both warpgroups store at once), and a shape with fewer tiles than SMs
// (a weight gradient with N = 768, K8 at bs <= 4: 12 and 42 tiles at B/16
// bs=1 and 4) leaves SMs idle: split-K, as a deterministic two-pass sum,
// or a 64-row tile would fill them.

#pragma once

#include <cuda.h>

#include "common.cuh"

namespace vit {
namespace wg {

constexpr int kBM = 128;       // two consumer warpgroups of 64 rows
constexpr int kBK = 64;        // one 128-byte swizzle row of bf16
constexpr int kThreads = 384;  // consumers 0-255, producer 256-383
constexpr int kAtom = 8192;    // a 64 x 64 bf16 box
// Registers a thread after setmaxnreg: the producer's warpgroup gives its
// share back, the consumers' take it. setmaxnreg.inc waits until the
// block's pool holds kPoolRegs, so the launcher refuses a build whose
// kernel got fewer than kPoolRegs / kThreads registers a thread (the
// launch bound's 168) instead of launching a block that never starts.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kPoolRegs = 256 * kConsumerRegs + 128 * kProducerRegs;
static_assert(kPoolRegs <= 65536, "one block an SM: 64K registers");
// A deadlock of the pipeline traps (a launch error) after about 10 s
// instead of hanging the card.
constexpr long long kWaitCycles = 20000000000LL;

constexpr int kBN = 128;
constexpr int kStages = 5;
constexpr int kABytes = kBM * kBK * 2;  // 16 KB
constexpr int kStageBytes = kABytes + kBN * kBK * 2;
constexpr int kLdc = kBN + 8;  // staging row in bf16: no bank conflicts
constexpr int kCOff = kStages * kStageBytes;
constexpr int kBarOff = kCOff + 2 * 64 * kLdc * 2;
// Three barriers a stage (K2 uses two), + 1024 so that the base can be
// aligned to a swizzle atom: 199,800 bytes.
constexpr int kSmem = kBarOff + 3 * kStages * 8 + 1024;

// K6 (LN): the producer warpgroup's warps 1-3 normalise each stage's x box
// in place between its TMA and the consumers; they need registers the
// consumers give up.
constexpr int kLnThreads = 96;  // threads 288-383
constexpr int kLnStep = kLnThreads / 8;  // rows between an LN thread's rows
constexpr int kLnRows = (kBM + kLnStep - 1) / kLnStep;  // rows a thread
constexpr int kLnProducerRegs = 88;
constexpr int kLnConsumerRegs = 208;
static_assert(256 * kLnConsumerRegs + 128 * kLnProducerRegs <= kPoolRegs,
              "K6's split fits K2's pool");

// K6's LN prologue on the A operand: the row stats mu and rstd (M,) from
// K5, gamma and beta (K,); vec: gamma and beta 16-byte aligned.
struct WgLn {
  const float* mu;
  const float* rstd;
  const bf16* gamma;
  const bf16* beta;
  int k;
  bool vec;
};

// The epilogue forms of the tile beyond K2's (template parameter XEP):
// K23's probe GEMMs (attn_core_probe.cu's ProbeEp, each code + 1) and
// K22's raw fp32 sums.
enum WgXep : int {
  kXepNone = 0,     // K2's (K6's; K8's with EMB)
  kXepSplitQ = 1,   // + bias[col]; the q third into alt (M, d), the rest
                    // into out (M, N)
  kXepSplitKT = 2,  // + bias[col]; the k third transposed into alt (d, M),
                    // q and v into out (M, N)
  kXepAllT = 3,     // + bias[col], transposed into out (N, M)
  kXepRowBias = 4,  // + bias[row] into out (M, N)
  kXepOutX = 5,     // (acc + bias[row]) + residual (M, N) into out (M, N)
  kXepOutT = 6,     // (round(acc) + bias[row]) + residual (N, M), into out
                    // (N, M)
  kXepRawF32 = 7,   // the fp32 sums as they stand into out_f32 (M, N)
};

// The epilogue's operands: bias (N,) and residual (M, N) may be null. K8
// (EMB): M = batch * n_tok patch rows into (batch, sp, N) tokens, pos
// (n_tok, N), cls (N,). K23 (XEP): bias (N,) or, per row, (M,), residual
// (M, N) or, for kXepOutT, (N, M); alt the split buffer; d the model
// width. K22 (kXepRawF32): out_f32 (M, N), vec_out its pairs 8-byte
// aligned (n even, base aligned).
struct WgEpilogue {
  const bf16* bias;
  const bf16* residual;
  bf16* out;
  int m, n, gelu_act;
  bool vec_res;  // residual pairs are 4-byte aligned (n even, base aligned)
  bool vec_out;  // out rows are 16-byte aligned (n % 8 == 0, base aligned)
  const bf16* pos;
  const bf16* cls;
  int n_tok, sp, batch;
  bool vec_pos;  // pos pairs are 4-byte aligned (n even, base aligned)
  bf16* alt;
  int d;
  bool vec_alt;  // alt's rows are 16-byte aligned (d % 8 == 0 for kXepSplitQ,
                 // m % 8 == 0 for kXepSplitKT; base aligned)
  bool vec_t;    // the transposed rows (m long) of out, residual and the
                 // row bias are 16-byte aligned (m % 8 == 0, bases aligned)
  float* out_f32;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` of the barrier to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// Whether the phase of parity `parity` of the barrier has completed, tried
// once (a producer that must not wait on a slot others still hold).
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Load the box at coordinates (c0 innermost, c1) of `map` into shared
// memory at `dst`, completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading byte offset and stride byte offset, each in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the sums across a
// wgmma fence or wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VIT_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define VIT_F64(d, i)                                                   \
  VIT_F8(d, i), VIT_F8(d, i + 8), VIT_F8(d, i + 16), VIT_F8(d, i + 24),  \
      VIT_F8(d, i + 32), VIT_F8(d, i + 40), VIT_F8(d, i + 48),          \
      VIT_F8(d, i + 56)

// d += A (64 x 16) @ B (16 x 128) on the tensor cores; TA, TB are the
// transpose bits (1: A M-major, B N-major).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : VIT_F64(d, 0)
      : "l"(da), "l"(db), "n"(1), "n"(TA), "n"(TB));
}

#undef VIT_F64
#undef VIT_F8

// K6's normalisation of one element, LnPrologue::apply's (gemm_tile.cuh):
// ((x - mu) * rstd) * gamma + beta in fp32.
__device__ __forceinline__ float ln_elem(float x, float mu, float rs,
                                         float g, float b) {
  return (x - mu) * rs * g + b;
}

// bf16 pair in a 32-bit word (lower column in the low half) to fp32.
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// K6: gamma and beta of LN thread j's chunk column c = j % 8 of a K step,
// columns col .. col + 7 (col = k0 + 8c; none read past K). They do not
// depend on x, so each step's are loaded before its box arrives.
__device__ __forceinline__ void ln_gb(const WgLn& ln, int col, float (&g)[8],
                                      float (&b)[8]) {
  if (col >= ln.k) return;
  if (ln.vec) {
    const uint4 gw = __ldg(reinterpret_cast<const uint4*>(ln.gamma + col));
    const uint4 bw = __ldg(reinterpret_cast<const uint4*>(ln.beta + col));
    const uint32_t gv[4] = {gw.x, gw.y, gw.z, gw.w};
    const uint32_t bv[4] = {bw.x, bw.y, bw.z, bw.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g[2 * e] = bf_lo(gv[e]);
      g[2 * e + 1] = bf_hi(gv[e]);
      b[2 * e] = bf_lo(bv[e]);
      b[2 * e + 1] = bf_hi(bv[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      g[e] = to_f32(ln.gamma[col + e]);
      b[e] = to_f32(ln.beta[col + e]);
    }
  }
}

// K6: the stats of LN thread j's rows of the tile at m0, rows j / 8 +
// kLnStep * i (0 past M, where TMA reads zeros and nothing is stored),
// held for the tile's K steps.
__device__ __forceinline__ void ln_stats(const WgLn& ln, int m0, int m,
                                         int j, float (&mu)[kLnRows],
                                         float (&rs)[kLnRows]) {
#pragma unroll
  for (int i = 0; i < kLnRows; ++i) {
    const int row = m0 + j / 8 + kLnStep * i;
    const bool live = j / 8 + kLnStep * i < kBM && row < m;
    mu[i] = live ? ln.mu[row] : 0.f;
    rs[i] = live ? ln.rstd[row] : 0.f;
  }
}

// K6: normalise, in place, the 128 x 64 raw x box of a stage at sa
// (columns k0 ..), by LN thread j (0 .. kLnThreads - 1): chunk column
// c = j % 8 (columns col = k0 + 8c ..) of its rows (ln_stats), with the
// chunk's gamma and beta (ln_gb); chunks at columns >= K become zeros.
// Eight neighbouring threads cover one row's 128 bytes: no bank
// conflict. Four rows at a time, their loads before any store. The
// caller fences the writes for the async proxy before it tells the
// consumers.
__device__ __forceinline__ void ln_box(uint32_t sa, int col, const WgLn& ln,
                                       const float (&mu)[kLnRows],
                                       const float (&rs)[kLnRows],
                                       const float (&g)[8],
                                       const float (&b)[8], int j) {
  const int c = j % 8;
  const bool in = col < ln.k;
#pragma unroll
  for (int i0 = 0; i0 < kLnRows; i0 += 4) {
    uint32_t addr[4], v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = j / 8 + kLnStep * (i0 + u);
      addr[u] = sa + r * 128 + ((c ^ (r & 7)) << 4);
      v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0u;
      if (in && i0 + u < kLnRows && r < kBM)
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v[u][0]), "=r"(v[u][1]), "=r"(v[u][2]),
                       "=r"(v[u][3])
                     : "r"(addr[u]));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (!in || i0 + u >= kLnRows) break;
      const int i = i0 + u < kLnRows ? i0 + u : 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 y = __floats2bfloat162_rn(
            ln_elem(bf_lo(v[u][e]), mu[i], rs[i], g[2 * e], b[2 * e]),
            ln_elem(bf_hi(v[u][e]), mu[i], rs[i], g[2 * e + 1],
                    b[2 * e + 1]));
        v[u][e] = *reinterpret_cast<const uint32_t*>(&y);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u < kLnRows && j / 8 + kLnStep * (i0 + u) < kBM)
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(
                         addr[u]),
                     "r"(v[u][0]), "r"(v[u][1]), "r"(v[u][2]), "r"(v[u][3])
                     : "memory");
  }
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// K8: the pos pairs (bf16 x 2 in a word) of the thread's accumulator
// values in the warpgroup's 64 rows of the tile at (m0, n0): pv[j][h]
// belongs to row 16 * warp + lane / 4 + 8h, columns 8j + 2 (lane % 4) and
// + 1 (zeros past M and N). Loaded when the tile starts, so that the K
// loop hides their latency: the compiler does not move loads in the
// epilogue past its staging stores, so there each would wait in turn
// (PERF.md, section 6).
__device__ __forceinline__ void embed_pos(const WgEpilogue& ep, int m0,
                                          int n0, uint32_t (&pv)[kBN / 8][2]) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = m0 + 16 * warp + lane / 4 + 8 * h;
    const bf16* pr =
        ep.pos + static_cast<size_t>(gr < ep.m ? gr % ep.n_tok : 0) * ep.n;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int gc = n0 + 8 * j + 2 * (lane % 4);
      pv[j][h] = 0u;
      if (gr < ep.m && gc + 1 < ep.n && ep.vec_pos) {
        pv[j][h] = __ldg(reinterpret_cast<const unsigned int*>(pr + gc));
      } else if (gr < ep.m && gc < ep.n) {
        const bf16 lo = pr[gc];
        const bf16 hi = gc + 1 < ep.n ? pr[gc + 1] : __float2bfloat16_rn(0.f);
        pv[j][h] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
                   (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
      }
    }
  }
}

// One consumer warpgroup's epilogue: its 64 rows of the tile at (m0, n0),
// sums in the wgmma accumulator layout (value 4j + i of a thread is row
// 16 * warp + lane / 4 + 8 * (i / 2), column 8j + 2 * (lane % 4) + i % 2).
// EMB: K8's rounding (pv from embed_pos) and row map instead of GELU and
// the residual.
template <bool EMB>
__device__ __forceinline__ void epilogue(const float (&d)[64],
                                         const WgEpilogue& ep, int m0, int n0,
                                         bf16* cs, int wgi,
                                         const uint32_t (&pv)[kBN / 8][2]) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  named_sync(1 + wgi);  // this warpgroup's readers of cs are done
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * (lane % 4), gc = n0 + c;
    float b0 = 0.f, b1 = 0.f;
    if (ep.bias) {
      if (gc < ep.n) b0 = to_f32(ep.bias[gc]);
      if (gc + 1 < ep.n) b1 = to_f32(ep.bias[gc + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + lane / 4 + 8 * h, gr = m0 + r;
      float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (ep.bias) {
        v0 += b0;
        v1 += b1;
      }
      if constexpr (EMB) {
        // z = bf16(acc + bias), then z + pos[i] rounded once more (below).
        v0 = __bfloat162float(__float2bfloat16_rn(v0)) + bf_lo(pv[j][h]);
        v1 = __bfloat162float(__float2bfloat16_rn(v1)) + bf_hi(pv[j][h]);
      } else if (ep.gelu_act) {
        v0 = gelu(v0);
        v1 = gelu(v1);
      }
      if (!EMB && ep.residual && gr < ep.m) {
        const bf16* rp = ep.residual + static_cast<size_t>(gr) * ep.n + gc;
        if (ep.vec_res && gc + 1 < ep.n) {
          const __nv_bfloat162 rv = *reinterpret_cast<const __nv_bfloat162*>(rp);
          v0 += __low2float(rv);
          v1 += __high2float(rv);
        } else {
          if (gc < ep.n) v0 += to_f32(rp[0]);
          if (gc + 1 < ep.n) v1 += to_f32(rp[1]);
        }
      }
      *reinterpret_cast<__nv_bfloat162*>(cs + r * kLdc + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  named_sync(1 + wgi);
  constexpr int CPR = kBN / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int ch = t; ch < 64 * CPR; ch += 128) {
    const int r = ch / CPR, c = (ch % CPR) * 8;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= ep.m || gc >= ep.n) continue;
    // EMB: patch row g*n_tok + i is token row g*sp + 1 + i.
    const int orow =
        EMB ? gr / ep.n_tok * ep.sp + 1 + gr % ep.n_tok : gr;
    bf16* o = ep.out + static_cast<size_t>(orow) * ep.n + gc;
    const bf16* s = cs + r * kLdc + c;
    if (ep.vec_out && gc + 8 <= ep.n) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int e = 0; e < 8 && gc + e < ep.n; ++e) o[e] = s[e];
    }
  }
}

// K8: each image's row 0 (cls) and pad rows n_tok+1 .. sp-1 (zeros) in the
// column tile at n0, by the block's 256 consumer threads, 16 bytes a
// store (N is a multiple of 8 on this tile; cls and out 16-byte aligned
// where vec_out, else element by element).
__device__ __forceinline__ void embed_fixed_rows(const WgEpilogue& ep,
                                                 int n0) {
  const int extra = ep.sp - ep.n_tok;  // row 0, rows n_tok+1 .. sp-1
  const int cols = min(kBN, ep.n - n0);
  constexpr int CPR = kBN / 8;  // 16-byte chunks a row
  const bool vec = ep.vec_out && reinterpret_cast<uintptr_t>(ep.cls) % 16 == 0;
  for (int e = threadIdx.x; e < ep.batch * extra * CPR; e += 256) {
    const int c = (e % CPR) * 8, r = e / CPR;
    if (c >= cols) continue;
    const int g = r / extra, j = r % extra;
    const int row = j == 0 ? 0 : ep.n_tok + j;
    bf16* o = ep.out + (static_cast<size_t>(g) * ep.sp + row) * ep.n + n0 + c;
    if (vec && c + 8 <= cols) {
      *reinterpret_cast<uint4*>(o) =
          j == 0 ? *reinterpret_cast<const uint4*>(ep.cls + n0 + c)
                 : make_uint4(0, 0, 0, 0);
    } else {
      for (int u = 0; u < 8 && c + u < cols; ++u)
        o[u] = j == 0 ? ep.cls[n0 + c + u] : __float2bfloat16_rn(0.f);
    }
  }
}

// K23's probe GEMMs (XEP from kXepSplitQ to kXepOutT): one consumer
// warpgroup's 64 rows of the tile at (m0, n0), in up to two rounds
// through its staging tile: first the columns stored row-major (into out,
// or alt for kXepSplitQ's q third), then those stored transposed
// (kXepSplitKT's k third into alt (d, M); every column of kXepAllT and
// kXepOutT into out (N, M)). For the second the staging tile is written
// transposed: column c of the tile is a row of 64 bf16 (the warpgroup's
// rows) whose 16-byte chunks are XOR-swizzled by c % 8, so that neither
// the accumulators' 2-byte writes nor the 16-byte reads conflict on a
// bank, and every device store is 16 contiguous bytes where the rows are
// aligned. The order of each element's operations is ProbeEpilogue's
// (attn_core_probe.cu); kXepOutT stages round(acc) and adds the row bias
// and the residual, 8 contiguous elements at a time, as it stores.
template <int XEP>
__device__ __forceinline__ void probe_epilogue(const float (&d)[64],
                                               const WgEpilogue& ep, int m0,
                                               int n0, bf16* cs, int wgi) {
  constexpr bool kAllT = XEP == kXepAllT || XEP == kXepOutT;
  constexpr bool kColBias =
      XEP == kXepSplitQ || XEP == kXepSplitKT || XEP == kXepAllT;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  auto trans = [&](int gc) {
    return kAllT || (XEP == kXepSplitKT && gc >= ep.d && gc < 2 * ep.d);
  };
  // The element (row r, column c) of the transposed staging tile.
  auto tidx = [](int c, int r) {
    return c * 64 + ((((r >> 3) ^ (c & 7))) << 3) + (r & 7);
  };
  const int c_hi = min(n0 + kBN, ep.n);
  const bool any_t = kAllT || (XEP == kXepSplitKT && n0 < 2 * ep.d &&
                               c_hi > ep.d);
  const bool any_r = !kAllT && (XEP != kXepSplitKT || n0 < ep.d ||
                                c_hi > 2 * ep.d);
  for (int round = 0; round < 2; ++round) {
    const bool tr = round == 1;
    if (tr ? !any_t : !any_r) continue;
    named_sync(1 + wgi);  // this warpgroup's readers of cs are done
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4), gc = n0 + c;
      float b0 = 0.f, b1 = 0.f;
      if (kColBias) {
        if (gc < ep.n) b0 = to_f32(ep.bias[gc]);
        if (gc + 1 < ep.n) b1 = to_f32(ep.bias[gc + 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + lane / 4 + 8 * h, gr = m0 + r;
        float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        if constexpr (kColBias) {
          v0 += b0;
          v1 += b1;
        } else if constexpr (XEP == kXepRowBias || XEP == kXepOutX) {
          const float br = gr < ep.m ? to_f32(ep.bias[gr]) : 0.f;
          v0 += br;
          v1 += br;
          if (XEP == kXepOutX && gr < ep.m) {
            const bf16* rp = ep.residual + static_cast<size_t>(gr) * ep.n + gc;
            if (ep.vec_res && gc + 1 < ep.n) {
              const __nv_bfloat162 rv =
                  *reinterpret_cast<const __nv_bfloat162*>(rp);
              v0 += __low2float(rv);
              v1 += __high2float(rv);
            } else {
              if (gc < ep.n) v0 += to_f32(rp[0]);
              if (gc + 1 < ep.n) v1 += to_f32(rp[1]);
            }
          }
        }
        if (tr) {
          cs[tidx(c, r)] = __float2bfloat16_rn(v0);
          cs[tidx(c + 1, r)] = __float2bfloat16_rn(v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(cs + r * kLdc + c) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    named_sync(1 + wgi);
    if (!tr) {
      constexpr int CPR = kBN / 8;  // 16-byte chunks a row
      for (int ch = t; ch < 64 * CPR; ch += 128) {
        const int r = ch / CPR, c = (ch % CPR) * 8;
        const int gr = m0 + r, gc = n0 + c;
        if (gr >= ep.m || gc >= ep.n) continue;
        const bf16* s = cs + r * kLdc + c;
        // kXepSplitQ's q third goes to alt (M, d).
        const bool to_alt = XEP == kXepSplitQ && gc < ep.d;
        if (to_alt ? ep.vec_alt && gc + 8 <= ep.d
                   : ep.vec_out && gc + 8 <= ep.n &&
                         (XEP != kXepSplitQ || gc >= ep.d) &&
                         (XEP != kXepSplitKT ||
                          gc + 8 <= ep.d || gc >= 2 * ep.d)) {
          bf16* o = to_alt ? ep.alt + static_cast<size_t>(gr) * ep.d + gc
                           : ep.out + static_cast<size_t>(gr) * ep.n + gc;
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(s);
          continue;
        }
        for (int e = 0; e < 8 && gc + e < ep.n; ++e) {
          const int col = gc + e;
          if (trans(col)) continue;
          if (XEP == kXepSplitQ && col < ep.d)
            ep.alt[static_cast<size_t>(gr) * ep.d + col] = s[e];
          else
            ep.out[static_cast<size_t>(gr) * ep.n + col] = s[e];
        }
      }
    } else {
      // Column c of the tile, rows 8 rc .. 8 rc + 7 of the warpgroup's.
      for (int ch = t; ch < kBN * 8; ch += 128) {
        const int c = ch / 8, rc = ch % 8;
        const int gc = n0 + c, gr = m0 + 8 * rc;
        if (gc >= ep.n || gr >= ep.m || !trans(gc)) continue;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(cs + tidx(c, 8 * rc));
        const bf16* s = reinterpret_cast<const bf16*>(&raw);
        const size_t at = (XEP == kXepSplitKT
                               ? static_cast<size_t>(gc - ep.d)
                               : static_cast<size_t>(gc)) *
                              ep.m + gr;
        bf16* o = (XEP == kXepSplitKT ? ep.alt : ep.out) + at;
        const bool vec = (XEP == kXepSplitKT ? ep.vec_alt : ep.vec_t) &&
                         gr + 8 <= ep.m;
        if constexpr (XEP == kXepOutT) {
          __align__(16) bf16 v[8];
          if (vec) {
            const uint4 bw = *reinterpret_cast<const uint4*>(ep.bias + gr);
            const uint4 rw = *reinterpret_cast<const uint4*>(ep.residual + at);
            const bf16* bb = reinterpret_cast<const bf16*>(&bw);
            const bf16* rr = reinterpret_cast<const bf16*>(&rw);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = __float2bfloat16_rn((to_f32(s[e]) + to_f32(bb[e])) +
                                         to_f32(rr[e]));
            *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
          } else {
            for (int e = 0; e < 8 && gr + e < ep.m; ++e)
              o[e] = __float2bfloat16_rn(
                  (to_f32(s[e]) + to_f32(ep.bias[gr + e])) +
                  to_f32(ep.residual[at + e]));
          }
        } else if (vec) {
          *reinterpret_cast<uint4*>(o) = raw;
        } else {
          for (int e = 0; e < 8 && gr + e < ep.m; ++e) o[e] = s[e];
        }
      }
    }
  }
}

// K22's bf16 dot (kXepRawF32): one consumer warpgroup's rows of the tile
// at (m0, n0), the fp32 sums stored as they stand, a pair at a time from
// the accumulator fragments (no bias, no cast).
__device__ __forceinline__ void raw_epilogue(const float (&d)[64],
                                             const WgEpilogue& ep, int m0,
                                             int n0) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int gc = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = m0 + 16 * warp + lane / 4 + 8 * h;
      if (gr >= ep.m || gc >= ep.n) continue;
      float* o = ep.out_f32 + static_cast<size_t>(gr) * ep.n + gc;
      const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
      if (ep.vec_out && gc + 1 < ep.n) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (gc + 1 < ep.n) o[1] = v1;
      }
    }
  }
}

// (m, k) @ (k, n): A through map_a, B through map_b (see the header
// comment for their boxes); TA: A is the view of a (k, m) matrix; TB: B is
// the view of an (n, k) matrix. LN (K6, A and B as they lie): the
// producer warpgroup's warps 1-3 normalise each stage's x box with `ln`
// in place between its TMA and the consumers' wgmma. EMB (K8, A and B as
// they lie): the embedding epilogue, and the column's fixed rows from the
// block that walks its first row tile. XEP (K23's probe GEMMs, K22's bf16
// dot; A and B as they lie): the epilogue form WgXep names, K2's loop and
// sum order unchanged.
template <int TA, int TB, bool LN = false, bool EMB = false,
          int XEP = kXepNone>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_bf16_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    WgEpilogue ep, int k, WgLn ln) {
  static_assert(!LN || (TA == 0 && TB == 0), "K6 reads x and w as they lie");
  static_assert(!EMB || (TA == 0 && TB == 0 && !LN), "K8: x and w as they lie");
  static_assert(XEP == kXepNone || (TA == 0 && TB == 0 && !LN && !EMB),
                "K22, K23: x and w as they lie");
  extern __shared__ uint8_t wg_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  // full: the stage holds A and B for the consumers; empty: both consumer
  // warpgroups are done with it; LN: raw, TMA's bytes have arrived, and
  // full is the LN threads' arrivals after their pass.
  const uint32_t full0 = base + kBarOff, empty0 = full0 + 8 * kStages;
  const uint32_t raw0 = empty0 + 8 * kStages;
  const int tiles_m = (ep.m + kBM - 1) / kBM;
  const int tiles = tiles_m * ((ep.n + kBN - 1) / kBN);
  const int nk = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // The producer's arrive + the bytes; with LN, one a warp of LN
      // threads.
      mbar_init(full0 + 8 * s, LN ? kLnThreads / 32 : 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrive a consumer warpgroup
      if (LN) mbar_init(raw0 + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        LN ? kLnProducerRegs : kProducerRegs));
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
        for (int kb = 0; kb < nk; ++kb) {
          const int k0 = kb * kBK;
          mbar_wait(empty0 + 8 * s, ph ^ 1);
          const uint32_t full = (LN ? raw0 : full0) + 8 * s;
          mbar_expect_tx(full, kStageBytes);
          const uint32_t sa = base + s * kStageBytes, sb = sa + kABytes;
          if (TA) {
            tma_load(sa, &map_a, full, m0, k0);
            tma_load(sa + kAtom, &map_a, full, m0 + 64, k0);
          } else {
            tma_load(sa, &map_a, full, k0, m0);
          }
          if (TB) {
            tma_load(sb, &map_b, full, k0, n0);
          } else {
            tma_load(sb, &map_b, full, n0, k0);
            tma_load(sb + kAtom, &map_b, full, n0 + 64, k0);
          }
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else if (LN && threadIdx.x >= 384 - kLnThreads) {
      // The LN threads: each stage's x box, normalised in place, in the
      // ring's order; the stage is the consumers' once every LN thread
      // has fenced its writes and each warp has arrived.
      const int j = threadIdx.x - (384 - kLnThreads);
      int s = 0;
      uint32_t ph = 0;
      float g[8], b[8], mu[kLnRows], rs[kLnRows];
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        ln_stats(ln, (tile % tiles_m) * kBM, ep.m, j, mu, rs);
        for (int kb = 0; kb < nk; ++kb) {
          const int col = kb * kBK + 8 * (j % 8);
          ln_gb(ln, col, g, b);
          mbar_wait(raw0 + 8 * s, ph);
          ln_box(base + s * kStageBytes, col, ln, mu, rs, g, b, j);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (j % 32 == 0) mbar_arrive(full0 + 8 * s);
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        LN ? kLnConsumerRegs : kConsumerRegs));
    float d[64];
    uint32_t pv[kBN / 8][2];  // K8's pos pairs (embed_pos)
    bf16* cs = reinterpret_cast<bf16*>(smem + kCOff) + wgi * 64 * kLdc;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
      if constexpr (EMB) embed_pos(ep, m0 + 64 * wgi, n0, pv);
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      fence_acc(d);
      int prev = -1;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full0 + 8 * s, ph);
        const uint32_t sa = base + s * kStageBytes + wgi * kAtom;
        const uint32_t sb = base + s * kStageBytes + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // The transpose bit is 1 for an MN-major operand: A when TA, B
          // when not TB.
          const uint64_t da = TA ? sw128_desc(sa + kk * 2048, kAtom, 1024)
                                 : sw128_desc(sa + kk * 32, 16, 1024);
          const uint64_t db = TB ? sw128_desc(sb + kk * 32, 16, 1024)
                                 : sw128_desc(sb + kk * 2048, kAtom, 1024);
          wgmma_bf16<TA, 1 - TB>(d, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done
        fence_acc(d);
        if (prev >= 0 && threadIdx.x % 128 == 0)
          mbar_arrive(empty0 + 8 * prev);
        prev = s;
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (threadIdx.x % 128 == 0) mbar_arrive(empty0 + 8 * prev);
      if constexpr (XEP == kXepRawF32) {
        raw_epilogue(d, ep, m0 + 64 * wgi, n0);
      } else if constexpr (XEP != kXepNone) {
        probe_epilogue<XEP>(d, ep, m0 + 64 * wgi, n0, cs, wgi);
      } else {
        epilogue<EMB>(d, ep, m0 + 64 * wgi, n0, cs, wgi, pv);
        if (EMB && m0 == 0) embed_fixed_rows(ep, n0);
      }
    }
  }
}

}  // namespace wg
}  // namespace vit
