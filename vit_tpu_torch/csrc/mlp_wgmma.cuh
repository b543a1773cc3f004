// K3's bf16 tile for Hopper (vit_tpu/ops/pallas/block.py:mlp_block, its
// pallas_call at :218, kernel _mlp_kernel at :49-93; mlp_block.cu launches
// it): out = x + fc2(gelu(fc1(LN(x)))) for 64 rows at a time on wgmma fed
// by TMA, with the (rows, mlp) hidden kept on chip. With the template flag
// L the same kernel is K18's bf16 form (layer_block.cu; below).
//
// Shape. A cluster of two blocks owns 64 rows; block r (its rank in the
// cluster) owns output columns [r*D/2, (r+1)*D/2) and keeps their fp32
// sums in registers. Each block holds LN(x) of the 64 rows in shared
// memory (computed by both, in bf16, block.py:74). The MLP columns are
// walked in chunks of 128: block r computes chunk columns [64r, 64r+64)
// of fc1 for the 64 rows over K = D (each consumer warpgroup 32 of them,
// an m64n32 wgmma chain), adds b1, applies the erf GELU in fp32, rounds to
// bf16 (block.py:86) and writes them into its h buffer; one bulk copy
// puts the 64-column slice into the other block's buffer too. Then each
// block runs fc2 over the whole 128-column chunk for its own columns, each
// warpgroup for half of the block's 64-column boxes (D = 128 T; where the
// count is odd the second's last box reads a padding box and is not
// stored). At D >= 896 the block's boxes go in two passes over the
// hidden, fc1 recomputed in each (Cfg::NP says why). Every output element
// sums its chunks in ascending order, seeded with x + b2 (zero for the
// partial form, block.py:77-78); there is no split over the hidden, so
// two calls give the same bits and a row's result does not depend on M.
//
// Why a cluster (and not each block recomputing fc1 for its columns):
// the fc2 sums of 64 rows x D columns (192 KB at D = 768, 256 KB at 1024)
// do not fit two warpgroups' registers beside fc1's, so the columns are
// split in two; sharing h through the cluster keeps fc1 computed once, so
// the bound stays 4*M*D*mlp operations (62.8 GFLOP at B/16 bs=32), where
// recomputing it would add half as much again (as the two passes at
// D >= 896 do). Rows are 64 a block because LN(x) for 64 rows is already
// 96 KB of shared memory at D = 768 (128 KB at D = 1024).
//
// K18 (L: vit_tpu/ops/pallas/block.py:_layer_kernel, :1687-1720, its
// pallas_call :1805): out = y + b2 + fc2(gelu(fc1(LN2(y)))) with y = ctx @
// Wout + bout + x kept in fp32, never rounded. y is exactly the seed of
// the fc2 sums (acc = y32 + b2, block.py:1710), so it lives in those
// registers, split between the blocks by columns like them. In front of
// the MLP: (1) ctx's 64 x D rows arrive by TMA as K-major A boxes into
// the region that later holds LN2(y); (2) acc = ctx @ Wout[:, the
// warpgroup's columns], Wout's KS2-row stages of the block's D/2 columns
// streamed through the W2 ring (an fc2 stage with K = D, Wout N-major
// where it lies); (3) acc = (acc + bout) + x in fp32; (4) LN2's
// statistics over the whole row, in _ln32's two passes (block.py:638-644:
// the mean, then the mean of the squared centred values): each thread's
// columns in order, the quad by shuffles, the two consumer warpgroups in
// shared memory, then the two blocks, whose 64 partials a round cross the
// cluster by distributed shared memory and a remote barrier arrival, summed
// in rank order so both blocks hold the same bits; (5) LN2(y) of the
// block's columns, (y - mean) * rstd * g2 + bn2 in fp32, rounded to bf16,
// into the block's A boxes, and one bulk copy of those boxes into the
// other block's (the statistics exchange shows that both blocks are done
// reading ctx there), fenced for the async proxy; (6) acc += b2 and K3's
// chunk loop unchanged, then one cast. At D >= 896 (two passes) the second
// pass's y is computed with the first's, for the statistics, and kept
// unrounded in fp32 in the output's own bytes (the warpgroup's 64 rows x
// its columns of both passes hold exactly its second-pass sums), read
// back before the first pass's stores overwrite them: fc1 stays computed
// once a pass, as in K3, with no second read of ctx. The statistics'
// order and the shared-memory maps are modelled on the CPU by
// tests/test_torch_layer_tiles.py.
//
// Pipeline. The producer warpgroup (threads 256-383) gives its registers
// up (setmaxnreg.dec). Thread 256 streams W1 tiles (64 D-rows x the
// block's 64 chunk columns, 8 KB) and thread 288 W2 tiles (KS2 hidden rows
// x the block's D/2 columns) through two TMA rings, each as far ahead as
// its ring allows; thread 320 copies the block's h slices to the other
// block. (K18: thread 256 first loads the ctx boxes, thread 288 first
// streams Wout's stages, thread 320 first copies the LN2 boxes.) The two
// consumer warpgroups (threads 0-255, setmaxnreg.inc) walk
// c = 0..C: fc1(c)'s K-steps two at a time, each pair followed by the
// fc2(c-1) stages due by then, so that both rings drain at a steady rate
// (h(c-1) is waited for just before its first stage); then the GELU of
// fc1(c) and its writes. Each pair of K-steps or fc2 stage is one wgmma
// group, waited for before the next is issued (wgmma_wait<0>): with a
// group left in flight, or fc1's and fc2's products in one group, ptxas
// serialised every wgmma; the other warpgroup's groups keep the tensor
// cores busy meanwhile. h is double-buffered: buffer b
// holds chunks b, b+2, ...; before writing chunk c a consumer waits until
// all four warpgroups of the cluster are done with chunk c-2 (hempty[b],
// on which each block's copier arrives once its two warpgroups are done,
// hdone[b], so that no consumer waits on a remote arrival).
// hfull[b] completes when this block's 256 consumer threads have written
// their slice (after a proxy fence: wgmma and the copy read h through the
// async proxy) and the other block's copy has landed (its arrival with
// the bytes, then the bytes). K18's LN2 boxes go the same way (lnready,
// lnfull), and its statistics slots lie in h buffer 1, unused until then.
//
// Layouts (128-byte swizzle throughout: a 64-wide bf16 row is 128 bytes,
// 8 rows form a 1024-byte atom, and 16-byte chunk j of row i sits at
// chunk j ^ (i % 8)). LN(x) is D/64 boxes of 64 rows x 64 columns (8 KB),
// written by the LN pass in the layout a K-major A operand reads (as
// gemm_wgmma.cuh's A stage): a k16 step moves the descriptor 32 bytes, a
// 64-column step 8 KB. Each h buffer is two such boxes (the chunk's two
// 64-column halves), written from the fc1 accumulator fragments: value
// 4j + i of thread (warp w, lane l) of warpgroup g is row 16w + l/4 +
// 8(i/2), column 32g + 8j + 2(l%4) + i%2, so a pair (i, i+1) is 4 bytes at
// row*128 + (((4g + j) ^ (l/4)) * 16) + 4(l%4). K18's LN2 pairs go the
// same way from the fc2 fragments: column c of the block's half lands in
// box c/64 at chunk ((c%64)/8) ^ (row%8). W1 and W2 tiles are
// N-major B operands, loaded in boxes of 64 N columns: a k16 step moves
// the descriptor 16 rows (2 KB), the stride between 8-row groups is 1024
// bytes and between 64-column boxes one box; the second warpgroup's fc1
// descriptor starts 64 bytes into the W1 box (its 32 columns).
//
// Bound on the card: the tensor cores, 4*M*D*mlp operations (0.0635 ms at
// B/16 bs=32 at 989 TFLOP/s); K18 2*M*D*(D + 2*mlp) (0.0715 ms). On an
// NVIDIA H100 80GB HBM3 at 700 W (tools/turns.py) K3 takes about 0.24 ms
// there on the card and K18 about 0.29, 0.97 times K2 -> K3 on the same
// operands; K18 at L/16 bs=8 (1664 x 1024, mlp 4096) about 0.39. What
// this tile still leaves: each cluster reads all of W1 and W2 (and for
// K18 Wout) from L2 (104 row blocks x 9.4 MB at B/16 bs=32); TMA
// multicast to clusters that share the weights would divide that. 104
// clusters of two blocks on 132 SMs leave a partial second wave. At
// D >= 896 fc1 is computed in each pass. K18's out-projection streams
// Wout through the two-stage W2 ring, one stage in flight, and ptxas
// spills a few hundred bytes in its D >= 640 forms.

#pragma once

#include "gemm_wgmma.cuh"

namespace vit {
namespace mw {

using wg::fence_acc;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::named_sync;
using wg::smem_u32;
using wg::sw128_desc;
using wg::tma_load;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int kBM = 64;        // rows of a cluster
constexpr int kCT = 128;       // MLP columns a chunk
constexpr int kHC = kCT / 2;   // a block's share of a chunk
constexpr int kThreads = 384;  // consumers 0-255, producer 256-383
constexpr int kBox = 8192;     // 64 x 64 bf16
constexpr int kSmemMax = 232448;
constexpr int kBarBytes = 320;
// setmaxnreg as in gemm_wgmma.cuh: the launcher refuses a build whose
// kernel got fewer than kPoolRegs / kThreads registers a thread.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kPoolRegs = 256 * kConsumerRegs + 128 * kProducerRegs;
static_assert(kPoolRegs <= 65536, "one block an SM: 64K registers");

// The geometry of D = 128 T: the passes, NB boxes of 64 output columns
// to each consumer warpgroup in a pass (fewer real ones where the pass's
// box count is odd: the second's last box reads a padding box of the W2
// stage and is not stored), the W2 stage (KS2 hidden rows of 2 NB boxes)
// and the ring depths that fit 227 KB.
template <int T>
struct Cfg {
  static constexpr int D = 128 * T;
  // Passes over the hidden: at D >= 896 the block's T boxes go in two
  // passes of BP, each recomputing fc1, since 4 boxes a warpgroup (128
  // fp32 sums a thread) beside fc1's 16 made ptxas give both accumulators
  // the same registers and swap them through local memory at every fc1
  // step (2.7 times slower on an H100 at D = 1024).
  static constexpr int NP = T >= 7 ? 2 : 1;
  static constexpr int BP = (T + NP - 1) / NP;
  static constexpr int NB = (BP + 1) / 2;
  // Real boxes of warpgroup w in pass q.
  __host__ __device__ static constexpr int boxes(int q, int w) {
    const int b = (T - q * BP < BP ? T - q * BP : BP) - w * NB;
    return b < 0 ? 0 : (b > NB ? NB : b);
  }
  static constexpr int kXn = D / 64 * kBox;
  static constexpr int kH = 2 * 2 * kBox;  // two buffers of 64 x 128
  static constexpr int kW1Off = kXn + kH;
  // After LN(x) and h: two W2 stages of 32 hidden rows where they leave
  // four W1 stages, else of 16; then W1 stages, up to 8.
  static constexpr int kFree = kSmemMax - 1024 - kBarBytes - kW1Off;
  static constexpr int KS2 =
      kFree >= 2 * 32 * 128 * 2 * NB + 4 * kBox ? 32 : 16;
  static constexpr int kBox2 = KS2 * 128;  // one 64-column box of W2
  static constexpr int kStage2 = kBox2 * 2 * NB;
  static constexpr int kS2 = 2;
  static constexpr int kS1raw = (kFree - kS2 * kStage2) / kBox;
  static constexpr int kS1 = kS1raw < 8 ? kS1raw : 8;
  static constexpr int kW2Off = kW1Off + kS1 * kBox;
  static constexpr int kBarOff = kW2Off + kS2 * kStage2;
  // + 1024 so that the base can be aligned to a swizzle atom.
  static constexpr int kSmem = kBarOff + kBarBytes + 1024;
  // The last pass's epilogue stages each warpgroup's real boxes in the
  // LN(x) region (earlier passes store from the registers: LN(x) is read
  // again).
  static constexpr int kLdc0 = 64 * NB + 8;
  static_assert(kS1 >= 4, "four W1 stages at least");
  static_assert(kSmem <= kSmemMax, "227 KB a block");
  // K3's barriers, then K18's five (ctx, the two statistics rounds,
  // lnfull, lnready).
  static_assert((2 * kS1 + 2 * kS2 + 8 + 5) * 8 <= kBarBytes, "barriers");
  // K18's statistics slots (Stats) fit h buffer 1.
  static_assert(2 * 2 * kBM * 4 + 2 * kBM * 4 <= 2 * kBox, "stat slots");
};

// The operands of one launch.
struct MlpArgs {
  const bf16* x;
  const bf16* g;
  const bf16* b;
  const bf16* b1;
  const bf16* b2;
  bf16* out;
  int m, mlp;
  float eps;
  int partial;
  int vec;  // x, g and b are 16-byte aligned
  const bf16* bout;  // K18: the out-projection's bias (x is the residual,
                     // g and b LN2's); null for K3
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The address in block `rank`'s shared memory of local address `addr`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Arrive on a barrier of any block of the cluster (a mapa address), with
// release at cluster scope.
__device__ __forceinline__ void arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
          bar)
      : "memory");
}

// Arrive on a barrier of another block (a mapa address), with release at
// cluster scope, adding `bytes` to the bytes its phase waits for.
__device__ __forceinline__ void arrive_expect_cluster(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cluster.shared::cluster.b64 _, "
      "[%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Copy `bytes` of this block's shared memory at `src` to `dst` (a mapa
// address in another block), completing them on that block's barrier.
__device__ __forceinline__ void copy_to_cluster(uint32_t dst, uint32_t src,
                                                uint32_t bytes,
                                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait, with acquire at cluster scope, for the phase of parity `parity` of
// a local barrier that other blocks arrive on.
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > wg::kWaitCycles) __trap();
  }
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n\t"
      "barrier.cluster.wait.acquire;" ::
          : "memory");
}

// Erf-form GELU with erf by Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7),
// the form the Pallas kernels evaluate (vit_tpu/ops/pallas/activations.py:
// 25-33), with the fast exp and reciprocal: no branch, where erff has one.
__device__ __forceinline__ float gelu_as(float x) {
  const float z = x * 0.70710678118654752f, az = fabsf(z);
  const float t = __fdividef(1.f, fmaf(0.3275911f, az, 1.f));
  const float poly =
      ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t -
        0.284496736f) * t + 0.254829592f) * t;
  const float e = 1.f - poly * __expf(-az * az);
  return 0.5f * x * (1.f + copysignf(e, z));
}

#define VIT_MW_F8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d = A (64 x 16, K-major) @ B (16 x 32, N-major) + (acc ? d : 0): a
// warpgroup's fc1 k16 step, whose first step needs no zeroed sums.
__device__ __forceinline__ void wgmma_fc1(float (&d)[16], uint64_t da,
                                          uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : VIT_MW_F8(d, 0), VIT_MW_F8(d, 8)
      : "l"(da), "l"(db), "r"(acc));
}

// d += A (64 x 16, K-major) @ B (16 x N, N-major) on the tensor cores.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : VIT_MW_F8(d, 0), VIT_MW_F8(d, 8), VIT_MW_F8(d, 16), VIT_MW_F8(d, 24)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : VIT_MW_F8(d, 0), VIT_MW_F8(d, 8), VIT_MW_F8(d, 16), VIT_MW_F8(d, 24),
        VIT_MW_F8(d, 32), VIT_MW_F8(d, 40), VIT_MW_F8(d, 48), VIT_MW_F8(d, 56)
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[96], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : VIT_MW_F8(d, 0), VIT_MW_F8(d, 8), VIT_MW_F8(d, 16), VIT_MW_F8(d, 24),
        VIT_MW_F8(d, 32), VIT_MW_F8(d, 40), VIT_MW_F8(d, 48), VIT_MW_F8(d, 56),
        VIT_MW_F8(d, 64), VIT_MW_F8(d, 72), VIT_MW_F8(d, 80), VIT_MW_F8(d, 88)
      : "l"(da), "l"(db));
}

#undef VIT_MW_F8

// LN(x) of the block's 64 rows into shared memory as D/64 swizzled boxes
// (rows past m are zeros), by every warp of the block (NT threads): each
// lane holds 16-byte chunks lane, lane + 32, ... of the row; fp32 mean,
// then the centred biased variance (layernorm.py:_stats_kernel), then
// (x - mean) * rstd * g + b rounded to bf16.
template <int T, int NT = kThreads>
__device__ __forceinline__ void ln_rows(const MlpArgs& a, uint8_t* xn,
                                        int m0) {
  constexpr int D = 128 * T, NCH = D / 8, PER = (NCH + 31) / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBM; r += NT / 32) {
    const int gr = m0 + r;
    uint4 out[PER];
    if (gr < a.m) {
      const bf16* xr = a.x + static_cast<size_t>(gr) * D;
      float v[PER][8];
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int ch = lane + 32 * p;
        if (ch < NCH) {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[p][e] = 0.f;
          if (a.vec) {
            const uint4 raw = *reinterpret_cast<const uint4*>(xr + 8 * ch);
            const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[p][e] = to_f32(h[e]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[p][e] = to_f32(xr[8 * ch + e]);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) s += v[p][e];
        }
      }
      const float mean = warp_sum(s) / D;
      float ss = 0.f;
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        if (lane + 32 * p < NCH) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float c = v[p][e] - mean;
            ss += c * c;
          }
        }
      }
      const float rstd = rsqrtf(warp_sum(ss) / D + a.eps);
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int ch = lane + 32 * p;
        if (ch < NCH) {
          uint32_t o[4];
#pragma unroll
          for (int e = 0; e < 8; e += 2) {
            const int k = 8 * ch + e;
            const float c0 = (v[p][e] - mean) * rstd;
            const float c1 = (v[p][e + 1] - mean) * rstd;
            const __nv_bfloat162 y = __floats2bfloat162_rn(
                c0 * to_f32(a.g[k]) + to_f32(a.b[k]),
                c1 * to_f32(a.g[k + 1]) + to_f32(a.b[k + 1]));
            o[e / 2] = *reinterpret_cast<const uint32_t*>(&y);
          }
          out[p] = make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < PER; ++p) out[p] = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int ch = lane + 32 * p;
      if (ch < NCH)
        *reinterpret_cast<uint4*>(xn + (ch / 8) * kBox + r * 128 +
                                  (((ch % 8) ^ (r % 8)) * 16)) = out[p];
    }
  }
}

// Shared-memory addresses of a block's barriers: the W1 ring (full,
// empty), the W2 ring (full, empty), then hfull[2], hempty[2], hready[2]
// and hdone[2]; K18's ctx (the ctx boxes have landed), st[2] (the other
// block's 64 partials of statistics round 0, 1), lnfull and lnready (as
// hfull and hready, for the LN2 boxes).
template <int T>
struct Bars {
  uint32_t w1f, w1e, w2f, w2e, hfull, hempty, hready, hdone;
  uint32_t ctx, st, lnfull, lnready;
  __device__ explicit Bars(uint32_t base) {
    using C = Cfg<T>;
    w1f = base + C::kBarOff;
    w1e = w1f + 8 * C::kS1;
    w2f = w1e + 8 * C::kS1;
    w2e = w2f + 8 * C::kS2;
    hfull = w2e + 8 * C::kS2;
    hempty = hfull + 16;
    hready = hempty + 16;
    hdone = hready + 16;
    ctx = hdone + 16;
    st = ctx + 8;
    lnfull = st + 16;
    lnready = lnfull + 8;
  }
};

// K18's statistics slots, in h buffer 1 (written first by chunk 1's h,
// after both blocks are past the statistics): each consumer warpgroup's
// partial of each row (part[round][wg][row]) and the other block's sum of
// its two (peer[round][row], written by that block).
struct Stats {
  float part[2][2][kBM];
  float peer[2][kBM];
};

// K18: store v to a distributed shared-memory address (mapa's).
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

// Both consumer warpgroups of the block (threads 0-255).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// K18 at two passes: where the fp32 pair (row r, columns cc, cc + 1) of a
// warpgroup's second-pass y waits in the output's bytes. Its 64 rows of
// its first-pass columns (col_a, 64 real_a bf16 a row), then of its
// second-pass ones (col_b), hold 2 bf16 slots a float: at least the
// 64 real_b floats a row of its second pass, since real_b <= real_a.
__device__ __forceinline__ float2* y_stash(bf16* out, int d, int r, int cc,
                                           int col_a, int col_b,
                                           int real_a) {
  const int slot = 2 * cc;
  bf16* row = out + static_cast<size_t>(r) * d;
  return reinterpret_cast<float2*>(slot < 64 * real_a
                                       ? row + col_a + slot
                                       : row + col_b + slot - 64 * real_a);
}

// One consumer warpgroup `wgi` (0 or 1): in pass q, boxes
// [q BP + wgi NB, + NB) of the block's 64-column boxes, of which
// boxes(q, wgi) are inside the block's columns. L: K18's phases first.
template <int T, bool L>
__device__ __forceinline__ void consumer(const MlpArgs& a, uint32_t base,
                                         uint8_t* smem, uint32_t rank,
                                         int m0, int wgi) {
  using C = Cfg<T>;
  constexpr int D = C::D, NB = C::NB, NA = 32 * NB;
  static_assert(64 * (C::kLdc0 + 64 * C::boxes(C::NP - 1, 1) + 8) * 2 <=
                    C::kXn,
                "the last pass's output staging fits the LN(x) region");
  const Bars<T> bar(base);
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  float acc[NA];
  float h1[16];
  // K18 at two passes: the second pass's y.
  float ya[L && C::NP == 2 ? NA : 1];

  const uint32_t w2s = base + C::kW2Off + NB * wgi * C::kBox2;
  int s1 = 0, s2 = 0;
  uint32_t p1 = 0, p2 = 0;
  const int nchunks = a.mlp / kCT;
  constexpr int NKB = D / 64, NKS = kCT / C::KS2;
  // The warpgroup's first column in pass q.
  auto col_of = [&](int q) {
    return static_cast<int>(rank) * (D / 2) + 64 * (q * C::BP + NB * wgi);
  };

  // fc1 K-steps kb and kb+1 of chunk c (one wgmma group over two W1
  // stages): h1 (+)= LN(x)[:, 128 columns] @ W1[those rows, the
  // warpgroup's 32 of the block's 64 columns of the chunk] (each stage's
  // box at + 64 bytes for the second warpgroup); the first k16 step
  // overwrites h1.
  auto fc1_step = [&](int kb) {
    int st[2];
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st[h] = s1;
      mbar_wait(bar.w1f + 8 * s1, p1);
      const uint32_t xa = base + (kb + h) * kBox;
      const uint32_t wb = base + C::kW1Off + s1 * kBox + 64 * wgi;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_fc1(h1, sw128_desc(xa + kk * 32, 16, 1024),
                  sw128_desc(wb + kk * 2048, kBox, 1024),
                  kb + h > 0 || kk > 0);
      if (++s1 == C::kS1) {
        s1 = 0;
        p1 ^= 1;
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(h1);
    if (t == 0) {
      mbar_arrive(bar.w1e + 8 * st[0]);
      mbar_arrive(bar.w1e + 8 * st[1]);
    }
  };
  // W2 stage ks, K rows [ks KS2, + KS2) of the A boxes at ha: d += A[:,
  // those rows] @ W2 (or K18's Wout)[those rows, the warpgroup's columns].
  auto fc2_step = [&](auto& d, int ks, uint32_t ha) {
    mbar_wait(bar.w2f + 8 * s2, p2);
    const uint32_t wb = w2s + s2 * C::kStage2;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS2 / 16; ++kk) {
      const int kg = ks * (C::KS2 / 16) + kk;
      wgmma_ss<64 * NB>(
          d, sw128_desc(ha + (kg / 4) * kBox + (kg % 4) * 32, 16, 1024),
          sw128_desc(wb + kk * 2048, C::kBox2, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    if (t == 0) mbar_arrive(bar.w2e + 8 * s2);
    if (++s2 == C::kS2) {
      s2 = 0;
      p2 ^= 1;
    }
  };

  if constexpr (L) {
    // (1)-(2) y = ctx @ Wout for each pass's columns, K = D: the ctx boxes
    // in the LN(x) region are the A operand, Wout's stages come through
    // the W2 ring. The sums of value 4j + i sit as fc2's (below).
    mbar_wait(bar.ctx, 0);
    auto out_proj = [&](auto& d) {
#pragma unroll
      for (int i = 0; i < NA; ++i) d[i] = 0.f;
      fence_acc(d);
      for (int ks = 0; ks < D / C::KS2; ++ks) fc2_step(d, ks, base);
    };
    // (3) y = (y + bout) + x in fp32 (layer_block.cu's order); zero past
    // the block's columns and past m.
    auto residual = [&](auto& d, int q) {
      const int real = C::boxes(q, wgi), col0 = col_of(q);
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + 16 * warp + lane / 4 + 8 * (i / 2);
          const int c = col0 + 8 * j + 2 * (lane % 4) + i % 2;
          d[4 * j + i] =
              j < 8 * real && r < a.m
                  ? (d[4 * j + i] + to_f32(a.bout[c])) +
                        to_f32(a.x[static_cast<size_t>(r) * D + c])
                  : 0.f;
        }
    };
    out_proj(acc);
    residual(acc, 0);
    if constexpr (C::NP == 2) {
      out_proj(ya);
      residual(ya, 1);
    }

    // (4) LN2's statistics of the thread's two rows (16 warp + lane/4 and
    // + 8). Each round sums the thread's values pass by pass, j by j, the
    // pair in order, then the quad (shuffles), the two warpgroups (Stats
    // part), then the two blocks: threads 0-63 store their row's block sum
    // into the other block's Stats peer and arrive on its st barrier.
    // Two-term fp32 sums are commutative, so both blocks get the same bits.
    Stats* stats = reinterpret_cast<Stats*>(smem + C::kXn + 2 * kBox);
    const uint32_t peer = rank ^ 1;
    auto row_total = [&](int rd, float (&s)[2]) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
        s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
        if (lane % 4 == 0)
          stats->part[rd][wgi][16 * warp + lane / 4 + 8 * hh] = s[hh];
      }
      consumers_sync();  // both warpgroups' partials (and reads of ctx)
      if (threadIdx.x < kBM) {
        const int r = threadIdx.x;
        st_cluster(mapa(smem_u32(&stats->peer[rd][r]), peer),
                   stats->part[rd][0][r] + stats->part[rd][1][r]);
        arrive_cluster(mapa(bar.st + 8 * rd, peer));
      }
      wait_cluster(bar.st + 8 * rd, 0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + lane / 4 + 8 * hh;
        s[hh] = (stats->part[rd][0][r] + stats->part[rd][1][r]) +
                stats->peer[rd][r];
      }
    };
    auto sum_y = [&](auto& d, int q, float (&s)[2]) {
      const int real = C::boxes(q, wgi);
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j < 8 * real) s[i / 2] += d[4 * j + i];
    };
    auto sum_sq = [&](auto& d, int q, float (&s)[2], const float (&mu)[2]) {
      const int real = C::boxes(q, wgi);
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j < 8 * real) {
            const float c = d[4 * j + i] - mu[i / 2];
            s[i / 2] += c * c;
          }
    };
    float s[2] = {0.f, 0.f};
    sum_y(acc, 0, s);
    if constexpr (C::NP == 2) sum_y(ya, 1, s);
    row_total(0, s);
    const float mean[2] = {s[0] / D, s[1] / D};
    float ss[2] = {0.f, 0.f};
    sum_sq(acc, 0, ss, mean);
    if constexpr (C::NP == 2) sum_sq(ya, 1, ss, mean);
    row_total(1, ss);
    const float rstd[2] = {rsqrtf(ss[0] / D + a.eps),
                           rsqrtf(ss[1] / D + a.eps)};

    // (5) LN2(y) of the warpgroup's columns into the block's A boxes (zeros
    // past m); its pair (2hh, 2hh + 1) of box j is 4 bytes in row r at
    // chunk (j % 8) ^ (r % 8).
    auto ln2_store = [&](auto& d, int q) {
      const int real = C::boxes(q, wgi), box0 = col_of(q) / 64;
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 16 * warp + lane / 4 + 8 * hh;
          const int c = 64 * box0 + 8 * j + 2 * (lane % 4);
          if (j >= 8 * real) continue;
          __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
          if (m0 + r < a.m)
            v = __floats2bfloat162_rn(
                (d[4 * j + 2 * hh] - mean[hh]) * rstd[hh] * to_f32(a.g[c]) +
                    to_f32(a.b[c]),
                (d[4 * j + 2 * hh + 1] - mean[hh]) * rstd[hh] *
                        to_f32(a.g[c + 1]) +
                    to_f32(a.b[c + 1]));
          *reinterpret_cast<__nv_bfloat162*>(
              smem + (box0 + j / 8) * kBox + r * 128 +
              (((j % 8) ^ (lane / 4)) * 16) + 4 * (lane % 4)) = v;
        }
    };
    ln2_store(acc, 0);
    if constexpr (C::NP == 2) {
      ln2_store(ya, 1);
      // The second pass's y, unrounded, into the output's bytes.
      const int real_a = C::boxes(0, wgi), real_b = C::boxes(1, wgi);
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 16 * warp + lane / 4 + 8 * hh;
          if (j < 8 * real_b && r < a.m)
            *y_stash(a.out, D, r, 8 * j + 2 * (lane % 4), col_of(0),
                     col_of(1), real_a) =
                make_float2(ya[4 * j + 2 * hh], ya[4 * j + 2 * hh + 1]);
        }
    }
    // wgmma and the copy to the other block read the boxes through the
    // async proxy; lnfull also waits for the other block's copy.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(bar.lnfull);
    mbar_arrive(bar.lnready);
    wait_cluster(bar.lnfull, 0);
  }

  for (int q = 0; q < C::NP; ++q) {
    const int real = C::boxes(q, wgi);
    // The warpgroup's columns in this pass.
    const int col0 = col_of(q);
    // acc[4j + i]: row 16*warp + lane/4 + 8(i/2), column col0 + 8j +
    // 2(lane%4) + i%2, seeded with x + b2 (K18: y + b2; zero for the
    // partial form and past the block's columns).
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + 16 * warp + lane / 4 + 8 * (i / 2);
        const int c = col0 + 8 * j + 2 * (lane % 4) + i % 2;
        float seed = 0.f;
        if (j < 8 * real && r < a.m && !a.partial)
          seed = (L ? acc[4 * j + i]
                    : to_f32(a.x[static_cast<size_t>(r) * D + c])) +
                 to_f32(a.b2[c]);
        acc[4 * j + i] = seed;
      }

    for (int c = 0; c <= nchunks; ++c) {
      // g: the chunk's place in the walk over all passes, which the h
      // buffers' barriers count.
      const int g = q * nchunks + c;
      // fc1(c) and fc2(c-1), interleaved so that both rings drain at a
      // steady rate: after K-steps kb, kb+1, the fc2 stages up to
      // kb NKS/NKB, and the rest after the last. h(c-1) is waited for
      // just before its first stage.
      const int hb2 = (g - 1) & 1;
      const uint32_t ha = base + C::kXn + hb2 * 2 * kBox;
      int ks = 0;
      auto fc2_upto = [&](int n) {
        if (ks < n && ks == 0)
          wait_cluster(bar.hfull + 8 * hb2, ((g - 1) >> 1) & 1);
        for (; ks < n; ++ks) fc2_step(acc, ks, ha);
      };
      if (c < nchunks) {
        // One fc1 group late, so that h(c-1) has landed before it is
        // read.
        for (int kb = 0; kb < NKB; kb += 2) {
          fc1_step(kb);
          if (c >= 1 && kb >= 2) fc2_upto(kb * NKS / NKB);
        }
        if (c >= 1) fc2_upto(NKS);
      } else {
        fc2_upto(NKS);
      }
      // Done with h(c-1): the copier frees its buffer in both blocks.
      if (c >= 1 && t == 0) mbar_arrive(bar.hdone + 8 * hb2);
      if (c < nchunks) {
        // h(c) = bf16(gelu(h1 + b1)): the warpgroup's 32 columns of the
        // block's 64, 16-byte chunks 4 wgi .. 4 wgi + 3 of each row.
        uint32_t hv[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int hc =
              c * kCT + rank * kHC + 32 * wgi + 8 * j + 2 * (lane % 4);
          const float bb0 = to_f32(a.b1[hc]), bb1 = to_f32(a.b1[hc + 1]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(gelu_as(h1[4 * j + 2 * hh] + bb0),
                                      gelu_as(h1[4 * j + 2 * hh + 1] + bb1));
            hv[2 * j + hh] = *reinterpret_cast<const uint32_t*>(&v);
          }
        }
        const int hb = g & 1;
        if (g >= 2) wait_cluster(bar.hempty + 8 * hb, ((g - 2) >> 1) & 1);
        uint8_t* blk = smem + C::kXn + hb * 2 * kBox + rank * kBox;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 16 * warp + lane / 4 + 8 * hh;
            *reinterpret_cast<uint32_t*>(
                blk + r * 128 + (((4 * wgi + j) ^ (lane / 4)) * 16) +
                4 * (lane % 4)) = hv[2 * j + hh];
          }
        // wgmma and the copy to the other block read h through the async
        // proxy.
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(bar.hfull + 8 * hb);
        mbar_arrive(bar.hready + 8 * hb);
      }
    }

    if (q + 1 < C::NP) {
      // K18: the second pass's y comes back from the output's bytes
      // before any thread of the warpgroup stores over them.
      if constexpr (L && C::NP == 2) {
        const int real_a = C::boxes(0, wgi), real_b = C::boxes(1, wgi);
#pragma unroll
        for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = m0 + 16 * warp + lane / 4 + 8 * hh;
            float2 v = make_float2(0.f, 0.f);
            if (j < 8 * real_b && r < a.m)
              v = *y_stash(a.out, D, r, 8 * j + 2 * (lane % 4), col_of(0),
                           col_of(1), real_a);
            ya[4 * j + 2 * hh] = v.x;
            ya[4 * j + 2 * hh + 1] = v.y;
          }
        named_sync(1 + wgi);
      }
      // Not the last pass: LN(x) is read again, so each thread stores its
      // pairs from the registers.
#pragma unroll
      for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + 16 * warp + lane / 4 + 8 * hh;
          if (j < 8 * real && r < a.m)
            *reinterpret_cast<__nv_bfloat162*>(
                a.out + static_cast<size_t>(r) * D + col0 + 8 * j +
                2 * (lane % 4)) =
                __floats2bfloat162_rn(acc[4 * j + 2 * hh],
                                      acc[4 * j + 2 * hh + 1]);
        }
      if constexpr (L && C::NP == 2) {
#pragma unroll
        for (int i = 0; i < NA; ++i) acc[i] = ya[i];
      }
      continue;
    }
    // The last pass: every fc1 of the block is done (the last one's
    // writer finished it before arriving on hfull), so the LN(x) region
    // stages the output; each warpgroup writes its real boxes' rows with
    // 16-byte stores.
    const int ldc = 64 * real + 8;
    bf16* cs = reinterpret_cast<bf16*>(smem) + (wgi ? 64 * C::kLdc0 : 0);
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + lane / 4 + 8 * hh;
        if (j < 8 * real)
          *reinterpret_cast<__nv_bfloat162*>(cs + r * ldc + 8 * j +
                                             2 * (lane % 4)) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hh],
                                    acc[4 * j + 2 * hh + 1]);
      }
    named_sync(1 + wgi);
    const int cpr = 8 * real;  // 16-byte chunks a row
    for (int ch = t; ch < 64 * cpr; ch += 128) {
      const int r = ch / cpr, cc = (ch % cpr) * 8;
      if (m0 + r < a.m)
        *reinterpret_cast<uint4*>(a.out + static_cast<size_t>(m0 + r) * D +
                                  col0 + cc) =
            *reinterpret_cast<const uint4*>(cs + r * ldc + cc);
    }
  }
}

// K3, or with L K18 (map_ctx over ctx (M, D) in 64 x 64 boxes, map_wout
// over Wout (D, D) in boxes of 64 columns x KS2 rows; K3 reads neither).
template <int T, bool L = false>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    mlp_bf16_wgmma(const __grid_constant__ CUtensorMap map_w1,
                   const __grid_constant__ CUtensorMap map_w2,
                   const __grid_constant__ CUtensorMap map_ctx,
                   const __grid_constant__ CUtensorMap map_wout, MlpArgs a) {
  using C = Cfg<T>;
  extern __shared__ uint8_t mw_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(mw_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t rank = cluster_rank();
  const int m0 = (blockIdx.x / 2) * kBM;
  const Bars<T> bar(base);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kS1; ++s) {
      mbar_init(bar.w1f + 8 * s, 1);  // the producer's arrive + the bytes
      mbar_init(bar.w1e + 8 * s, 2);  // both consumer warpgroups
    }
    for (int s = 0; s < C::kS2; ++s) {
      mbar_init(bar.w2f + 8 * s, 1);
      mbar_init(bar.w2e + 8 * s, 2);  // both consumer warpgroups
    }
    for (int b = 0; b < 2; ++b) {
      // This block's consumer threads, and the other block's copy (its
      // arrive with the bytes to come).
      mbar_init(bar.hfull + 8 * b, 256 + 1);
      mbar_init(bar.hempty + 8 * b, 2);   // both blocks' copiers
      mbar_init(bar.hready + 8 * b, 256);  // this block's consumers
      mbar_init(bar.hdone + 8 * b, 2);     // this block's warpgroups
    }
    if (L) {
      mbar_init(bar.ctx, 1);  // the producer's arrive + the bytes
      mbar_init(bar.st, kBM);  // the other block's threads 0-63
      mbar_init(bar.st + 8, kBM);
      mbar_init(bar.lnfull, 256 + 1);  // as hfull
      mbar_init(bar.lnready, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (!L) ln_rows<T>(a, smem, m0);
  // wgmma reads LN(x) through the async proxy; the cluster barrier also
  // makes both blocks' barriers initialised before either arrives on the
  // other's.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  cluster_sync();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    // Two threads in two warps: one streams W1, the other W2, each as far
    // ahead as its ring allows, in the order the consumers use them.
    const int nchunks = a.mlp / kCT;
    // The walk is NP passes over the chunks; g counts chunks over all.
    const int nwalk = C::NP * nchunks;
    if (threadIdx.x == 256) {
      if (L) {
        // K18: the 64 ctx rows, D/64 K-major boxes into the LN(x) region
        // (zeros past M).
        mbar_expect_tx(bar.ctx, C::D / 64 * kBox);
        for (int kb = 0; kb < C::D / 64; ++kb)
          tma_load(base + kb * kBox, &map_ctx, bar.ctx, kb * 64, m0);
      }
      int s1 = 0;
      uint32_t p1 = 0;
      for (int g = 0; g < nwalk; ++g) {
        const int h0 = (g % nchunks) * kCT + rank * kHC;
        for (int kb = 0; kb < C::D / 64; ++kb) {
          mbar_wait(bar.w1e + 8 * s1, p1 ^ 1);
          mbar_expect_tx(bar.w1f + 8 * s1, kBox);
          tma_load(base + C::kW1Off + s1 * kBox, &map_w1, bar.w1f + 8 * s1,
                   h0, kb * 64);
          if (++s1 == C::kS1) {
            s1 = 0;
            p1 ^= 1;
          }
        }
      }
    } else if (threadIdx.x == 320) {
      const uint32_t peer = rank ^ 1;
      if (L) {
        // K18: once this block's consumers have written LN2(y) of its
        // columns (and so are past the statistics, which show the other
        // block done with its ctx boxes), copy those boxes into the other
        // block's, the bytes counted on its lnfull.
        mbar_wait(bar.lnready, 0);
        const uint32_t src = base + rank * T * kBox;
        const uint32_t full = mapa(bar.lnfull, peer);
        arrive_expect_cluster(full, T * kBox);
        copy_to_cluster(mapa(src, peer), src, T * kBox, full);
      }
      // The h exchange, in the consumers' order: once both warpgroups are
      // done with h(c-1) (hdone), free its buffer in both blocks (hempty);
      // once this block's slice of h(c) is written (hready), copy it into
      // the other block's buffer, its bytes counted on that block's hfull
      // (that block's consumers are done with the buffer: hempty).
      for (int g = 0; g <= nwalk; ++g) {
        if (g >= 1) {
          const int hb = (g - 1) & 1;
          mbar_wait(bar.hdone + 8 * hb, ((g - 1) >> 1) & 1);
          arrive_cluster(mapa(bar.hempty + 8 * hb, 0));
          arrive_cluster(mapa(bar.hempty + 8 * hb, 1));
        }
        if (g < nwalk) {
          const int hb = g & 1;
          mbar_wait(bar.hready + 8 * hb, (g >> 1) & 1);
          if (g >= 2) wait_cluster(bar.hempty + 8 * hb, ((g - 2) >> 1) & 1);
          const uint32_t src = base + C::kXn + hb * 2 * kBox + rank * kBox;
          const uint32_t full = mapa(bar.hfull + 8 * hb, peer);
          arrive_expect_cluster(full, kBox);
          copy_to_cluster(mapa(src, peer), src, kBox, full);
        }
      }
    } else if (threadIdx.x == 288) {
      int s2 = 0;
      uint32_t p2 = 0;
      // Pass q's boxes of the block's columns; a padding box stays.
      auto pass_boxes = [](int q) {
        return T - q * C::BP < C::BP ? T - q * C::BP : C::BP;
      };
      if (L) {
        // K18: Wout's stages first, KS2 of its D rows x pass q's boxes of
        // the block's columns, pass by pass.
        for (int q = 0; q < C::NP; ++q) {
          const int nbox = pass_boxes(q);
          for (int ks = 0; ks < C::D / C::KS2; ++ks) {
            mbar_wait(bar.w2e + 8 * s2, p2 ^ 1);
            const uint32_t full = bar.w2f + 8 * s2;
            mbar_expect_tx(full, nbox * C::kBox2);
            for (int p = 0; p < nbox; ++p)
              tma_load(base + C::kW2Off + s2 * C::kStage2 + p * C::kBox2,
                       &map_wout, full,
                       rank * (C::D / 2) + 64 * (q * C::BP + p),
                       ks * C::KS2);
            if (++s2 == C::kS2) {
              s2 = 0;
              p2 ^= 1;
            }
          }
        }
      }
      for (int g = 0; g < nwalk; ++g) {
        const int q = g / nchunks, c = g % nchunks;
        const int nbox = pass_boxes(q);
        for (int ks = 0; ks < kCT / C::KS2; ++ks) {
          mbar_wait(bar.w2e + 8 * s2, p2 ^ 1);
          const uint32_t full = bar.w2f + 8 * s2;
          mbar_expect_tx(full, nbox * C::kBox2);
          for (int p = 0; p < nbox; ++p)
            tma_load(base + C::kW2Off + s2 * C::kStage2 + p * C::kBox2,
                     &map_w2, full, rank * (C::D / 2) + 64 * (q * C::BP + p),
                     c * kCT + ks * C::KS2);
          if (++s2 == C::kS2) {
            s2 = 0;
            p2 ^= 1;
          }
        }
      }
    }
    // No block leaves while the other may still write its h buffers or
    // arrive on its barriers.
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    consumer<T, L>(a, base, smem, rank, m0, wgi);
    cluster_sync();
  }
}

}  // namespace mw
}  // namespace vit
