// K3's fp32 tile for Hopper (vit_tpu/ops/pallas/block.py:mlp_block, its
// pallas_call at :218, kernel _mlp_kernel at :49-93; mlp_block_tf32.cu
// launches it): out = x + b2 + fc2(gelu(fc1(LN(x)))) on the tensor cores
// through the three-pass TF32 split of tf32_split.cuh, the (rows, mlp)
// hidden kept on chip, in one launch.
//
// Both products run transposed, so that the weights are wgmma's A operand,
// loaded from shared memory into registers and split there, and the
// activations its B operand, K-major in shared memory as x's rows already
// lie:
//   h^T (128 hidden x BM rows) = W1[:, chunk]^T @ LN(x)^T,
//   out^T (D x BM rows)       += W2[chunk, :]^T @ h^T.
// tf32 wgmma reads B K-major only and the weights lie N-major, so the
// other way round would turn every weight box in shared memory (as K2's
// converters do, twice the bytes of the box written a stage); here each
// weight element is read once from shared memory by the one thread whose
// fragment holds it, and no weight is transposed.
//
// Shape. A block owns BM rows (BM = 32 up to D = 768, 16 beyond) and
// every output column; there is no split over the hidden. The fc2 sums,
// BM x D fp32, stay in the consumers' registers: consumer warpgroup w
// holds the 64-column groups 2q + w (q < G) of out^T, BM / 2 values a
// thread a group (96 at D = 768, 64 at 1024, 80 at 1280): with the step's
// sums and the split fragments that is what fits the 168 registers ptxas
// gives a thread of a 384-thread block (setmaxnreg does not raise its
// allocation; BM = 32 at D = 1024 spilled). LN(x) does not fit shared
// memory whole (32 x 768 fp32, doubled by the split, is 192 KB), so x is
// streamed: its row statistics are computed once a block (fp32, two passes
// as layernorm_row), and every hidden chunk re-reads x's BM x 32 boxes by
// TMA (from L2: 24 times at B/16, 0.49 GB in all), which the producer
// warpgroup's three idle warps normalise, (x - mean) * rstd * g + b in
// fp32, and split into hi and lo boxes. The hidden is walked in chunks of
// 128 columns: each consumer warpgroup computes 64 of them (fc1, K = D),
// adds b1, applies the erf GELU in fp32 (h is not rounded: the tensor is
// fp32), splits it and writes it into the chunk's h buffer
// (double-buffered); then both run fc2 over the chunk, group by group.
// Each block reads all of W1 and W2 from L2 (3.9 GB at B/16 bs=32 for its
// 208 blocks); clusters of two sharing each weight stage by TMA multicast
// halved that and ran no faster at B/16, L/16-384 or H/14, so they went.
//
// Sums. fc1 sums K = D in one wgmma accumulator (three passes a k8 slice,
// the first product with scale-d 0) up to D = 1024: on the card one
// accumulator held the 1e-4 bar at K = 768-1536 (6.8e-5 at most,
// tools/tf32_probe.py, PERF.md section 6), where K = 2304 missed it; past
// D = 1024 (G = 12) in accumulators of K = 128 added on the FFMA units.
// fc2's products over a chunk (K = 128) go into a fresh accumulator each
// group, added to the group's fp32 total on the FFMA units, chunk after
// chunk in order, as JAX's kernel adds each chunk's h @ W2 to acc_ref
// (block.py:87-89); the totals start at x + b2 (zero for the partial form,
// block.py:77-78). Nothing depends on the grid: two calls give the same
// bits, and a row's result does not depend on M.
//
// K order and fragments. A's rows are permuted (pi: row g of a warp's 16
// is column 2g of its 16, row g + 8 column 2g + 1) and each k8 slice's
// eight K slots too (slot u holds k = 8s + perm8(u), perm8 = 0 2 4 6 1 3 5
// 7), so that a thread's A fragment (rows g, g+8; slots t, t+4) is two
// 8-byte loads a slice from the weight box, and each half-warp phase of a
// load reads four rows whose swizzles put its 128 bytes in 32 distinct
// banks: two wavefronts an instruction, the least there can be. B holds
// the same slot order: the helpers write LN(x)'s K slots permuted, the
// consumers write h at its permuted slots, so both products sum the same
// terms (tests/test_torch_mlp_tf32.py models the maps byte for byte).
//
// Pipeline. Threads 256-383 give registers up (setmaxnreg.dec): thread 256
// keeps TMA loads in flight, in the order the consumers use them -- per
// chunk, fc1's steps (x's box and W1's 32 D-rows x 128 hidden columns),
// then fc2's (W2's 32 hidden rows x 128 output columns, four steps a
// group) -- through a ring of 16 KB weight stages and a ring of x stages;
// threads 288-383 (three warps) normalise each x box. The consumers
// (threads 0-255, setmaxnreg.inc) wait for a stage, load and split their
// fragments, issue the step's twelve wgmma m64nBMk8 as one group, wait for
// it (the next step's fragments reuse the registers) and release the
// stage. Two fragment buffers with a group left in flight ran ptxas short
// of registers at 168 a thread: it serialised every wgmma ("insufficient
// register resources", C7512) and the tile was slower on the card; 352
// threads a block (184 registers, no setmaxnreg) was slower too
// (tools/mlp_tf32_ablate.py, PERF.md section 6). Before fc2 of a chunk the
// two warpgroups meet at a named barrier (both halves of h written, fenced
// for the async proxy); h's two buffers let one warpgroup start the next
// chunk's fc1 while the other still reads this one's h.
//
// Ragged edges: TMA fills boxes outside x, W1 or W2 with zeros; LN(x) is
// zero past D, h is zero past mlp (b1 masked, gelu(0) = 0), rows past M
// and columns past D are not stored. x, W1 and W2 need 16-byte aligned
// bases and rows of a multiple of 4 floats (D and mlp % 4 == 0); the
// launch takes that geometry only (ops/cuda/block.py:mlp_f32_form sends
// the rest to mlp_tile.cuh's FFMA form).
//
// Bound on the card: operations, 4*M*D*mlp in three TF32 passes (62.8
// GFLOP at B/16 bs=32: 0.381 ms at 495/3 TFLOP/s, chip_smoke.py's
// "tf32x3"). On an NVIDIA H100 80GB HBM3 at 700 W (tools/turns.py against
// the FFMA form it replaced, device ms): B/16 bs=32 1.24 (10.79 before; the
// same MLP as K1 -> K2 -> K2, whose GEMMs run on K2's 128 x 128 tf32 tile,
// 0.78), its shard over model=2 0.63 (3.77; chain 0.40), L/16-384 bs=8
// 2.51 (14.77; chain 0.94), H/14 bs=2 1.33 (12.44; chain 0.33): 3.3 times
// the bound at B/16, and slower than the chain everywhere. What it
// leaves: without its wgmma the tile still takes 0.73 of its 1.23 ms at
// B/16 (tools/mlp_tf32_ablate.py): the fragment loads and splits, LN(x),
// h and the barriers, which two consumer warpgroups do not hide behind
// each other's products; a wgmma of N = BM (32 or 16 rows) does little
// work a step; and at H/14 bs=2 (544 rows) 34 blocks leave most of the
// card idle.
//
// K18's fp32 form (layer_block.cu; layer_block_tf32.cu launches it) is
// this tile with its LAYER flag (layer_tf32_kernel): y = ctx @ Wout + bout
// + x, then out = y + b2 + fc2(gelu(fc1(LN2 y))), y never rounded.
// - The out-projection runs on the same tile, transposed as the MLP's
//   products: y^T = Wout^T @ ctx^T, Wout's 32 x 128 boxes the A operand
//   through the weight ring (load_w, as W2's), ctx's BM x 32 boxes the B
//   operand through the x ring, which the helper warps split with their
//   K slots permuted and no LN (normalize_box<BM, false>).
// - Group by group (the walk's order): each 128-column output group's sums
//   over K = D go into its fc2 totals tot[q] (one wgmma accumulator up to
//   D = 1024; past it accumulators of K = 128 added on the FFMA units, as
//   fc1), and ctx's boxes are read again from L2 for each group, as x's
//   are for each chunk. The other order (K outer, every group's sums
//   accumulating at once) would read ctx once but needs G accumulators
//   beside the totals past D = 1024, which the registers do not hold.
// - Then tot = (tot + bout) + x in fp32, the plain version's order. y, BM x
//   D fp32, does not fit shared memory beside the rings (no more than
//   LN(x) does), so it is written unrounded into the block's own rows of
//   out, which no other block reads; the writes are fenced for the async
//   proxy, the consumers meet, and their warps compute LN2's row
//   statistics from out (through L2: the generic loads must see the other
//   threads' stores) and arrive on the ydone barrier. The producer and the
//   helpers wait on it; then run_chunks runs unchanged, x's boxes read
//   from out by TMA, with the totals seeded tot = y + b2 (JAX's acc = y32 +
//   b2), and the final store overwrites out.
// Nothing else differs from K3's walk. Bound: operations, 2*M*D*(D +
// 2*mlp) in three TF32 passes (70.7 GFLOP at B/16 bs=32: 0.428 ms at
// 495/3 TFLOP/s).

#pragma once

#include <cuda.h>

#include "common.cuh"
#include "gemm_tf32.cuh"
#include "gemm_wgmma.cuh"
#include "tf32_split.cuh"

namespace vit {
namespace mt {

using wg::fence_acc;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::sw128_desc;
using wg::tma_load;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int kThreads = 384;    // consumers 0-255, producer 256-383
constexpr int kCT = 128;         // hidden columns a chunk, 64 a warpgroup
constexpr int kBK = 32;          // a K step: one 128-byte row of fp32
constexpr int kSub = 4096;       // a 32 x 32 fp32 box
constexpr int kWStage = 4 * kSub;  // 32 rows x 128 columns of W1 or W2
constexpr int kHelp0 = 288;      // the normalising threads: 288-383
constexpr int kHelpThreads = 96;
constexpr int kMaxD = 1536;
constexpr int kSmemMax = 232448;
constexpr int kSX = 4;           // x stages
constexpr int kBarBytes = 256;
// setmaxnreg as in gemm_tf32.cuh: the launcher refuses a build whose
// kernel got fewer than kPoolRegs / kThreads registers a thread.
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kPoolRegs = 256 * kConsumerRegs + 128 * kProducerRegs;
static_assert(kPoolRegs <= 65536, "one block an SM: 64K registers");

// Slot u of a k8 slice holds k = perm8(u) of the slice (0 2 4 6 1 3 5 7);
// slot8 inverts it.
__host__ __device__ constexpr int perm8(int u) {
  return ((u & 3) << 1) | (u >> 2);
}
__host__ __device__ constexpr int slot8(int k) {
  return (k >> 1) | ((k & 1) << 2);
}

// The geometry of BM rows a block.
template <int BM>
struct Cfg {
  static constexpr int kXBox = BM * 128;      // BM rows x 32 floats
  static constexpr int kXStage = 3 * kXBox;   // raw, hi, lo
  static constexpr int kHBuf = 8 * kXBox;     // hi then lo, 4 boxes each
  static constexpr int kFixed = kSX * kXStage + 2 * kHBuf +
                                2 * kMaxD * 4 + 2 * BM * 4 + kBarBytes;
  static constexpr int kSWraw = (kSmemMax - 1024 - kFixed) / kWStage;
  static constexpr int kSW = kSWraw < 8 ? kSWraw : 8;  // weight stages
  static constexpr int kXOff = kSW * kWStage;
  static constexpr int kHOff = kXOff + kSX * kXStage;
  static constexpr int kGOff = kHOff + 2 * kHBuf;      // g, then b
  static constexpr int kStOff = kGOff + 2 * kMaxD * 4;  // mean, rstd
  static constexpr int kBarOff = kStOff + 2 * BM * 4;
  // + 1024 so that the base can be aligned to a swizzle atom.
  static constexpr int kSmem = kBarOff + kBarBytes + 1024;
  static_assert(kSW >= 4, "four weight stages at least");
  static_assert(kSmem <= kSmemMax, "227 KB a block");
  static_assert((2 * kSW + 3 * kSX + 1) * 8 <= kBarBytes, "barriers");
};

// The operands of one launch.
struct MlpTf32Args {
  const float* x;
  const float* g;
  const float* b;
  const float* b1;
  const float* b2;
  float* out;
  int m, d, mlp;
  float eps;
  int partial;
};

// d (64 x N over a warpgroup) += A (64 x 8, tf32, registers) @ B (8 x N,
// tf32, K-major through descriptor db): wgmma m64nNk8 for N = 32, 16.
template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2],
                                        const uint32_t (&a)[4], uint64_t db);
// The same with scale-d 0, d = A B: d is written only, so its old value
// is dead before it (what ptxas needs to share its registers).
template <int N>
__device__ __forceinline__ void wgmma_n_fresh(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db);

#define VIT_MT_F8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// Written only, early-clobbered: the asynchronous product must not get
// an output register that also holds one of its A fragments.
#define VIT_MT_W8(d, i)                                                 \
  "=&f"(d[i]), "=&f"(d[i + 1]), "=&f"(d[i + 2]), "=&f"(d[i + 3]),       \
      "=&f"(d[i + 4]), "=&f"(d[i + 5]), "=&f"(d[i + 6]), "=&f"(d[i + 7])
// scale-d is a predicate: p = (SD != 0).
#define VIT_MT_N32(SD)                                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " #SD ", 0;\n"                       \
  "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"                 \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, "    \
  "p, 1, 1;\n}\n"
#define VIT_MT_N16(SD)                                                    \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " #SD ", 0;\n"                       \
  "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"                 \
  "%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"

template <>
__device__ __forceinline__ void wgmma_n<32>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(VIT_MT_N32(1)
               : VIT_MT_F8(d, 0), VIT_MT_F8(d, 8)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_n_fresh<32>(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(VIT_MT_N32(0)
               : VIT_MT_W8(d, 0), VIT_MT_W8(d, 8)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_n<16>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(VIT_MT_N16(1)
               : VIT_MT_F8(d, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma_n_fresh<16>(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(VIT_MT_N16(0)
               : VIT_MT_W8(d, 0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef VIT_MT_N16
#undef VIT_MT_N32
#undef VIT_MT_W8
#undef VIT_MT_F8

__device__ __forceinline__ float2 ld_shared_v2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// The two consumer warpgroups meet (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// A consumer's split A fragments of one K step from the weight stage at
// `stage` (32 rows k x 128 columns i in four 32 x 32 boxes): warpgroup
// wgi's columns 64 wgi .. + 63; row g of warp w is column 16 w + 2 g, row
// g + 8 the next one; slot u of slice s is row k = 8 s + perm8(u).
__device__ __forceinline__ void load_w(uint32_t stage, int wgi,
                                       uint32_t (&ah)[4][4],
                                       uint32_t (&al)[4][4]) {
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  const int col = 64 * wgi + 16 * warp + 2 * g;
  const uint32_t box = stage + (col >> 5) * kSub;
  const int c = col & 31;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float2 v0 = ld_shared_v2(box + sw128_f32(8 * s + perm8(q), c));
    const float2 v1 = ld_shared_v2(box + sw128_f32(8 * s + perm8(q + 4), c));
    split_tf32(v0.x, ah[s][0], al[s][0]);
    split_tf32(v0.y, ah[s][1], al[s][1]);
    split_tf32(v1.x, ah[s][2], al[s][2]);
    split_tf32(v1.y, ah[s][3], al[s][3]);
  }
}

// Keep the compiler from moving the fragments' splits past the wgmma
// fence (ptxas then injects a fence of its own before the wgmma).
__device__ __forceinline__ void fence_frag(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j])::"memory");
}

// One K step into acc: the three passes of each k8 slice (lo_a hi_b, hi_a
// lo_b, hi_a hi_b) against the B boxes at bhi, blo; fresh: its first
// product starts acc. Waited for before it returns: the next step loads
// its fragments into the same registers.
template <int BM>
__device__ __forceinline__ void step(float (&acc)[BM / 2],
                                     uint32_t (&ah)[4][4],
                                     uint32_t (&al)[4][4], uint32_t bhi,
                                     uint32_t blo, bool fresh) {
  fence_frag(ah);
  fence_frag(al);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t dh = sw128_desc(bhi + 32 * s, 16, 1024);
    const uint64_t dl = sw128_desc(blo + 32 * s, 16, 1024);
    if (s == 0 && fresh)
      wgmma_n_fresh<BM>(acc, al[s], dh);
    else
      wgmma_n<BM>(acc, al[s], dh);
    wgmma_n<BM>(acc, ah[s], dl);
    wgmma_n<BM>(acc, ah[s], dh);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// A helper thread's share (j of kHelpThreads) of one x box at `raw` (BM
// rows x D columns col0 .. col0 + 31): LN(x) in fp32, each 8-column slice's
// K slots permuted, split into the hi and lo boxes behind it. Unit u is
// row u / 4, slice u % 4: two 16-byte chunks read, two of hi and two of lo
// written; eight lanes of a phase hit eight distinct chunks. LN false (K18's
// ctx boxes): the same copy and split without LN (TMA's zeros past D stay
// zeros).
template <int BM, bool LN = true>
__device__ __forceinline__ void normalize_box(uint32_t raw, const float* gs,
                                              const float* bs,
                                              const float* mean,
                                              const float* rstd, int col0,
                                              int d, int j) {
  const uint32_t hi = raw + Cfg<BM>::kXBox, lo = hi + Cfg<BM>::kXBox;
  for (int u = j; u < 4 * BM; u += kHelpThreads) {
    const int n = u >> 2, s = u & 3, c = col0 + 8 * s;
    const float4 v0 = tf::ld_shared_v4(raw + sw128_f32(n, 8 * s));
    const float4 v1 = tf::ld_shared_v4(raw + sw128_f32(n, 8 * s + 4));
    const float e[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    if constexpr (!LN) {
      tf::st_split4(hi, lo, sw128_f32(n, 8 * s), e[0], e[2], e[4], e[6]);
      tf::st_split4(hi, lo, sw128_f32(n, 8 * s + 4), e[1], e[3], e[5], e[7]);
      continue;
    }
    const float mu = mean[n], rs = rstd[n];
    // D % 4 == 0: each four columns are all inside D or all past it.
    float gv[8] = {}, bv[8] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (c + 4 * h < d) {
        const float4 g4 = *reinterpret_cast<const float4*>(gs + c + 4 * h);
        const float4 b4 = *reinterpret_cast<const float4*>(bs + c + 4 * h);
        gv[4 * h] = g4.x, gv[4 * h + 1] = g4.y, gv[4 * h + 2] = g4.z,
        gv[4 * h + 3] = g4.w;
        bv[4 * h] = b4.x, bv[4 * h + 1] = b4.y, bv[4 * h + 2] = b4.z,
        bv[4 * h + 3] = b4.w;
      }
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      o[i] = c + i < d ? (e[i] - mu) * rs * gv[i] + bv[i] : 0.f;
    // Slots 0-3 hold k = 0 2 4 6, slots 4-7 k = 1 3 5 7.
    tf::st_split4(hi, lo, sw128_f32(n, 8 * s), o[0], o[2], o[4], o[6]);
    tf::st_split4(hi, lo, sw128_f32(n, 8 * s + 4), o[1], o[3], o[5], o[7]);
  }
}

// The shared-memory addresses of a launch.
template <int BM>
struct Smem {
  uint32_t base;
  __device__ __forceinline__ uint32_t wstage(int s) const {
    return base + s * kWStage;
  }
  __device__ __forceinline__ uint32_t xstage(int s) const {
    return base + Cfg<BM>::kXOff + s * Cfg<BM>::kXStage;
  }
  __device__ __forceinline__ uint32_t hbuf(int c) const {
    return base + Cfg<BM>::kHOff + (c & 1) * Cfg<BM>::kHBuf;
  }
  __device__ __forceinline__ uint32_t wfull(int s) const {
    return base + Cfg<BM>::kBarOff + 8 * s;
  }
  __device__ __forceinline__ uint32_t wempty(int s) const {
    return wfull(Cfg<BM>::kSW + s);
  }
  __device__ __forceinline__ uint32_t xraw(int s) const {
    return wfull(2 * Cfg<BM>::kSW + s);
  }
  __device__ __forceinline__ uint32_t xfull(int s) const {
    return xraw(kSX + s);
  }
  __device__ __forceinline__ uint32_t xempty(int s) const {
    return xraw(2 * kSX + s);
  }
  // K18: y and LN2's statistics are in place (the consumer warps arrive).
  __device__ __forceinline__ uint32_t ydone() const { return xraw(3 * kSX); }
};

// A ring position: stage s of S, the parity of its current phase.
template <int S>
struct Ring {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next() {
    if (++s == S) {
      s = 0;
      ph ^= 1;
    }
  }
};

// One accumulator's walk over `steps` K steps of 32, each loaded, issued
// and waited for in turn (the next step loads its fragments into the same
// registers), its weight stage and fc1's x stage released once it is done
// (every warp of the warpgroup has then loaded its fragments). FC1: B is
// x's stage ring; else the chunk's h boxes from hb. fresh: the first
// product starts acc.
template <int BM, bool FC1>
__device__ __forceinline__ void run_acc(const Smem<BM>& sm, int wgi,
                                        Ring<Cfg<BM>::kSW>& w,
                                        Ring<kSX>& xr, int steps,
                                        uint32_t hb, float (&acc)[BM / 2],
                                        bool fresh) {
  const int t = threadIdx.x % 128;
  uint32_t ah[4][4], al[4][4];
  for (int st = 0; st < steps; ++st) {
    mbar_wait(sm.wfull(w.s), w.ph);
    load_w(sm.wstage(w.s), wgi, ah, al);
    uint32_t bhi;
    if (FC1) {
      mbar_wait(sm.xfull(xr.s), xr.ph);
      bhi = sm.xstage(xr.s) + Cfg<BM>::kXBox;
    } else {
      bhi = hb + st * Cfg<BM>::kXBox;
    }
    const uint32_t blo = bhi + (FC1 ? 1 : 4) * Cfg<BM>::kXBox;
    step<BM>(acc, ah, al, bhi, blo, fresh && st == 0);
    if (t == 0) mbar_arrive(sm.wempty(w.s));
    w.next();
    if (FC1) {
      if (t == 0) mbar_arrive(sm.xempty(xr.s));
      xr.next();
    }
  }
}

// The consumers' walk over the hidden: for each 128-column chunk, fc1 into
// h (this warpgroup's 64 hidden columns), then fc2 into tot, whose group
// q (< G, real where q < ng) holds output columns 128 q + 64 wgi + ...
// as the accumulator layout gives them, seeded by the caller; each
// group's products over a chunk (K = 128) in one accumulator, added to
// tot on the FFMA units. fc1 sums K = D in one accumulator up to D = 1024
// (G <= 8; one accumulator held the bar at K = 768-1536 on the card,
// tools/tf32_probe.py), in accumulators of K = 128 added on the FFMA
// units beyond (G = 12, where the registers allow it). w and xr: the
// rings' positions where the chunks start (K18's out-projection runs
// through both rings first).
template <int BM, int G>
__device__ __forceinline__ void run_chunks(const Smem<BM>& sm,
                                           const MlpTf32Args& a, int wgi,
                                           float (&tot)[G][BM / 2],
                                           Ring<Cfg<BM>::kSW>& w,
                                           Ring<kSX>& xr) {
  constexpr int NV = BM / 2;
  constexpr bool kSplitFc1 = G > 8;
  constexpr int kFc1Steps = kCT / kBK;  // K = 128 an accumulator
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  const int nkd = (a.d + kBK - 1) / kBK, nc = (a.mlp + kCT - 1) / kCT;
  const int ng = (a.d + 127) / 128;
  float part[NV], hacc[NV];
  for (int c = 0; c < nc; ++c) {
    // fc1: h^T = W1[:, chunk]^T @ LN(x)^T, K = D.
    if constexpr (kSplitFc1) {
      for (int k0 = 0; k0 < nkd; k0 += kFc1Steps) {
        const int n = min(kFc1Steps, nkd - k0);
        run_acc<BM, true>(sm, wgi, w, xr, n, 0, part, true);
#pragma unroll
        for (int i = 0; i < NV; ++i)
          hacc[i] = k0 ? hacc[i] + part[i] : part[i];
      }
    } else {
      run_acc<BM, true>(sm, wgi, w, xr, nkd, 0, hacc, true);
    }
    // h = gelu(fc1 + b1), split, at its permuted K slot in the chunk's
    // buffer: hidden column kh is box kh / 32, slot slot8 of its slice.
    const uint32_t hb = sm.hbuf(c);
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int kh = 64 * wgi + 16 * warp + 2 * g + i2;
      const int hc = c * kCT + kh;
      const float bias = hc < a.mlp ? __ldg(a.b1 + hc) : 0.f;
      const uint32_t box = hb + (kh >> 5) * Cfg<BM>::kXBox;
      const int p = (kh & 24) + slot8(kh & 7);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int i1 = 0; i1 < 2; ++i1) {
          const int n = 8 * j + 2 * q + i1;
          const float v = hc < a.mlp ? gelu(hacc[4 * j + 2 * i2 + i1] + bias)
                                     : 0.f;
          uint32_t hi, lo;
          split_tf32(v, hi, lo);
          st_shared_u32(box + sw128_f32(n, p), hi);
          st_shared_u32(box + 4 * Cfg<BM>::kXBox + sw128_f32(n, p), lo);
        }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    consumer_sync();
    // fc2: out^T += W2[chunk, :]^T @ h^T, group by group, K = 128.
#pragma unroll
    for (int qg = 0; qg < G; ++qg) {
      if (qg < ng) {
        run_acc<BM, false>(sm, wgi, w, xr, kCT / kBK, hb, part, true);
#pragma unroll
        for (int i = 0; i < NV; ++i) tot[qg][i] += part[i];
      }
    }
  }
}

// K3's chunk loop: both rings from their first stage.
template <int BM, int G>
__device__ __forceinline__ void run_chunks(const Smem<BM>& sm,
                                           const MlpTf32Args& a, int wgi,
                                           float (&tot)[G][BM / 2]) {
  Ring<Cfg<BM>::kSW> w;
  Ring<kSX> xr;
  run_chunks<BM, G>(sm, a, wgi, tot, w, xr);
}

// LN2's statistics of one row of y, K18's, from out, where the block's
// consumers have just stored it: layernorm_row's arithmetic (row_stats),
// its loads through L2 (ld.global.cg), which sees the other threads'
// stores; the read-only path need not.
__device__ __forceinline__ float2 y_stats(const float* y, int d, float eps,
                                          int lane) {
  float s = 0.f;
  for (int i = lane; i < d; i += 32) s += __ldcg(y + i);
  const float mean = warp_sum(s) / d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float c = __ldcg(y + i) - mean;
    ss += c * c;
  }
  return make_float2(mean, rsqrtf(warp_sum(ss) / d + eps));
}

// The walk of one block, K3's (LAYER false: map_c, map_o and bout unused)
// or K18's (LAYER: map_x reads y from out, map_c ctx, map_o Wout; a.x is
// the layer's input rows, a.g and a.b LN2's scale and bias). a comes by
// value: so K3's kernel compiles to the code it had before K18's form
// shared this walk (tools/sass_count.py --exact).
template <int BM, int G, bool LAYER>
__device__ __forceinline__ void mlp_tf32_walk(const CUtensorMap& map_x,
                                              const CUtensorMap& map_w1,
                                              const CUtensorMap& map_w2,
                                              const CUtensorMap& map_c,
                                              const CUtensorMap& map_o,
                                              MlpTf32Args a,
                                              const float* bout) {
  extern __shared__ uint8_t mt_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(mt_smem) + 1023) & ~uintptr_t(1023));
  const Smem<BM> sm{wg::smem_u32(smem)};
  float* gs = reinterpret_cast<float*>(smem + Cfg<BM>::kGOff);
  float* bs = gs + kMaxD;
  float* mean = reinterpret_cast<float*>(smem + Cfg<BM>::kStOff);
  float* rstd = mean + BM;
  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // LN's parameters and the BM rows' statistics, by every thread (K18's
  // statistics wait for y).
  for (int i = threadIdx.x; i < a.d; i += kThreads) {
    gs[i] = a.g[i];
    bs[i] = a.b[i];
  }
  if constexpr (!LAYER) {
    for (int r = warp; r < BM; r += kThreads / 32) {
      float2 st = make_float2(0.f, 0.f);
      if (m0 + r < a.m)
        st = row_stats(a.x + static_cast<size_t>(m0 + r) * a.d, a.d, a.eps,
                       lane);
      if (lane == 0) {
        mean[r] = st.x;
        rstd[r] = st.y;
      }
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg<BM>::kSW; ++s) {
      mbar_init(sm.wfull(s), 1);
      mbar_init(sm.wempty(s), 2);
    }
    for (int s = 0; s < kSX; ++s) {
      mbar_init(sm.xraw(s), 1);
      mbar_init(sm.xfull(s), kHelpThreads / 32);
      mbar_init(sm.xempty(s), 2);
    }
    if (LAYER) mbar_init(sm.ydone(), 256 / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int nkd = (a.d + kBK - 1) / kBK, nc = (a.mlp + kCT - 1) / kCT;
  const int ng = (a.d + 127) / 128;
  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      // ---- the loads, in the consumers' order ----
      Ring<Cfg<BM>::kSW> w;
      Ring<kSX> xr;
      // Weight stage w.s: W's 32 rows from r0 x 128 columns from c0.
      auto load_w_stage = [&](const CUtensorMap* map, int c0, int r0) {
        mbar_wait(sm.wempty(w.s), w.ph ^ 1);
        mbar_expect_tx(sm.wfull(w.s), kWStage);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_load(sm.wstage(w.s) + j * kSub, map, sm.wfull(w.s),
                   c0 + 32 * j, r0);
        w.next();
      };
      if constexpr (LAYER) {
        // The out-projection, group by group: ctx's box, Wout's stage.
        for (int qg = 0; qg < ng; ++qg)
          for (int kb = 0; kb < nkd; ++kb) {
            mbar_wait(sm.xempty(xr.s), xr.ph ^ 1);
            mbar_expect_tx(sm.xraw(xr.s), Cfg<BM>::kXBox);
            tma_load(sm.xstage(xr.s), &map_c, sm.xraw(xr.s), kBK * kb, m0);
            xr.next();
            load_w_stage(&map_o, 128 * qg, kBK * kb);
          }
        // y is in out, written by the consumers' generic stores.
        mbar_wait(sm.ydone(), 0);
        asm volatile("fence.proxy.async.global;" ::: "memory");
      }
      for (int c = 0; c < nc; ++c) {
        for (int kb = 0; kb < nkd; ++kb) {
          mbar_wait(sm.xempty(xr.s), xr.ph ^ 1);
          mbar_expect_tx(sm.xraw(xr.s), Cfg<BM>::kXBox);
          tma_load(sm.xstage(xr.s), &map_x, sm.xraw(xr.s), kBK * kb, m0);
          xr.next();
          load_w_stage(&map_w1, kCT * c, kBK * kb);
        }
        for (int qg = 0; qg < ng; ++qg)
          for (int st = 0; st < kCT / kBK; ++st)
            load_w_stage(&map_w2, 128 * qg, kCT * c + kBK * st);
      }
    } else if (threadIdx.x >= kHelp0) {
      const int j = threadIdx.x - kHelp0;
      Ring<kSX> xr;
      if constexpr (LAYER) {
        // ---- ctx's boxes, split ----
        for (int qg = 0; qg < ng; ++qg)
          for (int kb = 0; kb < nkd; ++kb) {
            mbar_wait(sm.xraw(xr.s), xr.ph);
            normalize_box<BM, false>(sm.xstage(xr.s), gs, bs, mean, rstd,
                                     kBK * kb, a.d, j);
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            __syncwarp();
            if (j % 32 == 0) mbar_arrive(sm.xfull(xr.s));
            xr.next();
          }
        mbar_wait(sm.ydone(), 0);  // LN2's statistics
      }
      // ---- LN(x) of each x box, split ----
      for (int c = 0; c < nc; ++c)
        for (int kb = 0; kb < nkd; ++kb) {
          mbar_wait(sm.xraw(xr.s), xr.ph);
          normalize_box<BM>(sm.xstage(xr.s), gs, bs, mean, rstd, kBK * kb,
                            a.d, j);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          __syncwarp();
          if (j % 32 == 0) mbar_arrive(sm.xfull(xr.s));
          xr.next();
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128, cw = t / 32, cl = t % 32;
    const int g = cl / 4, q = cl % 4;
    Ring<Cfg<BM>::kSW> w;
    Ring<kSX> xr;
    // Group q's value 4 j + 2 i2 + i1 is row 8 j + 2 q + i1, column
    // 128 q + 64 wgi + 16 cw + 2 g + i2: pairs (i2 = 0, 1) are adjacent
    // columns of one row, read and stored as 8 bytes (D % 4 == 0).
    float tot[G][BM / 2];
    if constexpr (LAYER) {
      // y^T = Wout^T @ ctx^T, group by group, K = D: one accumulator up to
      // D = 1024, accumulators of K = 128 added on the FFMA units beyond.
      constexpr int NV = BM / 2;
      constexpr int kSteps = kCT / kBK;
#pragma unroll
      for (int qg = 0; qg < G; ++qg) {
        if (qg < ng) {
          if constexpr (G > 8) {
            float part[NV];
            for (int k0 = 0; k0 < nkd; k0 += kSteps) {
              run_acc<BM, true>(sm, wgi, w, xr, min(kSteps, nkd - k0), 0,
                                part, true);
#pragma unroll
              for (int i = 0; i < NV; ++i)
                tot[qg][i] = k0 ? tot[qg][i] + part[i] : part[i];
            }
          } else {
            run_acc<BM, true>(sm, wgi, w, xr, nkd, 0, tot[qg], true);
          }
        }
      }
      // y = (ctx @ Wout + bout) + x into the block's rows of out; the
      // totals become y + b2.
#pragma unroll
      for (int qg = 0; qg < G; ++qg)
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int i1 = 0; i1 < 2; ++i1) {
            const int col = 128 * qg + 64 * wgi + 16 * cw + 2 * g;
            const int row = m0 + 8 * j + 2 * q + i1;
            float2 v = make_float2(0.f, 0.f);
            if (qg < ng && col < a.d && row < a.m) {
              const size_t idx = static_cast<size_t>(row) * a.d + col;
              const float2 xv = *reinterpret_cast<const float2*>(a.x + idx);
              v.x = (tot[qg][4 * j + i1] + bout[col]) + xv.x;
              v.y = (tot[qg][4 * j + 2 + i1] + bout[col + 1]) + xv.y;
              *reinterpret_cast<float2*>(a.out + idx) = v;
              v.x += a.b2[col];
              v.y += a.b2[col + 1];
            }
            tot[qg][4 * j + i1] = v.x;
            tot[qg][4 * j + 2 + i1] = v.y;
          }
      asm volatile("fence.proxy.async.global;" ::: "memory");
      consumer_sync();
      // LN2's statistics: consumer warp cwg takes rows cwg, cwg + 8, ...
      for (int r = warp; r < BM; r += 256 / 32) {
        float2 st = make_float2(0.f, 0.f);
        if (m0 + r < a.m)
          st = y_stats(a.out + static_cast<size_t>(m0 + r) * a.d, a.d, a.eps,
                       lane);
        if (lane == 0) {
          mean[r] = st.x;
          rstd[r] = st.y;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.ydone());
    } else {
#pragma unroll
      for (int qg = 0; qg < G; ++qg)
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int i1 = 0; i1 < 2; ++i1) {
            const int col = 128 * qg + 64 * wgi + 16 * cw + 2 * g;
            const int row = m0 + 8 * j + 2 * q + i1;
            float2 v = make_float2(0.f, 0.f);
            if (!a.partial && qg < ng && col < a.d && row < a.m) {
              v = *reinterpret_cast<const float2*>(
                  a.x + static_cast<size_t>(row) * a.d + col);
              v.x += a.b2[col];
              v.y += a.b2[col + 1];
            }
            tot[qg][4 * j + i1] = v.x;
            tot[qg][4 * j + 2 + i1] = v.y;
          }
    }
    if constexpr (LAYER)
      run_chunks<BM, G>(sm, a, wgi, tot, w, xr);
    else
      run_chunks<BM, G>(sm, a, wgi, tot);
#pragma unroll
    for (int qg = 0; qg < G; ++qg)
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int i1 = 0; i1 < 2; ++i1) {
          const int col = 128 * qg + 64 * wgi + 16 * cw + 2 * g;
          const int row = m0 + 8 * j + 2 * q + i1;
          if (qg < ng && col < a.d && row < a.m)
            *reinterpret_cast<float2*>(
                a.out + static_cast<size_t>(row) * a.d + col) =
                make_float2(tot[qg][4 * j + i1], tot[qg][4 * j + 2 + i1]);
        }
  }
}

template <int BM, int G>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w1,
                    const __grid_constant__ CUtensorMap map_w2,
                    MlpTf32Args a) {
  mlp_tf32_walk<BM, G, false>(map_x, map_w1, map_w2, map_x, map_x, a,
                              nullptr);
}

// K18's fp32 form: map_y reads y back from out (m, d), map_c ctx (m, d),
// map_o Wout (d, d) in 32 x 32 boxes; bout (d,).
template <int BM, int G>
__global__ void __launch_bounds__(kThreads, 1)
    layer_tf32_kernel(const __grid_constant__ CUtensorMap map_y,
                      const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_w2,
                      const __grid_constant__ CUtensorMap map_c,
                      const __grid_constant__ CUtensorMap map_o,
                      MlpTf32Args a, const float* bout) {
  mlp_tf32_walk<BM, G, true>(map_y, map_w1, map_w2, map_c, map_o, a, bout);
}

}  // namespace mt
}  // namespace vit
