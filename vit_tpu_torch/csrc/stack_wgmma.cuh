// K9's bf16 GEMM phases on Hopper's tensor cores (encoder_stack.cu, and
// its probe K24, encstack_probe.cu): one phase is every tile of
// LN(x) @ W or x @ W over a grid of persistent blocks, on bf16
// wgmma fed by TMA from tensor maps over the stacked (L*K, N) weights. It
// replaces gemm_tile.cuh's unpipelined wmma loop in those phases; FOLD's
// patch projection (phase 0) and the fp32 kernel keep gemm_tile.cuh.
//
// Tiling, for batch 1-2 (M = 208-416 rows): an item is a 64-row tile by a
// 128-column tile of the output, and, in the out-projection and fc2, one of
// S slices of K (split-K). Items are walked in the order (column tile,
// slice, row tile), row tile fastest, strided over the grid, so that the
// blocks that read one weight slab run side by side and the slab comes
// from device memory once. The block's two warpgroups take 64 columns each
// (m64n64k16, 32 fp32 sums a thread). At B/16 bs=1 the QKV has 72 items,
// fc1 96, the out-projection and fc2 120 (S = 5): the weight stream
// spreads over (nearly) all 132 SMs.
//
// Split-K. S = min(8, K / 64, max(1, grid / tiles)) slices of K, slice s
// the 64-row steps [s nk / S, (s+1) nk / S). A slice's fp32 sums go to a
// workspace (S, M, N) (the caller's scratch: the packed QKV buffer, which
// no phase reads then); after a grid barrier, reduce_phase adds the S
// slices of each element in ascending order, ((p0 + p1) + p2) + ..., and
// hands the sum to the phase's epilogue. No atomics: two calls give the
// same bits, and a row's result does not depend on M. A phase given no
// workspace runs whole (S = 1) and stores directly.
//
// LN (QKV and fc1): before the products, ln_pass writes LN(x) of every row
// once, in bf16, into a buffer no phase reads then (K9's context buffer),
// with layernorm_row's arithmetic (fp32 mean, centred variance, ((x -
// mean) * rstd) * g + b rounded to bf16); after a grid barrier the phase
// reads it by TMA into the swizzled A layout, as it reads any A, so
// nothing is normalised while staged. (A first form wrote LN(x) of each
// item's 64 rows into shared memory, as K3 does: 18 to 32 items share a
// row tile, and an item's prologue took twice its 12 K-steps; the pass
// and its barrier take a tenth of that.)
//
// Pipeline. The kernel's block is 256 threads, which the attention phase
// uses whole, so there is no producer warpgroup: thread 0 keeps a ring of
// up to 12 stages (the A box, 8 KB, and the B boxes, 16 KB, or the raw
// int8 box, 8 KB) full ahead of the consumers: 9 stages in bf16, 12 with
// int8 weights. Before each K step it issues every step whose stage both
// warpgroups have released, without waiting, and waits only for the step
// its warpgroup takes now. Each warpgroup waits for its stage, issues four
// m64n64k16 with A K-major and B MN-major (the transpose bit: W read where
// it lies), waits for them (K3's finding: a group left in flight
// serialised ptxas's wgmma) and releases the stage. The barriers are
// initialised at the start of each phase and invalidated at its end: the
// attention phase and phase 0 reuse the same shared memory.
//
// int8 weights (encoder_stack_q): the stage holds the raw (64 K x 128 N)
// int8 box as TMA wrote it (128-byte swizzle); each warpgroup converts its
// 64 columns into its half of a bf16 buffer (q_convert.cuh, exact),
// fences, meets its own 128 threads at a named barrier and runs the same
// wgmma. The column scale applies in the epilogue before the bias, as the
// caller's epilogue does (JAX's order).
//
// Bound on the card: the weight stream at bs <= 2 (encoder_stack.cu). What
// the phases still leave: each item reads its weight slab and its 64 rows
// from L2 (the slab four to seven times over, once per row tile, and the
// rows once per column tile); the LN and split phases add a pass and a
// grid barrier each.

#pragma once

#include "gemm_wgmma.cuh"
#include "mlp_wgmma.cuh"
#include "q_convert.cuh"

namespace vit {
namespace sw {

using wg::fence_acc;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::sw128_desc;
using wg::tma_load;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int kBM = 64;        // rows of an item
constexpr int kBN = 128;       // columns of an item: 64 a warpgroup
constexpr int kBK = 64;        // K of a step
constexpr int kThreads = 256;  // the kernel's block
constexpr int kBox = 8192;     // 64 x 64 bf16
constexpr int kMaxStages = 12;
constexpr int kMaxSplits = 8;
constexpr int kSmemMax = 232448;
constexpr int kBarBytes = 2 * kMaxStages * 8;

// The tensor maps of a launch (encoded on the host; unused in fp32): the
// A operands (x, the context, which also holds LN(x), the hidden), and the
// stacked weights.
struct Maps {
  CUtensorMap x, ctx, hid;     // (m, D), (m, D), (m, mlp) bf16, 64 x 64
  CUtensorMap wqkv, wout, w1, w2;  // (L*K, N): bf16 64 x 64, int8 128 x 64
};

// Shared memory of a phase (bytes from the 1024-aligned base): for int8
// weights the bf16 B buffer the warpgroups convert into (16 KB); the ring,
// as many stages as the block's 227 KB hold, up to 12, a stage the A box
// (8 KB) and the weight boxes (bf16 16 KB, or the raw int8 box, 8 KB); the
// barriers. The kernel takes all 227 KB.
template <typename W>
struct Layout {
  static constexpr bool kI8 = sizeof(W) == 1;
  static constexpr int kConv = 0;
  static constexpr int kRing = kI8 ? 2 * kBox : 0;
  static constexpr int kStage = kBox + (kI8 ? kBox : 2 * kBox);
  static constexpr int kStagesFit = (kSmemMax - 1024 - kBarBytes - kRing) /
                                    kStage;
  static constexpr int kStages =
      kStagesFit < kMaxStages ? kStagesFit : kMaxStages;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kSmem = kSmemMax;
  static_assert(kStages >= 2, "two stages at least");
};

// One phase's shape: M, N, K, the tiles and the split.
struct Geo {
  int m, n, k, nk, tiles_m, tiles_n, splits, items;
  __device__ Geo(int m_, int n_, int k_, bool split) : m(m_), n(n_), k(k_) {
    nk = k / kBK;
    tiles_m = (m + kBM - 1) / kBM;
    tiles_n = (n + kBN - 1) / kBN;
    const int tiles = tiles_m * tiles_n;
    int s = split ? static_cast<int>(gridDim.x) / tiles : 1;
    s = s < 1 ? 1 : s;
    s = s < kMaxSplits ? s : kMaxSplits;
    splits = s < nk ? s : nk;
    items = tiles * splits;
  }
  // Item i: its row tile, column tile, slice and K steps [lo, hi).
  __device__ void item(int i, int& rt, int& nt, int& s, int& lo,
                       int& hi) const {
    rt = i % tiles_m;
    const int ns = i / tiles_m;
    s = ns % splits;
    nt = ns / splits;
    lo = s * nk / splits;
    hi = (s + 1) * nk / splits;
  }
};

// Order this thread's generic accesses to shared and global memory before
// the async proxy's (TMA, wgmma) that follow a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// LN of the m rows of x (m, k) into xn, rounded to bf16, a row a warp over
// the grid, with layernorm_row's arithmetic (fp32 mean, centred variance,
// ((x - mean) * rstd) * g + b). A lane holds 16-byte chunks lane, lane +
// 32, ... of its row (k a multiple of 8 up to kMaxK), so the row is read
// once; xn may be x itself (the row is in registers before it is written).
// The phase that reads xn by TMA follows a grid barrier.
constexpr int kMaxK = 2048;
__device__ __forceinline__ void ln_pass(const bf16* x, bf16* xn, int m,
                                        int k, const bf16* g, const bf16* b,
                                        float eps) {
  constexpr int PER = kMaxK / 8 / 32;
  const int warps = gridDim.x * (kThreads / 32), lane = threadIdx.x % 32;
  const int nch = k / 8;
  for (int r = blockIdx.x * (kThreads / 32) + threadIdx.x / 32; r < m;
       r += warps) {
    const bf16* xr = x + static_cast<size_t>(r) * k;
    bf16* outr = xn + static_cast<size_t>(r) * k;
    float v[PER][8];
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int ch = lane + 32 * p;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (ch < nch) raw = *reinterpret_cast<const uint4*>(xr + 8 * ch);
      const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[p][e] = to_f32(h[e]);
        s += v[p][e];  // zeros past k
      }
    }
    const float mean = warp_sum(s) / k;
    float ss = 0.f;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      if (lane + 32 * p < nch) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float c = v[p][e] - mean;
          ss += c * c;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(ss) / k + eps);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int ch = lane + 32 * p;
      if (ch >= nch) continue;
      const uint4 gr = *reinterpret_cast<const uint4*>(g + 8 * ch);
      const uint4 br = *reinterpret_cast<const uint4*>(b + 8 * ch);
      const bf16* gh = reinterpret_cast<const bf16*>(&gr);
      const bf16* bh = reinterpret_cast<const bf16*>(&br);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const __nv_bfloat162 y = __floats2bfloat162_rn(
            (v[p][e] - mean) * rstd * to_f32(gh[e]) + to_f32(bh[e]),
            (v[p][e + 1] - mean) * rstd * to_f32(gh[e + 1]) +
                to_f32(bh[e + 1]));
        o[e / 2] = *reinterpret_cast<const uint32_t*>(&y);
      }
      *reinterpret_cast<uint4*>(outr + 8 * ch) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  fence_proxy_async();  // TMA reads xn next
}

// One GEMM phase: a @ W, a through map_a, W the K rows from w_row0 of the
// stacked map_w. Every element inside (m, n) goes to ep.store(row, col,
// sum) once, or, split, to ws as a slice for reduce_phase. All 256 threads
// of every block call it together.
template <typename W, typename Ep>
__device__ __forceinline__ void wgmma_phase(
    uint8_t* sm, const CUtensorMap* map_a, const CUtensorMap* map_w,
    int w_row0, int m, int n, int k, float* ws, const Ep& ep) {
  using L = Layout<W>;
  const uint32_t base = smem_u32(sm);
  const uint32_t full0 = base + L::kBars, empty0 = full0 + 8 * kMaxStages;
  constexpr int S = L::kStages;
  const Geo geo(m, n, k, ws != nullptr);
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;

  // The previous phase's shared memory (attention, phase 0, an earlier
  // ring) is done with; its generic writes come before TMA's.
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);   // thread 0's arrive + the bytes
      mbar_init(empty0 + 8 * s, 2);  // one arrive a warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Thread 0's producer: the block's steps in order, (item, K step).
  int p_i = blockIdx.x, p_kb = 0, p_hi = 0, p_rt = 0, p_nt = 0;
  bool p_live = p_i < geo.items;
  uint32_t np = 0;  // steps issued
  if (p_live) {
    int s;
    geo.item(p_i, p_rt, p_nt, s, p_kb, p_hi);
  }
  // Steps up to `upto` whose stage is free; with `wait`, waiting for the
  // stage (thread 0 waits only for the step its warpgroup takes next, not
  // for the other warpgroup's releases of later ones).
  auto produce = [&](uint32_t upto, bool wait) {
    while (p_live && np < upto) {
      const int rt = p_rt, nt = p_nt;
      const int st = np % S;
      const uint32_t parity = ((np / S) & 1) ^ 1;
      if (!wait && !wg::mbar_try(empty0 + 8 * st, parity)) return;
      mbar_wait(empty0 + 8 * st, parity);
      const uint32_t full = full0 + 8 * st;
      const uint32_t sa = base + L::kRing + st * L::kStage;
      const uint32_t sb = sa + kBox;
      // A (8 KB); B as two bf16 boxes, or one raw int8 box of 64 x 128
      // codes (8 KB).
      mbar_expect_tx(full, L::kStage);
      tma_load(sa, map_a, full, p_kb * kBK, rt * kBM);
      const int wr = w_row0 + p_kb * kBK;
      if constexpr (L::kI8) {
        tma_load(sb, map_w, full, nt * kBN, wr);
      } else {
        tma_load(sb, map_w, full, nt * kBN, wr);
        tma_load(sb + kBox, map_w, full, nt * kBN + 64, wr);
      }
      ++np;
      if (++p_kb == p_hi) {
        p_i += gridDim.x;
        p_live = p_i < geo.items;
        int s;
        if (p_live) geo.item(p_i, p_rt, p_nt, s, p_kb, p_hi);
      }
    }
  };
  uint32_t nc = 0;  // steps consumed
  for (int i = blockIdx.x; i < geo.items; i += gridDim.x) {
    int rt, nt, s, lo, hi;
    geo.item(i, rt, nt, s, lo, hi);
    const int m0 = rt * kBM, n0 = nt * kBN;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int kb = lo; kb < hi; ++kb, ++nc) {
      if (threadIdx.x == 0) {
        produce(nc + S, false);
        produce(nc + 1, true);
      }
      __syncwarp();
      const int st = nc % S;
      mbar_wait(full0 + 8 * st, (nc / S) & 1);
      const uint32_t sa = base + L::kRing + st * L::kStage;
      const uint32_t wbox = sa + kBox;  // the weight boxes
      const uint32_t sb =
          (L::kI8 ? base + L::kConv : wbox) + wgi * kBox;  // this wg's B
      if constexpr (L::kI8) {
        // This warpgroup's 64 columns of the raw box into its half of the
        // conversion buffer (free: its previous wgmma has completed).
        const uint32_t raw = wbox;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          int pb, kr, c;
          qc::chunk_of(t + 128 * j, 64, pb, kr, c);
          qc::store_chunk(sb, kr, c,
                          qc::ld_shared4(qc::raw_sw128(raw, kr, 4 * wgi + c)));
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + wgi) : "memory");
      }
      const uint32_t xa = sa;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mw::wgmma_ss<64>(acc, sw128_desc(xa + kk * 32, 16, 1024),
                         sw128_desc(sb + kk * 2048, kBox, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      if (t == 0) mbar_arrive(empty0 + 8 * st);
    }
    // acc[4j + i]: row 16*warp + lane/4 + 8(i/2), column 64*wgi + 8j +
    // 2(lane%4) + i%2 of the item.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + 16 * warp + lane / 4 + 8 * (e / 2);
        const int col = n0 + 64 * wgi + 8 * j + 2 * (lane % 4) + e % 2;
        if (row < m && col < n) {
          if (geo.splits > 1)
            ws[(static_cast<size_t>(s) * m + row) * n + col] = acc[4 * j + e];
          else
            ep.store(row, col, acc[4 * j + e]);
        }
      }
  }
  // Every step issued was consumed; the ring is idle. The epilogue's global
  // writes come before the next phase's TMA reads of them.
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < S; ++s) {
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(full0 + 8 * s)
                   : "memory");
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(empty0 +
                                                                8 * s)
                   : "memory");
    }
}

// The split count wgmma_phase chose for (m, n, k) with a workspace: 1 when
// it stored directly and no reduce_phase is due.
__device__ __forceinline__ int phase_splits(int m, int n, int k) {
  return Geo(m, n, k, true).splits;
}

// The sums of a split phase: each element's S slices of ws added in
// ascending order, then ep.store, grid-strided.
template <typename Ep>
__device__ __forceinline__ void reduce_phase(const float* ws, int splits,
                                             int m, int n, const Ep& ep) {
  const size_t mn = static_cast<size_t>(m) * n;
  for (size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       e < mn; e += static_cast<size_t>(gridDim.x) * kThreads) {
    float v = ws[e];
    for (int s = 1; s < splits; ++s) v += ws[s * mn + e];
    ep.store(static_cast<int>(e / n), static_cast<int>(e % n), v);
  }
  fence_proxy_async();
}

}  // namespace sw
}  // namespace vit
