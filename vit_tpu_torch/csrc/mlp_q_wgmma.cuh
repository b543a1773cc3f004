// K17's bf16 tile for Hopper (vit_tpu/ops/pallas/block.py:mlp_block_q, its
// kernel _mlp_q_kernel :335-382, pallas_call :416, stacked :1588 with
// i8dot=False; mlp_block_q.cu launches it): out = x + fc2(gelu(fc1(LN(x))))
// with int8 weights and fp32 per-column scales, the activations in bf16,
// on bf16 wgmma fed by TMA, the (rows, mlp) hidden kept on chip.
//
// Shape: K3's cluster tile (mlp_wgmma.cuh), whose helpers it uses. A
// cluster of two blocks owns 64 rows; block r owns output columns
// [r*D/2, (r+1)*D/2) (T boxes of 64, D = 128 T). Both blocks write LN(x)
// of the rows, rounded to bf16, into shared memory as K3 does. The MLP
// columns go in chunks of 128: block r computes chunk columns [64r, 64r+64)
// of fc1 (each consumer warpgroup 32, m64n32), h = gelu((acc * s1) + b1)
// in fp32, rounded to bf16, into its half of the chunk's h buffer; one bulk
// copy puts the half into the other block's buffer. Then fc2 runs over the
// chunk for the warpgroup's output boxes of the pass.
//
// The scales (block.py:358-376, reference.mlp_block_q): fc1's sum is
// scaled per column before its bias. fc2 is scaled per quant group of 512
// hidden columns (reference.MLP_GROUP, four chunks): the group's fc2 sums
// collect in registers of their own (p, K12's order, mlp_i8_wgmma.cuh),
// and when the group's last chunk is done each output column takes acc +=
// p * s2 (__fmul_rn, __fadd_rn) and p restarts at zero. acc is seeded with
// x + b2 (zero for the partial form) and cast once. So the tile keeps the
// rounding points of the plain version; only the fp32 sum order inside a
// group differs (wgmma's k16 steps, chunk after chunk).
//
// Registers and passes. acc and p of a 64-column box take 32 registers
// each. The block has no producer warpgroup (256 threads, both consumer
// warpgroups), so a thread may hold 255 registers, and a warpgroup keeps
// up to three boxes a pass (NB = 3: 192 sums a thread beside fc1's 16):
// D = 768 runs in one pass, as K3 does; D = 1024 in two (six boxes, then
// two); H/14's D = 1280, whose LN(x) leaves 18 KB, in five passes of one
// box a warpgroup (Cfg). A first form with K3's producer warpgroup (384
// threads, at most 168 registers) held two boxes, ran D = 768 in two
// passes and spilled.
//
// Weights. Two consumer threads stream the int8 boxes by TMA as they lie
// (no swizzle: W1 boxes of 64 D-rows x the block's 64 chunk columns, W2
// boxes of KS2 hidden rows x 64 output columns) into two raw rings, thread
// 0 the W1 ring (S1 slots), warpgroup 1's leader the W2 ring (S2 slots),
// each in the consumers' order: a producer issues every item whose slot
// both warpgroups have released, without waiting, and waits only for the
// item its own warpgroup takes next. Each warpgroup converts only what
// its own wgmma reads (q_convert.cuh): its 32 of the W1 box's 64 columns
// (one raw chunk a thread), or its NB boxes of the W2 stage, into bf16
// buffers in the swizzled MN-major layout K3's TMA gave its bf16 boxes;
// proxy fence, a named barrier of its 128 threads, the raw slots
// released, then its wgmma reads the buffer with the transpose bit set,
// exactly as in K3. The two warpgroups write disjoint halves of the
// buffers and each rewrites its half only after its own wgmma is done, so
// the buffers need no barrier. Both warpgroups take each ring's items in
// the same order (fc1's K-steps two at a time, each pair followed by the
// fc2 stages of the previous chunk due by then, as K3 interleaves them),
// so each ring frees in order, and a producer's one wait is for a release
// the other warpgroup makes without it (the protocol test runs the rings
// under random interleavings).
//
// What the earlier forms taught (B/16 bs=32 on an H100, clock64 counters
// of one tile): converting in three producer warps cost a third of the
// time; one thread filling both rings and waiting for every slot stalled
// its warpgroup for 43% of the tile. With the rings split and the waits
// gone, a warpgroup still waits for its data about a third of the time
// (its producer issues one item between its own steps) and spends about a
// sixth in the proxy fence and barrier after its conversion.
//
// h exchange (K12's form): h is double-buffered, buffer b holding chunks
// b, b + 2, ...; before writing chunk g a consumer waits until all four
// warpgroups of the cluster are done with chunk g - 2 (hempty[b]: each
// warpgroup's leader arrives on both blocks' barrier once its fc2 of the
// chunk is done). After writing (and a proxy fence) the 256 threads arrive
// on hfull[b], meet at the block barrier, and thread 0 copies the block's
// 8 KB half into the other block's buffer, its bytes counted on that
// block's hfull[b].
//
// Shared memory (bytes, base aligned to 1024): LN(x) (D/64 boxes of 8 KB),
// the h buffers (2 x 16 KB), the W1 buffer (a fc1 pair, 2 x 8 KB), the W2
// buffer (KS2 x 128 x 2 NB), S1 raw W1 slots (4 KB), S2 raw W2 slots
// (KS2 x 64 x 2 NB), barriers: 227 KB at most, which sets NB, KS2, S1 and
// S2 (Cfg).
//
// Bound on the card: the tensor cores, 4*M*D*mlp operations (62.8 GFLOP
// at B/16 bs=32, 0.0635 ms at 989 TFLOP/s), on half of K3's weight bytes.
// What the tile still leaves: each cluster reads all of W1 and W2 from L2
// and converts them per 64 rows, on the consumers' critical path; the
// passes at D >= 896 recompute fc1.

#pragma once

#include "mlp_wgmma.cuh"
#include "q_convert.cuh"

namespace vit {
namespace mqw {

using mw::arrive_cluster;
using mw::arrive_expect_cluster;
using mw::cluster_rank;
using mw::cluster_sync;
using mw::copy_to_cluster;
using mw::mapa;
using mw::wait_cluster;
using mw::wgmma_fc1;
using mw::wgmma_ss;
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

constexpr int kBM = 64;          // rows of a cluster
constexpr int kCT = 128;         // MLP columns a chunk
constexpr int kHC = kCT / 2;     // a block's share of a chunk
constexpr int kGroupChunks = 4;  // 512 columns: reference.MLP_GROUP
constexpr int kThreads = 256;    // two consumer warpgroups
constexpr int kBox = 8192;       // 64 x 64 bf16
constexpr int kSmemMax = 232448;
constexpr int kBarBytes = 256;
constexpr int kMaxS1 = 12;
constexpr int kRaw1 = 64 * 64;  // a W1 box: 64 D-rows x 64 columns

// Bytes after LN(x), h and the W1 buffer, for the W2 buffer and the raw
// rings.
constexpr int free_bytes(int t) {
  return kSmemMax - 1024 - kBarBytes - (2 * t + 4) * kBox - 2 * kBox;
}
// A W2 stage of nb boxes a warpgroup of ks2 rows: its bf16 buffer and its
// raw slot.
constexpr int stage2(int nb, int ks2) { return ks2 * 128 * 2 * nb; }
constexpr int raw2(int nb, int ks2) { return ks2 * 64 * 2 * nb; }
// Raw W1 slots beside the W2 buffer and two raw W2 slots.
constexpr int w1_slots(int t, int nb, int ks2) {
  return (free_bytes(t) - stage2(nb, ks2) - 2 * raw2(nb, ks2)) / kRaw1;
}
// Whether (nb, ks2) leaves `want` W1 slots.
constexpr bool fits(int t, int nb, int ks2, int want) {
  return w1_slots(t, nb, ks2) >= want;
}

template <int T>
struct Cfg {
  static constexpr int D = 128 * T;
  // The widest W2 stage that leaves four W1 slots (three boxes a
  // warpgroup of 32 rows first, then 16 rows, then two boxes, one), else
  // the widest that leaves two.
  static constexpr int pick(int want) {
    return fits(T, 3, 32, want)   ? 332
           : fits(T, 3, 16, want) ? 316
           : fits(T, 2, 32, want) ? 232
           : fits(T, 2, 16, want) ? 216
           : fits(T, 1, 32, want) ? 132
           : fits(T, 1, 16, want) ? 116
                                  : 0;
  }
  static constexpr int kPick = pick(4) ? pick(4) : pick(2);
  static constexpr int NBmax = kPick / 100, KS2 = kPick % 100;
  static constexpr int BP = T < 2 * NBmax ? T : 2 * NBmax;  // boxes a pass
  static constexpr int NP = (T + BP - 1) / BP;
  static constexpr int NB = (BP + 1) / 2;  // boxes a warpgroup a pass
  __host__ __device__ static constexpr int boxes(int q, int w) {
    const int b = (T - q * BP < BP ? T - q * BP : BP) - w * NB;
    return b < 0 ? 0 : (b > NB ? NB : b);
  }
  static constexpr int kXn = D / 64 * kBox;
  static constexpr int kH = 2 * 2 * kBox;
  static constexpr int kW1Off = kXn + kH;  // two boxes: a fc1 pair
  static constexpr int kW2Off = kW1Off + 2 * kBox;
  static constexpr int kBox2 = KS2 * 128;
  static constexpr int kStage2 = stage2(NBmax, KS2);
  static constexpr int kRaw2 = raw2(NBmax, KS2);
  static constexpr int S2 = 2;
  static constexpr int S1 = w1_slots(T, NBmax, KS2) < kMaxS1
                                ? w1_slots(T, NBmax, KS2)
                                : kMaxS1;
  static constexpr int kRaw1Off = kW2Off + kStage2;
  static constexpr int kRaw2Off = kRaw1Off + S1 * kRaw1;
  static constexpr int kBarOff = kRaw2Off + S2 * kRaw2;
  static constexpr int kSmem = kBarOff + kBarBytes + 1024;
  static constexpr int kLdc0 = 64 * NB + 8;
  static constexpr int NKB = D / 64, NKS = kCT / KS2;
  static_assert(kPick != 0 && S1 >= 2, "two W1 slots at least: a fc1 pair");
  static_assert(kSmem <= kSmemMax, "227 KB a block");
  static_assert((2 * S1 + 2 * S2 + 4) * 8 <= kBarBytes, "barriers");
  static_assert(kBox2 % 1024 == 0 && kRaw2 % 1024 == 0, "aligned slots");
};

// The operands of one launch: K3's, and the two scales.
struct QArgs {
  mw::MlpArgs a;
  const float* s1;
  const float* s2;
};

// A block's barriers: the raw W1 ring and the raw W2 ring, each full
// (TMA) and empty (both warpgroups); then hfull[2], hempty[2].
template <int T>
struct Bars {
  uint32_t f1, e1, f2, e2, hfull, hempty;
  __device__ explicit Bars(uint32_t base) {
    using C = Cfg<T>;
    f1 = base + C::kBarOff;
    e1 = f1 + 8 * C::S1;
    f2 = e1 + 8 * C::S1;
    e2 = f2 + 8 * C::S2;
    hfull = e2 + 8 * C::S2;
    hempty = hfull + 16;
  }
};

// Real boxes of the block in pass q (the W2 TMA loads only these; the
// rest of a warpgroup's boxes are padding whose sums are not stored).
template <int T>
__host__ __device__ constexpr int pass_boxes(int q) {
  using C = Cfg<T>;
  return T - q * C::BP < C::BP ? T - q * C::BP : C::BP;
}

template <int T>
__device__ __forceinline__ void mlp_q_block(
    const CUtensorMap* map_w1, const CUtensorMap* map_w2, const QArgs& qa,
    uint32_t base, uint8_t* smem, uint32_t rank, int m0) {
  using C = Cfg<T>;
  constexpr int D = C::D, NB = C::NB, NKB = C::NKB, NKS = C::NKS;
  static_assert(64 * (C::kLdc0 + 64 * C::boxes(C::NP - 1, 1) + 8) * 2 <=
                    C::kXn,
                "the last pass's output staging fits the LN(x) region");
  const mw::MlpArgs& a = qa.a;
  const Bars<T> bar(base);
  const uint32_t peer = rank ^ 1;
  const int wgi = threadIdx.x / 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int nchunks = a.mlp / kCT;
  float acc[32 * NB];
  float p[32 * NB];
  float h1[16];

  // The producers, in the order the consumers take each ring's items:
  // thread 0 fills the W1 ring, warpgroup 1's leader the W2 ring. W1 item
  // j is K-step j % NKB of fc1 of chunk j / NKB (over the passes), W2 item
  // j stage j % NKS of fc2 of chunk j / NKS. Item j goes into slot j % S
  // once both warpgroups have released the slot's previous item. A
  // producer issues every item whose slot is free without waiting, and
  // waits only for the item its own warpgroup takes next. (One thread
  // issuing both rings and waiting for every slot stalled its warpgroup
  // for 43% of the tile's time at B/16 bs=32, by clock64 counters.)
  const int n1 = C::NP * nchunks * NKB, n2 = C::NP * nchunks * NKS;
  int np1 = 0, np2 = 0;
  auto issue2 = [&](bool wait) {
    const int s = np2 % C::S2, g = np2 / NKS;
    const uint32_t parity = ((np2 / C::S2) & 1) ^ 1;
    if (!wait && !wg::mbar_try(bar.e2 + 8 * s, parity)) return false;
    mbar_wait(bar.e2 + 8 * s, parity);
    const int q = g / nchunks, chunk = g % nchunks, step = np2 % NKS;
    // W2 rows [chunk*128 + KS2 step, + KS2), the pass's boxes.
    const int nbox = pass_boxes<T>(q);
    const uint32_t raw = base + C::kRaw2Off + s * C::kRaw2;
    mbar_expect_tx(bar.f2 + 8 * s, nbox * C::KS2 * 64);
    for (int pb = 0; pb < nbox; ++pb)
      tma_load(raw + pb * C::KS2 * 64, map_w2, bar.f2 + 8 * s,
               rank * (D / 2) + 64 * (q * C::BP + pb),
               chunk * kCT + step * C::KS2);
    ++np2;
    return true;
  };
  auto issue1 = [&](bool wait) {
    const int s = np1 % C::S1, chunk = (np1 / NKB) % nchunks;
    const uint32_t parity = ((np1 / C::S1) & 1) ^ 1;
    if (!wait && !wg::mbar_try(bar.e1 + 8 * s, parity)) return false;
    mbar_wait(bar.e1 + 8 * s, parity);
    // W1 rows [64 step, +64), the block's 64 columns of the chunk.
    mbar_expect_tx(bar.f1 + 8 * s, kRaw1);
    tma_load(base + C::kRaw1Off + s * kRaw1, map_w1, bar.f1 + 8 * s,
             chunk * kCT + rank * kHC, 64 * (np1 % NKB));
    ++np1;
    return true;
  };
  // This warpgroup's items of each ring: taken (waited for) and released.
  int taken[2] = {0, 0}, released[2] = {0, 0};
  auto take = [&](int ring) {
    const int n = taken[ring]++;
    if (t == 0 && wgi == 0) {
      while (np1 < n1 && np1 < released[0] + C::S1 && issue1(false)) {
      }
      // The item taken now, waiting for its slot if need be.
      while (ring == 0 && np1 <= n) issue1(true);
    } else if (t == 0) {
      while (np2 < n2 && np2 < released[1] + C::S2 && issue2(false)) {
      }
      while (ring == 1 && np2 <= n) issue2(true);
    }
    __syncwarp();
    const int S = ring ? C::S2 : C::S1;
    mbar_wait((ring ? bar.f2 : bar.f1) + 8 * (n % S), (n / S) & 1);
    return ring ? base + C::kRaw2Off + (n % S) * C::kRaw2
                : base + C::kRaw1Off + (n % S) * kRaw1;
  };
  // After the warpgroup's conversions of the items it took: the proxy
  // fence (wgmma reads the buffers through the async proxy), the
  // warpgroup's barrier, then its leader frees the raw slots.
  auto release = [&]() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    named_sync(1 + wgi);
    for (; released[0] < taken[0]; ++released[0])
      if (t == 0) mbar_arrive(bar.e1 + 8 * (released[0] % C::S1));
    for (; released[1] < taken[1]; ++released[1])
      if (t == 0) mbar_arrive(bar.e2 + 8 * (released[1] % C::S2));
  };

  // fc1 K-steps kb and kb+1 of a chunk: each raw box's 32 columns of this
  // warpgroup (row t / 2, raw chunk 2 wgi + t % 2 of the 64-byte rows)
  // into one of the W1 buffer's boxes, then one wgmma group over both.
  auto fc1_step = [&](int kb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t raw = take(0);
      const int k = t / 2, c = 2 * wgi + t % 2;
      qc::store_chunk(base + C::kW1Off + h * kBox, k, c,
                      qc::ld_shared4(qc::raw_dense(raw, k, c, 64)));
    }
    release();
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t xa = base + (kb + h) * kBox;
      const uint32_t wb = base + C::kW1Off + h * kBox + 64 * wgi;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_fc1(h1, sw128_desc(xa + kk * 32, 16, 1024),
                  sw128_desc(wb + kk * 2048, kBox, 1024),
                  kb + h > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(h1);
  };
  // fc2 stage ks of the chunk in the h buffer at ha: this warpgroup's NB
  // boxes of the raw stage into its boxes of the W2 buffer, then p += h[:,
  // KS2 rows] @ W2[those rows, the warpgroup's columns].
  auto fc2_step = [&](int ks, uint32_t ha) {
    const uint32_t raw = take(1);
    constexpr int kChunks = NB * C::KS2 * 4;
#pragma unroll
    for (int e = t; e < kChunks; e += 128) {
      int b, k, c;
      qc::chunk_of(e, C::KS2, b, k, c);
      const int box = NB * wgi + b;
      qc::store_chunk(base + C::kW2Off + box * C::kBox2, k, c,
                      qc::ld_shared4(qc::raw_dense(
                          raw + box * C::KS2 * 64, k, c, 64)));
    }
    release();
    const uint32_t wb = base + C::kW2Off + NB * wgi * C::kBox2;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS2 / 16; ++kk) {
      const int kg = ks * (C::KS2 / 16) + kk;
      wgmma_ss<64 * NB>(
          p, sw128_desc(ha + (kg / 4) * kBox + (kg % 4) * 32, 16, 1024),
          sw128_desc(wb + kk * 2048, C::kBox2, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(p);
  };

  for (int q = 0; q < C::NP; ++q) {
    const int real = C::boxes(q, wgi);
    const int col0 = rank * (D / 2) + 64 * (q * C::BP + NB * wgi);
    // acc[4j + i]: row 16*warp + lane/4 + 8(i/2), column col0 + 8j +
    // 2(lane%4) + i%2, seeded with x + b2 (zero for the partial form and
    // past the block's columns); p starts at zero.
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = m0 + 16 * warp + lane / 4 + 8 * (i / 2);
        const int c = col0 + 8 * j + 2 * (lane % 4) + i % 2;
        acc[4 * j + i] =
            j < 8 * real && r < a.m && !a.partial
                ? __fadd_rn(to_f32(a.x[static_cast<size_t>(r) * D + c]),
                            to_f32(a.b2[c]))
                : 0.f;
        p[4 * j + i] = 0.f;
      }

    for (int c = 0; c <= nchunks; ++c) {
      const int g = q * nchunks + c;
      const int hb2 = (g - 1) & 1;
      const uint32_t ha = base + C::kXn + hb2 * 2 * kBox;
      int ks = 0;
      auto fc2_upto = [&](int n) {
        if (ks < n && ks == 0)
          wait_cluster(bar.hfull + 8 * hb2, ((g - 1) >> 1) & 1);
        for (; ks < n; ++ks) fc2_step(ks, ha);
      };
      if (c < nchunks) {
        for (int kb = 0; kb < NKB; kb += 2) {
          fc1_step(kb);
          if (c >= 1 && kb >= 2) fc2_upto(kb * NKS / NKB);
        }
        if (c >= 1) fc2_upto(NKS);
      } else {
        fc2_upto(NKS);
      }
      if (c >= 1) {
        // Done with h(c-1): free its buffer in both blocks.
        if (t == 0) {
          arrive_cluster(mapa(bar.hempty + 8 * hb2, rank));
          arrive_cluster(mapa(bar.hempty + 8 * hb2, peer));
        }
        // The last chunk of a quant group: acc += p * s2, p restarts.
        if (c % kGroupChunks == 0) {
#pragma unroll
          for (int j = 0; j < 8 * NB; ++j) {
            const int cc = col0 + 8 * j + 2 * (lane % 4);
            const float sa = j < 8 * real ? qa.s2[cc] : 0.f;
            const float sb = j < 8 * real ? qa.s2[cc + 1] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[4 * j + i] = __fadd_rn(
                  acc[4 * j + i], __fmul_rn(p[4 * j + i], i % 2 ? sb : sa));
              p[4 * j + i] = 0.f;
            }
          }
        }
      }
      if (c < nchunks) {
        // h(c) = bf16(gelu((h1 * s1) + b1)): the warpgroup's 32 columns of
        // the block's 64, 16-byte chunks 4 wgi .. 4 wgi + 3 of each row.
        uint32_t hv[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int hc =
              c * kCT + rank * kHC + 32 * wgi + 8 * j + 2 * (lane % 4);
          const float sa = qa.s1[hc], sb = qa.s1[hc + 1];
          const float ba = to_f32(a.b1[hc]), bb = to_f32(a.b1[hc + 1]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                gelu(__fadd_rn(__fmul_rn(h1[4 * j + 2 * hh], sa), ba)),
                gelu(__fadd_rn(__fmul_rn(h1[4 * j + 2 * hh + 1], sb), bb)));
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
        __syncthreads();
        if (threadIdx.x == 0) {
          const uint32_t src = base + C::kXn + hb * 2 * kBox + rank * kBox;
          const uint32_t full = mapa(bar.hfull + 8 * hb, peer);
          arrive_expect_cluster(full, kBox);
          copy_to_cluster(mapa(src, peer), src, kBox, full);
        }
      }
    }

    if (q + 1 < C::NP) {
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
      continue;
    }
    // The last pass: every fc1 of the block is done (each consumer waited
    // for the last chunk's hfull, which the block's 256 writers of h
    // completed after their fc1), so the LN(x) region stages the output.
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
    const int cpr = 8 * real;
    for (int ch = t; ch < 64 * cpr; ch += 128) {
      const int r = ch / cpr, cc = (ch % cpr) * 8;
      if (m0 + r < a.m)
        *reinterpret_cast<uint4*>(a.out + static_cast<size_t>(m0 + r) * D +
                                  col0 + cc) =
            *reinterpret_cast<const uint4*>(cs + r * ldc + cc);
    }
  }
}

template <int T>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    mlp_q_bf16_wgmma(const __grid_constant__ CUtensorMap map_w1,
                     const __grid_constant__ CUtensorMap map_w2, QArgs qa) {
  using C = Cfg<T>;
  extern __shared__ uint8_t mqw_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(mqw_smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t rank = cluster_rank();
  const int m0 = (blockIdx.x / 2) * kBM;
  const Bars<T> bar(base);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::S1; ++s) {
      mbar_init(bar.f1 + 8 * s, 1);  // thread 0's arrive + the bytes
      mbar_init(bar.e1 + 8 * s, 2);  // both warpgroups
    }
    for (int s = 0; s < C::S2; ++s) {
      mbar_init(bar.f2 + 8 * s, 1);
      mbar_init(bar.e2 + 8 * s, 2);
    }
    for (int b = 0; b < 2; ++b) {
      // This block's threads, and the other block's copy.
      mbar_init(bar.hfull + 8 * b, 256 + 1);
      mbar_init(bar.hempty + 8 * b, 4);  // both blocks' warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  mw::ln_rows<T, kThreads>(qa.a, smem, m0);
  // wgmma reads LN(x) through the async proxy; the cluster barrier also
  // makes both blocks' barriers initialised before either arrives on the
  // other's.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  cluster_sync();
  mlp_q_block<T>(&map_w1, &map_w2, qa, base, smem, rank, m0);
  // No block leaves while the other may still write its h buffers or
  // arrive on its barriers.
  cluster_sync();
}

}  // namespace mqw
}  // namespace vit
