// K16 matmul3: out[b] = (x[b] @ y[b]) * scale for x (B, M, K) and y (B, K,
// N), row-major, summed in fp32 and cast once to the tensor's type.
//
// Replaces vit_tpu/ops/pallas/matmul3.py:matmul3, both of its pallas_calls:
// the group kernel (_matmul3_group_kernel, matmul3.py:52, launched at :105),
// which takes several whole per-batch products a grid step, and the general
// tiled kernel (_matmul3_kernel, :32, launched at :130). The two compute the
// same function; the split is the TPU's per-grid-step cost, which a Hopper
// grid does not have, so one kernel serves both. It carries the unfused
// attention's scores (q @ k^T * d^-0.5) and context (p @ v) and, in the
// backward, both products of its VJP (vit_tpu/ops/pallas/vjp.py:215-220).
// The operands are row-major, so the model copies k^T contiguous before the
// call, as XLA materialises it before the opaque pallas_call.
//
// fp32: the tensor cores in the three-pass TF32 split of tf32_split.cuh
// (the JAX kernel runs fp32 at Precision.HIGHEST; one TF32 pass would miss
// the 1e-4 bar), on mma.sync m16n8k8 tf32, a warp for each 32 x 32 of the
// block's tile: 128 x 128 (128 x 64 where N <= 64) where the grid keeps
// two blocks for each SM, else 64 x 64. K walks in steps of 16 through two
// shared-memory buffers; a thread loads its four-float runs of the next
// step into registers while this step's products run (one 16-byte load
// where the operand's base and rows are 16-byte aligned, else four float
// loads: at 197 tokens the rows of k^T and of the probs are 788 bytes,
// 4 r mod 16 off alignment, and a warp's float loads still cover whole
// sectors), then splits each element once into tf32 hi and lo as it
// stores it, so no warp splits what it reads. A's fragments come by
// ldmatrix of 32-bit words from x's rows (20 floats: conflict-free), B's
// as floats from y's rows (TN + 8). Each 16 x 8 output takes lo_a hi_b,
// hi_a lo_b, hi_a hi_b per k8 slice into one accumulator up to K = 208
// (the depth one accumulator held to within 6.5e-5 on the card, PERF.md
// section 6); past it K is summed in runs of 64, each added to the total
// on the FFMA units in K order (one accumulator over K = 2304 missed the
// bar).
// The epilogue is __fmul_rn(acc, scale) into a staged output tile and
// rows out, 32 consecutive columns a warp instruction. Each output sums K
// in one fixed order: two calls agree bit for bit. On an NVIDIA H100 80GB
// HBM3 at 700 W (tools/turns.py, device ms) the scores take 0.095-0.101
// (0.181 on the FFMA tile before; baddbmm 0.101), the context 0.068
// (0.152; 0.071), the scores at 200 tokens 0.089 (0.177; 0.101): about 3
// times the bytes' bound. A K = 2304 product of four batches (64 blocks)
// takes 0.107 against baddbmm's 0.054.
//
// bf16: a tile of its own on mma.sync (mma_frag.cuh). A block of four
// warps owns a 64 x 64 output tile (each warp 32 x 32: two A fragments,
// four 8-column B tiles, 32 fp32 sums a lane), so the context's N = 64
// fills it. K walks in steps of 64 through two shared-memory buffers, the
// next step's copy in flight while this one's products run, k16 slices in
// order: each output sums K in one fixed order (no split-K, no atomics),
// so two calls agree bit for bit. Rows, columns and K past the edges are
// zeros in shared memory. The epilogue is __fmul_rn(acc, scale) and one
// cast; scale == 1 (no scale) is exact.
//
// Bound on the card: bytes at the unfused B/16 bs=32 shapes (scores: 9.7 +
// 9.7 MB in, 29.8 MB out in bf16, 14.7 us at 3.35 TB/s, against 1.9 GFLOP,
// 1.9 us at 989 TFLOP/s; fp32 twice the bytes, 29.4 us, against 11.6 us
// for the three TF32 passes). The trap is alignment at 197 tokens: a row of
// 197 bf16 is 394 bytes, so odd rows of the probs (the context's x), of
// k^T (the scores' y) and of the scores themselves are only 2-byte
// aligned, and each (197, 197) batch starts 2 mod 16 bytes after the one
// before. An operand whose rows are 16-byte aligned is staged with
// cp.async; any other is read as the aligned 16-byte words that cover each
// 32-element run of a row, held in registers across the step's products,
// and realigned with funnel shifts as it is stored to shared memory. The
// output tile goes through shared memory, and each row leaves as the
// aligned 16-byte words it covers (element stores only in the words at a
// row's two ends). Those rows cost the scores a third of their time
// (chip_smoke.py times them at 197 columns and at 200, where every row is
// aligned; PERF.md). A block that spanned all 197 columns, so that its
// output rows were one contiguous range with element stores only at its
// two ends, gained little at 197 and lost at 200: a quarter of the
// blocks, each walking four tiles.

#include "gemm_tile.cuh"
#include "mma_frag.cuh"
#include "tf32_split.cuh"

namespace vit {

// ------------------------------------------------ fp32, mma.sync tf32 --

constexpr int kM3Threads = 128;     // bf16: four warps, 32 x 32 outputs each
constexpr int kM3Tile = 64;         // bf16: rows, columns and K step a tile
constexpr int kM3FK = 16;           // fp32: K a step
constexpr int kM3FRun = 64;         // fp32 past kM3FOne: K an accumulator
constexpr int kM3FOne = 208;        // fp32: K one accumulator holds
constexpr int kM3FLdx = kM3FK + 4;  // x rows: 80 B, ldmatrix without conflict

// The fp32 tile of TM rows x TN columns (64 or 128 each), a warp for
// each 32 x 32 of it. Dynamic shared memory: two buffers of x's (TM rows x
// 16 K) and y's (16 K x TN columns) tiles, each split into hi and lo when
// it is staged (38,912 B at 64 x 64, 75,776 at 128 x 128); the output
// tile (TM x (TN + 8) fp32) reuses all of it.
template <int TM, int TN>
struct M3F {
  static constexpr int kWarps = TM / 32 * (TN / 32);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kLdy = TN + 8;  // B fragments without conflict
  static constexpr int kLdo = TN + 8;  // the output tile's rows
  static constexpr int kX = TM * kM3FLdx, kY = kM3FK * kLdy;  // floats
  static constexpr int kSmem = 4 * (4 * kX + 4 * kY);
  static_assert(TM * kLdo <= 4 * kX + 4 * kY, "the output tile fits");
  // Staged four-float runs a thread a step: x's and y's.
  static constexpr int kRx = 4 * TM / kThreads, kRy = 4 * TN / kThreads;

  float* xh;  // [2][kX], then xl, yh, yl
  __device__ __forceinline__ float* x_hi(int b) const { return xh + b * kX; }
  __device__ __forceinline__ float* x_lo(int b) const {
    return xh + (2 + b) * kX;
  }
  __device__ __forceinline__ float* y_hi(int b) const {
    return xh + 4 * kX + b * kY;
  }
  __device__ __forceinline__ float* y_lo(int b) const {
    return xh + 4 * kX + (2 + b) * kY;
  }
};

// Four floats of row r, columns c .. c + 3 of the rows x cols matrix at
// src (row stride ld): one 16-byte load where vec (the matrix's base and
// rows 16-byte aligned), else four float loads; zeros past the edges.
__device__ __forceinline__ float4 m3f_run(const float* src, size_t ld, int r,
                                          int c, int rows, int cols,
                                          bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= rows) return v;
  const float* p = src + r * ld + c;
  if (c + 4 <= cols) {
    if (vec) return __ldg(reinterpret_cast<const float4*>(p));
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  if (c < cols) v.x = __ldg(p);
  if (c + 1 < cols) v.y = __ldg(p + 1);
  if (c + 2 < cols) v.z = __ldg(p + 2);
  return v;
}

// hi and lo of four floats, 16 bytes each at hi[i], lo[i].
__device__ __forceinline__ void m3f_split_store(float* hi, float* lo,
                                                float4 v) {
  uint4 h, l;
  split_tf32(v.x, h.x, l.x);
  split_tf32(v.y, h.y, l.y);
  split_tf32(v.z, h.z, l.z);
  split_tf32(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// A thread's share of one K step's operands, held in registers from the
// loads to the split: x runs u (row u / 4, K 4 (u % 4) ..) and y runs u (K
// row u / (TN / 4), columns 4 (u % (TN / 4)) ..), u = tid + kThreads i.
template <int TM, int TN>
struct M3FStage {
  using C = M3F<TM, TN>;
  float4 x[C::kRx], y[C::kRy];

  __device__ __forceinline__ void load(const float* xz, const float* yz,
                                       int m, int n, int k, int m0, int n0,
                                       int k0, bool vec_x, bool vec_y) {
#pragma unroll
    for (int i = 0; i < C::kRx; ++i) {
      const int u = threadIdx.x + C::kThreads * i;
      x[i] = m3f_run(xz, k, m0 + (u >> 2), k0 + 4 * (u & 3), m, k, vec_x);
    }
#pragma unroll
    for (int i = 0; i < C::kRy; ++i) {
      const int u = threadIdx.x + C::kThreads * i;
      y[i] = m3f_run(yz, n, k0 + u / (TN / 4), n0 + 4 * (u % (TN / 4)), k,
                     n, vec_y);
    }
  }

  __device__ __forceinline__ void store(const C& sm, int b) const {
#pragma unroll
    for (int i = 0; i < C::kRx; ++i) {
      const int u = threadIdx.x + C::kThreads * i;
      const int xi = (u >> 2) * kM3FLdx + 4 * (u & 3);
      m3f_split_store(sm.x_hi(b) + xi, sm.x_lo(b) + xi, x[i]);
    }
#pragma unroll
    for (int i = 0; i < C::kRy; ++i) {
      const int u = threadIdx.x + C::kThreads * i;
      const int yi = u / (TN / 4) * C::kLdy + 4 * (u % (TN / 4));
      m3f_split_store(sm.y_hi(b) + yi, sm.y_lo(b) + yi, y[i]);
    }
  }
};

// RUNS: K > kM3FOne, summed in runs of kM3FRun added on the FFMA units;
// else one accumulator, and no registers for a second set of sums.
template <int TM, int TN, bool RUNS>
__global__ void __launch_bounds__(M3F<TM, TN>::kThreads)
    matmul3_tf32_kernel(const float* __restrict__ x,
                        const float* __restrict__ y, float* __restrict__ out,
                        int m, int n, int k, float scale, bool vec_x,
                        bool vec_y) {
  using C = M3F<TM, TN>;
  extern __shared__ __align__(16) float m3f_smem[];
  const C sm{m3f_smem};
  const size_t z = blockIdx.z;
  const float* xz = x + z * m * k;
  const float* yz = y + z * k * n;
  float* oz = out + z * m * n;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // The warp's 32 x 32.
  const int wr = 32 * (warp / (TN / 32)), wc = 32 * (warp % (TN / 32));

  // part: the products' sums (the current run's with RUNS); tot: the
  // runs' total (untouched, so given no registers, without RUNS).
  float part[2][4][4], tot[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = tot[i][j][e] = 0.f;

  M3FStage<TM, TN> st;
  const int steps = (k + kM3FK - 1) / kM3FK;
  st.load(xz, yz, m, n, k, m0, n0, 0, vec_x, vec_y);
  st.store(sm, 0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int b = s & 1;
    const bool more = s + 1 < steps;
    if (more)
      st.load(xz, yz, m, n, k, m0, n0, (s + 1) * kM3FK, vec_x, vec_y);
#pragma unroll
    for (int kk = 0; kk < kM3FK; kk += 8) {
      // A: ldmatrix of 32-bit words gives the m16n8k8 tf32 fragment (rows
      // g, g + 8; columns t, t + 4) of each 16-row tile, hi and lo.
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int at = (wr + 16 * i + (lane & 15)) * kM3FLdx + kk +
                       4 * (lane >> 4);
        ldmatrix_x4(ah[i], sm.x_hi(b) + at);
        ldmatrix_x4(al[i], sm.x_lo(b) + at);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bt = (kk + t) * C::kLdy + wc + 8 * j + g;
        const float* yh = sm.y_hi(b);
        const float* yl = sm.y_lo(b);
        const uint32_t bh0 = __float_as_uint(yh[bt]);
        const uint32_t bh1 = __float_as_uint(yh[bt + 4 * C::kLdy]);
        const uint32_t bl0 = __float_as_uint(yl[bt]);
        const uint32_t bl1 = __float_as_uint(yl[bt + 4 * C::kLdy]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_tf32x3(part[i][j], ah[i], al[i], bh0, bh1, bl0, bl1);
      }
    }
    // A run's sums join the total on the FFMA units, runs in K order.
    if constexpr (RUNS) {
      if (!more || (s + 1) % (kM3FRun / kM3FK) == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[i][j][e] += part[i][j][e];
              part[i][j][e] = 0.f;
            }
      }
    }
    if (more) st.store(sm, b ^ 1);
    __syncthreads();
  }

  // The sums * scale into the output tile in shared memory (every read of
  // the operand buffers is behind the loop's last barrier), then rows
  // out, a warp's 32 lanes on 32 consecutive columns.
  float* os = m3f_smem;
  auto sums = [&](int i, int j, int e) {
    return RUNS ? tot[i][j][e] : part[i][j][e];
  };
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wr + 16 * i + g + 8 * r;
        *reinterpret_cast<float2*>(os + row * C::kLdo + wc + 8 * j + 2 * t) =
            make_float2(__fmul_rn(sums(i, j, 2 * r), scale),
                        __fmul_rn(sums(i, j, 2 * r + 1), scale));
      }
  __syncthreads();
  for (int r = warp; r < TM && m0 + r < m; r += C::kWarps)
#pragma unroll
    for (int h = 0; h < TN / 32; ++h) {
      const int c = 32 * h + lane;
      if (n0 + c < n)
        oz[static_cast<size_t>(m0 + r) * n + n0 + c] = os[r * C::kLdo + c];
    }
}

constexpr int kM3FMaxDevices = 64;

template <int TM, int TN, bool RUNS>
cudaError_t launch_m3f_kernel(const float* x, const float* y, float* out,
                              int b, int m, int n, int k, float scale,
                              bool vec_x, bool vec_y, int device,
                              cudaStream_t st) {
  using C = M3F<TM, TN>;
  auto kernel = matmul3_tf32_kernel<TM, TN, RUNS>;
  // Per device, once: the shared-memory limit.
  static bool ready[kM3FMaxDevices];
  if (device < 0 || device >= kM3FMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM, b);
  kernel<<<grid, C::kThreads, C::kSmem, st>>>(x, y, out, m, n, k, scale,
                                              vec_x, vec_y);
  return cudaGetLastError();
}

template <int TM, int TN>
cudaError_t launch_m3f(const float* x, const float* y, float* out, int b,
                       int m, int n, int k, float scale, bool vec_x,
                       bool vec_y, int device, cudaStream_t st) {
  return k > kM3FOne
             ? launch_m3f_kernel<TM, TN, true>(x, y, out, b, m, n, k, scale,
                                               vec_x, vec_y, device, st)
             : launch_m3f_kernel<TM, TN, false>(x, y, out, b, m, n, k, scale,
                                                vec_x, vec_y, device, st);
}

// The tile: 128 rows or columns where the product has more than 64 (each
// x and y element is then read by half as many blocks; ViT's 197 rows pad
// to 256 either way) where the grid then still has two blocks for each
// SM of the card (kM3FWideBlocks); else 64 x 64, whose 128-thread blocks
// share an SM five at a time (a K = 2304 product of four batches, 16
// blocks of 128 x 128 on 132 SMs, ran much slower than on 64 of 64 x 64).
constexpr int kM3FWideBlocks = 264;

cudaError_t launch_matmul3_tf32(const void* x, const void* y, void* out,
                                int b, int m, int n, int k, float scale,
                                int device, cudaStream_t st) {
  const bool vec_x = aligned16(x) && k % 4 == 0;
  const bool vec_y = aligned16(y) && n % 4 == 0;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* of = static_cast<float*>(out);
  const int tm = m > 64 ? 128 : 64, tn = n > 64 ? 128 : 64;
  const long long wide = static_cast<long long>((m + tm - 1) / tm) *
                         ((n + tn - 1) / tn) * b;
  if (wide < kM3FWideBlocks)
    return launch_m3f<64, 64>(xf, yf, of, b, m, n, k, scale, vec_x, vec_y,
                              device, st);
  if (m > 64)
    return n > 64 ? launch_m3f<128, 128>(xf, yf, of, b, m, n, k, scale,
                                         vec_x, vec_y, device, st)
                  : launch_m3f<128, 64>(xf, yf, of, b, m, n, k, scale, vec_x,
                                        vec_y, device, st);
  return n > 64 ? launch_m3f<64, 128>(xf, yf, of, b, m, n, k, scale, vec_x,
                                      vec_y, device, st)
                : launch_m3f<64, 64>(xf, yf, of, b, m, n, k, scale, vec_x,
                                     vec_y, device, st);
}

// ----------------------------------------------------- bf16, mma.sync --

constexpr int kM3Ld = kM3Tile + 8;  // padded rows: conflict-free ldmatrix
constexpr int kM3Elems = kM3Tile * kM3Ld;

// Two buffers of the x (64 rows x 64 K) and y (64 K x 64 columns) tiles,
// 36,864 B; the output tile reuses the first x buffer.
struct __align__(128) M3Smem {
  bf16 x[2][kM3Elems];
  bf16 y[2][kM3Elems];
};

// One thread's share of a 64 x 64 tile staged from rows that may be only
// 2-byte aligned: tile row tid / 2, columns 32 (tid % 2) .. + 31 (a run of
// 64 bytes). `load` reads the aligned 16-byte words that cover the run
// (five, or four where the run is aligned) into registers; `store`
// realigns them and writes the run to shared memory. A run that crosses
// the matrix's edge is read element by element in `store`, zeros past it.
struct RunStage {
  uint4 w[5];
  int shift;  // the run's byte offset in its first word: 0, 2, .., 14
  bool full;

  __device__ __forceinline__ void load(const bf16* src, size_t ld, int r0,
                                       int c0, int rows, int cols) {
    const int r = r0 + threadIdx.x / 2, c = c0 + 32 * (threadIdx.x % 2);
    full = r < rows && c + 32 <= cols;
    if (!full) return;
    const uintptr_t at = reinterpret_cast<uintptr_t>(src + r * ld + c);
    shift = static_cast<int>(at & 15);
    const uint4* p = reinterpret_cast<const uint4*>(at - shift);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __ldg(p + i);
    // An aligned run reads nothing past its end.
    w[4] = shift ? __ldg(p + 4) : make_uint4(0, 0, 0, 0);
  }

  __device__ __forceinline__ void store(bf16* dst, const bf16* src, size_t ld,
                                        int r0, int c0, int rows,
                                        int cols) const {
    const int tr = threadIdx.x / 2, tc = 32 * (threadIdx.x % 2);
    if (full) {
      uint32_t in[20];
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        in[4 * i] = w[i].x;
        in[4 * i + 1] = w[i].y;
        in[4 * i + 2] = w[i].z;
        in[4 * i + 3] = w[i].w;
      }
      // Whole 4-byte words by selects (the array stays in registers),
      // then half a word by a funnel shift.
      const int sw = shift >> 2, sh = (shift & 3) * 8;
      uint32_t u[17];
#pragma unroll
      for (int j = 0; j < 17; ++j)
        u[j] = sw == 0 ? in[j]
             : sw == 1 ? in[j + 1]
             : sw == 2 ? in[j + 2] : in[j + 3];
      uint4* d = reinterpret_cast<uint4*>(dst + tr * kM3Ld + tc);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        d[q] = make_uint4(__funnelshift_r(u[4 * q], u[4 * q + 1], sh),
                          __funnelshift_r(u[4 * q + 1], u[4 * q + 2], sh),
                          __funnelshift_r(u[4 * q + 2], u[4 * q + 3], sh),
                          __funnelshift_r(u[4 * q + 3], u[4 * q + 4], sh));
      return;
    }
    const int r = r0 + tr, c = c0 + tc;
    bf16* e = dst + tr * kM3Ld + tc;
#pragma unroll 4
    for (int i = 0; i < 32; ++i)
      e[i] = r < rows && c + i < cols ? src[r * ld + c + i]
                                      : __float2bfloat16_rn(0.f);
  }
};

// Tile (r0, c0) of the rows x cols matrix at src (row stride ld) into dst:
// by cp.async where vec (16-byte aligned rows; then cols % 8 == 0), else
// loaded into `st` now, to be stored after this step's products.
__device__ __forceinline__ void m3_fetch(bf16* dst, RunStage& st,
                                         const bf16* src, size_t ld, int r0,
                                         int c0, int rows, int cols,
                                         bool vec) {
  if (vec)
    stage_rows(dst, kM3Ld, src + r0 * ld + c0, ld, kM3Tile, rows - r0,
               min(kM3Tile, cols - c0), kM3Tile, true);
  else
    st.load(src, ld, r0, c0, rows, cols);
}

__global__ void __launch_bounds__(kM3Threads)
    matmul3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
                        bf16* __restrict__ out, int m, int n, int k,
                        float scale, bool vec_x, bool vec_y) {
  __shared__ M3Smem sm;
  const size_t z = blockIdx.z;
  const bf16* xz = x + z * m * k;
  const bf16* yz = y + z * k * n;
  bf16* oz = out + z * m * n;
  const int m0 = blockIdx.y * kM3Tile, n0 = blockIdx.x * kM3Tile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const int wr = 32 * (warp / 2), wc = 32 * (warp % 2);  // the warp's 32 x 32

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  RunStage sx, sy;
  const int steps = (k + kM3Tile - 1) / kM3Tile;
  m3_fetch(sm.x[0], sx, xz, k, m0, 0, m, k, vec_x);
  m3_fetch(sm.y[0], sy, yz, n, 0, n0, k, n, vec_y);
  cp_async_commit();
  if (!vec_x) sx.store(sm.x[0], xz, k, m0, 0, m, k);
  if (!vec_y) sy.store(sm.y[0], yz, n, 0, n0, k, n);
  cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int b = s & 1, k1 = (s + 1) * kM3Tile;
    const bool more = s + 1 < steps;
    if (more) {
      m3_fetch(sm.x[b ^ 1], sx, xz, k, m0, k1, m, k, vec_x);
      m3_fetch(sm.y[b ^ 1], sy, yz, n, k1, n0, k, n, vec_y);
    }
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kM3Tile; kk += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_a(af[i], sm.x[b], kM3Ld, wr + 16 * i, kk, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_b_rowmajor(bf[j], sm.y[b], kM3Ld, kk, wc + 16 * j, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_bf16(acc[i][2 * j], af[i], bf[j][0], bf[j][1]);
          mma_bf16(acc[i][2 * j + 1], af[i], bf[j][2], bf[j][3]);
        }
    }
    if (more) {
      if (!vec_x) sx.store(sm.x[b ^ 1], xz, k, m0, k1, m, k);
      if (!vec_y) sy.store(sm.y[b ^ 1], yz, n, k1, n0, k, n);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // acc * scale, one cast, into the output tile in shared memory (the
  // first x buffer: every read of it is behind the loop's last barrier).
  bf16* os = sm.x[0];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wr + 16 * i + lane / 4 + 8 * r;
        *reinterpret_cast<__nv_bfloat162*>(os + row * kM3Ld + wc + 8 * j +
                                           2 * t) =
            __floats2bfloat162_rn(__fmul_rn(acc[i][j][2 * r], scale),
                                  __fmul_rn(acc[i][j][2 * r + 1], scale));
      }
  __syncthreads();

  // Each row's segment leaves as the aligned 16-byte words that cover it,
  // two threads a row taking every other word; a word that holds elements
  // outside the segment (the first or the last) is written element by
  // element.
  const int tr = threadIdx.x / 2, row = m0 + tr;
  if (row >= m) return;
  const int len = min(kM3Tile, n - n0);
  bf16* seg = oz + static_cast<size_t>(row) * n + n0;
  const bf16* src = os + tr * kM3Ld;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(seg);
  const uintptr_t hi = lo + 2 * static_cast<uintptr_t>(len);
  for (uintptr_t w = (lo & ~uintptr_t{15}) + 16 * (threadIdx.x % 2); w < hi;
       w += 32) {
    const int c = static_cast<int>(static_cast<intptr_t>(w - lo) / 2);
    if (w >= lo && w + 16 <= hi) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 p2 =
            __halves2bfloat162(src[c + 2 * q], src[c + 2 * q + 1]);
        v[q] = *reinterpret_cast<const uint32_t*>(&p2);
      }
      *reinterpret_cast<uint4*>(w) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c + i >= 0 && c + i < len) seg[c + i] = src[c + i];
    }
  }
}

cudaError_t launch_matmul3_bf16(const void* x, const void* y, void* out,
                                int b, int m, int n, int k, float scale,
                                cudaStream_t st) {
  const dim3 grid((n + kM3Tile - 1) / kM3Tile, (m + kM3Tile - 1) / kM3Tile,
                  b);
  const bool vec_x = aligned16(x) && k % 8 == 0;
  const bool vec_y = aligned16(y) && n % 8 == 0;
  matmul3_bf16_kernel<<<grid, kM3Threads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y),
      static_cast<bf16*>(out), m, n, k, scale, vec_x, vec_y);
  return cudaGetLastError();
}

}  // namespace vit

// x (b, m, k), y (b, k, n) and out (b, m, n) in the dtype, row-major; scale
// 1 where the caller gives none.
extern "C" int vit_matmul3(const void* x, const void* y, void* out, int b,
                           int m, int n, int k, float scale, int dtype,
                           int device, void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (b <= 0 || b > 65535 || m <= 0 || n <= 0 || k <= 0)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_matmul3_tf32(x, y, out, b, m, n, k, scale, device, st);
  if (dtype == kBF16)
    return launch_matmul3_bf16(x, y, out, b, m, n, k, scale, st);
  return cudaErrorInvalidValue;
}
