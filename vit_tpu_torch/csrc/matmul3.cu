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
// fp32: each block runs gemm_tile.cuh's FFMA tile routine (true fp32, no
// TF32; the JAX kernel runs fp32 at Precision.HIGHEST) on one 64 x 64
// output tile of batch blockIdx.z, with an epilogue of acc * scale and one
// cast. The routine masks ragged M, N and K, so nothing is padded in device
// memory.
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
// 1.9 us at 989 TFLOP/s). The trap is alignment at 197 tokens: a row of
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

namespace vit {

template <typename T>
struct ScaleEpilogue {
  T* out;  // this batch's (M, N)
  int n;
  float scale;

  __device__ __forceinline__ void store(int row, int col, float acc) const {
    out[static_cast<size_t>(row) * n + col] = from_f32<T>(__fmul_rn(acc, scale));
  }
};

template <typename T>
__global__ void __launch_bounds__(kMmThreads)
    matmul3_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   T* __restrict__ out, int m, int n, int k, float scale) {
  __shared__ typename Gemm<T>::Smem sm;
  const size_t z = blockIdx.z;
  const T* xz = x + z * m * k;
  const T* yz = y + z * k * n;
  const ScaleEpilogue<T> ep{out + z * m * n, n, scale};
  gemm_tile<false>(xz, yz, m, n, k, blockIdx.y * Gemm<T>::BM,
                   blockIdx.x * Gemm<T>::BN, vec_ok<T, T>(xz, k),
                   vec_ok<T, T>(yz, n), LnPrologue<T>{}, ep, sm);
}

template <typename T>
cudaError_t launch_matmul3(const void* x, const void* y, void* out, int b,
                           int m, int n, int k, float scale,
                           cudaStream_t st) {
  const dim3 grid((n + Gemm<T>::BN - 1) / Gemm<T>::BN,
                  (m + Gemm<T>::BM - 1) / Gemm<T>::BM, b);
  matmul3_kernel<T><<<grid, kMmThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      m, n, k, scale);
  return cudaGetLastError();
}


// ----------------------------------------------------- bf16, mma.sync --

constexpr int kM3Threads = 128;     // four warps, 32 x 32 outputs each
constexpr int kM3Tile = 64;         // rows, columns and K step of a tile
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
    return launch_matmul3<float>(x, y, out, b, m, n, k, scale, st);
  if (dtype == kBF16)
    return launch_matmul3_bf16(x, y, out, b, m, n, k, scale, st);
  return cudaErrorInvalidValue;
}
