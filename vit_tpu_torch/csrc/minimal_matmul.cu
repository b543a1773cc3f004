// K21: the minimal matmul, the teaching companion of the library's kernels
// (counterpart of examples/minimal_pallas_matmul.py, whose pallas_call is at
// :50). It shows the bare essentials of a kernel of this library and how
// it reaches the tensor cores, with none of K2's machinery (no TMA, no
// wgmma, no epilogue, no ragged edges):
//
// - The C interface. A kernel is launched by a plain `extern "C"` function
//   that takes raw device pointers and sizes, then the dtype code, the
//   device index and the stream, and returns cudaGetLastError() after the
//   launch, so that a refused launch reaches the caller. The Python side
//   (vit_tpu_torch/examples/minimal_matmul.py) declares the argument types
//   for ctypes (_build.py:_SIGNATURES: a pointer is c_void_p, an int c_int),
//   passes tensor.data_ptr() and torch.cuda.current_stream().cuda_stream,
//   and allocates the output itself: the kernel allocates nothing and
//   never synchronises.
// - The grid tiles the output, as the Pallas grid does. Where a BlockSpec
//   maps a grid position to a tile, here the block computes its tile's
//   offsets from blockIdx; where the Pallas K axis streams K tiles through
//   a sequential grid dimension with an fp32 scratch accumulator, here a
//   loop inside the block walks K, because blocks run in parallel in no
//   order and nothing carries over between them.
// - The K walk. Each step's 64 x 32 slice of x and 32 x 64 slice of w go
//   into shared memory by cp.async (16 bytes a copy, no registers on the
//   way), two stages deep: the next step's copies are in flight while this
//   step multiplies (mma_frag.cuh's cp_async16, commit and wait).
// - The tensor cores. A block of four warps owns a 64 x 64 tile, each warp
//   a 32 x 32 quarter: two 16-row by four 8-column mma.sync tiles whose
//   fp32 sums stay in registers and are written once, in x's type.
//   - bf16: mma.sync m16n8k16; A fragments by ldmatrix from x's rows, B
//     fragments by ldmatrix.trans from w's rows (mma_frag.cuh), rows padded
//     by 16 bytes (an odd number of 16-byte units) so that the eight rows
//     of an ldmatrix fall in distinct banks.
//   - fp32: mma.sync m16n8k8 tf32 in the three-pass split of
//     tf32_split.cuh (x = hi + lo, a b = lo_a hi_b + hi_a lo_b + hi_a hi_b
//     into one accumulator, which holds the 1e-4 bar to K = 1536); the
//     fragments are loaded by plain shared-memory reads and split as they
//     are loaded, x's rows padded by 4 floats and w's by 8 so that each
//     fragment load touches 32 banks.
//
// The tile is 64, not the Pallas example's 128 (one MXU tile): at the
// example's (256, 384) @ (384, 512), 32 blocks rather than 8; every
// dimension must be a multiple of 128 all the same, the example's assert,
// and the bases 16-byte aligned for cp.async. Bound on the card: bytes in
// bf16 (0.00022 ms at that shape), the three TF32 passes' products in fp32
// (0.00061 ms at 165 TFLOP/s).

#include "common.cuh"
#include "mma_frag.cuh"
#include "tf32_split.cuh"

namespace vit {

constexpr int kTile = 64;      // a block's output tile
constexpr int kThreads = 128;  // four warps, 2 x 2 over the tile

// One stage: x's 64 x 32 slice and w's 32 x 64, rows padded (16 bytes in
// bf16; 4 and 8 floats in fp32).
template <typename T>
struct MinimalStage {
  static constexpr int kStep = 32;  // K a step
  static constexpr int kLdx = kStep + 16 / sizeof(T);
  static constexpr int kLdw = kTile + 8;
  T x[kTile][kLdx];
  T w[kStep][kLdw];
};

// One step's copies into stage s: rows of x and w in 16-byte pieces, the
// block's threads in turn.
template <typename T>
__device__ __forceinline__ void load_step(MinimalStage<T>& s, const T* x,
                                          const T* w, int n, int k, int row0,
                                          int col0, int k0) {
  constexpr int kPer = 16 / sizeof(T);  // elements a copy
  constexpr int kStep = MinimalStage<T>::kStep;
  for (int c = threadIdx.x; c < kTile * kStep / kPer; c += kThreads) {
    const int r = c / (kStep / kPer), e = c % (kStep / kPer) * kPer;
    cp_async16(&s.x[r][e], x + static_cast<size_t>(row0 + r) * k + k0 + e);
  }
  for (int c = threadIdx.x; c < kStep * kTile / kPer; c += kThreads) {
    const int r = c / (kTile / kPer), e = c % (kTile / kPer) * kPer;
    cp_async16(&s.w[r][e], w + static_cast<size_t>(k0 + r) * n + col0 + e);
  }
}

// acc[i][j] += the warp's 16-row tile i times its 8-column tile j over one
// step held in stage s; (wr, wc) is the warp's quarter of the tile.
__device__ __forceinline__ void mma_step(float (&acc)[2][4][4],
                                         const MinimalStage<bf16>& s, int wr,
                                         int wc, int lane) {
  using St = MinimalStage<bf16>;
#pragma unroll
  for (int kk = 0; kk < St::kStep; kk += 16) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldmatrix_a(a[i], &s.x[0][0], St::kLdx, 32 * wr + 16 * i, kk, lane);
#pragma unroll
    for (int j = 0; j < 2; ++j)  // two pairs of 8-column tiles
      ldmatrix_b_rowmajor(b[j], &s.w[0][0], St::kLdw, kk, 32 * wc + 16 * j,
                          lane);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_bf16(acc[i][j], a[i], b[j / 2][2 * (j % 2)],
                 b[j / 2][2 * (j % 2) + 1]);
  }
}

__device__ __forceinline__ void mma_step(float (&acc)[2][4][4],
                                         const MinimalStage<float>& s, int wr,
                                         int wc, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < MinimalStage<float>::kStep; kk += 8) {
    // A(r, c) for rows g, g + 8 and columns t, t + 4 of each 16 x 8 slice;
    // B(c, n) for rows t, t + 4 and column g of each 8 x 8 slice.
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 32 * wr + 16 * i + g + 8 * (e & 1);
        split_tf32(s.x[r][kk + t + 4 * (e >> 1)], ah[i][e], al[i][e]);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        split_tf32(s.w[kk + t + 4 * e][32 * wc + 8 * j + g], bh[j][e],
                   bl[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_tf32x3(acc[i][j], ah[i], al[i], bh[j][0], bh[j][1], bl[j][0],
                   bl[j][1]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    minimal_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                          T* __restrict__ out, int n, int k) {
  __shared__ __align__(16) MinimalStage<T> stage[2];
  constexpr int kStep = MinimalStage<T>::kStep;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = warp % 2;
  float acc[2][4][4] = {};
  const int steps = k / kStep;
  load_step(stage[0], x, w, n, k, row0, col0, 0);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps)  // the next step's copies, while this one multiplies
      load_step(stage[(i + 1) % 2], x, w, n, k, row0, col0, (i + 1) * kStep);
    cp_async_commit();
    cp_async_wait<1>();  // this step's copies have landed
    __syncthreads();
    mma_step(acc, stage[i % 2], wr, wc, lane);
    __syncthreads();  // before the next copies overwrite this stage
  }
  // The accumulators: C(g, 2t..2t+1) and C(g + 8, 2t..2t+1) of each tile.
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 32 * wr + 16 * i + g + 8 * h;
        const int c = col0 + 32 * wc + 8 * j + 2 * t;
        T* o = out + static_cast<size_t>(r) * n + c;
        o[0] = from_f32<T>(acc[i][j][2 * h]);
        o[1] = from_f32<T>(acc[i][j][2 * h + 1]);
      }
}

template <typename T>
cudaError_t launch_minimal(const T* x, const T* w, T* out, int m, int n,
                           int k, cudaStream_t st) {
  const dim3 grid(n / kTile, m / kTile);
  minimal_matmul_kernel<T><<<grid, kThreads, 0, st>>>(x, w, out, n, k);
  return cudaGetLastError();
}

}  // namespace vit

extern "C" int vit_minimal_matmul(const void* x, const void* w, void* out,
                                  int m, int n, int k, int dtype, int device,
                                  void* stream) {
  using namespace vit;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || n <= 0 || k <= 0 || m % 128 || n % 128 || k % 128 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_minimal(static_cast<const float*>(x),
                          static_cast<const float*>(w),
                          static_cast<float*>(out), m, n, k, st);
  if (dtype == kBF16)
    return launch_minimal(static_cast<const bf16*>(x),
                          static_cast<const bf16*>(w),
                          static_cast<bf16*>(out), m, n, k, st);
  return cudaErrorInvalidValue;
}
