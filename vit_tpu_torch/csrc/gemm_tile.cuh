// K2's tile loop as a device routine: one output tile of act(LN(x) @ w) at
// tile coordinates (m0, n0), handed element by element to an epilogue
// functor. K2 and K6 (matmul.cu), K11 (matmul.cu, int8), K8 (embed.cu)
// and the GEMM phases of K9 (encoder_stack.cu, float or int8 weights) are
// its callers; each brings its own epilogue (`void store(int row, int col,
// Acc acc) const`, called only for elements inside (m, n)) and its own
// shared memory.
//
// bf16 runs on the tensor cores through nvcuda::wmma 16x16x16 tiles (fp32
// accumulate): a 64x128 tile, K staged through shared memory 32 deep, eight
// warps of 32x32. int8 runs the same loop on s8 fragments with int32 sums,
// K staged 64 deep; the sums are exact, and the epilogue converts them with
// __int2float_rn. Weights may arrive as int8 for a bf16 or fp32 tile (K9
// on int8 weights): they are converted, exactly, as they are staged. fp32
// multiplies in true fp32 -- the JAX kernels run fp32
// at Precision.HIGHEST (vit_tpu/ops/pallas/matmul.py:37-45), and one TF32
// pass would break the golden bar -- as a register-blocked FFMA loop (64x64
// tile, 4x4 outputs a thread). Neither is pipelined (no cp.async, TMA or
// wgmma): loads and math alternate. K2's fp32 form runs here only where
// TMA cannot read its operands; elsewhere it has its own tile,
// gemm_tf32.cuh's three-pass TF32 split on wgmma, and so have K6's fp32
// form (with its LN prologue) and K8's (with its embedding epilogue), each
// by the same rule. K9's fp32 form and the probes' fp32 GEMMs still run
// here.
//
// Ragged M, N and K are masked: tiles are zero-filled past the edges in
// shared memory. K is not padded in device memory.
//
// With LN (K6's prologue) each element of an x tile is normalised as it is
// staged, ((x - mu) * rstd) * gamma + beta in fp32, rounded to the tensor's
// type. The zero-fill of a ragged K edge comes after the normalisation, not
// before: a zero x would normalise to beta - mu*rstd*gamma, not to zero
// (JAX gets its zeros by zero-padding gamma and beta, matmul.py:363-365).
//
// Every block of 256 threads must call the routine together: it
// synchronises the block. It neither reads nor writes anything but x, w,
// the LN rows and what the epilogue touches, so a persistent kernel may
// call it for one tile after another.

#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace vit {

constexpr int kMmThreads = 256;

// The LN prologue of K6, in fp32: `stats` reads a row's mean and rstd
// (once per staged chunk), `apply` normalises element (row, col) with
// them. mu and rstd are indexed by row - row0: K6 passes whole-matrix
// stats (row0 = 0), K9 the stats of one tile's rows in shared memory
// (row0 = the tile's m0).
template <typename T>
struct LnPrologue {
  const float* mu;
  const float* rstd;
  const T* gamma;  // (K,)
  const T* beta;   // (K,)
  int row0;

  __device__ __forceinline__ float2 stats(int row) const {
    return make_float2(mu[row - row0], rstd[row - row0]);
  }
  __device__ __forceinline__ float apply(float x, float2 st, int col) const {
    return (x - st.x) * st.y * to_f32(gamma[col]) + to_f32(beta[col]);
  }
};

// ------------------------------------------------------- tensor cores --
//
// One loop for both tensor-core types, In = bf16 or int8 (signed char):
// a kBM x kBN output tile, eight warps of 32 x 32, nvcuda::wmma 16x16x16
// fragments. TcTile<In> says how deep K is staged, what the sums are, and
// where an element of the A (kBM x BK) and B (BK x kBN) tiles sits in
// shared memory. wmma wants every fragment's first element 32-byte
// aligned: bf16 rows are padded row-major tiles (a 16-wide step is 32
// bytes); an int8 16-wide step is 16 bytes, so the int8 tiles are stored
// as 16-column slices, each slice kBM (or BK) rows of 16 bytes.

constexpr int kBM = 64, kBN = 128;

template <typename In>
struct TcTile;

template <>
struct TcTile<bf16> {
  using Acc = float;
  static constexpr int BK = 32;
  static constexpr int LDA = BK + 8;   // padded rows: 80 B, 16-byte aligned
  static constexpr int LDB = kBN + 8;  // 272 B
  static constexpr int A_ELEMS = kBM * LDA, B_ELEMS = BK * LDB;
  static __device__ __forceinline__ int a_off(int r, int k) {
    return r * LDA + k;
  }
  static __device__ __forceinline__ int b_off(int k, int c) {
    return k * LDB + c;
  }
};

template <>
struct TcTile<signed char> {
  using Acc = int;
  static constexpr int BK = 64;
  static constexpr int LDA = 16, LDB = 16;  // rows of one 16-column slice
  static constexpr int A_ELEMS = kBM * BK, B_ELEMS = BK * kBN;
  static __device__ __forceinline__ int a_off(int r, int k) {
    return (k / 16) * (kBM * 16) + r * 16 + k % 16;
  }
  static __device__ __forceinline__ int b_off(int k, int c) {
    return (c / 16) * (BK * 16) + k * 16 + c % 16;
  }
};

template <typename In>
struct __align__(128) TcSmem {
  In a[TcTile<In>::A_ELEMS];  // bf16 5120 B, int8 4096 B
  In b[TcTile<In>::B_ELEMS];  // bf16 8704 B, int8 8192 B
  typename TcTile<In>::Acc c[kMmThreads / 32][16 * 16];  // epilogue, 8192 B
};
using GemmSmemBf16 = TcSmem<bf16>;
using GemmSmemI8 = TcSmem<signed char>;

// A value of the source type S in the tile's type D: exact for int8 into
// bf16 or fp32.
template <typename D, typename S>
__device__ __forceinline__ D convert(S v) {
  if constexpr (std::is_same_v<D, S>)
    return v;
  else
    return from_f32<D>(to_f32(v));
}

// Bytes a thread reads for one 16-byte chunk of the tile (16 / sizeof(D)
// elements of S): 16, or 8 for int8 staged into bf16.
template <typename D, typename S>
constexpr int chunk_src_bytes() {
  return 16 / static_cast<int>(sizeof(D)) * static_cast<int>(sizeof(S));
}

// Whether rows of S with leading dimension ld starting at p may be read in
// whole chunks.
template <typename D, typename S>
__host__ __device__ inline bool vec_ok(const void* p, int ld) {
  constexpr int kb = chunk_src_bytes<D, S>();
  return reinterpret_cast<uintptr_t>(p) % kb == 0 &&
         (static_cast<long long>(ld) * sizeof(S)) % kb == 0;
}

// Stage the ROWS x COLS tile at (r0, c0) of a row-major R x C matrix of S
// with leading dimension ld into the A (A_TILE) or B tile of TcSmem<D>,
// zeros outside the matrix. A chunk of 16 bytes of D moves as one load when
// it lies wholly inside and `vec` says the rows allow it. With LN (bf16
// only), every value inside the matrix is normalised by `ln` (rows are rows
// of x, columns are K) before it is stored; values outside stay zeros.
template <int ROWS, int COLS, bool LN, bool A_TILE, typename D, typename S>
__device__ __forceinline__ void load_tile(D* __restrict__ dst, const S* src,
                                          int ld, int r0, int c0, int R,
                                          int C, bool vec,
                                          const LnPrologue<D>& ln) {
  constexpr int CH = 16 / static_cast<int>(sizeof(D));
  constexpr int kChunks = ROWS * COLS / CH;
  for (int ch = threadIdx.x; ch < kChunks; ch += kMmThreads) {
    const int r = ch / (COLS / CH), c = (ch % (COLS / CH)) * CH;
    const int gr = r0 + r, gc = c0 + c;
    D* d = dst + (A_TILE ? TcTile<D>::a_off(r, c) : TcTile<D>::b_off(r, c));
    const S* s = src + static_cast<size_t>(gr) * ld + gc;
    float2 st = make_float2(0.f, 0.f);
    if constexpr (LN) {
      if (gr < R) st = ln.stats(gr);
    }
    if (vec && gr < R && gc + CH <= C) {
      if constexpr (std::is_same_v<D, S>) {
        uint4 u = *reinterpret_cast<const uint4*>(s);
        if constexpr (LN) {
          D* e = reinterpret_cast<D*>(&u);
#pragma unroll
          for (int i = 0; i < CH; ++i)
            e[i] = from_f32<D>(ln.apply(to_f32(e[i]), st, gc + i));
        }
        *reinterpret_cast<uint4*>(d) = u;
      } else {
        static_assert(sizeof(S) == 1 && sizeof(D) == 2, "int8 into bf16");
        const uint2 u = *reinterpret_cast<const uint2*>(s);
        const S* e = reinterpret_cast<const S*>(&u);
        uint4 o;
        D* od = reinterpret_cast<D*>(&o);
#pragma unroll
        for (int i = 0; i < CH; ++i) od[i] = convert<D>(e[i]);
        *reinterpret_cast<uint4*>(d) = o;
      }
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        D v = from_f32<D>(0.f);
        if (gr < R && gc + e < C) {
          v = convert<D>(s[e]);
          if constexpr (LN) v = from_f32<D>(ln.apply(to_f32(v), st, gc + e));
        }
        d[e] = v;
      }
    }
  }
}

// One kBM x kBN tile at (m0, n0) of x (m, k) @ w (k, n) on the tensor
// cores: In = bf16 with w in bf16 or int8 (staged into bf16), fp32 sums; or
// In = int8 with w in int8, int32 sums. The epilogue's store takes the sum
// in TcTile<In>::Acc.
template <bool LN, typename In, typename W, typename Ep>
__device__ __forceinline__ void gemm_tile(const In* x, const W* w, int m,
                                          int n, int k, int m0, int n0,
                                          bool vec_x, bool vec_w,
                                          const LnPrologue<In>& ln,
                                          const Ep& ep, TcSmem<In>& sm) {
  using namespace nvcuda;
  using TT = TcTile<In>;
  using Acc = typename TT::Acc;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 4, wc = warp % 4;  // 2 x 4 warps, 32 x 32 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], Acc(0));

  __syncthreads();  // the previous tile's readers of sm are done
  for (int k0 = 0; k0 < k; k0 += TT::BK) {
    load_tile<kBM, TT::BK, LN, true>(sm.a, x, k, m0, k0, m, k, vec_x, ln);
    load_tile<TT::BK, kBN, false, false>(sm.b, w, n, k0, n0, k, n, vec_w,
                                         ln);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TT::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, In, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, In, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], sm.a + TT::a_off(wr * 32 + i * 16, kk),
                               TT::LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], sm.b + TT::b_off(kk, wc * 32 + j * 16),
                               TT::LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through a per-warp 16x16 tile in shared memory.
  Acc* cs = sm.c[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + wr * 32 + i * 16 + e / 16;
        const int col = n0 + wc * 32 + j * 16 + e % 16;
        if (row < m && col < n) ep.store(row, col, cs[e]);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------- fp32 --

constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

struct __align__(16) GemmSmemF32 {
  float a[kFBK][kFBM + 4];  // transposed: a[kk][row]
  float b[kFBK][kFBN];
};

// One kFBM x kFBN tile at (m0, n0) of x (m, k) @ w (k, n), fp32 FFMA; w in
// fp32 or int8 (converted as it is staged, exactly).
template <bool LN, typename W, typename Ep>
__device__ __forceinline__ void gemm_tile(const float* x, const W* w,
                                          int m, int n, int k, int m0, int n0,
                                          bool /*vec_x*/, bool /*vec_w*/,
                                          const LnPrologue<float>& ln,
                                          const Ep& ep, GemmSmemF32& sm) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};

  __syncthreads();  // the previous tile's readers of sm are done
  for (int k0 = 0; k0 < k; k0 += kFBK) {
    for (int e = threadIdx.x; e < kFBM * kFBK; e += kMmThreads) {
      const int r = e / kFBK, c = e % kFBK;
      const int gr = m0 + r, gc = k0 + c;
      float v = 0.f;
      if (gr < m && gc < k) {
        v = x[static_cast<size_t>(gr) * k + gc];
        if (LN) v = ln.apply(v, ln.stats(gr), gc);
      }
      sm.a[c][r] = v;
    }
    for (int e = threadIdx.x; e < kFBK * kFBN; e += kMmThreads) {
      const int r = e / kFBN, c = e % kFBN;
      const int gr = k0 + r, gc = n0 + c;
      sm.b[r][c] =
          (gr < k && gc < n) ? to_f32(w[static_cast<size_t>(gr) * n + gc])
                             : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.a[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sm.b[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < m && col < n) ep.store(row, col, acc[i][j]);
    }
}

// Tile shape and shared memory of the routine for each type.
template <typename T>
struct Gemm;
template <>
struct Gemm<bf16> {
  static constexpr int BM = kBM, BN = kBN;
  using Smem = GemmSmemBf16;
};
template <>
struct Gemm<signed char> {
  static constexpr int BM = kBM, BN = kBN;
  using Smem = GemmSmemI8;
};
template <>
struct Gemm<float> {
  static constexpr int BM = kFBM, BN = kFBN;
  using Smem = GemmSmemF32;
};

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace vit
