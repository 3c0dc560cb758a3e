// Tensor-core GEMM tile of the AMP stage convolutions (K2). The denoiser's
// kernels (K1, K5, K6, K8) run on the pipelined wgmma tiles of gemm_wg.cuh
// and gemm_wg_s8.cuh instead.
//
// One block of 4 warps computes a 64 x 64 output tile with bf16 WMMA
// fragments (16x16x16, f32 accumulation) over K in chunks of 32. The A
// operand is gathered on the fly as an implicit-GEMM "tap" matrix: row
// r = b*T + t, column kk = m*cin + c reads source row t + m*dil - pad of the
// same batch element (zero outside [0, T)): a dilated conv1d with `taps`
// taps. The [T, taps*cin] im2col matrix is never written to memory. The B
// operand is a row-major [K, ldw] bf16 weight. The result tile lands in
// shared memory (Cs) for the caller's epilogue.
//
// What bounds it: latency and issue. Each K chunk is loaded, synchronised,
// then multiplied, with nothing overlapped: no double buffering, no wgmma,
// no TMA (a wide K2 stage reaches a few percent of the bf16 peak).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace svc {

constexpr int GM_BM = 64;
constexpr int GM_BN = 64;
constexpr int GM_BK = 32;
constexpr int GM_LDA = GM_BK + 8;  // bf16 elements; rows stay 16-byte aligned
constexpr int GM_LDB = GM_BN + 8;
constexpr int GM_LDC = GM_BN + 4;  // f32 elements
constexpr int GM_THREADS = 128;

struct TapA {
  const bf16* src;  // [B*T, ld]
  int ld;           // source row stride, elements (multiple of 8)
  int M;            // rows = B*T
  int T;            // rows per batch element
  int K;            // taps * cin
  int cin;          // channels per tap (multiple of 8)
  int dil;          // tap spacing in rows
  int pad;          // left offset of tap 0
};

struct ColsB {
  const bf16* w;  // [K, ldw] row-major
  int ldw;        // multiple of 8
  int N;          // valid columns, multiple of 8
};

__device__ __forceinline__ void load_a_tile(const TapA& a, int m0, int k0, bf16 (*As)[GM_LDA]) {
  // 64 rows x 32 columns = 256 vectors of 8 consecutive K elements; a vector
  // never straddles two taps because cin and k0 are multiples of 8.
  for (int v = threadIdx.x; v < GM_BM * GM_BK / 8; v += GM_THREADS) {
    const int row = v >> 2;
    const int kv = (v & 3) << 3;
    const int r = m0 + row;
    const int kk = k0 + kv;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r < a.M && kk < a.K) {
      const int m = kk / a.cin;
      const int c = kk - m * a.cin;
      const int b = r / a.T;
      const int t = r - b * a.T;
      const int ts = t + m * a.dil - a.pad;
      if (ts >= 0 && ts < a.T) {
        packed = *reinterpret_cast<const uint4*>(a.src + (size_t)(b * a.T + ts) * a.ld + c);
      }
    }
    *reinterpret_cast<uint4*>(&As[row][kv]) = packed;
  }
}

__device__ __forceinline__ void load_b_tile(const ColsB& bw, int bx, int k0, int K,
                                            bf16 (*Bs)[GM_LDB]) {
  // 32 rows x 64 columns = 256 vectors of 8 consecutive columns
  for (int v = threadIdx.x; v < GM_BK * GM_BN / 8; v += GM_THREADS) {
    const int krow = v >> 3;
    const int cv = (v & 7) << 3;
    const int kk = k0 + krow;
    const int col = bx * GM_BN + cv;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (col < bw.N && kk < K) {
      packed = *reinterpret_cast<const uint4*>(bw.w + (size_t)kk * bw.ldw + col);
    }
    *reinterpret_cast<uint4*>(&Bs[krow][cv]) = packed;
  }
}

// Cs[64][GM_LDC] <- A[m0:m0+64, :] @ B[:, bx*64 : bx*64+64]
__device__ __forceinline__ void gemm_tile(const TapA& a, const ColsB& bw, int m0, int bx,
                                          bf16 (*As)[GM_LDA], bf16 (*Bs)[GM_LDB],
                                          float (*Cs)[GM_LDC]) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32;
  const int wc = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < a.K; k0 += GM_BK) {
    load_a_tile(a, m0, k0, As);
    load_b_tile(bw, bx, k0, a.K, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GM_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[wr + 16 * i][kk], GM_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &Bs[kk][wc + 16 * j], GM_LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wr + 16 * i][wc + 16 * j], acc[i][j], GM_LDC,
                              wmma::mem_row_major);
  __syncthreads();
}

// Launch geometry for an M-row problem: x over row tiles (unbounded in
// practice: a vocoder stage has 256 rows per mel frame), y over column tiles.
inline dim3 gemm_grid(int M, const ColsB& bw) { return dim3(cdiv(M, GM_BM), cdiv(bw.N, GM_BN)); }

}  // namespace svc
