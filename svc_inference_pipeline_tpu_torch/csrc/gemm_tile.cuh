// Tensor-core GEMM tile of the AMP stage convolutions (K2) and the one-launch
// denoiser (K8), and its int8 variant for the denoiser's int8 matmuls (K6,
// at the end of this file). K1, K5 and K6's bf16 launches use the pipelined
// tile of gemm_wg.cuh.
//
// One block of 4 warps computes a 64 x 64 output tile with bf16 WMMA
// fragments (16x16x16, f32 accumulation) over K in chunks of 32. The A
// operand is gathered on the fly as an implicit-GEMM "tap" matrix: row
// r = b*T + t, column kk = m*cin + c reads source row t + m*dil - pad of the
// same batch element (zero outside [0, T)) — a dilated conv1d with `taps`
// taps, or a plain matrix when taps = 1 and pad = 0. The [T, taps*cin] im2col
// matrix is never written to memory. An f32 source can be scaled before
// rounding (the skip sum / sqrt(L)).
//
// The B operand is a row-major [K, ldw] bf16 weight. In "paired" mode
// (half > 0) the tile's 64 columns are two 32-column slices half apart, so a
// gated epilogue sees gate and filter columns of the same channel together.
//
// The result tile lands in shared memory (Cs) for the caller's epilogue.
// Simple by design: no double buffering, no wgmma, no TMA.
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
  const void* src;      // bf16 (or f32 when A_F32) [B*T, ld]
  int ld;               // source row stride, elements (multiple of 8)
  int M;                // rows = B*T
  int T;                // rows per batch element
  int K;                // taps * cin
  int cin;              // channels per tap (multiple of 8)
  int dil;              // tap spacing in rows
  int pad;              // left offset of tap 0
  const bf16* add_row;  // int8 tile, quantised taps: [cin] row added in f32 before quantising
  float scale;          // f32 source only: multiplied before rounding
  const float* amax;    // int8 tile, quantised taps: [B] abs max of each batch element's A
};

template <typename E>
struct Cols {
  const E* w;  // [K, ldw] row-major
  int ldw;     // multiple of 16 bytes
  int N;       // valid columns (plain mode), multiple of 16 bytes
  int half;    // 0: plain; >0: paired mode with this column offset
};
using ColsB = Cols<bf16>;     // the bf16 tile's B operand
using ColsB8 = Cols<int8_t>;  // the int8 tile's B operand

// Global column of tile column j in block column bx; ok=false past the edge.
template <typename B>
__device__ __forceinline__ int tile_col(const B& bw, int bx, int j, bool& ok) {
  if (bw.half > 0) {
    int c = bx * 32 + (j & 31);
    ok = c < bw.half;
    return j < 32 ? c : bw.half + c;
  }
  int col = bx * GM_BN + j;
  ok = col < bw.N;
  return col;
}

template <bool A_F32>
__device__ __forceinline__ void load_a_tile(const TapA& a, int m0, int k0,
                                            bf16 (*As)[GM_LDA]) {
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
        const size_t off = (size_t)(b * a.T + ts) * a.ld + c;
        if constexpr (A_F32) {
          float f[8];
          const float4* p = reinterpret_cast<const float4*>(
              static_cast<const float*>(a.src) + off);
          const float4 x0 = p[0];
          const float4 x1 = p[1];
          f[0] = x0.x; f[1] = x0.y; f[2] = x0.z; f[3] = x0.w;
          f[4] = x1.x; f[5] = x1.y; f[6] = x1.z; f[7] = x1.w;
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] *= a.scale;
          bf16* ov = reinterpret_cast<bf16*>(&packed);
#pragma unroll
          for (int i = 0; i < 8; ++i) ov[i] = __float2bfloat16(f[i]);
        } else {
          packed = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(a.src) + off);
        }
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
    bool ok;
    const int col = tile_col(bw, bx, cv, ok);
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (ok && kk < K) {
      packed = *reinterpret_cast<const uint4*>(bw.w + (size_t)kk * bw.ldw + col);
    }
    *reinterpret_cast<uint4*>(&Bs[krow][cv]) = packed;
  }
}

// Cs[64][GM_LDC] <- A[m0:m0+64, :] @ B[:, tile columns of bx]
template <bool A_F32>
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
    load_a_tile<A_F32>(a, m0, k0, As);
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

// ---------------------------------------------------------------------------
// int8 tile (K6): the same 64 x 64 output tile from signed 8-bit operands
// with int32 accumulation (WMMA s8 16x16x16 fragments), over K in chunks of
// 64, the same 64 bytes per row and chunk as the bf16 tile. A is either a
// plain int8 matrix [M, ld] or (QUANT_TAPS) the conv taps of a bf16 source
// plus add_row, quantised in f32 exactly as the TPU kernel does:
// q = clip(rint(y * (1 / s)), -127, 127), s = max(amax[b], 1e-12) / 127 for
// the row's batch element b. The int32 sums land in shared memory (Ci) for
// the caller's epilogue. cin and K must be multiples of 16.
//
// Shared layouts keep every WMMA fragment pointer 256-bit aligned with
// ldm = 16: A as [k/16][row][16], B as [column/16][k][16].

constexpr int G8_BK = 64;

__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
}

__device__ __forceinline__ int8_t quant_i8(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

template <bool QUANT_TAPS>
__device__ __forceinline__ void load_a_tile_s8(const TapA& a, int m0, int k0,
                                               int8_t (*As)[GM_BM][16]) {
  // 64 rows x 64 columns = 256 vectors of 16 consecutive K elements
  for (int v = threadIdx.x; v < GM_BM * G8_BK / 16; v += GM_THREADS) {
    const int row = v >> 2;
    const int ks = v & 3;
    const int r = m0 + row;
    const int kk = k0 + ks * 16;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (r < a.M && kk < a.K) {
      if constexpr (QUANT_TAPS) {
        const int m = kk / a.cin;
        const int c = kk - m * a.cin;
        const int b = r / a.T;
        const int t = r - b * a.T;
        const int ts = t + m * a.dil - a.pad;
        if (ts >= 0 && ts < a.T) {
          const uint4* p = reinterpret_cast<const uint4*>(
              static_cast<const bf16*>(a.src) + (size_t)(b * a.T + ts) * a.ld + c);
          const uint4 raw[2] = {p[0], p[1]};
          const bf16* hv = reinterpret_cast<const bf16*>(raw);
          const float inv = 1.0f / quant_scale(a.amax[b]);
          int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const float y = __fadd_rn(__bfloat162float(hv[i]), __bfloat162float(a.add_row[c + i]));
            q[i] = quant_i8(__fmul_rn(y, inv));
          }
        }
      } else {
        packed = *reinterpret_cast<const uint4*>(static_cast<const int8_t*>(a.src) +
                                                 (size_t)r * a.ld + kk);
      }
    }
    *reinterpret_cast<uint4*>(&As[ks][row][0]) = packed;
  }
}

__device__ __forceinline__ void load_b_tile_s8(const ColsB8& bw, int bx, int k0, int K,
                                               int8_t (*Bs)[G8_BK][16]) {
  // 64 rows x 64 columns = 256 vectors of 16 consecutive columns
  for (int v = threadIdx.x; v < G8_BK * GM_BN / 16; v += GM_THREADS) {
    const int krow = v >> 2;
    const int jv = v & 3;
    const int kk = k0 + krow;
    bool ok;
    const int col = tile_col(bw, bx, jv * 16, ok);
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (ok && kk < K) {
      packed = *reinterpret_cast<const uint4*>(bw.w + (size_t)kk * bw.ldw + col);
    }
    *reinterpret_cast<uint4*>(&Bs[jv][krow][0]) = packed;
  }
}

// Ci[64][GM_LDC] <- A[m0:m0+64, :] @ B[:, tile columns of bx], int32
template <bool QUANT_TAPS>
__device__ __forceinline__ void gemm_tile_s8(const TapA& a, const ColsB8& bw, int m0, int bx,
                                             int8_t (*As)[GM_BM][16], int8_t (*Bs)[G8_BK][16],
                                             int (*Ci)[GM_LDC]) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32;
  const int wc = (warp & 1) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < a.K; k0 += G8_BK) {
    load_a_tile_s8<QUANT_TAPS>(a, m0, k0, As);
    load_b_tile_s8(bw, bx, k0, a.K, Bs);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < G8_BK / 16; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[ks][wr + 16 * i][0], 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], &Bs[(wc >> 4) + j][ks * 16][0], 16);
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
      wmma::store_matrix_sync(&Ci[wr + 16 * i][wc + 16 * j], acc[i][j], GM_LDC,
                              wmma::mem_row_major);
  __syncthreads();
}

// Launch geometry for an M-row problem: x over row tiles (unbounded in
// practice: a vocoder stage has 256 rows per mel frame), y over column tiles.
template <typename B>
inline dim3 gemm_grid(int M, const B& bw) {
  const int ny = bw.half > 0 ? cdiv(bw.half, 32) : cdiv(bw.N, GM_BN);
  return dim3(cdiv(M, GM_BM), ny);
}

}  // namespace svc
