// K4: unmasked full-context self-attention of the Whisper encoder.
//
// Replaces: svc_inference_pipeline_tpu/ops/pallas/attention.py
//   encoder_attention, whose kernel holds one (head, 512-row q block)'s
//   [512, T] f32 score block in VMEM against all keys at once.
//
// What bounds it here: at [B, 1500, 1024] with 16 heads of 64 the score
//   matrix is 36M f32 per window — writing it out and reading it back would
//   cost more than the products (4.6 GFLOP per pass per layer). 227 KB of
//   shared memory cannot hold a [64, 1500] f32 score block either.
//
// Design: one block of 4 warps per (batch*head, 64-row q tile); K and V
//   tiles of 64 keys are staged through shared memory, products on bf16 WMMA
//   fragments with f32 accumulation. Two passes over the keys: pass 1 keeps
//   each row's running max and sum; pass 2 recomputes the scores, forms
//   P = exp(s - max) / sum in f32, rounds P to bf16 only after the full
//   normalisation (as the TPU kernel does before its P@V), and accumulates
//   P@V. Keys past T (the last partial tile) are masked. q and k are scaled
//   by hd^-0.25 each and rounded to bf16 on load, as the JAX wrapper does.
#include <mma.h>

#include "common.cuh"

namespace svc {
namespace {

constexpr int AT_BQ = 64;   // query rows per block
constexpr int AT_BK = 64;   // keys per tile
constexpr int AT_HD = 64;   // head dim
constexpr int AT_LD = AT_HD + 8;
constexpr int AT_LDS = AT_BK + 4;
constexpr int AT_THREADS = 128;

// rows [t0, t0+64) x head columns of a [B, T, D] tensor -> bf16 tile, scaled
__device__ __forceinline__ void load_tile(const bf16* src, int b, int t0, int T, int D,
                                          int col0, float scale, bool scaled,
                                          bf16 (*dst)[AT_LD]) {
  for (int v = threadIdx.x; v < AT_BQ * AT_HD / 8; v += AT_THREADS) {
    const int row = v >> 3;
    const int cv = (v & 7) << 3;
    const int t = t0 + row;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      packed = *reinterpret_cast<const uint4*>(src + ((size_t)b * T + t) * D + col0 + cv);
      if (scaled) {
        bf16* hv = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int i = 0; i < 8; ++i) hv[i] = __float2bfloat16(__bfloat162float(hv[i]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(&dst[row][cv]) = packed;
  }
}

// Ss[16w:16w+16, 0:64] = Qs[16w:16w+16, :] @ Ks^T for warp w
__device__ __forceinline__ void scores(bf16 (*Qs)[AT_LD], bf16 (*Ks)[AT_LD],
                                       float (*Ss)[AT_LDS]) {
  using namespace nvcuda;
  const int w = threadIdx.x >> 5;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < AT_HD; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, &Qs[16 * w][kk], AT_LD);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, &Ks[16 * j][kk], AT_LD);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&Ss[16 * w][16 * j], acc[j], AT_LDS, wmma::mem_row_major);
}

__global__ void __launch_bounds__(AT_THREADS)
    encoder_attention_kernel(const bf16* q, const bf16* k, const bf16* v, bf16* out, int T,
                             int H, float scale) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 Qs[AT_BQ][AT_LD];
  __shared__ __align__(32) bf16 KVs[AT_BK][AT_LD];
  __shared__ __align__(32) float Ss[AT_BQ][AT_LDS];
  __shared__ __align__(32) bf16 Ps[AT_BQ][AT_LD];
  __shared__ float row_max[AT_BQ];
  __shared__ float row_sum[AT_BQ];

  const int t0 = blockIdx.x * AT_BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int D = H * AT_HD;
  const int col0 = h * AT_HD;
  const int w = threadIdx.x >> 5;
  const int row = threadIdx.x >> 1;          // softmax row of this thread
  const int cbase = (threadIdx.x & 1) * 32;  // its half of the key tile
  const int n_tiles = cdiv(T, AT_BK);

  load_tile(q, b, t0, T, D, col0, scale, true, Qs);

  // pass 1: running max / sum per (row, half), combined across the pair
  float m = __int_as_float(0xff800000);  // -inf
  float l = 0.0f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_tile(k, b, kt * AT_BK, T, D, col0, scale, true, KVs);
    __syncthreads();
    scores(Qs, KVs, Ss);
    __syncthreads();
    const int nvalid = min(AT_BK, T - kt * AT_BK);
    for (int c = cbase; c < cbase + 32 && c < nvalid; ++c) {
      const float s = Ss[row][c];
      if (s > m) {
        l = l * expf(m - s) + 1.0f;
        m = s;
      } else {
        l += expf(s - m);
      }
    }
  }
  {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, 1);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, 1);
    const float mm = fmaxf(m, m_o);
    const float ll = (l == 0.0f ? 0.0f : l * expf(m - mm)) +
                     (l_o == 0.0f ? 0.0f : l_o * expf(m_o - mm));
    if ((threadIdx.x & 1) == 0) {
      row_max[row] = mm;
      row_sum[row] = ll;
    }
  }

  // pass 2: normalised P (bf16) @ V, f32 accumulation
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(o[j], 0.0f);
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_tile(k, b, kt * AT_BK, T, D, col0, scale, true, KVs);
    __syncthreads();
    scores(Qs, KVs, Ss);
    __syncthreads();
    const int nvalid = min(AT_BK, T - kt * AT_BK);
    const float mm = row_max[row];
    const float ll = row_sum[row];
    for (int c = cbase; c < cbase + 32; ++c) {
      const float p = c < nvalid ? expf(Ss[row][c] - mm) / ll : 0.0f;
      Ps[row][c] = __float2bfloat16(p);
    }
    load_tile(v, b, kt * AT_BK, T, D, col0, 1.0f, false, KVs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AT_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &Ps[16 * w][kk], AT_LD);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &KVs[kk][16 * j], AT_LD);
        wmma::mma_sync(o[j], fa, fb, o[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&Ss[16 * w][16 * j], o[j], AT_LDS, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < AT_BQ * AT_HD; idx += AT_THREADS) {
    const int r = idx >> 6;
    const int c = idx & 63;
    const int t = t0 + r;
    if (t < T) out[((size_t)b * T + t) * D + col0 + c] = __float2bfloat16(Ss[r][c]);
  }
}

}  // namespace
}  // namespace svc

// q, k, v, out: bf16 [B, T, H*64], contiguous. scale: hd^-0.25 (applied to q and k).
extern "C" int svc_encoder_attention(const svc::bf16* q, const svc::bf16* k,
                                     const svc::bf16* v, svc::bf16* out, int B, int T, int H,
                                     float scale, void* stream) {
  using namespace svc;
  const dim3 grid(cdiv(T, AT_BQ), B * H);
  encoder_attention_kernel<<<grid, AT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, T, H, scale);
  return (int)cudaGetLastError();
}
