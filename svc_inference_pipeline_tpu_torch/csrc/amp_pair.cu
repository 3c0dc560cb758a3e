// K7: one BigVGAN AMPBlock1 pair, out = x + conv_1(act2(conv_d(act1(x)))),
// in ONE launch.
//
// Replaces: svc_inference_pipeline_tpu/ops/pallas/amp_pair.py fused_amp_pair
//   (kernel body _make_kernel): one time tile per grid step with both
//   activations inline and both convs as k shifted MXU matmuls, all in VMEM;
//   its outer halo rows are wrong at the clip's edges and are patched by an
//   XLA composition (_xla_pair) afterwards. That patch is not carried over.
//
// What bounds it here: at the wide stages the two convs, 2 * 2 T C^2 k
//   operations (a stage-1 pair at k = 11 on a 4 s clip: 40 GFLOP, 40 us at
//   the tensor cores' dense bf16 peak) against ~16 MB of x, output and
//   weights (5 us). At C = 24 the activations' f32 arithmetic (~116 FLOP per
//   element and pair) and the 9 MB of x and output weigh as much as the
//   convs. This first version is simple: WMMA fragments fed from shared
//   memory, one synchronised weight chunk at a time, nothing overlapped.
//
// Design: a block owns TT output rows of one clip and all C channels (C is
//   padded to a multiple of 16 with zero weights, so C = 24 and 48 work). It
//   recomputes its own halo instead of exchanging it: with p1 = d(k-1)/2 and
//   p2 = (k-1)/2 it needs
//     A3 = bf16(act2(.)) on N3 = TT + 2 p2 rows (conv_1's input),
//     A2 = conv_d output (f32) on N2 = N3 + 2 ACT_HALO rows (act2's input),
//     A1 = bf16(act1(x)) on N1 = N2 + 2 p1 rows (conv_d's input),
//   i.e. a halo of ACT_HALO + p1 + ACT_HALO + p2 input rows per side (40 at
//   k = 11, d = 5), and keeps A1, A2, A3 and the output tile in shared
//   memory, never in global memory. Both convs run on the tensor cores:
//   the A operand is the activation buffer itself, a tap m of conv_d being
//   the row offset m*d (the buffers' row stride keeps every fragment pointer
//   32-byte aligned), and the weight [k, C, C] is streamed from L2 into
//   shared memory 64 K-rows at a time (at C = 384 the pair's 6.5 MB of
//   weights do not fit). conv_d's rows are padded to a multiple of 16 (MP1);
//   the recomputed rows cost MP1 / TT = 1.5x (k = 3, 7) and 2x (k = 11) of
//   conv_d's useful work at TT = 32, conv_1 none. Shared memory is reused
//   between phases: region 1 holds A1, then A3 and act2's snake samples;
//   region 2 holds act1's snake samples, then A2, then the output tile.
//   Edges are exact by construction: every block knows its global rows, the
//   activations clamp them to [0, T) (edge replication of the resamplers) and
//   rows of A1/A3 outside [0, T) are zero (the convs' zero padding).
//   Numerics follow the TPU kernel: act1 on f32(x), conv operands rounded to
//   bf16, f32 accumulation, + b1, act2 on the f32 conv output, + b2 + f32(x)
//   rounded once. The host side (ops/pallas/amp_pair.py::plan) chooses TT and
//   lays out the shared memory, and passes it all in.
#include <mma.h>

#include "snake.cuh"

namespace svc {
namespace {

constexpr int AP_THREADS = 256;
constexpr int AP_WARPS = AP_THREADS / 32;
constexpr int AP_NB = 128;          // output columns per GEMM pass
constexpr int AP_KB = 64;           // weight rows (of the flattened k*C axis) staged per sync
constexpr int AP_LDB = AP_NB + 8;   // bf16 row stride of the staged weights
constexpr int AP_CG = 32;           // channels per activation pass
constexpr int AP_MAXI = 4;          // 16x16 accumulator tiles per warp (64 rows x 128 columns)

struct PairArgs {
  const bf16* x;  // [B, T, C]
  bf16* out;      // [B, T, C]
  const bf16* w1;  // [k, C, C] conv_d
  const float* b1;
  const bf16* w2;  // [k, C, C] conv_1
  const float* b2;
  const float* alpha1;
  const float* inv_beta1;
  const float* alpha2;
  const float* inv_beta2;
  Fir12 f;
  int T, C, k, d;
  int cp;       // C padded to a multiple of 16
  int lda;      // bf16 row stride of A1 and A3 (multiple of 16)
  int ldf;      // f32 row stride of A2 and the output tile (multiple of 4)
  int tt;       // output rows per block (multiple of 16)
  int mp1;      // conv_d output rows, N2 padded to a multiple of 16 (<= 64)
  int off_ss2;  // byte offset of act2's snake samples in region 1 (after A3)
  int off2;     // byte offset of region 2
  int offb;     // byte offset of the staged weights
};

// dst[i][c] = bf16(act(src)[o0 + i][c]) for i < n, c < cp: zero for rows
// outside [0, T) (the convs' zero padding) and for the padding channels.
// src(t, c) is the activation's input at the global row t in [0, T).
// ss holds (2n + 12) x AP_CG f32 snake samples of one channel group.
template <class Src>
__device__ void act_pass(Src src, int T, int C, int cp, int o0, int n, const float* alpha,
                         const float* inv_beta, const Fir12& f, bf16* dst, int ld, float* ss) {
  const int nq = 2 * n + 12;
  for (int c0 = 0; c0 < cp; c0 += AP_CG) {
    for (int e = threadIdx.x; e < nq * AP_CG; e += AP_THREADS) {
      const int q = e / AP_CG;
      const int c = c0 + (e - q * AP_CG);
      float s = 0.0f;
      if (c < C) {
        const int nn = min(max(2 * o0 - 5 + q, 0), 2 * T - 1);
        s = act_snake(act_up(f, nn, T, [&](int t) { return src(t, c); }), alpha[c], inv_beta[c]);
      }
      ss[e] = s;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * AP_CG; e += AP_THREADS) {
      const int i = e / AP_CG;
      const int cc = e - i * AP_CG;
      const int c = c0 + cc;
      if (c >= cp) continue;
      const int t = o0 + i;
      const bool live = t >= 0 && t < T && c < C;
      dst[i * ld + c] = __float2bfloat16(live ? act_down(f, ss + 2 * i * AP_CG + cc, AP_CG) : 0.0f);
    }
    __syncthreads();
  }
}

// D[r][c] = sum_{m < k, j < C} A[r + m*dil][j] * W[m][j][c] for r < 16 mf,
// c < cp (f32, row stride ldd). A: bf16 in shared memory, row stride lda;
// W: bf16 [k, C, C] in global memory, staged AP_KB rows of the flattened
// [k*cp] axis at a time into bs (zeros past C). A 16-row step never
// straddles two taps because cp is a multiple of 16.
__device__ void conv_pass(const bf16* A, int lda, int dil, int mf, const bf16* __restrict__ W, int k,
                          int C, int cp, bf16* bs, float* D, int ldd) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5;
  const int K = k * cp;
  for (int c0 = 0; c0 < cp; c0 += AP_NB) {
    const int nf = min(AP_NB, cp - c0) >> 4;
    const int items = mf * nf;  // 16x16 output tiles of this pass, AP_WARPS apart per warp
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[AP_MAXI];
#pragma unroll
    for (int i = 0; i < AP_MAXI; ++i) wmma::fill_fragment(acc[i], 0.0f);
    for (int k0 = 0; k0 < K; k0 += AP_KB) {
      for (int v = threadIdx.x; v < AP_KB * AP_NB / 8; v += AP_THREADS) {
        const int kr = v / (AP_NB / 8);
        const int cv = (v - kr * (AP_NB / 8)) * 8;
        const int kk = k0 + kr;
        const int m = kk / cp;
        const int j = kk - m * cp;
        const int col = c0 + cv;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (kk < K && j < C && col < C) {
          val = *reinterpret_cast<const uint4*>(W + ((size_t)m * C + j) * C + col);
        }
        *reinterpret_cast<uint4*>(bs + kr * AP_LDB + cv) = val;
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < AP_KB / 16; ++s) {
        const int kk = k0 + 16 * s;
        if (kk >= K) break;  // block-uniform
        const int m = kk / cp;
        const int j = kk - m * cp;
#pragma unroll
        for (int i = 0; i < AP_MAXI; ++i) {
          const int item = warp + i * AP_WARPS;
          if (item < items) {  // warp-uniform
            const int rf = item / nf;
            const int cf = item - rf * nf;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fa, A + (size_t)(16 * rf + m * dil) * lda + j, lda);
            wmma::load_matrix_sync(fb, bs + 16 * s * AP_LDB + 16 * cf, AP_LDB);
            wmma::mma_sync(acc[i], fa, fb, acc[i]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < AP_MAXI; ++i) {
      const int item = warp + i * AP_WARPS;
      if (item < items) {
        const int rf = item / nf;
        const int cf = item - rf * nf;
        wmma::store_matrix_sync(D + (size_t)16 * rf * ldd + c0 + 16 * cf, acc[i], ldd,
                                wmma::mem_row_major);
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(AP_THREADS) amp_pair_kernel(const PairArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a1 = reinterpret_cast<bf16*>(smem);  // region 1: A1, then A3
  float* ss2 = reinterpret_cast<float*>(smem + p.off_ss2);
  float* r2 = reinterpret_cast<float*>(smem + p.off2);  // region 2: act1's samples, A2, output tile
  bf16* bs = reinterpret_cast<bf16*>(smem + p.offb);
  const int T = p.T;
  const int C = p.C;
  const int t0 = blockIdx.x * p.tt;
  const int g3 = t0 - (p.k - 1) / 2;       // global row of A3's row 0
  const int g2 = g3 - ACT_HALO;            // ... of A2's row 0
  const int g1 = g2 - p.d * (p.k - 1) / 2;  // ... of A1's row 0
  const int n3 = p.tt + p.k - 1;
  const int n1 = n3 + 2 * ACT_HALO + p.d * (p.k - 1);
  const int rows1 = p.mp1 + p.d * (p.k - 1);  // A1 rows conv_d reads for its padded rows
  const size_t base = (size_t)blockIdx.y * T * C;
  const bf16* x = p.x + base;

  // 1. A1 = bf16(act1(x)) on rows g1 .. g1 + n1; the rows after them feed
  //    only conv_d's padding rows and are zeroed
  act_pass([&](int t, int c) { return __bfloat162float(x[(size_t)t * C + c]); }, T, C, p.cp, g1, n1,
           p.alpha1, p.inv_beta1, p.f, a1, p.lda, r2);
  for (int e = threadIdx.x; e < (rows1 - n1) * p.lda; e += AP_THREADS) {
    a1[(size_t)n1 * p.lda + e] = __float2bfloat16(0.0f);
  }
  __syncthreads();
  // 2. A2 = conv_d(A1), f32, b1 added where it is read
  conv_pass(a1, p.lda, p.d, p.mp1 >> 4, p.w1, p.k, C, p.cp, bs, r2, p.ldf);
  // 3. A3 = bf16(act2(A2 + b1)) on rows g3 .. g3 + n3, over A1
  const float* b1 = p.b1;
  act_pass([&](int t, int c) { return r2[(size_t)(t - g2) * p.ldf + c] + b1[c]; }, T, C, p.cp, g3, n3,
           p.alpha2, p.inv_beta2, p.f, a1, p.lda, ss2);
  // 4. output tile = conv_1(A3), f32, over A2
  conv_pass(a1, p.lda, 1, p.tt >> 4, p.w2, p.k, C, p.cp, bs, r2, p.ldf);
  // 5. out = bf16(tile + b2 + f32(x))
  for (int e = threadIdx.x; e < p.tt * C; e += AP_THREADS) {
    const int i = e / C;
    const int c = e - i * C;
    const int t = t0 + i;
    if (t >= T) break;  // rows only grow with e
    const size_t o = (size_t)t * C + c;
    p.out[base + o] = __float2bfloat16(r2[(size_t)i * p.ldf + c] + p.b2[c] + __bfloat162float(x[o]));
  }
}

}  // namespace
}  // namespace svc

// One AMPBlock1 pair of x [B, T, C] bf16 into out [B, T, C] bf16. w1, w2:
// bf16 [k, C, C] (tap-major [k, Cin, Cout]); b1, b2 and the activations'
// effective alpha / 1/(beta + 1e-9): f32 [C]; taps: host pointer to the 12
// resampling filter taps. cp .. smem: the tile and shared-memory layout of
// ops/pallas/amp_pair.py::plan (smem bytes of dynamic shared memory).
extern "C" int svc_amp_pair(const svc::bf16* x, svc::bf16* out, const svc::bf16* w1, const float* b1,
                            const svc::bf16* w2, const float* b2, const float* alpha1,
                            const float* inv_beta1, const float* alpha2, const float* inv_beta2,
                            const float* taps, int B, int T, int C, int k, int d, int cp, int lda,
                            int ldf, int tt, int mp1, int off_ss2, int off2, int offb, int smem,
                            void* stream) {
  using namespace svc;
  cudaError_t err =
      cudaFuncSetAttribute(amp_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const PairArgs p{x, out, w1, b1, w2, b2, alpha1, inv_beta1, alpha2, inv_beta2, fir12_from(taps),
                   T, C, k, d, cp, lda, ldf, tt, mp1, off_ss2, off2, offb};
  amp_pair_kernel<<<dim3(cdiv(T, tt), B), AP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
