// K1: one whole ancestral DDPM reverse step of the DiffSVC denoiser.
//
// Replaces: svc_inference_pipeline_tpu/ops/pallas/denoiser_step.py
//   _ddpm_step_pallas (kernel body _make_kernel(fused=True)), which keeps h,
//   the [T,3C] concat-tap conv input and the f32 skip sum in VMEM across a
//   sequential (batch, layer) grid.
//
// What bounds it here: ~18 GFLOP per step at T=384, C=384, L=20, but at
//   batch 1 the serial latency of each block's K loop (load, sync, MMA per
//   32-wide chunk) sets the time: the step takes the same ~2.7 ms at T=384
//   and T=960 on an H100. The activations (h [T,C] bf16, skip [T,C] f32:
//   ~0.9 MB at T=384) stay in the 50 MB L2 between launches. 227 KB of
//   shared memory cannot hold a sequential layer loop over the whole clip,
//   and CUDA blocks do not run in order, so the TPU's single resident kernel
//   does not carry over.
//
// Design: 2 + 2L launches of one WMMA GEMM tile (gemm_tile.cuh) per step,
//   each with its own fused epilogue:
//   1. prologue: h = relu(bf16(x) @ wmel + bmel), skip = 0;
//   2. per layer: gate g = sigmoid . tanh of (taps(h + step_row) @ w1 +
//      cond_block) — the dilated k=3 taps are gathered straight from h, so
//      the [T,3C] matrix never exists; then (h + yo_res)/sqrt2 and
//      skip += yo_skip from g @ wout + bout. The gate launch reads
//      neighbouring rows of h and the residual launch rewrites h in place only
//      after it, in stream order, so no block reads a row another overwrites.
//   3. skip projection: s1 = relu(bf16(skip/sqrt L) @ wskip + bskip);
//   4. output projection fused with the DDPM update
//      x0 = clamp(s0 x - s1 eps, +-1); x' = s2 x0 + s3 x + s4 z.
//   Numerics follow the TPU kernel: bf16 operands, f32 accumulation, f32
//   gates, f32 skip, h stored bf16, f32 carry x, sigma (s4) = 0 at t = 0.
#include "gemm_tile.cuh"

namespace svc {
namespace {

enum Epilogue { EPI_RELU = 0, EPI_GATE = 1, EPI_RESSKIP = 2, EPI_DDPM = 3 };

struct StepEpi {
  void* out;            // RELU: bf16 [M, ldo]; GATE: bf16 g; RESSKIP: bf16 h (in place); DDPM: f32 x'
  int ldo;
  const bf16* bias;     // RELU/RESSKIP/DDPM
  float* zero_f32;      // RELU: optional buffer zeroed at the same [M, ldo] index
  const bf16* cond;     // GATE: [M, 2C] conditioner block (conv bias folded in)
  float* skip;          // RESSKIP: f32 [M, C]
  const float* x;       // DDPM: f32 carry [M, ldo]
  const float* z;       // DDPM: f32 noise [M, ldo]
  float s0, s1, s2, s3, s4;
};

template <bool A_F32, int EPI>
__global__ void __launch_bounds__(GM_THREADS) step_gemm_kernel(const TapA a, const ColsB bw,
                                                              const StepEpi e) {
  __shared__ __align__(32) bf16 As[GM_BM][GM_LDA];
  __shared__ __align__(32) bf16 Bs[GM_BK][GM_LDB];
  __shared__ __align__(32) float Cs[GM_BM][GM_LDC];
  const int m0 = blockIdx.x * GM_BM;
  const int bx = blockIdx.y;
  gemm_tile<A_F32>(a, bw, m0, bx, As, Bs, Cs);

  if constexpr (EPI == EPI_GATE || EPI == EPI_RESSKIP) {
    const int C = bw.half;
    for (int idx = threadIdx.x; idx < GM_BM * 32; idx += GM_THREADS) {
      const int i = idx >> 5;
      const int j = idx & 31;
      const int r = m0 + i;
      const int c = bx * 32 + j;
      if (r >= a.M || c >= C) continue;
      const float lo = Cs[i][j];
      const float hi = Cs[i][j + 32];
      const size_t o = (size_t)r * e.ldo + c;
      if constexpr (EPI == EPI_GATE) {
        const bf16* cb = e.cond + (size_t)r * 2 * C;
        const float gate = lo + __bfloat162float(cb[c]);
        const float filt = hi + __bfloat162float(cb[C + c]);
        const float y = (1.0f / (1.0f + expf(-gate))) * tanhf(filt);
        static_cast<bf16*>(e.out)[o] = __float2bfloat16(y);
      } else {
        const float res = lo + __bfloat162float(e.bias[c]);
        const float sk = hi + __bfloat162float(e.bias[C + c]);
        bf16* h = static_cast<bf16*>(e.out);
        h[o] = __float2bfloat16((__bfloat162float(h[o]) + res) * 0.70710678118654752f);
        e.skip[o] += sk;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < GM_BM * GM_BN; idx += GM_THREADS) {
      const int i = idx >> 6;
      const int j = idx & 63;
      const int r = m0 + i;
      const int col = bx * GM_BN + j;
      if (r >= a.M || col >= bw.N) continue;
      const size_t o = (size_t)r * e.ldo + col;
      const float v = Cs[i][j] + __bfloat162float(e.bias[col]);
      if constexpr (EPI == EPI_RELU) {
        static_cast<bf16*>(e.out)[o] = __float2bfloat16(fmaxf(v, 0.0f));
        if (e.zero_f32 != nullptr) e.zero_f32[o] = 0.0f;
      } else {
        const float xv = e.x[o];
        const float x0 = fminf(fmaxf(e.s0 * xv - e.s1 * v, -1.0f), 1.0f);
        static_cast<float*>(e.out)[o] = e.s2 * x0 + e.s3 * xv + e.s4 * e.z[o];
      }
    }
  }
}

template <bool A_F32, int EPI>
void launch(const TapA& a, const ColsB& bw, const StepEpi& e, cudaStream_t s) {
  step_gemm_kernel<A_F32, EPI><<<gemm_grid(a.M, bw), GM_THREADS, 0, s>>>(a, bw, e);
}

TapA matrix_a(const void* src, int M, int K, float scale = 1.0f) {
  return TapA{src, K, M, M, K, K, 0, 0, nullptr, scale};
}

}  // namespace
}  // namespace svc

using svc::bf16;

// x_in/x_out/z: f32 [B*T, mp]; h, g, s1: bf16 [B*T, C] scratch; skip: f32
// [B*T, C] scratch; step_rows_t: bf16 [L, C] (this step's rows); w1: bf16
// [L, 3C, 2C] tap-major; condb: bf16 [L, B*T, 2C]; wout: bf16 [L, C, 2C];
// bout: bf16 [L, 2C]; wmel [mp, C], bmel [C], wskip [C, C], bskip [C],
// wo [C, mp], bo [mp], all bf16. sched: s0..s4 of this step.
extern "C" int svc_ddpm_step(const float* x_in, const float* z, float* x_out, bf16* h,
                             float* skip, bf16* g, bf16* s1, const bf16* step_rows_t,
                             const bf16* w1, const bf16* condb, const bf16* wout,
                             const bf16* bout, const bf16* wmel, const bf16* bmel,
                             const bf16* wskip, const bf16* bskip, const bf16* wo,
                             const bf16* bo, int B, int T, int C, int L, int cycle, int mp,
                             float s0, float s1c, float s2, float s3, float s4,
                             void* stream) {
  using namespace svc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * T;

  StepEpi pro{};
  pro.out = h; pro.ldo = C; pro.bias = bmel; pro.zero_f32 = skip;
  launch<true, EPI_RELU>(matrix_a(x_in, M, mp), ColsB{wmel, C, C, 0}, pro, st);

  for (int l = 0; l < L; ++l) {
    const int d = 1 << (l % cycle);
    const TapA taps{h, C, M, T, 3 * C, C, d, d, step_rows_t + (size_t)l * C, 1.0f};
    StepEpi ge{};
    ge.out = g; ge.ldo = C; ge.cond = condb + (size_t)l * M * 2 * C;
    launch<false, EPI_GATE>(taps, ColsB{w1 + (size_t)l * 3 * C * 2 * C, 2 * C, 2 * C, C}, ge, st);

    StepEpi re{};
    re.out = h; re.ldo = C; re.bias = bout + (size_t)l * 2 * C; re.skip = skip;
    launch<false, EPI_RESSKIP>(matrix_a(g, M, C), ColsB{wout + (size_t)l * C * 2 * C, 2 * C, 2 * C, C},
                               re, st);
  }

  StepEpi sk{};
  sk.out = s1; sk.ldo = C; sk.bias = bskip;
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)L));
  launch<true, EPI_RELU>(matrix_a(skip, M, C, inv_sqrt_l), ColsB{wskip, C, C, 0}, sk, st);

  StepEpi dd{};
  dd.out = x_out; dd.ldo = mp; dd.bias = bo; dd.x = x_in; dd.z = z;
  dd.s0 = s0; dd.s1 = s1c; dd.s2 = s2; dd.s3 = s3; dd.s4 = s4;
  launch<false, EPI_DDPM>(matrix_a(s1, M, C), ColsB{wo, mp, mp, 0}, dd, st);
  return (int)cudaGetLastError();
}
