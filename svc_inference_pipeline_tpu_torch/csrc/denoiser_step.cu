// K1, K5 and K6: the DiffSVC denoiser's forward with one of two outputs, on
// a bf16 or an int8 weight stack.
//
// Replaces, in svc_inference_pipeline_tpu/ops/pallas/denoiser_step.py:
//   K1 _ddpm_step_pallas (kernel body _make_kernel(fused=True)): one whole
//      ancestral DDPM reverse step (svc_ddpm_step);
//   K5 _denoise_pallas (_make_kernel(fused=False)): the forward returning
//      eps, for PLMS, DDIM and DPM++ (svc_denoise);
//   K6 the quant1/quant2 variants of that body: int8 dilated-conv GEMM with
//      a dynamic per-batch-element activation scale and per-column weight
//      scales ("int8-w1"), and in "int8" mode the output GEMM in int8 too.
//   The TPU kernel keeps h, the [T,3C] concat-tap conv input and the f32
//   skip sum in VMEM across a sequential (batch, layer) grid.
//
// What bounds it here: ~18 GFLOP per call at T=384, C=384, L=20, but at
//   batch 1 the serial latency of each block's K loop (load, sync, MMA per
//   chunk) sets the time: a step takes the same ~2.7 ms at T=384 and T=960
//   on an H100. The activations (h [T,C] bf16, skip [T,C] f32: ~0.9 MB at
//   T=384) stay in the 50 MB L2 between launches. 227 KB of shared memory
//   cannot hold a sequential layer loop over the whole clip, and CUDA blocks
//   do not run in order, so the TPU's single resident kernel does not carry
//   over. The int8 tile takes K in chunks of 64 (18 for the conv instead of
//   the bf16 tile's 36), which is what can make int8 faster here.
//
// Design: 2 + 2L launches of one WMMA GEMM tile (gemm_tile.cuh) per call,
//   each with its own fused epilogue:
//   1. prologue: h = relu(bf16(x) @ wmel + bmel), skip = 0;
//   2. per layer: gate g = sigmoid . tanh of (taps(h + step_row) @ w1 +
//      cond_block) — the dilated k=3 taps are gathered straight from h, so
//      the [T,3C] matrix never exists; then (h + yo_res)/sqrt2 and
//      skip += yo_skip from g @ wout + bout. The gate launch reads
//      neighbouring rows of h and the residual launch rewrites h in place only
//      after it, in stream order, so no block reads a row another overwrites.
//   3. skip projection: s1 = relu(bf16(skip/sqrt L) @ wskip + bskip);
//   4. output projection with either the DDPM update
//      x0 = clamp(s0 x - s1 eps, +-1); x' = s2 x0 + s3 x + s4 z (K1),
//      or the store of eps = acc + bo in f32 for the n_mel columns (K5).
//   Numerics follow the TPU kernel: bf16 operands, f32 accumulation, f32
//   gates, f32 skip, h stored bf16, f32 carry x, sigma (s4) = 0 at t = 0.
//
// int8 (K6): the conv input y = h + step_row is quantised in f32, not first
//   rounded to bf16, with s_y = max(max|y|, 1e-12)/127 per batch element (the
//   TPU grid's outer axis is batch). s_y needs the max over the element's
//   [T, C] before the gate GEMM reads it: the epilogue that writes h (the
//   prologue for layer 0, the residual epilogue of layer l for layer l+1)
//   folds |bf16(h) + step_row[l+1]| into a zeroed [L, B] buffer with one
//   atomicMax on the float bits per warp and batch element. The gate GEMM
//   scales its int32 sums by (s_y * w1s[col]); in "int8" mode its epilogue
//   stores the gate as rint(g * 127) in int8 and the residual GEMM runs on
//   int8 too, scaled by (wouts[col] * (1/127)). The dequantising epilogues
//   use round-to-nearest intrinsics without contraction, as the plain version
//   computes them. The int8 sums are exact (|sum| <= 3C * 127^2 < 2^31), and
//   the int32 -> f32 conversion rounds to nearest as the plain version's
//   float64 -> f32 does.
#include "gemm_tile.cuh"

namespace svc {
namespace {

enum Epilogue { EPI_RELU = 0, EPI_GATE = 1, EPI_RESSKIP = 2, EPI_DDPM = 3, EPI_EPS = 4 };
enum AKind { A_BF16 = 0, A_F32 = 1, A_Q8_TAPS = 2, A_I8 = 3 };

struct StepEpi {
  void* out;             // RELU: bf16 [M, ldo]; GATE: bf16 or int8 g; RESSKIP: bf16 h (in place);
                         // DDPM: f32 x'; EPS: f32 eps [M, ldo]
  int ldo;
  const bf16* bias;      // RELU/RESSKIP/DDPM/EPS
  float* zero_f32;       // RELU: optional buffer zeroed at the same [M, ldo] index
  const bf16* cond;      // GATE: [M, 2C] conditioner block (conv bias folded in)
  float* skip;           // RESSKIP: f32 [M, C]
  const float* x;        // DDPM: f32 carry [M, ldo]
  const float* z;        // DDPM: f32 noise [M, ldo]
  float s0, s1, s2, s3, s4;
  int n_out;             // EPS: columns stored (n_mel)
  // int8 (K6)
  const float* col_scale;  // int8 GEMM: w1s (GATE) or wouts (RESSKIP) [2C]
  const float* amax_in;    // GATE on int8 taps: [B] abs max of this layer's conv input
  bool gate_i8;            // GATE: store g as int8 rint(g * 127)
  float* amax_out;         // RELU/RESSKIP: [B] abs max of h + next_row, or null
  const bf16* next_row;    // the next layer's step row [C]
  int T;                   // rows per batch element
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Running max of |h + next_row| over one batch element, kept per warp: every
// lane of a warp handles the same row at the same time in the epilogues, so
// the batch index is warp-uniform and one atomic per warp and element folds
// the warp's max into amax_out (non-negative floats order like their bits).
struct RowMax {
  int b = -1;
  float m = 0.0f;

  __device__ void flush(float* amax_out) {
    const float w = warp_max(m);
    if ((threadIdx.x & 31) == 0 && b >= 0) atomicMax(reinterpret_cast<int*>(amax_out) + b, __float_as_int(w));
  }
  __device__ void add(int row_b, float v, float* amax_out) {
    if (row_b != b) {
      flush(amax_out);
      b = row_b;
      m = 0.0f;
    }
    m = fmaxf(m, v);
  }
};

template <int AK, int EPI>
__global__ void __launch_bounds__(GM_THREADS) step_gemm_kernel(const TapA a, const ColsB bw,
                                                              const ColsB8 bw8, const StepEpi e) {
  constexpr bool INT8 = AK == A_Q8_TAPS || AK == A_I8;
  __shared__ __align__(32) float Cs[GM_BM][GM_LDC];
  const int m0 = blockIdx.x * GM_BM;
  const int bx = blockIdx.y;
  if constexpr (INT8) {
    __shared__ __align__(32) int8_t As[G8_BK / 16][GM_BM][16];
    __shared__ __align__(32) int8_t Bs[GM_BN / 16][G8_BK][16];
    gemm_tile_s8<AK == A_Q8_TAPS>(a, bw8, m0, bx, As, Bs, reinterpret_cast<int (*)[GM_LDC]>(Cs));
  } else {
    __shared__ __align__(32) bf16 As[GM_BM][GM_LDA];
    __shared__ __align__(32) bf16 Bs[GM_BK][GM_LDB];
    gemm_tile<AK == A_F32>(a, bw, m0, bx, As, Bs, Cs);
  }
  RowMax rowmax;

  if constexpr (EPI == EPI_GATE || EPI == EPI_RESSKIP) {
    const int C = INT8 ? bw8.half : bw.half;
    for (int idx = threadIdx.x; idx < GM_BM * 32; idx += GM_THREADS) {
      const int i = idx >> 5;
      const int j = idx & 31;
      const int r = m0 + i;
      const int c = bx * 32 + j;
      if (r >= a.M) continue;  // warp-uniform: the lanes of a warp share i
      float lo = Cs[i][j];
      float hi = Cs[i][j + 32];
      if constexpr (INT8) {
        // s_y * w1s[col] (gate) or wouts[col] * (1/127) (residual), then acc * that
        const float rs = EPI == EPI_GATE ? quant_scale(e.amax_in[r / e.T]) : 1.0f / 127.0f;
        lo = __fmul_rn(__int2float_rn(__float_as_int(lo)), __fmul_rn(rs, e.col_scale[c]));
        hi = __fmul_rn(__int2float_rn(__float_as_int(hi)), __fmul_rn(rs, e.col_scale[C + c]));
      }
      const size_t o = (size_t)r * e.ldo + c;
      if constexpr (EPI == EPI_GATE) {
        const bf16* cb = e.cond + (size_t)r * 2 * C;
        const float gate = __fadd_rn(lo, __bfloat162float(cb[c]));
        const float filt = __fadd_rn(hi, __bfloat162float(cb[C + c]));
        const float y = (1.0f / (1.0f + expf(-gate))) * tanhf(filt);
        if (e.gate_i8) {
          static_cast<int8_t*>(e.out)[o] = quant_i8(y * 127.0f);
        } else {
          static_cast<bf16*>(e.out)[o] = __float2bfloat16(y);
        }
      } else {
        const float res = __fadd_rn(lo, __bfloat162float(e.bias[c]));
        const float sk = __fadd_rn(hi, __bfloat162float(e.bias[C + c]));
        bf16* h = static_cast<bf16*>(e.out);
        const bf16 hn = __float2bfloat16((__bfloat162float(h[o]) + res) * 0.70710678118654752f);
        h[o] = hn;
        e.skip[o] += sk;
        if (e.amax_out != nullptr) {
          rowmax.add(r / e.T, fabsf(__bfloat162float(hn) + __bfloat162float(e.next_row[c])), e.amax_out);
        }
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < GM_BM * GM_BN; idx += GM_THREADS) {
      const int i = idx >> 6;
      const int j = idx & 63;
      const int r = m0 + i;
      const int col = bx * GM_BN + j;
      if (r >= a.M || col >= bw.N) continue;  // warp-uniform for the N used here (multiples of 64)
      const size_t o = (size_t)r * e.ldo + col;
      const float v = Cs[i][j] + __bfloat162float(e.bias[col]);
      if constexpr (EPI == EPI_RELU) {
        const bf16 hv = __float2bfloat16(fmaxf(v, 0.0f));
        static_cast<bf16*>(e.out)[o] = hv;
        if (e.zero_f32 != nullptr) e.zero_f32[o] = 0.0f;
        if (e.amax_out != nullptr) {
          rowmax.add(r / e.T, fabsf(__bfloat162float(hv) + __bfloat162float(e.next_row[col])), e.amax_out);
        }
      } else if constexpr (EPI == EPI_DDPM) {
        const float xv = e.x[o];
        const float x0 = fminf(fmaxf(e.s0 * xv - e.s1 * v, -1.0f), 1.0f);
        static_cast<float*>(e.out)[o] = e.s2 * x0 + e.s3 * xv + e.s4 * e.z[o];
      } else {
        if (col < e.n_out) static_cast<float*>(e.out)[(size_t)r * e.n_out + col] = v;
      }
    }
  }
  if (e.amax_out != nullptr) rowmax.flush(e.amax_out);
}

template <int AK, int EPI>
void launch(const TapA& a, const ColsB& bw, const ColsB8& bw8, const StepEpi& e, cudaStream_t s) {
  const dim3 grid = (AK == A_Q8_TAPS || AK == A_I8) ? gemm_grid(a.M, bw8) : gemm_grid(a.M, bw);
  step_gemm_kernel<AK, EPI><<<grid, GM_THREADS, 0, s>>>(a, bw, bw8, e);
}

TapA matrix_a(const void* src, int M, int K, float scale = 1.0f) {
  return TapA{src, K, M, M, K, K, 0, 0, nullptr, scale, nullptr};
}

// Operands of one denoiser forward (both entry points).
struct Forward {
  const float* x_in;          // f32 [B*T, mp], mel padded with zeros
  bf16* h;                    // scratch bf16 [B*T, C]
  float* skip;                // scratch f32 [B*T, C]
  void* g;                    // scratch [B*T, C]: bf16, or int8 in "int8" mode
  bf16* s1;                   // scratch bf16 [B*T, C]
  const bf16* step_rows_t;    // [L, C] this step's rows
  const void* w1;             // [L, 3C, 2C] bf16, or int8 when w1s != null
  const bf16* condb;          // [L, B*T, 2C]
  const void* wout;           // [L, C, 2C] bf16, or int8 when wouts != null
  const bf16* bout;           // [L, 2C]
  const bf16 *wmel, *bmel, *wskip, *bskip, *wo, *bo;
  const float* w1s;           // [L, 2C] or null
  const float* wouts;         // [L, 2C] or null
  float* amax;                // [L, B] scratch when w1s != null
  int B, T, C, L, cycle, mp;
};

// Prologue, the L layers and the skip projection: s1 is then ready for the
// output projection.
void run_body(const Forward& f, cudaStream_t st) {
  const int M = f.B * f.T;
  const int C = f.C;
  const bool q1 = f.w1s != nullptr;
  const bool q2 = f.wouts != nullptr;
  if (q1) cudaMemsetAsync(f.amax, 0, sizeof(float) * f.L * f.B, st);

  StepEpi pro{};
  pro.out = f.h; pro.ldo = C; pro.bias = f.bmel; pro.zero_f32 = f.skip; pro.T = f.T;
  if (q1) { pro.amax_out = f.amax; pro.next_row = f.step_rows_t; }
  launch<A_F32, EPI_RELU>(matrix_a(f.x_in, M, f.mp), ColsB{f.wmel, C, C, 0}, ColsB8{}, pro, st);

  for (int l = 0; l < f.L; ++l) {
    const int d = 1 << (l % f.cycle);
    const size_t w1_off = (size_t)l * 3 * C * 2 * C;
    const size_t wout_off = (size_t)l * C * 2 * C;
    const TapA taps{f.h, C, M, f.T, 3 * C, C, d, d, f.step_rows_t + (size_t)l * C, 1.0f,
                    q1 ? f.amax + (size_t)l * f.B : nullptr};
    StepEpi ge{};
    ge.out = f.g; ge.ldo = C; ge.cond = f.condb + (size_t)l * M * 2 * C; ge.T = f.T;
    if (q1) {
      ge.col_scale = f.w1s + (size_t)l * 2 * C; ge.amax_in = taps.amax; ge.gate_i8 = q2;
      launch<A_Q8_TAPS, EPI_GATE>(taps, ColsB{},
                                  ColsB8{static_cast<const int8_t*>(f.w1) + w1_off, 2 * C, 2 * C, C}, ge, st);
    } else {
      launch<A_BF16, EPI_GATE>(taps, ColsB{static_cast<const bf16*>(f.w1) + w1_off, 2 * C, 2 * C, C},
                               ColsB8{}, ge, st);
    }

    StepEpi re{};
    re.out = f.h; re.ldo = C; re.bias = f.bout + (size_t)l * 2 * C; re.skip = f.skip; re.T = f.T;
    if (q1 && l + 1 < f.L) {
      re.amax_out = f.amax + (size_t)(l + 1) * f.B;
      re.next_row = f.step_rows_t + (size_t)(l + 1) * C;
    }
    if (q2) {
      re.col_scale = f.wouts + (size_t)l * 2 * C;
      launch<A_I8, EPI_RESSKIP>(matrix_a(f.g, M, C), ColsB{},
                                ColsB8{static_cast<const int8_t*>(f.wout) + wout_off, 2 * C, 2 * C, C}, re, st);
    } else {
      launch<A_BF16, EPI_RESSKIP>(matrix_a(f.g, M, C),
                                  ColsB{static_cast<const bf16*>(f.wout) + wout_off, 2 * C, 2 * C, C},
                                  ColsB8{}, re, st);
    }
  }

  StepEpi sk{};
  sk.out = f.s1; sk.ldo = C; sk.bias = f.bskip;
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)f.L));
  launch<A_F32, EPI_RELU>(matrix_a(f.skip, M, C, inv_sqrt_l), ColsB{f.wskip, C, C, 0}, ColsB8{}, sk, st);
}

}  // namespace
}  // namespace svc

using svc::bf16;

#define SVC_FORWARD_PARAMS                                                                      \
  bf16 *h, float *skip, void *g, bf16 *s1, const bf16 *step_rows_t, const void *w1,            \
      const bf16 *condb, const void *wout, const bf16 *bout, const bf16 *wmel, const bf16 *bmel, \
      const bf16 *wskip, const bf16 *bskip, const bf16 *wo, const bf16 *bo, const float *w1s,   \
      const float *wouts, float *amax, int B, int T, int C, int L, int cycle, int mp

#define SVC_FORWARD(x_in)                                                                    \
  svc::Forward {                                                                             \
    x_in, h, skip, g, s1, step_rows_t, w1, condb, wout, bout, wmel, bmel, wskip, bskip, wo, bo, \
        w1s, wouts, amax, B, T, C, L, cycle, mp                                              \
  }

// K1 (K6 on an int8 stack). x_in/x_out/z: f32 [B*T, mp]; h, s1: bf16
// [B*T, C] scratch; g: [B*T, C] bf16-sized scratch; skip: f32 [B*T, C]
// scratch; step_rows_t: bf16 [L, C] (this step's rows); w1: [L, 3C, 2C]
// tap-major, bf16 or int8 (then w1s f32 [L, 2C] and amax f32 [L, B]
// scratch); condb: bf16 [L, B*T, 2C]; wout: [L, C, 2C] bf16 or int8 (then
// wouts f32 [L, 2C]); bout: bf16 [L, 2C]; wmel [mp, C], bmel [C], wskip
// [C, C], bskip [C], wo [C, mp], bo [mp], all bf16. s0..s4: this step's
// schedule scalars.
extern "C" int svc_ddpm_step(const float* x_in, const float* z, float* x_out, SVC_FORWARD_PARAMS,
                             float s0, float s1c, float s2, float s3, float s4, void* stream) {
  using namespace svc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Forward f = SVC_FORWARD(x_in);
  run_body(f, st);
  StepEpi dd{};
  dd.out = x_out; dd.ldo = mp; dd.bias = bo; dd.x = x_in; dd.z = z;
  dd.s0 = s0; dd.s1 = s1c; dd.s2 = s2; dd.s3 = s3; dd.s4 = s4;
  launch<A_BF16, EPI_DDPM>(matrix_a(s1, B * T, C), ColsB{wo, mp, mp, 0}, ColsB8{}, dd, st);
  return (int)cudaGetLastError();
}

// K5 (K6 on an int8 stack): the same forward, storing eps f32 [B*T, n_mel]
// from the padded f32 input x_in [B*T, mp].
extern "C" int svc_denoise(const float* x_in, float* eps, SVC_FORWARD_PARAMS, int n_mel,
                           void* stream) {
  using namespace svc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Forward f = SVC_FORWARD(x_in);
  run_body(f, st);
  StepEpi ee{};
  ee.out = eps; ee.ldo = n_mel; ee.bias = bo; ee.n_out = n_mel;
  launch<A_BF16, EPI_EPS>(matrix_a(s1, B * T, C), ColsB{wo, mp, mp, 0}, ColsB8{}, ee, st);
  return (int)cudaGetLastError();
}
