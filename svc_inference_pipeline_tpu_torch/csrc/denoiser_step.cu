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
// What bounds it here: ~18 GFLOP per call at T=384, C=384, L=20 (18 us at
//   the tensor cores' peak), but at batch 1 a launch has 72 output tiles of
//   64 x 64 for 132 SMs, so each tile's serial K loop sets the time. The
//   activations (h [T,C] bf16, skip [T,C] f32: ~0.9 MB at T=384) stay in the
//   50 MB L2 between launches. 227 KB of shared memory cannot hold a
//   sequential layer loop over the whole clip, and CUDA blocks do not run in
//   order, so the TPU's single resident kernel does not carry over.
//
// Design: 2 + 2L launches per call, each one GEMM tile with its own fused
//   epilogue:
//   1. prologue: h = relu(bf16(x) @ wmel + bmel), skip = 0;
//   2. per layer: gate g = sigmoid . tanh of (taps(y) @ w1 + cond_block);
//      then (h + yo_res)/sqrt2 and skip += yo_skip from g @ wout + bout;
//   3. skip projection: s1 = relu(bf16(skip/sqrt L) @ wskip + bskip);
//   4. output projection with either the DDPM update
//      x0 = clamp(s0 x - s1 eps, +-1); x' = s2 x0 + s3 x + s4 z (K1),
//      or the store of eps = acc + bo in f32 for the n_mel columns (K5).
//   Numerics follow the TPU kernel: bf16 operands, f32 accumulation, f32
//   gates, f32 skip, h stored bf16, f32 carry x, sigma (s4) = 0 at t = 0.
//
// The bf16 launches run on the pipelined wgmma tile (gemm_wg.cuh): a
//   4-stage cp.async ring with K in chunks of 64. Row tiles go per clip
//   (b, 64-row t tile) and never straddle two clips.
//   - The conv input is ready to copy: the epilogue that writes h (the
//     prologue for layer 0, the residual epilogue of layer l for layer l+1)
//     also writes y = bf16(h + step_row[l+1]) into a [B, T + 2*halo, C]
//     buffer whose halo rows (halo = 2^(cycle-1), the largest dilation) are
//     zero: the prologue's blocks at a clip's first and last row tile write
//     the zeros of their columns, so the buffer needs no fill of its own.
//     Tap m of the gate is then the 64-row box at row t0 + (m-1)*d of the
//     clip's rows: a pure cp.async source, with no gather arithmetic.
//   - The gate is split over its 3 taps in a thread-block cluster of 3: each
//     block multiplies one tap (K = C), the three f32 partial tiles are summed
//     through distributed shared memory in the fixed order tap 0 + tap 1 +
//     tap 2 (no atomics: the same bits on every run, and a clip's rows never
//     depend on another clip's), and each block runs the gated epilogue on a
//     third of the rows. At T = 384 that is 216 blocks instead of 72.
//   - Programmatic dependent launch between the launches. The rule every
//     kernel here follows: it issues only its weight loads (B, which no
//     launch writes) before grid_dependency_wait(); it reads and writes h, y,
//     g, skip, s1, the amax buffer and the carry x only after it. No kernel
//     triggers its dependents early: the next launch's blocks start as this
//     launch's blocks exit, put their first weight chunks in flight and wait.
//     An explicit trigger, at a kernel's start or right after its wait, made
//     the int8 steps slower on an H100 than no PDL at all: chains of waiting
//     launches took the SMs from the kernel they waited for.
//
// int8 (K6): the conv input y = h + step_row is quantised in f32, not first
//   rounded to bf16, with s_y = max(max|y|, 1e-12)/127 per batch element (the
//   TPU grid's outer axis is batch). s_y needs the max over the element's
//   [T, C] before the gate GEMM reads it: the epilogue that writes h (the
//   prologue for layer 0, the residual epilogue of layer l for layer l+1)
//   folds |bf16(h) + step_row[l+1]| into a zeroed [L, B] buffer with one
//   atomicMax on the float bits per warp and batch element. The gate GEMM
//   (the int8 tile of gemm_tile.cuh, which gathers and quantises its taps
//   from h) scales its int32 sums by (s_y * w1s[col]); in "int8" mode its
//   epilogue stores the gate as rint(g * 127) in int8 and the residual GEMM
//   runs on int8 too, scaled by (wouts[col] * (1/127)). The other launches
//   of the int8 modes are bf16 and take the pipelined tile. The dequantising
//   epilogues use round-to-nearest intrinsics without contraction, as the
//   plain version computes them. The int8 sums are exact (|sum| <= 3C * 127^2
//   < 2^31), and the int32 -> f32 conversion rounds to nearest as the plain
//   version's float64 -> f32 does.
#include <cooperative_groups.h>

#include "gemm_tile.cuh"
#include "gemm_wg.cuh"

namespace svc {
namespace {

namespace cg = cooperative_groups;

enum Epilogue { EPI_RELU = 0, EPI_GATE = 1, EPI_RESSKIP = 2, EPI_DDPM = 3, EPI_EPS = 4 };
enum AKind { A_Q8_TAPS = 0, A_I8 = 1 };

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
  const bf16* next_row;  // the next layer's step row [C] (for y_out or amax_out)
  bf16* y_out;           // RELU/RESSKIP, bf16 mode: [B, T + 2*halo, ldo] next conv input, or null
  int halo;
  // int8 (K6)
  const float* col_scale;  // int8 GEMM: w1s (GATE) or wouts (RESSKIP) [2C]
  const float* amax_in;    // GATE on int8 taps: [B] abs max of this layer's conv input
  bool gate_i8;            // GATE: store g as int8 rint(g * 127)
  float* amax_out;         // RELU/RESSKIP: [B] abs max of h + next_row, or null
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

// What the epilogue that writes h also writes for the next layer: y to the
// bf16 conv-input buffer, or |y| to the int8 scale's running max.
__device__ __forceinline__ void next_input(const StepEpi& e, RowMax& rowmax, int r, int c, bf16 hv) {
  if (e.y_out == nullptr && e.amax_out == nullptr) return;
  const int b = r / e.T;
  const float y = __bfloat162float(hv) + __bfloat162float(e.next_row[c]);
  if (e.y_out != nullptr) {
    e.y_out[((size_t)b * (e.T + 2 * e.halo) + e.halo + (r - b * e.T)) * e.ldo + c] = __float2bfloat16(y);
  } else {
    rowmax.add(b, fabsf(y), e.amax_out);
  }
}

// The fused epilogues over tile rows [i_lo, i_hi) of the 64 x 64 result
// acc(i, j) (f32, or the bits of an int32 sum when INT8), whose row i is
// global row r0 + i; rows at or past nvalid are skipped. Lanes of a warp
// share a row (the loops step by whole rows per warp), so the skip is
// warp-uniform.
template <bool INT8, int EPI, typename Acc>
__device__ __forceinline__ void epilogue(const StepEpi& e, Acc acc, int r0, int nvalid, int bx, int C,
                                         int N, int i_lo, int i_hi) {
  RowMax rowmax;
  if constexpr (EPI == EPI_GATE || EPI == EPI_RESSKIP) {
    for (int idx = i_lo * 32 + threadIdx.x; idx < i_hi * 32; idx += GM_THREADS) {
      const int i = idx >> 5;
      const int j = idx & 31;
      if (i >= nvalid) continue;
      const int r = r0 + i;
      const int c = bx * 32 + j;
      float lo = acc(i, j);
      float hi = acc(i, j + 32);
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
        next_input(e, rowmax, r, c, hn);
      }
    }
  } else {
    for (int idx = i_lo * 64 + threadIdx.x; idx < i_hi * 64; idx += GM_THREADS) {
      const int i = idx >> 6;
      const int j = idx & 63;
      const int col = bx * GM_BN + j;
      if (i >= nvalid || col >= N) continue;  // warp-uniform for the N used here (multiples of 64)
      const int r = r0 + i;
      const size_t o = (size_t)r * e.ldo + col;
      const float v = acc(i, j) + __bfloat162float(e.bias[col]);
      if constexpr (EPI == EPI_RELU) {
        const bf16 hv = __float2bfloat16(fmaxf(v, 0.0f));
        static_cast<bf16*>(e.out)[o] = hv;
        if (e.zero_f32 != nullptr) e.zero_f32[o] = 0.0f;
        next_input(e, rowmax, r, col, hv);
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

// --- int8 launches (K6's gate, and "int8" mode's residual): the WMMA s8 tile
// over global 64-row tiles, gathering and quantising the conv taps from h.
template <int AK, int EPI>
__global__ void __launch_bounds__(GM_THREADS) step_gemm_s8_kernel(const TapA a, const ColsB8 bw8,
                                                                 const StepEpi e) {
  __shared__ __align__(32) float Cs[GM_BM][GM_LDC];
  __shared__ __align__(32) int8_t As[G8_BK / 16][GM_BM][16];
  __shared__ __align__(32) int8_t Bs[GM_BN / 16][G8_BK][16];
  grid_dependency_wait();
  const int m0 = blockIdx.x * GM_BM;
  gemm_tile_s8<AK == A_Q8_TAPS>(a, bw8, m0, blockIdx.y, As, Bs, reinterpret_cast<int (*)[GM_LDC]>(Cs));
  epilogue<true, EPI>(e, [&](int i, int j) { return Cs[i][j]; }, m0, min(GM_BM, a.M - m0), blockIdx.y,
                      bw8.half, bw8.N, 0, GM_BM);
}

// --- bf16 launches: the pipelined wgmma tile over per-clip row tiles.
struct WgOp {
  const void* a;  // bf16 (f32 when A_F32) rows [B, T + 2*halo, lda] (halo = 0: [B*T, lda])
  int lda, halo;
  int dil;        // SPLIT (the gate): tap m reads rows shifted by (m - 1) * dil
  const bf16* w;  // [K, ldw], or [3K, ldw] tap-major when SPLIT
  int ldw, half, N, K;
  float scale;    // f32 A: multiplied before rounding
};

template <bool A_F32, int EPI, bool SPLIT>
__global__ void __launch_bounds__(WG_THREADS) step_gemm_wg_kernel(const WgOp op, const StepEpi e) {
  extern __shared__ uint8_t wg_smem[];
  uint8_t* ring = align1024(wg_smem);
  const int tap = SPLIT ? (int)(blockIdx.x % 3) : 0;  // == the block's rank in its cluster of 3
  const int tile = SPLIT ? blockIdx.x / 3 : blockIdx.x;
  const int tpc = cdiv(e.T, WG_BM);
  const int b = tile / tpc;
  const int t0 = (tile - b * tpc) * WG_BM;
  const int nvalid = min(WG_BM, e.T - t0);
  const int bx = blockIdx.y;
  const long arow = (long)b * (e.T + 2 * op.halo) + op.halo + t0 + (SPLIT ? (tap - 1) * op.dil : 0);
  const WgA a{A_F32 ? static_cast<const void*>(static_cast<const float*>(op.a) + arow * op.lda)
                    : static_cast<const void*>(static_cast<const bf16*>(op.a) + arow * op.lda),
              op.lda, nvalid, op.scale};
  const WgB bw{op.w + (size_t)tap * op.K * op.ldw, op.ldw, op.half > 0 ? bx * 32 : bx * WG_BN,
               op.half > 0 ? op.half + bx * 32 : bx * WG_BN + 32};
  const float* Cs = wg_gemm<A_F32>(a, bw, op.K, ring);
  const int r0 = b * e.T + t0;
  const int C = op.half;
  if constexpr (SPLIT) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // the three partial tiles are complete
    const float* p0 = cluster.map_shared_rank(Cs, 0);
    const float* p1 = cluster.map_shared_rank(Cs, 1);
    const float* p2 = cluster.map_shared_rank(Cs, 2);
    const int rows = cdiv(WG_BM, 3);
    epilogue<false, EPI>(
        e, [&](int i, int j) { return (p0[i * WG_LDC + j] + p1[i * WG_LDC + j]) + p2[i * WG_LDC + j]; },
        r0, nvalid, bx, C, op.N, tap * rows, min(WG_BM, (tap + 1) * rows));
    cluster.sync();  // no block leaves while another still reads its tile
  } else {
    epilogue<false, EPI>(e, [&](int i, int j) { return Cs[i * WG_LDC + j]; }, r0, nvalid, bx, C, op.N, 0,
                         WG_BM);
  }
  if constexpr (EPI == EPI_RELU) {
    // the prologue: the halo rows of y above a clip's first tile and below
    // its last, for this block's 64 columns
    if (e.y_out != nullptr && (t0 == 0 || t0 + WG_BM >= e.T)) {
      bf16* clip = e.y_out + (size_t)b * (e.T + 2 * e.halo) * e.ldo + bx * WG_BN;
      const bf16 zero = __float2bfloat16(0.0f);
      for (int idx = threadIdx.x; idx < e.halo * WG_BN; idx += WG_THREADS) {
        const int i = idx / WG_BN;
        const int j = idx % WG_BN;
        if (t0 == 0) clip[(size_t)i * e.ldo + j] = zero;
        if (t0 + WG_BM >= e.T) clip[(size_t)(e.halo + e.T + i) * e.ldo + j] = zero;
      }
    }
  }
}

// Launch with programmatic stream serialization (and a cluster of 3 for the
// split gate).
template <typename... Params, typename... Args>
void launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block, int smem, int cluster_x, cudaStream_t s,
               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[0].val.programmaticStreamSerializationAllowed = 1;
  int n = 1;
  if (cluster_x > 1) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = cluster_x;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <bool A_F32, int EPI, bool SPLIT = false>
void launch_wg(const WgOp& op, const StepEpi& e, int B, cudaStream_t s) {
  auto kernel = step_gemm_wg_kernel<A_F32, EPI, SPLIT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM_BYTES);
  (void)attr;  // a refusal shows as the launch's error
  const int ny = op.half > 0 ? op.half / 32 : op.N / WG_BN;
  const dim3 grid((SPLIT ? 3 : 1) * B * cdiv(e.T, WG_BM), ny);
  launch_ex(kernel, grid, dim3(WG_THREADS), WG_SMEM_BYTES, SPLIT ? 3 : 1, s, op, e);
}

template <int AK, int EPI>
void launch_s8(const TapA& a, const ColsB8& bw8, const StepEpi& e, cudaStream_t s) {
  launch_ex(step_gemm_s8_kernel<AK, EPI>, gemm_grid(a.M, bw8), dim3(GM_THREADS), 0, 1, s, a, bw8, e);
}

TapA matrix_a(const void* src, int M, int K) { return TapA{src, K, M, M, K, K, 0, 0, nullptr, 1.0f, nullptr}; }

WgOp plain_op(const void* a, int lda, const bf16* w, int ldw, int half, int N, int K, float scale = 1.0f) {
  return WgOp{a, lda, 0, 0, w, ldw, half, N, K, scale};
}

// Operands of one denoiser forward (both entry points).
struct Forward {
  const float* x_in;          // f32 [B*T, mp], mel padded with zeros
  bf16* h;                    // scratch bf16 [B*T, C]
  float* skip;                // scratch f32 [B*T, C]
  void* g;                    // scratch [B*T, C]: bf16, or int8 in "int8" mode
  bf16* s1;                   // scratch bf16 [B*T, C]
  bf16* y;                    // bf16 stack: scratch [B, T + 2*halo, C], halo rows zero; else null
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
  const int halo = 1 << (f.cycle - 1);
  if (q1) cudaMemsetAsync(f.amax, 0, sizeof(float) * f.L * f.B, st);

  // what the epilogue that writes h passes on to layer l's gate
  auto feed = [&](StepEpi& e, int l) {
    e.next_row = f.step_rows_t + (size_t)l * C;
    if (q1) {
      e.amax_out = f.amax + (size_t)l * f.B;
    } else {
      e.y_out = f.y;
      e.halo = halo;
    }
  };

  StepEpi pro{};
  pro.out = f.h; pro.ldo = C; pro.bias = f.bmel; pro.zero_f32 = f.skip; pro.T = f.T;
  feed(pro, 0);
  launch_wg<true, EPI_RELU>(plain_op(f.x_in, f.mp, f.wmel, C, 0, C, f.mp), pro, f.B, st);

  for (int l = 0; l < f.L; ++l) {
    const int d = 1 << (l % f.cycle);
    const size_t w1_off = (size_t)l * 3 * C * 2 * C;
    const size_t wout_off = (size_t)l * C * 2 * C;
    StepEpi ge{};
    ge.out = f.g; ge.ldo = C; ge.cond = f.condb + (size_t)l * M * 2 * C; ge.T = f.T;
    if (q1) {
      const TapA taps{f.h, C, M, f.T, 3 * C, C, d, d, f.step_rows_t + (size_t)l * C, 1.0f,
                      f.amax + (size_t)l * f.B};
      ge.col_scale = f.w1s + (size_t)l * 2 * C; ge.amax_in = taps.amax; ge.gate_i8 = q2;
      launch_s8<A_Q8_TAPS, EPI_GATE>(taps, ColsB8{static_cast<const int8_t*>(f.w1) + w1_off, 2 * C, 2 * C, C},
                                     ge, st);
    } else {
      const WgOp gate{f.y, C, halo, d, static_cast<const bf16*>(f.w1) + w1_off, 2 * C, C, 2 * C, C, 1.0f};
      launch_wg<false, EPI_GATE, true>(gate, ge, f.B, st);
    }

    StepEpi re{};
    re.out = f.h; re.ldo = C; re.bias = f.bout + (size_t)l * 2 * C; re.skip = f.skip; re.T = f.T;
    if (l + 1 < f.L) feed(re, l + 1);
    if (q2) {
      re.col_scale = f.wouts + (size_t)l * 2 * C;
      launch_s8<A_I8, EPI_RESSKIP>(matrix_a(f.g, M, C),
                                   ColsB8{static_cast<const int8_t*>(f.wout) + wout_off, 2 * C, 2 * C, C}, re, st);
    } else {
      launch_wg<false, EPI_RESSKIP>(
          plain_op(f.g, C, static_cast<const bf16*>(f.wout) + wout_off, 2 * C, C, 2 * C, C), re, f.B, st);
    }
  }

  StepEpi sk{};
  sk.out = f.s1; sk.ldo = C; sk.bias = f.bskip; sk.T = f.T;
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)f.L));
  launch_wg<true, EPI_RELU>(plain_op(f.skip, C, f.wskip, C, 0, C, C, inv_sqrt_l), sk, f.B, st);
}

}  // namespace
}  // namespace svc

using svc::bf16;

#define SVC_FORWARD_PARAMS                                                                       \
  bf16 *h, float *skip, void *g, bf16 *s1, bf16 *y, const bf16 *step_rows_t, const void *w1,      \
      const bf16 *condb, const void *wout, const bf16 *bout, const bf16 *wmel, const bf16 *bmel,  \
      const bf16 *wskip, const bf16 *bskip, const bf16 *wo, const bf16 *bo, const float *w1s,    \
      const float *wouts, float *amax, int B, int T, int C, int L, int cycle, int mp

#define SVC_FORWARD(x_in)                                                                        \
  svc::Forward {                                                                                 \
    x_in, h, skip, g, s1, y, step_rows_t, w1, condb, wout, bout, wmel, bmel, wskip, bskip, wo, bo, \
        w1s, wouts, amax, B, T, C, L, cycle, mp                                                  \
  }

// K1 (K6 on an int8 stack). x_in/x_out/z: f32 [B*T, mp]; h, s1: bf16
// [B*T, C] scratch; g: [B*T, C] bf16-sized scratch; skip: f32 [B*T, C]
// scratch; y: bf16 [B, T + 2*2^(cycle-1), C] scratch with zero halo rows
// (bf16 stack; null on an int8 stack); step_rows_t: bf16 [L, C] (this step's
// rows); w1: [L, 3C, 2C] tap-major, bf16 or int8 (then w1s f32 [L, 2C] and
// amax f32 [L, B] scratch); condb: bf16 [L, B*T, 2C]; wout: [L, C, 2C] bf16
// or int8 (then wouts f32 [L, 2C]); bout: bf16 [L, 2C]; wmel [mp, C], bmel
// [C], wskip [C, C], bskip [C], wo [C, mp], bo [mp], all bf16. C and mp are
// multiples of 64. s0..s4: this step's schedule scalars.
extern "C" int svc_ddpm_step(const float* x_in, const float* z, float* x_out, SVC_FORWARD_PARAMS,
                             float s0, float s1c, float s2, float s3, float s4, void* stream) {
  using namespace svc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Forward f = SVC_FORWARD(x_in);
  run_body(f, st);
  StepEpi dd{};
  dd.out = x_out; dd.ldo = mp; dd.bias = bo; dd.x = x_in; dd.z = z; dd.T = T;
  dd.s0 = s0; dd.s1 = s1c; dd.s2 = s2; dd.s3 = s3; dd.s4 = s4;
  launch_wg<false, EPI_DDPM>(plain_op(s1, C, wo, mp, 0, mp, C), dd, B, st);
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
  ee.out = eps; ee.ldo = n_mel; ee.bias = bo; ee.n_out = n_mel; ee.T = T;
  launch_wg<false, EPI_EPS>(plain_op(s1, C, wo, mp, 0, mp, C), ee, B, st);
  return (int)cudaGetLastError();
}
