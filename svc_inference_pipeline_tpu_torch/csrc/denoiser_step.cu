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
//   the tensor cores' peak), but at batch 1 a layer has 6-15 row tiles of 64
//   rows for 132 SMs, so one block's path, from its start to its last store,
//   sets a launch's time, and a call is a chain of dependent launches. On an
//   H100 a global load right after a dependent-launch wait takes microseconds
//   (an epilogue reading its operands then took 3-15 us a launch), a block's
//   chunk loop pays ~0.6 us a chunk in its own latency where one warpgroup
//   runs on an SM, and each grid-wide dependency costs what a launch does
//   (K8, one cooperative launch with grid barriers, is no faster). The
//   activations (h [T,C] bf16, skip [T,C] f32: ~2.2 MB at T = 960) stay in the
//   50 MB L2 between launches.
//
// Design on a bf16 stack (K1, K5): L + 3 launches per call:
//   1. prologue: h = relu(bf16(x) @ wmel + bmel), skip = 0, and y_0 =
//      bf16(h + step_row[0]) into the conv-input buffer;
//   2. per layer, one launch (step_layer_kernel): the gate g = sigmoid . tanh
//      of (taps(y) @ w1 + cond_block), then (h + yo_res)/sqrt2, skip +=
//      yo_skip from g @ wout + bout, and y for the next layer;
//   3. skip projection: s1 = relu(bf16(skip/sqrt L) @ wskip + bskip);
//   4. output projection with either the DDPM update
//      x0 = clamp(s0 x - s1 eps, +-1); x' = s2 x0 + s3 x + s4 z (K1),
//      or the store of eps = acc + bo in f32 for the n_mel columns (K5).
//   Numerics follow the TPU kernel: bf16 operands, f32 accumulation, f32
//   gates, f32 skip, h stored bf16, f32 carry x, sigma (s4) = 0 at t = 0.
//   Row tiles go per clip (b, 64-row t tile) and never straddle two clips.
//   - The conv input is ready to copy: the epilogue that writes h also
//     writes y = bf16(h + step_row[l+1]) into one of two [B, T + 2*halo, C]
//     buffers by layer parity (layer l reads buffer l % 2, so no launch
//     overwrites rows that its neighbouring tiles still read), whose halo
//     rows (halo = 2^(cycle-1), the largest dilation) are zero: the
//     prologue's blocks at a clip's first and last row tile write the zeros
//     of their columns in both, so the buffers need no fill of their own.
//     Tap m of the gate is then the 64-row box at row t0 + (m-1)*d of the
//     clip's rows, a TMA box with no gather arithmetic.
//   - The layer launch (below, at step_layer_kernel) is a cluster of C/64
//     blocks a row tile: a block's three warpgroups multiply the three taps
//     side by side for its 64 gate and 64 filter columns, sum them in the
//     order tap 0 + tap 1 + tap 2 (no atomics: the same bits on every run,
//     and a clip's rows never depend on another clip's), run the gated
//     epilogue, and exchange g through distributed shared memory; the
//     residual GEMM then runs from it, so g never goes to device memory, and
//     the gate -> residual dependency stays inside the cluster. Each tap is
//     summed over its chunks in order from zero and the taps as (p0 + p1) +
//     p2, each residual sum over its chunks in order, with the epilogues'
//     roundings unchanged: K1 and K5 keep the bits of
//     tests/data/k1_k5_sha256.json.
//   - The prologue and the two projections run on the prefetching tile: the
//     whole K of A resident in shared memory, B's first three chunks of 64 in
//     shared memory and the rest in registers (PfNarrow, C and M_pad <= 384;
//     PfWide to 512), the epilogue from the wgmma accumulator registers.
//   - Programmatic dependent launch between the launches, and the rule for
//     what a launch may read before grid_dependency_wait(): anything that the
//     launch just before it does not write. Launch N's blocks start only when
//     every block of launch N-1 has triggered its dependents or exited, and
//     every one of those blocks triggers, if at all, after it has returned
//     from its own wait on launch N-2; so whatever launch N-2 or an earlier
//     one wrote is complete and visible when launch N starts. Each bf16
//     launch therefore puts in flight before its wait its weights (the layer:
//     its rings' first chunks and the residual's), its biases and step rows,
//     the layer's conditioner tile, and the DDPM update's x and z tiles
//     (written before the step began). After the wait it loads only what the
//     launch just before wrote: y's tap boxes, h and skip for the layer, skip
//     for the skip projection, s1 for the output projection; the prologue
//     loads x and its step row there, because the first launch of a call
//     follows whatever the caller ran last. Weights and biases belong to the
//     stack, which the caller makes before the call and no launch writes. The
//     early loads read through L2 (ld.global.cg or TMA), past the SMs'
//     incoherent L1. A launch whose blocks (the layer: clusters) are all
//     resident at once triggers its dependents right after its wait, so that
//     their blocks start and put their loads in flight while it runs; any
//     other launch of more than one wave triggers nothing: waiting blocks of
//     the next launch must not take the SMs from the launch they wait for
//     (an explicit trigger at a kernel's start or right after its wait made
//     the int8 steps, whose gate takes several waves, slower on an H100 than
//     no PDL at all; K6 triggers nothing). The layer's clusters never exceed
//     those resident: where the row tiles do, each cluster walks several.
//
// int8 (K6): the conv input y = h + step_row is quantised in f32, not first
//   rounded to bf16, with s_y = max(max|y|, 1e-12)/127 per batch element (the
//   TPU grid's outer axis is batch). s_y needs the max over the element's
//   [T, C] before the gate GEMM reads it: the epilogue that writes h (the
//   prologue for layer 0, the residual epilogue of layer l for layer l+1)
//   folds |bf16(h) + step_row[l+1]| into a zeroed [L, B] buffer with one
//   atomicMax on the float bits per warp and batch element. That max is
//   complete only when every block of that launch has folded its share, so
//   the taps cannot be quantised by the epilogue that writes h.
//   The int8 GEMMs run on the wgmma s8 tile (gemm_wg_s8.cuh), whose operands
//   are K-major: the stack carries K-major copies of the int8 weights
//   (w1 as [L, 3, 2C, C], wout as [L, 2C, C]).
//   - The gate is split over its 3 taps, in a cluster of 3 taps x 2 column
//     tiles. Each block issues its tap's weight chunks,
//     waits for the launch before and reads s_y of its clip. The three taps'
//     64-row boxes of y = h + step_row overlap: together they are the clip's
//     rows [t0 - d, t0 + 64 + d). The cluster's six blocks quantise that
//     union once, each an interleaved share, and store every quantised row
//     through distributed shared memory into the resident K-major int8 tile
//     (the whole K = C) of each block whose tap box holds it; rows outside
//     the clip are 0, since the conv pads the quantised input. Quantising
//     per block instead repeats the work 12x over the column tiles and
//     ~2.7x over the taps: on an H100 an int8 step at T = 384 took
//     0.61 ms that way and takes 0.54 ms this way (0.91 and 0.81 at T = 960).
//     The three int32 partials are summed in int32 through distributed
//     shared memory (exact, so the same bits in any order) and scaled once
//     by (s_y * w1s[col]): one rounding of the exact sum, as the plain
//     version. In "int8" mode the gated epilogue stores rint(g * 127) in
//     int8.
//   - "int8" mode's residual reads that int8 g by cp.async and scales its
//     int32 sums by (wouts[col] * (1/127)).
//   The other launches of the int8 modes are bf16 and take gemm_wg.cuh's
//   ring tile (wg_gemm: only the weights before the wait, the result through
//   shared memory) with the epilogue below, as every K6 launch does: the
//   int8 gate reads an abs max that the launch just before it completes.
//   The dequantising epilogues use round-to-nearest intrinsics without
//   contraction, as the plain version computes them. The int8 sums are exact
//   (|sum| <= 3C * 127^2 < 2^31), and the int32 -> f32 conversion rounds to
//   nearest as the plain version's float64 -> f32 does.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its encoder's types (the encoder is fetched at run time)

#include <algorithm>

#include "gemm_wg.cuh"
#include "gemm_wg_s8.cuh"

namespace svc {
namespace {

namespace cg = cooperative_groups;

enum Epilogue { EPI_RELU = 0, EPI_GATE = 1, EPI_RESSKIP = 2, EPI_DDPM = 3, EPI_EPS = 4 };

// s = max(amax, 1e-12) / 127, and q = clip(rint(v), -127, 127), as the TPU
// kernel and the plain version quantise
__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-12f), 1.0f / 127.0f);
}

__device__ __forceinline__ int8_t quant_i8(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

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
  bf16* y_out;           // RELU, bf16 mode: [B, T + 2*halo, ldo] layer 0's conv input, or null
  int halo;
  size_t y_parity;       // RELU, bf16 mode: elements from y_out to the other parity buffer (its halo zeroed too)
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

// What the epilogue that writes h also writes for the next layer on an int8
// stack: |y| to the int8 scale's running max.
__device__ __forceinline__ void next_input(const StepEpi& e, RowMax& rowmax, int r, int c, bf16 hv) {
  if (e.amax_out == nullptr) return;
  const float y = __bfloat162float(hv) + __bfloat162float(e.next_row[c]);
  rowmax.add(r / e.T, fabsf(y), e.amax_out);
}

// K6's fused epilogues over tile rows [i_lo, i_hi) of the 64 x 64 result
// acc(i, j) (f32, or an int32 sum when INT8), whose row i is
// global row r0 + i; rows at or past nvalid are skipped. Lanes of a warp
// share a row (the loops step by whole rows per warp), so the skip is
// warp-uniform.
template <bool INT8, int EPI, typename Acc>
__device__ __forceinline__ void epilogue(const StepEpi& e, Acc acc, int r0, int nvalid, int bx, int C,
                                         int N, int i_lo, int i_hi) {
  RowMax rowmax;
  if constexpr (EPI == EPI_GATE || EPI == EPI_RESSKIP) {
    for (int idx = i_lo * 32 + threadIdx.x; idx < i_hi * 32; idx += WG_THREADS) {
      const int i = idx >> 5;
      const int j = idx & 31;
      if (i >= nvalid) continue;
      const int r = r0 + i;
      const int c = bx * 32 + j;
      float lo, hi;
      if constexpr (INT8) {
        // s_y * w1s[col] (gate) or wouts[col] * (1/127) (residual), then acc * that
        const float rs = EPI == EPI_GATE ? quant_scale(e.amax_in[r / e.T]) : 1.0f / 127.0f;
        lo = __fmul_rn(__int2float_rn(acc(i, j)), __fmul_rn(rs, e.col_scale[c]));
        hi = __fmul_rn(__int2float_rn(acc(i, j + 32)), __fmul_rn(rs, e.col_scale[C + c]));
      } else {
        lo = acc(i, j);
        hi = acc(i, j + 32);
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
    for (int idx = i_lo * 64 + threadIdx.x; idx < i_hi * 64; idx += WG_THREADS) {
      const int i = idx >> 6;
      const int j = idx & 63;
      const int col = bx * WG_BN + j;
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

// The split gate's tap sum: each rank of the cluster of 3 sums the three
// partial tiles through distributed shared memory in one order (rank 0 + 1 +
// 2; no atomics, so the same bits on every run) for a third of the rows and
// runs the epilogue on them.
// The taps of a column tile are cluster ranks base + 0, 1, 2 (ranks run
// over the cluster's x first).
template <bool INT8, int EPI, typename Acc>
__device__ __forceinline__ void cluster_epilogue(const StepEpi& e, const Acc* part, int base, int tap, int r0,
                                                 int nvalid, int bx, int C, int N) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // the three partial tiles are complete
  const Acc* p0 = cluster.map_shared_rank(part, base);
  const Acc* p1 = cluster.map_shared_rank(part, base + 1);
  const Acc* p2 = cluster.map_shared_rank(part, base + 2);
  const int rows = cdiv(WG_BM, 3);
  epilogue<INT8, EPI>(
      e, [&](int i, int j) { return (p0[i * WG_LDC + j] + p1[i * WG_LDC + j]) + p2[i * WG_LDC + j]; }, r0,
      nvalid, bx, C, N, tap * rows, min(WG_BM, (tap + 1) * rows));
  cluster.sync();  // no block leaves while another still reads its tile
}

// --- K6's bf16 launches: gemm_wg.cuh's ring tile over per-clip row tiles.
struct WgOp {
  const void* a;  // bf16 (f32 when A_F32) rows [B*T, lda]
  int lda;
  const bf16* w;  // [K, ldw]
  int ldw, half, N, K;
  float scale;    // f32 A: multiplied before rounding
};

template <bool A_F32, int EPI>
__global__ void __launch_bounds__(WG_THREADS) step_gemm_wg_kernel(const WgOp op, const StepEpi e) {
  extern __shared__ uint8_t wg_smem[];
  uint8_t* ring = align1024(wg_smem);
  const int tile = blockIdx.x;
  const int tpc = cdiv(e.T, WG_BM);
  const int b = tile / tpc;
  const int t0 = (tile - b * tpc) * WG_BM;
  const int nvalid = min(WG_BM, e.T - t0);
  const int bx = blockIdx.y;
  const long arow = (long)b * e.T + t0;
  const WgA a{A_F32 ? static_cast<const void*>(static_cast<const float*>(op.a) + arow * op.lda)
                    : static_cast<const void*>(static_cast<const bf16*>(op.a) + arow * op.lda),
              op.lda, nvalid, op.scale};
  const WgB bw{op.w, op.ldw, op.half > 0 ? bx * 32 : bx * WG_BN, op.half > 0 ? op.half + bx * 32 : bx * WG_BN + 32};
  const float* Cs = wg_gemm<A_F32>(a, bw, op.K, ring);
  epilogue<false, EPI>(e, [&](int i, int j) { return Cs[i * WG_LDC + j]; }, b * e.T + t0, nvalid, bx, op.half,
                       op.N, 0, WG_BM);
}

// --- K1 and K5 (bf16 stacks): the prefetching tile. A block puts everything
// that the launch just before it does not write in flight, waits, loads that
// launch's output in one batch, multiplies, and runs its epilogue from the
// accumulator registers.
constexpr int PF_BS = 3;                            // B chunks in shared memory; the rest wait in registers
constexpr int PF_PIECES = WG_BM * 8 / WG_THREADS;   // 16-byte pieces of one chunk per thread
constexpr int PF_F32_BATCH = 3;                     // f32 A chunks loaded per round

// A tile's shape: the whole K, up to NK chunks of 64, resident in A tiles,
// the B chunks past the first PF_BS in registers, and its shared memory.
template <int NK_>
struct PfShape {
  static constexpr int NK = NK_;
  static constexpr int SMEM = (NK + PF_BS) * WG_TILE_BYTES + 1024;
};
// C, M_pad <= 384: 73 KB
using PfNarrow = PfShape<6>;
// C, M_pad <= 512: 89 KB. On an H100 (C = 512, L = 40, the residual layers
// then on this tile too) it beat K streamed past 384 through a 73 KB tile
// (A chunks 6-7 into the tiles of chunks 0-1, B chunks 6-7 reloaded into
// registers) at B = 2: 1.98-2.00 against 2.10-2.11 ms a step at T = 960
using PfWide = PfShape<8>;
constexpr int PF_NARROW_K = PfNarrow::NK * WG_BK;
constexpr int PF_MAX_K = PfWide::NK * WG_BK;

__device__ __forceinline__ uint32_t ldcg32(const void* p) { return __ldcg(static_cast<const unsigned int*>(p)); }
__device__ __forceinline__ float2 ldcg64(const float* p) { return __ldcg(reinterpret_cast<const float2*>(p)); }
// the two halves of two packed bf16, as f32 (a bf16's f32 value is its bits << 16)
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ void st32(void* p, uint32_t v) { *static_cast<uint32_t*>(p) = v; }
__device__ __forceinline__ void st64(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }

// This thread's fragments of the m64n64 accumulator: acc[4j + 2h + q] is
// tile row pf_row() + 8h, column 8j + pf_col() + q (j < 8, h, q < 2).
__device__ __forceinline__ int pf_row() { return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2); }
__device__ __forceinline__ int pf_col() { return 2 * (threadIdx.x & 3); }

__device__ __forceinline__ void cp_async_wait_upto(int n) {  // n: commit groups left in flight, < 8
  switch (n) {
    case 7: cp_async_wait<7>(); break;
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// B chunk kt's pieces of this thread (wg_load_b's) into registers, and from
// there into a stage
__device__ __forceinline__ void pf_load_b_regs(const WgB& bw, int kt, uint4 (&v)[PF_PIECES]) {
#pragma unroll
  for (int it = 0; it < PF_PIECES; ++it) {
    const int p = it * WG_THREADS + threadIdx.x;
    const int c = p & 7;
    const int col = c < 4 ? bw.col_lo + 8 * c : bw.col_hi + 8 * (c - 4);
    v[it] = __ldcg(reinterpret_cast<const uint4*>(bw.w + (size_t)(kt * WG_BK + (p >> 3)) * bw.ldw + col));
  }
}

__device__ __forceinline__ void pf_store_b(const uint4 (&v)[PF_PIECES], uint8_t* Bs) {
#pragma unroll
  for (int it = 0; it < PF_PIECES; ++it) {
    const int p = it * WG_THREADS + threadIdx.x;
    *reinterpret_cast<uint4*>(Bs + sw128(p >> 3, p & 7)) = v[it];
  }
}

// f32 A chunks k0 .. k0 + PF_F32_BATCH - 1 (those below nk), times a.scale and
// rounded to bf16, into their resident tiles: every load first, then the
// stores (wg_load_a<true>'s arithmetic)
__device__ __forceinline__ void pf_f32_chunks(const WgA& a, int k0, int nk, uint8_t* As) {
  float4 v[PF_F32_BATCH][PF_PIECES][2];
#pragma unroll
  for (int q = 0; q < PF_F32_BATCH; ++q)
#pragma unroll
    for (int it = 0; it < PF_PIECES; ++it) {
      const int p = it * WG_THREADS + threadIdx.x;
      v[q][it][0] = v[q][it][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k0 + q < nk && (p >> 3) < a.nvalid) {
        const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(a.row0) +
                                                            (size_t)(p >> 3) * a.ld + (k0 + q) * WG_BK + 8 * (p & 7));
        v[q][it][0] = __ldcg(src);
        v[q][it][1] = __ldcg(src + 1);
      }
    }
#pragma unroll
  for (int q = 0; q < PF_F32_BATCH; ++q)
#pragma unroll
    for (int it = 0; it < PF_PIECES; ++it) {
      const int p = it * WG_THREADS + threadIdx.x;
      const float4 x0 = v[q][it][0], x1 = v[q][it][1];
      const uint4 packed = make_uint4(pack_bf16x2(x0.x * a.scale, x0.y * a.scale),
                                      pack_bf16x2(x0.z * a.scale, x0.w * a.scale),
                                      pack_bf16x2(x1.x * a.scale, x1.y * a.scale),
                                      pack_bf16x2(x1.z * a.scale, x1.w * a.scale));
      if (k0 + q < nk) *reinterpret_cast<uint4*>(As + (k0 + q) * WG_TILE_BYTES + sw128(p >> 3, p & 7)) = packed;
    }
}

// Lets the launch after this one start its blocks (they then run up to their
// own grid_dependency_wait()).
__device__ __forceinline__ void grid_dependency_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

enum PfA { PF_A_BOX, PF_A_F32 };  // how load_a fills the A tiles

// acc = A @ B over K = 64 nk (nk <= S::NK), summed as wg_gemm_loop sums it:
// chunk by chunk, four k16 products a chunk. Before the wait: B's first PF_BS
// chunks by cp.async, the rest into registers. After it, load_a(As) puts
// every chunk of A into its own tile at once: PF_A_BOX by cp.async, one
// commit group a chunk; PF_A_F32 complete when load_a returns. With `early`
// the launch lets its dependents start right after the wait. B chunk
// k >= PF_BS goes from registers into the stage of chunk k - PF_BS once
// every warp has seen that chunk's products complete; one wgmma group stays
// in flight while the loop moves on.
template <int AMODE, class S, class LoadA>
__device__ __forceinline__ void pf_tile(const WgB& bw, int nk, bool early, uint8_t* smem, float (&acc)[32],
                                        LoadA load_a) {
  uint8_t* As = smem;
  uint8_t* Bs = smem + S::NK * WG_TILE_BYTES;
#pragma unroll
  for (int s = 0; s < PF_BS; ++s)
    if (s < nk) wg_load_b(bw, s * WG_BK, Bs + s * WG_TILE_BYTES);
  cp_async_commit();
  uint4 breg[S::NK - PF_BS][PF_PIECES];
#pragma unroll
  for (int s = 0; s < S::NK - PF_BS; ++s)
    if (PF_BS + s < nk) pf_load_b_regs(bw, PF_BS + s, breg[s]);
  grid_dependency_wait();
  if (early) grid_dependency_trigger();
  load_a(As);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < S::NK; ++kt) {
    if (kt < nk) {
      cp_async_wait_upto(AMODE == PF_A_BOX ? S::NK - 1 - kt : 0);  // this thread's copies: A chunk kt, B 0..2
      fence_proxy_async();  // ... and its stores, visible to wgmma's async proxy
      __syncthreads();      // for every thread; every warp has seen chunk kt-2's products complete
#pragma unroll
      for (int s = 0; s < S::NK - PF_BS; ++s)  // B chunk kt+1 into the stage of chunk kt-2
        if (PF_BS + s == kt + 1 && kt + 1 < nk) pf_store_b(breg[s], Bs + ((kt + 1) % PF_BS) * WG_TILE_BYTES);
      const uint64_t da = wg_desc(As + kt * WG_TILE_BYTES, 16);
      const uint64_t db = wg_desc(Bs + (kt % PF_BS) * WG_TILE_BYTES, 1024);
      wg_fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) wgmma_64x64x16(acc, da + 2 * kk, db + 128 * kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // chunk kt-1's products are complete
      wg_fence_acc(acc);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  wg_fence_acc(acc);
}

// The bf16 launches but the fused layer: the prologue (RELU), the skip
// projection (RELU) and the output projection (DDPM or EPS). Tile columns
// are weight columns bx*64 .. +63. Each epilogue computes every element as
// the ring tile's epilogue does, the same operations in the same order, and
// stores two adjacent columns at once.
template <bool A_F32, int EPI, class S>
__global__ void __launch_bounds__(WG_THREADS, 1) step_pf_kernel(const WgOp op, const StepEpi e, const bool early) {
  extern __shared__ uint8_t wg_smem[];
  uint8_t* smem = align1024(wg_smem);
  const int tile = blockIdx.x;
  const int tpc = cdiv(e.T, WG_BM);
  const int b = tile / tpc;
  const int t0 = (tile - b * tpc) * WG_BM;
  const int nvalid = min(WG_BM, e.T - t0);
  const int bx = blockIdx.y;
  const int r0 = b * e.T + t0;
  const int row = pf_row();
  const int col = pf_col();
  const int nk = op.K / WG_BK;
  const long arow = (long)b * e.T + t0;
  const WgA a{A_F32 ? static_cast<const void*>(static_cast<const float*>(op.a) + arow * op.lda)
                    : static_cast<const void*>(static_cast<const bf16*>(op.a) + arow * op.lda),
              op.lda, nvalid, op.scale};
  const WgB bw{op.w, op.ldw, bx * WG_BN, bx * WG_BN + 32};
  auto box_a = [&](uint8_t* As) {  // A a 64-row box of bf16 rows
#pragma unroll
    for (int kt = 0; kt < S::NK; ++kt) {
      if (kt < nk) wg_load_a<false>(a, kt * WG_BK, As + kt * WG_TILE_BYTES);
      cp_async_commit();  // group 1 + kt
    }
  };
  float acc[32];

  // tile columns bx*64 + 8j + col
  uint32_t bias[8];
  float2 xv[2][8] = {}, zv[2][8] = {};  // DDPM: x and z, written before the step
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = bx * WG_BN + 8 * j + col;
    bias[j] = ldcg32(e.bias + c);
    if constexpr (EPI == EPI_DDPM) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + 8 * h < nvalid) {
          const size_t o = (size_t)(r0 + row + 8 * h) * e.ldo + c;
          xv[h][j] = ldcg64(e.x + o);
          zv[h][j] = ldcg64(e.z + o);
        }
      }
    }
  }
  uint32_t nrow[8] = {};  // the prologue's step row, after the wait
  if constexpr (A_F32) {  // the prologue and the skip projection
    pf_tile<PF_A_F32, S>(bw, nk, early, smem, acc, [&](uint8_t* As) {
      if (e.y_out != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j) nrow[j] = ldcg32(e.next_row + bx * WG_BN + 8 * j + col);
      }
#pragma unroll
      for (int k0 = 0; k0 < S::NK; k0 += PF_F32_BATCH)
        if (k0 < nk) pf_f32_chunks(a, k0, nk, As);
    });
  } else {
    pf_tile<PF_A_BOX, S>(bw, nk, early, smem, acc, box_a);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = row + 8 * h;
    if (i >= nvalid) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = bx * WG_BN + 8 * j + col;
      const size_t o = (size_t)(r0 + i) * e.ldo + c;
      const float v0 = acc[4 * j + 2 * h] + bf_lo(bias[j]);
      const float v1 = acc[4 * j + 2 * h + 1] + bf_hi(bias[j]);
      if constexpr (EPI == EPI_RELU) {
        const uint32_t hv = pack_bf16x2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
        st32(static_cast<bf16*>(e.out) + o, hv);
        if (e.zero_f32 != nullptr) st64(e.zero_f32 + o, 0.0f, 0.0f);
        if (e.y_out != nullptr)
          st32(e.y_out + ((size_t)b * (e.T + 2 * e.halo) + e.halo + t0 + i) * e.ldo + c,
               pack_bf16x2(bf_lo(hv) + bf_lo(nrow[j]), bf_hi(hv) + bf_hi(nrow[j])));
      } else if constexpr (EPI == EPI_DDPM) {
        const float2 x = xv[h][j], z = zv[h][j];
        const float x00 = fminf(fmaxf(e.s0 * x.x - e.s1 * v0, -1.0f), 1.0f);
        const float x01 = fminf(fmaxf(e.s0 * x.y - e.s1 * v1, -1.0f), 1.0f);
        st64(static_cast<float*>(e.out) + o, e.s2 * x00 + e.s3 * x.x + e.s4 * z.x,
             e.s2 * x01 + e.s3 * x.y + e.s4 * z.y);
      } else {
        float* eps = static_cast<float*>(e.out) + (size_t)(r0 + i) * e.n_out + c;
        if (c + 1 < e.n_out && (e.n_out & 1) == 0) {
          st64(eps, v0, v1);
        } else if (c < e.n_out) {
          eps[0] = v0;
          if (c + 1 < e.n_out) eps[1] = v1;
        }
      }
    }
  }
  if constexpr (EPI == EPI_RELU) {
    // the prologue: the halo rows of both parity buffers of y above a
    // clip's first tile and below its last, for this block's 64 columns
    if (e.y_out != nullptr && (t0 == 0 || t0 + WG_BM >= e.T)) {
      bf16* clip = e.y_out + (size_t)b * (e.T + 2 * e.halo) * e.ldo + bx * WG_BN;
      const bf16 zero = __float2bfloat16(0.0f);
      for (int idx = threadIdx.x; idx < 2 * e.halo * WG_BN; idx += WG_THREADS) {
        bf16* buf = clip + (idx >= e.halo * WG_BN ? e.y_parity : 0);
        const int i = idx % (e.halo * WG_BN) / WG_BN;
        const int j = idx % WG_BN;
        if (t0 == 0) buf[(size_t)i * e.ldo + j] = zero;
        if (t0 + WG_BM >= e.T) buf[(size_t)(e.halo + e.T + i) * e.ldo + j] = zero;
      }
    }
  }
}

// d += A (64 x 16, shared memory) @ B (16 x 128, MN-major in shared memory: two
// 64-column swizzle atoms 8 KB apart, the descriptor's leading byte offset),
// f32. Element (i, j) is the m64n64k16 tile's dot product, in the same order.
#define SVC_WG128_D "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define SVC_WG128_OUT "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
__device__ __forceinline__ void wgmma_64x128x16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SVC_WG128_D ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : SVC_WG128_OUT
      : "l"(da), "l"(db), "r"(1));
}
#undef SVC_WG128_D
#undef SVC_WG128_OUT

// d += A (64 x 16, this thread's fragments in registers) @ B (16 x 64, MN-major in shared
// memory). A's fragments are those of an m64 accumulator's columns 16kk .. 16kk + 15 packed
// to bf16 in pairs: a.x = (d[8kk], d[8kk + 1]), a.y = (d[8kk + 2], d[8kk + 3]), and so on.
__device__ __forceinline__ void wgmma_64x64x16_ra(float (&d)[32], const uint4& a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(1));
}

__device__ __forceinline__ void wg_fence_acc64(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One residual layer of a bf16 stack as one launch: a cluster of C/64
// blocks owns one 64-row tile of one clip, and block rank q owns gate
// columns c0 = 64q .. c0 + 63, their filter columns C + c0, and the same
// residual and skip columns. 64 columns a half because B, the weights as
// stored ([K, 2C], read MN-major), needs whole 64-column swizzle atoms; the
// cluster takes C/64 blocks (6 at C = 384, 8 at 512). A block is three
// consumer warpgroups and one producer warp, alone on its SM (226 KB):
//   - Warpgroup m multiplies tap m: its box of y (the clip's rows shifted by
//     (m - 1) d) by the tap's rows of w1, gate and filter columns as one
//     m64n128 accumulator, over the C/64 chunks in order from zero. Each tap
//     has its own ring of LAYER_STAGES stages, which the producer warp fills
//     by TMA (one mbarrier a stage filled, one a stage emptied). On an H100
//     one warpgroup running the three taps in turn took ~0.7 us a chunk, most
//     of it the loop's own latency at one warp a scheduler (fences, barrier
//     waits, four dependent wgmmas); three warpgroups overlap it.
//   - The three partials meet in shared memory, each in its tap's ring, and
//     each warpgroup sums a third of the fragments, (p0 + p1) + p2, and runs
//     the gated epilogue on them into this block's
//     exchange buffer: g as the A fragments of the residual GEMM (an
//     accumulator's column pairs are an A fragment's).
//   - After a cluster barrier the producer bulk-copies the exchange buffer
//     into every other rank's shared memory (the other ranks' chunks land in
//     tap 2's ring and the conditioner's tiles, read by then), completing on
//     the receiver's mbarrier: reading g's chunks from the other ranks with
//     loads instead cost ~0.9 us a chunk. Warpgroup 0 then multiplies g by
//     the residual columns and warpgroup 1 by the skip columns, K chunk kc of
//     g being rank kc's fragments; g never goes to device memory.
//   - The residual's weight chunks: the first LAYER_STAGES before the wait,
//     the rest into taps 0 and 1's rings once the partials there are read.
//   - The residual epilogue writes h and skip in place,
//     and the next layer's y into the other parity buffer. Box rows at or
//     past the tile's nvalid read whatever lies there (TMA fills only rows
//     past the tensor with zeros); they make only result rows that are not
//     stored.
// Before the wait: the first ring chunks' weights, the residual's, the
// conditioner tile, the biases and the next step row (no launch writes
// them); after it, y's tap boxes and the h and skip tiles (written by the
// launch before).
constexpr int LAYER_STAGES = 2;                                     // a tap ring's stages
constexpr int LAYER_STAGE_BYTES = 3 * WG_TILE_BYTES;                // A box chunk, gate and filter B chunks
constexpr int LAYER_RING_BYTES = LAYER_STAGES * LAYER_STAGE_BYTES;  // a tap's ring, then its partial
constexpr int LAYER_RES_OFF = 2 * LAYER_RING_BYTES;                 // the residual's ring: res and skip B
constexpr int LAYER_RING2_OFF = LAYER_RES_OFF + LAYER_STAGES * 2 * WG_TILE_BYTES;  // tap 2's ring
constexpr int LAYER_COND_OFF = LAYER_RING2_OFF + LAYER_RING_BYTES;  // gate and filter tiles
constexpr int LAYER_XBUF_OFF = LAYER_COND_OFF + 2 * WG_TILE_BYTES;  // this rank's g fragments: 8 KB
constexpr int LAYER_HS_OFF = LAYER_XBUF_OFF + 4 * WG_THREADS * 16;   // h, then skip's two 32-column halves
constexpr int LAYER_ROWS_OFF = LAYER_HS_OFF + 3 * WG_TILE_BYTES;       // res and skip biases, next step row
constexpr int LAYER_BAR_OFF = LAYER_ROWS_OFF + 3 * WG_BN * 2;        // the mbarriers
constexpr int LAYER_NBARS = 7 * LAYER_STAGES + 5;  // tap full/empty, residual full; rest, cond, h, g, partials read
constexpr int LAYER_SMEM_BYTES = LAYER_BAR_OFF + LAYER_NBARS * 8 + 1024;  // 226 KB: one block an SM
constexpr int LAYER_THREADS = 3 * WG_THREADS + 32;
static_assert(WG_BM * 2 * WG_BN * 4 <= LAYER_RING_BYTES, "a tap's f32 partial fits its ring");
static_assert((PF_MAX_K / WG_BK - LAYER_STAGES) * 2 * WG_TILE_BYTES <= 2 * LAYER_RING_BYTES,
              "the residual's chunks past its ring fit taps 0 and 1's rings");
static_assert((PF_MAX_K / WG_BK - 1) * WG_TILE_BYTES <= LAYER_XBUF_OFF - LAYER_RING2_OFF,
              "the other ranks' g fragments fit tap 2's ring and the conditioner's tiles");

struct LayerOp {
  bf16* y_next;          // the next layer's conv input (the other parity buffer), or null after the last layer
  const bf16* bout;      // [2C]
  const bf16* next_row;  // [C] the next layer's step row (with y_next)
  bf16* h;               // [B*T, C], in place
  float* skip;           // [B*T, C], in place
  int T, C, halo, dil;
  int y_row0;            // row of the y map where this layer's parity buffer starts
  int cond_row0;         // row of the cond map where this layer's block starts
  int layer;             // w1's rows layer * 3C .., wout's layer * C ..
  int tiles;             // row tiles: B * ceil(T / 64); cluster y walks tiles y, y + gridDim.y, ...
};

// The layer's tensor maps, boxes of 64 rows by 128 bytes in the 128-byte
// swizzle the wgmma tiles read: y's two parity buffers as rows [2 B (T + 2
// halo), C], w1 [3 L C, 2C], wout [L C, 2C], the conditioner blocks [L B T,
// 2C] and h [B T, C] in bf16, skip [B T, C] in f32
struct LayerMaps {
  CUtensorMap y, w1, wout, cond, h, skip;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// box (x = column, y = row) of `map` into dst, completing on bar
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}
// the bytes at row i, byte offset o (< 128, within one 16-byte chunk) of a 128-byte-swizzled tile
template <typename V>
__device__ __forceinline__ V sw_ld(const uint8_t* tile, int i, int o) {
  return *reinterpret_cast<const V*>(tile + sw128(i, o >> 4) + (o & 15));
}
// the shared::cluster address of this CTA's shared address a in cluster rank r
__device__ __forceinline__ uint32_t mapa_shared(uint32_t a, int r) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(r));
  return d;
}
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

__global__ void __launch_bounds__(LAYER_THREADS, 1)
    step_layer_kernel(const __grid_constant__ LayerMaps maps, const LayerOp op, const bool early) {
  extern __shared__ uint8_t wg_smem[];
  uint8_t* smem = align1024(wg_smem);
  const uint8_t* cond = smem + LAYER_COND_OFF;  // gate columns' tile, then the filter columns'
  uint32_t* xbuf = reinterpret_cast<uint32_t*>(smem + LAYER_XBUF_OFF);
  bf16* rows = reinterpret_cast<bf16*>(smem + LAYER_ROWS_OFF);  // res bias [64], skip bias [64], next row [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + LAYER_BAR_OFF);  // [tap][stage]
  uint64_t* empty = full + 3 * LAYER_STAGES;                            // [tap][stage]
  uint64_t* rfull = empty + 3 * LAYER_STAGES;                           // the residual's [stage]
  uint64_t* rbar = rfull + LAYER_STAGES;   // the residual's chunks past its ring
  uint64_t* cbar = rbar + 1;               // the conditioner tile
  uint64_t* hbar = cbar + 1;               // h and skip
  uint64_t* gbar = hbar + 1;               // the other ranks' g fragments
  uint64_t* pbar = gbar + 1;               // every partial read: taps 0 and 1's rings are free
  const int C = op.C;
  const int nk = C / WG_BK;  // == the cluster's size
  const int c0 = blockIdx.x * WG_BN;
  const int tpc = cdiv(op.T, WG_BM);
  const int wg = threadIdx.x / WG_THREADS;  // 0-2: the consumer warpgroups; 3: the producer warp
  const int t = threadIdx.x % WG_THREADS;
  const int row = 16 * (t >> 5) + ((t & 31) >> 2);  // this thread's accumulator rows row, row + 8
  const int col = 2 * (t & 3);                       // ... and columns 8j + col, +1
  auto ring = [&](int m) { return smem + (m < 2 ? m * LAYER_RING_BYTES : LAYER_RING2_OFF); };
  // K chunk kc of g: this rank's exchange buffer, or the other ranks' pushed copies in slots
  // 0 .. nk - 2 from tap 2's ring on
  auto g_chunk = [&](int kc) {
    const int q = blockIdx.x;
    return kc == q ? smem + LAYER_XBUF_OFF : smem + LAYER_RING2_OFF + (kc - (kc > q)) * WG_TILE_BYTES;
  };
  // the residual's chunk kc: the first LAYER_STAGES in its own ring, loaded before the wait;
  // the rest in taps 0 and 1's rings once the partials there are read
  auto res_chunk = [&](int kc) {
    return kc < LAYER_STAGES ? smem + LAYER_RES_OFF + kc * 2 * WG_TILE_BYTES
                             : smem + (kc - LAYER_STAGES) * 2 * WG_TILE_BYTES;
  };
  if (threadIdx.x == 3 * WG_THREADS) {
    const CUtensorMap* all[6] = {&maps.y, &maps.w1, &maps.wout, &maps.cond, &maps.h, &maps.skip};
#pragma unroll
    for (int m = 0; m < 6; ++m) asm volatile("prefetch.tensormap [%0];\n" ::"l"(all[m]) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int m = 0; m < 3 * LAYER_STAGES; ++m) {
      mbar_init(full + m, 1);
      mbar_init(empty + m, WG_THREADS);
    }
    for (int s = 0; s < LAYER_STAGES; ++s) mbar_init(rfull + s, 1);
    mbar_init(rbar, 1);
    mbar_init(cbar, 1);
    mbar_init(hbar, 1);
    mbar_init(gbar, 1);
    mbar_init(pbar, 3 * WG_THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the biases and the next step row of this rank's columns (no launch writes them)
  if (threadIdx.x < 24) {
    const int part = threadIdx.x >> 3;  // 0: res bias, 1: skip bias, 2: next row
    const bf16* src = part == 0 ? op.bout + c0 : part == 1 ? op.bout + C + c0 : op.next_row + c0;
    if (part < 2 || op.y_next != nullptr) cp_async16(rows + 64 * part + 8 * (threadIdx.x & 7), src + 8 * (threadIdx.x & 7));
  }
  cp_async_commit();  // waited for before the first cluster barrier, which publishes them
  __syncthreads();

  for (int it = 0, tile = blockIdx.y; tile < op.tiles; ++it, tile += gridDim.y) {
    const int b = tile / tpc;
    const int t0 = (tile - b * tpc) * WG_BM;
    const int nvalid = min(WG_BM, op.T - t0);
    const int r0 = b * op.T + t0;
    const int slot0 = it * nk;  // chunk kc of a ring is its slot slot0 + kc
    if (wg == 3) {
      // the producer: lane 0 issues, the warp takes part in the cluster barriers
      const int ybox = op.y_row0 + b * (op.T + 2 * op.halo) + op.halo + t0;  // tap 1's box
      auto wait_free = [&](uint64_t* bars, int kc) {  // a stage's previous chunk is consumed
        const int u = (slot0 + kc) / LAYER_STAGES;
        if (u > 0) mbar_wait(bars + (slot0 + kc) % LAYER_STAGES, (u - 1) & 1);
      };
      auto tap_b = [&](int m, int kc) {  // tap m's chunk kc of w1, after its barrier expects it whole
        const int s = (slot0 + kc) % LAYER_STAGES;
        uint64_t* bar = full + m * LAYER_STAGES + s;
        mbar_expect(bar, LAYER_STAGE_BYTES);
        uint8_t* st = ring(m) + s * LAYER_STAGE_BYTES;
        const int k0 = (op.layer * 3 + m) * C + kc * WG_BK;
        tma_box(st + WG_TILE_BYTES, &maps.w1, c0, k0, bar);
        tma_box(st + 2 * WG_TILE_BYTES, &maps.w1, C + c0, k0, bar);
      };
      auto tap_a = [&](int m, int kc) {  // tap m's box of y, chunk kc
        const int s = (slot0 + kc) % LAYER_STAGES;
        tma_box(ring(m) + s * LAYER_STAGE_BYTES, &maps.y, kc * WG_BK, ybox + (m - 1) * op.dil,
                full + m * LAYER_STAGES + s);
      };
      auto res_b = [&](int kc, uint64_t* bar) {  // the residual's chunk kc of wout: res and skip columns
        tma_box(res_chunk(kc), &maps.wout, c0, op.layer * C + kc * WG_BK, bar);
        tma_box(res_chunk(kc) + WG_TILE_BYTES, &maps.wout, C + c0, op.layer * C + kc * WG_BK, bar);
      };
      const bool issuer = (threadIdx.x & 31) == 0;
      if (issuer) {
        // the other ranks' g fragments, due once every rank is past the exchange barrier (a copy
        // may complete before this, which the barrier's transaction count allows)
        mbar_expect(gbar, (nk - 1) * WG_TILE_BYTES);
        const int pre = min(LAYER_STAGES, nk);
        for (int kc = 0; kc < pre; ++kc) {
          for (int m = 0; m < 3; ++m) {
            wait_free(empty + m * LAYER_STAGES, kc);
            tap_b(m, kc);
          }
          mbar_expect(rfull + kc, 2 * WG_TILE_BYTES);
          res_b(kc, rfull + kc);
        }
        mbar_expect(cbar, 2 * WG_TILE_BYTES);
        tma_box(smem + LAYER_COND_OFF, &maps.cond, c0, op.cond_row0 + r0, cbar);
        tma_box(smem + LAYER_COND_OFF + WG_TILE_BYTES, &maps.cond, C + c0, op.cond_row0 + r0, cbar);
        grid_dependency_wait();
        if (early) grid_dependency_trigger();
        for (int kc = 0; kc < pre; ++kc)
          for (int m = 0; m < 3; ++m) tap_a(m, kc);
        // h and skip, written by the launch before, for the epilogue
        mbar_expect(hbar, 3 * WG_TILE_BYTES);
        tma_box(smem + LAYER_HS_OFF, &maps.h, c0, r0, hbar);
        tma_box(smem + LAYER_HS_OFF + WG_TILE_BYTES, &maps.skip, c0, r0, hbar);
        tma_box(smem + LAYER_HS_OFF + 2 * WG_TILE_BYTES, &maps.skip, c0 + 32, r0, hbar);
        for (int kc = pre; kc < nk; ++kc) {
          for (int m = 0; m < 3; ++m) {
            wait_free(empty + m * LAYER_STAGES, kc);
            tap_b(m, kc);
            tap_a(m, kc);
          }
        }
      }
      __syncwarp();
      cluster_arrive();  // the g exchange
      if (issuer) {
        // every partial is read: the residual's other chunks into taps 0 and 1's rings
        mbar_wait(pbar, it & 1);
        if (nk > LAYER_STAGES) {
          mbar_expect(rbar, (nk - LAYER_STAGES) * 2 * WG_TILE_BYTES);
          for (int kc = LAYER_STAGES; kc < nk; ++kc) res_b(kc, rbar);
        }
      }
      __syncwarp();
      cluster_wait();  // every rank's fragments are in place, and every rank's slots for them free
      if (issuer) {
        // this rank's fragments into each other rank's slot for them, completing on its gbar
        const int q = blockIdx.x;
        for (int r = 0; r < nk; ++r) {
          if (r == q) continue;
          const uint32_t dst = mapa_shared(smem_u32(smem + LAYER_RING2_OFF + (q - (q > r)) * WG_TILE_BYTES), r);
          asm volatile(
              "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
              "r"(smem_u32(smem + LAYER_XBUF_OFF)), "r"(WG_TILE_BYTES), "r"(mapa_shared(smem_u32(gbar), r))
              : "memory");
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the exchange buffer is read
      }
    } else {
      // consumer warpgroup wg: tap wg's partial, summed over its chunks in order from zero
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      for (int kc = 0; kc < nk; ++kc) {
        const int s = (slot0 + kc) % LAYER_STAGES;
        mbar_wait(full + wg * LAYER_STAGES + s, (slot0 + kc) / LAYER_STAGES & 1);
        const uint8_t* st = ring(wg) + s * LAYER_STAGE_BYTES;
        const uint64_t da = wg_desc(st, 16);
        const uint64_t db = wg_desc(st + WG_TILE_BYTES, WG_TILE_BYTES);  // both B tiles: 128 columns
        wg_fence_acc64(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) wgmma_64x128x16(acc, da + 2 * kk, db + 128 * kk);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        wg_fence_acc64(acc);
        mbar_arrive(empty + wg * LAYER_STAGES + s);
      }
      // the partial into this tap's ring (its chunks are all consumed): fragment k of thread t
      float* part = reinterpret_cast<float*>(ring(wg));
#pragma unroll
      for (int k = 0; k < 64; ++k) part[k * WG_THREADS + t] = acc[k];
      asm volatile("bar.sync 1, %0;\n" ::"n"(3 * WG_THREADS) : "memory");  // the three partials are in place

      // the tap sum, (p0 + p1) + p2, and the gated epilogue for fragments u = wg, wg + 3, ... of
      // every thread slot t: u = 2j + h is row row + 8h, gate columns c0 + 8j + col, +1 in
      // accumulator entries 4j + 2h, +1, and their filter columns 32 further; g's fragment u
      // of slot t is word u % 4 of the exchange buffer's uint4 (u / 4) * 128 + t
      {
        const float* p0 = reinterpret_cast<const float*>(ring(0));
        const float* p1 = reinterpret_cast<const float*>(ring(1));
        const float* p2 = reinterpret_cast<const float*>(ring(2));
        mbar_wait(cbar, it & 1);
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          const int u = wg + 3 * m;
          if (u >= 16) break;
          const int k = 4 * (u >> 1) + 2 * (u & 1);
          const int i = row + 8 * (u & 1);
          const int o = 2 * (8 * (u >> 1) + col);
          const uint32_t cg2 = sw_ld<uint32_t>(cond, i, o), cf2 = sw_ld<uint32_t>(cond + WG_TILE_BYTES, i, o);
          float y[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int g = (k + q) * WG_THREADS + t, f = (32 + k + q) * WG_THREADS + t;
            const float sg = (p0[g] + p1[g]) + p2[g], sf = (p0[f] + p1[f]) + p2[f];
            const float gate = __fadd_rn(sg, q ? bf_hi(cg2) : bf_lo(cg2));
            const float filt = __fadd_rn(sf, q ? bf_hi(cf2) : bf_lo(cf2));
            y[q] = (1.0f / (1.0f + expf(-gate))) * tanhf(filt);
          }
          xbuf[((u >> 2) * WG_THREADS + t) * 4 + (u & 3)] = pack_bf16x2(y[0], y[1]);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the partials' reads, before TMA refills
        mbar_arrive(pbar);
      }
      cp_async_wait<0>();  // this thread's copies of the biases and the next row
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the fragments, for the bulk copies
      cluster_arrive();    // every rank's fragments are in place (and every thread's copies)
      cluster_wait();

      // the residual: warpgroup 0 the res columns, 1 the skip columns (B tile wg of a stage)
      float racc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) racc[i] = 0.0f;
      if (wg < 2) {
        // warpgroup 0 the res columns, 1 the skip columns (B tile wg of a chunk); K chunk kc of
        // g is rank kc's fragments, here once gbar completes
        mbar_wait(gbar, it & 1);
#pragma unroll 1
        for (int kc = 0; kc < nk; ++kc) {
          if (kc < LAYER_STAGES) {
            mbar_wait(rfull + kc, it & 1);
          } else if (kc == LAYER_STAGES) {
            mbar_wait(rbar, it & 1);
          }
          const uint4* g4 = reinterpret_cast<const uint4*>(g_chunk(kc));
          uint4 ga[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) ga[i] = g4[i * WG_THREADS + t];
          const uint64_t db = wg_desc(res_chunk(kc) + wg * WG_TILE_BYTES, 1024);
          wg_fence_acc(racc);
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int kk = 0; kk < WG_BK / 16; ++kk) wgmma_64x64x16_ra(racc, ga[kk], db + 128 * kk);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          wg_fence_acc(racc);
        }

        // the residual epilogue: warpgroup 0 res column c (h and the next y), 1 skip
        // column C + c; h and skip's halves in their tiles
        mbar_wait(hbar, it & 1);
        const uint8_t* hs = smem + LAYER_HS_OFF;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = row + 8 * h;
          if (i >= nvalid) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + 8 * j + col;
            const size_t o = (size_t)(r0 + i) * C + c;
            if (wg == 0) {
              const uint32_t br = *reinterpret_cast<const uint32_t*>(rows + 8 * j + col);
              const float res0 = __fadd_rn(racc[4 * j + 2 * h], bf_lo(br));
              const float res1 = __fadd_rn(racc[4 * j + 2 * h + 1], bf_hi(br));
              const uint32_t hv = sw_ld<uint32_t>(hs, i, 2 * (8 * j + col));
              const uint32_t hn = pack_bf16x2((bf_lo(hv) + res0) * 0.70710678118654752f,
                                              (bf_hi(hv) + res1) * 0.70710678118654752f);
              st32(op.h + o, hn);
              if (op.y_next != nullptr) {
                const uint32_t nr = *reinterpret_cast<const uint32_t*>(rows + 128 + 8 * j + col);
                st32(op.y_next + ((size_t)b * (op.T + 2 * op.halo) + op.halo + t0 + i) * C + c,
                     pack_bf16x2(bf_lo(hn) + bf_lo(nr), bf_hi(hn) + bf_hi(nr)));
              }
            } else {
              const uint32_t bs = *reinterpret_cast<const uint32_t*>(rows + 64 + 8 * j + col);
              const float sk0 = __fadd_rn(racc[4 * j + 2 * h], bf_lo(bs));
              const float sk1 = __fadd_rn(racc[4 * j + 2 * h + 1], bf_hi(bs));
              const float2 sk = sw_ld<float2>(hs + (1 + (j >> 2)) * WG_TILE_BYTES, i, 4 * (8 * (j & 3) + col));
              st64(op.skip + o, sk.x + sk0, sk.y + sk1);
            }
          }
        }
      }
      // this tile's reads of shared memory are complete before the next tile's loads, which the
      // producer issues after the barrier below
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();  // the tile's shared memory is read: the next tile's loads may overwrite it
  }
}


// --- int8 launches (K6): the wgmma s8 tile over per-clip row tiles. The
// gate, split over its taps, quantises its tap's box of y from h; "int8"
// mode's residual copies the int8 g.
struct W8Op {
  const void* a;        // gate: bf16 h [B*T, lda]; residual: int8 g [B*T, lda]
  int lda;
  int dil;              // gate: tap m reads rows shifted by (m - 1) * dil
  const int8_t* w;      // K-major: gate [3, 2*half, K] tap-major; residual [2*half, K]
  int half, K;          // tile columns: rows bx*32.. and half + bx*32.. of w
  const bf16* add_row;  // gate: this layer's step row [K], added before quantising
  const float* amax;    // gate: [B] abs max of y per clip
};

// two bf16 of h plus two of the step row (one word each), quantised with
// 1/s_y = inv: two int8 in the low 16 bits (a bf16's f32 value is its bits << 16)
__device__ __forceinline__ uint32_t quant_pair(uint32_t h, uint32_t r, float inv) {
  const float y0 = __fadd_rn(__uint_as_float(h << 16), __uint_as_float(r << 16));
  const float y1 = __fadd_rn(__uint_as_float(h & 0xffff0000u), __uint_as_float(r & 0xffff0000u));
  return static_cast<uint8_t>(quant_i8(__fmul_rn(y0, inv))) |
         static_cast<uint32_t>(static_cast<uint8_t>(quant_i8(__fmul_rn(y1, inv)))) << 8;
}

// 8 bf16 of h plus 8 of the row -> 8 int8
__device__ __forceinline__ uint2 quant8(uint4 h, uint4 r, float inv) {
  return make_uint2(quant_pair(h.x, r.x, inv) | quant_pair(h.y, r.y, inv) << 16,
                    quant_pair(h.z, r.z, inv) | quant_pair(h.w, r.w, inv) << 16);
}

constexpr int W8_GATE_Q = 2;   // column tiles per gate cluster (cluster of 3 taps x W8_GATE_Q)
constexpr int W8_QBATCH = 3;   // 32-byte reads of h in flight per thread

// The int8 gate's resident A tiles, quantised once per cluster. The three
// taps' 64-row boxes of a row tile overlap: together they are clip rows
// [t0 - d, t0 + 64 + d) of y = h + add_row. Each of the cluster's
// 3 * W8_GATE_Q blocks quantises an interleaved share of those rows
// (1/s_y = inv) and stores every quantised 16-byte chunk, through
// distributed shared memory, into the A tile of each block whose tap box
// holds it: tap m's tile row i is union row i + m * d. Rows outside [0, T)
// are 0 (the conv pads the quantised input), as are tile rows at or past
// nvalid and the columns at or past K. Ends with every tile of the cluster
// complete.
__device__ __forceinline__ void quant_taps_cluster(const bf16* clip, int ld, int T, int t0, int d, int nvalid,
                                                   const bf16* add_row, float inv, int K, uint8_t* As) {
  constexpr int NB = 3 * W8_GATE_Q;
  cg::cluster_group cluster = cg::this_cluster();
  uint8_t* dst[NB];
#pragma unroll
  for (int r = 0; r < NB; ++r) dst[r] = cluster.map_shared_rank(As, r);
  const int nc = w8_row_chunks(K);
  const int n = (WG_BM + 2 * d) * nc;
  const int stride = NB * WG_THREADS;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every block has started: DSMEM is live
  for (int base = cluster.block_rank() * WG_THREADS + threadIdx.x; base < n; base += W8_QBATCH * stride) {
    uint4 hv[W8_QBATCH][2];
    uint4 rv[W8_QBATCH][2];
    bool ok[W8_QBATCH];
#pragma unroll
    for (int q = 0; q < W8_QBATCH; ++q) {
      const int v = base + q * stride;
      const int u = v / nc;
      const int c = v - u * nc;
      const int ts = t0 - d + u;
      ok[q] = v < n && ts >= 0 && ts < T && 16 * c < K;
      if (ok[q]) {
        const uint4* hp = reinterpret_cast<const uint4*>(clip + (size_t)ts * ld + 16 * c);
        const uint4* rp = reinterpret_cast<const uint4*>(add_row + 16 * c);
        hv[q][0] = hp[0];
        hv[q][1] = hp[1];
        rv[q][0] = rp[0];
        rv[q][1] = rp[1];
      }
    }
#pragma unroll
    for (int q = 0; q < W8_QBATCH; ++q) {
      const int v = base + q * stride;
      if (v < n) {
        uint4 packed = make_uint4(0u, 0u, 0u, 0u);
        if (ok[q]) {
          const uint2 lo = quant8(hv[q][0], rv[q][0], inv);
          const uint2 hi = quant8(hv[q][1], rv[q][1], inv);
          packed = make_uint4(lo.x, lo.y, hi.x, hi.y);
        }
        const int u = v / nc;
        const int c = v - u * nc;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          const int i = u - m * d;
          if (i >= 0 && i < WG_BM) {
            const uint4 val = i < nvalid ? packed : make_uint4(0u, 0u, 0u, 0u);
            const int off = w8_a_offset(i, c);
#pragma unroll
            for (int p = 0; p < W8_GATE_Q; ++p) *reinterpret_cast<uint4*>(dst[m + 3 * p] + off) = val;
          }
        }
      }
    }
  }
  // the stores, visible to every block's wgmma (async proxy), then complete
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
  cluster.sync();
}

template <int EPI>
__global__ void __launch_bounds__(WG_THREADS) step_gemm_s8_kernel(const W8Op op, const StepEpi e) {
  constexpr bool SPLIT = EPI == EPI_GATE;
  extern __shared__ uint8_t wg_smem[];
  uint8_t* smem = align1024(wg_smem);
  const int tap = SPLIT ? (int)(blockIdx.x % 3) : 0;  // == the block's rank in its cluster of 3
  const int tile = SPLIT ? blockIdx.x / 3 : blockIdx.x;
  const int tpc = cdiv(e.T, WG_BM);
  const int b = tile / tpc;
  const int t0 = (tile - b * tpc) * WG_BM;
  const int nvalid = min(WG_BM, e.T - t0);
  const int bx = blockIdx.y;
  const int C = op.half;
  const W8B bw{op.w + (size_t)tap * 2 * C * op.K, op.K, bx * 32, C + bx * 32};
  if constexpr (SPLIT) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");  // started
  const int* Ci = wg_gemm_s8(bw, op.K, smem, [&](uint8_t* As) {
    if constexpr (SPLIT) {
      // s_y is complete now: every block of the launch that wrote h has folded its max
      const float inv = 1.0f / quant_scale(op.amax[b]);
      quant_taps_cluster(static_cast<const bf16*>(op.a) + (size_t)b * e.T * op.lda, op.lda, e.T, t0, op.dil,
                         nvalid, op.add_row, inv, op.K, As);
    } else {
      w8_copy_a(static_cast<const int8_t*>(op.a) + (size_t)(b * e.T + t0) * op.lda, op.lda, nvalid, op.K, As);
    }
  });
  const int r0 = b * e.T + t0;
  if constexpr (SPLIT) {
    cluster_epilogue<true, EPI>(e, Ci, 3 * (bx % W8_GATE_Q), tap, r0, nvalid, bx, C, 2 * C);
  } else {
    epilogue<true, EPI>(e, [&](int i, int j) { return Ci[i * WG_LDC + j]; }, r0, nvalid, bx, C, 2 * C, 0, WG_BM);
  }
}

// launch_ex (common.cuh), with a cluster for the int8 gate: 3 taps by
// W8_GATE_Q column tiles.
// The launches of one entry-point call, for the caller's counters: each
// launch helper below adds its own, and the entry point passes the sums on.
struct Issued {
  int launches = 0;  // kernel launches
  int layers = 0;    // of them step_layer_kernel's, one a fused residual layer
  int tiled = 0;     // of them step_pf_kernel's, on the prefetching tile of
  int nk = 0;        // ... nk resident K chunks
};
thread_local Issued issued;

template <bool A_F32, int EPI>
void launch_wg(const WgOp& op, const StepEpi& e, int B, cudaStream_t s) {
  ++issued.launches;
  auto kernel = step_gemm_wg_kernel<A_F32, EPI>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM_BYTES);
  (void)attr;  // a refusal shows as the launch's error
  const int ny = op.half > 0 ? op.half / 32 : op.N / WG_BN;
  launch_ex(kernel, dim3(B * cdiv(e.T, WG_BM), ny), dim3(WG_THREADS), WG_SMEM_BYTES, dim3(1), s, op, e);
}

// Blocks of `kernel` that the device holds at once: its SMs times the blocks
// an SM takes (0 when the query fails)
template <typename Kernel>
int resident_blocks(Kernel kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WG_THREADS, smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// All of the SM's shared memory for `kernel`, so that three 73 KB blocks
// fit; returns resident_blocks (a refused attribute shows as the launch's
// error)
template <typename Kernel>
int big_smem(Kernel kernel, int smem) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return resident_blocks(kernel, smem);
}

// A launch whose grid is resident at once triggers its dependents right
// after its wait (`early`), so that their blocks start and put their loads in
// flight while it runs; a longer one triggers nothing, lest waiting blocks of
// the next launch hold an SM that one of its later blocks needs.
template <bool A_F32, int EPI, class S>
void launch_pf(const WgOp& op, const StepEpi& e, int B, cudaStream_t s) {
  ++issued.launches;
  ++issued.tiled;
  issued.nk = S::NK;
  auto kernel = step_pf_kernel<A_F32, EPI, S>;
  static const int resident = big_smem(kernel, S::SMEM);
  const dim3 grid(B * cdiv(e.T, WG_BM), op.N / WG_BN);
  const bool early = (int)(grid.x * grid.y) <= resident;
  launch_ex(kernel, grid, dim3(WG_THREADS), S::SMEM, dim3(1), s, op, e, early);
}

// Clusters of step_layer_kernel that the device holds at once, for clusters
// of nq blocks (0 when the query fails)
int layer_resident_clusters(int nq) {
  static int cached[PF_MAX_K / WG_BN + 1] = {};  // by nq <= 8
  if (cached[nq] == 0) {
    big_smem(step_layer_kernel, LAYER_SMEM_BYTES);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nq, 1);
    cfg.blockDim = dim3(LAYER_THREADS);
    cfg.dynamicSmemBytes = LAYER_SMEM_BYTES;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = nq;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, step_layer_kernel, &cfg) != cudaSuccess) {
      cudaGetLastError();  // a failed query is no launch error
      return 0;
    }
    cached[nq] = n;
  }
  return cached[nq];
}

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime's entry-point
// lookup (the library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
    cudaGetLastError();
    return nullptr;
  }
  return reinterpret_cast<EncodeTiled>(fn);
}

// A row-major matrix [rows, cols] (row stride ld elements) of bf16, or of
// f32 with `f32`, as a tensor map of boxes 64 rows by 128 bytes, swizzled as
// the wgmma tiles read them; rows past the end read 0
bool tile_map(CUtensorMap* map, const void* base, int cols, long rows, int ld, bool f32 = false) {
  static const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const int size = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * size};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / size), WG_BM};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One residual layer: a cluster of C/64 blocks a row tile, as many clusters
// as the device holds at once at most, each walking its row tiles (on an
// H100 2-3% faster than waves of one tile a cluster where the tiles take
// more than one wave). It triggers its dependents right after its wait.
void launch_layer(const LayerMaps& maps, const LayerOp& op, cudaStream_t s) {
  ++issued.launches;
  ++issued.layers;
  const int nq = op.C / WG_BN;
  const int resident = layer_resident_clusters(nq);
  const int clusters = resident > 0 ? std::min(op.tiles, resident) : op.tiles;
  launch_ex(step_layer_kernel, dim3(nq, clusters), dim3(LAYER_THREADS), LAYER_SMEM_BYTES, dim3(nq, 1), s, maps, op,
            clusters <= resident);
}

template <int EPI>
void launch_s8(const W8Op& op, const StepEpi& e, int B, cudaStream_t s) {
  ++issued.launches;
  constexpr bool SPLIT = EPI == EPI_GATE;
  auto kernel = step_gemm_s8_kernel<EPI>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, w8_smem_bytes(W8_MAX_K));
  (void)attr;  // a refusal shows as the launch's error
  const dim3 grid((SPLIT ? 3 : 1) * B * cdiv(e.T, WG_BM), op.half / 32);
  launch_ex(kernel, grid, dim3(WG_THREADS), w8_smem_bytes(op.K), SPLIT ? dim3(3, W8_GATE_Q) : dim3(1), s, op, e);
}

WgOp plain_op(const void* a, int lda, const bf16* w, int ldw, int half, int N, int K, float scale = 1.0f) {
  return WgOp{a, lda, w, ldw, half, N, K, scale};
}

// Operands of one denoiser forward (both entry points).
struct Forward {
  const float* x_in;          // f32 [B*T, mp], mel padded with zeros
  bf16* h;                    // scratch bf16 [B*T, C]
  float* skip;                // scratch f32 [B*T, C]
  void* g;                    // int8 stack: scratch [B*T, C], bf16 g, or int8 in "int8" mode; else null
  bf16* s1;                   // scratch bf16 [B*T, C]
  bf16* y;                    // bf16 stack: scratch [2, B, T + 2*halo, C], halo rows zero; else null
  const bf16* step_rows_t;    // [L, C] this step's rows
  const void* w1;             // bf16 [L, 3C, 2C], or int8 K-major [L, 3, 2C, C] when w1s != null
  const bf16* condb;          // [L, B*T, 2C]
  const void* wout;           // bf16 [L, C, 2C], or int8 K-major [L, 2C, C] when wouts != null
  const bf16* bout;           // [L, 2C]
  const bf16 *wmel, *bmel, *wskip, *bskip, *wo, *bo;
  const float* w1s;           // [L, 2C] or null
  const float* wouts;         // [L, 2C] or null
  float* amax;                // [L, B] scratch when w1s != null
  int B, T, C, L, cycle, mp;
};

// Prologue, the L layers (one step_layer_kernel launch each) and the skip
// projection on a bf16 stack (the prefetching tile of shape S): s1 is then
// ready for the output projection. False, launching nothing, where the
// layers' tensor maps cannot be made.
template <class S>
bool run_body_bf16(const Forward& f, cudaStream_t st) {
  const int M = f.B * f.T;
  const int C = f.C;
  const int halo = 1 << (f.cycle - 1);
  const int rows = f.B * (f.T + 2 * halo);  // y's parity buffer l % 2 is rows l % 2 ..
  const size_t parity = (size_t)rows * C;   // ... and starts `parity` elements in
  LayerMaps maps;
  if (!tile_map(&maps.y, f.y, C, 2L * rows, C) || !tile_map(&maps.w1, f.w1, 2 * C, 3L * f.L * C, 2 * C) ||
      !tile_map(&maps.wout, f.wout, 2 * C, (long)f.L * C, 2 * C) ||
      !tile_map(&maps.cond, f.condb, 2 * C, (long)f.L * M, 2 * C) || !tile_map(&maps.h, f.h, C, M, C) ||
      !tile_map(&maps.skip, f.skip, C, M, C, true))
    return false;

  StepEpi pro{};
  pro.out = f.h; pro.ldo = C; pro.bias = f.bmel; pro.zero_f32 = f.skip; pro.T = f.T;
  pro.next_row = f.step_rows_t; pro.y_out = f.y; pro.halo = halo; pro.y_parity = parity;
  launch_pf<true, EPI_RELU, S>(plain_op(f.x_in, f.mp, f.wmel, C, 0, C, f.mp), pro, f.B, st);

  for (int l = 0; l < f.L; ++l) {
    LayerOp op{};
    op.bout = f.bout + (size_t)l * 2 * C; op.h = f.h; op.skip = f.skip;
    op.T = f.T; op.C = C; op.halo = halo; op.dil = 1 << (l % f.cycle);
    op.y_row0 = (l % 2) * rows; op.cond_row0 = l * M; op.layer = l; op.tiles = f.B * cdiv(f.T, WG_BM);
    if (l + 1 < f.L) {
      op.y_next = f.y + ((l + 1) % 2) * parity;
      op.next_row = f.step_rows_t + (size_t)(l + 1) * C;
    }
    launch_layer(maps, op, st);
  }

  StepEpi sk{};
  sk.out = f.s1; sk.ldo = C; sk.bias = f.bskip; sk.T = f.T;
  const float inv_sqrt_l = (float)(1.0 / sqrt((double)f.L));
  launch_pf<true, EPI_RELU, S>(plain_op(f.skip, C, f.wskip, C, 0, C, C, inv_sqrt_l), sk, f.B, st);
  return true;
}

// A bf16 stack's whole forward, ending with the output projection's
// epilogue `oe` (DDPM update or eps): the prologue, skip and output
// projections on the narrow tile where C, mp <= PF_NARROW_K, else on the
// wide one. False where run_body_bf16 is.
template <int EPI>
bool run_bf16(const Forward& f, const WgOp& out, const StepEpi& oe, cudaStream_t st) {
  if (f.C <= PF_NARROW_K && f.mp <= PF_NARROW_K) {
    if (!run_body_bf16<PfNarrow>(f, st)) return false;
    launch_pf<false, EPI, PfNarrow>(out, oe, f.B, st);
  } else {
    if (!run_body_bf16<PfWide>(f, st)) return false;
    launch_pf<false, EPI, PfWide>(out, oe, f.B, st);
  }
  return true;
}

// The same on an int8 stack (K6): the int8 GEMMs on the s8 tile, the bf16
// ones on the ring tile.
void run_body_i8(const Forward& f, cudaStream_t st) {
  const int M = f.B * f.T;
  const int C = f.C;
  const bool q2 = f.wouts != nullptr;
  cudaMemsetAsync(f.amax, 0, sizeof(float) * f.L * f.B, st);

  // what the epilogue that writes h passes on to layer l's gate
  auto feed = [&](StepEpi& e, int l) {
    e.next_row = f.step_rows_t + (size_t)l * C;
    e.amax_out = f.amax + (size_t)l * f.B;
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
    const W8Op gate{f.h, C, d, static_cast<const int8_t*>(f.w1) + w1_off, C, C, f.step_rows_t + (size_t)l * C,
                    f.amax + (size_t)l * f.B};
    ge.col_scale = f.w1s + (size_t)l * 2 * C; ge.amax_in = gate.amax; ge.gate_i8 = q2;
    launch_s8<EPI_GATE>(gate, ge, f.B, st);

    StepEpi re{};
    re.out = f.h; re.ldo = C; re.bias = f.bout + (size_t)l * 2 * C; re.skip = f.skip; re.T = f.T;
    if (l + 1 < f.L) feed(re, l + 1);
    if (q2) {
      re.col_scale = f.wouts + (size_t)l * 2 * C;
      const W8Op res{f.g, C, 0, static_cast<const int8_t*>(f.wout) + wout_off, C, C, nullptr, nullptr};
      launch_s8<EPI_RESSKIP>(res, re, f.B, st);
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

// The widths a stack's tiles take: K = C <= W8_MAX_K for the int8 tile, and
// K = C and K = mp <= PF_MAX_K for the prefetching tiles (K6's bf16 launches
// run on the ring tile, which takes any K)
bool shapes_ok(const Forward& f) {
  return f.w1s != nullptr ? f.C <= W8_MAX_K : f.C <= PF_MAX_K && f.mp <= PF_MAX_K;
}

// An entry point's status: the launches' error, or 0 after adding what the
// call issued to `launched` (when not null): [0] its kernel launches, [1] of
// them step_layer_kernel's, [2] step_pf_kernel's, and setting [3] to the
// NK of that prefetching tile (when [2] grew)
int report(int* launched) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && launched != nullptr) {
    launched[0] += issued.launches;
    launched[1] += issued.layers;
    launched[2] += issued.tiled;
    if (issued.tiled > 0) launched[3] = issued.nk;
  }
  return (int)err;
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
// [B*T, C] scratch; g: [B*T, C] bf16-sized scratch on an int8 stack (null on
// a bf16 stack); skip: f32 [B*T, C] scratch; y: bf16 [2, B, T +
// 2*2^(cycle-1), C] scratch, the two conv-input buffers (bf16 stack; null on
// an int8 stack); step_rows_t: bf16 [L, C] (this step's
// rows); w1: bf16 [L, 3C, 2C] tap-major, or the int8 K-major copy
// [L, 3, 2C, C] (then w1s f32 [L, 2C] and amax f32 [L, B] scratch); condb:
// bf16 [L, B*T, 2C]; wout: bf16 [L, C, 2C], or the int8 K-major copy
// [L, 2C, C] (then wouts f32 [L, 2C]); bout: bf16 [L, 2C]; wmel [mp, C], bmel
// [C], wskip [C, C], bskip [C], wo [C, mp], bo [mp], all bf16. C and mp are
// multiples of 64, C <= W8_MAX_K on an int8 stack and C, mp <= 512 on a bf16
// stack. s0..s4: this step's schedule scalars. launched: null, or 4 host
// ints to which the call adds what it launched (report, below).
extern "C" int svc_ddpm_step(const float* x_in, const float* z, float* x_out, SVC_FORWARD_PARAMS,
                             float s0, float s1c, float s2, float s3, float s4, int* launched, void* stream) {
  using namespace svc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Forward f = SVC_FORWARD(x_in);
  if (!shapes_ok(f)) return (int)cudaErrorInvalidValue;
  issued = {};
  StepEpi dd{};
  dd.out = x_out; dd.ldo = mp; dd.bias = bo; dd.x = x_in; dd.z = z; dd.T = T;
  dd.s0 = s0; dd.s1 = s1c; dd.s2 = s2; dd.s3 = s3; dd.s4 = s4;
  const WgOp out = plain_op(s1, C, wo, mp, 0, mp, C);
  if (w1s != nullptr) {
    run_body_i8(f, st);
    launch_wg<false, EPI_DDPM>(out, dd, B, st);
  } else {
    if (!run_bf16<EPI_DDPM>(f, out, dd, st)) return (int)cudaErrorInvalidValue;
  }
  return report(launched);
}

// K5 (K6 on an int8 stack): the same forward, storing eps f32 [B*T, n_mel]
// from the padded f32 input x_in [B*T, mp]; launched as svc_ddpm_step's.
extern "C" int svc_denoise(const float* x_in, float* eps, SVC_FORWARD_PARAMS, int n_mel,
                           int* launched, void* stream) {
  using namespace svc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Forward f = SVC_FORWARD(x_in);
  if (!shapes_ok(f)) return (int)cudaErrorInvalidValue;
  issued = {};
  StepEpi ee{};
  ee.out = eps; ee.ldo = n_mel; ee.bias = bo; ee.n_out = n_mel; ee.T = T;
  const WgOp out = plain_op(s1, C, wo, mp, 0, mp, C);
  if (w1s != nullptr) {
    run_body_i8(f, st);
    launch_wg<false, EPI_EPS>(out, ee, B, st);
  } else {
    if (!run_bf16<EPI_EPS>(f, out, ee, st)) return (int)cudaErrorInvalidValue;
  }
  return report(launched);
}
