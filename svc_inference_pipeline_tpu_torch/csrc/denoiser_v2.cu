// K8: the DiffSVC denoiser's eps forward in ONE launch per evaluation.
//
// Replaces: perf_kernel3.py build_v2_fn.run_step (kernel body
//   make_kernel_v2), the concat-tap variant of the TPU denoiser: one
//   pallas_call whose grid walks the L layers while h [T, C] bf16, the f32
//   skip sum and the conv input y3 [T, 3C] = [y(t-d) | y(t) | y(t+d)] bf16
//   (y = bf16(h + step_row), zero halo) stay in VMEM; the dilated conv is one
//   K = 3C matmul over y3.
//
// What bounds it here: ~45 GFLOP of bf16 products per evaluation at
//   T = 944, C = 384, L = 20 (46 us at the tensor cores' dense peak) against
//   ~76 MB of weights and conditioner blocks (23 us). As in K5, whose 2 + 2L
//   launches compute the same function, each phase is one pass of 64 x 64
//   tiles whose latency (loads, K loop, epilogue) sets its time; K8 replaces
//   K5's launch boundaries by grid barriers.
//
// Design: one persistent cooperative launch. The grid is sized with
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor (the tile's dynamic shared
//   memory included) so that every block is resident (no more blocks than
//   the largest phase has tiles), launched with cudaLaunchCooperativeKernel,
//   and each block loops over the output tiles of a phase;
//   cooperative_groups' grid.sync() separates the phases:
//     prologue: h = bf16(relu(bf16(x) @ wmel + bmel)), skip = 0, layer 0's y3;
//     per layer l: gate  g = sigmoid(acc_g + condb) * tanh(acc_f + condb'),
//                         acc = y3 @ w1[l] (gate and filter columns paired);
//                  residual: yo = g @ wout[l] + bout[l], h = bf16((h + yo_res)
//                         / sqrt 2), skip += yo_skip, and layer l+1's y3;
//     skip projection s1 = bf16(relu(bf16(skip / sqrt L) @ wskip + bskip));
//     output projection eps = s1 @ wo + bo for the n_mel columns.
//   Every phase runs on the pipelined wgmma tile of K1 (gemm_wg.cuh: 4-stage
//   cp.async ring in dynamic shared memory, K in chunks of 64). The gate
//   keeps the TPU kernel's y3 as its A: a plain bf16 K-major box with
//   K = 3C, so a pure cp.async source (K1's zero-halo buffer with three
//   row-shifted boxes would need a tile that changes its A box per tap).
//   Before each grid.sync() a block issues the first WG_STAGES - 1 weight
//   chunks of its first tile in the next phase (no phase writes weights):
//   K1's dependent-launch rule inside one launch. The tap split of K1's gate
//   (clusters of 3) was not tried here: a cooperative launch with clusters
//   needs cudaLaunchKernelEx with both attributes.
//   h, skip, y3, g and s1 live in global scratch (together ~3.7 MB at
//   T = 944: L2-resident). The y3 build is fused into the epilogue that
//   writes h: the thread that writes h[t][c] also writes y(t) into the three
//   y3 slots that hold it (centre of row t, left of row t + d, right of row
//   t - d) and zeroes the halo slots of row t, so every y3 element is written
//   exactly once per layer, after the gate phase that read the last layer's
//   y3 and before the next gate phase reads it. h[t][c] is read and written
//   by the same thread only. Rounding points are K5's and the TPU kernel's:
//   bf16 operands, f32 accumulation, f32 gates and skip sum, h stored bf16;
//   the sums run in another order than K5's (K over 3C in one tile, not
//   split over taps), so K8 and K5 agree to rounding, not bit for bit.
#include <cooperative_groups.h>

#include <algorithm>

#include "gemm_wg.cuh"

namespace svc {
namespace {

namespace cg = cooperative_groups;

enum Phase { PH_PRO, PH_GATE, PH_RES, PH_SKIP, PH_OUT };

struct V2Args {
  const float* x;     // [T, mp] f32, the mel padded with zeros
  float* eps;         // [T, n_mel] f32
  bf16* h;            // scratch [T, C]
  float* skip;        // scratch [T, C]
  bf16* y3;           // scratch [T, 3C]
  bf16* g;            // scratch [T, C]
  bf16* s1;           // scratch [T, C]
  const bf16* step_rows;  // [L, C] this step's rows
  const bf16* w1;     // [L, 3C, 2C] tap-major rows [left; centre; right]
  const bf16* condb;  // [L, T, 2C] conditioner + conv bias
  const bf16* wout;   // [L, C, 2C]
  const bf16* bout;   // [L, 2C]
  const bf16 *wmel, *bmel, *wskip, *bskip, *wo, *bo;
  float inv_sqrt_l;
  int T, C, L, cycle, mp, n_mel;
};

// The gate and the residual have paired tiles (32 channels, gate and filter
// or residual and skip columns); the other phases plain 64-column tiles.
__host__ __device__ constexpr bool paired(int ph) { return ph == PH_GATE || ph == PH_RES; }

__device__ __forceinline__ int phase_tiles(const V2Args& p, int ph) {
  const int mt = cdiv(p.T, WG_BM);
  return mt * (paired(ph) ? p.C / 32 : (ph == PH_OUT ? p.mp : p.C) / WG_BN);
}

__device__ __forceinline__ int phase_k(const V2Args& p, int ph) {
  return ph == PH_PRO ? p.mp : ph == PH_GATE ? 3 * p.C : p.C;
}

// Weights of column tile bx of phase ph at layer l.
__device__ __forceinline__ WgB phase_b(const V2Args& p, int ph, int l, int bx) {
  const int C = p.C;
  switch (ph) {
    case PH_PRO: return WgB{p.wmel, C, bx * WG_BN, bx * WG_BN + 32};
    case PH_GATE: return WgB{p.w1 + (size_t)l * 3 * C * 2 * C, 2 * C, bx * 32, C + bx * 32};
    case PH_RES: return WgB{p.wout + (size_t)l * C * 2 * C, 2 * C, bx * 32, C + bx * 32};
    case PH_SKIP: return WgB{p.wskip, C, bx * WG_BN, bx * WG_BN + 32};
    default: return WgB{p.wo, p.mp, bx * WG_BN, bx * WG_BN + 32};
  }
}

// Rows [t0, t0 + 64) of phase ph's A.
__device__ __forceinline__ WgA phase_a(const V2Args& p, int ph, int t0) {
  const int nvalid = min(WG_BM, p.T - t0);
  switch (ph) {
    case PH_PRO: return WgA{p.x + (size_t)t0 * p.mp, p.mp, nvalid, 1.0f};
    case PH_GATE: return WgA{p.y3 + (size_t)t0 * 3 * p.C, 3 * p.C, nvalid, 1.0f};
    case PH_RES: return WgA{p.g + (size_t)t0 * p.C, p.C, nvalid, 1.0f};
    case PH_SKIP: return WgA{p.skip + (size_t)t0 * p.C, p.C, nvalid, p.inv_sqrt_l};
    default: return WgA{p.s1 + (size_t)t0 * p.C, p.C, nvalid, 1.0f};
  }
}

// Before a grid barrier: the first weight chunks of this block's first tile
// in phase ph (its ring is free: the last epilogue ended in __syncthreads()).
__device__ __forceinline__ void prefetch_phase(const V2Args& p, int ph, int l, uint8_t* ring) {
  if ((int)blockIdx.x < phase_tiles(p, ph)) {
    wg_prefetch_b(phase_b(p, ph, l, blockIdx.x / cdiv(p.T, WG_BM)), phase_k(p, ph), ring);
  }
}

// y(t) = bf16(hn + row[c]) into the y3 slots of a layer with dilation d.
__device__ __forceinline__ void put_taps(const V2Args& p, int t, int c, bf16 hn, const bf16* row, int d) {
  const int C = p.C;
  const size_t ld = 3 * (size_t)C;
  const bf16 y = __float2bfloat16(__bfloat162float(hn) + __bfloat162float(row[c]));
  const bf16 zero = __float2bfloat16(0.0f);
  p.y3[t * ld + C + c] = y;
  if (t + d < p.T) {
    p.y3[(t + d) * ld + c] = y;
  } else {
    p.y3[t * ld + 2 * C + c] = zero;
  }
  if (t >= d) {
    p.y3[(t - d) * ld + 2 * C + c] = y;
  } else {
    p.y3[t * ld + c] = zero;
  }
}

// Every tile of phase ph (layer l) owned by this block; the first one's
// weight chunks were issued before the barrier that opened the phase.
template <int PH>
__device__ __forceinline__ void run_phase(const V2Args& p, int l, uint8_t* ring) {
  const int T = p.T;
  const int C = p.C;
  const int mt = cdiv(T, WG_BM);
  const int K = phase_k(p, PH);
  for (int tile = blockIdx.x; tile < phase_tiles(p, PH); tile += gridDim.x) {
    const int t0 = (tile % mt) * WG_BM;
    const int bx = tile / mt;
    const WgB bw = phase_b(p, PH, l, bx);
    if (tile != (int)blockIdx.x) wg_prefetch_b(bw, K, ring);
    const float* Cs = wg_gemm_main<PH == PH_PRO || PH == PH_SKIP>(phase_a(p, PH, t0), bw, K, ring);
    if constexpr (paired(PH)) {
      const bf16* cond = p.condb + (size_t)l * T * 2 * C;
      const bf16* bias = p.bout + (size_t)l * 2 * C;
      const bf16* row = p.step_rows + (size_t)(l + 1) * C;  // the next layer's (PH_RES)
      const int d = 1 << ((l + 1) % p.cycle);
      for (int idx = threadIdx.x; idx < WG_BM * 32; idx += WG_THREADS) {
        const int i = idx >> 5;
        const int j = idx & 31;
        const int t = t0 + i;
        if (t >= T) continue;
        const int c = bx * 32 + j;
        const float lo = Cs[i * WG_LDC + j];
        const float hi = Cs[i * WG_LDC + j + 32];
        const size_t o = (size_t)t * C + c;
        if constexpr (PH == PH_GATE) {
          const bf16* cb = cond + (size_t)t * 2 * C;
          const float gate = __fadd_rn(lo, __bfloat162float(cb[c]));
          const float filt = __fadd_rn(hi, __bfloat162float(cb[C + c]));
          p.g[o] = __float2bfloat16((1.0f / (1.0f + expf(-gate))) * tanhf(filt));
        } else {
          const float res = __fadd_rn(lo, __bfloat162float(bias[c]));
          const float sk = __fadd_rn(hi, __bfloat162float(bias[C + c]));
          const bf16 hn = __float2bfloat16((__bfloat162float(p.h[o]) + res) * 0.70710678118654752f);
          p.h[o] = hn;
          p.skip[o] += sk;
          if (l + 1 < p.L) put_taps(p, t, c, hn, row, d);
        }
      }
    } else {
      for (int idx = threadIdx.x; idx < WG_BM * WG_BN; idx += WG_THREADS) {
        const int i = idx >> 6;
        const int j = idx & 63;
        const int t = t0 + i;
        const int c = bx * WG_BN + j;
        if (t >= T) continue;
        const float v = Cs[i * WG_LDC + j];
        if constexpr (PH == PH_PRO) {
          const bf16 hv = __float2bfloat16(fmaxf(v + __bfloat162float(p.bmel[c]), 0.0f));
          p.h[(size_t)t * C + c] = hv;
          p.skip[(size_t)t * C + c] = 0.0f;
          put_taps(p, t, c, hv, p.step_rows, 1);
        } else if constexpr (PH == PH_SKIP) {
          p.s1[(size_t)t * C + c] = __float2bfloat16(fmaxf(v + __bfloat162float(p.bskip[c]), 0.0f));
        } else {
          if (c < p.n_mel) p.eps[(size_t)t * p.n_mel + c] = v + __bfloat162float(p.bo[c]);
        }
      }
    }
    __syncthreads();  // the epilogue has read Cs (aliased on the ring) before the next weight chunks
  }
}

__global__ void __launch_bounds__(WG_THREADS) denoise_v2_kernel(const V2Args p) {
  extern __shared__ uint8_t v2_smem[];
  uint8_t* ring = align1024(v2_smem);
  cg::grid_group grid = cg::this_grid();
  prefetch_phase(p, PH_PRO, 0, ring);
  run_phase<PH_PRO>(p, 0, ring);
  prefetch_phase(p, PH_GATE, 0, ring);
  grid.sync();
  for (int l = 0; l < p.L; ++l) {
    run_phase<PH_GATE>(p, l, ring);
    prefetch_phase(p, PH_RES, l, ring);
    grid.sync();
    run_phase<PH_RES>(p, l, ring);
    if (l + 1 < p.L) {
      prefetch_phase(p, PH_GATE, l + 1, ring);
    } else {
      prefetch_phase(p, PH_SKIP, 0, ring);
    }
    grid.sync();
  }
  run_phase<PH_SKIP>(p, 0, ring);
  prefetch_phase(p, PH_OUT, 0, ring);
  grid.sync();
  run_phase<PH_OUT>(p, 0, ring);
}

}  // namespace
}  // namespace svc

using svc::bf16;

// K8: eps [T, n_mel] f32 of one clip from the padded f32 mel x_in [T, mp].
// h, g, s1: bf16 [T, C] scratch; skip: f32 [T, C] scratch; y3: bf16
// [T, 3C] scratch; step_rows_t: bf16 [L, C]; w1: bf16 [L, 3C, 2C]
// tap-major; condb: bf16 [L, T, 2C]; wout: bf16 [L, C, 2C]; bout: bf16
// [L, 2C]; wmel [mp, C], bmel [C], wskip [C, C], bskip [C], wo [C, mp],
// bo [mp], all bf16. C and mp multiples of 64. grid_out (may be null)
// receives the number of blocks launched.
extern "C" int svc_denoise_v2(const float* x_in, float* eps, bf16* h, float* skip, bf16* y3, bf16* g,
                              bf16* s1, const bf16* step_rows_t, const bf16* w1, const bf16* condb,
                              const bf16* wout, const bf16* bout, const bf16* wmel, const bf16* bmel,
                              const bf16* wskip, const bf16* bskip, const bf16* wo, const bf16* bo,
                              int T, int C, int L, int cycle, int mp, int n_mel, int* grid_out,
                              void* stream) {
  using namespace svc;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  static const cudaError_t attr =
      cudaFuncSetAttribute(denoise_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM_BYTES);
  cudaError_t err = attr;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, denoise_v2_kernel, WG_THREADS, WG_SMEM_BYTES);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int mt = cdiv(T, WG_BM);
  const int most = mt * std::max(C / 32, mp / WG_BN);  // tiles of the largest phase
  const int grid = std::min(most, per_sm * sms);
  if (grid_out != nullptr) *grid_out = grid;
  const V2Args p{x_in, eps, h, skip, y3, g, s1, step_rows_t, w1, condb, wout, bout, wmel, bmel,
                 wskip, bskip, wo, bo, (float)(1.0 / sqrt((double)L)), T, C, L, cycle, mp, n_mel};
  void* args[] = {const_cast<V2Args*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(denoise_v2_kernel), dim3(grid), dim3(WG_THREADS),
                                    args, WG_SMEM_BYTES, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
