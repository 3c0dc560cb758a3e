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
//   launches compute the same function, each phase is a pass of 64 x 64
//   WMMA tiles (gemm_tile.cuh) bound by the serial latency of its K loop; K8
//   removes the launch boundaries between the phases, nothing else.
//
// Design: one persistent cooperative launch. The grid is sized with
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor so that every block is
//   resident (no more blocks than the largest phase has tiles), launched with
//   cudaLaunchCooperativeKernel, and each block loops over the output tiles
//   of a phase; cooperative_groups' grid.sync() separates the phases:
//     prologue: h = bf16(relu(bf16(x) @ wmel + bmel)), skip = 0, layer 0's y3;
//     per layer l: gate  g = sigmoid(acc_g + condb) * tanh(acc_f + condb'),
//                         acc = y3 @ w1[l] (gate and filter columns paired);
//                  residual: yo = g @ wout[l] + bout[l], h = bf16((h + yo_res)
//                         / sqrt 2), skip += yo_skip, and layer l+1's y3;
//     skip projection s1 = bf16(relu(bf16(skip / sqrt L) @ wskip + bskip));
//     output projection eps = s1 @ wo + bo for the n_mel columns.
//   h, skip, y3, g and s1 live in global scratch (together ~3.7 MB at
//   T = 944: L2-resident). The y3 build is fused into the epilogue that
//   writes h: the thread that writes h[t][c] also writes y(t) into the three
//   y3 slots that hold it (centre of row t, left of row t + d, right of row
//   t - d) and zeroes the halo slots of row t, so every y3 element is written
//   exactly once per layer, after the gate phase that read the last layer's
//   y3 and before the next gate phase reads it. h[t][c] is read and written
//   by the same thread only. Rounding points are K5's and the TPU kernel's:
//   bf16 operands, f32 accumulation, f32 gates and skip sum, h stored bf16.
#include <cooperative_groups.h>

#include <algorithm>

#include "gemm_tile.cuh"

namespace svc {
namespace {

namespace cg = cooperative_groups;

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

__device__ __forceinline__ TapA plain_a(const void* src, int M, int K, float scale = 1.0f) {
  return TapA{src, K, M, M, K, K, 0, 0, nullptr, scale, nullptr};
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

__global__ void __launch_bounds__(GM_THREADS) denoise_v2_kernel(const V2Args p) {
  __shared__ __align__(32) bf16 As[GM_BM][GM_LDA];
  __shared__ __align__(32) bf16 Bs[GM_BK][GM_LDB];
  __shared__ __align__(32) float Cs[GM_BM][GM_LDC];
  cg::grid_group grid = cg::this_grid();
  const int T = p.T;
  const int C = p.C;
  const int mt = cdiv(T, GM_BM);

  {  // prologue
    const TapA a = plain_a(p.x, T, p.mp);
    const ColsB bw{p.wmel, C, C, 0};
    for (int tile = blockIdx.x; tile < mt * cdiv(C, GM_BN); tile += gridDim.x) {
      const int m0 = (tile % mt) * GM_BM;
      const int bx = tile / mt;
      gemm_tile<true>(a, bw, m0, bx, As, Bs, Cs);
      for (int idx = threadIdx.x; idx < GM_BM * GM_BN; idx += GM_THREADS) {
        const int t = m0 + (idx >> 6);
        const int c = bx * GM_BN + (idx & 63);
        if (t >= T || c >= C) continue;
        const bf16 hv = __float2bfloat16(fmaxf(Cs[idx >> 6][idx & 63] + __bfloat162float(p.bmel[c]), 0.0f));
        p.h[(size_t)t * C + c] = hv;
        p.skip[(size_t)t * C + c] = 0.0f;
        put_taps(p, t, c, hv, p.step_rows, 1);
      }
    }
  }
  grid.sync();

  const int n_pair = mt * cdiv(C, 32);  // gate / residual tiles: 32 channels, both halves
  for (int l = 0; l < p.L; ++l) {
    {  // gate
      const TapA a = plain_a(p.y3, T, 3 * C);
      const ColsB bw{p.w1 + (size_t)l * 3 * C * 2 * C, 2 * C, 2 * C, C};
      const bf16* cond = p.condb + (size_t)l * T * 2 * C;
      for (int tile = blockIdx.x; tile < n_pair; tile += gridDim.x) {
        const int m0 = (tile % mt) * GM_BM;
        const int bx = tile / mt;
        gemm_tile<false>(a, bw, m0, bx, As, Bs, Cs);
        for (int idx = threadIdx.x; idx < GM_BM * 32; idx += GM_THREADS) {
          const int i = idx >> 5;
          const int j = idx & 31;
          const int t = m0 + i;
          const int c = bx * 32 + j;
          if (t >= T || c >= C) continue;
          const bf16* cb = cond + (size_t)t * 2 * C;
          const float gate = __fadd_rn(Cs[i][j], __bfloat162float(cb[c]));
          const float filt = __fadd_rn(Cs[i][j + 32], __bfloat162float(cb[C + c]));
          p.g[(size_t)t * C + c] = __float2bfloat16((1.0f / (1.0f + expf(-gate))) * tanhf(filt));
        }
      }
    }
    grid.sync();
    {  // residual and skip, then the next layer's y3
      const TapA a = plain_a(p.g, T, C);
      const ColsB bw{p.wout + (size_t)l * C * 2 * C, 2 * C, 2 * C, C};
      const bf16* bias = p.bout + (size_t)l * 2 * C;
      const bool next = l + 1 < p.L;
      const bf16* row = p.step_rows + (size_t)(l + 1) * C;
      const int d = 1 << ((l + 1) % p.cycle);
      for (int tile = blockIdx.x; tile < n_pair; tile += gridDim.x) {
        const int m0 = (tile % mt) * GM_BM;
        const int bx = tile / mt;
        gemm_tile<false>(a, bw, m0, bx, As, Bs, Cs);
        for (int idx = threadIdx.x; idx < GM_BM * 32; idx += GM_THREADS) {
          const int i = idx >> 5;
          const int j = idx & 31;
          const int t = m0 + i;
          const int c = bx * 32 + j;
          if (t >= T || c >= C) continue;
          const float res = __fadd_rn(Cs[i][j], __bfloat162float(bias[c]));
          const float sk = __fadd_rn(Cs[i][j + 32], __bfloat162float(bias[C + c]));
          const size_t o = (size_t)t * C + c;
          const bf16 hn = __float2bfloat16((__bfloat162float(p.h[o]) + res) * 0.70710678118654752f);
          p.h[o] = hn;
          p.skip[o] += sk;
          if (next) put_taps(p, t, c, hn, row, d);
        }
      }
    }
    grid.sync();
  }

  {  // skip projection
    const TapA a = plain_a(p.skip, T, C, p.inv_sqrt_l);
    const ColsB bw{p.wskip, C, C, 0};
    for (int tile = blockIdx.x; tile < mt * cdiv(C, GM_BN); tile += gridDim.x) {
      const int m0 = (tile % mt) * GM_BM;
      const int bx = tile / mt;
      gemm_tile<true>(a, bw, m0, bx, As, Bs, Cs);
      for (int idx = threadIdx.x; idx < GM_BM * GM_BN; idx += GM_THREADS) {
        const int t = m0 + (idx >> 6);
        const int c = bx * GM_BN + (idx & 63);
        if (t >= T || c >= C) continue;
        p.s1[(size_t)t * C + c] =
            __float2bfloat16(fmaxf(Cs[idx >> 6][idx & 63] + __bfloat162float(p.bskip[c]), 0.0f));
      }
    }
  }
  grid.sync();

  {  // output projection
    const TapA a = plain_a(p.s1, T, C);
    const ColsB bw{p.wo, p.mp, p.mp, 0};
    for (int tile = blockIdx.x; tile < mt * cdiv(p.mp, GM_BN); tile += gridDim.x) {
      const int m0 = (tile % mt) * GM_BM;
      const int bx = tile / mt;
      gemm_tile<false>(a, bw, m0, bx, As, Bs, Cs);
      for (int idx = threadIdx.x; idx < GM_BM * GM_BN; idx += GM_THREADS) {
        const int t = m0 + (idx >> 6);
        const int c = bx * GM_BN + (idx & 63);
        if (t >= T || c >= p.n_mel) continue;
        p.eps[(size_t)t * p.n_mel + c] = Cs[idx >> 6][idx & 63] + __bfloat162float(p.bo[c]);
      }
    }
  }
}

}  // namespace
}  // namespace svc

using svc::bf16;

// K8: eps [T, n_mel] f32 of one clip from the padded f32 mel x_in [T, mp].
// h, g, s1: bf16 [T, C] scratch; skip: f32 [T, C] scratch; y3: bf16
// [T, 3C] scratch; step_rows_t: bf16 [L, C]; w1: bf16 [L, 3C, 2C]
// tap-major; condb: bf16 [L, T, 2C]; wout: bf16 [L, C, 2C]; bout: bf16
// [L, 2C]; wmel [mp, C], bmel [C], wskip [C, C], bskip [C], wo [C, mp],
// bo [mp], all bf16. C a multiple of 32, mp of 64. grid_out (may be null)
// receives the number of blocks launched.
extern "C" int svc_denoise_v2(const float* x_in, float* eps, bf16* h, float* skip, bf16* y3, bf16* g,
                              bf16* s1, const bf16* step_rows_t, const bf16* w1, const bf16* condb,
                              const bf16* wout, const bf16* bout, const bf16* wmel, const bf16* bmel,
                              const bf16* wskip, const bf16* bskip, const bf16* wo, const bf16* bo,
                              int T, int C, int L, int cycle, int mp, int n_mel, int* grid_out,
                              void* stream) {
  using namespace svc;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, denoise_v2_kernel, GM_THREADS, 0);
  }
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int mt = cdiv(T, GM_BM);
  const int most = mt * std::max(cdiv(C, 32), cdiv(mp, GM_BN));  // tiles of the largest phase
  const int grid = std::min(most, per_sm * sms);
  if (grid_out != nullptr) *grid_out = grid;
  const V2Args p{x_in, eps, h, skip, y3, g, s1, step_rows_t, w1, condb, wout, bout, wmel, bmel,
                 wskip, bskip, wo, bo, (float)(1.0 / sqrt((double)L)), T, C, L, cycle, mp, n_mel};
  void* args[] = {const_cast<V2Args*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(denoise_v2_kernel), dim3(grid),
                                    dim3(GM_THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
