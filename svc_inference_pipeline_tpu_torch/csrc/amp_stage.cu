// K2: one BigVGAN AMP stage (the mean of three AMPBlock1 stacks, each three
// x <- x + conv_1(act(conv_d(act(x)))) pairs), composed from two kernels:
// the shared activation (snake.cuh, entry svc_activation1d) and the dilated
// conv1d below, whose epilogue adds the bias, the residual and the running
// 3-block sum and applies the mean. The Python wrapper
// (ops/pallas/amp_stage.py::fused_amp_stage) issues the 36 launches of a
// stage.
//
// Replaces: svc_inference_pipeline_tpu/ops/pallas/amp_stage.py
//   fused_amp_stage (kernel body _make_kernel), a time-tiled mega-kernel with
//   a 112-row halo whose outer rows _xla_stage patches afterwards.
//
// What bounds it here: latency and issue, not FLOPs or bytes. A wide stage
//   (2 T C^2 sum(6k) = ~228 GFLOP for a 4 s clip at C = 768 or 384) takes
//   7.5 and 4.9 ms on an H100, ~30-47 TFLOP/s, a few percent of the
//   tensor cores' dense bf16 peak: each block's K loop loads a chunk,
//   synchronises, then multiplies, with nothing overlapped (gemm_tile.cuh).
//   The narrow stages (C = 24..96, ~2 ms each) are set by the 36 launches of
//   a stage rather than their bytes.
//
// Design: implicit GEMM over the [k, Cin, Cout] weight (gemm_tile.cuh): the
//   k dilated taps are gathered from the activation with zero "same" padding
//   while the A tile is staged, so no im2col matrix is written. Every launch
//   sees the whole sequence, so the global edges are exact and nothing is
//   patched. Activations between the convs are f32 (the stage carry and the
//   conv outputs) or bf16 (the conv operands, as on the TPU); the stage output
//   is rounded once, at the mean. The TPU-only devices (phase packing for
//   C <= 64, weight streaming at C = 768, the sin^2 polynomial) are not
//   carried over.
#include "gemm_tile.cuh"

namespace svc {
namespace {

struct ConvEpi {
  const float* bias;   // f32 [Cout]
  const void* res;     // optional residual [M, Cout] (bf16 if res_bf16 else f32)
  int res_bf16;
  const float* acc_in; // optional running sum [M, Cout] f32
  float scale;         // applied after all adds
  void* out;           // [M, Cout] (bf16 if out_bf16 else f32); may alias res / acc_in
  int out_bf16;
};

__global__ void __launch_bounds__(GM_THREADS) conv1d_kernel(const TapA a, const ColsB bw,
                                                           const ConvEpi e) {
  __shared__ __align__(32) bf16 As[GM_BM][GM_LDA];
  __shared__ __align__(32) bf16 Bs[GM_BK][GM_LDB];
  __shared__ __align__(32) float Cs[GM_BM][GM_LDC];
  const int m0 = blockIdx.x * GM_BM;
  const int bx = blockIdx.y;
  gemm_tile(a, bw, m0, bx, As, Bs, Cs);
  for (int idx = threadIdx.x; idx < GM_BM * GM_BN; idx += GM_THREADS) {
    const int i = idx >> 6;
    const int j = idx & 63;
    const int r = m0 + i;
    const int col = bx * GM_BN + j;
    if (r >= a.M || col >= bw.N) continue;
    const size_t o = (size_t)r * bw.N + col;
    float v = Cs[i][j] + e.bias[col];
    if (e.res != nullptr) {
      v += e.res_bf16 ? __bfloat162float(static_cast<const bf16*>(e.res)[o])
                      : static_cast<const float*>(e.res)[o];
    }
    if (e.acc_in != nullptr) v += e.acc_in[o];
    v *= e.scale;
    if (e.out_bf16) {
      static_cast<bf16*>(e.out)[o] = __float2bfloat16(v);
    } else {
      static_cast<float*>(e.out)[o] = v;
    }
  }
}

}  // namespace
}  // namespace svc

// out = (conv_{k,dil}(x) + bias + res + acc_in) * scale with zero "same"
// padding dil*(k-1)/2. x: bf16 [B, T, cin]; w: bf16 [k, cin, cout] (tap-major,
// i.e. a row-major [k*cin, cout] matrix); bias f32 [cout]; res / acc_in may be
// null; out may alias res or acc_in (each element is read then written by the
// same thread). cin and cout must be multiples of 8.
extern "C" int svc_conv1d(const svc::bf16* x, const svc::bf16* w, const float* bias,
                          const void* res, int res_bf16, const float* acc_in, float scale,
                          void* out, int out_bf16, int B, int T, int cin, int cout, int k,
                          int dil, void* stream) {
  using namespace svc;
  const int M = B * T;
  const TapA a{x, cin, M, T, k * cin, cin, dil, dil * (k - 1) / 2};
  const ColsB bw{w, cout, cout};
  const ConvEpi e{bias, res, res_bf16, acc_in, scale, out, out_bf16};
  conv1d_kernel<<<gemm_grid(M, bw), GM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, bw, e);
  return (int)cudaGetLastError();
}
