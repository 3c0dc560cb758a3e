// K3: fused anti-aliased SnakeBeta activation (BigVGAN Activation1d).
//
// Replaces: svc_inference_pipeline_tpu/ops/pallas/snake.py _fused_impl
//   (via fused_activation1d), which tiles time with a +-8 edge-padded halo
//   and patches the outer 3 samples with the composed XLA path afterwards.
//
// What bounds it here: a priori memory traffic — one read and one write of
//   [B, T, C] (T = 256 frames per second of audio, C = 24 on the main path)
//   against ~72 FMAs and ~2 sinf per output, where the composed form writes
//   and re-reads a 2x-rate intermediate three times. Measured on an H100 at
//   [1, 98304, 24] bf16: 0.10 ms, where the 9.4 MB moved would take ~3 us, so
//   the arithmetic and index math inside each block bound it today.
//
// Design: the device function in snake.cuh. Each block stages a 64-row x
//   32-channel x tile plus its +-8 halo in shared memory, forms the snake of
//   the upsampled samples there, and decimates; the edge replication of both
//   resampling steps is computed from clamped global indices, so the global
//   edges are exact in the kernel and need no separate patch.
#include "snake.cuh"

// x: [B, T, C] (bf16 if x_bf16 else f32); out: [B, T, C] (bf16 if out_bf16
// else f32); alpha, inv_beta: f32 [C] effective parameters (exp already
// applied for logscale); taps: host pointer to the 12 filter taps.
extern "C" int svc_activation1d(const void* x, int x_bf16, void* out, int out_bf16,
                                const float* alpha, const float* inv_beta,
                                const float* taps, int B, int T, int C, void* stream) {
  using namespace svc;
  const Fir12 f = fir12_from(taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16) {
    launch_activation1d(static_cast<const bf16*>(x), static_cast<bf16*>(out), alpha, inv_beta, f,
                        B, T, C, s);
  } else if (x_bf16) {
    launch_activation1d(static_cast<const bf16*>(x), static_cast<float*>(out), alpha, inv_beta, f,
                        B, T, C, s);
  } else if (out_bf16) {
    launch_activation1d(static_cast<const float*>(x), static_cast<bf16*>(out), alpha, inv_beta, f,
                        B, T, C, s);
  } else {
    launch_activation1d(static_cast<const float*>(x), static_cast<float*>(out), alpha, inv_beta,
                        f, B, T, C, s);
  }
  return (int)cudaGetLastError();
}
