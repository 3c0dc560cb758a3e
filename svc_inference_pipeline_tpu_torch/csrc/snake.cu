// K3: fused anti-aliased SnakeBeta activation (BigVGAN Activation1d).
//
// Replaces: svc_inference_pipeline_tpu/ops/pallas/snake.py _fused_impl
//   (via fused_activation1d), which tiles time with a +-8 edge-padded halo
//   and patches the outer 3 samples with the composed XLA path afterwards.
//
// What bounds it here: one read and one write of [B, T, C] (T = 256 frames
//   per second of audio, C = 24 on the main path; 9.4 MB at [1, 98304, 24]
//   bf16, ~3 us at the HBM rate) against ~60 f32 operations and 2 accurate
//   sines per element, ~10 us of issue on the whole card, and the latency
//   of each thread's chain of them at the few warps per scheduler the
//   problem gives. The first version (a 64-row x 32-channel shared-memory
//   tile with a +-8 halo, divisions per element, the 2x-rate samples staged
//   between two barriers) was itself latency-bound.
//
// Design: the register-resident polyphase pass of snake.cuh: one thread per
//   channel pair and run of 16 or 32 output rows, a sliding window of input
//   rows and running decimation sums in registers, coalesced loads and stores
//   (neighbouring threads on neighbouring channels), the global edges exact by
//   the clamps of the semantics.
#include "snake.cuh"

// x: [B, T, C] (bf16 if x_bf16 else f32); out: [B, T + 2 halo, C] (bf16 if
// out_bf16 else f32), act(x) in rows [halo, halo + T) and zeros in the halo
// rows (halo = 0: a plain [B, T, C] output); alpha, inv_beta: f32 [C]
// effective parameters (exp already applied for logscale); taps: host pointer
// to the 12 filter taps. C must be even and every pointer 8-byte aligned.
extern "C" int svc_activation1d(const void* x, int x_bf16, void* out, int out_bf16, const float* alpha,
                                const float* inv_beta, const float* taps, int B, int T, int C, int halo,
                                void* stream) {
  using namespace svc;
  if (C % ACT_VEC != 0) return (int)cudaErrorInvalidValue;
  const ActArgs a{x, out, alpha, inv_beta, fir12_from(taps), B, T, C, halo};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16) {
    launch_activation1d<bf16, bf16>(a, s);
  } else if (x_bf16) {
    launch_activation1d<bf16, float>(a, s);
  } else if (out_bf16) {
    launch_activation1d<float, bf16>(a, s);
  } else {
    launch_activation1d<float, float>(a, s);
  }
  return (int)cudaGetLastError();
}
