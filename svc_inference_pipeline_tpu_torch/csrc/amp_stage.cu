// K2: one BigVGAN AMP stage (the mean of three AMPBlock1 stacks, each three
// x <- x + conv_1(act(conv_d(act(x)))) pairs), issued by ONE host call
// (svc_amp_stage): 36 launches for the 18 pairs, two kernels with
// programmatic dependent launch between them:
//   - the activation (snake.cuh), which writes bf16(act(.)) straight into
//     the conv's zero-halo input buffer;
//   - the dilated conv1d below, on the pipelined wgmma tile (gemm_wg.cuh),
//     whose epilogue adds the bias, the residual and the running 3-block sum
//     and applies the mean.
// K7: one AMPBlock1 pair, out = x + conv_1(act2(conv_d(act1(x)))), issued by
// ONE host call (svc_amp_pair): the same four launches of the same two
// kernels as one pair of a K2 stage (issue_pair), with the pair's own halo
// and an epilogue that adds b2 and x and rounds once to bf16.
//
// Replaces: svc_inference_pipeline_tpu/ops/pallas/amp_stage.py
//   fused_amp_stage (kernel body _make_kernel), a time-tiled mega-kernel with
//   a 112-row halo whose outer rows _xla_stage patches afterwards; and
//   svc_inference_pipeline_tpu/ops/pallas/amp_pair.py fused_amp_pair (kernel
//   body _make_kernel), one time tile per grid step with both activations
//   inline and both convs as k shifted MXU matmuls, whose outer halo rows
//   _xla_pair patches afterwards.
//
// What bounds it here: the convs' operations at the wide stages (2 T C^2
//   sum(6k) = ~228 GFLOP for a 4 s clip at C = 768 or 384, 0.23 ms at the
//   tensor cores' dense bf16 peak); at the narrow stages (C = 24..96) the
//   activations' f32 work and the latency of the dependent launches. A K7
//   pair is 1/18 of a stage's work: at C <= 96 its four launches are
//   latency-bound, and the host's call is of the same order.
//
// Design:
//   - The conv input is ready to copy. The activations write into one
//     buffer [B, T + 2H, C] bf16 whose halo rows (H = the stage's largest
//     d(k-1)/2, 25 for k = 11, d = 5; a K7 pair's own d(k-1)/2) are zero,
//     so tap m of a conv with dilation d is the plain row box that starts
//     at clip row H - d(k-1)/2 + m d: no gather, no division and no edge
//     test in the A loader, which copies 16-byte chunks by cp.async into
//     the swizzled ring.
//     C is a multiple of 8, so a chunk never straddles two taps; a thread's
//     (tap, channel) advances by one K chunk per call, with no division.
//   - The [k, Cin, Cout] weight is a row-major [k Cin, Cout] matrix, read
//     MN-major through the descriptor's transpose bit: no weight copy.
//   - K = k C is padded to the tile's 64-wide chunks, and N to 64 columns,
//     with zeros (cp.async of 0 bytes): columns past C (C = 24, 48) read
//     nothing and are not stored.
//   - Tiles never straddle two clips (grid x = clip x row tile).
//   - Dependent launches: the conv issues its first weight chunks, waits for
//     the launch before, then reads the buffer and writes its output; the
//     activation reads its parameters, waits, then reads and writes.
//   Every launch sees the whole sequence, so the global edges are exact and
//   nothing is patched. Activations between the convs are f32 (the stage
//   carry and the conv outputs) or bf16 (the conv operands, as on the TPU);
//   the stage output is rounded once, at the mean, and a K7 pair's once, at
//   its residual.
#include "gemm_wg.cuh"
#include "snake.cuh"

namespace svc {
namespace {

struct ConvOp {
  const bf16* buf;  // [B, T + 2 halo, C] conv input, halo rows zero
  const bf16* w;    // [k C, C] row-major (the [k, Cin, Cout] weight)
  int T, C, halo, k, d;
};

struct ConvEpi {
  const float* bias;   // f32 [C]
  const void* res;     // optional residual [B T, C] (bf16 if res_bf16 else f32)
  int res_bf16;
  const float* acc_in; // optional running sum [B T, C] f32
  float scale;         // applied after all adds
  void* out;           // [B T, C] (bf16 if out_bf16 else f32); may alias res / acc_in
  int out_bf16;
};

constexpr int AMP_EPI_BATCH = 4;  // epilogue quads whose loads a thread has in flight at once

__global__ void __launch_bounds__(WG_THREADS) conv1d_kernel(const ConvOp op, const ConvEpi e) {
  extern __shared__ uint8_t wg_smem[];
  uint8_t* ring = align1024(wg_smem);
  const int tpc = cdiv(op.T, WG_BM);
  const int b = blockIdx.x / tpc;
  const int t0 = (blockIdx.x - b * tpc) * WG_BM;
  const int nvalid = min(WG_BM, op.T - t0);
  const int n0 = blockIdx.y * WG_BN;
  const int K = op.k * op.C;
  const int nk = cdiv(K, WG_BK);
  const int c = threadIdx.x & 7;   // the 16-byte chunk of a tile row this thread copies
  const int r0 = threadIdx.x >> 3;  // and its rows r0 + 16 i

  auto load_b = [&](int kt, uint8_t* Bs) {
    const int col = n0 + 8 * c;
#pragma unroll
    for (int i = 0; i < WG_BK * 8 / WG_THREADS; ++i) {
      const int r = r0 + 16 * i;
      const int kk = kt * WG_BK + r;
      const bool ok = kk < K && col < op.C;
      cp_async16(Bs + sw128(r, c), ok ? op.w + (size_t)kk * op.C + col : op.w, ok ? 16 : 0);
    }
  };
  wg_prefetch(nk, ring, load_b);
  grid_dependency_wait();

  // tap m and channel ch of this thread's chunk in the current K chunk
  int m = 0;
  int ch = 8 * c;
  while (ch >= op.C) {
    ch -= op.C;
    ++m;
  }
  const bf16* clip = op.buf + ((size_t)b * (op.T + 2 * op.halo) + op.halo - op.d * (op.k - 1) / 2 + t0) * op.C;
  auto load_a = [&](int kt, uint8_t* As) {
    const bool tap = m < op.k;
    const bf16* src = clip + (size_t)(tap ? m * op.d : 0) * op.C + ch;
#pragma unroll
    for (int i = 0; i < WG_BM * 8 / WG_THREADS; ++i) {
      const int r = r0 + 16 * i;
      const bool ok = tap && r < nvalid;
      cp_async16(As + sw128(r, c), ok ? src + (size_t)r * op.C : op.buf, ok ? 16 : 0);
    }
    ch += WG_BK;
    while (ch >= op.C) {
      ch -= op.C;
      ++m;
    }
  };
  const float* Cs = wg_gemm_loop(nk, ring, load_a, load_b);

  // epilogue over the tile's valid quads (4 columns; C is a multiple of 8),
  // AMP_EPI_BATCH per thread at a time: their residual and running-sum loads
  // are all issued before any store (each element is read, then written, by
  // one thread, so out may alias res or acc_in)
  const int nqc = min(WG_BN, op.C - n0) / 4;  // valid quads per row
  const int nq = nvalid * nqc;
  const size_t row0 = (size_t)b * op.T + t0;
  for (int base = threadIdx.x; base < nq; base += AMP_EPI_BATCH * WG_THREADS) {
    float v[AMP_EPI_BATCH][4];
    size_t o[AMP_EPI_BATCH];
#pragma unroll
    for (int u = 0; u < AMP_EPI_BATCH; ++u) {
      const int idx = base + u * WG_THREADS;
      const int i = idx / nqc;
      const int j = 4 * (idx - i * nqc);
      o[u] = (row0 + i) * op.C + n0 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[u][q] = 0.0f;
      if (idx >= nq) continue;
      if (e.res != nullptr) {
        if (e.res_bf16) {
          const uint2 r = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(e.res) + o[u]);
          v[u][0] = __uint_as_float(r.x << 16);
          v[u][1] = __uint_as_float(r.x & 0xffff0000u);
          v[u][2] = __uint_as_float(r.y << 16);
          v[u][3] = __uint_as_float(r.y & 0xffff0000u);
        } else {
          const float4 r = *reinterpret_cast<const float4*>(static_cast<const float*>(e.res) + o[u]);
          v[u][0] = r.x; v[u][1] = r.y; v[u][2] = r.z; v[u][3] = r.w;
        }
      }
    }
    float4 acc_in[AMP_EPI_BATCH];
#pragma unroll
    for (int u = 0; u < AMP_EPI_BATCH; ++u) {
      acc_in[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (base + u * WG_THREADS < nq && e.acc_in != nullptr) acc_in[u] = *reinterpret_cast<const float4*>(e.acc_in + o[u]);
    }
#pragma unroll
    for (int u = 0; u < AMP_EPI_BATCH; ++u) {
      const int idx = base + u * WG_THREADS;
      if (idx >= nq) continue;
      const int i = idx / nqc;
      const int j = 4 * (idx - i * nqc);
      const float4 bias = *reinterpret_cast<const float4*>(e.bias + n0 + j);
      const float* cs = Cs + i * WG_LDC + j;
      // (conv + bias) + residual, + running sum, * scale: the plain version's order
      float w[4] = {cs[0] + bias.x, cs[1] + bias.y, cs[2] + bias.z, cs[3] + bias.w};
      const float a4[4] = {acc_in[u].x, acc_in[u].y, acc_in[u].z, acc_in[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (e.res != nullptr) w[q] += v[u][q];
        if (e.acc_in != nullptr) w[q] += a4[q];
        w[q] *= e.scale;
      }
      if (e.out_bf16) {
        *reinterpret_cast<uint2*>(static_cast<bf16*>(e.out) + o[u]) =
            make_uint2(pack_bf16x2(w[0], w[1]), pack_bf16x2(w[2], w[3]));
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(e.out) + o[u]) = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
  }
}

void launch_conv(const ConvOp& op, const ConvEpi& e, int B, cudaStream_t s) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv1d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM_BYTES);
  (void)attr;  // a refusal shows as the launch's error
  launch_ex(conv1d_kernel, dim3(B * cdiv(op.T, WG_BM), cdiv(op.C, WG_BN)), dim3(WG_THREADS), WG_SMEM_BYTES,
            dim3(1), s, op, e);
}

template <typename TIn>
void launch_act(const TIn* x, bf16* buf, const float* alpha, const float* inv_beta, const Fir12& f, int B, int T,
                int C, int halo, cudaStream_t s) {
  launch_activation1d<TIn, bf16>(ActArgs{x, buf, alpha, inv_beta, f, B, T, C, halo}, s);
}

// One AMPBlock1 pair on in [B, T, C] (bf16 or f32) as four dependent launches:
// act1(in) into buf, conv_d into conv_out (f32, + b1), act2(conv_out) into
// buf, conv_1 with the caller's epilogue e (whose bias is b2). q: the pair's
// 8 parameters (w1, b1, w2, b2, alpha1, inv_beta1, alpha2, inv_beta2); buf:
// [B, T + 2 halo, C], halo >= d(k-1)/2.
template <typename TIn>
void issue_pair(const TIn* in, bf16* buf, float* conv_out, const void* const* q, int k, int d, int halo,
                const ConvEpi& e, const Fir12& f, int B, int T, int C, cudaStream_t s) {
  const auto weight = [&](int i) { return static_cast<const bf16*>(q[i]); };
  const auto vec = [&](int i) { return static_cast<const float*>(q[i]); };
  launch_act(in, buf, vec(4), vec(5), f, B, T, C, halo, s);
  launch_conv(ConvOp{buf, weight(0), T, C, halo, k, d}, ConvEpi{vec(1), nullptr, 0, nullptr, 1.0f, conv_out, 0},
              B, s);
  launch_act<float>(conv_out, buf, vec(6), vec(7), f, B, T, C, halo, s);
  launch_conv(ConvOp{buf, weight(2), T, C, halo, k, 1}, e, B, s);
}

}  // namespace
}  // namespace svc

// One AMP stage of x [B, T, C] bf16 into out [B, T, C] bf16, as the plain
// version's block and pair loop (ops/pallas/amp_stage.py::amp_stage_plain).
// Scratch (the caller allocates it): buf bf16 [B, T + 2 halo, C] (the conv
// input), conv_out, carry f32 [B, T, C], total f32 [B, T, C] (null when
// n_blocks == 1). Host arrays, planned once (ops/pallas/amp_stage.py::
// stage_table): params, 8 device pointers per pair (w1 [k, C, C] bf16, b1
// f32 [C], w2, b2, alpha1, inv_beta1, alpha2, inv_beta2, f32 [C]); kd, (k, d)
// per pair; pairs_per_block [n_blocks]. taps: the 12 filter taps; halo: the
// largest d(k-1)/2 of the stage. C must be a multiple of 8.
extern "C" int svc_amp_stage(const svc::bf16* x, svc::bf16* out, svc::bf16* buf, float* conv_out, float* carry,
                             float* total, const void* const* params, const int* kd, const int* pairs_per_block,
                             int n_blocks, const float* taps, int B, int T, int C, int halo, void* stream) {
  using namespace svc;
  if (C % 8 != 0 || (n_blocks > 1 && total == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Fir12 f = fir12_from(taps);
  int p = 0;
  for (int bi = 0; bi < n_blocks; ++bi) {
    for (int j = 0; j < pairs_per_block[bi]; ++j, ++p) {
      const void* const* q = params + 8 * p;
      const int k = kd[2 * p];
      const int d = kd[2 * p + 1];
      if (d * (k - 1) / 2 > halo) return (int)cudaErrorInvalidValue;
      // the pair's input: x for a block's first pair, else the block carry
      const bool first = j == 0;
      const void* res = first ? static_cast<const void*>(x) : static_cast<const void*>(carry);
      ConvEpi e{static_cast<const float*>(q[3]), res, first ? 1 : 0, nullptr, 1.0f, carry, 0};
      if (j == pairs_per_block[bi] - 1) {
        if (bi == n_blocks - 1) {
          e.acc_in = total;  // null for a single block
          e.scale = 1.0f / n_blocks;
          e.out = out;
          e.out_bf16 = 1;
        } else {
          e.acc_in = bi > 0 ? total : nullptr;
          e.out = total;
        }
      }
      if (first) {
        issue_pair(x, buf, conv_out, q, k, d, halo, e, f, B, T, C, s);
      } else {
        issue_pair<float>(carry, buf, conv_out, q, k, d, halo, e, f, B, T, C, s);
      }
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// One AMPBlock1 pair (K7) of x [B, T, C] bf16 into out [B, T, C] bf16, as the
// plain version (ops/pallas/amp_pair.py::amp_pair_plain): act1 on f32(x),
// conv_d on bf16 operands with f32 sums + b1, act2 on that f32 output,
// conv_1, then + b2 + f32(x) rounded once to bf16. Scratch (the caller
// allocates it): buf bf16 [B, T + 2H, C], H = d(k-1)/2 (the conv input),
// conv_out f32 [B, T, C]. Parameters in kernel form (ops/pallas/amp_stage.py::
// kernel_params): w1, w2 bf16 [k, C, C]; b1, b2, alpha1, inv_beta1, alpha2,
// inv_beta2 f32 [C]. taps: the 12 filter taps. C must be a multiple of 8, k
// odd, d >= 1.
extern "C" int svc_amp_pair(const svc::bf16* x, svc::bf16* out, svc::bf16* buf, float* conv_out,
                            const svc::bf16* w1, const float* b1, const svc::bf16* w2, const float* b2,
                            const float* alpha1, const float* inv_beta1, const float* alpha2,
                            const float* inv_beta2, const float* taps, int B, int T, int C, int k, int d,
                            void* stream) {
  using namespace svc;
  if (C % 8 != 0 || k % 2 == 0 || d < 1) return (int)cudaErrorInvalidValue;
  const void* const q[8] = {w1, b1, w2, b2, alpha1, inv_beta1, alpha2, inv_beta2};
  const ConvEpi e{b2, x, /*res_bf16*/ 1, nullptr, 1.0f, out, /*out_bf16*/ 1};
  issue_pair(x, buf, conv_out, q, k, d, d * (k - 1) / 2, e, fir12_from(taps), B, T, C,
             static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
