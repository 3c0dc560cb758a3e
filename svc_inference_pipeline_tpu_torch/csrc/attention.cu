// K4: unmasked full-context self-attention of the Whisper encoder.
//
// Replaces: svc_inference_pipeline_tpu/ops/pallas/attention.py
//   encoder_attention, whose kernel holds one (head, 512-row q block)'s
//   [512, T] f32 score block in VMEM against all keys at once.
//
// What bounds it here: at [B, 1500, 1024] with 16 heads of 64 the score
//   matrix is 36M f32 per window; writing it out and reading it back would
//   cost more than the products (4.6 GFLOP per pass per layer). So the
//   scores never leave the SM, and the kernel is bound by how well the
//   tensor cores are fed: the key loop's latency at 24 tiles per block.
//
// Design: one pass over the keys in the shape of FlashAttention-2, with
//   mma.sync.m16n8k16 on bf16 and f32 accumulation. One block of 4 warps per
//   (batch*head, 64-row q tile); each warp owns 16 q rows.
//   - Q is loaded once, scaled by hd^-0.25 and rounded to bf16 (as the JAX
//     wrapper does), and kept as A fragments in registers for the whole loop.
//   - K and V tiles of 64 keys go through a 2-stage cp.async ring in shared
//     memory (rows padded to 72 elements, so ldmatrix is free of bank
//     conflicts); tile j+1 is in flight while tile j computes. Rows >= T are
//     zero-filled (source size 0). K's fragments are scaled and rounded to
//     bf16 in registers right after ldmatrix: bf16(f32(k) * scale), the one
//     rounding the plain version applies.
//   - S = Q K^T stays in registers (16 x 64 f32 per warp). The online
//     softmax runs there too: row max and sum across the quad of lanes that
//     share a row, exp2 with log2(e) folded into one FMA, O and the sum
//     rescaled by exp(m_old - m_new). Keys >= T score -inf.
//   - P = exp(s - m_running) is rounded to bf16 straight into the A
//     fragments of P @ V. (The plain version and the TPU kernel round P after
//     the full normalisation; here the division by the row sum comes at the
//     end, on the f32 O. The difference stays within 2 bf16 ulps of
//     max|out|: tests/test_torch_redesign.py emulates this order on the CPU.)
//   - O / l is rounded to bf16, staged through the warp's own Q rows in
//     shared memory and stored with 16-byte stores; q rows >= T are not stored.
#include "common.cuh"

namespace svc {
namespace {

constexpr int AT_BQ = 64;  // query rows per block
constexpr int AT_BK = 64;  // keys per tile
constexpr int AT_HD = 64;  // head dim
constexpr int AT_LD = AT_HD + 8;
constexpr int AT_THREADS = 128;
constexpr float AT_LOG2E = 1.4426950408889634f;

// rows [t0, t0+64) x the head's 64 columns of a [B, T, D] tensor -> shared, async
__device__ __forceinline__ void load_rows(const bf16* src, int b, int t0, int T, int D, int col0,
                                          bf16 (*dst)[AT_LD]) {
#pragma unroll
  for (int it = 0; it < AT_BQ * AT_HD / 8 / AT_THREADS; ++it) {
    const int v = it * AT_THREADS + threadIdx.x;
    const int row = v >> 3;
    const int c = (v & 7) << 3;
    const int t = t0 + row;
    const bool ok = t < T;
    cp_async16(&dst[row][c], ok ? src + ((size_t)b * T + t) * D + col0 + c : src, ok ? 16 : 0);
  }
}

// bf16(f32(x) * scale) on both halves of a fragment register
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t r, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  return pack_bf16x2(f.x * scale, f.y * scale);
}

__global__ void __launch_bounds__(AT_THREADS)
    encoder_attention_kernel(const bf16* q, const bf16* k, const bf16* v, bf16* out, int T,
                             int H, float scale) {
  __shared__ __align__(128) bf16 Qs[AT_BQ][AT_LD];
  __shared__ __align__(128) bf16 Ks[2][AT_BK][AT_LD];
  __shared__ __align__(128) bf16 Vs[2][AT_BK][AT_LD];

  const int t0 = blockIdx.x * AT_BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int D = H * AT_HD;
  const int col0 = h * AT_HD;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quad = lane & 3;  // column pair within an 8-column fragment
  const int n_tiles = cdiv(T, AT_BK);
  const float neg_inf = __int_as_float(0xff800000);

  load_rows(q, b, t0, T, D, col0, Qs);
  load_rows(k, b, 0, T, D, col0, Ks[0]);
  load_rows(v, b, 0, T, D, col0, Vs[0]);
  cp_async_commit();

  uint32_t qf[4][4];     // Q A fragments, 4 k16 steps over the head dim
  float o[8][4] = {};    // O: 8 fragments of 8 head columns
  float m_run[2] = {neg_inf, neg_inf};  // rows lane/4 and lane/4 + 8, log2 units
  float l_run[2] = {0.0f, 0.0f};        // this lane's part of the row sums

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile kt visible to all; every warp is done with tile kt-1
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        ldsm_x4(qf[kk], &Qs[16 * w + (lane & 15)][16 * kk + (lane >> 4) * 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[kk][i] = scale_bf16x2(qf[kk][i], scale);
      }
    }
    if (kt + 1 < n_tiles) {
      load_rows(k, b, (kt + 1) * AT_BK, T, D, col0, Ks[st ^ 1]);
      load_rows(v, b, (kt + 1) * AT_BK, T, D, col0, Vs[st ^ 1]);
    }
    cp_async_commit();

    // S = Q K^T: s[j] holds keys 8j + 2*quad + {0, 1} of rows lane/4 and lane/4 + 8
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, &Ks[st][16 * jp + (lane >> 4) * 8 + (lane & 7)][16 * kk + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int i = 0; i < 4; ++i) kb[i] = scale_bf16x2(kb[i], scale);
        mma_bf16_16816(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_bf16_16816(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }
    if ((kt + 1) * AT_BK > T) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kt * AT_BK + 8 * j + 2 * quad + (e & 1) >= T) s[j][e] = neg_inf;
    }

    // online softmax in registers (log2 units)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]) * AT_LOG2E);
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]) * AT_LOG2E);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], AT_LOG2E, -mx[e >> 1]));
        l_run[e >> 1] += s[j][e];
      }

    // O += bf16(P) @ V: the S fragments of keys 16kk..16kk+15 are P's A fragment
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, &Vs[st][16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)][16 * jp + (lane >> 4) * 8]);
        mma_bf16_16816(o[2 * jp], pa, vb[0], vb[1]);
        mma_bf16_16816(o[2 * jp + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // O / l -> bf16 into the warp's own Q rows, then 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.0f / l;
  }
  const int r0 = 16 * w + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(&Qs[r0][8 * j + 2 * quad]) = pack_bf16x2(o[j][0] * inv[0], o[j][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(&Qs[r0 + 8][8 * j + 2 * quad]) = pack_bf16x2(o[j][2] * inv[1], o[j][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int idx = it * 32 + lane;
    const int row = 16 * w + (idx >> 3);
    const int c = (idx & 7) << 3;
    const int t = t0 + row;
    if (t < T) {
      *reinterpret_cast<uint4*>(out + ((size_t)b * T + t) * D + col0 + c) =
          *reinterpret_cast<const uint4*>(&Qs[row][c]);
    }
  }
}

}  // namespace
}  // namespace svc

// q, k, v, out: bf16 [B, T, H*64], contiguous. scale: hd^-0.25 (applied to q and k).
extern "C" int svc_encoder_attention(const svc::bf16* q, const svc::bf16* k,
                                     const svc::bf16* v, svc::bf16* out, int B, int T, int H,
                                     float scale, void* stream) {
  using namespace svc;
  const dim3 grid(cdiv(T, AT_BQ), B * H);
  encoder_attention_kernel<<<grid, AT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, out, T, H, scale);
  return (int)cudaGetLastError();
}
