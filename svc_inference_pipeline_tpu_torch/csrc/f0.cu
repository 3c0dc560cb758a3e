// K9: Praat's autocorrelation pitch tracker (Boersma 1993) and the median
// pitch shift onto the mel grid, for a batch of clips.
//
// Replaces no TPU kernel. The JAX package runs this tracker as one XLA region
//   pinned to the host (svc_inference_pipeline_tpu/ops/f0.py, praat_pitch_ac:
//   XLA on the TPU took ~0.8 s for it), and the port ran it as numpy on a
//   host thread (ops/f0.py::praat_pitch_ac, its Viterbi a Python loop over
//   frames) while the device waited for the melody. Here it runs on the
//   caller's stream, on the waveform the device front-end reads, and writes
//   the melody [B, padded] the condition encoder reads.
//
// What bounds it: the direct autocorrelation, sum_k (W - k) multiply-adds a
//   frame for lags k <= max_lag (0.46 M at W = 1106, max_lag = 553; 0.43 G
//   for the 940 frames of a 10 s clip), in float64; and the Viterbi, one
//   dependent step a frame over 15 states, which no number of SMs shortens.
//
// Design: three launches, each a grid over the batch's clips.
//   (a) clip_stats_kernel, a block a clip: its mean and max|x - mean| over
//       its true length (Praat's global peak), in one pass over the samples.
//   (b) frame_kernel, a block a (frame, clip): the frame, its local mean, the
//       Hann window and the intensity in float32 as the host tracker computes
//       them; then the frame in float64 in shared memory and its
//       autocorrelation summed there. A thread holds R = 9 consecutive lags
//       and slides a window of 9 samples through registers: 2 shared loads
//       for 9 FMAs, the lanes' windows 9 doubles apart (an odd stride: a
//       half-warp's loads fall on 16 distinct bank pairs), the samples split
//       into NQ runs whose partial sums are added in a fixed order. A product
//       of two float32 samples is exact in float64. Then the normalisation,
//       the parabolic peaks, the rank with octave cost, and the best 14 peaks
//       in descending rank, ties to the lower lag (the order of a stable
//       descending sort and of lax.top_k), by counting over the frame's peaks
//       compacted in lag order.
//   (c) viterbi_kernel, a block a clip: its first warp runs the Viterbi (lane
//       j the state j, scores in float64, the previous scores by shuffles, the
//       argmax a tree whose ties go to the lowest previous state,
//       back-pointers a byte a state) and the backtrace, 32 frames a
//       chunk through shuffles; then the block pads the track onto the mel
//       grid, takes the voiced median by a radix select (the mean of the two
//       middle values for an even count, in float32, as numpy's median), and
//       writes the shifted melody, zero past the clip's frames.
//   A clip's blocks read only its own row and parameters, and every sum runs
//   in an order fixed by the shapes, so a batched clip gives the same bits as
//   the clip alone. Nothing here synchronises with the host.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace svc_f0 {

constexpr int K = 15;           // Viterbi states: unvoiced + Praat's max_candidates - 1 peaks
constexpr int KS = 16;          // state stride of the candidate and back-pointer rows
constexpr int MAX_CLIPS = 64;   // clips a call (the wrapper splits larger batches)
constexpr int R = 9;            // lags a thread of the autocorrelation holds
constexpr int THREADS = 256;    // frame and Viterbi blocks
constexpr int WARPS = THREADS / 32;
constexpr int STATS_THREADS = 1024;
constexpr int MAX_LAGS_PER_THREAD = 4;  // lags a thread of the peak search evaluates

struct Praat {
  const float* audio;     // [B, ld] float32, clip b's samples in [0, n_samples[b])
  int ld;
  const float* window;    // [W] Praat's Hann window, float32
  const double* hann_ac;  // [max_lag + 1] its normalised autocorrelation
  int W, half_window, period, lo, hi, max_lag, lag_min;
  int G, GW, NQ, Wq, xs_len, list_len;  // autocorrelation layout (svc_praat_f0)
  double fs, dt, f0_min, f0_max, octave_cost, ojc, vuc, target_median;
  float voicing_threshold, uv_scale, silence_threshold, pitch_factor;
  int use_pitch_factor;
  int F;                  // frame stride of the scratch rows (the batch's most frames)
  int padded;             // melody row length
  float* gpeak;           // [B] global peak + 1e-30
  double* local;          // [B, F, KS] local strengths (unvoiced first; -inf: no candidate)
  double* lf;             // [B, F, KS] log2 frequency (-inf: unvoiced or no candidate)
  float* freq;            // [B, F, KS] frequency (0: unvoiced or no candidate)
  uint8_t* back;          // [B, F, KS] back-pointers
  float* track;           // [B, F] the Viterbi path's F0
  float* melody;          // [B, padded]
  int n_samples[MAX_CLIPS], n_pf[MAX_CLIPS], pad[MAX_CLIPS], n_mel[MAX_CLIPS];
  double t1[MAX_CLIPS];
};

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct MinF {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};

// Reduce over the block; every thread gets the same value. The xor butterfly
// leaves each lane the same bits, and the warps' totals are taken in warp
// order, so the result depends on the block's shape alone.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // red may still be read by the reduction before this one
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = op(v, red[w]);
  return v;
}

// (a) mean and global peak of each clip, in one pass: the rounded difference
// x - mean is monotone in x, so its largest magnitude is at the clip's
// largest or smallest sample
__global__ void __launch_bounds__(STATS_THREADS) clip_stats_kernel(const Praat p) {
  constexpr int U = 8;  // independent loads in flight a thread
  __shared__ double red_d[STATS_THREADS / 32];
  __shared__ float red_f[STATS_THREADS / 32];
  const int b = blockIdx.x, n = p.n_samples[b];
  const float* x = p.audio + (size_t)b * p.ld;
  double s[U];
  float hi = -CUDART_INF_F, lo = CUDART_INF_F;
#pragma unroll
  for (int u = 0; u < U; ++u) s[u] = 0.0;
  for (int j0 = threadIdx.x; j0 < n; j0 += U * STATS_THREADS) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * STATS_THREADS;
      if (j < n) {
        const float v = x[j];
        s[u] += (double)v;
        hi = fmaxf(hi, v);
        lo = fminf(lo, v);
      }
    }
  }
#pragma unroll
  for (int u = 1; u < U; ++u) s[0] += s[u];
  const double sum = block_reduce(s[0], Sum(), red_d);
  hi = block_reduce(hi, MaxF(), red_f);
  lo = block_reduce(lo, MinF(), red_f);
  const float mean = (float)(sum / (double)n);
  if (threadIdx.x == 0) p.gpeak[b] = __fadd_rn(fmaxf(fabsf(__fsub_rn(hi, mean)), fabsf(__fsub_rn(lo, mean))), 1e-30f);
}

// (b) one frame: autocorrelation, peaks, the 15 candidates
__global__ void __launch_bounds__(THREADS) frame_kernel(const Praat p) {
  extern __shared__ double smem[];
  double* xs = smem;                       // [xs_len] the windowed frame, zero past W
  double* part = smem + p.list_len;        // [NQ][R G] partial sums of the autocorrelation
  double* r = part + p.NQ * R * p.G;       // [max_lag + 1] normalised autocorrelation
  // once the sums are taken, xs's region holds the frame's peaks in lag order
  double* pk_rank = smem;
  double* pk_rstar = smem + p.max_lag;
  double* pk_lag = smem + 2 * p.max_lag;
  __shared__ double red_d[WARPS];
  __shared__ float red_f[WARPS];
  __shared__ int warp_count[WARPS];
  __shared__ int slot[K - 1];

  const int i = blockIdx.x, b = blockIdx.y;
  if (i >= p.n_pf[b]) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n_samples[b];
  const float* x = p.audio + (size_t)b * p.ld;
  if (tid < K - 1) slot[tid] = -1;

  // the frame's centre, rint((t1 + i dt) fs) unfused in float64 (numpy rounds half to even, as rint)
  const long long center = (long long)rint(__dmul_rn(__dadd_rn(p.t1[b], __dmul_rn((double)i, p.dt)), p.fs));

  // local mean over one longest period on each side of the centre
  double s = 0.0;
  for (int m = tid; m < 2 * p.period; m += THREADS) {
    const long long j = center - p.period + m;
    s += (j >= 0 && j < n) ? (double)x[j] : 0.0;
  }
  s = block_reduce(s, Sum(), red_d);
  const float mean = (float)(s / (double)(2 * p.period));

  // windowed frame (float32), its peak over half a period on each side of the centre
  const long long start = center - p.half_window;
  float peak = 0.f;
  for (int j = tid; j < p.xs_len; j += THREADS) {
    double v = 0.0;
    if (j < p.W) {
      const long long k = start + j;
      const float xv = (k >= 0 && k < n) ? x[k] : 0.f;
      const float fw = __fmul_rn(__fsub_rn(xv, mean), p.window[j]);
      if (j >= p.lo && j < p.hi) peak = fmaxf(peak, fabsf(fw));
      v = (double)fw;
    }
    xs[j] = v;
  }
  peak = block_reduce(peak, MaxF(), red_f);  // its barriers also publish xs
  const float intensity = fminf(__fdiv_rn(peak, p.gpeak[b]), 1.0f);

  // autocorrelation: warp w takes the sample run q = w / GW and lag groups g = (w % GW) 32 + lane
  {
    const int q = warp / p.GW, g = (warp % p.GW) * 32 + lane;
    if (q < p.NQ && g < p.G) {
      const int base = R * g, n0 = q * p.Wq, n1 = n0 + p.Wq;
      double acc[R], win[R];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        acc[k] = 0.0;
        win[k] = xs[n0 + base + k];
      }
      // slot (u + k) % R holds sample m + u + base + k at sub-step u
      for (int m = n0; m < n1; m += R) {
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const double a = xs[m + u];
#pragma unroll
          for (int k = 0; k < R; ++k) acc[k] = fma(a, win[(u + k) % R], acc[k]);
          win[u] = xs[m + u + base + R];
        }
      }
#pragma unroll
      for (int k = 0; k < R; ++k) part[q * R * p.G + base + k] = acc[k];
    }
  }
  __syncthreads();
  {
    const int gr = R * p.G;
    double ac0 = 0.0;
    for (int q = 0; q < p.NQ; ++q) ac0 += part[q * gr];
    for (int k = tid; k <= p.max_lag; k += THREADS) {
      double ac = 0.0;
      for (int q = 0; q < p.NQ; ++q) ac += part[q * gr + k];
      r[k] = ac / (ac0 + 1e-30) / p.hann_ac[k];
    }
  }
  __syncthreads();

  // parabolic peaks over lags 1 .. max_lag - 1; thread tid takes C consecutive lags
  const int n_lags = p.max_lag - 1, c_per = (n_lags + THREADS - 1) / THREADS;
  bool ok[MAX_LAGS_PER_THREAD];
  double my_rank[MAX_LAGS_PER_THREAD], my_rstar[MAX_LAGS_PER_THREAD], my_lag[MAX_LAGS_PER_THREAD];
  int cnt = 0;
#pragma unroll
  for (int c = 0; c < MAX_LAGS_PER_THREAD; ++c) {
    ok[c] = false;
    my_rank[c] = my_rstar[c] = my_lag[c] = 0.0;
    const int l = 1 + tid * c_per + c;
    if (c < c_per && l <= n_lags) {
      const double rm1 = r[l - 1], r0 = r[l], rp1 = r[l + 1];
      if (r0 > rm1 && r0 >= rp1 && l >= p.lag_min) {
        const double denom = (rm1 - 2.0 * r0) + rp1;
        double shift = fabs(denom) > 1e-12 ? 0.5 * (rm1 - rp1) / denom : 0.0;
        shift = fmin(fmax(shift, -0.5), 0.5);
        const double lag = (double)l + shift;
        double rstar = __dsub_rn(r0, __dmul_rn(0.25 * (rm1 - rp1), shift));
        if (rstar > 1.0) rstar = 1.0 / rstar;
        const double f = p.fs / lag;
        if (f <= p.f0_max && f > 0.0) {
          ok[c] = true;
          my_rank[c] = __dsub_rn(rstar, __dmul_rn(p.octave_cost, log2(__dmul_rn(p.f0_min, lag) / p.fs)));
          my_rstar[c] = rstar;
          my_lag[c] = lag;
          ++cnt;
        }
      }
    }
  }
  // compact the peaks in lag order: an exclusive scan of the counts
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_count[warp] = incl;
  __syncthreads();
  int off = incl - cnt, n_peaks = 0;
  for (int w = 0; w < WARPS; ++w) {
    const int c = warp_count[w];
    if (w < warp) off += c;
    n_peaks += c;
  }
#pragma unroll
  for (int c = 0; c < MAX_LAGS_PER_THREAD; ++c) {
    if (ok[c]) {
      pk_rank[off] = my_rank[c];
      pk_rstar[off] = my_rstar[c];
      pk_lag[off] = my_lag[c];
      ++off;
    }
  }
  __syncthreads();
  // each peak's place in descending rank, ties to the lower lag
  for (int e = tid; e < n_peaks; e += THREADS) {
    const double re = pk_rank[e];
    int pos = 0;
    for (int e2 = 0; e2 < n_peaks; ++e2) {
      const double r2 = pk_rank[e2];
      pos += (r2 > re) || (r2 == re && e2 < e);
    }
    if (pos < K - 1) slot[pos] = e;
  }
  __syncthreads();

  if (tid < KS) {
    double loc = -CUDART_INF, lfv = -CUDART_INF;
    float fq = 0.f;
    if (tid == 0) {
      // the unvoiced strength, in float32 as the host tracker computes it
      const float drop = __fdiv_rn(__fmul_rn(intensity, p.uv_scale), p.silence_threshold);
      loc = (double)__fadd_rn(p.voicing_threshold, fmaxf(0.f, __fsub_rn(2.f, drop)));
    } else if (tid < K && slot[tid - 1] >= 0) {
      const int e = slot[tid - 1];
      const double f = p.fs / pk_lag[e];
      loc = __dsub_rn(pk_rstar[e], __dmul_rn(p.octave_cost, log2(p.f0_max / fmax(f, 1e-6))));
      lfv = log2(f);
      fq = (float)f;
    }
    const size_t row = ((size_t)b * p.F + i) * KS + tid;
    p.local[row] = loc;
    p.lf[row] = lfv;
    p.freq[row] = fq;
  }
}

// the track of clip b padded (centred) onto its mel frames
struct MelGrid {
  const float* track;
  int n_frames, pad, n_mel;
  __device__ float operator()(int m) const {
    const int k = m - pad;
    return (k >= 0 && k < n_frames) ? track[k] : 0.f;
  }
};

// The k-th smallest (from 0) of the grid's voiced (positive) values: a radix
// select over their bits, 8 at a time. Called by the whole block.
__device__ float select_voiced(const MelGrid& g, unsigned k, unsigned* hist, unsigned* sel) {
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int d = threadIdx.x; d < 256; d += blockDim.x) hist[d] = 0;
    __syncthreads();
    for (int m = threadIdx.x; m < g.n_mel; m += blockDim.x) {
      const float v = g(m);
      const unsigned u = __float_as_uint(v);
      if (v != 0.f && (u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned cum = 0;
      int d = 0;
      while (cum + hist[d] <= k) cum += hist[d++];
      sel[0] = prefix | ((unsigned)d << shift);
      sel[1] = k - cum;
    }
    __syncthreads();
    prefix = sel[0];
    k = sel[1];
    mask |= 0xffu << shift;
    __syncthreads();  // sel and hist are written again
  }
  return __uint_as_float(prefix);
}

// (c) Viterbi, backtrace, median pitch shift, melody
__global__ void __launch_bounds__(THREADS) viterbi_kernel(const Praat p) {
  __shared__ unsigned hist[256], sel[2];
  __shared__ int red_i[WARPS];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int n_frames = p.n_pf[b];
  const size_t row0 = (size_t)b * p.F;

  if (tid < 32) {
    const int j = lane & (KS - 1);  // lanes 16-31 repeat 0-15 and store nothing
    double s = p.local[row0 * KS + j], lfp = p.lf[row0 * KS + j];
    double nl[4], nlf[4];  // the next 4 frames' strengths and log2 frequencies
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      nl[d] = nlf[d] = 0.0;
      if (1 + d < n_frames) {
        nl[d] = p.local[(row0 + 1 + d) * KS + j];
        nlf[d] = p.lf[(row0 + 1 + d) * KS + j];
      }
    }
    // no barrier in the loop (a warp barrier orders memory, so it would wait
    // for the prefetches): the previous scores come by shuffles
    for (int t0 = 1; t0 < n_frames; t0 += 4) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int t = t0 + d;
        if (t < n_frames) {
          const double l = nl[d], lfc = nlf[d];
          if (t + 4 < n_frames) {
            nl[d] = p.local[(row0 + t + 4) * KS + j];
            nlf[d] = p.lf[(row0 + t + 4) * KS + j];
          }
          const bool cv = lfc > -CUDART_INF;
          double tot[K];
#pragma unroll
          for (int i = 0; i < K; ++i) {
            const double si = __shfl_sync(0xffffffffu, s, i), lpi = __shfl_sync(0xffffffffu, lfp, i);
            const bool pv = lpi > -CUDART_INF;
            const double tr = (pv && cv) ? __dmul_rn(p.ojc, fabs(lpi - lfc)) : (pv == cv ? 0.0 : p.vuc);
            tot[i] = __dadd_rn(__dsub_rn(si, tr), l);
          }
          // argmax as a tree, the left (lower) state kept on ties: the first maximum
          int arg[K];
#pragma unroll
          for (int i = 0; i < K; ++i) arg[i] = i;
#pragma unroll
          for (int w = 1; w < K; w *= 2) {
#pragma unroll
            for (int i = 0; i + w < K; i += 2 * w) {
              if (tot[i + w] > tot[i]) {
                tot[i] = tot[i + w];
                arg[i] = arg[i + w];
              }
            }
          }
          if (lane < KS) p.back[(row0 + t) * KS + lane] = (uint8_t)arg[0];
          s = tot[0];
          lfp = lfc;
        }
      }
    }
    __syncwarp();  // the back-pointers, read across lanes below
    int state = 0;
    double bs = __shfl_sync(0xffffffffu, s, 0);
    for (int i = 1; i < K; ++i) {
      const double si = __shfl_sync(0xffffffffu, s, i);
      if (si > bs) {
        bs = si;
        state = i;
      }
    }
    // backtrace: lane l loads the back-pointer row of frame hi - l, the walk shuffles it in
    for (int hi = n_frames - 1; hi >= 0; hi -= 32) {
      const int t = hi - lane;
      uint4 rowv = make_uint4(0u, 0u, 0u, 0u);
      if (t >= 1) rowv = *reinterpret_cast<const uint4*>(p.back + (row0 + t) * KS);
      int mine = 0;
      for (int l = 0; l < 32 && hi - l >= 0; ++l) {
        if (lane == l) mine = state;
        if (hi - l >= 1) {
          const int q = state >> 2;
          const unsigned word = q == 0 ? rowv.x : q == 1 ? rowv.y : q == 2 ? rowv.z : rowv.w;
          const unsigned w = __shfl_sync(0xffffffffu, word, l);
          state = (int)((w >> (8 * (state & 3))) & 0xffu);
        }
      }
      if (t >= 0) p.track[row0 + t] = p.freq[(row0 + t) * KS + mine];
    }
  }
  __syncthreads();

  const MelGrid g{p.track + row0, n_frames, p.pad[b], p.n_mel[b]};
  float factor = p.pitch_factor;
  if (!p.use_pitch_factor) {
    factor = 1.f;  // no voiced frame: the track as it is
    int c = 0;
    for (int m = tid; m < g.n_mel; m += THREADS) c += g(m) != 0.f;
    c = block_reduce(c, Sum(), red_i);
    if (c > 0) {
      float med;
      if (c & 1) {
        med = select_voiced(g, (unsigned)(c / 2), hist, sel);
      } else {
        const float a = select_voiced(g, (unsigned)(c / 2 - 1), hist, sel);
        const float z = select_voiced(g, (unsigned)(c / 2), hist, sel);
        med = __fmul_rn(__fadd_rn(a, z), 0.5f);
      }
      factor = (float)(p.target_median / (double)med);
    }
  }
  float* out = p.melody + (size_t)b * p.padded;
  for (int m = tid; m < p.padded; m += THREADS) out[m] = m < g.n_mel ? __fmul_rn(g(m), factor) : 0.f;
}

}  // namespace svc_f0

// audio: [B, ld] f32 device; n_samples, n_pf (Praat frames), t1 (first frame's
// time), pad (the mel grid's left padding), n_mel (mel frames): host arrays of
// B; F >= max n_pf; window [W] f32 and hann_ac [max_lag + 1] f64 device tables;
// geom (host): W, half_window, period, lo, hi, max_lag, lag_min; consts (host):
// fs, dt, f0_min, f0_max, octave_cost, ojc, vuc, target_median; fconsts (host):
// voicing_threshold, 1 + voicing_threshold, silence_threshold, pitch_factor
// (float32); scratch: gpeak [B], local and lf [B, F, 16] f64, freq [B, F, 16]
// f32, back [B, F, 16] u8 (16-byte aligned), track [B, F] f32; melody [B,
// padded] f32. Three launches on stream; returns the first launch error.
extern "C" int svc_praat_f0(const float* audio, int B, int ld, const int* n_samples, const int* n_pf,
                            const double* t1, const int* pad, const int* n_mel, int F, int padded,
                            const float* window, const double* hann_ac, const int* geom, const double* consts,
                            const float* fconsts, int use_pitch_factor, float* gpeak, double* local, double* lf,
                            float* freq, unsigned char* back, float* track, float* melody, void* stream) {
  using namespace svc_f0;
  if (B < 1 || B > MAX_CLIPS || F < 1 || padded < 1) return (int)cudaErrorInvalidValue;
  Praat p{};
  p.audio = audio;
  p.ld = ld;
  p.window = window;
  p.hann_ac = hann_ac;
  p.W = geom[0];
  p.half_window = geom[1];
  p.period = geom[2];
  p.lo = geom[3];
  p.hi = geom[4];
  p.max_lag = geom[5];
  p.lag_min = geom[6];
  if (p.W < 2 || p.max_lag < 2 || p.max_lag >= p.W || p.period < 1) return (int)cudaErrorInvalidValue;
  if ((p.max_lag - 1 + THREADS - 1) / THREADS > MAX_LAGS_PER_THREAD) return (int)cudaErrorInvalidValue;
  p.G = (p.max_lag + 1 + R - 1) / R;
  p.GW = (p.G + 31) / 32;
  p.NQ = WARPS / p.GW;
  if (p.NQ < 1) return (int)cudaErrorInvalidValue;
  p.Wq = R * (((p.W + p.NQ - 1) / p.NQ + R - 1) / R);
  p.xs_len = p.NQ * p.Wq + R * p.G;
  p.list_len = p.xs_len > 3 * p.max_lag ? p.xs_len : 3 * p.max_lag;
  const size_t smem = sizeof(double) * ((size_t)p.list_len + (size_t)p.NQ * R * p.G + p.max_lag + 1);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  p.fs = consts[0];
  p.dt = consts[1];
  p.f0_min = consts[2];
  p.f0_max = consts[3];
  p.octave_cost = consts[4];
  p.ojc = consts[5];
  p.vuc = consts[6];
  p.target_median = consts[7];
  p.voicing_threshold = fconsts[0];
  p.uv_scale = fconsts[1];
  p.silence_threshold = fconsts[2];
  p.pitch_factor = fconsts[3];
  p.use_pitch_factor = use_pitch_factor;
  p.F = F;
  p.padded = padded;
  p.gpeak = gpeak;
  p.local = local;
  p.lf = lf;
  p.freq = freq;
  p.back = back;
  p.track = track;
  p.melody = melody;
  for (int b = 0; b < B; ++b) {
    if (n_samples[b] < 1 || n_samples[b] > ld || n_pf[b] < 1 || n_pf[b] > F || n_mel[b] > padded)
      return (int)cudaErrorInvalidValue;
    p.n_samples[b] = n_samples[b];
    p.n_pf[b] = n_pf[b];
    p.t1[b] = t1[b];
    p.pad[b] = pad[b];
    p.n_mel[b] = n_mel[b];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  clip_stats_kernel<<<B, STATS_THREADS, 0, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  frame_kernel<<<dim3(F, B), THREADS, smem, s>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  viterbi_kernel<<<B, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
