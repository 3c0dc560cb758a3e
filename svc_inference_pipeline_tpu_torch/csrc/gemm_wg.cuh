// The pipelined bf16 GEMM tile of the denoiser (the bf16 launches of K6,
// every phase of K8) and of K2's convs: one warpgroup (128 threads) computes
// a 64 x 64 f32 tile with wgmma.mma_async m64n64k16 over K in chunks of 64.
// K1 and K5 build their own tile from its pieces (denoiser_step.cu).
// gemm_wg_s8.cuh builds K6's int8 tile from the same swizzle, descriptors,
// ring and dependent-launch rule.
//
// Operands: A is a 64-row box of a row-major bf16 matrix (or f32, converted
// on the way in), B a row-major [K, ldw] bf16 weight whose tile columns are
// two 32-column slices (col_lo, col_hi): adjacent for a plain tile, C apart
// for the gated layers' paired tile. Both wait in shared memory in the
// 128-byte-swizzle layout wgmma reads: a tile row is 128 bytes (64 bf16), its
// 16-byte chunk c stored at chunk c ^ (row % 8) of a 1024-byte-aligned tile.
// A is K-major; B is read MN-major (its rows are K), so the B descriptor's
// transpose bit is set and B never needs a transposed copy.
//
// Pipeline: a ring of WG_STAGES (A, B) stages in dynamic shared memory,
// filled by cp.async.cg (16 bytes a thread) with one commit group per chunk.
// Chunk k+3 is in flight while chunk k multiplies. A f32 A (the prologue's
// mel and the skip projection's sum) is loaded, scaled and rounded
// synchronously into its stage instead. Rows of A at or past `nvalid` read
// nothing and are zero.
//
// Dependent launches: a launch may read before grid_dependency_wait()
// anything that the launch just before it does not write. Its blocks start
// only when every block of that launch has triggered its dependents (never
// before its own wait) or exited, so what the launches before that one wrote
// is complete and visible. wg_gemm's launches trigger nothing and use the
// narrowest form of the rule: the weights' first
// WG_STAGES - 1 chunks (wg_prefetch_b), which no launch writes, then the
// wait, then A (wg_gemm_main); the caller's epilogue runs after the wait too.
// K1 and K5's tile puts everything but the launch before's output in flight
// before the wait. K8, one cooperative launch, calls the two halves itself
// and issues a phase's first weight chunks before the grid barrier that
// opens the phase.
#pragma once

#include "common.cuh"

namespace svc {

constexpr int WG_BM = 64;
constexpr int WG_BN = 64;
constexpr int WG_BK = 64;
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 128;
constexpr int WG_TILE_BYTES = WG_BM * WG_BK * 2;  // one A or B tile of a stage
constexpr int WG_STAGE_BYTES = 2 * WG_TILE_BYTES;
constexpr int WG_SMEM_BYTES = WG_STAGES * WG_STAGE_BYTES + 1024;  // + room to align to 1024
constexpr int WG_LDC = WG_BN + 4;  // f32 result tile, aliased on the ring after the K loop

struct WgA {
  const void* row0;  // element (row 0, column 0) of the tile's box: bf16, or f32 when A_F32
  int ld;            // row stride, elements
  int nvalid;        // rows >= nvalid are zero
  float scale;       // f32 A: multiplied before rounding to bf16
};

struct WgB {
  const bf16* w;  // row 0 of the K range this tile reads
  int ldw;        // row stride, elements
  int col_lo;     // weight column of tile columns 0..31
  int col_hi;     // weight column of tile columns 32..63
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t s = smem_u32(p);
  return p + (((s + 1023u) & ~1023u) - s);
}

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows (128B swizzle)
__device__ __forceinline__ int sw128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// wgmma shared-memory descriptor, 128B swizzle. SBO: 1024 bytes between
// groups of 8 rows; LBO: 16 bytes for K-major A (unused there), 1024 for
// MN-major B (unused too: its 64 columns are one swizzle atom wide).
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo_bytes) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024u >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major) @ B (16 x 64, MN-major)
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <bool A_F32>
__device__ __forceinline__ void wg_load_a(const WgA& a, int k0, uint8_t* As) {
#pragma unroll
  for (int it = 0; it < WG_BM * 8 / WG_THREADS; ++it) {
    const int v = it * WG_THREADS + threadIdx.x;
    const int r = v >> 3;
    const int c = v & 7;
    const bool ok = r < a.nvalid;
    if constexpr (A_F32) {
      float f[8] = {};
      if (ok) {
        const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(a.row0) +
                                                          (size_t)r * a.ld + k0 + 8 * c);
        const float4 x0 = p[0];
        const float4 x1 = p[1];
        f[0] = x0.x; f[1] = x0.y; f[2] = x0.z; f[3] = x0.w;
        f[4] = x1.x; f[5] = x1.y; f[6] = x1.z; f[7] = x1.w;
      }
      uint4 packed;
      uint32_t* pv = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = pack_bf16x2(f[2 * i] * a.scale, f[2 * i + 1] * a.scale);
      *reinterpret_cast<uint4*>(As + sw128(r, c)) = packed;
    } else {
      const bf16* src = static_cast<const bf16*>(a.row0);
      cp_async16(As + sw128(r, c), ok ? src + (size_t)r * a.ld + k0 + 8 * c : src, ok ? 16 : 0);
    }
  }
}

__device__ __forceinline__ void wg_load_b(const WgB& bw, int k0, uint8_t* Bs) {
#pragma unroll
  for (int it = 0; it < WG_BK * 8 / WG_THREADS; ++it) {
    const int v = it * WG_THREADS + threadIdx.x;
    const int r = v >> 3;
    const int c = v & 7;
    const int col = c < 4 ? bw.col_lo + 8 * c : bw.col_hi + 8 * (c - 4);
    cp_async16(Bs + sw128(r, c), bw.w + (size_t)(k0 + r) * bw.ldw + col);
  }
}

// The generic pipeline over nk chunks of K: load_a(kt, As) and load_b(kt,
// Bs) issue the cp.async copies (or synchronous stores) of chunk kt's A and
// B tiles into a ring stage, in the 128-byte-swizzle layout; each is called
// once per chunk, in increasing kt. The conv of K2 and K7 (amp_stage.cu)
// brings its own loaders; wg_gemm_main below is the plain box and weight.
//
// The first WG_STAGES - 1 weight chunks into their ring stages, uncommitted:
// wg_gemm_loop commits them with the A chunks of the same stages.
template <class LoadB>
__device__ __forceinline__ void wg_prefetch(int nk, uint8_t* ring, LoadB load_b) {
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s)
    if (s < nk) load_b(s, ring + s * WG_STAGE_BYTES + WG_TILE_BYTES);
}

// Cs[64][WG_LDC] (aliased on the ring) <- A @ B over nk chunks, after
// wg_prefetch(nk, ring, load_b). A block that runs a second tile must
// __syncthreads() after its epilogue has read Cs, before the next prefetch.
// Each chunk's products complete (wgmma.wait_group 0) before the barrier
// that opens the next chunk, so the stage a refill overwrites, chunk kt-1's,
// is free for every warp once the block has passed that barrier.
template <class LoadA, class LoadB>
__device__ __forceinline__ float* wg_gemm_loop(int nk, uint8_t* ring, LoadA load_a, LoadB load_b) {
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s) {
    if (s < nk) load_a(s, ring + s * WG_STAGE_BYTES);
    cp_async_commit();
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<WG_STAGES - 2>();  // chunk kt has landed (this thread's copies)
    fence_proxy_async();             // ... and is visible to wgmma's async proxy
    __syncthreads();                 // for every thread; chunk kt-1's stage is free
    const int pf = kt + WG_STAGES - 1;
    if (pf < nk) {
      uint8_t* stage = ring + (pf % WG_STAGES) * WG_STAGE_BYTES;
      load_a(pf, stage);
      load_b(pf, stage + WG_TILE_BYTES);
    }
    cp_async_commit();
    const uint8_t* stage = ring + (kt % WG_STAGES) * WG_STAGE_BYTES;
    const uint64_t da = wg_desc(stage, 16);
    const uint64_t db = wg_desc(stage + WG_TILE_BYTES, 1024);
    wg_fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: 16 columns = 32 bytes further along the row; B: 16 rows = 2048 bytes
      wgmma_64x64x16(acc, da + 2 * kk, db + 128 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    wg_fence_acc(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before it becomes Cs
  float* Cs = reinterpret_cast<float*>(ring);
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = 16 * w + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<float2*>(&Cs[row * WG_LDC + col]) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(&Cs[(row + 8) * WG_LDC + col]) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  return Cs;
}

// The plain operands: A a row box (WgA), B a weight (WgB), K a multiple of 64.
__device__ __forceinline__ void wg_prefetch_b(const WgB& bw, int K, uint8_t* ring) {
  wg_prefetch(K / WG_BK, ring, [&](int kt, uint8_t* Bs) { wg_load_b(bw, kt * WG_BK, Bs); });
}

template <bool A_F32>
__device__ __forceinline__ float* wg_gemm_main(const WgA& a, const WgB& bw, int K, uint8_t* ring) {
  return wg_gemm_loop(
      K / WG_BK, ring, [&](int kt, uint8_t* As) { wg_load_a<A_F32>(a, kt * WG_BK, As); },
      [&](int kt, uint8_t* Bs) { wg_load_b(bw, kt * WG_BK, Bs); });
}

// One tile of a launch with programmatic stream serialization: the weights'
// first chunks, the wait for the launch before, then the rest.
template <bool A_F32>
__device__ __forceinline__ float* wg_gemm(const WgA& a, const WgB& bw, int K, uint8_t* ring) {
  wg_prefetch_b(bw, K, ring);
  grid_dependency_wait();
  return wg_gemm_main<A_F32>(a, bw, K, ring);
}

}  // namespace svc
