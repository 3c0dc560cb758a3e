// The int8 GEMM tile of the denoiser's int8 modes (K6): one warpgroup (128
// threads) computes a 64 x 64 int32 tile with wgmma.mma_async m64n64k32
// .s32.s8.s8. It shares the bf16 tile's 128-byte swizzle, descriptors, ring
// and dependent-launch rule (gemm_wg.cuh).
//
// Operands: wgmma takes 8-bit A and B only K-major (the bf16 tile's
// transpose bit exists for 16-bit types alone), so B is a K-major copy of
// the weight, [N, ldw] with row n holding output column n's K values. A
// 128-byte swizzle row holds 128 K elements: a K chunk is 128 wide, and both
// descriptors step 32 bytes per k32.
//
// A, the activations, stays resident for the whole K (64 rows x K bytes in
// cdiv(K, 128) swizzled chunks, K <= W8_MAX_K). The caller writes it after
// grid_dependency_wait(): quantised from bf16 (the gate's conv taps, by the
// threads of its cluster) or copied with cp.async (w8_copy_a, "int8" mode's
// gate g).
// B streams through a ring of WG_STAGES chunks of 8 KB, its first
// WG_STAGES - 1 chunks issued before the wait (no launch writes weights).
// K columns past K are zero on both sides, so a short last chunk runs all
// four k32 steps. The int32 sums land in shared memory (Ci, aliased on the
// drained ring) for the caller's epilogue.
//
// What bounds it: at batch 1 the denoiser's int8 GEMMs are ~0.1-0.2 GOP per
// launch (0.1 us at the tensor cores' int8 peak), so the latency of one
// tile's loads, K loop and epilogue sets the time, as for the bf16 tile.
#pragma once

#include "gemm_wg.cuh"

namespace svc {

constexpr int W8_BK = 128;                       // K elements per chunk: one 128-byte swizzle row
constexpr int W8_TILE_BYTES = WG_BM * W8_BK;     // one A chunk or one B stage, 8 KB
constexpr int W8_MAX_K = 1024;                   // A resident for the whole K

// dynamic shared memory of a launch with reduction depth K: room to align,
// the B ring, the resident A
__host__ __device__ constexpr int w8_smem_bytes(int K) {
  return 1024 + WG_STAGES * W8_TILE_BYTES + (K + W8_BK - 1) / W8_BK * W8_TILE_BYTES;
}

struct W8B {
  const int8_t* w;  // K-major weight [N, ldw]: row n holds output column n
  int ldw;          // row stride, bytes
  int row_lo;       // weight row of tile columns 0..31
  int row_hi;       // weight row of tile columns 32..63
};

__device__ __forceinline__ void w8_fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 32, K-major) @ B (32 x 64, K-major), int8 -> int32
__device__ __forceinline__ void wgmma_s8_64x64x32(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// 16-byte chunks of one A row: every chunk of the resident A, K padding included
__device__ __forceinline__ int w8_row_chunks(int K) { return (K + W8_BK - 1) / W8_BK * (W8_BK / 16); }

// byte offset of 16-byte chunk c of row r in the resident A
__device__ __forceinline__ int w8_a_offset(int r, int c) { return (c >> 3) * W8_TILE_BYTES + sw128(r, c & 7); }

__device__ __forceinline__ void w8_load_b(const W8B& bw, int k0, int K, uint8_t* Bs) {
#pragma unroll
  for (int it = 0; it < WG_BM * 8 / WG_THREADS; ++it) {
    const int v = it * WG_THREADS + threadIdx.x;
    const int r = v >> 3;
    const int c = v & 7;
    const int k = k0 + 16 * c;
    const bool ok = k < K;
    const int8_t* row = bw.w + (size_t)(r < 32 ? bw.row_lo + r : bw.row_hi + r - 32) * bw.ldw;
    cp_async16(Bs + sw128(r, c), ok ? row + k : bw.w, ok ? 16 : 0);
  }
}

// A by cp.async from a row-major int8 matrix: tile row r is row0 + r * ld;
// rows at or past nvalid and columns at or past K are zero.
__device__ __forceinline__ void w8_copy_a(const int8_t* row0, int ld, int nvalid, int K, uint8_t* As) {
  const int nc = w8_row_chunks(K);
  for (int v = threadIdx.x; v < WG_BM * nc; v += WG_THREADS) {
    const int r = v / nc;
    const int c = v - r * nc;
    const bool ok = r < nvalid && 16 * c < K;
    cp_async16(As + w8_a_offset(r, c), ok ? row0 + (size_t)r * ld + 16 * c : row0, ok ? 16 : 0);
  }
}

// Ci[64][WG_LDC] (int32, aliased on the ring) <- A @ B over K. load_a(As)
// runs after grid_dependency_wait() and writes the resident A; its cp.async
// copies, if any, are waited for here.
template <typename LoadA>
__device__ __forceinline__ int* wg_gemm_s8(const W8B& bw, int K, uint8_t* smem, LoadA&& load_a) {
  uint8_t* ring = smem;
  uint8_t* As = smem + WG_STAGES * W8_TILE_BYTES;
  const int nk = (K + W8_BK - 1) / W8_BK;
#pragma unroll
  for (int s = 0; s < WG_STAGES - 1; ++s)
    if (s < nk) w8_load_b(bw, s * W8_BK, K, ring + s * W8_TILE_BYTES);
  grid_dependency_wait();
  load_a(As);
  cp_async_commit();
  cp_async_wait<0>();  // A and the first B chunks (this thread's copies)
  fence_proxy_async(); // A written by st.shared, visible to wgmma's async proxy
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<WG_STAGES - 2>();  // B chunk kt has landed
    fence_proxy_async();
    __syncthreads();                 // for every thread; chunk kt-1's stage is free
    const int pf = kt + WG_STAGES - 1;
    if (pf < nk) w8_load_b(bw, pf * W8_BK, K, ring + (pf % WG_STAGES) * W8_TILE_BYTES);
    cp_async_commit();
    const uint64_t da = wg_desc(As + kt * W8_TILE_BYTES, 16);
    const uint64_t db = wg_desc(ring + (kt % WG_STAGES) * W8_TILE_BYTES, 16);
    w8_fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < W8_BK / 32; ++kk) {
      // both operands: 32 K elements = 32 bytes further along the row
      wgmma_s8_64x64x32(acc, da + 2 * kk, db + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    w8_fence_acc(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring before it becomes Ci
  int* Ci = reinterpret_cast<int*>(ring);
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = 16 * w + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    *reinterpret_cast<int2*>(&Ci[row * WG_LDC + col]) = make_int2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<int2*>(&Ci[(row + 8) * WG_LDC + col]) = make_int2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  return Ci;
}

}  // namespace svc
