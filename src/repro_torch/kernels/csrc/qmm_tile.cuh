// The int8 tensor-core tile of quant_matmul.cu:
//
//   acc[r][c] = sum_k a8[r, k] * w8[k, c]     (int8 x int8 -> int32, exact)
//
// Hopper's warp-level int8 MMA (mma.sync m16n8k32 .s8.s8.s32) from shared
// memory. Integer sums are exact in any order (|acc| <= K * 128 * 128 <
// 2^31 for K <= kMaxK), so any tiling, k order or k permutation gives the
// same bits as the reference's int32 sum.
//
// Layout:
// - A block owns kBR rows x kBN columns; its four warps own 16 x 32 each
//   (2 x 2). A ring of kNS shared-memory stages of kBK k holds the block's
//   A rows (kBR x kBK bytes, k contiguous) and W rows (kBK x kBN bytes, n
//   contiguous, as W lies in global memory). Stages are filled with
//   cp.async 16-byte copies where K (for A) or N (for W) is a multiple of
//   16 and the base is 16-byte aligned, 4-byte copies where both are
//   multiples of 4, and plain byte loads otherwise; everything past R, N
//   and K is zero-filled.
// - The A fragment (16 rows x 32 k) is four 4-byte shared loads per lane.
// - The B fragment wants 4 consecutive k of one column per register, and W
//   is n-contiguous. The columns of an n8 tile may be any 8 columns, so
//   tile j of a warp takes the columns wc + 4 g + j (g = 0..7): each lane
//   then loads, for its 4 k, one 4-byte word of 4 adjacent columns, and a
//   4 x 4 byte transpose (__byte_perm) turns those 4 words into the B
//   registers of the warp's 4 n8 tiles. No transposed copy of W is made.
//   The output columns follow the same map, so each lane ends up holding 8
//   adjacent columns of a row: two float4 stores.
// - Both stages are XOR-swizzled on 16-byte chunks (swz_a, swz_w), so the
//   fragment loads of a warp touch 32 distinct banks and the 16-byte
//   copies stay whole.
#pragma once

#include "ip2_common.cuh"

namespace ip2 {
namespace qmm {

constexpr int kBR = 32;        // rows per block
constexpr int kBN = 64;        // columns per block
constexpr int kBK = 64;        // k per stage
constexpr int kNS = 3;         // stages in the ring (K = 192: all of K at once)
constexpr int kThreads = 128;  // 4 warps, 2 (rows) x 2 (columns) of 16 x 32
constexpr int kAStage = kBR * kBK;  // bytes
constexpr int kWStage = kBK * kBN;
constexpr int kMaxK = 131071;  // K * 128 * 128 < 2^31: the int32 sum is exact
static_assert(kBK == 64 && kBN == 64, "the swizzles assume 64-byte stage rows");
static_assert(kBR == 32 && kThreads == 128, "2 x 2 warps of 16 x 32");

// Byte offset of A (r, k) in a stage: rows of 64 bytes; the 16-byte chunk
// index is XORed with bits 1-2 of the row, so the 8 rows a fragment load
// reads at one k land on 8 different bank quads.
__device__ __forceinline__ int swz_a(int a) { return a ^ (((a >> 7) & 3) << 4); }
// Byte offset of W (k, n): rows of 64 bytes; bits 5-6 are XORed with bits
// 2-3 of k, so the rows k, k + 4, k + 8, k + 12 a fragment load reads at
// once land on different bank quads.
__device__ __forceinline__ int swz_w(int a) { return a ^ (((a >> 8) & 3) << 5); }

// Copy V bytes (16 or 4 by cp.async, 1 by a plain load) from global to
// shared; with ok false nothing is read and the bytes are zero.
template <int V>
__device__ __forceinline__ void copy(int8_t* dst, const int8_t* src, bool ok) {
  if constexpr (V == 1) {
    *dst = ok ? *src : (int8_t)0;
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = ok ? V : 0;
    if constexpr (V == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(d), "l"(src), "r"(n) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(d), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The widest copy (16, 4 or 1 bytes) for rows of len bytes starting at p.
__host__ __forceinline__ int copy_bytes(const void* p, int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (len % 16 == 0 && a % 16 == 0) return 16;
  if (len % 4 == 0 && a % 4 == 0) return 4;
  return 1;
}

// Stage rows r0 .. r0 + kBR - 1, k0 .. k0 + kBK - 1 of a8 (R x K).
template <int V>
__device__ __forceinline__ void load_a(int8_t* as, const int8_t* __restrict__ a8,
                                       int R, int K, int r0, int k0) {
  constexpr int PER_ROW = kBK / V, COUNT = kBR * PER_ROW;
  static_assert(COUNT % kThreads == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < COUNT / kThreads; ++i) {
    const int t = i * kThreads + threadIdx.x;
    const int r = t / PER_ROW, k = (t % PER_ROW) * V;
    const bool ok = r0 + r < R && k0 + k < K;
    copy<V>(as + swz_a(r * kBK + k), ok ? a8 + (long long)(r0 + r) * K + k0 + k : a8, ok);
  }
}

// Stage rows k0 .. k0 + kBK - 1, columns n0 .. n0 + kBN - 1 of w8 (K x N).
template <int V>
__device__ __forceinline__ void load_w(int8_t* ws, const int8_t* __restrict__ w8,
                                       int K, int N, int k0, int n0) {
  constexpr int PER_ROW = kBN / V, COUNT = kBK * PER_ROW;
  static_assert(COUNT % kThreads == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < COUNT / kThreads; ++i) {
    const int t = i * kThreads + threadIdx.x;
    const int k = t / PER_ROW, n = (t % PER_ROW) * V;
    const bool ok = k0 + k < K && n0 + n < N;
    copy<V>(ws + swz_w(k * kBN + n), ok ? w8 + (long long)(k0 + k) * N + n0 + n : w8, ok);
  }
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// w[q] holds bytes (q, 0..3) of a 4 x 4 byte block; afterwards w[j] holds
// bytes (0..3, j).
__device__ __forceinline__ void transpose4x4(unsigned (&w)[4]) {
  const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);  // (0,0) (1,0) (0,1) (1,1)
  const unsigned t1 = __byte_perm(w[0], w[1], 0x7362);  // (0,2) (1,2) (0,3) (1,3)
  const unsigned t2 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 16 x 32 outputs (rows wr.., stage columns wc..) over one
// stage. acc[j] is the m16n8 tile j, whose local column c is the stage
// column wc + 4 c + j.
__device__ __forceinline__ void mma_stage(const int8_t* as, const int8_t* ws, int wr, int wc,
                                          int (&acc)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 32) {
    unsigned a[4], lo[4], hi[4];
    a[0] = lds32(as + swz_a((wr + g) * kBK + kk + 4 * t));
    a[1] = lds32(as + swz_a((wr + g + 8) * kBK + kk + 4 * t));
    a[2] = lds32(as + swz_a((wr + g) * kBK + kk + 16 + 4 * t));
    a[3] = lds32(as + swz_a((wr + g + 8) * kBK + kk + 16 + 4 * t));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo[q] = lds32(ws + swz_w((kk + 4 * t + q) * kBN + wc + 4 * g));
      hi[q] = lds32(ws + swz_w((kk + 16 + 4 * t + q) * kBN + wc + 4 * g));
    }
    transpose4x4(lo);
    transpose4x4(hi);
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_s8(acc[j], a, lo[j], hi[j]);
  }
}

}  // namespace qmm
}  // namespace ip2
