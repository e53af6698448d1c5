// The int8 tensor-core tile of quant_matmul.cu and ip2_fused_embed.cu:
//
//   acc[r][c] = sum_k a[r, k] * w8[k, c]     (int32, modulo 2^32)
//
// Hopper's warp-level int8 MMA (mma.sync m16n8k32 .s8.s8.s32) from shared
// memory. The reference sums in int32, which wraps modulo 2^32; a sum
// modulo 2^32 does not depend on its order, so any tiling, k order or k
// permutation gives the reference's bits, wrapped or not.
//
// Codes wider than 8 bits are split into NP byte planes as they are
// staged: c = sum_p b_p 256^(NP-1-p) with the top byte b_0 signed and the
// others unsigned (an ADC of 9 to 16 bits stores int16 codes, NP = 2; of 17
// to 32 bits int32 codes, NP = 4). Each plane is an A operand of the same
// layout. Every MMA starts from a zero accumulator and covers 32 k, so its
// int32 sum is exact (|sum| <= 32 * 255 * 128); the plane sums are shifted
// and added into the tile's accumulator in uint32, which wraps modulo 2^32
// by definition. So the result is the reference's wrapped int32 sum bit
// for bit at every K, with no reliance on how the MMA treats an overflow.
//
// Layout:
// - A quant_matmul block owns kBR rows x kBN columns; its four warps own
//   16 x 32 each (2 x 2). A ring of kNS shared-memory stages of kBK k holds
//   the block's A rows (kBR x kBK bytes per plane, k contiguous) and W rows
//   (kBK x kBN bytes, n contiguous, as W lies in global memory). Stages are
//   filled with cp.async 16-byte copies where K (for A) or N (for W) is a
//   multiple of 16 and the base is 16-byte aligned, 4-byte copies where
//   both are multiples of 4, and plain byte loads otherwise; int16 codes go
//   and int32 codes go through registers (int16: 8, 2 or 1 codes a load;
//   int32: 4 or 1), where they are split into their planes.
//   Everything past R, N and K is zero-filled.
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
//   copies stay whole. swz_a holds for any number of 64-byte rows.
#pragma once

#include "ip2_common.cuh"

namespace ip2 {
namespace qmm {

constexpr int kBR = 32;        // rows per block
constexpr int kBN = 64;        // columns per block
constexpr int kBK = 64;        // k per stage
constexpr int kNS = 3;         // stages in the ring (K = 192: all of K at once)
constexpr int kThreads = 128;  // 4 warps, 2 (rows) x 2 (columns) of 16 x 32
constexpr int kAStage = kBR * kBK;  // bytes per plane
constexpr int kWStage = kBK * kBN;
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
__host__ __forceinline__ int copy_bytes(const void* p, long long len) {
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

// The same for int16 codes, V of them a load (8: 16 bytes, 2: 4 bytes, or
// 1), split into the high-byte plane ah and the low-byte plane al.
template <int V>
__device__ __forceinline__ void load_a16(int8_t* ah, int8_t* al,
                                         const int16_t* __restrict__ a16, int R, int K,
                                         int r0, int k0) {
  constexpr int PER_ROW = kBK / V, COUNT = kBR * PER_ROW;
  static_assert(COUNT % kThreads == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < COUNT / kThreads; ++i) {
    const int t = i * kThreads + threadIdx.x;
    const int r = t / PER_ROW, k = (t % PER_ROW) * V;
    const bool ok = r0 + r < R && k0 + k < K;
    const int16_t* src = a16 + (long long)(r0 + r) * K + k0 + k;
    const int o = swz_a(r * kBK + k);
    if constexpr (V == 8) {  // words of two codes, bytes l0 h0 l1 h1
      const uint4 v = ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint2*>(ah + o) =
          make_uint2(__byte_perm(v.x, v.y, 0x7531), __byte_perm(v.z, v.w, 0x7531));
      *reinterpret_cast<uint2*>(al + o) =
          make_uint2(__byte_perm(v.x, v.y, 0x6420), __byte_perm(v.z, v.w, 0x6420));
    } else if constexpr (V == 2) {
      const unsigned v = ok ? *reinterpret_cast<const unsigned*>(src) : 0u;
      *reinterpret_cast<uint16_t*>(ah + o) = (uint16_t)__byte_perm(v, 0, 0x31);
      *reinterpret_cast<uint16_t*>(al + o) = (uint16_t)__byte_perm(v, 0, 0x20);
    } else {
      const int c = ok ? *src : 0;
      ah[o] = (int8_t)(c >> 8);
      al[o] = (int8_t)(c & 0xFF);
    }
  }
}

// The same for int32 codes, V of them a load (4: 16 bytes, or 1), split
// into four planes kAStage bytes apart: plane p holds byte 3 - p.
template <int V>
__device__ __forceinline__ void load_a32(int8_t* a, const int32_t* __restrict__ a32, int R,
                                         int K, int r0, int k0) {
  constexpr int PER_ROW = kBK / V, COUNT = kBR * PER_ROW;
  static_assert(COUNT % kThreads == 0, "whole passes");
#pragma unroll
  for (int i = 0; i < COUNT / kThreads; ++i) {
    const int t = i * kThreads + threadIdx.x;
    const int r = t / PER_ROW, k = (t % PER_ROW) * V;
    const bool ok = r0 + r < R && k0 + k < K;
    const int32_t* src = a32 + (long long)(r0 + r) * K + k0 + k;
    const int o = swz_a(r * kBK + k);
    if constexpr (V == 4) {  // four codes; byte b of each, in code order
      const uint4 v = ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const unsigned sel = (3 - p) | ((7 - p) << 4);
        *reinterpret_cast<unsigned*>(a + p * kAStage + o) =
            __byte_perm(__byte_perm(v.x, v.y, sel), __byte_perm(v.z, v.w, sel), 0x5410);
      }
    } else {
      const unsigned c = ok ? static_cast<unsigned>(*src) : 0u;
#pragma unroll
      for (int p = 0; p < 4; ++p) a[p * kAStage + o] = (int8_t)(c >> (8 * (3 - p)));
    }
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

// d = a (16 x 32, row) * b (32 x 8, col), int32 sums from a zero
// accumulator; a signed (.s8) or unsigned (.u8) bytes, b signed
template <bool A_SIGNED>
__device__ __forceinline__ void mma(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  const int z = 0;
  if constexpr (A_SIGNED)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(z));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(z));
}

// The A fragment of rows wr .. wr + 15, stage columns kk .. kk + 31.
__device__ __forceinline__ void load_a_frag(const int8_t* as, int wr, int kk,
                                            unsigned (&a)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  a[0] = lds32(as + swz_a((wr + g) * kBK + kk + 4 * t));
  a[1] = lds32(as + swz_a((wr + g + 8) * kBK + kk + 4 * t));
  a[2] = lds32(as + swz_a((wr + g) * kBK + kk + 16 + 4 * t));
  a[3] = lds32(as + swz_a((wr + g + 8) * kBK + kk + 16 + 4 * t));
}

// The B fragments of stage rows kk .. kk + 31 for the warp's four n8 tiles:
// tile j's local column c is the stage column wc + 4 c + j.
__device__ __forceinline__ void load_b_frag(const int8_t* ws, int wc, int kk,
                                            unsigned (&lo)[4], unsigned (&hi)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    lo[q] = lds32(ws + swz_w((kk + 4 * t + q) * kBN + wc + 4 * g));
    hi[q] = lds32(ws + swz_w((kk + 16 + 4 * t + q) * kBN + wc + 4 * g));
  }
  transpose4x4(lo);
  transpose4x4(hi);
}

// 32 k of one warp's 16 x 32 outputs from a loaded B fragment, over the
// NP code planes at a, a + plane, ...: each plane's exact sums, shifted to
// its byte, are added into acc modulo 2^32.
template <int NP>
__device__ __forceinline__ void mma_k32(const int8_t* a, int plane, int wr, int kk,
                                        const unsigned (&lo)[4], const unsigned (&hi)[4],
                                        unsigned (&acc)[4][4]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    unsigned af[4];
    load_a_frag(a + p * plane, wr, kk, af);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int d[4];
      if (p == 0) mma<true>(d, af, lo[j], hi[j]);
      else mma<false>(d, af, lo[j], hi[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[j][i] += static_cast<unsigned>(d[i]) << (8 * (NP - 1 - p));
    }
  }
}

// One warp's 16 x 32 outputs (rows wr.., stage columns wc..) over one
// stage. acc[j] is the m16n8 tile j, whose local column c is the stage
// column wc + 4 c + j.
template <int NP>
__device__ __forceinline__ void mma_stage(const int8_t* a, int plane, const int8_t* ws, int wr,
                                          int wc, unsigned (&acc)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 32) {
    unsigned lo[4], hi[4];
    load_b_frag(ws, wc, kk, lo, hi);
    mma_k32<NP>(a, plane, wr, kk, lo, hi, acc);
  }
}

// The epilogue of one warp's 16 x 32 tile: acc[j][2h + e] is row g + 8h,
// column c + 4e + j of the output (c = the lane's first column, n0 + wc +
// 8t), so each lane holds 8 adjacent columns of two rows. For h = 0, 1,
// o[h] points at (row, c) in the output, or is null for a row that is not
// stored; a row with live[h] false is stored as 0.
__device__ __forceinline__ void store_warp(const unsigned (&acc)[4][4], float* const (&o)[2],
                                           const float (&sa)[2], const bool (&live)[2],
                                           const float* __restrict__ s_w, int c, int N,
                                           bool vec_out) {
  float sw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sw[i] = c + i < N ? s_w[c + i] : 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (o[h] == nullptr) continue;
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = live[h] ? qmm_epilogue((int)acc[j][2 * h], sa[h], sw[j]) : 0.0f;
      v[4 + j] = live[h] ? qmm_epilogue((int)acc[j][2 * h + 1], sa[h], sw[4 + j]) : 0.0f;
    }
    if (vec_out) {
      if (c < N) *reinterpret_cast<float4*>(o[h]) = make_float4(v[0], v[1], v[2], v[3]);
      if (c + 4 < N) *reinterpret_cast<float4*>(o[h] + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c + i < N) o[h][i] = v[i];
    }
  }
}

}  // namespace qmm
}  // namespace ip2
