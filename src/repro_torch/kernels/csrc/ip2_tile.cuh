// The pipelined fp32 projection tile of ip2_project.cu, ip2_ragged.cu and
// ip2_fused_embed.cu.
//
//   acc[i][j] = sum_k PWM(x[rows[r_i] + k]) * w[k * M + c0 + c_j]
//
// Bitwise contract: every output is ONE fmaf chain over k = 0 .. K-1 in
// order, starting from 0.0f, with a_k = pwm_quantize(x[row, k]) and
// b_k = w[k, col]. So every kernel on this tile gives the same code for the
// same row bit for bit, whatever the tile shape. Past K the tile is
// zero-filled and fmaf(0, 0, acc) == acc. No split-K, no reassociation, no
// tensor cores.
//
// Design, for Hopper:
// - A ring of NS shared-memory stages of BK k each, filled with cp.async
//   (16-byte copies, 4-byte where K or M is not a multiple of 4 or a base
//   is not 16-byte aligned; zero-fill past K, past M and for rows that do
//   not exist). NS - 1 stages are in flight while the FMAs run on the
//   oldest; one __syncthreads per stage.
// - PWM is applied once per element, not once per thread that reads it:
//   each thread quantises the x words it copied itself, in place, after
//   its own copies landed and before the stage's barrier publishes them.
//   Same function, same operand of the same fmaf.
// - A compile-time K step, fully unrolled, with the register fragments
//   (TR rows x 4 k of x, 4 k x TM columns of w) double-buffered; both are
//   16-byte shared loads (8-byte for TM = 2), broadcast or contiguous per
//   quarter warp, so conflict-free. x rows are padded by 4 floats.
// - TR x TM outputs per thread; the tile shapes are chosen per kernel
//   (ProjectTile, RaggedTile below).
// What bounds it on the H100: with four warps on an SM the fragment loads
// fill the SM's shared-memory datapath (an LDS.128 moves 512 bytes to a
// warp, broadcast or not, at 128 bytes a clock), about (TR + TM) / (TR *
// TM) * 4 bytes per FMA; the per-output chain leaves ~12 chains per lane at
// R = 1024, M = 192, which caps TR * TM. With one or two warps on an SM a
// stage is bound by latency instead.

#pragma once

#include <type_traits>

#include "ip2_common.cuh"

namespace ip2 {

template <int BR_, int BM_, int TR_, int TM_, int NS_ = 4, int BK_ = 32>
struct Tile {
  static constexpr int BR = BR_, BM = BM_, TR = TR_, TM = TM_;
  static constexpr int BK = BK_;                  // k per stage
  static constexpr int NS = NS_;                  // stages in the ring
  static constexpr int XS = BK + 4;               // x row stride in shared
  static constexpr int TC = BM / TM;              // thread columns
  static constexpr int NT = (BR / TR) * TC;       // threads per block
  static constexpr int X_STAGE = BR * XS, W_STAGE = BK * BM;
  static constexpr int SMEM_FLOATS = NS * (X_STAGE + W_STAGE);
  static_assert(BR % TR == 0 && BM % TM == 0 && NT % 32 == 0, "tile shape");
  static_assert(BR <= NT, "one thread per tile row sets up the rows");
  static_assert(TM == 2 || TM == 4, "w fragment is one 8- or 16-byte load");
};

// ip2_project, the dense sparse gather and ip2_fused_embed: 48 x 32
// outputs per 128-thread block, 3 x 4 per thread, 4 stages of 32 k (44 KB).
// At R = 1024, M = 192 that is 22 x 6 = 132 blocks, one per SM, one warp
// per scheduler, 12 independent chains each.
using ProjectTile = Tile<48, 32, 3, 4>;
// ip2_fused_embed: 64 x 32 outputs per 128-thread block, 4 x 4 per thread.
// A bank of 64 rows is one cluster of 6 such blocks at M = 192; at R = 1024
// that is 16 clusters, which the card places one block per SM (96 SMs),
// where 48-row banks give 22 clusters of which only 20 fit one block per
// SM (the rest double up on 12 SMs and take twice as long).
using FusedTile = Tile<64, 32, 4, 4>;
// The ragged kernel: few live rows (75 on the gated path), so 64-thread
// blocks of 16 x 16 outputs, 2 x 2 per thread, put 5 x 12 = 60 SMs on
// them; 3 stages of 64 k (25 KB) halve the stages, and with them the
// per-stage waits and barriers, of a block that is latency-bound.
using RaggedTile = Tile<16, 16, 2, 2, 3, 64>;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy BYTES (16 or 4) from global to the shared address dst without the
// registers; with valid false nothing is read and dst is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned dst, const float* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// True when the 16-byte copies apply: K and M multiples of 4 and both bases
// 16-byte aligned (each copied run of 4 floats then lies wholly inside or
// wholly outside the data).
__host__ __forceinline__ bool vec4_ok(const float* x, const float* w, int K, int M) {
  return K % 4 == 0 && M % 4 == 0 &&
         (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
}

template <class T>
__device__ __forceinline__ void load_frag(const float* xa, const float* wb, int kk,
                                          float (&a)[T::TR][4], float (&b)[4][T::TM]) {
#pragma unroll
  for (int i = 0; i < T::TR; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(xa + i * T::XS + kk);
    a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float* p = wb + (kk + q) * T::BM;
    if constexpr (T::TM == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      b[q][0] = v.x; b[q][1] = v.y; b[q][2] = v.z; b[q][3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      b[q][0] = v.x; b[q][1] = v.y;
    }
  }
}

// four k steps of every chain, in k order
template <class T>
__device__ __forceinline__ void fma_frag(const float (&a)[T::TR][4],
                                         const float (&b)[4][T::TM],
                                         float (&acc)[T::TR][T::TM]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < T::TR; ++i)
#pragma unroll
      for (int j = 0; j < T::TM; ++j) acc[i][j] = fmaf(a[i][q], b[q][j], acc[i][j]);
}

// Block-cooperative: ``rows`` (shared, BR entries, set and synchronised by
// the caller) holds each tile row's element offset into x, or -1 for a row
// that reads zeros. Thread t owns rows (t / TC) * TR + i and columns
// c0 + (t % TC) * TM + j. ``smem`` is 16-byte aligned, SMEM_FLOATS long.
// VEC is 4 (16-byte copies, see vec4_ok) or 1.
template <class T, int VEC>
__device__ __forceinline__ void project_tile_pipelined(
    const float* __restrict__ x, const long long* rows,
    const float* __restrict__ w, int K, int M, int c0, const Epilogue& e,
    float* smem, float (&acc)[T::TR][T::TM]) {
  constexpr int BK = T::BK, NS = T::NS, NT = T::NT;
  constexpr int XCH = T::BR * BK / VEC, WCH = BK * T::BM / VEC;  // copies per stage
  static_assert(XCH % NT == 0 && WCH % NT == 0, "copies split evenly");
  constexpr int XPT = XCH / NT, WPT = WCH / NT;
  float* xs = smem;                       // NS x BR x XS
  float* ws = smem + NS * T::X_STAGE;     // NS x BK x BM
  const int tid = threadIdx.x;
  const int nk = (K + BK - 1) / BK;

  // This thread's copies: the shared address in slot 0 and a global
  // pointer that each load advances by one stage.
  unsigned xsh[XPT], wsh[WPT];
  const float* xp[XPT];
  const float* wp[WPT];
  int xdst[XPT], xk[XPT], wk[WPT];
  bool xrow[XPT], wcol[WPT];
#pragma unroll
  for (int u = 0; u < XPT; ++u) {
    const int id = tid + u * NT;
    const int r = id / (BK / VEC), kc = id % (BK / VEC) * VEC;
    const long long base = rows[r];
    xrow[u] = base >= 0;
    xp[u] = x + (base >= 0 ? base : 0) + kc;
    xdst[u] = r * T::XS + kc;
    xsh[u] = smem_u32(xs + xdst[u]);
    xk[u] = kc;
  }
#pragma unroll
  for (int u = 0; u < WPT; ++u) {
    const int id = tid + u * NT;
    const int kr = id / (T::BM / VEC), cc = id % (T::BM / VEC) * VEC;
    wcol[u] = c0 + cc < M;
    wp[u] = w + (long long)kr * M + (c0 + cc < M ? c0 + cc : 0);
    wsh[u] = smem_u32(ws + kr * T::BM + cc);
    wk[u] = kr;
  }
  const long long wstep = (long long)BK * M;
  // stage st into slot st % NS; called for st = 0, 1, 2, ... in order. In a
  // whole stage every pointer lies in the data (a dead row reads row 0, a
  // column past M column 0, both zero-filled); in the K tail a copy past K
  // reads nothing.
  auto load = [&](int st) {
    const int k0 = st * BK;
    const unsigned xo = (st % NS) * (T::X_STAGE * 4), wo = (st % NS) * (T::W_STAGE * 4);
    const bool whole = k0 + BK <= K;
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const bool ok = xrow[u] && (whole || k0 + xk[u] < K);
      cp_async<VEC * 4>(xsh[u] + xo, ok || whole ? xp[u] : x, ok);
      xp[u] += BK;
    }
#pragma unroll
    for (int u = 0; u < WPT; ++u) {
      const bool ok = wcol[u] && (whole || k0 + wk[u] < K);
      cp_async<VEC * 4>(wsh[u] + wo, ok || whole ? wp[u] : w, ok);
      wp[u] += wstep;
    }
  };
  // PWM on the x words this thread copied into slot st % NS: all loads,
  // then the arithmetic, then all stores, so the words overlap in flight.
  // V is float4 for 16-byte copies, float for 4-byte ones.
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  auto quantize = [&](int st) {
    float* xd = xs + (st % NS) * T::X_STAGE;
    V v[XPT];
#pragma unroll
    for (int u = 0; u < XPT; ++u) v[u] = *reinterpret_cast<const V*>(xd + xdst[u]);
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      if constexpr (VEC == 4) {
        v[u].x = pwm_quantize(v[u].x, e);
        v[u].y = pwm_quantize(v[u].y, e);
        v[u].z = pwm_quantize(v[u].z, e);
        v[u].w = pwm_quantize(v[u].w, e);
      } else {
        v[u] = pwm_quantize(v[u], e);
      }
    }
#pragma unroll
    for (int u = 0; u < XPT; ++u) *reinterpret_cast<V*>(xd + xdst[u]) = v[u];
  };

#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nk) load(st);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < T::TR; ++i)
#pragma unroll
    for (int j = 0; j < T::TM; ++j) acc[i][j] = 0.0f;

  const int tr = tid / T::TC, tc = tid % T::TC;
  for (int st = 0; st < nk; ++st) {
    cp_async_wait<NS - 2>();  // this thread's copies of stage st have landed
    quantize(st);
    __syncthreads();  // stage st quantised and visible; stage st - 1 consumed
    if (st + NS - 1 < nk) load(st + NS - 1);
    cp_async_commit();

    const float* xa = xs + (st % NS) * T::X_STAGE + tr * T::TR * T::XS;
    const float* wb = ws + (st % NS) * T::W_STAGE + tc * T::TM;
    float a0[T::TR][4], b0[4][T::TM], a1[T::TR][4], b1[4][T::TM];
    load_frag<T>(xa, wb, 0, a0, b0);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      load_frag<T>(xa, wb, kk + 4, a1, b1);
      fma_frag<T>(a0, b0, acc);
      if (kk + 8 < BK) load_frag<T>(xa, wb, kk + 8, a0, b0);
      fma_frag<T>(a1, b1, acc);
    }
  }
  cp_async_wait<0>();
}

// The epilogue of a computed tile: row r goes to output row orow[r] (-1:
// none).
template <class T>
__device__ __forceinline__ void store_tile(const float (&acc)[T::TR][T::TM],
                                           const long long* orow, int M, int c0,
                                           const float* __restrict__ colv, void* out,
                                           int out_bytes, const Epilogue& e) {
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
#pragma unroll
  for (int i = 0; i < T::TR; ++i) {
    const long long o = orow[tr * T::TR + i];
    if (o < 0) continue;
#pragma unroll
    for (int j = 0; j < T::TM; ++j) {
      const int c = c0 + tc * T::TM + j;
      if (c < M) store_readout(out, out_bytes, o * M + c,
                               readout(acc[i][j], colv ? colv[c] : 0.0f, e), e);
    }
  }
}

}  // namespace ip2
