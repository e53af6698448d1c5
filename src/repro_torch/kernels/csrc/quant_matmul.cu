// quant_matmul: the w8a8 code-wire embed, y = (a @ w8) * s_a[r] * s_w[c],
// for int8 codes a8, the int16 codes of a 9- to 16-bit ADC or the int32
// codes of a 17- to 32-bit one.
//
// Replaces the Pallas TPU kernel quant_matmul_pallas (src/repro/kernels/
// quant_matmul.py:55, body _qmm_kernel :34): int8 x int8 with int32
// accumulation, then (float(acc) * s_a[r]) * s_w[c] in that order.
//
// What bounds it here: on the serving path (R = 1024 code rows, K = 192
// vectors, N = 256 model width) it moves ~1.3 MB for 0.1 GOP, a bound of
// ~0.4 us set by the bytes, far below the int8 tensor-core rate. The
// earlier design (__dp4a on the CUDA cores, the weights read from global
// memory one byte at a time) was set by the latency of those byte loads.
// Design: the int8 tensor-core tile of qmm_tile.cuh. 32 x 64 outputs per
// 128-thread block (32 x 4 = 128 blocks at the serving shape, one wave on
// 132 SMs); a 3-stage cp.async ring of 64 k, so at K = 192 the whole K
// extent of the block is in flight after one round of copies; m16n8k32
// int8 MMAs from swizzled shared memory; the epilogue of ip2_common.cuh
// (built with --fmad=false, so bitwise the reference's) stored as float4.
// The int32 sums are the reference's modulo 2^32, so the result is bitwise
// equal to the plain version whatever the tiling, at every K. int16 and
// int32 codes are split into 2 or 4 byte planes as they are staged
// (qmm_tile.cuh) and take 2 or 4 MMAs per fragment.
#include "qmm_tile.cuh"

namespace {

using namespace ip2::qmm;

struct Args {
  const void* a;  // int8, int16 (NP = 2) or int32 (NP = 4) codes
  const float* s_a;
  const int8_t* w8;
  const float* s_w;
  float* out;
  int R, K, N;
  bool vec_out;  // N % 4 == 0 and out 16-byte aligned: float4 stores
};

// VA: the A copy width in bytes (16, 4 or 1; int16 codes 16, 4 or 2; int32
// codes 16 or 4); NP: the code planes
template <int VA, int VW, int NP>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(const Args p) {
  __shared__ __align__(128) int8_t as[kNS][NP * kAStage];
  __shared__ __align__(128) int8_t ws[kNS][kWStage];
  const int r0 = blockIdx.x * kBR, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 32;
  unsigned acc[4][4] = {};
  const int nk = (p.K + kBK - 1) / kBK;
  auto load = [&](int s, int slot) {
    if constexpr (NP == 4)
      load_a32<VA / 4>(as[slot], static_cast<const int32_t*>(p.a), p.R, p.K, r0, s * kBK);
    else if constexpr (NP == 2)
      load_a16<VA / 2>(as[slot], as[slot] + kAStage, static_cast<const int16_t*>(p.a), p.R,
                       p.K, r0, s * kBK);
    else
      load_a<VA>(as[slot], static_cast<const int8_t*>(p.a), p.R, p.K, r0, s * kBK);
    load_w<VW>(ws[slot], p.w8, p.K, p.N, s * kBK, n0);
  };
#pragma unroll
  for (int s = 0; s < kNS - 1; ++s) {
    if (s < nk) load(s, s);
    commit();
  }
  for (int s = 0; s < nk; ++s) {
    wait<kNS - 2>();  // this thread's copies of stage s have landed
    __syncthreads();  // everyone's have, and stage s - 1 is consumed
    const int nx = s + kNS - 1;
    if (nx < nk) load(nx, nx % kNS);
    commit();
    mma_stage<NP>(as[s % kNS], kAStage, ws[s % kNS], wr, wc, acc);
  }
  const int lane = threadIdx.x & 31, g = lane >> 2;
  float* o[2];
  float sa[2];
  const bool live[2] = {true, true};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + wr + g + 8 * h;
    const int c = n0 + wc + 8 * (lane & 3);
    o[h] = r < p.R ? p.out + (long long)r * p.N + c : nullptr;
    sa[h] = r < p.R ? p.s_a[r] : 0.0f;
  }
  store_warp(acc, o, sa, live, p.s_w, n0 + wc + 8 * (lane & 3), p.N, p.vec_out);
}

template <int VA, int VW, int NP>
void run(const Args& p, cudaStream_t stream) {
  const dim3 grid((p.R + kBR - 1) / kBR, (p.N + kBN - 1) / kBN);
  quant_matmul_kernel<VA, VW, NP><<<grid, kThreads, 0, stream>>>(p);
}

template <int VA, int NP>
void run_w(int vw, const Args& p, cudaStream_t stream) {
  if (vw == 16) run<VA, 16, NP>(p, stream);
  else if (vw == 4) run<VA, 4, NP>(p, stream);
  else run<VA, 1, NP>(p, stream);
}

}  // namespace

// a (R, K) codes of a_bytes (1: int8, 2: int16, 4: int32), s_a (R,) f32,
// w8 (K, N) int8, s_w (N,) f32 -> out (R, N) f32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another code width.
extern "C" int quant_matmul_launch(const void* a, int a_bytes, const float* s_a,
                                   const int8_t* w8, const float* s_w, float* out,
                                   int R, int K, int N, void* stream) {
  if (a_bytes != 1 && a_bytes != 2 && a_bytes != 4) return (int)cudaErrorInvalidValue;
  if (R < 0 || K < 0 || N < 0) return (int)cudaErrorInvalidValue;
  if (R > 0 && N > 0) {
    const Args p{a, s_a, w8, s_w, out, R, K, N,
                 N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0};
    const int vw = copy_bytes(w8, N);
    const cudaStream_t st = (cudaStream_t)stream;
    if (a_bytes == 4) {
      if (copy_bytes(a, 4LL * K) == 16) run_w<16, 4>(vw, p, st);
      else run_w<4, 4>(vw, p, st);
    } else if (a_bytes == 2) {
      const int va = copy_bytes(a, 2LL * K);
      if (va == 16) run_w<16, 2>(vw, p, st);
      else if (va == 4) run_w<4, 2>(vw, p, st);
      else run_w<2, 2>(vw, p, st);
    } else {
      const int va = copy_bytes(a, K);
      if (va == 16) run_w<16, 1>(vw, p, st);
      else if (va == 4) run_w<4, 1>(vw, p, st);
      else run_w<1, 1>(vw, p, st);
    }
  }
  return (int)cudaGetLastError();
}
