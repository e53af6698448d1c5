// quant_matmul: the w8a8 code-wire embed, y = (a8 @ w8) * s_a[r] * s_w[c].
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
// The int32 sums are exact, so the result is bitwise equal to the plain
// version whatever the tiling.
#include "qmm_tile.cuh"

namespace {

using namespace ip2::qmm;

struct Args {
  const int8_t* a8;
  const float* s_a;
  const int8_t* w8;
  const float* s_w;
  float* out;
  int R, K, N;
  bool vec_out;  // N % 4 == 0 and out 16-byte aligned: float4 stores
};

template <int VA, int VW>
__global__ void __launch_bounds__(kThreads) quant_matmul_kernel(const Args p) {
  __shared__ __align__(128) int8_t as[kNS][kAStage];
  __shared__ __align__(128) int8_t ws[kNS][kWStage];
  const int r0 = blockIdx.x * kBR, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 32;
  int acc[4][4] = {};
  const int nk = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kNS - 1; ++s) {
    if (s < nk) {
      load_a<VA>(as[s], p.a8, p.R, p.K, r0, s * kBK);
      load_w<VW>(ws[s], p.w8, p.K, p.N, s * kBK, n0);
    }
    commit();
  }
  for (int s = 0; s < nk; ++s) {
    wait<kNS - 2>();  // this thread's copies of stage s have landed
    __syncthreads();  // everyone's have, and stage s - 1 is consumed
    const int nx = s + kNS - 1;
    if (nx < nk) {
      load_a<VA>(as[nx % kNS], p.a8, p.R, p.K, r0, nx * kBK);
      load_w<VW>(ws[nx % kNS], p.w8, p.K, p.N, nx * kBK, n0);
    }
    commit();
    mma_stage(as[s % kNS], ws[s % kNS], wr, wc, acc);
  }
  // acc[j][2h + e] is row wr + g + 8h, column wc + 8t + 4e + j: each lane
  // holds 8 adjacent columns of two rows
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c = n0 + wc + 8 * t;
  float sw[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sw[i] = c + i < p.N ? p.s_w[c + i] : 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + wr + g + 8 * h;
    if (r >= p.R) continue;
    const float sa = p.s_a[r];
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = ip2::qmm_epilogue(acc[j][2 * h], sa, sw[j]);
      v[4 + j] = ip2::qmm_epilogue(acc[j][2 * h + 1], sa, sw[4 + j]);
    }
    float* o = p.out + (long long)r * p.N + c;
    if (p.vec_out) {
      if (c < p.N) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      if (c + 4 < p.N) *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (c + i < p.N) o[i] = v[i];
    }
  }
}

template <int VA, int VW>
void run(const Args& p, cudaStream_t stream) {
  const dim3 grid((p.R + kBR - 1) / kBR, (p.N + kBN - 1) / kBN);
  quant_matmul_kernel<VA, VW><<<grid, kThreads, 0, stream>>>(p);
}

template <int VA>
void run_w(int vw, const Args& p, cudaStream_t stream) {
  if (vw == 16) run<VA, 16>(p, stream);
  else if (vw == 4) run<VA, 4>(p, stream);
  else run<VA, 1>(p, stream);
}

}  // namespace

// a8 (R, K) int8, s_a (R,) f32, w8 (K, N) int8, s_w (N,) f32 -> out (R, N)
// f32. Returns cudaGetLastError(), or cudaErrorInvalidValue for a K whose
// int32 sums could overflow.
extern "C" int quant_matmul_launch(const int8_t* a8, const float* s_a,
                                   const int8_t* w8, const float* s_w,
                                   float* out, int R, int K, int N,
                                   void* stream) {
  if (R < 0 || K < 0 || N < 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  if (R > 0 && N > 0) {
    const Args p{a8, s_a, w8, s_w, out, R, K, N,
                 N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0};
    const int va = copy_bytes(a8, K), vw = copy_bytes(w8, N);
    const cudaStream_t st = (cudaStream_t)stream;
    if (va == 16) run_w<16>(vw, p, st);
    else if (va == 4) run_w<4>(vw, p, st);
    else run_w<1>(vw, p, st);
  }
  return (int)cudaGetLastError();
}
