// quant_matmul: the w8a8 code-wire embed, y = (a8 @ w8) * s_a[r] * s_w[c].
//
// Replaces the Pallas TPU kernel quant_matmul_pallas (src/repro/kernels/
// quant_matmul.py:55, body _qmm_kernel :34): int8 x int8 with int32
// accumulation, then (float(acc) * s_a[r]) * s_w[c] in that order.
//
// What bounds it here: on the serving path (R = 1024 code rows, K = 192
// vectors, N = 256 model width) it moves ~1.3 MB for 0.1 GOP, so memory
// bytes bound it, not the int8 rate. Design: one block per 16 rows x 128
// columns; the block stages its int8 code rows in shared memory, each
// thread owns one column and keeps 16 int32 sums, and four k at a time go
// through __dp4a on the CUDA cores (no tensor-core tiles yet).
#include "ip2_common.cuh"

namespace {

constexpr int kRows = 16, kCols = 128;

__global__ void __launch_bounds__(kCols)
quant_matmul_kernel(const int8_t* __restrict__ a8,
                    const float* __restrict__ s_a,
                    const int8_t* __restrict__ w8,
                    const float* __restrict__ s_w, float* __restrict__ out,
                    int R, int K, int N, int Kp) {
  extern __shared__ __align__(16) int8_t a_s[];  // kRows x Kp
  const int r0 = blockIdx.x * kRows;
  for (int t = threadIdx.x; t < kRows * Kp; t += blockDim.x) {
    const int r = r0 + t / Kp, k = t % Kp;
    a_s[t] = (r < R && k < K) ? a8[(long long)r * K + k] : (int8_t)0;
  }
  __syncthreads();
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (c >= N) return;
  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;
  ip2::int8_rows_dot_col<kRows>(a_s, Kp, w8, K, N, c, acc);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r0 + r < R)
      out[(long long)(r0 + r) * N + c] =
          ip2::qmm_epilogue(acc[r], s_a[r0 + r], s_w[c]);
  }
}

}  // namespace

// a8 (R, K) int8, s_a (R,) f32, w8 (K, N) int8, s_w (N,) f32 -> out (R, N)
// f32. Returns cudaGetLastError().
extern "C" int quant_matmul_launch(const int8_t* a8, const float* s_a,
                                   const int8_t* w8, const float* s_w,
                                   float* out, int R, int K, int N,
                                   void* stream) {
  const int Kp = (K + 3) / 4 * 4;
  const size_t smem = (size_t)kRows * Kp;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (R > 0 && N > 0) {
    dim3 grid((R + kRows - 1) / kRows, (N + kCols - 1) / kCols);
    quant_matmul_kernel<<<grid, kCols, smem, (cudaStream_t)stream>>>(
        a8, s_a, w8, s_w, out, R, K, N, Kp);
  }
  return (int)cudaGetLastError();
}
