// ip2_project: the analog patch-projection array with its fused readout.
//
// Replaces the Pallas TPU kernel ip2_project_pallas (src/repro/kernels/
// ip2_project.py:138, body _ip2_kernel :119):
//   out[r, v] = readout(sum_i PWM(x[r, i]) * Wq[i, v]),
// readout = acc * (droop / n2) + V_R, the optional 2T clip, then ADC codes
// (int8, int16 or int32 as the ADC's width needs), the dequantised float, the
// float without an ADC, or an int8 sign bit.
//
// What bounds it here: on the serving path (R = 1024 rows, K = 1024, M =
// 192) it does 0.4 GFLOP on 5 MB, so fp32 operations bound it (CUDA-core
// fp32, 67 TFLOP/s). Tensor cores are ruled out on purpose: TF32 keeps 10
// mantissa bits and moves ADC codes, and the codes are the contract.
// Design: 16-row x 64-column tiles, 128 threads, K streamed through shared
// memory 32 at a time with the PWM quantiser applied at tile load; each
// thread keeps a 2 x 4 register tile and walks K in order (ip2_common.cuh),
// so the fused kernel reproduces these sums exactly.
#include "ip2_common.cuh"

namespace {

__global__ void __launch_bounds__(ip2::kThreads)
ip2_project_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ colv, void* out, int out_bytes,
                   int R, int K, int M, ip2::Epilogue e) {
  using namespace ip2;
  __shared__ float xs[kBR * kBK];
  __shared__ float ws[kBK * kBM];
  __shared__ long long rows[kBR];
  const int r0 = blockIdx.x * kBR, c0 = blockIdx.y * kBM;
  const int tid = threadIdx.x;
  if (tid < kBR) rows[tid] = r0 + tid < R ? (long long)(r0 + tid) * K : -1;
  __syncthreads();
  float acc[kTR][kTM];
  project_tile<kBR, kBM, kBK, kTR, kTM>(x, rows, w, K, M, c0, e, xs, ws, acc);
  const int tr = tid / (kBM / kTM), tc = tid % (kBM / kTM);
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = r0 + tr * kTR + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int c = c0 + tc * kTM + j;
      if (c >= M) continue;
      store_readout(out, out_bytes, (long long)r * M + c,
                    readout(acc[i][j], colv ? colv[c] : 0.0f, e), e);
    }
  }
}

}  // namespace

// x (R, K) f32, w (K, M) f32 on the DAC grid, colv (M,) f32 or null,
// out (R, M) f32, or an integer of out_bytes (1, 2 or 4) bytes for codes and
// sign. Returns cudaGetLastError().
extern "C" int ip2_project_launch(const float* x, const float* w,
                                  const float* colv, void* out, int out_bytes,
                                  int R, int K, int M, const ip2::Epilogue* e,
                                  void* stream) {
  if (!ip2::out_bytes_ok(out_bytes, *e)) return (int)cudaErrorInvalidValue;
  if (R > 0 && M > 0) {
    dim3 grid((R + ip2::kBR - 1) / ip2::kBR, (M + ip2::kBM - 1) / ip2::kBM);
    ip2_project_kernel<<<grid, ip2::kThreads, 0, (cudaStream_t)stream>>>(
        x, w, colv, out, out_bytes, R, K, M, *e);
  }
  return (int)cudaGetLastError();
}
