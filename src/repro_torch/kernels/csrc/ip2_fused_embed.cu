// ip2_fused_embed: gather -> project -> ADC codes -> w8a8 embed in one kernel.
//
// Replaces the Pallas TPU kernel ip2_fused_embed_pallas (src/repro/kernels/
// ip2_megakernel.py:251, body _fused_kernel :189). For slot s and row
// position p < counts[s], with row = table[s * k + p]:
//   codes[p, :] = ADC(project(patches[row, :]))        (bias 0)
//   out[s*k+p, d] = (float(codes[p, :] @ w8[:, d]) * s_a) * s_w[d]
// and rows at or past the slot's count are 0.
//
// What bounds it here: the projection's fp32 work (2·R·K·M) dominates, so
// fp32 operations bound it, as for ip2_project; the embed adds 2·R·M·D int8
// operations and the codes never touch device memory. Design: one block
// per (slot, bank of 16 rows). The block reads its rows from the index
// table and its slot's count, gathers the patch rows straight from the
// dense patch grid, projects all M columns 64 at a time with the same
// project_tile and epilogue as ip2_project (ip2_common.cuh), keeps the int8
// code bank in shared memory, then each thread runs the embed for its
// columns with __dp4a. A bank wholly past its count writes zeros and does
// no work.
#include "ip2_common.cuh"

namespace {

__global__ void __launch_bounds__(ip2::kThreads)
ip2_fused_embed_kernel(const float* __restrict__ patches,
                       const int* __restrict__ table,
                       const int* __restrict__ counts, int k, int K,
                       const float* __restrict__ w, int M, int Mp,
                       const int8_t* __restrict__ w8,
                       const float* __restrict__ s_w, float s_a, int D,
                       float* __restrict__ out, ip2::Epilogue e) {
  using namespace ip2;
  __shared__ float xs[kBR * kBK];
  __shared__ float ws[kBK * kBM];
  __shared__ long long rows[kBR];
  extern __shared__ __align__(16) int8_t codes_s[];  // kBR x Mp
  const int s = blockIdx.y, bank0 = blockIdx.x * kBR, tid = threadIdx.x;
  const int cnt = min(max(counts[s], 0), k);
  const long long out0 = (long long)s * k;
  if (bank0 >= cnt) {
    for (int t = tid; t < kBR * D; t += kThreads) {
      const int p = bank0 + t / D;
      if (p < k) out[(out0 + p) * D + t % D] = 0.0f;
    }
    return;
  }
  if (tid < kBR) {
    const int p = bank0 + tid;
    rows[tid] = p < cnt ? (long long)table[out0 + p] * K : -1;
  }
  __syncthreads();
  const int tr = tid / (kBM / kTM), tc = tid % (kBM / kTM);
  for (int c0 = 0; c0 < Mp; c0 += kBM) {
    float acc[kTR][kTM];
    project_tile<kBR, kBM, kBK, kTR, kTM>(patches, rows, w, K, M, c0, e, xs,
                                          ws, acc);
#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = tr * kTR + i;
#pragma unroll
      for (int j = 0; j < kTM; ++j) {
        const int c = c0 + tc * kTM + j;
        const float code = (rows[r] >= 0 && c < M)
                               ? adc_code(analog_out(acc[i][j], e), e)
                               : 0.0f;
        codes_s[r * Mp + c] = (int8_t)__float2int_rn(code);
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < D; c += kThreads) {
    int acc[kBR];
#pragma unroll
    for (int r = 0; r < kBR; ++r) acc[r] = 0;
    int8_rows_dot_col<kBR>(codes_s, Mp, w8, M, D, c, acc);
#pragma unroll
    for (int r = 0; r < kBR; ++r) {
      const int p = bank0 + r;
      if (p < k)
        out[(out0 + p) * D + c] =
            p < cnt ? qmm_epilogue(acc[r], s_a, s_w[c]) : 0.0f;
    }
  }
}

}  // namespace

// patches (rows, K) f32, table (S * k,) i32 dense row indices, counts (S,)
// i32, w (K, M) f32 on the DAC grid, w8 (M, D) int8, s_w (D,) f32, s_a the
// ADC LSB -> out (S * k, D) f32. The epilogue must be in code mode.
// Returns cudaGetLastError().
extern "C" int ip2_fused_embed_launch(const float* patches, const int* table,
                                      const int* counts, int S, int k, int K,
                                      const float* w, int M, const int8_t* w8,
                                      const float* s_w, float s_a, int D,
                                      float* out, const ip2::Epilogue* e,
                                      void* stream) {
  if (e->mode != ip2::kCodes) return (int)cudaErrorInvalidValue;
  const int Mp = (M + ip2::kBM - 1) / ip2::kBM * ip2::kBM;
  const size_t smem = (size_t)ip2::kBR * Mp;
  if (smem > 32 * 1024) return (int)cudaErrorInvalidValue;
  if (S > 0 && k > 0) {
    dim3 grid((k + ip2::kBR - 1) / ip2::kBR, S);
    ip2_fused_embed_kernel<<<grid, ip2::kThreads, smem, (cudaStream_t)stream>>>(
        patches, table, counts, k, K, w, M, Mp, w8, s_w, s_a, D, out, *e);
  }
  return (int)cudaGetLastError();
}
