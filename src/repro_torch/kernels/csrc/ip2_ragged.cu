// ip2_ragged: the projection of rows gathered by a row table, dense or with
// per-slot row counts.
//
// Replaces two Pallas TPU kernels:
//   ip2_project_sparse_pallas (src/repro/kernels/ip2_project_sparse.py:79,
//     body _ip2_sparse_kernel :50) — entry ip2_project_sparse_launch:
//       out[r, :] = readout(project(x[table[r], :]))              r < R
//   ip2_ragged_pallas (src/repro/kernels/ip2_megakernel.py:122, body
//     _ragged_kernel :88) — entry ip2_ragged_launch, the same with a slot
//     axis: for slot s and row position p,
//       out[s*k+p, :] = p < counts[s] ? readout(project(x[table[s*k+p], :])) : 0
// with the readouts of ip2_project.cu (codes of the ADC's width, dequant,
// no-ADC float, sign bit).
//
// What bounds it here: on the gated serving path (64 slots, j = 8 rows per
// slot, K = 1024, M = 192) it does at most 0.2 GFLOP on ~2 MB of gathered
// rows and weights, so fp32 operations bound it, but the bound (~0.003 ms)
// is below a launch's latency: at these shapes the launch dominates.
// Design: one 128-thread block per (slot, 16-row bank, 64-column tile),
// with the same project_tile and epilogue as ip2_project (ip2_common.cuh),
// so a row's codes are bit for bit those ip2_project gives for the same
// gathered row. A block reads its rows from the table and its slot's count;
// rows at or past the count read nothing, and a bank wholly past it skips
// the projection and stores zeros. Every output row is stored, zeros
// included: the wrapper allocates with torch.empty.
#include "ip2_common.cuh"

namespace {

__global__ void __launch_bounds__(ip2::kThreads)
ip2_ragged_kernel(const float* __restrict__ x, const int* __restrict__ table,
                  const int* __restrict__ counts, int k, int K,
                  const float* __restrict__ w, int M,
                  const float* __restrict__ colv, void* out, int out_bytes,
                  ip2::Epilogue e) {
  using namespace ip2;
  __shared__ float xs[kBR * kBK];
  __shared__ float ws[kBK * kBM];
  __shared__ long long rows[kBR];
  const int bank0 = blockIdx.x * kBR, s = blockIdx.y, c0 = blockIdx.z * kBM;
  const int tid = threadIdx.x;
  const int cnt = counts ? min(max(counts[s], 0), k) : k;
  const long long row0 = (long long)s * k;
  if (bank0 >= cnt) {
    for (int t = tid; t < kBR * kBM; t += kThreads) {
      const int p = bank0 + t / kBM, c = c0 + t % kBM;
      if (p < k && c < M) store_readout(out, out_bytes, (row0 + p) * M + c, 0.0f, e);
    }
    return;
  }
  if (tid < kBR) {
    const int p = bank0 + tid;
    rows[tid] = p < cnt ? (long long)table[row0 + p] * K : -1;
  }
  __syncthreads();
  float acc[kTR][kTM];
  project_tile<kBR, kBM, kBK, kTR, kTM>(x, rows, w, K, M, c0, e, xs, ws, acc);
  const int tr = tid / (kBM / kTM), tc = tid % (kBM / kTM);
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int p = bank0 + tr * kTR + i;
    if (p >= k) continue;
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      const int c = c0 + tc * kTM + j;
      if (c >= M) continue;
      const float v = p < cnt ? readout(acc[i][j], colv ? colv[c] : 0.0f, e) : 0.0f;
      store_readout(out, out_bytes, (row0 + p) * M + c, v, e);
    }
  }
}

int launch(const float* x, const int* table, const int* counts, int S, int k,
           int K, const float* w, int M, const float* colv, void* out,
           int out_bytes, const ip2::Epilogue* e, void* stream) {
  if (!ip2::out_bytes_ok(out_bytes, *e)) return (int)cudaErrorInvalidValue;
  if (S > 0 && k > 0 && M > 0) {
    dim3 grid((k + ip2::kBR - 1) / ip2::kBR, S, (M + ip2::kBM - 1) / ip2::kBM);
    ip2_ragged_kernel<<<grid, ip2::kThreads, 0, (cudaStream_t)stream>>>(
        x, table, counts, k, K, w, M, colv, out, out_bytes, *e);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, K) f32 patch grid, table (R,) i32 row indices into it, w (K, M)
// f32 on the DAC grid, colv (M,) f32 or null (as ip2_project) -> out (R, M)
// f32, or an integer of out_bytes bytes for codes and sign.
// Returns cudaGetLastError().
extern "C" int ip2_project_sparse_launch(const float* x, const int* table, int R,
                                         int K, const float* w, int M,
                                         const float* colv, void* out,
                                         int out_bytes, const ip2::Epilogue* e,
                                         void* stream) {
  return launch(x, table, nullptr, 1, R, K, w, M, colv, out, out_bytes, e, stream);
}

// As above with a slot axis: table (S * k,) i32, counts (S,) i32 real rows
// per slot -> out (S * k, M), rows at or past their slot's count zero.
extern "C" int ip2_ragged_launch(const float* x, const int* table,
                                 const int* counts, int S, int k, int K,
                                 const float* w, int M, const float* colv,
                                 void* out, int out_bytes,
                                 const ip2::Epilogue* e, void* stream) {
  return launch(x, table, counts, S, k, K, w, M, colv, out, out_bytes, e, stream);
}
