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
// 192) it does 0.4 GFLOP on 5 MB, so by the card's peaks fp32 operations
// bound it (CUDA-core fp32, 67 TFLOP/s: 0.006 ms). Tensor cores are ruled
// out on purpose: TF32 keeps 10 mantissa bits and moves ADC codes, and the
// codes are the contract. So are split-K and any reassociation: each
// output is one fmaf chain over k in order (ip2_tile.cuh), which is what
// keeps ip2_fused_embed (the same tile and chain) bitwise equal to this
// kernel. In practice the SM's shared-memory datapath bounds it:
// the fixed chain leaves ~12 chains per fp32 lane, too few for a register
// tile that would feed the FMAs from shared memory at full rate (see
// ip2_tile.cuh).
//
// Design: ProjectTile (ip2_tile.cuh), 48 x 32 outputs per 128-thread
// block, 3 x 4 per thread, a 4-stage cp.async ring of 32-k stages with PWM
// applied once per element as a stage lands. At the serving shape the grid
// is 22 x 6 = 132 blocks, one per SM and one warp per scheduler, each lane
// carrying 12 independent chains of 1024 FMAs (196 608 chains on 16 896
// lanes). ptxas (sm_90a, CUDA 12.8): 93 registers, no spill, 44 800 bytes
// of shared memory with 16-byte copies; 165 registers with 4-byte ones.
#include "ip2_tile.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(ip2::ProjectTile::NT, 1)
ip2_project_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ colv, void* out, int out_bytes,
                   int R, int K, int M, ip2::Epilogue e) {
  using T = ip2::ProjectTile;
  __shared__ __align__(16) float smem[T::SMEM_FLOATS];
  __shared__ long long rows[T::BR], orow[T::BR];
  const int r0 = blockIdx.x * T::BR, c0 = blockIdx.y * T::BM;
  const int tid = threadIdx.x;
  if (tid < T::BR) {
    const int r = r0 + tid;
    orow[tid] = r < R ? r : -1;
    rows[tid] = r < R ? (long long)r * K : -1;
  }
  __syncthreads();
  float acc[T::TR][T::TM];
  ip2::project_tile_pipelined<T, VEC>(x, rows, w, K, M, c0, e, smem, acc);
  ip2::store_tile<T>(acc, orow, M, c0, colv, out, out_bytes, e);
}

}  // namespace

// x (R, K) f32, w (K, M) f32 on the DAC grid, colv (M,) f32 or null,
// out (R, M) f32, or an integer of out_bytes (1, 2 or 4) bytes for codes and
// sign. Returns cudaGetLastError().
extern "C" int ip2_project_launch(const float* x, const float* w,
                                  const float* colv, void* out, int out_bytes,
                                  int R, int K, int M, const ip2::Epilogue* e,
                                  void* stream) {
  using T = ip2::ProjectTile;
  if (!ip2::out_bytes_ok(out_bytes, *e)) return (int)cudaErrorInvalidValue;
  if (R > 0 && M > 0) {
    const dim3 grid((R + T::BR - 1) / T::BR, (M + T::BM - 1) / T::BM);
    const cudaStream_t s = (cudaStream_t)stream;
    if (ip2::vec4_ok(x, w, K, M))
      ip2_project_kernel<4><<<grid, T::NT, 0, s>>>(x, w, colv, out, out_bytes, R, K, M, *e);
    else
      ip2_project_kernel<1><<<grid, T::NT, 0, s>>>(x, w, colv, out, out_bytes, R, K, M, *e);
  }
  return (int)cudaGetLastError();
}
