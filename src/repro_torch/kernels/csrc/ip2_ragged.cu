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
// slot, K = 1024, M = 192) the governor keeps most counts at 1 (75 live
// rows of 512 on the last tick), so the work is ~14 400 chains of 1024
// FMAs: 0.03 GFLOP, a bound of 0.0004 ms, far below one chain's latency
// (1024 dependent FMAs, ~2 us) plus a launch. So latency bounds it: the
// design makes the work scale with the live rows and spreads them over
// many SMs.
//
// Bitwise contract: both entries run the pipelined tile of ip2_project
// (ip2_tile.cuh), one fmaf chain over k in order per output, so a row's
// codes equal ip2_project's, and ip2_fused_embed's, on the same gathered
// row bit for bit whatever the tile shape.
//
// Design:
// - Packed rows. The grid covers the worst case, S*k rows, in tiles of BR.
//   Block b computes the live (slot, row) pairs b*BR .. b*BR+BR-1 in packed
//   slot-major order, and stores zeros for the output rows b*BR ..
//   b*BR+BR-1 that are at or past their slot's count. Each block reads the
//   counts (on the device: no host sync, no extra launch), clips them to
//   [0, k], scans them NT slots at a time until its packed rows are placed
//   and binary-searches their slots. So every output row is written
//   exactly once, zeros included (the wrapper allocates with torch.empty),
//   and a block past the live total only stores its zeros.
// - Tiles. With counts: RaggedTile, 16 x 16 outputs per 64-thread block,
//   2 x 2 per thread, so 75 live rows still occupy 5 x 12 = 60 blocks
//   (ptxas, sm_90a, CUDA 12.8: 108 registers with 16-byte copies, 239 with
//   4-byte ones, no spill, 26 000 bytes of shared memory). Without counts
//   (every row live, the dense sparse gather): ProjectTile, as
//   ip2_project (91 / 161 registers, 45 712 bytes).
#include "ip2_tile.cuh"

namespace {

// Exclusive prefix sum of v over the block's NT threads; *total gets the
// block's sum. Every thread must call it (two barriers).
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_tot[wid] = inc;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    const int s = warp_tot[i];
    if (i < wid) before += s;
    sum += s;
  }
  __syncthreads();
  *total = sum;
  return before + inc - v;
}

// The largest i in [0, n) with f(i) <= q, for f non-decreasing and
// f(0) <= q.
template <class F>
__device__ __forceinline__ int last_at_most(int n, long long q, F f) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (f(mid) <= q) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The block's rows. Live: packed rows v0 .. v0+BR-1, in slot-major order
// of the (slot, row) pairs below the counts, go to orow (their output row)
// and rows (the element offset of their x row); -1 where there is none.
// Dead: of the output rows v0 .. v0+BR-1, those at or past their slot's
// count go to zrow (-1 otherwise). Returns whether a live row is the
// block's. Ends with a barrier; every thread must call it.
template <class T>
__device__ bool resolve_rows(const int* __restrict__ table,
                             const int* __restrict__ counts, int S, int k, int K,
                             long long v0, long long* rows, long long* orow,
                             long long* zrow) {
  __shared__ int warp_tot[T::NT / 32];
  __shared__ int ex_s[T::NT];
  const int tid = threadIdx.x;
  const long long n_rows = (long long)S * k, v = v0 + tid;
  if (counts == nullptr) {  // every row live, in table order
    if (tid < T::BR) {
      orow[tid] = v < n_rows ? v : -1;
      rows[tid] = v < n_rows ? (long long)table[v] * K : -1;
      zrow[tid] = -1;
    }
    __syncthreads();
    return v0 < n_rows;
  }
  if (tid < T::BR) {
    orow[tid] = rows[tid] = zrow[tid] = -1;
    if (v < n_rows && v % k >= min(max(counts[v / k], 0), k)) zrow[tid] = v;
  }
  // scan the clipped counts NT slots at a time, until the block's packed
  // rows are placed
  long long live0 = 0;  // live rows before this chunk
  for (int s0 = 0; s0 < S && live0 < v0 + T::BR; s0 += T::NT) {
    const int n = min(T::NT, S - s0);
    const int c = tid < n ? min(max(counts[s0 + tid], 0), k) : 0;
    int tot;
    ex_s[tid] = block_exclusive_scan<T::NT>(c, warp_tot, &tot);
    __syncthreads();
    const long long q = v - live0;
    if (tid < T::BR && q >= 0 && q < tot) {
      const int i = last_at_most(n, q, [&](int m) { return (long long)ex_s[m]; });
      const long long o = (long long)(s0 + i) * k + (q - ex_s[i]);
      orow[tid] = o;
      rows[tid] = (long long)table[o] * K;
    }
    live0 += tot;
    __syncthreads();  // ex_s free for the next chunk; rows published
  }
  return v0 < live0;
}

template <class T, int VEC>
__global__ void __launch_bounds__(T::NT)
ip2_ragged_kernel(const float* __restrict__ x, const int* __restrict__ table,
                  const int* __restrict__ counts, int S, int k, int K,
                  const float* __restrict__ w, int M,
                  const float* __restrict__ colv, void* out, int out_bytes,
                  ip2::Epilogue e) {
  __shared__ __align__(16) float smem[T::SMEM_FLOATS];
  __shared__ long long rows[T::BR], orow[T::BR], zrow[T::BR];
  const int c0 = blockIdx.y * T::BM;
  const long long v0 = (long long)blockIdx.x * T::BR;
  const bool live = resolve_rows<T>(table, counts, S, k, K, v0, rows, orow, zrow);
  for (int t = threadIdx.x; t < T::BR * T::BM; t += T::NT) {
    const long long o = zrow[t / T::BM];
    const int c = c0 + t % T::BM;
    if (o >= 0 && c < M) ip2::store_readout(out, out_bytes, o * M + c, 0.0f, e);
  }
  if (!live) return;
  float acc[T::TR][T::TM];
  ip2::project_tile_pipelined<T, VEC>(x, rows, w, K, M, c0, e, smem, acc);
  ip2::store_tile<T>(acc, orow, M, c0, colv, out, out_bytes, e);
}

template <class T>
void launch_tile(const float* x, const int* table, const int* counts, int S, int k,
                 int K, const float* w, int M, const float* colv, void* out,
                 int out_bytes, const ip2::Epilogue& e, cudaStream_t stream) {
  const long long n_rows = (long long)S * k;
  const dim3 grid((unsigned)((n_rows + T::BR - 1) / T::BR), (M + T::BM - 1) / T::BM);
  if (ip2::vec4_ok(x, w, K, M))
    ip2_ragged_kernel<T, 4><<<grid, T::NT, 0, stream>>>(
        x, table, counts, S, k, K, w, M, colv, out, out_bytes, e);
  else
    ip2_ragged_kernel<T, 1><<<grid, T::NT, 0, stream>>>(
        x, table, counts, S, k, K, w, M, colv, out, out_bytes, e);
}

int launch(const float* x, const int* table, const int* counts, int S, int k,
           int K, const float* w, int M, const float* colv, void* out,
           int out_bytes, const ip2::Epilogue* e, void* stream) {
  if (!ip2::out_bytes_ok(out_bytes, *e)) return (int)cudaErrorInvalidValue;
  if (S > 0 && k > 0 && M > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (counts == nullptr)
      launch_tile<ip2::ProjectTile>(x, table, counts, S, k, K, w, M, colv, out,
                                    out_bytes, *e, s);
    else
      launch_tile<ip2::RaggedTile>(x, table, counts, S, k, K, w, M, colv, out,
                                   out_bytes, *e, s);
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
