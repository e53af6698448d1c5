// ip2_fused_embed: gather -> project -> ADC codes -> w8a8 embed in one kernel.
//
// Replaces the Pallas TPU kernel ip2_fused_embed_pallas (src/repro/kernels/
// ip2_megakernel.py:251, body _fused_kernel :189). For slot s and row
// position p < counts[s], with row = table[s * k + p]:
//   codes[p, :] = ADC(project(patches[row, :]))        (bias 0)
//   out[s*k+p, d] = (float(codes[p, :] @ w8[:, d]) * s_a) * s_w[d]
// and rows at or past the slot's count are 0. Codes of up to 8 bits are
// int8; those of a 9- to 16-bit ADC are split into 2 byte planes, of a 17-
// to 32-bit ADC into 4 (qmm_tile.cuh), so the embed sums are the
// reference's int32 sums modulo 2^32 at every M. The codes never leave the
// chip.
//
// What bounds it here: the projection's fp32 work (2·R·K·M) dominates, so
// fp32 operations bound it, as for ip2_project (0.006 ms at R = 1024, K =
// 1024, M = 192); the embed adds 2·R·M·D int8 tensor-core operations. In
// practice the projection tile is bound by the SM's shared-memory datapath
// (ip2_tile.cuh), and here also by where the card can place clusters.
//
// Bitwise contract: the projection is ip2_tile.cuh's pipelined tile, one
// fmaf chain from 0.0f in k order per output, with ip2_project's epilogue;
// the embed sums are int32 modulo 2^32, which no order changes; the store is
// ip2::qmm_epilogue. So the result equals ip2_project -> quant_matmul bit
// for bit at any shape.
//
// Design, for Hopper:
// - Grid: the (slot, position) rows flattened into banks of 64 rows (a
//   bank may span slots: a row's slot and position are divmod(row, k)),
//   each bank paired with its ceil(M / 32) column slices of 32: FusedTile
//   blocks of 64 x 32 outputs, 128 threads. A row at or past its slot's
//   count reads nothing and has code 0; a bank with no live row stores its
//   zeros and does no work.
// - One thread-block cluster per bank, of min(ceil(M / 32), 8) blocks;
//   block q projects slices q, q + 8, ... with project_tile_pipelined and
//   writes their ADC codes into its own copy of the bank's code tile in
//   shared memory (zero for dead rows and columns past M), laid out as
//   int8 A stages of 64 k (one plane per code byte: 1, 2 or 4).
// - M in chunks: where the whole bank's code tile does not fit one block's
//   shared memory (M > 2496 for int8 codes, 1216 for int16, 576 for int32),
//   the kernel walks M in equal chunks of whole 64-k stages that fit, each
//   projected, exchanged and embedded in turn. Between chunks each block
//   keeps its tiles' raw int32 sums in out (the same element it stores at
//   the end, written and read back by the same thread) and adds the next
//   chunk's sums to them; the last chunk stores lsb * s_w once. Sums modulo
//   2^32 do not depend on the order, so every M gives the staged pair's
//   bits. Up to those M there is one chunk and the path is the one-chunk
//   kernel's.
//   At the serving shape that is 16 clusters of 6 blocks, placed one block
//   per SM on 96 SMs. (With 48-row banks, ip2_project's tile, 22 clusters
//   of 6 would fill 132 SMs, but the card fits only 20 such clusters at one
//   block per SM, so 12 SMs ran two blocks and the kernel took 0.040 ms
//   instead of 0.032; PERF.md.)
// - Exchange through distributed shared memory: every block then stores
//   its slices into the code tile of every other block of the cluster
//   (16-byte stores to map_shared_rank addresses), and a cluster barrier
//   (release / acquire) publishes them. The first cluster barrier is split:
//   arrived at before the projection, waited on after it, so a block only
//   writes into blocks that have started. After the second one no block
//   touches another's memory, so none has to wait for the others to end.
// - Embed on int8 tensor cores: the bank's 64 x D output in tiles of 64 x
//   64 columns, dealt round-robin to the blocks of the cluster. Warp w
//   takes columns (w & 1) * 32 .. + 31 and the k half (w >> 1) * 32 of
//   every 64-k stage, for all four 16-row groups (m16n8k32 MMAs, A from
//   the local code tile, B from a cp.async ring of w8 stages whose first
//   three, all of M = 192, are in flight while the projection runs); the
//   two k halves' int32 sums meet in shared memory, and the epilogue is
//   stored as float4 (dead rows as 0.0f).
#include <cooperative_groups.h>

#include <algorithm>

#include "ip2_tile.cuh"
#include "qmm_tile.cuh"

namespace {

namespace cg = cooperative_groups;
using T = ip2::FusedTile;
namespace qmm = ip2::qmm;

constexpr int kBankRows = T::BR;                 // rows a bank
constexpr int kRG = (kBankRows + 15) / 16;       // m16 row groups of the embed
constexpr int kMaxCluster = 8;                   // the portable cluster size
constexpr int kTileN = qmm::kBN;                 // embed tile: the bank x 64 columns
constexpr int kCodeBlock = kRG * 16 * qmm::kBK;  // bytes per 64 k of a plane
constexpr int kNW = 4;                           // w8 ring stages of the embed
// an H100 block's shared memory (opt-in), less the static rows table
constexpr size_t kMaxSmem = 232448 - kBankRows * sizeof(long long);
static_assert(T::NT == qmm::kThreads, "one 128-thread block for both tiles");
static_assert(qmm::kBK % T::BM == 0 && T::BM % 16 == 0,
              "a slice is whole 16-byte chunks of one 64-k code block");
constexpr int kSliceChunks = T::BM / 16;

// Dynamic shared memory: the projection ring (later the k halves' partial
// sums), the w8 ring, and the code tile of one chunk of the bank's columns
// (np planes of ceil(chunk / 64) A stages of 16 kRG rows x 64 k).
constexpr int kProjBytes = T::SMEM_FLOATS * 4;
constexpr int kWRingBytes = kNW * qmm::kWStage;
constexpr int kXchBytes = 2 * kRG * 16 * 32 * 4;  // 2 warps, 16 kRG sums, 32 lanes
static_assert(kXchBytes <= kProjBytes, "partial sums fit the dead ring");

__host__ __device__ __forceinline__ int plane_bytes(int M) {
  return (M + qmm::kBK - 1) / qmm::kBK * kCodeBlock;
}

__host__ __forceinline__ size_t smem_bytes(int M, int np) {
  return (size_t)kProjBytes + kWRingBytes + np * (size_t)plane_bytes(M);
}

// Columns of codes a chunk: M when the bank's whole code tile fits one
// block's shared memory, else the fewest equal chunks of whole 64-k stages
// that fit.
__host__ __forceinline__ int chunk_cols(int M, int np) {
  if (smem_bytes(M, np) <= kMaxSmem) return M;
  const int fit = (int)((kMaxSmem - kProjBytes - kWRingBytes) / (np * (size_t)kCodeBlock)) *
                  qmm::kBK;
  const int n = (M + fit - 1) / fit;
  return ((M + n - 1) / n + qmm::kBK - 1) / qmm::kBK * qmm::kBK;
}

__host__ __forceinline__ int cluster_size(int M) {
  return std::min(std::max((M + T::BM - 1) / T::BM, 1), kMaxCluster);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct Args {
  const float* patches;
  const int* table;
  const int* counts;
  int S, k, K;
  const float* w;
  int M;
  const int8_t* w8;
  const float* s_w;
  float s_a;
  int D;
  float* out;
  int mc;        // columns of codes a chunk (M: one chunk)
  int cs;        // blocks per cluster
  bool vec_out;  // D % 4 == 0 and out 16-byte aligned: float4 stores
};

// One warp's raw int32 sums between chunks of M, kept in out at the
// elements store_warp writes at the end (acc[j][2h + e] is row g + 8h,
// column c + 4e + j; rows with o[h] null and columns past N are never
// stored, so they are not kept). LOAD adds the kept sums to acc, else acc
// is kept.
template <bool LOAD>
__device__ __forceinline__ void carry_warp(unsigned (&acc)[4][4], float* const (&o)[2], int c,
                                           int N) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (o[h] == nullptr) continue;
    unsigned* u = reinterpret_cast<unsigned*>(o[h]);
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + 4 * e + j < N) {
          if constexpr (LOAD) acc[j][2 * h + e] += u[4 * e + j];
          else u[4 * e + j] = acc[j][2 * h + e];
        }
  }
}

// VEC: the projection's copy width (ip2::vec4_ok); VW: the w8 copy width;
// NP: the code planes (1 for int8 codes, 2 for int16, 4 for int32); CH: M
// in chunks (else one chunk of all of M, with no chunk bookkeeping in the
// code).
template <int VEC, int VW, int NP, bool CH>
__global__ void __launch_bounds__(T::NT, 1)
ip2_fused_embed_kernel(const Args p, const ip2::Epilogue e) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long rows[kBankRows];
  float* ring = reinterpret_cast<float*>(smem);
  int8_t* wring = reinterpret_cast<int8_t*>(smem + kProjBytes);
  int8_t* codes = reinterpret_cast<int8_t*>(smem + kProjBytes + kWRingBytes);
  const int mc = CH ? p.mc : p.M;  // columns a chunk
  const int plane = plane_bytes(mc);
  const int rank = blockIdx.x % p.cs;
  const long long R = (long long)p.S * p.k;
  const long long r0 = (long long)(blockIdx.x / p.cs) * kBankRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  bool live = false;
  if (tid < kBankRows) {
    const long long gr = r0 + tid;
    if (gr < R) {
      const int s = (int)(gr / p.k), pos = (int)(gr % p.k);
      live = pos < min(max(p.counts[s], 0), p.k);
    }
    rows[tid] = live ? (long long)p.table[gr] * p.K : -1;
  }
  // every block of a cluster has the same rows, so the whole cluster
  // leaves here or none of it does
  if (!__syncthreads_or(live)) {
    const long long n = min((long long)kBankRows, R - r0) * p.D;
    for (long long i = (long long)rank * T::NT + tid; i < n; i += (long long)p.cs * T::NT)
      p.out[r0 * p.D + i] = 0.0f;
    return;
  }
  const int n_tiles = (p.D + kTileN - 1) / kTileN;
  unsigned* xch = reinterpret_cast<unsigned*>(smem);  // over the projection ring
  const int wc = (warp & 1) * 32, kk = (warp >> 1) * 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int tr = tid / T::TC, tc = tid % T::TC;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kChunks = NP * kBankRows * kSliceChunks;  // per slice
  int m0 = 0;
  do {  // once at M 0 too: the bank's rows are stored as 0
    const int mw = CH ? min(mc, p.M - m0) : p.M;  // this chunk's columns
    const bool first = !CH || m0 == 0, last = !CH || m0 + mc >= p.M;
    if (first) {
      cluster_arrive_relaxed();
    } else {
      __syncthreads();  // the last chunk's ring, partial sums and code tile are consumed
      cluster_arrive();  // ... and the others may write into this block's code tile
    }

    // the first embed tile's w8 stages land while the projection runs
    const int nkw = (mw + qmm::kBK - 1) / qmm::kBK;
    auto load_w_prologue = [&](int n0) {
#pragma unroll
      for (int st = 0; st < kNW - 1; ++st) {
        if (st < nkw)
          qmm::load_w<VW>(wring + st * qmm::kWStage, p.w8, p.M, p.D, m0 + st * qmm::kBK, n0);
        qmm::commit();
      }
    };
    if (rank < n_tiles) load_w_prologue(rank * kTileN);

    // the projection of the chunk's slices rank, rank + cs, ... into the
    // local code tile
    const int sl0 = m0 / T::BM, sl1 = (m0 + mw + T::BM - 1) / T::BM;
    for (int sl = sl0 + rank; sl < sl1; sl += p.cs) {
      const int m = sl * T::BM + tc * T::TM;  // this thread's 4 columns
      float acc[T::TR][T::TM];
      ip2::project_tile_pipelined<T, VEC>(p.patches, rows, p.w, p.K, p.M, sl * T::BM, e,
                                          ring, acc);
#pragma unroll
      for (int i = 0; i < T::TR; ++i) {
        const int r = tr * T::TR + i;
        unsigned pb[NP] = {};  // plane q holds byte NP - 1 - q of each code
#pragma unroll
        for (int j = 0; j < T::TM; ++j) {
          const int c = rows[r] >= 0 && m + j < p.M
                            ? __float2int_rn(ip2::adc_code(ip2::analog_out(acc[i][j], e), e))
                            : 0;
#pragma unroll
          for (int q = 0; q < NP; ++q)
            pb[q] |= ((static_cast<unsigned>(c) >> (8 * (NP - 1 - q))) & 0xFF) << (8 * j);
        }
        const int o =
            ((m - m0) / qmm::kBK) * kCodeBlock + qmm::swz_a(r * qmm::kBK + m % qmm::kBK);
#pragma unroll
        for (int q = 0; q < NP; ++q) *reinterpret_cast<unsigned*>(codes + q * plane + o) = pb[q];
      }
      __syncthreads();  // the codes are written; the ring is free for the next slice
    }

    // every block of the cluster has started (and is done with its code
    // tile's last chunk): hand this block's slices to the others (a slice's
    // columns are whole 16-byte chunks of each swizzled 64-byte row)
    cluster_wait();
    for (int sl = sl0 + rank; sl < sl1; sl += p.cs) {
      for (int t = tid; t < kChunks; t += T::NT) {
        const int pl = t / (kSliceChunks * kBankRows), r = t / kSliceChunks % kBankRows;
        const int m = sl * T::BM + t % kSliceChunks * 16;
        int4* src =
            reinterpret_cast<int4*>(codes + pl * plane + ((m - m0) / qmm::kBK) * kCodeBlock +
                                    qmm::swz_a(r * qmm::kBK + m % qmm::kBK));
        const int4 v = *src;
        for (int q = 0; q < p.cs; ++q)
          if (q != rank) *cluster.map_shared_rank(src, q) = v;
      }
    }
    cluster_arrive();
    cluster_wait();  // the whole chunk's codes are in every block of the cluster

    // the embed: tiles rank, rank + cs, ... of the bank's rows x 64 columns
    for (int tile = rank; tile < n_tiles; tile += p.cs) {
      const int n0 = tile * kTileN;
      if (tile != rank) {
        __syncthreads();  // the last tile's ring stages and partial sums are consumed
        load_w_prologue(n0);
      }
      unsigned acc[kRG][4][4] = {};
      for (int s = 0; s < nkw; ++s) {
        qmm::wait<kNW - 2>();  // this thread's copies of stage s have landed
        __syncthreads();       // everyone's have, and stage s - 1 is consumed
        const int nx = s + kNW - 1;
        if (nx < nkw)
          qmm::load_w<VW>(wring + (nx % kNW) * qmm::kWStage, p.w8, p.M, p.D,
                          m0 + nx * qmm::kBK, n0);
        qmm::commit();
        unsigned lo[4], hi[4];
        qmm::load_b_frag(wring + (s % kNW) * qmm::kWStage, wc, kk, lo, hi);
        const int8_t* ah = codes + s * kCodeBlock;
#pragma unroll
        for (int rg = 0; rg < kRG; ++rg)
          qmm::mma_k32<NP>(ah, plane, rg * 16, kk, lo, hi, acc[rg]);
      }
      // the k halves: warps 2 and 3 hand their sums to warps 0 and 1
      unsigned* x = xch + (warp & 1) * kRG * 16 * 32 + lane;
      if (warp >= 2) {
#pragma unroll
        for (int rg = 0; rg < kRG; ++rg)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) x[((rg * 4 + j) * 4 + i) * 32] = acc[rg][j][i];
      }
      __syncthreads();
      if (warp < 2) {
        const int c = n0 + wc + 8 * t4;
#pragma unroll
        for (int rg = 0; rg < kRG; ++rg) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[rg][j][i] += x[((rg * 4 + j) * 4 + i) * 32];
          float* o[2];
          bool alive[2];
          const float sa[2] = {p.s_a, p.s_a};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rg * 16 + g + 8 * h;
            o[h] = r < kBankRows && r0 + r < R ? p.out + (r0 + r) * p.D + c : nullptr;
            alive[h] = r < kBankRows && rows[r] >= 0;
          }
          if (!first) carry_warp<true>(acc[rg], o, c, p.D);
          if (last) qmm::store_warp(acc[rg], o, sa, alive, p.s_w, c, p.D, p.vec_out);
          else carry_warp<false>(acc[rg], o, c, p.D);
        }
      }
    }
    m0 += mc;
  } while (CH && m0 < p.M);
}

template <int VEC, int VW, int NP, bool CH>
cudaError_t launch(const Args& a, const ip2::Epilogue& e, size_t smem, long long n_banks,
                   cudaStream_t stream) {
  const auto kernel = ip2_fused_embed_kernel<VEC, VW, NP, CH>;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.cs * n_banks));
  cfg.blockDim = dim3(T::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a, e);
}

// the chunked kernel takes 16-byte or byte-wise w8 copies only (fewer
// instantiations to build)
template <int VEC, int NP, bool CH>
cudaError_t launch_w(int vw, const Args& a, const ip2::Epilogue& e, size_t smem,
                     long long n_banks, cudaStream_t stream) {
  if (vw == 16) return launch<VEC, 16, NP, CH>(a, e, smem, n_banks, stream);
  if (vw == 4 && !CH) return launch<VEC, 4, NP, CH>(a, e, smem, n_banks, stream);
  return launch<VEC, 1, NP, CH>(a, e, smem, n_banks, stream);
}

template <int NP, bool CH>
cudaError_t launch_v(bool vec, int vw, const Args& a, const ip2::Epilogue& e, size_t smem,
                     long long n_banks, cudaStream_t stream) {
  return vec ? launch_w<4, NP, CH>(vw, a, e, smem, n_banks, stream)
             : launch_w<1, NP, CH>(vw, a, e, smem, n_banks, stream);
}

template <int NP>
cudaError_t launch_c(bool chunked, bool vec, int vw, const Args& a, const ip2::Epilogue& e,
                     size_t smem, long long n_banks, cudaStream_t stream) {
  return chunked ? launch_v<NP, true>(vec, vw, a, e, smem, n_banks, stream)
                 : launch_v<NP, false>(vec, vw, a, e, smem, n_banks, stream);
}

// 1 for int8 codes, 2 for int16, 4 for int32, 0 for an ADC wider than 32 bits
__host__ int code_bytes(const ip2::Epilogue& e) {
  return e.adc_half <= 128.0f     ? 1
         : e.adc_half <= 32768.0f ? 2
         : e.adc_half <= 2147483648.0f ? 4
                                       : 0;
}

}  // namespace

// patches (rows, K) f32, table (S * k,) i32 dense row indices, counts (S,)
// i32, w (K, M) f32 on the DAC grid, w8 (M, D) int8, s_w (D,) f32, s_a the
// ADC LSB -> out (S * k, D) f32. The epilogue must be in code mode; the
// code width (int8 up to 8 bits, int16 up to 16, int32 up to 32) follows
// its ADC; M may be any size (in chunks past the code tile's room).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an ADC wider
// than 32 bits.
extern "C" int ip2_fused_embed_launch(const float* patches, const int* table,
                                      const int* counts, int S, int k, int K,
                                      const float* w, int M, const int8_t* w8,
                                      const float* s_w, float s_a, int D,
                                      float* out, const ip2::Epilogue* e,
                                      void* stream) {
  const int cb = code_bytes(*e);
  if (e->mode != ip2::kCodes || cb == 0) return (int)cudaErrorInvalidValue;
  if (S < 0 || k < 0 || K < 0 || M < 0 || D < 0) return (int)cudaErrorInvalidValue;
  const int mc = chunk_cols(M, cb);
  const size_t smem = smem_bytes(mc, cb);
  const long long R = (long long)S * k;
  if (R == 0 || D == 0) return (int)cudaGetLastError();
  const Args a{patches, table, counts, S, k, K, w, M, w8, s_w, s_a, D, out, mc,
               cluster_size(M), D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0};
  const long long n_banks = (R + kBankRows - 1) / kBankRows;
  const int vw = qmm::copy_bytes(w8, D);
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = ip2::vec4_ok(patches, w, K, M);
  const bool ch = mc < M;
  const cudaError_t rc = cb == 4   ? launch_c<4>(ch, vec, vw, a, *e, smem, n_banks, st)
                        : cb == 2 ? launch_c<2>(ch, vec, vw, a, *e, smem, n_banks, st)
                                  : launch_c<1>(ch, vec, vw, a, *e, smem, n_banks, st);
  const cudaError_t last = cudaGetLastError();
  return (int)(rc != cudaSuccess ? rc : last);
}

// The launch shape of the serving instantiation (16-byte copies) for M
// columns of codes of code_bytes: out[0] blocks per cluster, out[1] dynamic
// shared memory per block in bytes, out[2] resident blocks per SM, out[3]
// clusters resident at once on the device. Returns a cudaError_t.
extern "C" int ip2_fused_embed_occupancy(int M, int code_bytes_, int* out) {
  if ((code_bytes_ != 1 && code_bytes_ != 2 && code_bytes_ != 4) || M < 0)
    return (int)cudaErrorInvalidValue;
  const int mc = chunk_cols(M, code_bytes_);
  const size_t smem = smem_bytes(mc, code_bytes_);
  const bool ch = mc < M;
  const auto kernel = code_bytes_ == 4 ? (ch ? ip2_fused_embed_kernel<4, 16, 4, true>
                                             : ip2_fused_embed_kernel<4, 16, 4, false>)
                      : code_bytes_ == 2 ? (ch ? ip2_fused_embed_kernel<4, 16, 2, true>
                                               : ip2_fused_embed_kernel<4, 16, 2, false>)
                                         : (ch ? ip2_fused_embed_kernel<4, 16, 1, true>
                                               : ip2_fused_embed_kernel<4, 16, 1, false>);
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int cs = cluster_size(M);
  out[0] = cs;
  out[1] = (int)smem;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, T::NT, smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(T::NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(&out[3], kernel, &cfg);
}
