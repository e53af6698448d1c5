// delta_attention: ragged stale-prefix attention of the delta-gated backend.
//
// Replaces the Pallas TPU kernel delta_attention_pallas (src/repro/kernels/
// vit_delta_attention.py:130, body _delta_attn_kernel :79). For slot b,
// head h and query row r < q_counts[b] (counts clipped to [0, S]):
//   s_j   = (q[b, r, h, :] . k[b, j, h, :]) / sqrt(dh),  -1e30 where key j is invalid
//   out[b, r, h, :] = sum_j softmax(s)_j * v[b, j, h, :]
// and rows at or past the count are exact zeros. A slot whose keys are all
// invalid softmaxes uniformly over its -1e30 scores, as the reference does.
//
// What bounds it here: on the serving path (64 slots, 16 tokens, 4 heads,
// dh 64) a call reads the keys and values of the slots with live rows
// (up to 2 MB) and writes every output row (1 MB): ~1 us of bytes, a few
// MFLOP. The earlier design (one block per 8-query bank, head and slot,
// scores one 64-long chain per thread with 16-way bank conflicts, softmax
// on 8 threads of 128) was bound by latency and serial chains.
// Design: one 512-thread block per (head, slot). It stores the zero rows
// past the count with vector stores while its cp.async copies of the
// slot's keys, values and live query rows land in shared memory (keys at
// a row stride whose quarter is odd, so a quarter warp's float4 key loads
// hit 32 different banks). Each warp then takes live query rows: lanes
// take keys (a loop of 32-key chunks for S > 32), each score four fmaf
// chains over dh summed in a fixed order, divided by sqrtf(dh) with an
// IEEE divide; max and sum by warp shuffles; expf (no fast math); then
// lanes take output dims for the value mix, one fmaf chain over the keys
// each. A slot with no live row loads nothing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16, kThreads = 32 * kWarps;  // one warp per row at S 16
constexpr float kNegInf = -1e30f;  // the reference's masking constant
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory, opt-in

// Shared-memory row strides, in floats: d4 for values and queries, and for
// keys a multiple of 4 whose quarter is odd (conflict-free float4 loads).
__host__ __device__ __forceinline__ int row4(int dh) { return (dh + 3) & ~3; }
__host__ __device__ __forceinline__ int key_stride(int dh) {
  return (((dh + 3) >> 2) | 1) << 2;
}

__host__ __forceinline__ size_t smem_bytes(int S, int dh) {
  return sizeof(float) * (size_t)S * (key_stride(dh) + 2 * row4(dh) + kWarps);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Copy 16 bytes (VEC) or one float (else) from global to shared; with ok
// false nothing is read and the bytes are zero.
template <bool VEC>
__device__ __forceinline__ void copy(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? (VEC ? 16 : 4) : 0;
  if constexpr (VEC)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

// VEC: dh % 4 == 0 and every base 16-byte aligned, so rows are whole
// float4s; else one float at a time, the pad columns up to d4 zero.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
delta_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ key_mask,
                       const int* __restrict__ q_counts, int S, int H, int dh,
                       float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int d4 = row4(dh), kst = key_stride(dh);
  float* ks = reinterpret_cast<float*>(smem4);  // S x kst
  float* vs = ks + S * kst;                     // S x d4
  float* qs = vs + S * d4;                      // S x d4, rows below the count
  float* ps = qs + S * d4;                      // kWarps x S probabilities
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int cnt = min(max(q_counts[b], 0), S);
  const long long tok = (long long)H * dh;  // one token's stride
  const long long base = ((long long)b * S * H + h) * dh;

  if (cnt > 0) {
    const int per_row = VEC ? d4 / 4 : d4;
    for (int t = tid; t < S * per_row; t += kThreads) {
      const int j = t / per_row;
      const int c = VEC ? (t % per_row) * 4 : t % per_row;
      const bool ok = VEC || c < dh;
      const long long g = base + j * tok + c;
      copy<VEC>(ks + j * kst + c, ok ? k + g : k, ok);
      copy<VEC>(vs + j * d4 + c, ok ? v + g : v, ok);
      if (j < cnt) copy<VEC>(qs + j * d4 + c, ok ? q + g : q, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // rows at or past the count: exact zeros, while the copies land
  if (VEC) {
    const int per_row = dh / 4;
    for (int t = tid; t < (S - cnt) * per_row; t += kThreads) {
      const int r = cnt + t / per_row, c = (t % per_row) * 4;
      *reinterpret_cast<float4*>(out + base + r * tok + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int t = tid; t < (S - cnt) * dh; t += kThreads)
      out[base + (cnt + t / dh) * tok + t % dh] = 0.0f;
  }
  if (cnt == 0) return;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const float scale = sqrtf((float)dh);
  const uint8_t* valid = key_mask + (long long)b * S;
  float* pw = ps + warp * S;
  for (int r = warp; r < cnt; r += kWarps) {  // warp-uniform
    const float* qr = qs + r * d4;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const float* kr = ks + j * kst;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
      for (int c = 0; c < d4; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(qr + c);
        const float4 y = *reinterpret_cast<const float4*>(kr + c);
        a0 = fmaf(x.x, y.x, a0);
        a1 = fmaf(x.y, y.y, a1);
        a2 = fmaf(x.z, y.z, a2);
        a3 = fmaf(x.w, y.w, a3);
      }
      const float dot = __fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3));
      const float s = valid[j] ? __fdiv_rn(dot, scale) : kNegInf;
      pw[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(__fsub_rn(pw[j], m));
      pw[j] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    for (int j = lane; j < S; j += 32) pw[j] = __fdiv_rn(pw[j], sum);
    __syncwarp();
    float* orow = out + base + r * tok;
    for (int c0 = 0; c0 < dh; c0 += 64) {  // two output dims per lane at once
      const int c1 = c0 + lane, c2 = c1 + 32;
      float o1 = 0.0f, o2 = 0.0f;
#pragma unroll 4
      for (int j = 0; j < S; ++j) {
        const float p = pw[j];
        const float* vr = vs + j * d4;
        o1 = fmaf(p, vr[min(c1, d4 - 1)], o1);
        o2 = fmaf(p, vr[min(c2, d4 - 1)], o2);
      }
      if (c1 < dh) orow[c1] = o1;
      if (c2 < dh) orow[c2] = o2;
    }
    __syncwarp();  // pw is rewritten by this warp's next row
  }
}

}  // namespace

// q, k, v (B, S, H, dh) f32, key_mask (B, S) bool as bytes, q_counts (B,)
// i32 -> out (B, S, H, dh) f32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue when S x dh needs more shared memory than a block
// has.
extern "C" int delta_attention_launch(const float* q, const float* k,
                                      const float* v, const uint8_t* key_mask,
                                      const int* q_counts, int B, int S, int H,
                                      int dh, float* out, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(S, dh);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool vec = dh % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const dim3 grid(H, B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(delta_attention_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    delta_attention_kernel<true><<<grid, kThreads, smem, st>>>(
        q, k, v, key_mask, q_counts, S, H, dh, out);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(delta_attention_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    delta_attention_kernel<false><<<grid, kThreads, smem, st>>>(
        q, k, v, key_mask, q_counts, S, H, dh, out);
  }
  return (int)cudaGetLastError();
}
