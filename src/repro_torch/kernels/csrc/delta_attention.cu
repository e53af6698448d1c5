// delta_attention: ragged stale-prefix attention of the delta-gated backend.
//
// Replaces the Pallas TPU kernel delta_attention_pallas (src/repro/kernels/
// vit_delta_attention.py:130, body _delta_attn_kernel :79). For slot b,
// head h and query row r < q_counts[b]:
//   s_j   = (q[b, r, h, :] . k[b, j, h, :]) / sqrt(dh),  -1e30 where key j is invalid
//   out[b, r, h, :] = sum_j softmax(s)_j * v[b, j, h, :]
// and rows at or past the count are exact zeros.
//
// What bounds it here: on the serving path (64 slots, 16 tokens, 4 heads,
// dh 64) one call is ~2 MFLOP on ~1 MB, a bound well under a microsecond:
// the launch's latency dominates. Design: one 128-thread block per (query
// bank of 8 rows, head, slot). A bank wholly past its slot's count loads
// nothing and stores zeros. Otherwise the block stages the slot's keys,
// values and key mask for its head (S x dh f32 each) and its query rows in
// shared memory, computes the 8 x S scores (each a dot product in dh order),
// divides by sqrtf(dh) with an IEEE divide, masks, runs a max-subtracted
// softmax with expf per row (no fast math) and mixes the values.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 8, kThreads = 128;
constexpr float kNegInf = -1e30f;  // the reference's masking constant

__global__ void __launch_bounds__(kThreads)
delta_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const uint8_t* __restrict__ key_mask,
                       const int* __restrict__ q_counts, int S, int H, int dh,
                       float* __restrict__ out) {
  extern __shared__ float smem[];
  float* ks = smem;              // S x dh
  float* vs = ks + S * dh;       // S x dh
  float* qs = vs + S * dh;       // kBQ x dh
  float* ps = qs + kBQ * dh;     // kBQ x S scores, then probabilities
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int cnt = min(max(q_counts[b], 0), S);
  const long long tok = (long long)H * dh;           // one token's stride
  const long long base = (long long)b * S * tok + (long long)h * dh;
  if (q0 >= cnt) {
    for (int t = tid; t < kBQ * dh; t += kThreads) {
      const int r = q0 + t / dh;
      if (r < S) out[base + r * tok + t % dh] = 0.0f;
    }
    return;
  }
  for (int t = tid; t < S * dh; t += kThreads) {
    const long long g = base + (t / dh) * tok + t % dh;
    ks[t] = k[g];
    vs[t] = v[g];
  }
  for (int t = tid; t < kBQ * dh; t += kThreads) {
    const int r = q0 + t / dh;
    qs[t] = r < cnt ? q[base + r * tok + t % dh] : 0.0f;
  }
  __syncthreads();
  const float scale = sqrtf((float)dh);
  for (int t = tid; t < kBQ * S; t += kThreads) {
    const int r = t / S, j = t % S;
    float acc = 0.0f;
    for (int c = 0; c < dh; ++c) acc = fmaf(qs[r * dh + c], ks[j * dh + c], acc);
    ps[t] = key_mask[(long long)b * S + j] ? __fdiv_rn(acc, scale) : kNegInf;
  }
  __syncthreads();
  if (tid < kBQ) {
    float* row = ps + tid * S;
    float m = row[0];
    for (int j = 1; j < S; ++j) m = fmaxf(m, row[j]);
    float sum = 0.0f;
    for (int j = 0; j < S; ++j) {
      row[j] = expf(__fsub_rn(row[j], m));
      sum = __fadd_rn(sum, row[j]);
    }
    for (int j = 0; j < S; ++j) row[j] = __fdiv_rn(row[j], sum);
  }
  __syncthreads();
  for (int t = tid; t < kBQ * dh; t += kThreads) {
    const int r = t / dh, c = t % dh, p = q0 + r;
    if (p >= S) continue;
    float acc = 0.0f;
    if (p < cnt)
      for (int j = 0; j < S; ++j) acc = fmaf(ps[r * S + j], vs[j * dh + c], acc);
    out[base + p * tok + c] = acc;
  }
}

}  // namespace

// q, k, v (B, S, H, dh) f32, key_mask (B, S) bool as bytes, q_counts (B,)
// i32 -> out (B, S, H, dh) f32. Returns cudaGetLastError().
extern "C" int delta_attention_launch(const float* q, const float* k,
                                      const float* v, const uint8_t* key_mask,
                                      const int* q_counts, int B, int S, int H,
                                      int dh, float* out, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * S * dh + kBQ * dh + kBQ * S);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (B > 0 && S > 0 && H > 0 && dh > 0) {
    dim3 grid((S + kBQ - 1) / kBQ, H, B);
    delta_attention_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        q, k, v, key_mask, q_counts, S, H, dh, out);
  }
  return (int)cudaGetLastError();
}
