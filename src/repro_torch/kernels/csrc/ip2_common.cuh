// Device routines shared by the IP2 projection kernels.
//
// The PWM quantiser, the fp32 projection tile and the analog/ADC epilogue
// live here once, so ip2_project.cu and ip2_fused_embed.cu run the same
// instructions in the same K order: the fused kernel then equals the staged
// ip2_project -> quant_matmul pair bit for bit, as the two Pallas kernels
// do in the JAX package (ip2_project.py:75,82 are the shared helpers there).
//
// Rounding: every product and sum in the epilogue is an explicit _rn
// intrinsic (never contracted into an FMA), the ADC step is a true IEEE
// division, and rintf rounds half to even like jnp.round. The files are
// built with --fmad=false on top of that; never with --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ip2 {

// readout modes of the projection epilogue
enum Readout { kCodes = 0, kDequant = 1, kNoADC = 2, kSign = 3 };

// Host-computed constants: each is a Python double rounded to float32 once
// (droop/n2 and the LSB are never recomputed on the device).
struct Epilogue {
  float pwm_n;      // pwm_levels - 1
  float pwm_inv_n;  // float32(1 / (pwm_levels - 1))
  float acc_scale;  // float32(droop / n2)
  float v_ref;
  int relu;         // 2T stage: clip to [0, v_sat]
  float v_sat;
  int mode;         // Readout
  float adc_vmin;
  float adc_vmax;
  float adc_lsb;    // float32((v_max - v_min) / (levels - 1))
  float adc_half;   // levels / 2
};

// pixel -> pulse width: round(clip(x, 0, 1) * n) * (1 / n)
__device__ __forceinline__ float pwm_quantize(float x, const Epilogue& e) {
  const float c = fminf(fmaxf(x, 0.0f), 1.0f);
  return __fmul_rn(rintf(__fmul_rn(c, e.pwm_n)), e.pwm_inv_n);
}

// charge share, droop and V_R: acc * (droop / n2) + v_ref, then the 2T clip
__device__ __forceinline__ float analog_out(float acc, const Epilogue& e) {
  float out = __fadd_rn(__fmul_rn(acc, e.acc_scale), e.v_ref);
  if (e.relu) out = fminf(fmaxf(out, 0.0f), e.v_sat);
  return out;
}

// centred ADC code on the float grid: round((clip(v) - v_min) / lsb) - half
__device__ __forceinline__ float adc_code(float out, const Epilogue& e) {
  const float c = fminf(fmaxf(out, e.adc_vmin), e.adc_vmax);
  return __fsub_rn(rintf(__fdiv_rn(__fsub_rn(c, e.adc_vmin), e.adc_lsb)),
                   e.adc_half);
}

// The full epilogue of one output. ``colv`` is the column's dequant zero
// (kDequant) or its bias (kNoADC); codes and sign ignore it.
__device__ __forceinline__ float readout(float acc, float colv, const Epilogue& e) {
  const float out = analog_out(acc, e);
  switch (e.mode) {
    case kSign: return out >= e.v_ref ? 1.0f : 0.0f;
    case kNoADC: return __fsub_rn(out, __fsub_rn(e.v_ref, colv));
    case kCodes: return adc_code(out, e);
    default: return __fadd_rn(__fmul_rn(adc_code(out, e), e.adc_lsb), colv);
  }
}

// Store one readout value: float32 for the dequant and no-ADC readouts; for
// codes and sign an integer of out_bytes (1, 2 or 4) bytes, as wide as the
// ADC's code dtype.
__device__ __forceinline__ void store_readout(void* out, int out_bytes,
                                              long long o, float v,
                                              const Epilogue& e) {
  if (e.mode != kCodes && e.mode != kSign)
    static_cast<float*>(out)[o] = v;
  else if (out_bytes == 1)
    static_cast<int8_t*>(out)[o] = (int8_t)__float2int_rn(v);
  else if (out_bytes == 2)
    static_cast<int16_t*>(out)[o] = (int16_t)__float2int_rn(v);
  else
    static_cast<int32_t*>(out)[o] = __float2int_rn(v);
}

// The byte widths the integer readouts may be stored in.
__host__ __forceinline__ bool out_bytes_ok(int out_bytes, const Epilogue& e) {
  const bool int_out = e.mode == kCodes || e.mode == kSign;
  return !int_out || out_bytes == 1 || out_bytes == 2 || out_bytes == 4;
}

// Block-cooperative fp32 projection tile on CUDA cores:
//   acc[i][j] = sum_k PWM(x[rows[r_i] + k]) * w[k * M + c0 + c_j]
// for BR rows x BM columns. ``rows`` (shared) holds each row's element
// offset into x, or -1 for a row that does not exist (it reads zeros).
// Every thread walks k = 0 .. K-1 in order with one fmaf per step, so the
// sum's rounding depends on K alone, not on the tiling or the caller.
// PWM quantisation happens as the x tile is loaded.
template <int BR, int BM, int BK, int TR, int TM>
__device__ __forceinline__ void project_tile(
    const float* __restrict__ x, const long long* rows,
    const float* __restrict__ w, int K, int M, int c0, const Epilogue& e,
    float* xs, float* ws, float (&acc)[TR][TM]) {
  constexpr int NT = (BR / TR) * (BM / TM);
  const int tid = threadIdx.x;
  const int tr = tid / (BM / TM), tc = tid % (BM / TM);
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int t = tid; t < BR * BK; t += NT) {
      const int r = t / BK, k = k0 + t % BK;
      const long long base = rows[r];
      xs[t] = (base >= 0 && k < K) ? pwm_quantize(x[base + k], e) : 0.0f;
    }
    for (int t = tid; t < BK * BM; t += NT) {
      const int k = k0 + t / BM, col = c0 + t % BM;
      ws[t] = (k < K && col < M) ? w[(long long)k * M + col] : 0.0f;
    }
    __syncthreads();
    const int kmax = min(BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[TR], b[TM];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = xs[(tr * TR + i) * BK + kk];
#pragma unroll
      for (int j = 0; j < TM; ++j) b[j] = ws[kk * BM + tc * TM + j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// int8 x int8 -> int32 for BR rows against one column c of w8 (K x N):
//   acc[r] += sum_m a_s[r * Kp + m] * w8[m * N + c]
// a_s is shared, row stride Kp (a multiple of 4, zero past K). Four k at a
// time go through __dp4a; integer sums are exact in any order.
template <int BR>
__device__ __forceinline__ void int8_rows_dot_col(
    const int8_t* a_s, int Kp, const int8_t* __restrict__ w8, int K, int N,
    int c, int (&acc)[BR]) {
  for (int m = 0; m < K; m += 4) {
    int packed = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mm = m + q;
      const int v = mm < K ? (int)(uint8_t)w8[(long long)mm * N + c] : 0;
      packed |= v << (8 * q);
    }
#pragma unroll
    for (int r = 0; r < BR; ++r)
      acc[r] = __dp4a(*reinterpret_cast<const int*>(a_s + r * Kp + m), packed,
                      acc[r]);
  }
}

// w8a8 epilogue in the reference's order: (float(acc) * s_a) * s_w
__device__ __forceinline__ float qmm_epilogue(int acc, float s_a, float s_w) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_a), s_w);
}

// projection tiling shared by both projection kernels
constexpr int kBR = 16, kBM = 64, kBK = 32, kTR = 2, kTM = 4;
constexpr int kThreads = (kBR / kTR) * (kBM / kTM);  // 128

}  // namespace ip2
