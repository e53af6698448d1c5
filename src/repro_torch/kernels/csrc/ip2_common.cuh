// Device routines shared by the IP2 projection and embed kernels.
//
// The PWM quantiser, the analog/ADC epilogue, the readout store and the
// w8a8 epilogue live here once. Every projection kernel sums each output as
// the same fmaf chain (ip2_tile.cuh) and ends in the same epilogue, so
// ip2_fused_embed equals the staged ip2_project -> quant_matmul pair bit for
// bit, as the two Pallas kernels do in the JAX package (ip2_project.py:75,82
// are the shared helpers there).
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

// w8a8 epilogue in the reference's order: (float(acc) * s_a) * s_w
__device__ __forceinline__ float qmm_epilogue(int acc, float s_a, float s_w) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_a), s_w);
}

}  // namespace ip2
