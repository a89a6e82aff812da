// The LIF neuron's per-element math, shared by K1 (lif_fwd.cu, lif_bwd.cu)
// and K3 (bn_lif.cu), so each formula is written once.
//
// Every function is a fixed sequence of fp32 operations in the order of the
// JAX kernels (spiking_diffusion_tpu/ops/pallas_lif.py `_fwd_kernel`,
// `_bwd_kernel`) and of the plain PyTorch versions (ops/lif.py `charge`,
// `reset`, `bptt_step`); the sources are built with --fmad=false, so no
// multiply-add is contracted and the kernels are bitwise their plain
// versions (sigmoid's `expf` aside).

#pragma once

#include <cuda_runtime.h>

namespace lif {

// The backward kernels keep H[t] in registers up to this many steps;
// beyond it the caller passes a (T, M) fp32 scratch in device memory.
constexpr int kRegSteps = 16;

struct Neuron {
  float decay, v_th, v_reset, dh_dv;  // dh_dv = 1 - decay
  int decay_input, hard_reset, detach_reset, surrogate;  // 0 atan, 1 sigmoid
  float sg_a, sg_b;  // atan: pi/2 * alpha, alpha/2; sigmoid: alpha, unused
};

// The pre-reset membrane after input x.
__device__ __forceinline__ float charge(float v, float x, const Neuron& p) {
  if (p.decay_input) return v + (x - (v - p.v_reset)) * p.decay;
  return v - (v - p.v_reset) * p.decay + x;
}

__device__ __forceinline__ float fire(float h, const Neuron& p) {
  return h >= p.v_th ? 1.0f : 0.0f;
}

__device__ __forceinline__ float reset(float h, float spike, const Neuron& p) {
  if (p.hard_reset) return (1.0f - spike) * h + spike * p.v_reset;
  return h - spike * p.v_th;
}

__device__ __forceinline__ float surrogate_grad(float x, const Neuron& p) {
  if (p.surrogate == 0) {
    const float u = p.sg_a * x;
    return p.sg_b / (1.0f + u * u);
  }
  const float s = 1.0f / (1.0f + expf(-(p.sg_a * x)));
  return p.sg_a * s * (1.0f - s);
}

// One reverse-time step of BPTT: the cotangent dL/dH[t] from H[t], the
// membrane cotangent gv flowing in from step t + 1 and the spike
// cotangent g_s of step t.
//   hard reset: gh = gv * ((1 - s) + (v_reset - h) * sg) + g_s * sg
//   soft reset: gh = gv * (1 + (-v_th) * sg) + g_s * sg
// detach_reset drops the (v_reset - h) * sg and (-v_th) * sg terms.
__device__ __forceinline__ float bptt_step(float h, float gv, float g_s,
                                           const Neuron& p) {
  const float spike = fire(h, p);
  const float sg = surrogate_grad(h - p.v_th, p);
  float dv_dh, reset_term;
  if (p.hard_reset) {
    dv_dh = 1.0f - spike;
    reset_term = (p.v_reset - h) * sg;
  } else {
    dv_dh = 1.0f;
    reset_term = -p.v_th * sg;
  }
  if (p.detach_reset) return gv * dv_dh + g_s * sg;
  return gv * (dv_dh + reset_term) + g_s * sg;
}

}  // namespace lif

// How many steps the backward kernels keep in registers, for the wrapper
// that decides whether to pass the scratch.
extern "C" int lif_register_steps() { return lif::kRegSteps; }
