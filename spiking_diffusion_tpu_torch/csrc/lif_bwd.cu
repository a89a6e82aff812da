// K1 backward: BPTT of the multi-step LIF over a flattened (T, M) input,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spiking_diffusion_tpu/ops/pallas_lif.py
// `_bwd_kernel` (launched by `_lif_fused_2d_bwd`). Inputs: x (T, M), the
// initial membrane v0 (M, or none: every membrane starts at v_reset) and
// the spike cotangent gs (T, M), all fp32; the cotangent of v_T is zero.
// Outputs: dX (T, M) and, when asked for, dV0 (M). For every neuron i < M:
//
//   pass 1 (recompute, not store): the forward of lif_fwd.cu again,
//     keeping the pre-reset membranes H[t];
//   pass 2, t = T-1 .. 0, with sg = surrogate'(H[t] - v_th):
//     gv = gv_carry + gh_next * (1 - decay)
//     hard reset: gh = gv * ((1 - s) + (v_reset - H[t]) * sg) + gs[t] * sg
//     soft reset: gh = gv * (1 + (-v_th) * sg) + gs[t] * sg
//     detach_reset drops the (.. - H[t]) * sg and (-v_th) * sg terms
//     dX[t] = gh * decay (decay_input) or gh
//   dV0 = gh_0 * (1 - decay)
//
// with the surrogate atan, (alpha/2) / (1 + u*u) at u = (pi/2 * alpha) * x,
// or sigmoid, alpha * s * (1 - s) at s = 1 / (1 + expf(-(alpha * x))).
// The step bodies are csrc/lif_neuron.cuh's `charge`, `reset` and
// `bptt_step`, shared with K3.
// Every operation is one fp32 operation in the order above, built with
// --fmad=false, so with atan the results are bitwise those of the plain
// PyTorch loop (ops/lif.py `lif_bwd_reference`); with sigmoid `expf` may
// differ from PyTorch's exp by an ulp.
//
// What bounds it on an H100: device-memory traffic. It reads x and gs once
// and writes dX once, 3T * M * 4 bytes, plus M * 4 for each of v0 and dV0
// when the caller passes them (the training path passes neither), against
// 3.35 TB/s; ~25 fp32 operations per element and step are far below the
// card's rate. So, as in the forward, one thread per neuron keeps its
// state in registers and the warps coalesce each time row. The TPU kernel
// keeps H in a VMEM scratch; here, for T <= 16 (the models' T), H[t] lives
// in 16 registers of the thread (lif::kRegSteps): the loops are unrolled so
// every index is a constant. For a longer T the wrapper passes a (T, M)
// scratch in device memory for H, at 2 * T * M * 4 more bytes.

#include <cuda_runtime.h>

#include "lif_neuron.cuh"

namespace {

constexpr int kThreads = 256;

// kRegT > 0: T <= kRegT and H[t] in registers; kRegT == 0: H in `hs`.
template <int kRegT>
__global__ void lif_bwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ v0,
                               const float* __restrict__ gs,
                               float* __restrict__ gx,
                               float* __restrict__ gv0,
                               float* __restrict__ hs,
                               long long T, long long M, lif::Neuron p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const long long steps = kRegT > 0 ? kRegT : T;
  float h_reg[kRegT > 0 ? kRegT : 1];
  float v = v0 != nullptr ? v0[i] : p.v_reset;
#pragma unroll
  for (long long t = 0; t < steps; ++t) {
    if (t < T) {
      const float h = lif::charge(v, x[t * M + i], p);
      if (kRegT > 0) {
        h_reg[t] = h;
      } else {
        hs[t * M + i] = h;
      }
      v = lif::reset(h, lif::fire(h, p), p);
    }
  }
  float gh_next = 0.0f;
  float gv_carry = 0.0f;  // the cotangent of v_T
#pragma unroll
  for (long long t = steps - 1; t >= 0; --t) {
    if (t < T) {
      const float h = kRegT > 0 ? h_reg[t] : hs[t * M + i];
      const float gv = gv_carry + gh_next * p.dh_dv;
      const float gh = lif::bptt_step(h, gv, gs[t * M + i], p);
      gx[t * M + i] = p.decay_input ? gh * p.decay : gh;
      gh_next = gh;
      gv_carry = 0.0f;
    }
  }
  if (gv0 != nullptr) gv0[i] = gh_next * p.dh_dv;
}

}  // namespace

// Launches on `stream` (a cudaStream_t); allocates nothing and does not
// synchronise. A null `v0` starts every membrane at v_reset without
// reading memory; a null `gv0` skips dV0. `hs` is a (T, M) fp32 scratch,
// read only when T > lif_register_steps() (may be null otherwise).
// `surrogate` is 0 (atan) or 1 (sigmoid). Returns cudaGetLastError()
// after the launch.
extern "C" int lif_bwd_f32(const float* x, const float* v0, const float* gs,
                           float* gx, float* gv0, float* hs, long long T,
                           long long M, float decay, float v_th, float v_reset,
                           float dh_dv, int decay_input, int hard_reset,
                           int detach_reset, int surrogate, float sg_a,
                           float sg_b, void* stream) {
  const lif::Neuron p{decay, v_th, v_reset, dh_dv, decay_input, hard_reset,
                      detach_reset, surrogate, sg_a, sg_b};
  const unsigned int blocks = static_cast<unsigned int>((M + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= lif::kRegSteps) {
    lif_bwd_kernel<lif::kRegSteps><<<blocks, kThreads, 0, s>>>(
        x, v0, gs, gx, gv0, hs, T, M, p);
  } else {
    lif_bwd_kernel<0><<<blocks, kThreads, 0, s>>>(x, v0, gs, gx, gv0, hs, T,
                                                  M, p);
  }
  return static_cast<int>(cudaGetLastError());
}
