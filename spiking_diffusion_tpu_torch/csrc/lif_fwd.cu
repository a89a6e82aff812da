// K1 forward: multi-step LIF over a flattened (T, M) input, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel spiking_diffusion_tpu/ops/pallas_lif.py
// `_fwd_kernel` (launched by `lif_fused`). For every neuron i < M and every
// step t < T it charges, fires and resets:
//
//   decay_input: h = v + (x[t, i] - (v - v_reset)) * decay
//   otherwise:   h = v - (v - v_reset) * decay + x[t, i]
//   s[t, i] = h >= v_th
//   hard reset:  v = (1 - s) * h + s * v_reset
//   soft reset:  v = h - s * v_th
//
// and writes the last membrane to vT[i]. Every operation is one fp32
// operation in the order above; built with --fmad=false, so no multiply-add
// is contracted and the spikes and v_T are bitwise those of the plain
// PyTorch loop (ops/lif.py `lif_fwd_reference`).
//
// The per-element math is csrc/lif_neuron.cuh's `charge`, `fire`, `reset`.
//
// What bounds it on an H100: device-memory traffic. It reads x once and
// writes s and vT once, (2T + 1) * M * 4 bytes (one more M * 4 to read v0
// when the caller gives an initial membrane), against 3.35 TB/s;
// the arithmetic is ~6 fp32 operations per element and step, far below the
// card's rate. So the design keeps memory traffic at that minimum: one
// thread per neuron holds its membrane in a register across the whole T
// loop (nothing but x and s touches device memory inside the loop), and
// at each step the threads of a warp load and store 32 neighbouring floats
// of row t (stride M between steps), so every access is coalesced. The
// TPU kernel's (R, 128) lane tiling and padding have no counterpart here:
// the last block masks the ragged edge itself.

#include <cuda_runtime.h>

#include "lif_neuron.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void lif_fwd_kernel(const float* __restrict__ x,
                               const float* __restrict__ v0,
                               float* __restrict__ s,
                               float* __restrict__ vT, long long T,
                               long long M, lif::Neuron p) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float v = v0 != nullptr ? v0[i] : p.v_reset;
  for (long long t = 0; t < T; ++t) {
    const float h = lif::charge(v, x[t * M + i], p);
    const float spike = lif::fire(h, p);
    s[t * M + i] = spike;
    v = lif::reset(h, spike, p);
  }
  vT[i] = v;
}

}  // namespace

// Launches on `stream` (a cudaStream_t); allocates nothing and does not
// synchronise. A null `v0` starts every membrane at v_reset without
// reading memory. Returns cudaGetLastError() after the launch.
extern "C" int lif_fwd_f32(const float* x, const float* v0, float* s, float* vT,
                           long long T, long long M, float decay, float v_th,
                           float v_reset, int decay_input, int hard_reset,
                           void* stream) {
  const lif::Neuron p{decay, v_th, v_reset, 1.0f - decay, decay_input,
                      hard_reset, 0, 0, 0.0f, 0.0f};
  const long long blocks = (M + kThreads - 1) / kThreads;
  lif_fwd_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, v0, s, vT, T, M, p);
  return static_cast<int>(cudaGetLastError());
}
