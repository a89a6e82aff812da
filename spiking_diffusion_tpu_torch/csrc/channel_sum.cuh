// The fixed-order per-channel sums shared by K3 (bn_lif.cu: dscale, dshift)
// and K4 (spike_conv.cu: db), so the scheme that keeps them equal from run
// to run is written once.
//
// No atomics. A block of kBlock threads halves its kBlock values in a tree
// (128, 64, .., 1) into one partial per block and channel, and a second
// kernel adds the partials of a channel in block order, from 0. Each step
// is one fp32 addition, so the order, and the result, is the same on
// every run.

#pragma once

#include <cuda_runtime.h>

namespace chsum {

constexpr int kBlock = 256;

// Sums v[j] over the block's kBlock threads for each j, through the shared
// scratch `red`; every thread gets the sums back in v.
template <int kN>
__device__ __forceinline__ void block_tree_sum(float (&red)[kN][kBlock], float (&v)[kN]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) red[j][threadIdx.x] = v[j];
  __syncthreads();
  for (int half = kBlock / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        red[j][threadIdx.x] = red[j][threadIdx.x] + red[j][threadIdx.x + half];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) v[j] = red[j][0];
}

// One thread per channel adds its channel's partials (blocks, C) in block
// order; the second array may be null.
__global__ void sum_partials_kernel(const float* __restrict__ part_a,
                                    const float* __restrict__ part_b,
                                    float* __restrict__ a, float* __restrict__ b,
                                    long long blocks, long long C) {
  const long long c = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sa = 0.0f;
  float sb = 0.0f;
  for (long long k = 0; k < blocks; ++k) {
    sa = sa + part_a[k * C + c];
    if (part_b != nullptr) sb = sb + part_b[k * C + c];
  }
  a[c] = sa;
  if (b != nullptr) b[c] = sb;
}

// Launches sum_partials_kernel over C channels on `stream`.
inline void sum_partials(const float* part_a, const float* part_b, float* a, float* b,
                         long long blocks, long long C, cudaStream_t stream) {
  sum_partials_kernel<<<static_cast<unsigned int>((C + kBlock - 1) / kBlock), kBlock, 0,
                        stream>>>(part_a, part_b, a, b, blocks, C);
}

}  // namespace chsum
