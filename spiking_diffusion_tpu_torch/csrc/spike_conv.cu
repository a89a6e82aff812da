// K4: the 3x3 SAME stride-1 training convolution, forward (with the
// per-channel BatchNorm moments of its output) and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels spiking_diffusion_tpu/ops/spike_conv.py
// `_fwd_kernel` and `_bwd_kernel` (launched by `_spike_conv_4d` and its
// VJP). The layout at the interface is PyTorch's: x is (N, Cin, H, W) with
// the time axis folded into N, y is (N, Cout, H, W). Every product is
// summed in fp32.
//
// Forward, an implicit GEMM over rows m = (n, h, w), M = N * H * W:
//   y[m, co] = T( sum_k A[m, k] * B[k, co] + bias[co] )
//   A[m, k] = x[n, ci, h + kh - 1, w + kw - 1] for the tap (kh, kw) and
//   channel ci of column k, 0 off the edge (the edge test uses (h, w) only,
//   so a row never reads another sample's pixels);
//   s1[co] = sum over m of float(y[m, co]), s2[co] = sum of float(y)^2,
//   of the ROUNDED y, as the TPU kernel takes them.
// Backward, from (gy, gs1, gs2), the cotangents of (y, s1, s2):
//   g = float(gy) + (gs1[co] + 2 * gs2[co] * float(y))   (y re-read)
//   db[co] = sum over m of g (fp32);  g is then rounded to T, as the TPU
//   kernel rounds it before its products;
//   dW[co, k] = sum over m of g[m, co] * A[m, k]         (fp32)
//   dx = the same implicit GEMM as the forward on g, with the weight
//   flipped and transposed (the tap 8 - t of W[co, ci] at tap t), in T;
//   skipped when the caller passes no dx.
//
// What bounds it on an H100: operations. A training step of the full-width
// denoiser at batch 256 runs 1.24 TFLOP through the forward and 2.49 through
// the backward (1.02 and 2.03 inside the 7x7 grid), against ~2 GB of
// activations. bf16 and the fp32 forward run on the tensor cores; the fp32
// backward, and the fp32 forward of an x that bf16 cannot hold, on the CUDA
// cores.
//
// The tensor-core route. The operands are channels-last and padded: x (and
// g for dx and dW) is copied (written, for g) as bf16 (M, Cp) with Cp = C
// rounded up to a multiple of 8, the padding zero, so that every operand
// row piece is one aligned 16-byte `cp.async`; column k = tap * Cp + ci with
// tap = kh * 3 + kw, so for one row and one tap a run of 8 channels is
// contiguous and an off-grid tap or a row past M is one zero-filled copy.
// Forward, dx and dW share one inner loop: a 128 x 128 block tile
// contracted in 64-deep stages through a 3-stage `cp.async` ring, 8 warps
// of 64 x 32, fragments from `ldmatrix` (`.trans` for an operand stored
// contraction-major), `mma.sync.m16n8k16` bf16 -> fp32. Forward and dx take
// A = the im2col rows of the channels-last x (or g), B = the (9 * Cp_in,
// Cp_out) weight matrix (or the (9 * Cp_out, Cp_in) flipped one); dW takes
// A = g^T and B = the im2col of x over one split of the rows, and gives
// (Cout, 9 * Cp_in). The bound is the tensor cores' rate and how well a
// warp-level `mma.sync` feeds them; Hopper's `wgmma` would lift that
// ceiling.
//
// fp32 forward (T = float), two routes, chosen on the device per call. On
// the model's path every x is exact in bf16: spikes (0, 1), token ids (<=
// mask_id, 128) and timesteps (<= 49). That holds while mask_id and the
// number of timesteps are at most 256, since every integer up to 256 is
// exact in bf16; a larger codebook sends block 0 to the CUDA-core route,
// still correct. And any fp32 weight W is the exact sum of
// three bf16 planes, W0 = bf16(W), W1 = bf16(W - W0), W2 = bf16(W - W0 -
// W1), each holding 8 of fp32's 24 significant bits (for |W| >= 2^-110;
// below, the sum is within 2^-134, half bf16's least subnormal). A bf16 x
// bf16 product is exact in fp32, so y = sum x W2 + sum x W1 + sum x W0 has
// exact products summed in fp32: the CUDA cores' arithmetic in another
// order, at three bf16 products per product.
//  - The pack copies the fp32 x to the bf16 channels-last scratch and sets
//    a device flag (atomicOr) if any element changed when rounded.
//  - Exact x: the tensor-core loop above over K' = 3 * 9 * Cp_in, B the
//    three planes stacked as (3 * 9 * Cp_in, Cp_out), smallest first (W2,
//    W1, W0) so that the small terms are summed before the large ones; A's
//    loader reads column k' at k' mod (9 * Cp_in), which needs no extra
//    copy of x (9 * Cp is a multiple of 8, so no 16-byte piece straddles
//    two planes). Three B fragments against each A fragment would read A
//    once instead of three times, but triple B's share of the ring; the
//    longer contraction keeps the loop, its ring and its occupancy as they
//    are. The whole K'-deep sum stays in the mma's fp32 accumulators: y
//    meets the plain version's 1e-5 at the path's shapes and the card
//    tests' without promoting partial sums through CUDA-core adds. y is
//    stored in fp32. One kernel (split_weight_kernel) writes both routes'
//    weight matrices per call. Bounded, like bf16, by the tensor cores, at
//    three products per useful one.
//  - Other x (an element off bf16's grid, or not finite: inf times a zero
//    plane would give NaN), and any call of 2^31 rows or more (the
//    tensor-core loop's index is 32-bit; no pack then): the CUDA cores,
//    column k = ci * 9 + kh * 3 + kw, x and the (Cin * 9, Cout) weight
//    matrix read as they lie (NCHW). A classic
//    register-blocked SGEMM: a block computes a 128 x 128 output tile with
//    256 threads, 8 x 8 outputs each, from double-buffered 8-deep tiles of
//    A and B in shared memory, A gathered from NCHW as the tile is loaded.
//    Bounded by the CUDA cores' 67 TFLOP/s. It is also the fp32 backward's
//    dx.
//  Both kernels are launched after the pack; each reads the flag first and
//  the one not chosen returns at once, so the choice needs no host
//  synchronisation. Both write the moments' partials in one (row tiles,
//  Cout) layout for one second stage, and count the calls they take in a
//  device tally (tensor cores, CUDA cores).
//
// Fixed orders, no atomics in any sum (the route's flag and tally are
// the only atomics): the moments and db are summed per thread over its
// rows, then in a fixed shuffle tree (forward) or shared-memory tree (db),
// into per-block partials, and a second kernel adds the partials of a
// channel in a fixed order (the moments: a warp per channel; db: block
// order, csrc/channel_sum.cuh, shared with K3); dW is contracted over a
// fixed split of the rows, one partial per split, which a last kernel adds
// in split order. So s1, s2, db and dW are equal from run to run. The
// plain PyTorch versions (ops/spike_conv.py) sum in other orders; the
// tolerances are stated there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "channel_sum.cuh"

namespace {

constexpr int kBM = 128;      // output tile rows
constexpr int kBN = 128;      // output tile columns
constexpr int kBK = 8;        // contraction depth of one shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPad = 4;       // row padding of the wgrad tiles (bank spread)
constexpr int kRedThreads = chsum::kBlock;

// The CUDA-core kernels below are instantiated for fp32 only; bf16 takes
// the tensor-core route (namespace tc).
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// One element of the implicit im2col matrix: x[img, ci, h + dh, w + dw] for
// column k = ci * 9 + (dh + 1) * 3 + (dw + 1), 0 off the edge.
template <typename T>
__device__ __forceinline__ float im2col(const T* __restrict__ x_img, int k, int h,
                                        int w, int H, int W) {
  const int ci = k / 9;
  const int tap = k - ci * 9;
  const int kh = tap / 3;
  const int hh = h + kh - 1;
  const int ww = w + (tap - kh * 3) - 1;
  if (hh < 0 || hh >= H || ww < 0 || ww >= W) return 0.0f;
  return to_f32(x_img[static_cast<long long>(ci) * H * W + hh * W + ww]);
}

// The 8 x 8 register tile's update from one shared-memory stage. Thread
// (tx, ty) owns rows tx * 4 + {0..3} and 64 + tx * 4 + {0..3} and the same
// pattern of columns from ty.
template <int kLdA, int kLdB>
__device__ __forceinline__ void multiply_stage(const float* __restrict__ As,
                                               const float* __restrict__ Bs,
                                               int tx, int ty, float acc[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kLdA + tx * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kLdA + 64 + tx * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kLdB + ty * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * kLdB + 64 + ty * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ int tile_offset(int i, int t4) {
  return (i < 4 ? 0 : 64) + t4 * 4 + (i & 3);
}

// y = conv3x3(x, B) (+ bias), rows m = (img, h, w), columns co; with
// `part_s1` non-null also the per-block moments partials (gridDim.x, cout).
// With `inexact` non-null (the fp32 forward's route for an x that bf16
// cannot hold) the blocks return at once unless the flag is set; with
// `tally` non-null block 0 counts the call in tally[1].
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const T* __restrict__ wk,
            const float* __restrict__ bias, T* __restrict__ y,
            float* __restrict__ part_s1, float* __restrict__ part_s2,
            const int* __restrict__ inexact, int* __restrict__ tally,
            long long n_img, int cin, int cout, int H, int W) {
  __shared__ __align__(16) float As[2][kBK * kBM];
  __shared__ __align__(16) float Bs[2][kBK * kBN];
  const int tid = threadIdx.x;
  if (inexact != nullptr && *inexact == 0) return;
  if (tally != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    atomicAdd(&tally[1], 1);
  }
  const int HW = H * W;
  const long long M = n_img * HW;
  const int K = cin * 9;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // Loader: each thread fills one row of A and one column of B, at depths
  // kl, kl + 2, kl + 4, kl + 6 of each stage.
  const int lrow = tid % kBM;
  const int kl = tid / kBM;
  const long long am = m0 + lrow;
  const bool a_ok = am < M;
  const long long a_img = a_ok ? am / HW : 0;
  const int a_p = a_ok ? static_cast<int>(am - a_img * HW) : 0;
  const int a_h = a_ok ? a_p / W : 0;
  const int a_w = a_ok ? a_p - a_h * W : 0;
  const T* x_img = x + a_img * cin * HW;
  const int bcol = n0 + lrow;
  const bool b_ok = bcol < cout;

  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + kl + 2 * i;
      ra[i] = (a_ok && k < K) ? im2col(x_img, k, a_h, a_w, H, W) : 0.0f;
      rb[i] = (b_ok && k < K) ? to_f32(wk[static_cast<long long>(k) * cout + bcol]) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[buf][(kl + 2 * i) * kBM + lrow] = ra[i];
      Bs[buf][(kl + 2 * i) * kBN + lrow] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int stages = (K + kBK - 1) / kBK;
  load(0);
  stash(0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) load((s + 1) * kBK);
    multiply_stage<kBM, kBN>(As[buf], Bs[buf], tx, ty, acc);
    if (s + 1 < stages) stash(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: bias, rounding to T, NCHW store, moments of the rounded y.
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + tile_offset(i, tx);
    if (m >= M) continue;
    const long long img = m / HW;
    const int p = static_cast<int>(m - img * HW);
    T* y_px = y + img * cout * HW + p;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = n0 + tile_offset(j, ty);
      if (co >= cout) continue;
      const float v = bias != nullptr ? acc[i][j] + bias[co] : acc[i][j];
      const T r = from_f32<T>(v);
      y_px[static_cast<long long>(co) * HW] = r;
      const float f = to_f32(r);
      s1[j] = s1[j] + f;
      s2[j] = s2[j] + f * f;
    }
  }
  if (part_s1 == nullptr) return;
  // The 16 threads of a half-warp share their columns: a fixed xor tree.
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      s1[j] = s1[j] + __shfl_xor_sync(0xffffffffu, s1[j], off);
      s2[j] = s2[j] + __shfl_xor_sync(0xffffffffu, s2[j], off);
    }
  }
  if (tx != 0) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = n0 + tile_offset(j, ty);
    if (co < cout) {
      part_s1[static_cast<long long>(blockIdx.x) * cout + co] = s1[j];
      part_s2[static_cast<long long>(blockIdx.x) * cout + co] = s2[j];
    }
  }
}

// g = gy (+ gs1 + 2 gs2 y) in fp32, stored rounded to T; per-block db
// partials (gridDim.x, C) of the unrounded g. A block takes 256 consecutive
// (img, p) of one channel (blockIdx.y), as K3's backward does.
template <typename T>
__global__ void grad_out_kernel(const T* __restrict__ gy, const T* __restrict__ y,
                                const float* __restrict__ gs1,
                                const float* __restrict__ gs2, T* __restrict__ g,
                                float* __restrict__ part_db, long long n_img,
                                int C, int HW, int with_moments) {
  __shared__ float red[1][kRedThreads];
  const long long e = static_cast<long long>(blockIdx.x) * kRedThreads + threadIdx.x;
  const int c = blockIdx.y;
  float gf = 0.0f;
  if (e < n_img * HW) {
    const long long img = e / HW;
    const long long i = (img * C + c) * HW + (e - img * HW);
    gf = to_f32(gy[i]);
    if (with_moments) gf = gf + (gs1[c] + 2.0f * gs2[c] * to_f32(y[i]));
    g[i] = from_f32<T>(gf);
  }
  float acc[1] = {gf};
  chsum::block_tree_sum<1>(red, acc);
  if (threadIdx.x == 0) part_db[static_cast<long long>(blockIdx.x) * C + c] = acc[0];
}

// dW partial of one row split: part[split, co, k] = sum over the split's
// rows m of g[m, co] * A[m, k]. Tile rows co, columns k, contraction m.
template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const T* __restrict__ g, const T* __restrict__ x,
             float* __restrict__ part, long long n_img, int cin, int cout, int H,
             int W, long long rows_per_split) {
  constexpr int kLd = kBM + kPad;
  __shared__ __align__(16) float As[2][kBK * kLd];
  __shared__ __align__(16) float Bs[2][kBK * kLd];
  const int tid = threadIdx.x;
  const int HW = H * W;
  const long long M = n_img * HW;
  const int K = cin * 9;
  const int k0 = blockIdx.x * kBN;
  const int co0 = blockIdx.y * kBM;
  const long long r0 = static_cast<long long>(blockIdx.z) * rows_per_split;
  const long long r1 = r0 + rows_per_split < M ? r0 + rows_per_split : M;

  // Loader: each thread takes one row m of the stage (tid % 8) and four
  // channels of g and four columns of A (tid / 8 + 32 i): runs of 8
  // consecutive pixels per channel.
  const int lm = tid % kBK;
  const int lc = tid / kBK;
  float ra[4], rb[4];
  auto load = [&](long long mb) {
    const long long m = mb + lm;
    const bool ok = m < r1;
    const long long img = ok ? m / HW : 0;
    const int p = ok ? static_cast<int>(m - img * HW) : 0;
    const int h = ok ? p / W : 0;
    const int w = ok ? p - h * W : 0;
    const T* g_px = g + img * cout * HW + p;
    const T* x_img = x + img * cin * HW;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = co0 + lc + 32 * i;
      const int k = k0 + lc + 32 * i;
      ra[i] = (ok && co < cout) ? to_f32(g_px[static_cast<long long>(co) * HW]) : 0.0f;
      rb[i] = (ok && k < K) ? im2col(x_img, k, h, w, H, W) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[buf][lm * kLd + lc + 32 * i] = ra[i];
      Bs[buf][lm * kLd + lc + 32 * i] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long stages = r1 > r0 ? (r1 - r0 + kBK - 1) / kBK : 0;
  if (stages > 0) {
    load(r0);
    stash(0);
  }
  __syncthreads();
  for (long long s = 0; s < stages; ++s) {
    const int buf = static_cast<int>(s & 1);
    if (s + 1 < stages) load(r0 + (s + 1) * kBK);
    multiply_stage<kLd, kLd>(As[buf], Bs[buf], tx, ty, acc);
    if (s + 1 < stages) stash(buf ^ 1);
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.z) * cout * K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int co = co0 + tile_offset(i, tx);
    if (co >= cout) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + tile_offset(j, ty);
      if (k < K) out[static_cast<long long>(co) * K + k] = acc[i][j];
    }
  }
}

// dW[e] = sum over splits, in split order, of part[split, e].
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, long long n,
                                  int splits) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int k = 0; k < splits; ++k) s = s + part[k * n + e];
  dw[e] = s;
}

inline unsigned int cdiv(long long a, long long b) {
  return static_cast<unsigned int>((a + b - 1) / b);
}

// conv_kernel over the whole of y; the moments' partials (row tiles of kBM,
// cout), when asked for, are the caller's to sum.
template <typename T>
int launch_conv(const void* x, const void* wk, const float* bias, void* y,
                float* part_s1, float* part_s2, const int* inexact, int* tally,
                long long n_img, int cin, int cout, int H, int W, cudaStream_t st) {
  const long long M = n_img * H * W;
  const dim3 grid(cdiv(M, kBM), cdiv(cout, kBN));
  conv_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk), bias,
      static_cast<T*>(y), part_s1, part_s2, inexact, tally, n_img, cin, cout, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* w2, const void* y, const void* gy,
               const float* gs1, const float* gs2, void* g, float* part_db,
               float* db, void* dx, float* part_dw, float* dw, long long n_img,
               int cin, int cout, int H, int W, int splits,
               long long rows_per_split, int with_moments, cudaStream_t st) {
  const int HW = H * W;
  const dim3 ggrid(cdiv(n_img * HW, kRedThreads), cout);
  grad_out_kernel<T><<<ggrid, kRedThreads, 0, st>>>(
      static_cast<const T*>(gy), static_cast<const T*>(y), gs1, gs2,
      static_cast<T*>(g), part_db, n_img, cout, HW, with_moments);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  chsum::sum_partials(part_db, nullptr, db, nullptr, ggrid.x, cout, st);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int K = cin * 9;
  const dim3 wgrid(cdiv(K, kBN), cdiv(cout, kBM), splits);
  wgrad_kernel<T><<<wgrid, kThreads, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), part_dw, n_img, cin,
      cout, H, W, rows_per_split);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long n = static_cast<long long>(cout) * K;
  sum_splits_kernel<<<cdiv(n, kRedThreads), kRedThreads, 0, st>>>(part_dw, dw, n,
                                                                  splits);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || dx == nullptr) return rc;
  // dx: the forward GEMM on g, Cout channels in, Cin out, no bias or moments
  return launch_conv<T>(g, w2, nullptr, dx, nullptr, nullptr, nullptr, nullptr,
                        n_img, cout, cin, H, W, st);
}


// --- tensor cores: bf16, and the fp32 forward of an x exact in bf16 --------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // block tile rows (GEMM M)
constexpr int kBN = 128;        // block tile columns (GEMM N)
constexpr int kBK = 64;         // contraction depth of one stage
constexpr int kStages = 3;      // cp.async ring: two stages in flight
constexpr int kThreads = 256;   // 8 warps, 2 (rows) x 4 (columns), 64 x 32 each
constexpr int kAlign = 8;       // channels padded to whole 16-byte copies
constexpr int kLdRow = kBK + 8; // [row][k] tile: 144 B a row, ldmatrix conflict-free
constexpr int kLdK = kBN + 8;   // [k][column] tile: 272 B a row, the same
constexpr int kTileRows = kBM * kLdRow;  // elements of a [row][k] tile
constexpr int kTileK = kBK * kLdK;       // elements of a [k][column] tile
// Loaders: a thread copies 8 consecutive elements (16 bytes) of a row per
// copy. A [row][k] tile takes kRowPasses passes of kThreads / (kBK / 8) rows,
// a [k][column] tile kKPasses passes of kThreads / (kBN / 8) rows.
constexpr int kRowChunks = kBK / 8;
constexpr int kRowPasses = kBM * kRowChunks / kThreads;
constexpr int kKChunks = kBN / 8;
constexpr int kKPasses = kBK * kKChunks / kThreads;
// bf16 planes of the weight: an fp32 weight is three (the fp32 forward)
template <typename Out>
constexpr int kPlanes = 1;
template <>
constexpr int kPlanes<float> = 3;

__host__ __device__ constexpr int padded(int c) { return (c + kAlign - 1) / kAlign * kAlign; }

// Elements of one ring stage: A ([row][k], or [k][row] with kATrans), then B.
__host__ __device__ constexpr int stage_elems(bool a_trans) {
  return (a_trans ? kTileK : kTileRows) + kTileK;
}
constexpr int smem_bytes(bool a_trans) {
  return kStages * stage_elems(a_trans) * static_cast<int>(sizeof(bf16));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled, nothing read, if !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8q..8q+7 give the row addresses of matrix q.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The inner loop every pass shares: one kBK-deep stage of the warp's 64 x 32
// tile, acc[i][j] the m16n8 fragment at rows wm * 64 + 16 i, columns wn * 32 +
// 8 j. A is [row][k] (kLdRow) or, with kATrans, [k][row] (kLdK), read with
// ldmatrix.trans; B is [k][column] (kLdK), always read with ldmatrix.trans.
template <bool kATrans>
__device__ __forceinline__ void mma_stage(const bf16* As, const bf16* Bs, int wm, int wn,
                                          int lane, float (&acc)[4][4][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    unsigned a[4][4];
    unsigned b[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wm * 64 + i * 16;
      if (kATrans) {
        // matrices (rows, k): (0-7, 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        ldmatrix_x4_trans(a[i], As + (kk + (lane & 7) + ((lane >> 4) << 3)) * kLdK + row +
                                    ((lane >> 3) & 1) * 8);
      } else {
        ldmatrix_x4(a[i], As + (row + (lane & 15)) * kLdRow + kk + ((lane >> 4) << 3));
      }
    }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      // matrices (k, columns): (0-7, 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
      unsigned r[4];
      ldmatrix_x4_trans(r, Bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdK + wn * 32 +
                               jp * 16 + ((lane >> 4) << 3));
      b[2 * jp][0] = r[0];
      b[2 * jp][1] = r[1];
      b[2 * jp + 1][0] = r[2];
      b[2 * jp + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
}

// `steps` stages through the ring: load(A, B, s) issues stage s's copies
// (zero-filling what lies outside the operands), kStages - 1 stages ahead of
// the one multiplied, for s = 0, 1, 2, .. in turn (so a loader may step its
// own state). Leaves the ring drained and the block synchronised.
template <bool kATrans, typename Load>
__device__ __forceinline__ void mainloop(bf16* smem, int steps, Load load,
                                         float (&acc)[4][4][4]) {
  constexpr int kStage = stage_elems(kATrans);
  constexpr int kA = kATrans ? kTileK : kTileRows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(smem + s * kStage, smem + s * kStage + kA, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage s landed for all; stage s - 1's slot is free
    const int next = s + kStages - 1;
    if (next < steps) {
      bf16* st = smem + (next % kStages) * kStage;
      load(st, st + kA, next);
    }
    cp_async_commit();
    const bf16* st = smem + (s % kStages) * kStage;
    mma_stage<kATrans>(st, st + kA, warp >> 2, warp & 3, lane, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The stored value of v in `out`, as a float.
__device__ __forceinline__ float store_as(bf16* out, float v) {
  const bf16 r = __float2bfloat16(v);
  *out = r;
  return __bfloat162float(r);
}
__device__ __forceinline__ float store_as(float* out, float v) {
  *out = v;
  return v;
}

// out = conv3x3 over the channels-last (M, padded(cin)) src with the
// (kPlanes<Out> * 9 * padded(cin), padded(cout)) matrix wk (+ bias), NCHW,
// in Out (bf16: rounded); A's column k' is the im2col column k' mod (9 *
// padded(cin)), so each of wk's planes meets the same rows of x. With
// `part_s1` non-null also the moments partials (row tiles, cout) of the
// stored out. With `inexact` non-null (the fp32 forward) the blocks return at
// once if the flag is set, and block 0 counts the call in tally[0]. Block
// b computes row tile b / tiles_n, column tile b % tiles_n.
template <typename Out>
__global__ void __launch_bounds__(kThreads, 2)
conv_mma_kernel(const bf16* __restrict__ src, const bf16* __restrict__ wk,
                const float* __restrict__ bias, Out* __restrict__ out,
                float* __restrict__ part_s1, float* __restrict__ part_s2,
                const int* __restrict__ inexact, int* __restrict__ tally, int M, int cin,
                int cout, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  if (inexact != nullptr) {
    if (*inexact != 0) return;
    if (blockIdx.x == 0 && tid == 0) atomicAdd(&tally[0], 1);
  }
  const int HW = H * W;
  const int cp = padded(cin);
  const int np = padded(cout);
  const int K = 9 * cp;
  const int tiles_n = (cout + kBN - 1) / kBN;
  const int m_tile = blockIdx.x / tiles_n;
  const int n0 = (blockIdx.x - m_tile * tiles_n) * kBN;
  const int m0 = m_tile * kBM;

  // A: rows tid / kRowChunks + r * (kThreads / kRowChunks), columns
  // (tid % kRowChunks) * 8.. of the stage
  const int a_c = (tid % kRowChunks) * 8;
  const int a_row = tid / kRowChunks;
  int a_pix[kRowPasses], a_h[kRowPasses], a_w[kRowPasses];
  bool a_ok[kRowPasses];
#pragma unroll
  for (int r = 0; r < kRowPasses; ++r) {
    const int m = m0 + a_row + r * (kThreads / kRowChunks);
    a_ok[r] = m < M;
    const int img = a_ok[r] ? m / HW : 0;
    const int p = a_ok[r] ? m - img * HW : 0;
    a_pix[r] = img * HW;
    a_h[r] = p / W;
    a_w[r] = p - a_h[r] * W;
  }
  // B: k rows tid / kKChunks + r * (kThreads / kKChunks), columns
  // (tid % kKChunks) * 8..
  const int b_c = (tid % kKChunks) * 8;
  const bool b_col_ok = n0 + b_c < np;

  // the A columns' (plane * 9 + tap, ci) of column k' = s * kBK + a_c,
  // stepped by kBK a stage
  int ptap = 0;
  int ci = a_c;
  while (ci >= cp) {
    ci -= cp;
    ++ptap;
  }

  auto load = [&](bf16* As, bf16* Bs, int s) {
    const bool k_ok = ptap < 9 * kPlanes<Out>;
    const int tap = kPlanes<Out> == 1 ? ptap : ptap % 9;
    const int kh = tap >= 6 ? 2 : (tap >= 3 ? 1 : 0);
    const int dh = kh - 1;
    const int dw = tap - kh * 3 - 1;
#pragma unroll
    for (int r = 0; r < kRowPasses; ++r) {
      const int hh = a_h[r] + dh;
      const int ww = a_w[r] + dw;
      const bool ok = k_ok && a_ok[r] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const bf16* from =
          ok ? src + static_cast<long long>(a_pix[r] + hh * W + ww) * cp + ci : src;
      cp_async16(As + (a_row + r * (kThreads / kRowChunks)) * kLdRow + a_c, from, ok);
    }
    ci += kBK;
    while (ci >= cp) {
      ci -= cp;
      ++ptap;
    }
#pragma unroll
    for (int r = 0; r < kKPasses; ++r) {
      const int kr = tid / kKChunks + r * (kThreads / kKChunks);
      const int kb = s * kBK + kr;
      const bool ok = b_col_ok && kb < kPlanes<Out> * K;
      const bf16* from = ok ? wk + static_cast<long long>(kb) * np + n0 + b_c : wk;
      cp_async16(Bs + kr * kLdK + b_c, from, ok);
    }
  };
  float acc[4][4][4];
  mainloop<false>(smem, (kPlanes<Out> * K + kBK - 1) / kBK, load, acc);

  // Epilogue: bias, rounding to Out, NCHW store, moments of the stored out over
  // the rows < M. Element e of acc[i][j] lies at row 16 i + lane / 4 + 8 (e / 2),
  // column 8 j + 2 (lane % 4) + e % 2 of the warp's tile.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
      const int img = m / HW;
      Out* o = out + static_cast<long long>(img) * cout * HW + (m - img * HW);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * 32 + j * 8 + 2 * (lane & 3) + e;
          if (co >= cout) continue;
          const float v = acc[i][j][half * 2 + e];
          const float f =
              store_as(o + static_cast<long long>(co) * HW, bias != nullptr ? v + bias[co] : v);
          s1[j][e] = s1[j][e] + f;
          s2[j][e] = s2[j][e] + f * f;
        }
      }
    }
  }
  if (part_s1 == nullptr) return;
  // the 8 lanes of one lane % 4 share their columns: a fixed xor tree
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[j][e] = s1[j][e] + __shfl_xor_sync(0xffffffffu, s1[j][e], off);
        s2[j][e] = s2[j][e] + __shfl_xor_sync(0xffffffffu, s2[j][e], off);
      }
    }
  }
  // then the tile's two row halves (wm = 0, 1), in that order
  float* red = reinterpret_cast<float*>(smem_raw);  // [wm][s1, s2][kBN]
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn * 32 + j * 8 + 2 * lane + e;
        red[(wm * 2) * kBN + col] = s1[j][e];
        red[(wm * 2 + 1) * kBN + col] = s2[j][e];
      }
    }
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < cout) {
    const long long at = static_cast<long long>(m_tile) * cout + n0 + tid;
    part_s1[at] = red[tid] + red[2 * kBN + tid];
    part_s2[at] = red[kBN + tid] + red[3 * kBN + tid];
  }
}

// dW partial of one row split: part[split, co, k] = sum over the split's rows
// m of g[m, co] * A[m, k], g the channels-last (M, padded(cout)) cotangent, A
// the forward's im2col of the channels-last (M, padded(cin)) x. Tile rows co
// (A = g^T, stored [m][co]), columns k (B stored [m][k]), contraction m.
__global__ void __launch_bounds__(kThreads, 2)
wgrad_mma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                 float* __restrict__ part, int M, int cin, int cout, int H, int W,
                 int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int HW = H * W;
  const int cp = padded(cin);
  const int gp = padded(cout);
  const int K = 9 * cp;
  const int k0 = blockIdx.x * kBN;
  const int co0 = blockIdx.y * kBM;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = r0 + rows_per_split < M ? r0 + rows_per_split : M;

  // both operands: rows (m) tid / kKChunks + r * (kThreads / kKChunks) of
  // the stage, 8 columns at (tid % kKChunks) * 8: channels co of g, columns
  // k of A
  const int c8 = (tid % kKChunks) * 8;
  const bool co_ok = co0 + c8 < gp;
  const int k = k0 + c8;
  const bool k_ok = k < K;
  const int tap = k_ok ? k / cp : 0;
  const int ci = k - tap * cp;
  const int dh = tap / 3 - 1;
  const int dw = tap % 3 - 1;

  // the thread's rows m (and their img, h, w), stepped by kBK a stage
  const int step_img = kBK / HW;
  const int step_h = (kBK - step_img * HW) / W;
  const int step_w = kBK - step_img * HW - step_h * W;
  int b_m[kKPasses], b_img[kKPasses], b_h[kKPasses], b_w[kKPasses];
#pragma unroll
  for (int r = 0; r < kKPasses; ++r) {
    b_m[r] = r0 + tid / kKChunks + r * (kThreads / kKChunks);
    b_img[r] = b_m[r] / HW;
    const int p = b_m[r] - b_img[r] * HW;
    b_h[r] = p / W;
    b_w[r] = p - b_h[r] * W;
  }

  auto load = [&](bf16* As, bf16* Bs, int) {
#pragma unroll
    for (int r = 0; r < kKPasses; ++r) {
      const int row = tid / kKChunks + r * (kThreads / kKChunks);
      const bool m_ok = b_m[r] < r1;
      const bool g_ok = m_ok && co_ok;
      cp_async16(As + row * kLdK + c8,
                 g_ok ? g + static_cast<long long>(b_m[r]) * gp + co0 + c8 : g, g_ok);
      const int hh = b_h[r] + dh;
      const int ww = b_w[r] + dw;
      const bool x_ok = m_ok && k_ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
      cp_async16(Bs + row * kLdK + c8,
                 x_ok ? x + static_cast<long long>(b_img[r] * HW + hh * W + ww) * cp + ci
                      : x,
                 x_ok);
      b_m[r] += kBK;
      b_img[r] += step_img;
      b_h[r] += step_h;
      b_w[r] += step_w;
      if (b_w[r] >= W) {
        b_w[r] -= W;
        ++b_h[r];
      }
      if (b_h[r] >= H) {
        b_h[r] -= H;
        ++b_img[r];
      }
    }
  };
  float acc[4][4][4];
  mainloop<true>(smem, r1 > r0 ? (r1 - r0 + kBK - 1) / kBK : 0, load, acc);

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  float* o = part + static_cast<long long>(blockIdx.z) * cout * K;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = co0 + wm * 64 + i * 16 + (lane >> 2) + half * 8;
      if (co >= cout) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + wn * 32 + j * 8 + 2 * (lane & 3);
        if (kc < K) {
          *reinterpret_cast<float2*>(o + static_cast<long long>(co) * K + kc) =
              make_float2(acc[i][j][half * 2], acc[i][j][half * 2 + 1]);
        }
      }
    }
  }
}

// Stores v, rounded to bf16, as the 16 bytes at p.
__device__ __forceinline__ void store8(bf16* p, const float (&v)[kAlign]) {
  unsigned q[kAlign / 2];
#pragma unroll
  for (int j = 0; j < kAlign / 2; ++j) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    q[j] = *reinterpret_cast<const unsigned*>(&pair);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(q[0], q[1], q[2], q[3]);
}

// v as bf16; `changed` set if that rounds it (an fp32 v only).
__device__ __forceinline__ bf16 to_bf16(bf16 v, bool&) { return v; }
__device__ __forceinline__ bf16 to_bf16(float v, bool& changed) {
  const bf16 r = __float2bfloat16(v);
  changed = changed || !isfinite(v) || __bfloat162float(r) != v;
  return r;
}

// out = the bf16 channels-last (M, padded(C)) copy of the NCHW x, the
// padding channels 0, through a shared-memory transpose: a block reads a
// tile of kPackChans channels x kPackRows rows along the rows (a channel's
// pixels are contiguous in an image) and writes it along the channels, 16
// bytes a thread, whole rows of the tile at once. Block b takes row tile b
// / groups, channel tile b % groups. An fp32 x sets *inexact (atomicOr, so
// in no particular order and with one result) if any element changed when
// rounded to bf16 or is not finite (an inf meets the planes' zeros, and inf
// x 0 is NaN); a bf16 x never does.
constexpr int kPackRows = 64;
constexpr int kPackChans = 64;
constexpr int kPackLd = kPackRows + 1;  // odd: the column reads spread over the banks

template <typename In>
__global__ void __launch_bounds__(kRedThreads)
pack_cl_kernel(const In* __restrict__ x, bf16* __restrict__ out, int* __restrict__ inexact,
               int M, int C, int HW) {
  __shared__ bf16 tile[kPackChans * kPackLd];
  const int cp = padded(C);
  const int groups = (cp + kPackChans - 1) / kPackChans;
  const int rt = blockIdx.x / groups;
  const int c0 = (blockIdx.x - rt * groups) * kPackChans;
  const int m0 = rt * kPackRows;
  // read: row m0 + tid % kPackRows of channels c0 + tid / kPackRows + 4 i
  const int r = threadIdx.x % kPackRows;
  const int m = m0 + r;
  const bool m_ok = m < M;
  const int img = m_ok ? m / HW : 0;
  const In* px = x + static_cast<long long>(img) * C * HW + (m - img * HW);
  bool changed = false;
#pragma unroll
  for (int i = 0; i < kPackChans * kPackRows / kRedThreads; ++i) {
    const int cl = threadIdx.x / kPackRows + (kRedThreads / kPackRows) * i;
    const int c = c0 + cl;
    tile[cl * kPackLd + r] = m_ok && c < C ? to_bf16(px[static_cast<long long>(c) * HW], changed)
                                           : __float2bfloat16(0.0f);
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) atomicOr(inexact, 1);
  // write: channels c0 + (tid % 8) * 8.. of rows m0 + tid / 8 + 32 j
  const int ch = (threadIdx.x % (kPackChans / kAlign)) * kAlign;
#pragma unroll
  for (int j = 0; j < kPackRows * kPackChans / kAlign / kRedThreads; ++j) {
    const int rr = threadIdx.x / (kPackChans / kAlign) + (kRedThreads * kAlign / kPackChans) * j;
    if (m0 + rr >= M || c0 + ch >= cp) continue;
    float v[kAlign];
#pragma unroll
    for (int q = 0; q < kAlign; ++q) v[q] = __bfloat162float(tile[(ch + q) * kPackLd + rr]);
    store8(out + static_cast<long long>(m0 + rr) * cp + c0 + ch, v);
  }
}

// a[c] = sum over blocks of part_a[block, c] (b, part_b the same, may be
// null), in a fixed order: lane l of channel c's warp adds the partials l,
// l + 32, .. in turn, then the 32 lane sums meet in a fixed xor tree. A warp
// per channel keeps thousands of partials from being one thread's chain of
// dependent loads.
__global__ void __launch_bounds__(kRedThreads)
sum_partials_kernel(const float* __restrict__ part_a, const float* __restrict__ part_b,
                    float* __restrict__ a, float* __restrict__ b, int blocks, int C) {
  const int c = blockIdx.x * (kRedThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;
  float sa = 0.0f;
  float sb = 0.0f;
#pragma unroll 4
  for (int k = lane; k < blocks; k += 32) {
    sa = sa + part_a[static_cast<long long>(k) * C + c];
    if (part_b != nullptr) sb = sb + part_b[static_cast<long long>(k) * C + c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sa = sa + __shfl_xor_sync(0xffffffffu, sa, off);
    sb = sb + __shfl_xor_sync(0xffffffffu, sb, off);
  }
  if (lane != 0) return;
  a[c] = sa;
  if (b != nullptr) b[c] = sb;
}

inline int sum_partials(const float* part_a, const float* part_b, float* a, float* b,
                        int blocks, int C, cudaStream_t st) {
  sum_partials_kernel<<<cdiv(C, kRedThreads / 32), kRedThreads, 0, st>>>(part_a, part_b, a,
                                                                          b, blocks, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
inline int pack_cl(const void* x, void* out, int* inexact, int M, int C, int HW,
                   cudaStream_t st) {
  pack_cl_kernel<In><<<cdiv(M, kPackRows) * cdiv(padded(C), kPackChans), kRedThreads, 0, st>>>(
      static_cast<const In*>(x), static_cast<bf16*>(out), inexact, M, C, HW);
  return static_cast<int>(cudaGetLastError());
}

// g = gy (+ gs1 + 2 gs2 y) in fp32 for 8 channels c0.. of 256 rows, stored
// rounded to bf16 as one 16-byte piece of each row of the channels-last (M,
// padded(C)) g (the padding channels 0); per-block db partials (row blocks,
// C) of the unrounded g, in grad_out_kernel's tree and layout. Block b
// takes row block b / groups, channel group b % groups.
__global__ void __launch_bounds__(kRedThreads)
grad_out_cl_kernel(const bf16* __restrict__ gy, const bf16* __restrict__ y,
                   const float* __restrict__ gs1, const float* __restrict__ gs2,
                   bf16* __restrict__ g, float* __restrict__ part_db, int M, int C, int HW,
                   int with_moments) {
  __shared__ float red[kAlign][kRedThreads];
  const int groups = padded(C) / kAlign;
  const int rb = blockIdx.x / groups;
  const int c0 = (blockIdx.x - rb * groups) * kAlign;
  const int e = rb * kRedThreads + threadIdx.x;
  const bool ok = e < M;
  const int img = ok ? e / HW : 0;
  const long long base = static_cast<long long>(img) * C * HW + (e - img * HW);
  float v[kAlign];
#pragma unroll
  for (int j = 0; j < kAlign; ++j) {
    const int c = c0 + j;
    float gf = 0.0f;
    if (ok && c < C) {
      const long long i = base + static_cast<long long>(c) * HW;
      gf = __bfloat162float(gy[i]);
      if (with_moments) gf = gf + (gs1[c] + 2.0f * gs2[c] * __bfloat162float(y[i]));
    }
    v[j] = gf;
  }
  if (ok) store8(g + static_cast<long long>(e) * padded(C) + c0, v);
  chsum::block_tree_sum<kAlign>(red, v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kAlign; ++j) {
      if (c0 + j < C) part_db[static_cast<long long>(rb) * C + c0 + j] = v[j];
    }
  }
}

// conv_mma_kernel<Out> over the whole of out; the moments' partials (row
// tiles of kBM, cout), when asked for, are the caller's to sum.
template <typename Out>
inline int launch_mma(const void* src, const void* wk, const float* bias, void* out,
                      float* part_s1, float* part_s2, const int* inexact, int* tally, int M,
                      int cin, int cout, int H, int W, cudaStream_t st) {
  const int bytes = smem_bytes(false);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      conv_mma_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  conv_mma_kernel<Out><<<cdiv(M, kBM) * cdiv(cout, kBN), kThreads, bytes, st>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(wk), bias, static_cast<Out*>(out),
      part_s1, part_s2, inexact, tally, M, cin, cout, H, W);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_fwd(const void* x, void* xcl, const void* wk, const float* bias, void* y,
                      float* part_s1, float* part_s2, float* s1, float* s2, int M, int cin,
                      int cout, int H, int W, cudaStream_t st) {
  int rc = pack_cl<bf16>(x, xcl, nullptr, M, cin, H * W, st);
  if (rc != 0) return rc;
  rc = launch_mma<bf16>(xcl, wk, bias, y, part_s1, part_s2, nullptr, nullptr, M, cin, cout,
                        H, W, st);
  if (rc != 0 || part_s1 == nullptr) return rc;
  return sum_partials(part_s1, part_s2, s1, s2, cdiv(M, kBM), cout, st);
}

// The fp32 forward's two weight matrices from the OIHW fp32 weight w, one
// thread per element of a plane: wk the three bf16 planes W2, W1, W0 (W0 =
// bf16(w), W1 = bf16(w - W0), W2 = bf16(w - W0 - W1); both differences are
// exact in fp32) stacked as (3 * 9 * Cp_in, Cp_out), row p * 9 * Cp_in + tap
// * Cp_in + ci, zero in the padding; wk_cc the CUDA cores' (cin * 9, cout)
// fp32 matrix, row ci * 9 + tap. Also clears the route flag for the pack.
__global__ void __launch_bounds__(kRedThreads)
split_weight_kernel(const float* __restrict__ w, bf16* __restrict__ wk,
                    float* __restrict__ wk_cc, int* __restrict__ inexact, int cin, int cout) {
  const int cp = padded(cin);
  const int np = padded(cout);
  const int e = blockIdx.x * kRedThreads + threadIdx.x;
  if (e == 0) *inexact = 0;
  if (e >= 9 * cp * np) return;
  const int co = e % np;
  const int row = e / np;  // tap * cp + ci
  const int tap = row / cp;
  const int ci = row - tap * cp;
  const bool ok = ci < cin && co < cout;
  const float v = ok ? w[(static_cast<long long>(co) * cin + ci) * 9 + tap] : 0.0f;
  const bf16 w0 = __float2bfloat16(v);
  const float rest = v - __bfloat162float(w0);
  const bf16 w1 = __float2bfloat16(rest);
  const long long plane = 9LL * cp * np;
  wk[e] = __float2bfloat16(rest - __bfloat162float(w1));
  wk[plane + e] = w1;
  wk[2 * plane + e] = w0;
  if (ok) wk_cc[(static_cast<long long>(ci) * 9 + tap) * cout + co] = v;
}

// The fp32 forward: the pack sets *inexact if x is not exact in bf16; the
// tensor-core kernel (wk: the three planes) runs if it is not set, the
// CUDA-core kernel (wk_cc: the fp32 (cin * 9, cout) matrix over the NCHW
// x) if it is, and one second stage sums the partials of either. More rows
// than the tensor-core loop's 32-bit index go to the CUDA cores alone,
// with no pack and the flag unread.
inline int launch_fwd_f32(const void* x, void* xcl, const void* wk, const void* wk_cc,
                          const float* bias, void* y, float* part_s1, float* part_s2,
                          float* s1, float* s2, int* inexact, int* tally, long long n_img,
                          int cin, int cout, int H, int W, cudaStream_t st) {
  static_assert(kBM == ::kBM, "both routes write partials per 128-row tile");
  const long long M = n_img * H * W;
  int rc = 0;
  if (M > 0x7fffffffLL) {
    inexact = nullptr;
  } else {
    rc = pack_cl<float>(x, xcl, inexact, static_cast<int>(M), cin, H * W, st);
    if (rc != 0) return rc;
    rc = launch_mma<float>(xcl, wk, bias, y, part_s1, part_s2, inexact, tally,
                           static_cast<int>(M), cin, cout, H, W, st);
    if (rc != 0) return rc;
  }
  rc = launch_conv<float>(x, wk_cc, bias, y, part_s1, part_s2, inexact, tally, n_img, cin,
                          cout, H, W, st);
  if (rc != 0 || part_s1 == nullptr) return rc;
  return sum_partials(part_s1, part_s2, s1, s2, cdiv(M, kBM), cout, st);
}

inline int launch_bwd(const void* x, void* xcl, const void* w2, const void* y,
                      const void* gy, const float* gs1, const float* gs2, void* g,
                      float* part_db, float* db, void* dx, float* part_dw, float* dw, int M,
                      int cin, int cout, int H, int W, int splits, int rows_per_split,
                      int with_moments, cudaStream_t st) {
  const unsigned row_blocks = cdiv(M, kRedThreads);
  grad_out_cl_kernel<<<row_blocks * (padded(cout) / kAlign), kRedThreads, 0, st>>>(
      static_cast<const bf16*>(gy), static_cast<const bf16*>(y), gs1, gs2,
      static_cast<bf16*>(g), part_db, M, cout, H * W, with_moments);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rc = sum_partials(part_db, nullptr, db, nullptr, row_blocks, cout, st);
  if (rc != 0) return rc;
  rc = pack_cl<bf16>(x, xcl, nullptr, M, cin, H * W, st);
  if (rc != 0) return rc;
  const int K = 9 * padded(cin);
  const int bytes = smem_bytes(true);
  rc = static_cast<int>(cudaFuncSetAttribute(
      wgrad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  const dim3 wgrid(cdiv(K, kBN), cdiv(cout, kBM), splits);
  wgrad_mma_kernel<<<wgrid, kThreads, bytes, st>>>(static_cast<const bf16*>(g),
                                                   static_cast<const bf16*>(xcl), part_dw,
                                                   M, cin, cout, H, W, rows_per_split);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const long long n = static_cast<long long>(cout) * K;
  sum_splits_kernel<<<cdiv(n, kRedThreads), kRedThreads, 0, st>>>(part_dw, dw, n, splits);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || dx == nullptr) return rc;
  // dx: the forward's GEMM on g, Cout channels in, Cin out, no bias or moments
  return launch_mma<bf16>(g, w2, nullptr, dx, nullptr, nullptr, nullptr, nullptr, M, cout,
                          cin, H, W, st);
}

}  // namespace tc

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t), allocates nothing
// and does not synchronise; `bf16` selects the storage type of x, the weight matrices,
// y, gy, g and dx: 0 fp32, 1 bf16. Cp = C rounded up to a multiple of 8.
// xcl is the (n_img * H * W, Cp_in) bf16 scratch for x's channels-last copy
// (the fp32 backward: unused, may be null). Each returns the first CUDA
// error of its launches, 0 if none.
//
// spike_conv_weight_f32: the fp32 forward's wk and wk_cc (below) from the
// contiguous OIHW fp32 weight w (cout, cin, 3, 3), and inexact set to 0.
extern "C" int spike_conv_weight_f32(const float* w, void* wk, float* wk_cc, int* inexact,
                                     int cin, int cout, void* stream) {
  const long long n = 9LL * tc::padded(cin) * tc::padded(cout);
  tc::split_weight_kernel<<<cdiv(n, kRedThreads), kRedThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<tc::bf16*>(wk), wk_cc, inexact, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

// spike_conv_fwd: x (n_img, cin, H, W), bf16 n_img * H * W below 2^31; wk the
// tensor-core matrix, bf16 (9 * Cp_in, Cp_out), row tap * Cp_in + ci, fp32
// the three bf16 planes of the weight stacked as (3 * 9 * Cp_in, Cp_out),
// smallest first; wk_cc (fp32 only) the CUDA-core matrix (cin * 9, cout),
// row ci * 9 + tap, fp32; bias (cout,) fp32 or null; y (n_img, cout, H, W).
// fp32 only: inexact one int, 0 on entry, set to 1 if x is not exact in
// bf16 or not finite (then the CUDA cores computed y, else the tensor
// cores; from 2^31 rows on, the CUDA cores and the flag is unread), and
// tally two ints to which the call adds one, at [0] for the tensor cores,
// at [1] for the CUDA cores. With `with_moments`, part_s1 and part_s2 are
// (ceil(n_img * H * W / 128), cout) fp32 scratch and s1, s2 (cout,) fp32
// outputs; without, all four are unused (may be null).
extern "C" int spike_conv_fwd(const void* x, void* xcl, const void* wk, const void* wk_cc,
                              const float* bias, void* y, float* part_s1, float* part_s2,
                              float* s1, float* s2, int* inexact, int* tally, long long n_img,
                              int cin, int cout, int H, int W, int with_moments, int bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!with_moments) part_s1 = part_s2 = s1 = s2 = nullptr;
  if (!bf16) {
    return tc::launch_fwd_f32(x, xcl, wk, wk_cc, bias, y, part_s1, part_s2, s1, s2, inexact,
                              tally, n_img, cin, cout, H, W, st);
  }
  if (n_img * H * W > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_fwd(x, xcl, wk, bias, y, part_s1, part_s2, s1, s2,
                        static_cast<int>(n_img * H * W), cin, cout, H, W, st);
}

// spike_conv_bwd: x (n_img, cin, H, W), bf16 n_img * H * W below 2^31; w2
// (cout * 9, cin), row co * 9 +
// t, bf16 (9 * Cp_out, Cp_in), row t * Cp_out + co, the flipped and
// transposed weight, read only with dx; y, gy
// (n_img, cout, H, W); gs1, gs2 (cout,) fp32, read only with
// `with_moments`; g scratch in the storage type, (n_img, cout, H, W), bf16
// (n_img * H * W, Cp_out); part_db (ceil(n_img * H * W / 256), cout) fp32
// scratch; db (cout,) fp32; dx (n_img, cin, H, W) or null (not computed);
// part_dw (splits, cout, Kw) fp32 scratch, split s covering rows
// [s * rows_per_split, (s + 1) * rows_per_split); dw (cout, Kw) fp32, with
// Kw = cin * 9, column ci * 9 + tap (OIHW), bf16 Kw = 9 * Cp_in, column tap *
// Cp_in + ci.
extern "C" int spike_conv_bwd(const void* x, void* xcl, const void* w2, const void* y,
                              const void* gy, const float* gs1, const float* gs2,
                              void* g, float* part_db, float* db, void* dx,
                              float* part_dw, float* dw, long long n_img, int cin,
                              int cout, int H, int W, int splits,
                              long long rows_per_split, int with_moments, int bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (n_img * H * W > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    return tc::launch_bwd(x, xcl, w2, y, gy, gs1, gs2, g, part_db, db, dx, part_dw, dw,
                          static_cast<int>(n_img * H * W), cin, cout, H, W, splits,
                          static_cast<int>(rows_per_split), with_moments, st);
  }
  return launch_bwd<float>(x, w2, y, gy, gs1, gs2, g, part_db, db, dx, part_dw,
                           dw, n_img, cin, cout, H, W, splits, rows_per_split,
                           with_moments, st);
}
