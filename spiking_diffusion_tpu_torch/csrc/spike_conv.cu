// K4: the 3x3 SAME stride-1 training convolution, forward (with the
// per-channel BatchNorm moments of its output) and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels spiking_diffusion_tpu/ops/spike_conv.py
// `_fwd_kernel` and `_bwd_kernel` (launched by `_spike_conv_4d` and its
// VJP). The layout is PyTorch's: x is (N, Cin, H, W) with the time axis
// folded into N, the weight the caller reorders from OIHW (Cout, Cin, 3, 3)
// into a (Cin * 9, Cout) matrix B with row k = ci * 9 + kh * 3 + kw, y is
// (N, Cout, H, W). Every operand is stored in T (fp32 or bf16) and every
// product is summed in fp32.
//
// Forward, an implicit GEMM over rows m = (n, h, w), M = N * H * W:
//   y[m, co] = T( sum_k A[m, k] * B[k, co] + bias[co] )
//   A[m, ci * 9 + kh * 3 + kw] = x[n, ci, h + kh - 1, w + kw - 1], 0 off the
//   edge (the edge test uses (h, w) only, so a row never reads another
//   sample's pixels);
//   s1[co] = sum over m of float(y[m, co]), s2[co] = sum of float(y)^2,
//   of the ROUNDED y, as the TPU kernel takes them.
// Backward, from (gy, gs1, gs2), the cotangents of (y, s1, s2):
//   g = float(gy) + (gs1[co] + 2 * gs2[co] * float(y))   (y re-read)
//   db[co] = sum over m of g (fp32);  g is then rounded to T, as the TPU
//   kernel rounds it before its products;
//   dW[co, k] = sum over m of g[m, co] * A[m, k]         (fp32, OIHW)
//   dx = the same implicit GEMM as the forward on g, with the weight
//   flipped and transposed (B2[co * 9 + t, ci] = W[co, ci, 8 - t]), in T;
//   skipped when the caller passes no dx.
//
// What bounds it on an H100: operations. A training step of the full-width
// denoiser at batch 256 runs 1.24 TFLOP through the forward and 2.49 through
// the backward, against ~2 GB of activations: ~30 fp32 operations per byte
// the calls must move. This first version runs them on the CUDA cores
// (fp32 FMAs, bf16 values widened to fp32 as they reach shared memory), as
// a classic register-blocked SGEMM: a block computes a 128 x 128 output tile
// with 256 threads, 8 x 8 outputs each, from double-buffered 8-deep tiles of
// A and B in shared memory, the next tile's global loads in flight while the
// current one is multiplied. The TPU kernel's (HW, T, N, C) view, its
// sublane padding of N and its masked rolls have no counterpart: A is
// gathered from NCHW as the tile is loaded.
//
// Fixed orders, no atomics: the moments and db are summed per thread over
// its rows, then in a fixed shuffle tree (forward) or shared-memory tree
// (db), into per-block partials, and a second kernel adds the partials of a
// channel in block order (csrc/channel_sum.cuh, shared with K3); dW is
// contracted over a fixed split of the rows, one partial (Cout, Cin * 9)
// per split, which a last kernel adds in split
// order. So s1, s2, db and dW are equal from run to run. The plain PyTorch
// versions (ops/spike_conv.py) sum in other orders; the tolerances are
// stated there.

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as PyTorch's cast
}

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const T* __restrict__ wk,
            const float* __restrict__ bias, T* __restrict__ y,
            float* __restrict__ part_s1, float* __restrict__ part_s2,
            long long n_img, int cin, int cout, int H, int W) {
  __shared__ __align__(16) float As[2][kBK * kBM];
  __shared__ __align__(16) float Bs[2][kBK * kBN];
  const int tid = threadIdx.x;
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

template <typename T>
int launch_conv(const void* x, const void* wk, const float* bias, void* y,
                float* part_s1, float* part_s2, float* s1, float* s2,
                long long n_img, int cin, int cout, int H, int W,
                cudaStream_t st) {
  const long long M = n_img * H * W;
  const dim3 grid(cdiv(M, kBM), cdiv(cout, kBN));
  conv_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk), bias,
      static_cast<T*>(y), part_s1, part_s2, n_img, cin, cout, H, W);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || part_s1 == nullptr) return rc;
  chsum::sum_partials(part_s1, part_s2, s1, s2, grid.x, cout, st);
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

}  // namespace

// Both launch on `stream` (a cudaStream_t), allocate nothing and do not
// synchronise; `bf16` selects the storage type of x, the weight matrices,
// y, gy, g and dx: 0 fp32, 1 bf16. Each returns cudaGetLastError() after
// its launches.
//
// spike_conv_fwd: x (n_img, cin, H, W); wk (cin * 9, cout); bias (cout,)
// fp32 or null; y (n_img, cout, H, W). With `with_moments`, part_s1 and
// part_s2 are (ceil(n_img * H * W / 128), cout) fp32 scratch and s1, s2
// (cout,) fp32 outputs; without, all four are unused (may be null).
extern "C" int spike_conv_fwd(const void* x, const void* wk, const float* bias,
                              void* y, float* part_s1, float* part_s2, float* s1,
                              float* s2, long long n_img, int cin, int cout, int H,
                              int W, int with_moments, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!with_moments) part_s1 = part_s2 = s1 = s2 = nullptr;
  if (bf16) {
    return launch_conv<__nv_bfloat16>(x, wk, bias, y, part_s1, part_s2, s1, s2,
                                      n_img, cin, cout, H, W, st);
  }
  return launch_conv<float>(x, wk, bias, y, part_s1, part_s2, s1, s2, n_img,
                            cin, cout, H, W, st);
}

// spike_conv_bwd: x (n_img, cin, H, W); w2 (cout * 9, cin), the flipped and
// transposed weight, read only with dx; y, gy (n_img, cout, H, W); gs1, gs2
// (cout,) fp32, read only with `with_moments`; g (n_img, cout, H, W) scratch
// in the storage type; part_db (ceil(n_img * H * W / 256), cout) fp32
// scratch; db (cout,) fp32; dx (n_img, cin, H, W) or null (not computed);
// part_dw (splits, cout, cin * 9) fp32 scratch, split s covering rows
// [s * rows_per_split, (s + 1) * rows_per_split); dw (cout, cin * 9) fp32.
extern "C" int spike_conv_bwd(const void* x, const void* w2, const void* y,
                              const void* gy, const float* gs1, const float* gs2,
                              void* g, float* part_db, float* db, void* dx,
                              float* part_dw, float* dw, long long n_img, int cin,
                              int cout, int H, int W, int splits,
                              long long rows_per_split, int with_moments, int bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_bwd<__nv_bfloat16>(x, w2, y, gy, gs1, gs2, g, part_db, db, dx,
                                     part_dw, dw, n_img, cin, cout, H, W, splits,
                                     rows_per_split, with_moments, st);
  }
  return launch_bwd<float>(x, w2, y, gy, gs1, gs2, g, part_db, db, dx, part_dw,
                           dw, n_img, cin, cout, H, W, splits, rows_per_split,
                           with_moments, st);
}
