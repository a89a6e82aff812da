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
// activations. Every pass runs on the tensor cores: bf16 as it is, fp32
// through exact bf16 planes (below); an fp32 operand that the planes cannot
// carry takes the CUDA cores.
//
// The tensor-core route. The operands are channels-last and padded: x (and
// g for dx and dW) is copied (written, for g) as bf16 (M, Cp) with Cp = C
// rounded up to a multiple of 8, the padding zero, so that every operand
// row piece is one aligned 16-byte `cp.async`; column k = tap * Cp + ci with
// tap = kh * 3 + kw, so for one row and one tap a run of 8 channels is
// contiguous and an off-grid tap or a row past M is one zero-filled copy.
// Forward, dx and dW share one inner loop (mma_loop.cuh, which K2 shares
// too): a 128 x 128 block tile
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
// fp32 (T = float): bf16 planes. Any fp32 value v is the exact sum of
// three bf16 planes, V0 = bf16(v), V1 = bf16(v - V0), V2 = bf16(v - V0 -
// V1), each holding 8 of fp32's 24 significant bits (for |v| >= 2^-110;
// below, the sum is within 2^-134, half bf16's least subnormal), and a
// bf16 x bf16 product is exact in fp32. On the model's path every x is
// exact in bf16: spikes (0, 1), token ids (<= mask_id, 128) and timesteps
// (<= 49). That holds while mask_id and the number of timesteps are at
// most 256, since every integer up to 256 is exact in bf16; a larger
// codebook sends block 0 to the CUDA-core routes, still correct. So:
//  - forward: y = sum x W2 + sum x W1 + sum x W0, exact products summed in
//    fp32, the CUDA cores' arithmetic in another order at three bf16
//    products per product;
//  - dW = sum G2 x + sum G1 x + sum G0 x over the planes of g, the same
//    with the planes on the other operand;
//  - dx = sum over the six plane products Gi Wj with i + j <= 2 (g and the
//    weight both fp32). Term (i, j) is about 2^-8(i+j) of g W; the three
//    dropped, (1, 2), (2, 1) and (2, 2), add up to at most (2 * 2^-24 +
//    2^-32) |g W| a product, one fp32 rounding of it: as accurate as an
//    fp32 FMA chain, the standard bf16 emulation of an fp32 GEMM.
// Each longer contraction keeps the loop, its ring and its occupancy as
// they are: A's loader reads the same rows of x (dW: of x again, per g
// plane) for each plane, from L2, and the planes are stacked smallest
// first so that the small terms are summed before the large ones. The
// sums stay in the mma's fp32 accumulators, but for dx's last term: the
// mma's accumulation truncates, so one chain over dx's 6 * 9 * Cp_out
// terms drifted past the plain version's 1e-4 where dx cancels (card
// tests, 256 -> 512 channels); G0 W0 is summed in chains of 1,024
// products, each folded into dx with fp32 adds, which holds it.
//  - Forward: the pack copies the fp32 x to the bf16 channels-last scratch
//    and sets a device flag (atomicOr) if any element changed when
//    rounded. Exact x: the loop over K' = 3 * 9 * Cp_in, B the weight's
//    three planes stacked as (3 * 9 * Cp_in, Cp_out) (W2, W1, W0); A's
//    loader reads column k' at k' mod (9 * Cp_in), which needs no extra
//    copy of x (9 * Cp is a multiple of 8, so no 16-byte piece straddles
//    two planes). One kernel (split_weight_kernel) writes both routes'
//    weight matrices per call.
//  - Backward: the g pass writes g's three planes channels-last, (3, M,
//    Cp_out), and sets a second flag if any g is not finite or its first
//    plane is not (a plane of +-inf holds inf - inf = NaN); the pack sets
//    the first flag for x. dW runs the loop once per g plane over each
//    row split (G2, G1, G0). dx runs it over K' = 6 * 9 * Cp_out, B the
//    (6 * 9 * Cp_out, Cp_in) matrix of the flipped weight's planes in the
//    terms' order (written per call by split_dx_weight_kernel, with the
//    CUDA cores' dx matrix), A's loader reading the g plane of each term.
//    The caller gives the terms' order (ops/spike_conv.py DX_TERMS, two
//    bits a plane index).
//  - Other operands, and any call of 2^31 rows or more (the tensor-core
//    loop's index is 32-bit; no pack then): the CUDA cores, column k = ci *
//    9 + kh * 3 + kw, over NCHW operands as they lie (the backward's g
//    formed from gy and y as it is read, no fp32 copy of g). The forward
//    and dW go there for an x that is off bf16's grid or not finite (inf
//    times a zero plane is NaN), dW and dx for a g that is not finite. A
//    classic register-blocked SGEMM: a block computes a 128 x 128 output
//    tile with 256 threads, 8 x 8 outputs each, from double-buffered
//    8-deep tiles of A and B in shared memory, A gathered from NCHW as the
//    tile is loaded. Bounded by the CUDA cores' 67 TFLOP/s.
//  Both routes' kernels are launched; each reads the flags first and the
//  one not chosen returns at once, so the choice needs no host
//  synchronisation. Both write one layout for one last stage (the
//  moments' partials per row tile; dW's partials, which the last stage
//  sums from either route's layout into (Cout, 9 * Cp_in)), and count the
//  calls they take in a device tally: forward, dW, dx, each (tensor
//  cores, CUDA cores).
//
// Fixed orders, no atomics in any sum (the routes' flags and tally are
// the only atomics): the moments and db are summed per thread over its
// rows, then in a fixed shuffle tree (forward) or shared-memory tree (db,
// csrc/channel_sum.cuh, shared with K3), into per-block partials, and a
// second kernel adds the partials of a channel in a fixed order (a warp
// per channel); dW is contracted over a fixed split of the rows, one
// partial per split, which a last kernel adds in split order. So s1, s2,
// db and dW are equal from run to run. The plain PyTorch versions
// (ops/spike_conv.py) sum in other orders; the tolerances are stated
// there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "channel_sum.cuh"
#include "mma_loop.cuh"

namespace {

constexpr int kBM = 128;      // output tile rows
constexpr int kBN = 128;      // output tile columns
constexpr int kBK = 8;        // contraction depth of one shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 8 x 8 outputs each
constexpr int kPad = 4;       // row padding of the wgrad tiles (bank spread)
constexpr int kRedThreads = chsum::kBlock;

// The NCHW operands that the CUDA-core kernels (fp32 only; bf16 takes the
// tensor cores) gather: at(i, c) is element i, of channel c. Plain reads x
// as it lies; Grad forms the backward's g = gy (+ gs1 + 2 gs2 y) from gy
// and y as it reads them, in grad_out_cl_kernel's operations and order, so
// that the CUDA-core routes need no fp32 copy of g.
struct Plain {
  const float* x;
  __device__ __forceinline__ float at(long long i, int) const { return x[i]; }
};

struct Grad {
  const float* gy;
  const float* y;
  const float* gs1;
  const float* gs2;
  int with_moments;
  __device__ __forceinline__ float at(long long i, int c) const {
    float g = gy[i];
    if (with_moments) g = g + (gs1[c] + 2.0f * gs2[c] * y[i]);
    return g;
  }
};

// One element of the implicit im2col matrix of the image that starts at
// element `img` of src: src[img + (ci, h + dh, w + dw)] for column k = ci *
// 9 + (dh + 1) * 3 + (dw + 1), 0 off the edge.
template <typename Src>
__device__ __forceinline__ float im2col(const Src& src, long long img, int k, int h, int w,
                                        int H, int W) {
  const int ci = k / 9;
  const int tap = k - ci * 9;
  const int kh = tap / 3;
  const int hh = h + kh - 1;
  const int ww = w + (tap - kh * 3) - 1;
  if (hh < 0 || hh >= H || ww < 0 || ww >= W) return 0.0f;
  return src.at(img + static_cast<long long>(ci) * H * W + hh * W + ww, ci);
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

// y = conv3x3(src, B) (+ bias), rows m = (img, h, w), columns co; with
// `part_s1` non-null also the per-block moments partials (gridDim.x, cout).
// With `flag` non-null (a route that the card chooses: the fp32 forward
// of an x that bf16 cannot hold, the dx of a g that is not finite) the
// blocks return at once unless *flag is set; with `tally` non-null block
// 0 counts the call in tally[1].
template <typename Src>
__global__ void __launch_bounds__(kThreads)
conv_kernel(Src src, const float* __restrict__ wk, const float* __restrict__ bias,
            float* __restrict__ y, float* __restrict__ part_s1, float* __restrict__ part_s2,
            const int* __restrict__ flag, int* __restrict__ tally, long long n_img, int cin,
            int cout, int H, int W) {
  __shared__ __align__(16) float As[2][kBK * kBM];
  __shared__ __align__(16) float Bs[2][kBK * kBN];
  const int tid = threadIdx.x;
  if (flag != nullptr && *flag == 0) return;
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
  const long long img = a_img * cin * HW;
  const int bcol = n0 + lrow;
  const bool b_ok = bcol < cout;

  float ra[4], rb[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + kl + 2 * i;
      ra[i] = (a_ok && k < K) ? im2col(src, img, k, a_h, a_w, H, W) : 0.0f;
      rb[i] = (b_ok && k < K) ? wk[static_cast<long long>(k) * cout + bcol] : 0.0f;
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

  // Epilogue: bias, NCHW store, moments.
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + tile_offset(i, tx);
    if (m >= M) continue;
    const long long im = m / HW;
    const int p = static_cast<int>(m - im * HW);
    float* y_px = y + im * cout * HW + p;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = n0 + tile_offset(j, ty);
      if (co >= cout) continue;
      const float f = bias != nullptr ? acc[i][j] + bias[co] : acc[i][j];
      y_px[static_cast<long long>(co) * HW] = f;
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

// Per-block db partials (gridDim.x, C) of g: a block takes 256 consecutive
// (img, p) of one channel (blockIdx.y), as K3's backward does. The fp32
// backward of 2^31 rows or more, whose g the tensor-core g pass cannot
// index.
__global__ void grad_out_kernel(Grad g, float* __restrict__ part_db, long long n_img, int C,
                                int HW) {
  __shared__ float red[1][kRedThreads];
  const long long e = static_cast<long long>(blockIdx.x) * kRedThreads + threadIdx.x;
  const int c = blockIdx.y;
  float gf = 0.0f;
  if (e < n_img * HW) {
    const long long img = e / HW;
    gf = g.at((img * C + c) * HW + (e - img * HW), c);
  }
  float acc[1] = {gf};
  chsum::block_tree_sum<1>(red, acc);
  if (threadIdx.x == 0) part_db[static_cast<long long>(blockIdx.x) * C + c] = acc[0];
}

// dW partial of one row split on the CUDA cores: part[split, co, k] = sum
// over the split's rows m of g[m, co] * A[m, k], k = ci * 9 + tap. Tile
// rows co, columns k, contraction m. The blocks return at once unless
// route[0] (x not exact in bf16) or route[1] (g not finite) is set; block
// 0 counts the call in tally[1].
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(Grad g, const float* __restrict__ x, float* __restrict__ part,
             const int* __restrict__ route, int* __restrict__ tally, long long n_img, int cin,
             int cout, int H, int W, long long rows_per_split) {
  constexpr int kLd = kBM + kPad;
  __shared__ __align__(16) float As[2][kBK * kLd];
  __shared__ __align__(16) float Bs[2][kBK * kLd];
  const int tid = threadIdx.x;
  if ((route[0] | route[1]) == 0) return;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0) {
    atomicAdd(&tally[1], 1);
  }
  const Plain xs{x};
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int co = co0 + lc + 32 * i;
      const int k = k0 + lc + 32 * i;
      ra[i] = (ok && co < cout) ? g.at((img * cout + co) * HW + p, co) : 0.0f;
      rb[i] = (ok && k < K) ? im2col(xs, img * cin * HW, k, h, w, H, W) : 0.0f;
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

// dw[co, tap * Cp + ci] (Cp = cin padded to a multiple of 8: the tensor-core
// route's layout, 0 in the padding) = the sum over splits, in split order,
// of the partials of the route that ran: the tensor cores' part[split, co,
// tap * Cp + ci] (splits_tc of them), or, if route is non-null and
// route[0] or route[1] is set, the CUDA cores' part[split, co, ci * 9 +
// tap] (splits_cc). One thread per element of dw.
__global__ void sum_splits_kernel(const float* __restrict__ part, float* __restrict__ dw,
                                  const int* __restrict__ route, int cin, int cout,
                                  int splits_tc, int splits_cc) {
  const int cp = tc::padded(cin);
  const long long n = 9LL * cp * cout;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  if (route == nullptr || (route[0] | route[1]) == 0) {
    for (int k = 0; k < splits_tc; ++k) s = s + part[k * n + e];
  } else {
    const int co = static_cast<int>(e / (9 * cp));
    const int col = static_cast<int>(e - static_cast<long long>(co) * 9 * cp);
    const int tap = col / cp;
    const int ci = col - tap * cp;
    if (ci < cin) {
      const long long n_cc = 9LL * cin * cout;
      const long long at = (static_cast<long long>(co) * cin + ci) * 9 + tap;
      for (int k = 0; k < splits_cc; ++k) s = s + part[k * n_cc + at];
    }
  }
  dw[e] = s;
}

inline unsigned int cdiv(long long a, long long b) {
  return static_cast<unsigned int>((a + b - 1) / b);
}

// conv_kernel over the whole of y; the moments' partials (row tiles of kBM,
// cout), when asked for, are the caller's to sum.
template <typename Src>
int launch_conv(Src src, const float* wk, const float* bias, float* y, float* part_s1,
                float* part_s2, const int* flag, int* tally, long long n_img, int cin,
                int cout, int H, int W, cudaStream_t st) {
  const long long M = n_img * H * W;
  const dim3 grid(cdiv(M, kBM), cdiv(cout, kBN));
  conv_kernel<Src><<<grid, kThreads, 0, st>>>(src, wk, bias, y, part_s1, part_s2, flag,
                                               tally, n_img, cin, cout, H, W);
  return static_cast<int>(cudaGetLastError());
}

// --- tensor cores: bf16, and fp32 through exact bf16 planes -----------------

namespace tc {

// The loop itself (tc::mainloop and its constants) is in mma_loop.cuh.

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

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// Plane index q of term t in a code of two bits a term, first term lowest.
__device__ __forceinline__ int plane_of(int code, int t) { return (code >> (2 * t)) & 3; }

// dx's plane products (ops/spike_conv.py DX_TERMS). The mma's fp32
// accumulation truncates rather than rounds, so a long chain of it drifts
// further from the exact sum than rounded fp32 adds: the last term (G0 W0,
// the size of dx) is summed in chains of kFoldStages stages, each folded
// into dx with fp32 adds.
constexpr int kDxTerms = 6;
constexpr int kFoldStages = 16;

// out[tile] (+)= acc, NCHW fp32, the tile at rows m0.., columns n0.. laid
// out as conv_mma_kernel's epilogue lays it (`add` false: stored), and acc
// zeroed: a finished chain of the contraction folded away.
__device__ __forceinline__ void fold_into(float* __restrict__ out, float (&acc)[4][4][4],
                                          bool add, int m0, int n0, int M, int cout, int HW) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + (warp >> 2) * 64 + i * 16 + (lane >> 2) + half * 8;
      const int img = m / HW;
      float* o = out + static_cast<long long>(img) * cout * HW + (m - img * HW);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + (warp & 3) * 32 + j * 8 + 2 * (lane & 3) + e;
          float& a = acc[i][j][half * 2 + e];
          if (m < M && co < cout) {
            float* p = o + static_cast<long long>(co) * HW;
            *p = add ? *p + a : a;
          }
          a = 0.0f;
        }
      }
    }
  }
}

// out = conv3x3 over the channels-last src with the (kTerms * 9 *
// padded(cin), padded(cout)) matrix wk (+ bias), NCHW, in Out (bf16:
// rounded). The contraction is kTerms blocks of 9 * padded(cin) columns.
// The forward's blocks all read the im2col of the (M, padded(cin)) x;
// dx's (kTerms == kDxTerms) block t reads that of g's plane
// plane_of(a_planes, t), the planes one after the other in src, and its
// last term is folded into out every kFoldStages stages. With `part_s1`
// non-null also the moments partials (row tiles, cout) of the stored out.
// With `flag` non-null (fp32) the blocks return at once if the flag is
// set, and block 0 counts the call in tally[0]. Block b computes row tile
// b / tiles_n, column tile b % tiles_n.
template <typename Out, int kTerms>
__global__ void __launch_bounds__(kThreads, 2)
conv_mma_kernel(const bf16* __restrict__ src, const bf16* __restrict__ wk,
                const float* __restrict__ bias, Out* __restrict__ out,
                float* __restrict__ part_s1, float* __restrict__ part_s2,
                const int* __restrict__ flag, int* __restrict__ tally, int M, int cin,
                int cout, int H, int W, int a_planes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  if (flag != nullptr) {
    if (*flag != 0) return;
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

  // the A columns' (term * 9 + tap, ci) of column k' = s * kBK + a_c,
  // stepped by kBK a stage
  int ptap = 0;
  int ci = a_c;
  while (ci >= cp) {
    ci -= cp;
    ++ptap;
  }

  auto load = [&](bf16* As, bf16* Bs, int s) {
    const bool k_ok = ptap < 9 * kTerms;
    const int term = kTerms == 1 ? 0 : ptap / 9;
    const int tap = ptap - term * 9;
    const bf16* a_src =
        kTerms == kDxTerms ? src + static_cast<long long>(plane_of(a_planes, term)) * M * cp : src;
    const int kh = tap >= 6 ? 2 : (tap >= 3 ? 1 : 0);
    const int dh = kh - 1;
    const int dw = tap - kh * 3 - 1;
#pragma unroll
    for (int r = 0; r < kRowPasses; ++r) {
      const int hh = a_h[r] + dh;
      const int ww = a_w[r] + dw;
      const bool ok = k_ok && a_ok[r] && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const bf16* from =
          ok ? a_src + static_cast<long long>(a_pix[r] + hh * W + ww) * cp + ci : src;
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
      const bool ok = b_col_ok && kb < kTerms * K;
      const bf16* from = ok ? wk + static_cast<long long>(kb) * np + n0 + b_c : wk;
      cp_async16(Bs + kr * kLdK + b_c, from, ok);
    }
  };
  // dx: fold after every kFoldStages stages of the last term (from its
  // first whole stage), the first fold a store; state derived from s alone
  const int steps = (kTerms * K + kBK - 1) / kBK;
  auto fold = [&](int s, float (&a)[4][4][4]) {
    if constexpr (kTerms == kDxTerms) {
      const int done = s + 1 - (kTerms - 1) * K / kBK;  // stages of the last term
      if (done > 0 && done % kFoldStages == 0) {
        fold_into(out, a, done > kFoldStages, m0, n0, M, cout, HW);
      }
    }
  };
  float acc[4][4][4];
  mainloop<false>(smem, steps, load, acc, fold);
  const bool folded = kTerms == kDxTerms && steps - (kTerms - 1) * K / kBK >= kFoldStages;

  // Epilogue: bias (or the folded chains), rounding to Out, NCHW store,
  // moments of the stored out over the rows < M. Element e of acc[i][j]
  // lies at row 16 i + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e
  // % 2 of the warp's tile.
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
          const float v = bias != nullptr ? acc[i][j][half * 2 + e] + bias[co]
                                          : acc[i][j][half * 2 + e];
          Out* p = o + static_cast<long long>(co) * HW;
          const float f = store_as(p, folded ? to_float(*p) + v : v);
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
// m of g[m, co] * A[m, k], g channels-last (M, padded(cout)) in kPlanes bf16
// planes one after the other (fp32: G0, G1, G2), A the forward's im2col of
// the channels-last (M, padded(cin)) x. Tile rows co (A = g^T, stored
// [m][co]), columns k (B stored [m][k]), contraction m, once per plane,
// the last plane (the smallest) first, so the rows of x are read kPlanes
// times. With `route` non-null (fp32) the blocks return at once if
// route[0] (x not exact in bf16) or route[1] (g not finite) is set, and
// block 0 counts the call in tally[0].
template <int kPlanes>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_mma_kernel(const bf16* __restrict__ g, const bf16* __restrict__ x,
                 float* __restrict__ part, const int* __restrict__ route,
                 int* __restrict__ tally, int M, int cin, int cout, int H, int W,
                 int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  if (route != nullptr) {
    if ((route[0] | route[1]) != 0) return;
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0) {
      atomicAdd(&tally[0], 1);
    }
  }
  const int HW = H * W;
  const int cp = padded(cin);
  const int gp = padded(cout);
  const int K = 9 * cp;
  const int k0 = blockIdx.x * kBN;
  const int co0 = blockIdx.y * kBM;
  const int r0 = blockIdx.z * rows_per_split;
  const int r1 = r0 + rows_per_split < M ? r0 + rows_per_split : M;
  const int per_plane = r1 > r0 ? (r1 - r0 + kBK - 1) / kBK : 0;
  const long long plane = static_cast<long long>(M) * gp;

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

  // the thread's rows m (and their img, h, w), from the split's first,
  // stepped by kBK a stage
  const int step_img = kBK / HW;
  const int step_h = (kBK - step_img * HW) / W;
  const int step_w = kBK - step_img * HW - step_h * W;
  int b_m[kKPasses], b_img[kKPasses], b_h[kKPasses], b_w[kKPasses];
  auto first_rows = [&]() {
#pragma unroll
    for (int r = 0; r < kKPasses; ++r) {
      b_m[r] = r0 + tid / kKChunks + r * (kThreads / kKChunks);
      b_img[r] = b_m[r] / HW;
      const int p = b_m[r] - b_img[r] * HW;
      b_h[r] = p / W;
      b_w[r] = p - b_h[r] * W;
    }
  };
  first_rows();
  const bf16* gq = g + (kPlanes - 1) * plane;  // the plane being contracted
  int left = per_plane;                        // its stages still to load

  auto load = [&](bf16* As, bf16* Bs, int) {
    if (kPlanes > 1 && left == 0) {  // the next plane, from the split's first row
      left = per_plane;
      gq -= plane;
      first_rows();
    }
    --left;
#pragma unroll
    for (int r = 0; r < kKPasses; ++r) {
      const int row = tid / kKChunks + r * (kThreads / kKChunks);
      const bool m_ok = b_m[r] < r1;
      const bool g_ok = m_ok && co_ok;
      cp_async16(As + row * kLdK + c8,
                 g_ok ? gq + static_cast<long long>(b_m[r]) * gp + co0 + c8 : g, g_ok);
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
  mainloop<true>(smem, kPlanes * per_plane, load, acc);

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

// bf16 planes of g: an fp32 g is three (the fp32 backward)
template <typename T>
constexpr int kGradPlanes = 1;
template <>
constexpr int kGradPlanes<float> = 3;

// g = gy (+ gs1 + 2 gs2 y) in fp32 for 8 channels c0.. of 256 rows, stored
// as one 16-byte piece of each row of the channels-last (M, padded(C)) g
// (the padding channels 0): bf16 rounded to bf16; fp32 as its three bf16
// planes G0 = bf16(g), G1 = bf16(g - G0), G2 = bf16(g - G0 - G1), (M,
// padded(C)) each, one after the other, with *nonfinite set (atomicOr) if
// any G0 is not finite (g is NaN or +-inf, or rounds to inf in bf16: its
// planes would not sum to it). Per-block db partials (row blocks, C) of the
// unrounded g, in a fixed tree. Block b takes row block b / groups, channel
// group b % groups.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
grad_out_cl_kernel(const T* __restrict__ gy, const T* __restrict__ y,
                   const float* __restrict__ gs1, const float* __restrict__ gs2,
                   bf16* __restrict__ g, float* __restrict__ part_db, int* __restrict__ nonfinite,
                   int M, int C, int HW, int with_moments) {
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
      gf = to_float(gy[i]);
      if (with_moments) gf = gf + (gs1[c] + 2.0f * gs2[c] * to_float(y[i]));
    }
    v[j] = gf;
  }
  bool bad = false;
  if (ok) {
    bf16* row = g + static_cast<long long>(e) * padded(C) + c0;
    store8(row, v);
    if (kGradPlanes<T> == 3) {
      const long long plane = static_cast<long long>(M) * padded(C);
      float rest[kAlign];
#pragma unroll
      for (int j = 0; j < kAlign; ++j) {
        const float g0 = __bfloat162float(__float2bfloat16(v[j]));
        bad = bad || !isfinite(g0);
        rest[j] = v[j] - g0;
      }
      store8(row + plane, rest);
#pragma unroll
      for (int j = 0; j < kAlign; ++j) {
        rest[j] = rest[j] - __bfloat162float(__float2bfloat16(rest[j]));
      }
      store8(row + 2 * plane, rest);
    }
  }
  if (kGradPlanes<T> == 3 && __syncthreads_or(bad) && threadIdx.x == 0) atomicOr(nonfinite, 1);
  chsum::block_tree_sum<kAlign>(red, v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kAlign; ++j) {
      if (c0 + j < C) part_db[static_cast<long long>(rb) * C + c0 + j] = v[j];
    }
  }
}

template <typename T>
inline int grad_out_cl(const void* gy, const void* y, const float* gs1, const float* gs2,
                       void* g, float* part_db, int* nonfinite, int M, int C, int HW,
                       int with_moments, cudaStream_t st) {
  grad_out_cl_kernel<T><<<cdiv(M, kRedThreads) * (padded(C) / kAlign), kRedThreads, 0, st>>>(
      static_cast<const T*>(gy), static_cast<const T*>(y), gs1, gs2, static_cast<bf16*>(g),
      part_db, nonfinite, M, C, HW, with_moments);
  return static_cast<int>(cudaGetLastError());
}

// conv_mma_kernel<Out, kTerms> over the whole of out; the moments' partials
// (row tiles of kBM, cout), when asked for, are the caller's to sum.
template <typename Out, int kTerms>
inline int launch_mma(const void* src, const void* wk, const float* bias, void* out,
                      float* part_s1, float* part_s2, const int* flag, int* tally, int M,
                      int cin, int cout, int H, int W, int a_planes, cudaStream_t st) {
  const int bytes = smem_bytes(false);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      conv_mma_kernel<Out, kTerms>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  conv_mma_kernel<Out, kTerms><<<cdiv(M, kBM) * cdiv(cout, kBN), kThreads, bytes, st>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(wk), bias, static_cast<Out*>(out),
      part_s1, part_s2, flag, tally, M, cin, cout, H, W, a_planes);
  return static_cast<int>(cudaGetLastError());
}

// wgrad_mma_kernel<kPlanes> over every split; the partials are the
// caller's to sum.
template <int kPlanes>
inline int launch_wgrad_mma(const void* g, const void* xcl, float* part_dw, const int* route,
                            int* tally, int M, int cin, int cout, int H, int W, int splits,
                            int rows_per_split, cudaStream_t st) {
  const int bytes = smem_bytes(true);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      wgrad_mma_kernel<kPlanes>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  const dim3 grid(cdiv(9 * padded(cin), kBN), cdiv(cout, kBM), splits);
  wgrad_mma_kernel<kPlanes><<<grid, kThreads, bytes, st>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(xcl), part_dw, route, tally, M, cin,
      cout, H, W, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

// sum_splits_kernel into the (cout, 9 * padded(cin)) dw.
inline int sum_splits(const float* part_dw, float* dw, const int* route, int cin, int cout,
                      int splits_tc, int splits_cc, cudaStream_t st) {
  sum_splits_kernel<<<cdiv(9LL * padded(cin) * cout, kRedThreads), kRedThreads, 0, st>>>(
      part_dw, dw, route, cin, cout, splits_tc, splits_cc);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_fwd(const void* x, void* xcl, const void* wk, const float* bias, void* y,
                      float* part_s1, float* part_s2, float* s1, float* s2, int M, int cin,
                      int cout, int H, int W, cudaStream_t st) {
  int rc = pack_cl<bf16>(x, xcl, nullptr, M, cin, H * W, st);
  if (rc != 0) return rc;
  rc = launch_mma<bf16, 1>(xcl, wk, bias, y, part_s1, part_s2, nullptr, nullptr, M, cin, cout,
                           H, W, 0, st);
  if (rc != 0 || part_s1 == nullptr) return rc;
  return sum_partials(part_s1, part_s2, s1, s2, cdiv(M, kBM), cout, st);
}

// The three bf16 planes of an fp32 v (both differences are exact in fp32).
struct Planes {
  bf16 p[3];
  __device__ __forceinline__ explicit Planes(float v) {
    p[0] = __float2bfloat16(v);
    const float rest = v - __bfloat162float(p[0]);
    p[1] = __float2bfloat16(rest);
    p[2] = __float2bfloat16(rest - __bfloat162float(p[1]));
  }
  __device__ __forceinline__ bf16 operator[](int q) const {
    return q == 0 ? p[0] : (q == 1 ? p[1] : p[2]);
  }
};

// The fp32 forward's two weight matrices from the OIHW fp32 weight w, one
// thread per element of a plane: wk the three bf16 planes W2, W1, W0 (W0 =
// bf16(w), W1 = bf16(w - W0), W2 = bf16(w - W0 - W1)) stacked as (3 * 9 *
// Cp_in, Cp_out), row p * 9 * Cp_in + tap * Cp_in + ci, zero in the
// padding; wk_cc the CUDA cores' (cin * 9, cout) fp32 matrix, row ci * 9 +
// tap. Also clears the route flag for the pack.
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
  const Planes q(v);
  const long long plane = 9LL * cp * np;
  wk[e] = q[2];
  wk[plane + e] = q[1];
  wk[2 * plane + e] = q[0];
  if (ok) wk_cc[(static_cast<long long>(ci) * 9 + tap) * cout + co] = v;
}

// The fp32 dx pass's two weight matrices from the OIHW fp32 weight w, one
// thread per element of a plane of the flipped, transposed weight W[co, ci,
// 8 - tap]: w2 the (6 * 9 * Cp_out, Cp_in) bf16 matrix whose block t (rows
// t * 9 * Cp_out + tap * Cp_out + co) is its plane plane_of(w_planes, t)
// (planes as split_weight_kernel's), zero in the padding; w2_cc the CUDA
// cores' (cout * 9, cin) fp32 matrix, row co * 9 + tap. Both null: no dx,
// nothing written. Also sets both backward route flags to `force` (1: a
// call too large for the tensor cores), for the g pass and the pack.
__global__ void __launch_bounds__(kRedThreads)
split_dx_weight_kernel(const float* __restrict__ w, bf16* __restrict__ w2,
                       float* __restrict__ w2_cc, int* __restrict__ flags, int cin, int cout,
                       int w_planes, int force) {
  const int cp = padded(cout);
  const int np = padded(cin);
  const int e = blockIdx.x * kRedThreads + threadIdx.x;
  if (e == 0) flags[0] = flags[1] = force;
  if (w2 == nullptr || e >= 9 * cp * np) return;
  const int ci = e % np;
  const int row = e / np;  // tap * cp + co
  const int tap = row / cp;
  const int co = row - tap * cp;
  const bool ok = ci < cin && co < cout;
  const float v = ok ? w[(static_cast<long long>(co) * cin + ci) * 9 + 8 - tap] : 0.0f;
  const Planes q(v);
  const long long block = 9LL * cp * np;
#pragma unroll
  for (int t = 0; t < 6; ++t) w2[t * block + e] = q[plane_of(w_planes, t)];
  if (ok) w2_cc[(static_cast<long long>(co) * 9 + tap) * cin + ci] = v;
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
    rc = launch_mma<float, 3>(xcl, wk, bias, y, part_s1, part_s2, inexact, tally,
                              static_cast<int>(M), cin, cout, H, W, 0, st);
    if (rc != 0) return rc;
  }
  rc = launch_conv(Plain{static_cast<const float*>(x)}, static_cast<const float*>(wk_cc), bias,
                   static_cast<float*>(y), part_s1, part_s2, inexact, tally, n_img, cin, cout,
                   H, W, st);
  if (rc != 0 || part_s1 == nullptr) return rc;
  return sum_partials(part_s1, part_s2, s1, s2, cdiv(M, kBM), cout, st);
}

inline int launch_bwd(const void* x, void* xcl, const void* w2, const void* y,
                      const void* gy, const float* gs1, const float* gs2, void* g,
                      float* part_db, float* db, void* dx, float* part_dw, float* dw, int M,
                      int cin, int cout, int H, int W, int splits, int rows_per_split,
                      int with_moments, cudaStream_t st) {
  int rc = grad_out_cl<bf16>(gy, y, gs1, gs2, g, part_db, nullptr, M, cout, H * W,
                             with_moments, st);
  if (rc != 0) return rc;
  rc = sum_partials(part_db, nullptr, db, nullptr, cdiv(M, kRedThreads), cout, st);
  if (rc != 0) return rc;
  rc = pack_cl<bf16>(x, xcl, nullptr, M, cin, H * W, st);
  if (rc != 0) return rc;
  rc = launch_wgrad_mma<1>(g, xcl, part_dw, nullptr, nullptr, M, cin, cout, H, W, splits,
                           rows_per_split, st);
  if (rc != 0) return rc;
  rc = sum_splits(part_dw, dw, nullptr, cin, cout, splits, 0, st);
  if (rc != 0 || dx == nullptr) return rc;
  // dx: the forward's GEMM on g, Cout channels in, Cin out, no bias or moments
  return launch_mma<bf16, 1>(g, w2, nullptr, dx, nullptr, nullptr, nullptr, nullptr, M, cout,
                             cin, H, W, 0, st);
}

// The fp32 backward after split_dx_weight_kernel (which set flags[0] =
// flags[1] = 0, or 1 beyond 2^31 rows). Up to 2^31 rows: the g pass writes
// g's planes and db's partials and sets flags[1] if g is not finite, the
// pack copies x and sets flags[0] if x is not exact in bf16; then each
// pass launches both routes, and the one not chosen returns at once: dW on
// the tensor cores over g's planes if neither flag is set, else on the
// CUDA cores; dx on the tensor cores over the six plane products if
// flags[1] is clear, else on the CUDA cores. From 2^31 rows on, the CUDA
// cores alone (db's partials from the NCHW gy and y, no pack). tally:
// (dW tensor cores, dW CUDA cores, dx tensor cores, dx CUDA cores).
inline int launch_bwd_f32(const void* x, void* xcl, const void* w2, const float* w2_cc,
                          const void* y, const void* gy, const float* gs1, const float* gs2,
                          void* g, float* part_db, float* db, void* dx, float* part_dw,
                          float* dw, int* flags, int* tally, long long n_img, int cin, int cout,
                          int H, int W, int splits, int rows_per_split, int splits_cc,
                          long long rows_per_split_cc, int with_moments, int g_planes,
                          cudaStream_t st) {
  const long long M = n_img * H * W;
  const int HW = H * W;
  const bool tc = M <= 0x7fffffffLL;
  const Grad grad{static_cast<const float*>(gy), static_cast<const float*>(y), gs1, gs2,
                  with_moments};
  int rc = 0;
  if (tc) {
    rc = grad_out_cl<float>(gy, y, gs1, gs2, g, part_db, flags + 1, static_cast<int>(M), cout,
                            HW, with_moments, st);
  } else {
    grad_out_kernel<<<dim3(cdiv(M, kRedThreads), cout), kRedThreads, 0, st>>>(grad, part_db,
                                                                               n_img, cout, HW);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc != 0) return rc;
  rc = sum_partials(part_db, nullptr, db, nullptr, cdiv(M, kRedThreads), cout, st);
  if (rc != 0) return rc;
  if (tc) {
    rc = pack_cl<float>(x, xcl, flags, static_cast<int>(M), cin, HW, st);
    if (rc != 0) return rc;
    rc = launch_wgrad_mma<3>(g, xcl, part_dw, flags, tally, static_cast<int>(M), cin, cout, H,
                             W, splits, rows_per_split, st);
    if (rc != 0) return rc;
  }
  wgrad_kernel<<<dim3(cdiv(9 * cin, ::kBN), cdiv(cout, ::kBM), splits_cc), ::kThreads, 0, st>>>(
      grad, static_cast<const float*>(x), part_dw, flags, tally, n_img, cin, cout, H, W,
      rows_per_split_cc);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  rc = sum_splits(part_dw, dw, flags, cin, cout, splits, splits_cc, st);
  if (rc != 0 || dx == nullptr) return rc;
  // dx: the forward's GEMM on g, Cout channels in, Cin out, no bias or moments
  if (tc) {
    rc = launch_mma<float, 6>(g, w2, nullptr, dx, nullptr, nullptr, flags + 1, tally + 2,
                              static_cast<int>(M), cout, cin, H, W, g_planes, st);
    if (rc != 0) return rc;
  }
  return launch_conv(grad, w2_cc, nullptr, static_cast<float*>(dx), nullptr, nullptr,
                     flags + 1, tally + 2, n_img, cout, cin, H, W, st);
}

}  // namespace tc

}  // namespace

// Each entry point launches on `stream` (a cudaStream_t), allocates nothing
// and does not synchronise; `bf16` selects the storage type of x, the weight matrices,
// y, gy, dx: 0 fp32, 1 bf16. Cp = C rounded up to a multiple of 8. xcl is
// the (n_img * H * W, Cp_in) bf16 scratch for x's channels-last copy
// (fp32 from 2^31 rows on: unused, may be null). Each returns the first
// CUDA error of its launches, 0 if none.
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

// spike_conv_dx_weight_f32: the fp32 backward's w2 and w2_cc (below) from
// the contiguous OIHW fp32 weight w (cout, cin, 3, 3), both null for a
// backward without dx; w_planes the weight plane of each of the six dx
// terms, two bits a term, first term lowest. Sets flags[0] = flags[1] =
// force_cc, 1 for a call of 2^31 rows or more, else 0.
extern "C" int spike_conv_dx_weight_f32(const float* w, void* w2, float* w2_cc, int* flags,
                                        int cin, int cout, int w_planes, int force_cc,
                                        void* stream) {
  const long long n = w2 != nullptr ? 9LL * tc::padded(cin) * tc::padded(cout) : 1;
  tc::split_dx_weight_kernel<<<cdiv(n, kRedThreads), kRedThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      w, static_cast<tc::bf16*>(w2), w2_cc, flags, cin, cout, w_planes, force_cc);
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
// the tensor-core dx matrix, row tap * Cp_out + co of a block holding the
// flipped, transposed weight W[co, :, 8 - tap]: bf16 (9 * Cp_out, Cp_in),
// fp32 six blocks of bf16 planes, (6 * 9 * Cp_out, Cp_in) (from
// spike_conv_dx_weight_f32); w2_cc (fp32 only) the CUDA cores' (cout * 9,
// cin) fp32 dx matrix, row co * 9 + tap; both read only with dx; y, gy
// (n_img, cout, H, W); gs1, gs2 (cout,) fp32, read only with
// `with_moments`; g bf16 scratch, (n_img * H * W, Cp_out), fp32 three of
// them one after the other (from 2^31 rows on: unused); part_db
// (ceil(n_img * H * W / 256), cout) fp32 scratch; db (cout,) fp32; dx
// (n_img, cin, H, W) or null (not computed); part_dw fp32 scratch of
// (splits, cout, 9 * Cp_in) (the tensor cores; split s covers rows [s *
// rows_per_split, (s + 1) * rows_per_split)) and, fp32, of (splits_cc,
// cout, cin * 9) (the CUDA cores, rows_per_split_cc); dw (cout, 9 * Cp_in)
// fp32, column tap * Cp_in + ci, 0 in the padding. fp32 only: flags two
// ints as spike_conv_dx_weight_f32 left them, set by the call (x not exact
// in bf16, g not finite), tally four ints to which the call adds one for
// each pass's route (dW tensor cores, dW CUDA cores, dx tensor cores, dx
// CUDA cores), and g_planes the g plane of each of the six dx terms, two
// bits a term, first term lowest.
extern "C" int spike_conv_bwd(const void* x, void* xcl, const void* w2, const float* w2_cc,
                              const void* y, const void* gy, const float* gs1,
                              const float* gs2, void* g, float* part_db, float* db, void* dx,
                              float* part_dw, float* dw, int* flags, int* tally,
                              long long n_img, int cin, int cout, int H, int W, int splits,
                              int rows_per_split, int splits_cc, long long rows_per_split_cc,
                              int with_moments, int g_planes, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (n_img * H * W > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    return tc::launch_bwd(x, xcl, w2, y, gy, gs1, gs2, g, part_db, db, dx, part_dw, dw,
                          static_cast<int>(n_img * H * W), cin, cout, H, W, splits,
                          rows_per_split, with_moments, st);
  }
  return tc::launch_bwd_f32(x, xcl, w2, w2_cc, y, gy, gs1, gs2, g, part_db, db, dx, part_dw,
                            dw, flags, tally, n_img, cin, cout, H, W, splits, rows_per_split,
                            splits_cc, rows_per_split_cc, with_moments, g_planes, st);
}
