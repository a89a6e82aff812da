// K2: the whole spiking-denoiser inference forward in one launch, for Hopper
// (sm_90a). fp32, bf16 or int8 weights share one templated body.
//
// Replaces the Pallas TPU kernel spiking_diffusion_tpu/ops/fused_denoiser.py
// `_make_kernel` / `kernel` (launched by the `pallas_call` of
// `make_fused_denoise_apply`). For each image it runs the T-step loop of the
// BN-folded denoiser:
//
//   s1 = LIF_1(a1)                       a1: the first conv's output, the
//                                        same current at every step
//   x  = LIF_l(conv3x3_l(x)), l = 2..L   3x3 SAME convs, BN folded in
//   acc += conv3x3_out(cat(x, s1))       skip concat, x first
//   logits = acc / T
//
// with the LIF step of ops/lif.py (decay_input / hard_reset branches, spike
// h >= v_th, membranes start at v_reset), every fp32 operation rounded on
// its own (built with --fmad=false).
//
// Each 3x3 conv is taken as three kernel-row products: for dy in (1, 0, 2)
// (centre, top, bottom) a partial sum over (dx, cin), then
//   fp32, bf16:  out = ((p1 + p0) + p2) + bias
//   int8:        out = ((p1 * s1 + p0 * s0) + p2 * s2) + bias
// with one dequant scale per kernel row and output channel. Spikes are
// exactly 0 or 1 and the weights are exact in fp32 (int8 values, bf16
// values), so every product is exact; in int8 every partial is an integer
// below 2^24 and so exact in fp32 in any order. The int8 logits therefore
// equal bitwise those of the plain version (ops/fused_denoiser.py
// `fused_denoise_reference`), which forms the same partials with fp32
// matrix products and combines them in the same order. fp32 and bf16
// partials are summed here in another order than cuBLAS's.
//
// What bounds it on an H100: operations. One call at batch 256 needs ~1.0
// TFLOP of useful multiply-adds against ~22 MB of device-memory traffic
// (a1 in, logits out, the weights once). This first version runs them on
// the fp32 CUDA cores (67 TFLOP/s), not the tensor cores, for all three
// weight types: products with a 0/1 spike are taken as fmaf, which is
// exact and equal to a separate multiply and add.
//
// What the design keeps on chip: one block per image. The spikes of the
// current and next layer, the first layer's spikes (for the skip) and a
// ring of two weight tiles live in shared memory as fp32 (~182 KB at the
// flagship widths, 64-128-256-512-256), so no spike train ever touches
// device memory. The membranes of the five layers (238 KB per image, more
// than a block's shared memory) live in a per-image scratch in device
// memory that stays in L2 (61 MB at batch 256). The only other device
// memory traffic is a1 in, the weights (read through L2 by every block)
// and the logits out. SAME padding: a tap outside the 7x7 grid reads a row
// of zeros in shared memory, so it never reaches another image.
//
// Thread layout of a conv: 8 warps x 32 lanes; warp w takes rows w, w+8,
// ..., (7 rows, 56 >= 49), lane l takes 4 output channels of a 128-wide
// tile, so a warp's spike reads are broadcasts and its weight reads 512
// contiguous bytes. Weight tiles of 16 (dx, cin) rows x 128 channels go
// through registers into a double buffer, one __syncthreads per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 7;           // rows per thread per pass
constexpr int kPassRows = kWarps * kRows;
constexpr int kCoTile = 128;       // output channels per tile (4 per lane)
constexpr int kKTile = 16;         // (dx, cin) rows per weight tile
constexpr int kTileElems = kKTile * kCoTile;
constexpr int kLoadsPerThread = kTileElems / kThreads;
constexpr int kMaxLayers = 8;
constexpr int kSmemLimit = 232448;  // bytes a block may use on an H100

struct Params {
  int n_layers;                 // LIF conv blocks, the first included
  int ch[kMaxLayers];           // their output channels
  int stride[kMaxLayers];       // spike row stride in shared memory
  int classes;                  // K, the readout's output channels
  int steps;                    // T
  int hw;                       // latent side
  int P;                        // hw * hw
  int v_per_image;              // P * sum(ch)
  const float* a1;              // (N, P, ch[0])
  const void* w[kMaxLayers];    // blocks 2..L, then the readout: (3, 3 Cin, Cout)
  const float* b[kMaxLayers];   // (1, Cout) bias, or (4, Cout) bias + 3 scales
  float* v;                     // (N, v_per_image) scratch
  float* logits;                // (N, P, K)
  float decay, v_th, v_reset;
  int decay_input, hard_reset;
  int off_zero, off_s1, off_buf[2], off_wt;  // shared-memory offsets (floats)
  int smem_floats;
};

struct Seg {      // one input of a conv: a spike buffer in shared memory
  int off;        // its offset (floats)
  int stride;     // its row stride (a multiple of kKTile)
  int c;          // its channels
  int wbase;      // its first channel in the conv's input
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ float lif(float& v, float x, const Params& p) {
  float h;
  if (p.decay_input) {
    h = v + (x - (v - p.v_reset)) * p.decay;
  } else {
    h = v - (v - p.v_reset) * p.decay + x;
  }
  const float s = h >= p.v_th ? 1.0f : 0.0f;
  if (p.hard_reset) {
    v = (1.0f - s) * h + s * p.v_reset;
  } else {
    v = h - s * p.v_th;
  }
  return s;
}

// One 3x3 SAME conv of the spikes in `segs` (concatenated on channels) with
// W (3, 3 * cin, cout). READOUT: add the result to `acc` (P, cout) in device
// memory; else apply the LIF step with membranes `v` (P, cout) and write the
// spikes to shared memory at `out_off` with row stride `out_stride`.
template <typename W, bool READOUT>
__device__ void conv3x3(const Params& p, float* sm, const Seg* segs, int nseg,
                        const W* __restrict__ w, const float* __restrict__ b,
                        int cin, int cout, bool int8_scales, float* v,
                        float* acc, int out_off, int out_stride) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hw = p.hw;
  int seg_tiles[2];
  int tiles_per_dx = 0;
  for (int s = 0; s < nseg; ++s) {
    seg_tiles[s] = segs[s].stride / kKTile;
    tiles_per_dx += seg_tiles[s];
  }
  const int tiles_per_dy = 3 * tiles_per_dx;
  const int n_tiles = 3 * tiles_per_dy;
  float* wt0 = sm + p.off_wt;

  for (int co0 = 0; co0 < cout; co0 += kCoTile) {
    for (int r0 = 0; r0 < p.P; r0 += kPassRows) {
      // tile i -> (kernel row, dx, input segment, first channel)
      auto decode = [&](int i, int& dy, int& dx, int& s, int& c0) {
        const int dyi = i / tiles_per_dy;
        dy = dyi == 0 ? 1 : (dyi == 1 ? 0 : 2);
        const int rem = i % tiles_per_dy;
        dx = rem / tiles_per_dx;
        int q = rem % tiles_per_dx;
        s = 0;
        if (q >= seg_tiles[0]) {
          q -= seg_tiles[0];
          s = 1;
        }
        c0 = q * kKTile;
      };
      W pre[kLoadsPerThread];
      auto fetch = [&](int i) {
        int dy, dx, s, c0;
        decode(i, dy, dx, s, c0);
#pragma unroll
        for (int m = 0; m < kLoadsPerThread; ++m) {
          const int e = tid + m * kThreads;
          const int c = c0 + e / kCoTile;
          const int co = co0 + e % kCoTile;
          W val{};
          if (c < segs[s].c && co < cout) {
            const long long row = static_cast<long long>(dy) * 3 * cin +
                                  static_cast<long long>(dx) * cin + segs[s].wbase + c;
            val = w[row * cout + co];
          }
          pre[m] = val;
        }
      };
      auto stash = [&](int i) {
        float* wt = wt0 + (i & 1) * kTileElems;
#pragma unroll
        for (int m = 0; m < kLoadsPerThread; ++m) {
          wt[tid + m * kThreads] = to_float(pre[m]);
        }
      };

      fetch(0);
      stash(0);
      __syncthreads();

      float out[kRows][4];
      float part[kRows][4];
      int base[kRows];
      for (int i = 0; i < n_tiles; ++i) {
        int dy, dx, s, c0;
        decode(i, dy, dx, s, c0);
        if (i + 1 < n_tiles) fetch(i + 1);
        if (c0 == 0) {
          // a new (dy, dx, segment): the source row of each of my rows, or
          // the zero row where the tap falls outside the grid
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int r = r0 + warp + kWarps * j;
            base[j] = p.off_zero;
            if (r < p.P) {
              const int y = r / hw + dy - 1;
              const int x = r % hw + dx - 1;
              if (y >= 0 && y < hw && x >= 0 && x < hw) {
                base[j] = segs[s].off + (y * hw + x) * segs[s].stride;
              }
            }
          }
        }
        if (i % tiles_per_dy == 0) {
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) part[j][c] = 0.0f;
          }
        }
        const float* wt = wt0 + (i & 1) * kTileElems + lane * 4;
#pragma unroll
        for (int k4 = 0; k4 < kKTile; k4 += 4) {
          float4 wk[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            wk[q] = *reinterpret_cast<const float4*>(wt + (k4 + q) * kCoTile);
          }
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const float4 sp = *reinterpret_cast<const float4*>(sm + base[j] + c0 + k4);
            const float sv[4] = {sp.x, sp.y, sp.z, sp.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              part[j][0] = fmaf(sv[q], wk[q].x, part[j][0]);
              part[j][1] = fmaf(sv[q], wk[q].y, part[j][1]);
              part[j][2] = fmaf(sv[q], wk[q].z, part[j][2]);
              part[j][3] = fmaf(sv[q], wk[q].w, part[j][3]);
            }
          }
        }
        if ((i + 1) % tiles_per_dy == 0) {
          // the kernel row is complete: fold it into the output in the
          // order centre, top, bottom
          const int dyi = i / tiles_per_dy;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int co = co0 + lane * 4 + c;
            const float sc = (int8_scales && co < cout) ? b[(1 + dy) * cout + co] : 1.0f;
#pragma unroll
            for (int j = 0; j < kRows; ++j) {
              const float pj = int8_scales ? part[j][c] * sc : part[j][c];
              out[j][c] = dyi == 0 ? pj : out[j][c] + pj;
            }
          }
        }
        if (i + 1 < n_tiles) stash(i + 1);
        __syncthreads();
      }

#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = r0 + warp + kWarps * j;
        if (r >= p.P) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int co = co0 + lane * 4 + c;
          if (co >= cout) continue;
          const float z = out[j][c] + b[co];
          if (READOUT) {
            acc[r * cout + co] = acc[r * cout + co] + z;
          } else {
            float vm = v[r * cout + co];
            const float spike = lif(vm, z, p);
            v[r * cout + co] = vm;
            sm[out_off + r * out_stride + co] = spike;
          }
        }
      }
    }
  }
  __syncthreads();
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 1)
fused_denoiser_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = p.n_layers;
  const int P = p.P;
  const int K = p.classes;
  float* v_img = p.v + static_cast<long long>(n) * p.v_per_image;
  float* acc = p.logits + static_cast<long long>(n) * P * K;
  const float* a1 = p.a1 + static_cast<long long>(n) * P * p.ch[0];
  const bool int8_scales = sizeof(W) == 1;

  for (int i = tid; i < p.smem_floats; i += kThreads) sm[i] = 0.0f;
  for (int i = tid; i < p.v_per_image; i += kThreads) v_img[i] = p.v_reset;
  for (int i = tid; i < P * K; i += kThreads) acc[i] = 0.0f;
  __syncthreads();

  for (int t = 0; t < p.steps; ++t) {
    const int c0 = p.ch[0];
    for (int i = tid; i < P * c0; i += kThreads) {
      float vm = v_img[i];
      const float spike = lif(vm, a1[i], p);
      v_img[i] = vm;
      sm[p.off_s1 + (i / c0) * p.stride[0] + i % c0] = spike;
    }
    __syncthreads();
    Seg in = {p.off_s1, p.stride[0], c0, 0};
    long long v_off = static_cast<long long>(P) * c0;
    for (int l = 1; l < L; ++l) {
      const int out_off = p.off_buf[(l - 1) & 1];
      conv3x3<W, false>(p, sm, &in, 1, static_cast<const W*>(p.w[l - 1]),
                        p.b[l - 1], p.ch[l - 1], p.ch[l], int8_scales,
                        v_img + v_off, nullptr, out_off, p.stride[l]);
      v_off += static_cast<long long>(P) * p.ch[l];
      in = Seg{out_off, p.stride[l], p.ch[l], 0};
    }
    Seg cat[2] = {in, Seg{p.off_s1, p.stride[0], c0, p.ch[L - 1]}};
    conv3x3<W, true>(p, sm, cat, 2, static_cast<const W*>(p.w[L - 1]),
                     p.b[L - 1], p.ch[L - 1] + c0, K, int8_scales, nullptr,
                     acc, 0, 0);
  }
  const float steps = static_cast<float>(p.steps);
  for (int i = tid; i < P * K; i += kThreads) acc[i] = acc[i] / steps;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <typename W>
int launch(Params p, int n_images, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(p.smem_floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_denoiser_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_denoiser_kernel<W><<<n_images, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one block per image on `stream` (a cudaStream_t); allocates
// nothing and does not synchronise. wtype: 0 fp32, 1 bf16, 2 int8 weights.
// w_ptrs / b_ptrs: device pointers of the n_layers weights and bias packs
// (blocks 2..L, then the readout). Returns cudaGetLastError() after the
// launch, or -1 for arguments it does not take and -2 when the shared
// memory exceeds what a block may use.
extern "C" int fused_denoiser_fwd(int wtype, int n_images, int hw, int n_layers,
                                  const int* channels, int classes, int steps,
                                  const float* a1, const long long* w_ptrs,
                                  const long long* b_ptrs, float* v_scratch,
                                  float* logits, float decay, float v_th,
                                  float v_reset, int decay_input, int hard_reset,
                                  void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || n_images < 1 || hw < 1 ||
      classes < 1 || steps < 1) {
    return -1;
  }
  Params p = {};
  p.n_layers = n_layers;
  p.classes = classes;
  p.steps = steps;
  p.hw = hw;
  p.P = hw * hw;
  int sum_ch = 0, buf[2] = {0, 0}, max_stride = 0;
  for (int l = 0; l < n_layers; ++l) {
    if (channels[l] < 1) return -1;
    p.ch[l] = channels[l];
    p.stride[l] = round_up(channels[l], kKTile);
    sum_ch += channels[l];
    max_stride = p.stride[l] > max_stride ? p.stride[l] : max_stride;
    if (l > 0) buf[(l - 1) & 1] = p.stride[l] > buf[(l - 1) & 1] ? p.stride[l] : buf[(l - 1) & 1];
    p.w[l] = reinterpret_cast<const void*>(w_ptrs[l]);
    p.b[l] = reinterpret_cast<const float*>(b_ptrs[l]);
  }
  p.v_per_image = p.P * sum_ch;
  p.a1 = a1;
  p.v = v_scratch;
  p.logits = logits;
  p.decay = decay;
  p.v_th = v_th;
  p.v_reset = v_reset;
  p.decay_input = decay_input;
  p.hard_reset = hard_reset;
  p.off_zero = 0;
  p.off_s1 = max_stride;
  p.off_buf[0] = p.off_s1 + p.P * p.stride[0];
  p.off_buf[1] = p.off_buf[0] + p.P * buf[0];
  p.off_wt = p.off_buf[1] + p.P * buf[1];
  p.smem_floats = p.off_wt + 2 * kTileElems;
  if (p.smem_floats * 4LL > kSmemLimit) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wtype) {
    case 0: return launch<float>(p, n_images, s);
    case 1: return launch<__nv_bfloat16>(p, n_images, s);
    case 2: return launch<int8_t>(p, n_images, s);
    default: return -1;
  }
}
