// K2: the spiking-denoiser inference forward of the fused sampler, for Hopper
// (sm_90a). fp32, bf16 or int8 weights share one tensor-core body.
//
// Replaces the Pallas TPU kernel spiking_diffusion_tpu/ops/fused_denoiser.py
// `_make_kernel` / `kernel` (launched by the `pallas_call` of
// `make_fused_denoise_apply`). It computes, for every image, the T-step loop
// of the BN-folded denoiser:
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
// Layer by layer, not step by step. Layer l at step t reads only layer l-1's
// spikes at step t and its own membrane from step t-1, so the conv of a
// layer runs for all T steps at once, once the layer below has, and the
// LIF recurrence then runs per neuron over t. Each conv is one implicit
// GEMM over M = N * P * T rows (P = hw * hw), ordered (n, p, t) with t
// fastest, on the tensor-core loop of mma_loop.cuh (128 x 128 block tiles,
// `mma.sync.m16n8k16` bf16 -> fp32). The launches of one call:
//   lif1_kernel        s1 for every t from a1;
//   conv_lif_kernel    one per block 2..L: the conv, then in its epilogue
//                      the LIF scan over t of each (position, channel);
//   readout_kernel     the readout conv, then in its epilogue the sum over
//                      t in order, times 1 / T.
//
// Spikes live in device memory as bf16 (0 or 1, exact), channels-last,
// each layer's channels padded to a multiple of 8 (zero), so a tap's 8
// channels are one 16-byte `cp.async`. The neighbour of row (n, p, t)
// under a tap is row ((n * P + p') * T + t); a tap off the 7x7 grid, or a
// row past M, is a zero-filled copy, so no row reads another image. One
// concat buffer holds (x_L | s1), x first as in the skip concat, so the
// readout reads one operand and block 2 reads s1 through a channel offset
// and the buffer's row stride; two ping-pong buffers hold blocks 2..L-1.
//
// The weights, per conv, are one bf16 matrix B (3 * Kr, Np): its kernel
// rows in the order dy = 1, 0, 2 (centre, top, bottom), each a range of
// Kr rows, Kr = planes * 3 * Cp_in rounded up to whole 64-deep stages
// (zero below), row plane * 3 * Cp_in + dx * Cp_in + ci within it. fp32
// weights are three bf16 planes whose fp32 sum is the weight (smallest
// first); bf16 weights one plane; int8 weights one plane of their integer
// values (exact in bf16), with one scale per kernel row and output channel
// or one per output channel. An int8 sampler's readout may be bf16 (JAX's
// SD_INT8_LOGITS=bf16): its layers then run conv_lif_kernel<int8_t> and
// the readout readout_kernel<bf16>. Spikes are 0 or 1, so every product is
// exact in fp32. The loop's hook folds each kernel row's sum into `out` at
// the row's last stage and zeroes the accumulators:
//   fp32, bf16:        out = ((p1 + p0) + p2) + bias
//   int8, row scales:  out = ((p1 * s1 + p0 * s0) + p2 * s2) + bias
//   int8, cout scale:  out = ((p1 + p0) + p2) * s + bias
// the order of the plain version (ops/fused_denoiser.py `_conv_rows`). In
// int8 a kernel row's sum is an integer below 3 * 512 * 127 < 2^24, and the
// three rows' below 9 * 512 * 127 < 2^24, exact in fp32 in any order, so
// the int8 logits equal the plain version's bitwise (JAX's cout order:
// the int32 sum, then one dequant). fp32 and bf16 sums within a kernel row
// run in the tensor cores' order, not cuBLAS's.
//
// JAX's roofline ablations (SD_FUSED_ABLATE), whose output is wrong on
// purpose: `nolif` (Lif::nolif) spikes where z >= v_th and carries no
// membrane, in lif1_kernel and every block's epilogue; `noshift` (the
// kNoShift instances) reads every tap's A rows at the row's own (y, x),
// with no halo and no bounds mask, the partials combined as above.
//
// The row tile holds whole T sequences: floor(128 / T) positions of T rows
// (8 x 16 at T = 16; T <= 128). After the loop the ring is drained, and the
// epilogue stages z = out + bias as an fp32 tile there; each thread then
// scans whole (position, channel) sequences, t = 0..T-1.
//
// What bounds it on an H100: operations. One call at batch 256 needs ~1.0
// TFLOP of useful multiply-adds (1.24 padded; fp32 three times that in
// bf16 products) against ~0.9 GB of spike traffic. `out` and the
// accumulators take 128 registers a thread, so one block runs per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_loop.cuh"

namespace {

using tc::bf16;

constexpr int kMaxLayers = 8;
constexpr int kMaxSteps = tc::kBM;  // a row tile holds at least one sequence
constexpr int kZLd = tc::kBN + 8;   // row stride (floats) of the staged z tile
static_assert(tc::kBM * kZLd * 4 <= tc::smem_bytes(false), "z tile fits the ring");

struct Lif {
  float decay, v_th, v_reset;
  int decay_input, hard_reset;
  int nolif;  // the roofline ablation: threshold-only spikes, no membrane
};

__device__ __forceinline__ float lif(float& v, float x, const Lif& p) {
  if (p.nolif) return x >= p.v_th ? 1.0f : 0.0f;
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

// The row geometry shared by every launch of a call.
struct Rows {
  int M;      // N * P * T
  int T;      // steps
  int hw;     // latent side
  int P;      // hw * hw
  int G;      // positions per row tile: floor(kBM / T)
};

// One conv: its spike operand and weights, and where its output goes.
struct Conv {
  const bf16* src;  // the operand's first channel in row 0
  int src_ld;       // the operand buffer's row stride (elements)
  int cp;           // the operand's channels (padded)
  const bf16* w;    // B, (3 * kr, np)
  int kr;           // rows of one kernel row's range
  const float* b;   // (1, cout) bias, (4, cout) bias + 3 scales, or (2, cout) bias + 1
  int row_scales;   // an int8 weight's scales: 1 one per kernel row, 0 one per cout
  int cout;
  int np;           // padded(cout)
  bf16* dst;        // conv_lif: the output's first channel in row 0
  int dst_ld;       // its buffer's row stride
  float* logits;    // readout: (N, P, cout)
};

// Weight planes of W: an fp32 weight is three bf16 planes.
template <typename W>
constexpr int kPlanes = 1;
template <>
constexpr int kPlanes<float> = 3;

// The conv of `c` over the block's tile: rows m0.. (row tile blockIdx.x /
// tiles_n, whole T sequences), columns n0.. (column tile blockIdx.x %
// tiles_n). Leaves z = conv + bias, fp32, in the drained ring as a
// [row][kZLd] tile and returns it. kNoShift: every tap reads the row's own
// position (the roofline ablation).
template <typename W, bool kNoShift>
__device__ __forceinline__ float* conv_tile(unsigned char* smem_raw, const Conv& c,
                                            const Rows& g, int& m0, int& n0) {
  using namespace tc;
  const int tiles_n = (c.np + kBN - 1) / kBN;
  const int m_tile = blockIdx.x / tiles_n;
  n0 = (blockIdx.x - m_tile * tiles_n) * kBN;
  m0 = m_tile * g.G * g.T;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int rows_tile = g.G * g.T;
  const int spr = c.kr / kBK;  // stages per kernel row

  // A: rows a_row + r * (kThreads / kRowChunks), columns a_c.. of the stage
  const int a_c = (tid % kRowChunks) * 8;
  const int a_row = tid / kRowChunks;
  int a_base[kRowPasses], a_y[kRowPasses], a_x[kRowPasses];
  bool a_ok[kRowPasses];
#pragma unroll
  for (int r = 0; r < kRowPasses; ++r) {
    const int lr = a_row + r * (kThreads / kRowChunks);
    const int m = m0 + lr;
    a_ok[r] = lr < rows_tile && m < g.M;
    const int pos = a_ok[r] ? m / g.T : 0;
    const int t = a_ok[r] ? m - pos * g.T : 0;
    const int img = pos / g.P;
    const int p = pos - img * g.P;
    a_base[r] = img * g.P * g.T + t;  // row of position 0 of the image at step t
    a_y[r] = p / g.hw;
    a_x[r] = p - a_y[r] * g.hw;
  }
  // B: k rows tid / kKChunks + r * (kThreads / kKChunks), columns b_c..
  const int b_c = (tid % kKChunks) * 8;
  const bool b_col_ok = n0 + b_c < c.np;

  // the A columns' (plane * 3 + dx, ci) of the stage's column a_c within the
  // kernel row dyi, stepped by kBK a stage
  int dyi = 0, s_row = 0, ptap = 0, ci = a_c;
  while (ci >= c.cp) {
    ci -= c.cp;
    ++ptap;
  }
  auto load = [&](bf16* As, bf16* Bs, int s) {
    const int dy = dyi == 0 ? 1 : (dyi == 1 ? 0 : 2);
    const bool k_ok = ptap < 3 * kPlanes<W>;
    const int dx = ptap % 3;
#pragma unroll
    for (int r = 0; r < kRowPasses; ++r) {
      const int yy = kNoShift ? a_y[r] : a_y[r] + dy - 1;
      const int xx = kNoShift ? a_x[r] : a_x[r] + dx - 1;
      const bool ok = k_ok && a_ok[r] &&
                      (kNoShift || (yy >= 0 && yy < g.hw && xx >= 0 && xx < g.hw));
      const bf16* from =
          ok ? c.src + static_cast<long long>(a_base[r] + (yy * g.hw + xx) * g.T) * c.src_ld + ci
             : c.src;
      cp_async16(As + (a_row + r * (kThreads / kRowChunks)) * kLdRow + a_c, from, ok);
    }
    if (++s_row == spr) {
      s_row = 0;
      ++dyi;
      ptap = 0;
      ci = a_c;
    } else {
      ci += kBK;
    }
    while (ci >= c.cp) {
      ci -= c.cp;
      ++ptap;
    }
#pragma unroll
    for (int r = 0; r < kKPasses; ++r) {
      const int kr = tid / kKChunks + r * (kThreads / kKChunks);
      const long long kb = static_cast<long long>(s) * kBK + kr;
      const bf16* from = b_col_ok ? c.w + kb * c.np + n0 + b_c : c.w;
      cp_async16(Bs + kr * kLdK + b_c, from, b_col_ok);
    }
  };

  // Element e of acc[i][j] lies at row 16 i + lane / 4 + 8 (e / 2), column
  // 8 j + 2 (lane % 4) + e % 2 of the warp's 64 x 32 tile.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  float out[4][4][4];
  int h_row = 0, h_dyi = 0;
  const bool row_scales = sizeof(W) == 1 && c.row_scales;
  auto fold = [&](int, float (&acc)[4][4][4]) {
    if (++h_row < spr) return;
    h_row = 0;
    const int dy = h_dyi == 0 ? 1 : (h_dyi == 1 ? 0 : 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int co = n0 + wn * 32 + j * 8 + 2 * (lane & 3) + e;
        float sc = 1.0f;
        if (row_scales && co < c.cout) sc = c.b[(1 + dy) * c.cout + co];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float pj = acc[i][j][half * 2 + e];
            if (row_scales) pj = pj * sc;
            out[i][j][half * 2 + e] = h_dyi == 0 ? pj : out[i][j][half * 2 + e] + pj;
            acc[i][j][half * 2 + e] = 0.0f;
          }
        }
      }
    }
    ++h_dyi;
  };
  float acc[4][4][4];
  mainloop<false>(smem, 3 * spr, load, acc, fold);

  float* zs = reinterpret_cast<float*>(smem_raw);
  const bool cout_scale = sizeof(W) == 1 && !c.row_scales;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + j * 8 + 2 * (lane & 3);
    const int co = n0 + col;
    const float b0 = co < c.cout ? c.b[co] : 0.0f;
    const float b1 = co + 1 < c.cout ? c.b[co + 1] : 0.0f;
    const float s0 = cout_scale && co < c.cout ? c.b[c.cout + co] : 0.0f;
    const float s1 = cout_scale && co + 1 < c.cout ? c.b[c.cout + co + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 64 + i * 16 + (lane >> 2) + half * 8;
        float z0 = out[i][j][half * 2];
        float z1 = out[i][j][half * 2 + 1];
        if (cout_scale) {  // the exact integer sum, then its one dequant
          z0 = z0 * s0;
          z1 = z1 * s1;
        }
        *reinterpret_cast<float2*>(zs + row * kZLd + col) = make_float2(z0 + b0, z1 + b1);
      }
    }
  }
  __syncthreads();
  return zs;
}

// A LIF conv block over all T steps: the conv, then each thread scans whole
// (position, channel) sequences of the tile from v_reset and writes the
// spikes (and zeros in the padding channels up to np) to c.dst.
template <typename W, bool kNoShift>
__global__ void __launch_bounds__(tc::kThreads, 1)
conv_lif_kernel(const Conv c, const Rows g, const Lif lp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int m0, n0;
  const float* zs = conv_tile<W, kNoShift>(smem_raw, c, g, m0, n0);
  for (int q = threadIdx.x; q < g.G * tc::kBN; q += tc::kThreads) {
    const int gi = q / tc::kBN;
    const int col = q - gi * tc::kBN;
    const int co = n0 + col;
    const int m = m0 + gi * g.T;  // the sequence's first row
    if (m >= g.M || co >= c.np) continue;
    bf16* d = c.dst + static_cast<long long>(m) * c.dst_ld + co;
    const float* z = zs + gi * g.T * kZLd + col;
    float v = lp.v_reset;
    for (int t = 0; t < g.T; ++t) {
      const float s = co < c.cout ? lif(v, z[t * kZLd], lp) : 0.0f;
      d[static_cast<long long>(t) * c.dst_ld] = __float2bfloat16(s);
    }
  }
}

// The readout conv over all T steps: each thread sums whole (position,
// class) sequences of the tile in t order from 0 and writes the sum times
// the fp32 reciprocal of T, which is how PyTorch's CUDA division by a
// scalar computes the plain version's acc / T (the same as dividing when T
// is a power of two).
template <typename W, bool kNoShift>
__global__ void __launch_bounds__(tc::kThreads, 1)
readout_kernel(const Conv c, const Rows g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int m0, n0;
  const float* zs = conv_tile<W, kNoShift>(smem_raw, c, g, m0, n0);
  const float inv_steps = 1.0f / static_cast<float>(g.T);
  for (int q = threadIdx.x; q < g.G * tc::kBN; q += tc::kThreads) {
    const int gi = q / tc::kBN;
    const int col = q - gi * tc::kBN;
    const int co = n0 + col;
    const int m = m0 + gi * g.T;
    if (m >= g.M || co >= c.cout) continue;
    const float* z = zs + gi * g.T * kZLd + col;
    float acc = 0.0f;
    for (int t = 0; t < g.T; ++t) acc = acc + z[t * kZLd];
    c.logits[static_cast<long long>(m / g.T) * c.cout + co] = acc * inv_steps;
  }
}

// s1 at every step from the constant current a1 (n_pos, c1): one thread
// per (position, padded channel), writing T rows of dst (zeros in the
// padding channels).
__global__ void __launch_bounds__(256)
lif1_kernel(const float* __restrict__ a1, bf16* __restrict__ dst, int dst_ld, int n_pos,
            int c1, int cp1, int T, const Lif lp) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(n_pos) * cp1) return;
  const int pos = static_cast<int>(e / cp1);
  const int ch = static_cast<int>(e - static_cast<long long>(pos) * cp1);
  bf16* d = dst + static_cast<long long>(pos) * T * dst_ld + ch;
  const float x = ch < c1 ? a1[static_cast<long long>(pos) * c1 + ch] : 0.0f;
  float v = lp.v_reset;
  for (int t = 0; t < T; ++t) {
    const float s = ch < c1 ? lif(v, x, lp) : 0.0f;
    d[static_cast<long long>(t) * dst_ld] = __float2bfloat16(s);
  }
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// W: the layers' weights, RW: the readout's; kNoShift: the ablation.
template <typename W, typename RW, bool kNoShift>
int launch(const Rows& g, int n_layers, const int* ch, int classes, int row_scales,
           const float* a1, const long long* w_ptrs, const long long* b_ptrs, bf16* cat,
           bf16* ping, bf16* pong, float* logits, const Lif& lp, cudaStream_t st) {
  const int bytes = tc::smem_bytes(false);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      conv_lif_kernel<W, kNoShift>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  rc = static_cast<int>(cudaFuncSetAttribute(
      readout_kernel<RW, kNoShift>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (rc != 0) return rc;
  const int L = n_layers;
  const int cp1 = tc::padded(ch[0]);
  const int cpL = tc::padded(ch[L - 1]);
  const int cat_ld = cpL + cp1;
  const int n_pos = g.M / g.T;
  const long long n1 = static_cast<long long>(n_pos) * cp1;
  lif1_kernel<<<static_cast<unsigned>((n1 + 255) / 256), 256, 0, st>>>(
      a1, cat + cpL, cat_ld, n_pos, ch[0], cp1, g.T, lp);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const unsigned tiles_m = static_cast<unsigned>((n_pos + g.G - 1) / g.G);
  bf16* bufs[2] = {ping, pong};
  for (int i = 0; i <= L - 1; ++i) {
    const bool readout = i == L - 1;
    Conv c = {};
    if (i == 0) {
      c.src = cat + cpL;
      c.src_ld = cat_ld;
      c.cp = cp1;
    } else if (readout) {
      c.src = cat;
      c.src_ld = cat_ld;
      c.cp = cat_ld;
    } else {
      c.src = bufs[(i - 1) & 1];
      c.src_ld = c.cp = tc::padded(ch[i]);
    }
    c.w = reinterpret_cast<const bf16*>(w_ptrs[i]);
    c.kr = round_up((readout ? kPlanes<RW> : kPlanes<W>) * 3 * c.cp, tc::kBK);
    c.b = reinterpret_cast<const float*>(b_ptrs[i]);
    c.row_scales = row_scales;
    c.cout = readout ? classes : ch[i + 1];
    c.np = tc::padded(c.cout);
    const unsigned blocks = tiles_m * static_cast<unsigned>((c.np + tc::kBN - 1) / tc::kBN);
    if (readout) {
      c.logits = logits;
      readout_kernel<RW, kNoShift><<<blocks, tc::kThreads, bytes, st>>>(c, g);
    } else {
      if (i == L - 2) {
        c.dst = cat;
        c.dst_ld = cat_ld;
      } else {
        c.dst = bufs[i & 1];
        c.dst_ld = c.np;
      }
      conv_lif_kernel<W, kNoShift><<<blocks, tc::kThreads, bytes, st>>>(c, g, lp);
    }
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return 0;
}

template <bool kNoShift>
int launch_types(int wtype, int readout_wtype, const Rows& g, int n_layers, const int* ch,
                 int classes, int row_scales, const float* a1, const long long* w_ptrs,
                 const long long* b_ptrs, bf16* cat, bf16* ping, bf16* pong, float* logits,
                 const Lif& lp, cudaStream_t st) {
  if (wtype == 0 && readout_wtype == 0) {
    return launch<float, float, kNoShift>(g, n_layers, ch, classes, row_scales, a1, w_ptrs,
                                          b_ptrs, cat, ping, pong, logits, lp, st);
  }
  if (wtype == 1 && readout_wtype == 1) {
    return launch<bf16, bf16, kNoShift>(g, n_layers, ch, classes, row_scales, a1, w_ptrs,
                                        b_ptrs, cat, ping, pong, logits, lp, st);
  }
  if (wtype == 2 && readout_wtype == 2) {
    return launch<int8_t, int8_t, kNoShift>(g, n_layers, ch, classes, row_scales, a1, w_ptrs,
                                            b_ptrs, cat, ping, pong, logits, lp, st);
  }
  if (wtype == 2 && readout_wtype == 1) {
    return launch<int8_t, bf16, kNoShift>(g, n_layers, ch, classes, row_scales, a1, w_ptrs,
                                          b_ptrs, cat, ping, pong, logits, lp, st);
  }
  return -1;
}

}  // namespace

// Launches K2's L + 1 kernels on `stream` (a cudaStream_t); allocates
// nothing and does not synchronise. wtype: 0 fp32, 1 bf16, 2 int8 weights
// of the L - 1 blocks; readout_wtype the readout's, wtype's but for an int8
// sampler's bf16 readout (2, 1). row_scales: int8 scales one per kernel
// row (1) or per output channel (0). ablate: bit 1 nolif, bit 2 noshift.
// channels: the n_layers LIF conv blocks' output channels, the first
// included; Cp(c) = c rounded up to a multiple of 8. a1 (N, P, ch[0]) fp32.
// w_ptrs: device pointers of the n_layers bf16 matrices B (blocks 2..L,
// then the readout), each (3 * Kr, Cp(cout)), Kr = planes * 3 * Cp_in
// rounded up to a multiple of 64, planes 3 for fp32 and 1 otherwise, Cp_in
// = Cp(ch[i]) for block i + 2 and Cp(ch[L-1]) + Cp(ch[0]) for the readout,
// whose input channels are laid out as (x_L | s1), each part padded.
// b_ptrs: the (1, cout) fp32 biases, int8 (4, cout): bias, then the
// scales of kernel rows dy = 0, 1, 2, or (2, cout): bias, then the scale
// of the output channel. cat: bf16 (N * P * T, Cp(ch[L-1]) +
// Cp(ch[0])); ping, pong: bf16 scratch of N * P * T * Cp(ch[i + 1])
// elements for blocks i + 2 = 2, 4, .. (ping) and 3, 5, .. (pong) below L;
// logits (N, P, classes) fp32. Returns the first cudaGetLastError() of the
// launches, or -1 for arguments it does not take (T > 128, N * P * T of
// 2^31 or more).
extern "C" int fused_denoiser_fwd(int wtype, int readout_wtype, int row_scales, int ablate,
                                  int n_images, int hw, int n_layers,
                                  const int* channels, int classes, int steps,
                                  const float* a1, const long long* w_ptrs,
                                  const long long* b_ptrs, void* cat, void* ping, void* pong,
                                  float* logits, float decay, float v_th, float v_reset,
                                  int decay_input, int hard_reset, void* stream) {
  if (n_layers < 2 || n_layers > kMaxLayers || n_images < 1 || hw < 1 || classes < 1 ||
      steps < 1 || steps > kMaxSteps) {
    return -1;
  }
  for (int l = 0; l < n_layers; ++l) {
    if (channels[l] < 1) return -1;
  }
  const long long rows = static_cast<long long>(n_images) * hw * hw * steps;
  if (rows > 0x7fffffffLL) return -1;
  const Rows g = {static_cast<int>(rows), steps, hw, hw * hw, tc::kBM / steps};
  if (ablate < 0 || ablate > 3) return -1;
  const Lif lp = {decay, v_th, v_reset, decay_input, hard_reset, ablate & 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* c = static_cast<bf16*>(cat);
  bf16* p0 = static_cast<bf16*>(ping);
  bf16* p1 = static_cast<bf16*>(pong);
  if (ablate & 2) {
    return launch_types<true>(wtype, readout_wtype, g, n_layers, channels, classes, row_scales,
                              a1, w_ptrs, b_ptrs, c, p0, p1, logits, lp, st);
  }
  return launch_types<false>(wtype, readout_wtype, g, n_layers, channels, classes, row_scales,
                             a1, w_ptrs, b_ptrs, c, p0, p1, logits, lp, st);
}
