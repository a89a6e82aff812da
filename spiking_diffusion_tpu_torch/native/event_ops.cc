// Native data-path kernels for the host side of the pipeline.
//
// The card runs the model; these C++ loops cover the host-side hot loops
// that are pathologically slow in numpy:
//
//   * event-stream -> frame integration (np.add.at is a serial scatter
//     with huge interpreter overhead; this is the per-sample hot loop of
//     every neuromorphic dataset, spikingjelly/datasets/)
//   * IDX batch decode: uint8 image bytes -> normalized float32 with an
//     index gather (the shuffle+decode inner loop of the data loader)
//   * spike bit-pack/unpack (host-side mirror of ops/bitpack.py)
//
// Built with plain g++ at first use (spiking_diffusion_tpu_torch/native);
// bound via ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// events (t,x,y,p int64 arrays, n entries) -> frames (F,H,W,2) float32,
// split by equal time bins. Returns 0 on success.
int integrate_events_time(
    const int64_t* t, const int64_t* x, const int64_t* y, const int64_t* p,
    int64_t n, int64_t H, int64_t W, int64_t F, float* frames /*zeroed*/) {
  if (n <= 0) return 0;
  const int64_t t0 = t[0];
  int64_t span = t[n - 1] - t0;
  if (span < 1) span = 1;
  const int64_t strideF = H * W * 2;
  for (int64_t i = 0; i < n; ++i) {
    // an event before t0 is out of bounds (integer division would round
    // its negative frame index toward zero)
    if (t[i] < t0 || x[i] < 0 || x[i] >= W || y[i] < 0 || y[i] >= H) return 1;
    int64_t f = ((t[i] - t0) * F) / (span + 1);
    if (f >= F) f = F - 1;
    const int64_t pol = p[i] ? 1 : 0;
    frames[f * strideF + (y[i] * W + x[i]) * 2 + pol] += 1.0f;
  }
  return 0;
}

// equal-event-count bins variant
int integrate_events_number(
    const int64_t* t, const int64_t* x, const int64_t* y, const int64_t* p,
    int64_t n, int64_t H, int64_t W, int64_t F, float* frames /*zeroed*/) {
  (void)t;
  if (n <= 0) return 0;
  const int64_t strideF = H * W * 2;
  for (int64_t i = 0; i < n; ++i) {
    int64_t f = (i * F) / n;
    if (f >= F) f = F - 1;
    if (x[i] < 0 || x[i] >= W || y[i] < 0 || y[i] >= H) return 1;
    const int64_t pol = p[i] ? 1 : 0;
    frames[f * strideF + (y[i] * W + x[i]) * 2 + pol] += 1.0f;
  }
  return 0;
}

// gather rows of uint8 images by index and normalize to [0,1] float32.
// images: (N, row_size) uint8; indices: (B,); out: (B, row_size) float32.
void decode_idx_batch(
    const uint8_t* images, const int64_t* indices, int64_t batch,
    int64_t row_size, float* out) {
  constexpr float kInv = 1.0f / 255.0f;
  for (int64_t b = 0; b < batch; ++b) {
    const uint8_t* src = images + indices[b] * row_size;
    float* dst = out + b * row_size;
    for (int64_t j = 0; j < row_size; ++j) dst[j] = src[j] * kInv;
  }
}

// pack n float spikes (0/1) LSB-first into ceil(n/8) bytes (zero-padded)
void pack_spikes_f32(const float* spikes, int64_t n, uint8_t* out) {
  const int64_t nbytes = (n + 7) / 8;
  std::memset(out, 0, static_cast<size_t>(nbytes));
  for (int64_t i = 0; i < n; ++i) {
    if (spikes[i] != 0.0f) out[i >> 3] |= static_cast<uint8_t>(1u << (i & 7));
  }
}

void unpack_spikes_f32(const uint8_t* packed, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = (packed[i >> 3] >> (i & 7)) & 1u ? 1.0f : 0.0f;
  }
}

}  // extern "C"
