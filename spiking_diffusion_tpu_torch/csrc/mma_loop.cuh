// The tensor-core inner loop of the port's implicit GEMMs, shared by K4
// (spike_conv.cu: forward, dx and dW) and K2 (fused_denoiser.cu: the
// denoiser's convs over all T steps).
//
// A 128 x 128 block tile contracted in 64-deep stages through a 3-stage
// `cp.async` ring, 8 warps of 64 x 32, fragments from `ldmatrix` (`.trans`
// for an operand stored contraction-major), `mma.sync.m16n8k16` bf16 ->
// fp32. The caller's loader fills each stage (16-byte copies, zero-filled
// where the operand has nothing), and an optional hook runs after each
// stage's products, so that a caller can fold the accumulators away at a
// boundary of the contraction and zero them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
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

// The hook of a caller that folds nothing: mainloop's default.
struct NoHook {
  __device__ __forceinline__ void operator()(int, float (&)[4][4][4]) const {}
};

// `steps` stages through the ring: load(A, B, s) issues stage s's copies
// (zero-filling what lies outside the operands), kStages - 1 stages ahead of
// the one multiplied, for s = 0, 1, 2, .. in turn (so a loader may step its
// own state). hook(s, acc) runs after stage s's products, in every thread.
// Leaves the ring drained and the block synchronised.
template <bool kATrans, typename Load, typename Hook = NoHook>
__device__ __forceinline__ void mainloop(bf16* smem, int steps, Load load,
                                         float (&acc)[4][4][4], Hook hook = Hook()) {
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
    hook(s, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace tc
}  // namespace
