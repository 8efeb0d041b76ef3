// W8A8 matmul for Hopper (sm_90a): int8 activations times symmetric 8-bit weights.
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_w8a8.py
// (_w8a8_call -> _w8a8_kernel). The activations arrive quantized per tensor
// (x_q int8 in [-127, 127], one float32 scale sx). The weights are
// symmetric: int8 with zero point 0, or uint8 with zero point 128, which the
// load shifts into int8 (u ^ 0x80 == u - 128 as a signed byte), as the
// reference's shift does. Each K tile of bk rows (the group for a group
// scale, all of K for a channel or tensor scale) is dotted fully in int32
// and then scaled once:
//     acc += float(x_q . w over the tile) * (sx * s_row).
// The reference cuts a whole-K tile into 512-row steps; that only changes
// float32 rounding, so the port keeps whole tiles. The epilogue uses rounded
// intrinsics in the plain version's order, so the two agree bit for bit.
//
// Shapes: x_q (M, K) int8; sx a float32 scalar on the device; w (K, N)
// int8/uint8; scale (K / bk, N) float32; out (M, N) float32.
//
// Grid and block as the other matmul kernels (common.cuh); the inner loop
// starts the loads of 16 weight rows of the thread's columns, then takes
// them four at a time, transposes them into one word per column and runs
// __dp4a against the staged x_q words.
// What bounds it on the card: for the Gemma-3-270M lm_head at decode (K =
// 640, N = 262144, M = 32) the 168 MB of weights and 33.5 MB of float32
// output would take ~60 us at 3.35 TB/s; the dp4a work (M multiply-adds
// per weight byte, on the CUDA cores) costs more. Tensor-core mma.sync /
// wgmma s8 tiles are the next step.

#include "common.cuh"

namespace {

using oqt::kBatch8;
using oqt::kChunk8;
using oqt::kRow8;
using oqt::kThreadsM;
using oqt::kThreadsN;

template <int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads)
w8a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx_ptr,
            const uint8_t* __restrict__ w, const float* __restrict__ scale,
            float* __restrict__ out, int M, int K, int N, int bk, uint32_t flip) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ __align__(16) int8_t xs[BM][kRow8];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const int n_tiles = K / bk;
  const float sx = *sx_ptr;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    int d[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) d[i][c] = 0;

    for (int r0 = 0; r0 < bk; r0 += kChunk8) {
      const int rc = min(kChunk8, bk - r0);
      __syncthreads();  // the previous chunk is consumed
      oqt::stage_rows_i8<BM>(xs, x, M, K, m0, t * bk + r0, rc, tid);
      __syncthreads();
      if (!col_ok) continue;
      const int words = (rc + 3) / 4;
      const uint8_t* wchunk = w + static_cast<size_t>(t * bk + r0) * N + col0;
      for (int j0 = 0; j0 < words; j0 += kBatch8) {
        // All loads of kBatch8 words first; rows past rc (and words past
        // `words`) meet x staged as zero, and their load is skipped.
        uint32_t rows[kBatch8][4];
#pragma unroll
        for (int b = 0; b < kBatch8; ++b)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = 4 * (j0 + b) + q;
            rows[b][q] =
                (r < rc ? oqt::load_bytes<CPT>(wchunk + static_cast<size_t>(r) * N) : 0u) ^ flip;
          }
#pragma unroll
        for (int b = 0; b < kBatch8; ++b) {
          uint32_t cols[4];
          oqt::transpose4x4(rows[b], cols);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const int xv = oqt::staged_word(xs[ty + i * kThreadsM], j0 + b);
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              d[i][c] = __dp4a(xv, static_cast<int>(cols[c]), d[i][c]);
          }
        }
      }
    }
    if (col_ok) {
      // Rounded operations in the plain version's order: bit-equal results.
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float s = __fmul_rn(sx, scale[static_cast<size_t>(t) * N + col0 + c]);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(static_cast<float>(d[i][c]), s));
      }
    }
  }

  if (!col_ok) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + i * kThreadsM;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[static_cast<size_t>(m) * N + col0 + c] = acc[i][c];
  }
}

template <int RPT, int CPT>
void launch(const void* x, const void* sx, const void* w, const void* s, void* out, int M, int K,
            int N, int bk, uint32_t flip, cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (M + BM - 1) / BM);
  const dim3 block(kThreadsN, kThreadsM);
  w8a8_kernel<RPT, CPT><<<grid, block, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(w), static_cast<const float*>(s), static_cast<float*>(out), M,
      K, N, bk, flip);
}

}  // namespace

// x: int8 (M, K); sx: one float32 on the device. is_signed: int8 weights (1)
// or uint8 with zero point 128 (0). cols4: 4 adjacent columns per thread
// (requires N % 4 == 0). Returns cudaGetLastError() after the launch.
extern "C" int oqt_w8a8_matmul(const void* x, const void* sx, const void* w, const void* scale,
                               void* out, int M, int K, int N, int bk, int is_signed, int cols4,
                               void* stream) {
  const uint32_t flip = is_signed ? 0u : 0x80808080u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 32) {
    if (cols4) launch<4, 4>(x, sx, w, scale, out, M, K, N, bk, flip, st);
    else launch<4, 1>(x, sx, w, scale, out, M, K, N, bk, flip, st);
  } else {
    if (cols4) launch<8, 4>(x, sx, w, scale, out, M, K, N, bk, flip, st);
    else launch<8, 1>(x, sx, w, scale, out, M, K, N, bk, flip, st);
  }
  return static_cast<int>(cudaGetLastError());
}
