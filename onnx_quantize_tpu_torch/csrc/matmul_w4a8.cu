// W4A8 matmul for Hopper (sm_90a): int8 activations times packed 4-bit weights.
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_w4a8.py
// (_w4a8_call -> _w4a8_kernel). The activations arrive quantized per tensor
// (x_q int8 in [-127, 127], one float32 scale sx, from
// quantize_activation_int8 in the wrapper's module). The weights are in the
// group-pair nibble layout of the W4 kernel: packed row p*gs + r holds
// logical row (2p)*gs + r in its low nibble (scale group 2p) and
// (2p+1)*gs + r in its high nibble (group 2p+1). The raw nibbles (0..15 for
// uint4, sign-extended -8..7 for int4) are dotted against x_q in int32, and
// the integer zero point folds in through the int32 sum of x_q:
//     x . ((w - zp) * s) == (x_q . w - sum(x_q) * zp) * (sx * s),
// so per group pair and output
//     acc += (dot_lo - xsum_lo * z_lo) * (sx * s_lo) + (dot_hi - xsum_hi * z_hi) * (sx * s_hi).
// Every int32 partial stays below 2^24 (127 * 15 * 128 = 243,840 at gs = 128),
// so the integer part is exact and only the float32 order of the group sums
// can differ from the reference. The float32 epilogue is written with
// rounded intrinsics in the plain version's order, so kernel and plain
// version agree bit for bit: in a bf16 stream a last-bit difference can move
// an int8 activation code of a later site, and comparisons of whole models
// would otherwise measure that amplification rather than the kernel.
//
// Shapes: x_q (M, K_pad) int8, zero past K; sx a float32 scalar on the
// device; w (K_pad / 2, N) uint8; scale and zp (G_pad/2, 2, N) float32, pad
// groups (1, 0); out (M, N) float32.
//
// Grid and block as the W4 kernel (common.cuh): one block covers 32 * CPT
// columns and BM <= 64 rows of M and walks every group pair itself, so at
// decode each weight byte is read from device memory once per call. The
// inner loop starts the loads of 16 packed rows of the thread's columns,
// then takes them four at a time: splits and sign-extends the nibbles
// bytewise, transposes them into one word per column and runs __dp4a on the
// CUDA cores: 4 K values per instruction where the W4 kernel spends one FMA
// per value.
// What bounds it on the card: at decode (M = 32) the packed weights and
// scales would take ~1.3 us per layer at 3.35 TB/s, but the dp4a work per
// packed byte (2 * M multiply-adds) runs far below the int8 tensor-core
// rate; mma.sync m16n8k32 s8 / wgmma tiles and a split over K for the N =
// 640 sites are the next steps.

#include "common.cuh"

namespace {

using oqt::kBatch8;
using oqt::kChunk8;
using oqt::kRow8;
using oqt::kThreadsM;
using oqt::kThreadsN;

// Low or high nibbles of four bytes, sign-extended bytewise when sign is
// 0x08080808 (int4: (n ^ 8) - 8); sign 0 leaves uint4 nibbles as they are.
__device__ __forceinline__ uint32_t nibbles(uint32_t bytes, int shift, uint32_t sign) {
  return __vsub4(((bytes >> shift) & 0x0F0F0F0Fu) ^ sign, sign);
}

template <int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads)
w4a8_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx_ptr,
            const uint8_t* __restrict__ w, const float* __restrict__ scale,
            const float* __restrict__ zp, float* __restrict__ out, int M, int K_pad, int N,
            int gs, uint32_t sign) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ __align__(16) int8_t xs[2][BM][kRow8];
  __shared__ int xsum[2][BM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const int n_pairs = K_pad / (2 * gs);
  const float sx = *sx_ptr;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int p = 0; p < n_pairs; ++p) {
    int dlo[RPT][CPT], dhi[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) dlo[i][c] = dhi[i][c] = 0;

    __syncthreads();  // the previous pair's epilogue has read xsum
    if (tid < 2 * BM) xsum[tid / BM][tid % BM] = 0;

    for (int r0 = 0; r0 < gs; r0 += kChunk8) {
      const int rc = min(kChunk8, gs - r0);
      __syncthreads();  // the previous chunk is consumed
      oqt::stage_rows_i8<BM>(xs[0], x, M, K_pad, m0, (2 * p) * gs + r0, rc, tid);
      oqt::stage_rows_i8<BM>(xs[1], x, M, K_pad, m0, (2 * p + 1) * gs + r0, rc, tid);
      __syncthreads();
      const int words = (rc + 3) / 4;
      if (tid < 2 * BM) {
        const int h = tid / BM, m = tid % BM;
        int s = 0;
        for (int j = 0; j < words; ++j) s = __dp4a(oqt::staged_word(xs[h][m], j), 0x01010101, s);
        xsum[h][m] += s;
      }
      if (col_ok) {
        const uint8_t* wchunk = w + static_cast<size_t>(p * gs + r0) * N + col0;
        for (int j0 = 0; j0 < words; j0 += kBatch8) {
          // All loads of kBatch8 words first. Rows past rc belong to the next
          // group (or lie past the array): their load is skipped, and they
          // (like words past `words`) meet x staged as zero.
          uint32_t bytes[kBatch8][4];
#pragma unroll
          for (int b = 0; b < kBatch8; ++b)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int r = 4 * (j0 + b) + q;
              bytes[b][q] = r < rc ? oqt::load_bytes<CPT>(wchunk + static_cast<size_t>(r) * N)
                                   : 0u;
            }
#pragma unroll
          for (int b = 0; b < kBatch8; ++b) {
            uint32_t lo_rows[4], hi_rows[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              lo_rows[q] = nibbles(bytes[b][q], 0, sign);
              hi_rows[q] = nibbles(bytes[b][q], 4, sign);
            }
            uint32_t lo[4], hi[4];
            oqt::transpose4x4(lo_rows, lo);
            oqt::transpose4x4(hi_rows, hi);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const int m = ty + i * kThreadsM;
              const int xl = oqt::staged_word(xs[0][m], j0 + b);
              const int xh = oqt::staged_word(xs[1][m], j0 + b);
#pragma unroll
              for (int c = 0; c < CPT; ++c) {
                dlo[i][c] = __dp4a(xl, static_cast<int>(lo[c]), dlo[i][c]);
                dhi[i][c] = __dp4a(xh, static_cast<int>(hi[c]), dhi[i][c]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // xsum is complete
    if (col_ok) {
      // Rounded operations (no FMA contraction), in the plain version's order,
      // so that the two agree bit for bit.
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const size_t lo_row = static_cast<size_t>(2 * p) * N + col0 + c;
        const float s_lo = __fmul_rn(sx, scale[lo_row]), z_lo = zp[lo_row];
        const float s_hi = __fmul_rn(sx, scale[lo_row + N]), z_hi = zp[lo_row + N];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int m = ty + i * kThreadsM;
          const float t_lo = __fmul_rn(
              __fsub_rn(static_cast<float>(dlo[i][c]),
                        __fmul_rn(static_cast<float>(xsum[0][m]), z_lo)), s_lo);
          const float t_hi = __fmul_rn(
              __fsub_rn(static_cast<float>(dhi[i][c]),
                        __fmul_rn(static_cast<float>(xsum[1][m]), z_hi)), s_hi);
          acc[i][c] = __fadd_rn(acc[i][c], __fadd_rn(t_lo, t_hi));
        }
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
void launch(const void* x, const void* sx, const void* w, const void* s, const void* z, void* out,
            int M, int K_pad, int N, int gs, uint32_t sign, cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (M + BM - 1) / BM);
  const dim3 block(kThreadsN, kThreadsM);
  w4a8_kernel<RPT, CPT><<<grid, block, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(w), static_cast<const float*>(s), static_cast<const float*>(z),
      static_cast<float*>(out), M, K_pad, N, gs, sign);
}

}  // namespace

// x: int8 (M, K_pad); sx: one float32 on the device. is_signed: int4 (1) or
// uint4 (0). cols4: 4 adjacent columns per thread (requires N % 4 == 0).
// Returns cudaGetLastError() after the launch.
extern "C" int oqt_w4a8_matmul(const void* x, const void* sx, const void* w, const void* scale,
                               const void* zp, void* out, int M, int K_pad, int N, int gs,
                               int is_signed, int cols4, void* stream) {
  const uint32_t sign = is_signed ? 0x08080808u : 0u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Up to 32 rows of M: one 32-row tile (decode); otherwise 64-row tiles.
  if (M <= 32) {
    if (cols4) launch<4, 4>(x, sx, w, scale, zp, out, M, K_pad, N, gs, sign, st);
    else launch<4, 1>(x, sx, w, scale, zp, out, M, K_pad, N, gs, sign, st);
  } else {
    if (cols4) launch<8, 4>(x, sx, w, scale, zp, out, M, K_pad, N, gs, sign, st);
    else launch<8, 1>(x, sx, w, scale, zp, out, M, K_pad, N, gs, sign, st);
  }
  return static_cast<int>(cudaGetLastError());
}
