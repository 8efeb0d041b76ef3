// W4 group-pair dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_w4.py
// (_w4_call -> _w4_kernel). Computes out = x @ dequant(W) in float32 for
// 4-bit weights in the group-pair nibble layout: packed row p*gs + r holds
// logical row (2p)*gs + r in its low nibble (scale group 2p) and
// (2p+1)*gs + r in its high nibble (group 2p+1). The dequant affine is applied
// to each group's partial dot, not to the weights:
//     x . ((w - zp) * s) == (x . w - sum(x) * zp) * s,
// so the inner loop is the nibble unpack plus FMAs, all in float32.
//
// Shapes: x (M, K_pad) float32 or bfloat16, K_pad = 2 * half_rows;
// w (half_rows, N) uint8; scale and zp (G_pad/2, 2, N) float32, with pad
// groups carrying (1, 0); out (M, N) float32.
//
// Grid: (ceil(N / (32 * CPT)), ceil(M / BM)). One block covers 32 * CPT
// columns and BM <= 64 rows of M and walks every group pair, so at decode
// (M <= 64) each weight byte is read from device memory once per call.
// What bounds it on the card: at decode the weight bytes would, at 3.35 TB/s,
// but this simple kernel runs its FMAs on the CUDA cores (64 per packed byte
// at M = 32), which cost more than the bytes; tensor-core mma and a split
// over K for the narrow-N sites are the next steps.

#include "common.cuh"

namespace {

using oqt::kRowChunk;
using oqt::kThreadsM;
using oqt::kThreadsN;

template <typename T, int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads)
w4_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ zp,
          float* __restrict__ out, int M, int K_pad, int N, int gs, int sign_off) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ float xs[2][BM][kRowChunk];
  __shared__ float xsum[2][BM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const int n_pairs = K_pad / (2 * gs);

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int p = 0; p < n_pairs; ++p) {
    float dlo[RPT][CPT], dhi[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) dlo[i][c] = dhi[i][c] = 0.f;

    __syncthreads();  // the previous pair's epilogue has read xsum
    if (tid < 2 * BM) xsum[tid / BM][tid % BM] = 0.f;

    for (int r0 = 0; r0 < gs; r0 += kRowChunk) {
      const int rc = min(kRowChunk, gs - r0);
      __syncthreads();  // the previous chunk is consumed
      oqt::stage_rows<T, BM>(xs[0], x, M, K_pad, m0, (2 * p) * gs + r0, rc, tid);
      oqt::stage_rows<T, BM>(xs[1], x, M, K_pad, m0, (2 * p + 1) * gs + r0, rc, tid);
      __syncthreads();
      if (tid < 2 * BM) {
        const int h = tid / BM, m = tid % BM;
        float s = 0.f;
        for (int r = 0; r < rc; ++r) s += xs[h][m][r];
        xsum[h][m] += s;
      }
      if (col_ok) {
        const uint8_t* wrow = w + static_cast<size_t>(p * gs + r0) * N + col0;
        for (int r = 0; r < rc; ++r, wrow += N) {
          const uint32_t bytes = oqt::load_bytes<CPT>(wrow);
          float lo[CPT], hi[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const int b = (bytes >> (8 * c)) & 0xFF;
            // sign_off is 8 for int4 (sign-extend the nibble), 0 for uint4.
            lo[c] = static_cast<float>(((b & 0x0F) ^ sign_off) - sign_off);
            hi[c] = static_cast<float>(((b >> 4) ^ sign_off) - sign_off);
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float xl = xs[0][ty + i * kThreadsM][r];
            const float xh = xs[1][ty + i * kThreadsM][r];
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              dlo[i][c] = fmaf(xl, lo[c], dlo[i][c]);
              dhi[i][c] = fmaf(xh, hi[c], dhi[i][c]);
            }
          }
        }
      }
    }
    __syncthreads();  // xsum is complete
    if (col_ok) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const size_t lo_row = static_cast<size_t>(2 * p) * N + col0 + c;
        const float s_lo = scale[lo_row], z_lo = zp[lo_row];
        const float s_hi = scale[lo_row + N], z_hi = zp[lo_row + N];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int m = ty + i * kThreadsM;
          acc[i][c] += (dlo[i][c] - xsum[0][m] * z_lo) * s_lo +
                       (dhi[i][c] - xsum[1][m] * z_hi) * s_hi;
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

template <typename T, int RPT, int CPT>
void launch(const void* x, const void* w, const void* s, const void* z, void* out, int M,
            int K_pad, int N, int gs, int sign_off, cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (M + BM - 1) / BM);
  const dim3 block(kThreadsN, kThreadsM);
  w4_kernel<T, RPT, CPT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w), static_cast<const float*>(s),
      static_cast<const float*>(z), static_cast<float*>(out), M, K_pad, N, gs, sign_off);
}

template <typename T>
void dispatch(const void* x, const void* w, const void* s, const void* z, void* out, int M,
              int K_pad, int N, int gs, int sign_off, int cols4, cudaStream_t stream) {
  // Up to 32 rows of M: one 32-row tile (decode); otherwise 64-row tiles.
  if (M <= 32) {
    if (cols4) launch<T, 4, 4>(x, w, s, z, out, M, K_pad, N, gs, sign_off, stream);
    else launch<T, 4, 1>(x, w, s, z, out, M, K_pad, N, gs, sign_off, stream);
  } else {
    if (cols4) launch<T, 8, 4>(x, w, s, z, out, M, K_pad, N, gs, sign_off, stream);
    else launch<T, 8, 1>(x, w, s, z, out, M, K_pad, N, gs, sign_off, stream);
  }
}

}  // namespace

// x_bf16: 1 for bfloat16 x, 0 for float32. is_signed: int4 (1) or uint4 (0).
// cols4: 4 adjacent columns per thread (requires N % 4 == 0).
// Returns cudaGetLastError() after the launch.
extern "C" int oqt_w4_matmul(const void* x, int x_bf16, const void* w, const void* scale,
                             const void* zp, void* out, int M, int K_pad, int N, int gs,
                             int is_signed, int cols4, void* stream) {
  const int sign_off = is_signed ? 8 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    dispatch<__nv_bfloat16>(x, w, scale, zp, out, M, K_pad, N, gs, sign_off, cols4, st);
  } else {
    dispatch<float>(x, w, scale, zp, out, M, K_pad, N, gs, sign_off, cols4, st);
  }
  return static_cast<int>(cudaGetLastError());
}
