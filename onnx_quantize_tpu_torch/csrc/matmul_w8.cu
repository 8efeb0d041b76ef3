// W8 dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_w8.py
// (_w8_call -> _w8_kernel). Computes out = x @ dequant(W) in float32 for
// int8/uint8 weights with one scale row per K tile of bk rows (a tensor or
// channel scale is one tile spanning K; a group scale has bk = group size).
// The affine goes on each tile's partial dot:
//     x . ((w - zp) * s) == (x . w - sum(x) * zp) * s,
// and the symmetric path (zero point 0) skips the zp term.
//
// Shapes: x (M, K) float32 or bfloat16; w (K, N) int8/uint8; scale and zp
// (K / bk, N) float32 (zp unused when symmetric); out (M, N) float32.
//
// Grid and block as the W4 kernel (common.cuh). What bounds it on the card:
// for the Gemma-3-270M lm_head at decode (K = 640, N = 262144) the 168 MB of
// int8 weights would, at 3.35 TB/s; this simple kernel spends 32 CUDA-core
// FMAs per weight byte at M = 32, which cost more. Tensor-core mma is the
// next step.

#include "common.cuh"

namespace {

using oqt::kRowChunk;
using oqt::kThreadsM;
using oqt::kThreadsN;

template <typename T, int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads)
w8_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, const float* __restrict__ zp,
          float* __restrict__ out, int M, int K, int N, int bk, int sign_off, int symmetric) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ float xs[BM][kRowChunk];
  __shared__ float xsum[BM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const int n_tiles = K / bk;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    float d[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) d[i][c] = 0.f;

    __syncthreads();  // the previous tile's epilogue has read xsum
    if (tid < BM) xsum[tid] = 0.f;

    for (int r0 = 0; r0 < bk; r0 += kRowChunk) {
      const int rc = min(kRowChunk, bk - r0);
      __syncthreads();  // the previous chunk is consumed
      oqt::stage_rows<T, BM>(xs, x, M, K, m0, t * bk + r0, rc, tid);
      __syncthreads();
      if (!symmetric && tid < BM) {
        float s = 0.f;
        for (int r = 0; r < rc; ++r) s += xs[tid][r];
        xsum[tid] += s;
      }
      if (col_ok) {
        const uint8_t* wrow = w + static_cast<size_t>(t * bk + r0) * N + col0;
        for (int r = 0; r < rc; ++r, wrow += N) {
          const uint32_t bytes = oqt::load_bytes<CPT>(wrow);
          float wv[CPT];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            // sign_off is 128 for int8 (sign-extend the byte), 0 for uint8.
            const int b = static_cast<int>((bytes >> (8 * c)) & 0xFF);
            wv[c] = static_cast<float>((b ^ sign_off) - sign_off);
          }
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float xv = xs[ty + i * kThreadsM][r];
#pragma unroll
            for (int c = 0; c < CPT; ++c) d[i][c] = fmaf(xv, wv[c], d[i][c]);
          }
        }
      }
    }
    __syncthreads();  // xsum is complete
    if (col_ok) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const size_t row = static_cast<size_t>(t) * N + col0 + c;
        const float s = scale[row];
        const float z = symmetric ? 0.f : zp[row];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float part = symmetric ? d[i][c] : d[i][c] - xsum[ty + i * kThreadsM] * z;
          acc[i][c] += part * s;
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
void launch(const void* x, const void* w, const void* s, const void* z, void* out, int M, int K,
            int N, int bk, int sign_off, int symmetric, cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (M + BM - 1) / BM);
  const dim3 block(kThreadsN, kThreadsM);
  w8_kernel<T, RPT, CPT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w), static_cast<const float*>(s),
      static_cast<const float*>(z), static_cast<float*>(out), M, K, N, bk, sign_off, symmetric);
}

template <typename T>
void dispatch(const void* x, const void* w, const void* s, const void* z, void* out, int M, int K,
              int N, int bk, int sign_off, int symmetric, int cols4, cudaStream_t stream) {
  if (M <= 32) {
    if (cols4) launch<T, 4, 4>(x, w, s, z, out, M, K, N, bk, sign_off, symmetric, stream);
    else launch<T, 4, 1>(x, w, s, z, out, M, K, N, bk, sign_off, symmetric, stream);
  } else {
    if (cols4) launch<T, 8, 4>(x, w, s, z, out, M, K, N, bk, sign_off, symmetric, stream);
    else launch<T, 8, 1>(x, w, s, z, out, M, K, N, bk, sign_off, symmetric, stream);
  }
}

}  // namespace

// x_bf16: 1 for bfloat16 x, 0 for float32. is_signed: int8 (1) or uint8 (0).
// symmetric: zero point is 0 (zp may be null). cols4: 4 adjacent columns per
// thread (requires N % 4 == 0). Returns cudaGetLastError() after the launch.
extern "C" int oqt_w8_matmul(const void* x, int x_bf16, const void* w, const void* scale,
                             const void* zp, void* out, int M, int K, int N, int bk,
                             int is_signed, int symmetric, int cols4, void* stream) {
  const int sign_off = is_signed ? 128 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    dispatch<__nv_bfloat16>(x, w, scale, zp, out, M, K, N, bk, sign_off, symmetric, cols4, st);
  } else {
    dispatch<float>(x, w, scale, zp, out, M, K, N, bk, sign_off, symmetric, cols4, st);
  }
  return static_cast<int>(cudaGetLastError());
}
