// Full-integer QLINEAR matmul (Q8) for Hopper (sm_90a).
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/matmul_q8.py
// (_q8_call -> _q8_kernel). One launch computes a whole QLINEAR site:
//   1. static input quantization while x is staged: q = rint(x / x_scale) +
//      x_zp, clamped to the input type's range, then shifted into int8
//      (uint8 codes minus 128); x is read as float32 (a bf16 x exactly),
//      the division is IEEE (__fdiv_rn) and rint rounds half to even;
//   2. the int8 x int8 dot in int32 on __dp4a, the weights loaded as the
//      W8A8 kernel loads them (uint8 weights flipped into int8 by XOR 0x80);
//   3. the zero-point corrections and the int32 bias, exact in int32:
//        acc - x_zp*wsum - w_zp*xsum + K*x_zp*w_zp + b
//      (x_zp and w_zp shifted with their codes, wsum the column sums of the
//      shifted weights, xsum the row sums of the staged codes);
//   4. requantization by req = x_scale*w_scale/y_scale (one float32 per
//      column, computed once by the wrapper), rint, + y_zp, clamp to the
//      output type's range, and the dequantization (y_q - y_zp) * y_scale.
// Every float step is one rounded operation in the reference's order, so the
// result equals the plain version's and the JAX oracle's bit for bit.
//
// Shapes: x (M, K) float32 or bfloat16; w (K, N) int8/uint8; wsum, w_zp
// (N,) int32; req (N,) float32; bias (N,) int32 or null; fparams
// [x_scale, y_scale] and iparams [x_zp, y_zp] on the device (no host sync);
// out (M, N) float32.
//
// Grid and block as the W8A8 kernel (common.cuh): 32 x 8 threads, each
// owning CPT adjacent columns and RPT rows of M strided by 8, K staged 64
// rows at a time.
// What bounds it on the card: a Gemma-3-270M layer's seven sites at decode
// (M = 32) read 5.57 MB of int8 weights, ~1.7 us at 3.35 TB/s; like W8A8,
// this simple kernel's dp4a work on the CUDA cores and its load latency
// cost more. Tensor-core mma / wgmma s8 tiles are the next step.

#include "common.cuh"

namespace {

using oqt::kBatch8;
using oqt::kChunk8;
using oqt::kRow8;
using oqt::kThreadsM;
using oqt::kThreadsN;

struct QuantIn {
  float scale;
  int zp, qmin, qmax, shift;
};

// Stage x[m0 : m0+BM, k0 : k0+rc] into dst[BM][kRow8] as shifted int8 codes,
// zero outside the matrix and past rc (zeros add nothing to the dots or the
// row sums).
template <typename T, int BM>
__device__ __forceinline__ void stage_quantized(int8_t (*dst)[kRow8], const T* __restrict__ x,
                                                int M, int K, int m0, int k0, int rc, int tid,
                                                const QuantIn& qi) {
  for (int i = tid; i < BM * kChunk8; i += oqt::kThreads) {
    const int m = i / kChunk8;
    const int r = i % kChunk8;
    int v = 0;
    if (m0 + m < M && r < rc) {
      const float f = oqt::to_f32(x[static_cast<size_t>(m0 + m) * K + k0 + r]);
      const int q = __float2int_rn(__fdiv_rn(f, qi.scale)) + qi.zp;
      v = min(max(q, qi.qmin), qi.qmax) - qi.shift;
    }
    dst[m][r] = static_cast<int8_t>(v);
  }
}

template <typename T, int RPT, int CPT>
__global__ void __launch_bounds__(oqt::kThreads)
q8_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w, const int* __restrict__ wsum,
          const int* __restrict__ wzp, const float* __restrict__ req,
          const int* __restrict__ bias, const float* __restrict__ fparams,
          const int* __restrict__ iparams, float* __restrict__ out, int M, int K, int N,
          uint32_t flip, int x_shift, int iqmin, int iqmax, int oqmin, int oqmax) {
  constexpr int BM = RPT * kThreadsM;
  __shared__ __align__(16) int8_t xs[BM][kRow8];
  __shared__ int xsum[BM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int col0 = (blockIdx.x * kThreadsN + tx) * CPT;
  const int m0 = blockIdx.y * BM;
  const bool col_ok = col0 < N;  // CPT == 4 only when N % 4 == 0
  const QuantIn qi{fparams[0], iparams[0], iqmin, iqmax, x_shift};

  int d[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) d[i][c] = 0;
  int row_sum = 0;  // thread tid < BM: the sum of row tid's staged codes

  for (int r0 = 0; r0 < K; r0 += kChunk8) {
    const int rc = min(kChunk8, K - r0);
    __syncthreads();  // the previous chunk is consumed
    stage_quantized<T, BM>(xs, x, M, K, m0, r0, rc, tid, qi);
    __syncthreads();
    if (tid < BM) {
#pragma unroll
      for (int j = 0; j < kChunk8 / 4; ++j)
        row_sum = __dp4a(oqt::staged_word(xs[tid], j), 0x01010101, row_sum);
    }
    if (!col_ok) continue;
    const int words = (rc + 3) / 4;
    const uint8_t* wchunk = w + static_cast<size_t>(r0) * N + col0;
    for (int j0 = 0; j0 < words; j0 += kBatch8) {
      // All loads of kBatch8 words first; rows past rc meet x staged as
      // zero, and their load is skipped.
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
          for (int c = 0; c < CPT; ++c) d[i][c] = __dp4a(xv, static_cast<int>(cols[c]), d[i][c]);
        }
      }
    }
  }
  if (tid < BM) xsum[tid] = row_sum;
  __syncthreads();
  if (!col_ok) return;

  const int x_zp = iparams[0] - x_shift;
  const float y_scale = fparams[1];
  const float y_zp = static_cast<float>(iparams[1]);
  const float lo = static_cast<float>(oqmin), hi = static_cast<float>(oqmax);
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int n = col0 + c;
    const int zw = wzp[n];
    const int fixed = -x_zp * wsum[n] + K * x_zp * zw + (bias != nullptr ? bias[n] : 0);
    const float rq = req[n];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = m0 + ty + i * kThreadsM;
      if (m >= M) continue;
      const int acc = d[i][c] - zw * xsum[ty + i * kThreadsM] + fixed;
      const float yq = fminf(fmaxf(__fadd_rn(rintf(__fmul_rn(__int2float_rn(acc), rq)), y_zp),
                                   lo), hi);
      out[static_cast<size_t>(m) * N + n] = __fmul_rn(__fsub_rn(yq, y_zp), y_scale);
    }
  }
}

template <typename T, int RPT, int CPT>
void launch(const void* x, const void* w, const void* wsum, const void* wzp, const void* req,
            const void* bias, const void* fparams, const void* iparams, void* out, int M, int K,
            int N, uint32_t flip, int x_shift, int iqmin, int iqmax, int oqmin, int oqmax,
            cudaStream_t stream) {
  constexpr int BM = RPT * kThreadsM;
  const dim3 grid((N + kThreadsN * CPT - 1) / (kThreadsN * CPT), (M + BM - 1) / BM);
  const dim3 block(kThreadsN, kThreadsM);
  q8_kernel<T, RPT, CPT><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w), static_cast<const int*>(wsum),
      static_cast<const int*>(wzp), static_cast<const float*>(req),
      static_cast<const int*>(bias), static_cast<const float*>(fparams),
      static_cast<const int*>(iparams), static_cast<float*>(out), M, K, N, flip, x_shift, iqmin,
      iqmax, oqmin, oqmax);
}

template <typename T>
void dispatch(const void* x, const void* w, const void* wsum, const void* wzp, const void* req,
              const void* bias, const void* fparams, const void* iparams, void* out, int M,
              int K, int N, uint32_t flip, int x_shift, int iqmin, int iqmax, int oqmin,
              int oqmax, int cols4, cudaStream_t st) {
  if (M <= 32) {
    if (cols4)
      launch<T, 4, 4>(x, w, wsum, wzp, req, bias, fparams, iparams, out, M, K, N, flip, x_shift,
                      iqmin, iqmax, oqmin, oqmax, st);
    else
      launch<T, 4, 1>(x, w, wsum, wzp, req, bias, fparams, iparams, out, M, K, N, flip, x_shift,
                      iqmin, iqmax, oqmin, oqmax, st);
  } else {
    if (cols4)
      launch<T, 8, 4>(x, w, wsum, wzp, req, bias, fparams, iparams, out, M, K, N, flip, x_shift,
                      iqmin, iqmax, oqmin, oqmax, st);
    else
      launch<T, 8, 1>(x, w, wsum, wzp, req, bias, fparams, iparams, out, M, K, N, flip, x_shift,
                      iqmin, iqmax, oqmin, oqmax, st);
  }
}

}  // namespace

// x_bf16: 1 for bfloat16 x, 0 for float32. is_signed: int8 weights (1) or
// uint8 (0, flipped into int8 at load; wsum and w_zp describe the flipped
// codes). x_shift: 128 for uint8 input codes, 0 for int8. bias may be null.
// cols4: 4 adjacent columns per thread (requires N % 4 == 0). Returns
// cudaGetLastError() after the launch.
extern "C" int oqt_q8_matmul(const void* x, int x_bf16, const void* w, const void* wsum,
                             const void* wzp, const void* req, const void* bias,
                             const void* fparams, const void* iparams, void* out, int M, int K,
                             int N, int is_signed, int x_shift, int iqmin, int iqmax, int oqmin,
                             int oqmax, int cols4, void* stream) {
  const uint32_t flip = is_signed ? 0u : 0x80808080u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    dispatch<__nv_bfloat16>(x, w, wsum, wzp, req, bias, fparams, iparams, out, M, K, N, flip,
                            x_shift, iqmin, iqmax, oqmin, oqmax, cols4, st);
  } else {
    dispatch<float>(x, w, wsum, wzp, req, bias, fparams, iparams, out, M, K, N, flip, x_shift,
                    iqmin, iqmax, oqmin, oqmax, cols4, st);
  }
  return static_cast<int>(cudaGetLastError());
}
