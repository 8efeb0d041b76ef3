// Blockwise causal attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/flash_attention.py
// (_fa_call -> _fa_kernel): full-sequence (prefill / perplexity window)
// attention with online softmax that never materializes the (T, S) scores.
// Row t attends to columns s with s <= t and, with a sliding window w,
// s > t - w. GQA by index: query head h reads kv head h / group.
//
// Shapes: q (B, T, Hq, D), k and v (B, S, Hkv, D), out (B, T, Hq, D), all
// float32 or all bfloat16, last dim contiguous, other strides given in
// elements (the (B, T, H, D) layouts are read directly, no transpose). q is
// pre-scaled. Scores and the accumulator are float32; p is rounded to v's
// dtype before the PV product and the row sum l uses the unrounded p, as the
// reference; the output is acc / max(l, 1e-30) in q's dtype.
//
// What bounds it on the card: operations. A 2048-token window of
// Gemma-3-270M is ~90 GFLOP of attention over 18 layers, at least ~1.4 ms on
// the CUDA cores. Design: one block per (T tile of kBT rows, query head,
// sequence) loops only over the live S tiles (causal upper bound, window
// lower bound) and masks elements at the edges. 256 threads as 16 x 16: a
// thread owns 4 rows (strided by 16) and, for QK^T, 4 columns of the score
// tile; for PV, 4 rows x D/4 output elements in registers. Q, K and V tiles
// sit in shared memory as 32-bit words with rows padded by one word, so the
// column-wise reads of K hit 16 distinct banks. FMAs run on the CUDA cores;
// mma/wgmma tensor-core tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 64;        // query rows per block
constexpr int kBS = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPStride = kBS + 16;  // p tile row stride: two rows of a warp 16 banks apart
constexpr float kNegInf = -1e30f;

template <typename T> struct Word;

template <> struct Word<float> {
  static constexpr int kElems = 1;
  __device__ static void unpack(uint32_t w, float* out) { out[0] = __uint_as_float(w); }
  __device__ static float round(float x) { return x; }
  __device__ static uint32_t pack(const float* x) { return __float_as_uint(x[0]); }
};

template <> struct Word<__nv_bfloat16> {
  static constexpr int kElems = 2;
  __device__ static void unpack(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  __device__ static uint32_t pack(const float* x) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16(x[0]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16(x[1]));
    return lo | (hi << 16);
  }
};

struct Strides {
  long long b, t, h;  // in elements; the head_dim stride is 1
};

// Copy rows [r0, r0 + rows) of one head into a padded word tile, zero past n.
template <int DW>
__device__ __forceinline__ void load_tile(uint32_t* dst, const uint32_t* base, long long row_words,
                                          int r0, int n, int rows, int tid) {
  for (int i = tid; i < rows * DW; i += kThreads) {
    const int r = i / DW;
    const int w = i - r * DW;
    dst[r * (DW + 1) + w] = (r0 + r < n) ? base[(r0 + r) * row_words + w] : 0u;
  }
}

// Max and sum over the 16 lanes that hold one score row (a half warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int T_len, int S,
                       int group, int window, Strides qs, Strides ks, Strides vs, Strides os) {
  using W = Word<T>;
  constexpr int E = W::kElems;
  constexpr int DW = D / E;       // words per row
  constexpr int RW = DW + 1;      // padded row stride in words
  constexpr int CW = DW / 16;     // word columns per thread in PV
  extern __shared__ uint32_t smem[];
  uint32_t* qt = smem;                 // (kBT, RW)
  uint32_t* kt = qt + kBT * RW;        // (kBS, RW)
  uint32_t* vt = kt + kBS * RW;        // (kBS, RW)
  float* pt = reinterpret_cast<float*>(vt + kBS * RW);  // (kBT, kPStride)

  const int t0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // rows tr + 16 i
  const int tc = tid % 16;  // score columns tc + 16 j; PV word columns tc + 16 c

  // Views in 32-bit words (the wrapper guarantees even strides for bf16).
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + b * qs.b + h * qs.h);
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(k + b * ks.b + hk * ks.h);
  const uint32_t* vw = reinterpret_cast<const uint32_t*>(v + b * vs.b + hk * vs.h);
  load_tile<DW>(qt, qw, qs.t / E, t0, T_len, kBT, tid);

  float m[4], l[4], acc[4][CW * E];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW * E; ++c) acc[i][c] = 0.f;
  }

  // Live columns for this row tile: causal upper bound, window lower bound.
  const int t_last = min(t0 + kBT, T_len) - 1;
  const int s_hi = min(t_last, S - 1);
  const int s_lo = window > 0 ? max(t0 - window + 1, 0) : 0;

  for (int s0 = s_lo; s0 <= s_hi; s0 += kBS) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    load_tile<DW>(kt, kw, ks.t / E, s0, S, kBS, tid);
    load_tile<DW>(vt, vw, vs.t / E, s0, S, kBS, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int w = 0; w < DW; ++w) {
      float qv[4][E], kv[4][E];
#pragma unroll
      for (int i = 0; i < 4; ++i) W::unpack(qt[(tr + 16 * i) * RW + w], qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) W::unpack(kt[(tc + 16 * j) * RW + w], kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < E; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t0 + tr + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = s0 + tc + 16 * j;
        ok[j] = col <= row && col < S && (window <= 0 || col > row - window);
        if (!ok[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      const float a = m[i] <= kNegInf / 2 ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        sum += p;
        pt[(tr + 16 * i) * kPStride + tc + 16 * j] = W::round(p);
      }
      sum = row_sum(sum);
      l[i] = l[i] * a + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW * E; ++c) acc[i][c] *= a;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBS; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[(tr + 16 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        float vv[E];
        W::unpack(vt[j * RW + tc + 16 * c], vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < E; ++e) acc[i][c * E + e] = fmaf(p[i], vv[e], acc[i][c * E + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + tr + 16 * i;
    if (row >= T_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + b * os.b + row * os.t + h * os.h);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      float x[E];
#pragma unroll
      for (int e = 0; e < E; ++e) x[e] = acc[i][c * E + e] * inv;
      orow[tc + 16 * c] = W::pack(x);
    }
  }
}

struct Problem {
  const void *q, *k, *v;
  void* out;
  int B, T_len, S, Hq, group, window;
  Strides qs, ks, vs, os;
};

template <typename T, int D>
int launch(const Problem& p, cudaStream_t stream) {
  constexpr int RW = D / Word<T>::kElems + 1;
  const int smem = static_cast<int>((kBT + 2 * kBS) * RW * sizeof(uint32_t) +
                                    kBT * kPStride * sizeof(float));
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  const dim3 grid((p.T_len + kBT - 1) / kBT, p.Hq, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k), static_cast<const T*>(p.v),
      static_cast<T*>(p.out), p.T_len, p.S, p.group, p.window, p.qs, p.ks, p.vs, p.os);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const Problem& p, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// is_bf16: 1 for bfloat16 tensors, 0 for float32. D in {32, 64, 128, 256}.
// window <= 0: no sliding window. strides: (b, t, h) of q, k, v, out in
// elements. Returns cudaGetLastError() after the launch.
extern "C" int oqt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int is_bf16, int B, int T_len, int S, int Hq, int Hkv,
                                   int D, int window, const long long* strides, void* stream) {
  const Problem p{q, k, v, out, B, T_len, S, Hq, Hq / Hkv, window,
                  Strides{strides[0], strides[1], strides[2]},
                  Strides{strides[3], strides[4], strides[5]},
                  Strides{strides[6], strides[7], strides[8]},
                  Strides{strides[9], strides[10], strides[11]}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(D, p, st) : dispatch<float>(D, p, st);
}
