// Int8-KV flash decode for Hopper (sm_90a).
//
// Replaces the Pallas kernels onnx_quantize_tpu/ops/kernels/flash_decode.py
// (_fd_call -> _fd_kernel, and _fd_batched_call -> _fd_batched_kernel, which
// computes the same function on a coarser TPU grid). One-token GQA attention
// read straight from the int8 cache, with the per-(token, head) scales folded
// in, so no dequantized cache exists:
//     scores[g, s] = (q[g] . K_i8[s]) * ks[s]
//     out[g]       = sum_s softmax(scores)[g, s] * vs[s] * V_i8[s]
// Keys at slots in [max(pos - window + 1, 0), min(pos, S - 1)] are live; the
// clamp to S - 1 covers the engine's sentinel pos = S of inactive slots,
// whose (discarded) output stays finite.
//
// Shapes: q (B, Hkv * G, D) float32, pre-scaled; k, v (B, S, Hkv, D) int8;
// ks, vs (B, S, Hkv) float32 (the cache's own layout, no transpose); pos (B,)
// int32; out (B, Hkv * G, D) float32. D % 16 == 0.
//
// What bounds it on the card: the live int8 K/V bytes (B = 32, 640 live
// slots, D = 256: 10.5 MB per global layer, ~3 us at 3.35 TB/s). Design: one
// block per (kv head, sequence) walks the live range in tiles of kTile keys
// (the in-block loop replaces the TPU's sequential S grid axis and its
// clamped index maps, so dead blocks are never read). The G query heads of
// the group share each K/V tile, so each live byte is read once per step.
// Tiles are loaded with 16-byte loads into shared memory rows padded by one
// word, so the score phase (one thread per (head, key) pair) reads K without
// bank conflicts. Online softmax per head keeps (m, l) in shared memory and
// the (G, D) accumulator there too. All dots are float32 on the CUDA cores,
// as the reference's HIGHEST precision. A later version splits S across
// blocks: with B * Hkv = 32 blocks most SMs idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // keys per tile
constexpr int kThreads = 256;  // 8 warps
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float byte_at(uint32_t w, int i) {
  // Sign-extend byte i of w.
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * i)) >> 24);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                    const float* __restrict__ ks, const int8_t* __restrict__ v,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    float* __restrict__ out, int S, int Hkv, int G, int D, int window) {
  extern __shared__ float4 smem4[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D4 = D / 4;           // 32-bit words (4 codes) per K/V row
  const int row_words = D4 + 1;   // padded: consecutive rows start one bank apart

  float* qs = reinterpret_cast<float*>(smem4);  // (G, D)
  float* acc = qs + G * D;                      // (G, D)
  float* sc = acc + G * D;                      // (G, kTile): scores, then p * vs
  float* ksc = sc + G * kTile;                  // (kTile)
  float* vsc = ksc + kTile;                     // (kTile)
  float* m_run = vsc + kTile;                   // (G)
  float* l_run = m_run + G;                     // (G)
  float* alpha = l_run + G;                     // (G)
  uint32_t* kt = reinterpret_cast<uint32_t*>(alpha + G);  // (kTile, row_words)
  uint32_t* vt = kt + kTile * row_words;

  const size_t head_base = (static_cast<size_t>(b) * Hkv + h) * G * D;  // q and out
  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = q[head_base + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
  }

  const int p = pos[b];
  const int hi = min(p, S - 1);
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int chunks = D / 16;  // 16-byte chunks per row

  for (int s0 = lo; s0 <= hi; s0 += kTile) {
    const int n = min(kTile, hi - s0 + 1);
    __syncthreads();  // the previous tile is consumed (and the init is visible)
    for (int i = tid; i < n * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = i - r * chunks;
      const size_t off = ((static_cast<size_t>(b) * S + s0 + r) * Hkv + h) * D + 16 * c;
      const uint4 kk = *reinterpret_cast<const uint4*>(k + off);
      const uint4 vv = *reinterpret_cast<const uint4*>(v + off);
      uint32_t* kd = kt + r * row_words + 4 * c;
      uint32_t* vd = vt + r * row_words + 4 * c;
      kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    for (int i = tid; i < n; i += kThreads) {
      const size_t off = (static_cast<size_t>(b) * S + s0 + i) * Hkv + h;
      ksc[i] = ks[off];
      vsc[i] = vs[off];
    }
    __syncthreads();

    // Scores: one (head, key) pair per thread; lanes take consecutive keys.
    for (int e = tid; e < G * kTile; e += kThreads) {
      const int g = e / kTile;
      const int j = e - g * kTile;
      float s = kNegInf;
      if (j < n) {
        const uint32_t* kr = kt + j * row_words;
        const float4* qg = reinterpret_cast<const float4*>(qs + g * D);
        float d = 0.f;
        for (int w = 0; w < D4; ++w) {
          const uint32_t word = kr[w];
          const float4 qv = qg[w];
          d = fmaf(qv.x, byte_at(word, 0), d);
          d = fmaf(qv.y, byte_at(word, 1), d);
          d = fmaf(qv.z, byte_at(word, 2), d);
          d = fmaf(qv.w, byte_at(word, 3), d);
        }
        s = d * ksc[j];
      }
      sc[e] = s;
    }
    __syncthreads();

    // Online softmax, one warp per head; v's scale folds into p.
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sg = sc + g * kTile;
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, sg[j]);
      mx = warp_max(mx);
      const float m_prev = m_run[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = m_new <= kNegInf / 2 ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        const float pj = j < n ? expf(sg[j] - m_safe) : 0.f;
        sum += pj;
        sg[j] = pj * vsc[j];
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = m_prev <= kNegInf / 2 ? 0.f : expf(m_prev - m_safe);
        alpha[g] = a;
        l_run[g] = l_run[g] * a + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g, 4w:4w+4] = alpha * acc + sum_j pv[g, j] * V[j, 4w:4w+4].
    float4* acc4 = reinterpret_cast<float4*>(acc);
    for (int e = tid; e < G * D4; e += kThreads) {
      const int g = e / D4;
      const int w = e - g * D4;
      const float a = alpha[g];
      float4 o = acc4[e];
      o.x *= a; o.y *= a; o.z *= a; o.w *= a;
      const float* pg = sc + g * kTile;
      for (int j = 0; j < n; ++j) {
        const uint32_t word = vt[j * row_words + w];
        const float pj = pg[j];
        o.x = fmaf(pj, byte_at(word, 0), o.x);
        o.y = fmaf(pj, byte_at(word, 1), o.y);
        o.z = fmaf(pj, byte_at(word, 2), o.z);
        o.w = fmaf(pj, byte_at(word, 3), o.w);
      }
      acc4[e] = o;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    out[head_base + i] = acc[i] / fmaxf(l_run[i / D], 1e-30f);
  }
}

// Dynamic shared memory for group size G and head dim D (43 KB at G = 4,
// D = 256; above 48 KB the launch needs the opt-in attribute).
int smem_bytes(int G, int D) {
  const int floats = 2 * G * D + G * kTile + 2 * kTile + 3 * G;
  return static_cast<int>(sizeof(float)) * floats + 2 * kTile * (D / 4 + 1) * 4;
}

}  // namespace

// window <= 0: no sliding window. Returns cudaGetLastError() after the launch
// (a launch refused for its shared memory never runs).
extern "C" int oqt_flash_decode(const void* q, const void* k, const void* ks, const void* v,
                                const void* vs, const void* pos, void* out, int B, int S,
                                int Hkv, int G, int D, int window, void* stream) {
  const int smem = smem_bytes(G, D);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  const dim3 grid(Hkv, B);
  flash_decode_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k), static_cast<const float*>(ks),
      static_cast<const int8_t*>(v), static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<float*>(out), S, Hkv, G, D, window);
  return static_cast<int>(cudaGetLastError());
}
