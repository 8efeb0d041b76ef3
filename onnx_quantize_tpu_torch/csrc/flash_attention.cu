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
// Gemma-3-270M is ~82 GFLOP of attention over 18 layers (0.083 ms at 989
// TFLOP/s bf16). Its shapes give little parallelism: a layer has 2048 x 4
// query rows on one KV head, 512 tiles of 16 rows for 132 SMs. Two routes,
// chosen by the launch plan (ops/kernels/flash_attention.py::fa_plan):
//
// mma (bfloat16): tensor cores.
//   - A block owns 16 query rows of `heads` query heads of one GQA group and
//     runs heads x splits warps: warp (head, split) takes the 16 rows of its
//     head and every split-th 32-key slice of the block's live keys. Each
//     K/V tile is staged once for all heads of the group.
//   - S = Q K^T and O += P V on mma.sync m16n8k16 bf16 -> f32. Q's A
//     fragments come by ldmatrix from the staged Q tile (a 16 x D slice a
//     warp; D = 256 of Q does not fit in registers beside the 16 x D float32
//     accumulator), K's B fragments by ldmatrix from key-major rows, V's by
//     ldmatrix.trans. The S accumulator (C layout) is PV's A fragment,
//     rounded to bf16 in registers: the plain version's "p rounded to v's
//     dtype". Row max across the 4 lanes of a row by two shuffles; each lane
//     keeps its part of l (unrounded p) and the lanes sum once at the end.
//   - K and V move by 16-byte cp.async into a ring of 2 stages; the next
//     stage's copies are issued before the current stage's mmas. A staged
//     row is padded by 16 bytes, so ldmatrix's 8 row addresses fall in
//     distinct bank groups.
//   - The live key range is the causal upper bound and the window lower
//     bound of the block's rows; only edge slices (the diagonal, the
//     window's start, past S) compare indices, and a split whose slice
//     starts past the range skips it.
//   - Splits of one row slice keep their own m, l and acc; at the end they
//     meet in shared memory, are rescaled to the common max and summed
//     (exact in float32 up to summation order). Split 0 writes the output.
//   - T tiles launch in reverse order, so a causal layer's longest tiles
//     start first.
//
// simt (float32): the CUDA-core kernel of the first port. One block per
//   (T tile of kBT rows, query head, sequence) loops over the live S tiles;
//   256 threads as 16 x 16: a thread owns 4 rows (strided by 16) and, for
//   QK^T, 4 columns of the score tile; for PV, 4 rows x D/16 output elements
//   in registers. Q, K and V tiles sit in shared memory with rows padded by
//   one word, so the column-wise reads of K hit 16 distinct banks. A bf16
//   mma cannot hold float32 operands exactly, and TF32 would miss the
//   float32 bar.

#include "common.cuh"

namespace {

// ---- simt route ----------------------------------------------------------------

constexpr int kBT = 64;        // query rows per block
constexpr int kBS = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPStride = kBS + 16;  // p tile row stride: two rows of a warp 16 banks apart
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, t, h;  // in elements; the head_dim stride is 1
};

// Copy rows [r0, r0 + rows) of one head into a padded tile, zero past n.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long row_stride,
                                          int r0, int n, int rows, int tid) {
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * (D + 1) + c] = (r0 + r < n) ? base[(r0 + r) * row_stride + c] : 0.f;
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int T_len, int S,
                       int group, int window, Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int RW = D + 1;   // padded row stride
  constexpr int CW = D / 16;  // output columns per thread in PV
  extern __shared__ float smem[];
  float* qt = smem;           // (kBT, RW)
  float* kt = qt + kBT * RW;  // (kBS, RW)
  float* vt = kt + kBS * RW;  // (kBS, RW)
  float* pt = vt + kBS * RW;  // (kBT, kPStride)

  const int t0 = blockIdx.x * kBT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // rows tr + 16 i
  const int tc = tid % 16;  // score columns tc + 16 j; PV columns tc + 16 c

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  load_tile<D>(qt, qb, qs.t, t0, T_len, kBT, tid);

  float m[4], l[4], acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  // Live columns for this row tile: causal upper bound, window lower bound.
  const int t_last = min(t0 + kBT, T_len) - 1;
  const int s_hi = min(t_last, S - 1);
  const int s_lo = window > 0 ? max(t0 - window + 1, 0) : 0;

  for (int s0 = s_lo; s0 <= s_hi; s0 += kBS) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    load_tile<D>(kt, kb, ks.t, s0, S, kBS, tid);
    load_tile<D>(vt, vb, vs.t, s0, S, kBS, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[(tr + 16 * i) * RW + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[(tc + 16 * j) * RW + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
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
        pt[(tr + 16 * i) * kPStride + tc + 16 * j] = p;
      }
      sum = row_sum(sum);
      l[i] = l[i] * a + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= a;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBS; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[(tr + 16 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vv = vt[j * RW + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + tr + 16 * i;
    if (row >= T_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = out + b * os.b + row * os.t + h * os.h;
#pragma unroll
    for (int c = 0; c < CW; ++c) orow[tc + 16 * c] = acc[i][c] * inv;
  }
}

struct Problem {
  const void *q, *k, *v;
  void* out;
  int B, T_len, S, Hq, group, window;
  Strides qs, ks, vs, os;
};

template <int D>
int launch_simt(const Problem& p, cudaStream_t stream) {
  const int smem = static_cast<int>((kBT + 2 * kBS) * (D + 1) * sizeof(float) +
                                    kBT * kPStride * sizeof(float));
  auto kernel = flash_attention_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.T_len + kBT - 1) / kBT, p.Hq, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(p.q), static_cast<const float*>(p.k),
      static_cast<const float*>(p.v), static_cast<float*>(p.out), p.T_len, p.S, p.group,
      p.window, p.qs, p.ks, p.vs, p.os);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_simt(int D, const Problem& p, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_simt<32>(p, stream);
    case 64: return launch_simt<64>(p, stream);
    case 128: return launch_simt<128>(p, stream);
    case 256: return launch_simt<256>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- mma route -----------------------------------------------------------------

constexpr int kRows = 16;      // query rows of a block (one m16 tile a warp)
constexpr int kKeyTile = 32;   // keys a warp takes from each stage (four n8 tiles)
constexpr int kMaxWarps = 8;   // 256 threads: up to 255 registers each
constexpr int kStages = 2;     // K/V ring: the next stage lands during this one's mmas
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// Shared memory of the mma route, in bytes: the Q tile (heads x 16 rows),
// then the K/V ring (2 stages x splits x 32 keys, K and V) or, after the walk,
// the merge tile of splits 1.. (float32 rows of D + 8), whichever is larger,
// then each warp's row max and sum. A staged bf16 row is D + 8 elements.
// ops/kernels/flash_attention.py::mma_smem_bytes computes the same.
__host__ __device__ constexpr int mma_q_bytes(int D, int heads) {
  return heads * kRows * (D + 8) * 2;
}
__host__ __device__ constexpr int mma_ring_bytes(int D, int heads, int splits) {
  const int ring = kStages * splits * kKeyTile * 2 * (D + 8) * 2;
  const int merge = (splits - 1) * heads * kRows * (D + 8) * 4;
  return ring > merge ? ring : merge;
}
__host__ __device__ constexpr int mma_smem_bytes(int D, int heads, int splits) {
  return mma_q_bytes(D, heads) + mma_ring_bytes(D, heads, splits) +
         2 * splits * heads * kRows * 4;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out, int T_len, int S,
                           int group, int heads, int splits, int window, Strides qs,
                           Strides ks, Strides vs, Strides os) {
  constexpr int P = D + 8;   // elements a staged row
  constexpr int C = D / 8;   // 16-byte chunks a row
  constexpr int NT = D / 8;  // n8 tiles of the output
  // The simt kernel's extern array is float: another name, another type.
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bf16* qt = reinterpret_cast<bf16*>(mma_smem);
  uint8_t* ring_base = mma_smem + mma_q_bytes(D, heads);
  bf16* ring = reinterpret_cast<bf16*>(ring_base);
  float* ml = reinterpret_cast<float*>(ring_base + mma_ring_bytes(D, heads, splits));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int wh = warp % heads, split = warp / heads;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // the longest tiles first
  const int h0 = blockIdx.y * heads;
  const int hk = h0 / group;
  const int b = blockIdx.z;
  const int stage_keys = splits * kKeyTile;
  const int stage_elems = stage_keys * P;  // K (or V) of one stage

  // Live keys of the block's rows: causal upper bound, window lower bound.
  const int t_last = min(t0 + kRows, T_len) - 1;
  const int s_hi = min(t_last, S - 1);
  const int s_lo = window > 0 ? max(t0 - window + 1, 0) : 0;
  const int n_stages = s_hi >= s_lo ? (s_hi - s_lo + stage_keys) / stage_keys : 0;

  const bf16* qb = q + b * qs.b + h0 * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // Q: heads x 16 rows, zero past T. It joins the first stage's group.
  for (int i = tid; i < heads * kRows * C; i += nthreads) {
    const int r = i / C, c = i % C;  // r = head * 16 + row
    const int row = t0 + r % kRows;
    const bool ok = row < T_len;
    oqt::cp_async16(qt + r * P + c * 8, ok ? qb + row * qs.t + (r / kRows) * qs.h + c * 8 : qb,
                    ok);
  }
  auto load_stage = [&](int s) {
    bf16* kd = ring + (s % kStages) * 2 * stage_elems;
    bf16* vd = kd + stage_elems;
    const int key0 = s_lo + s * stage_keys;
    for (int i = tid; i < stage_keys * C; i += nthreads) {
      const int r = i / C, c = i % C;
      const int key = key0 + r;
      const bool ok = key <= s_hi;  // zero past the live range (and past S)
      oqt::cp_async16(kd + r * P + c * 8, ok ? kb + key * ks.t + c * 8 : kb, ok);
      oqt::cp_async16(vd + r * P + c * 8, ok ? vb + key * vs.t + c * 8 : vb, ok);
    }
  };
  if (n_stages > 0) load_stage(0);
  oqt::cp_async_commit();

  float m[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of their running sums
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const bf16* qw = qt + wh * kRows * P;
  const int row0 = t0 + g, row1 = t0 + g + 8;
  for (int s = 0; s < n_stages; ++s) {
    oqt::cp_async_wait<0>();
    __syncthreads();  // stage s landed; every warp is done with stage s - 1
    if (s + 1 < n_stages) load_stage(s + 1);
    oqt::cp_async_commit();

    const int key0 = s_lo + s * stage_keys + split * kKeyTile;
    if (key0 > s_hi) continue;  // this split's slice holds no live key
    const bf16* kt = ring + (s % kStages) * 2 * stage_elems + split * kKeyTile * P;
    const bf16* vt = kt + stage_elems;

    // S = Q K^T over 32 keys: four n8 tiles.
    float sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const bf16* qa = qw + (lane & 15) * P + (lane >> 4) * 8;
    const bf16* kp = kt + ((lane & 7) + ((lane >> 4) << 3)) * P + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b0[4], b1[4];
      oqt::ldmatrix_x4(a, qa + kk * 16);
      oqt::ldmatrix_x4(b0, kp + kk * 16);
      oqt::ldmatrix_x4(b1, kp + 16 * P + kk * 16);
      oqt::mma_bf16(sc[0], a, b0[0], b0[1]);
      oqt::mma_bf16(sc[1], a, b0[2], b0[3]);
      oqt::mma_bf16(sc[2], a, b1[0], b1[1]);
      oqt::mma_bf16(sc[3], a, b1[2], b1[3]);
    }

    // Edge slices only: the diagonal, the window's start, past S.
    const bool edge = key0 + kKeyTile - 1 > t0 || key0 + kKeyTile > S ||
                      (window > 0 && key0 <= t0 + kRows - 1 - window);
    if (edge) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = key0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          const bool ok = col <= row && col < S && (window <= 0 || col > row - window);
          if (!ok) sc[j][e] = kNegInf;
        }
    }

    // Online softmax; a masked score is -1e30, so its p is exactly 0.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2], m_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      m_safe[r] = m_new <= kNegInf / 2 ? 0.f : m_new;
      alpha[r] = m[r] <= kNegInf / 2 ? 0.f : exp2f((m[r] - m_safe[r]) * kLog2e);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2f((sc[j][e] - m_safe[e >> 1]) * kLog2e);
        l[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

    // O += P V: the S tiles, rounded to bf16, are the A fragments.
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
      const bf16* vp = vt + (kk * 16 + (lane & 15)) * P + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt) {
        uint32_t bv[4];
        oqt::ldmatrix_x4_trans(bv, vp + dt * 16);
        oqt::mma_bf16(acc[2 * dt], a, bv[0], bv[1]);
        oqt::mma_bf16(acc[2 * dt + 1], a, bv[2], bv[3]);
      }
    }
  }
  oqt::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring; it becomes the merge tile

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (splits > 1) {
    // Rescale every split to the common max; splits 1.. hand their acc to split 0.
    float* mine = ml + 2 * ((split * heads + wh) * kRows);
    if (t == 0) {
      mine[2 * g] = m[0];
      mine[2 * g + 1] = l[0];
      mine[2 * (g + 8)] = m[1];
      mine[2 * (g + 8) + 1] = l[1];
    }
    __syncthreads();
    float f[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      float m_all = kNegInf;
      for (int j = 0; j < splits; ++j)
        m_all = fmaxf(m_all, ml[2 * ((j * heads + wh) * kRows + row)]);
      const float m_all_safe = m_all <= kNegInf / 2 ? 0.f : m_all;
      float l_all = 0.f;
      for (int j = 0; j < splits; ++j) {
        const float mj = ml[2 * ((j * heads + wh) * kRows + row)];
        const float lj = ml[2 * ((j * heads + wh) * kRows + row) + 1];
        l_all += mj <= kNegInf / 2 ? 0.f : exp2f((mj - m_all_safe) * kLog2e) * lj;
      }
      f[r] = m[r] <= kNegInf / 2 ? 0.f : exp2f((m[r] - m_all_safe) * kLog2e);
      l[r] = l_all;
    }
    float* tile = reinterpret_cast<float*>(ring_base);  // (splits - 1, heads, 16, D + 8)
    if (split > 0) {
      float* dst = tile + ((split - 1) * heads + wh) * kRows * P;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        *reinterpret_cast<float2*>(dst + g * P + 8 * j + 2 * t) =
            make_float2(acc[j][0] * f[0], acc[j][1] * f[0]);
        *reinterpret_cast<float2*>(dst + (g + 8) * P + 8 * j + 2 * t) =
            make_float2(acc[j][2] * f[1], acc[j][3] * f[1]);
      }
    }
    __syncthreads();
    if (split > 0) return;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= f[e >> 1];
    for (int z = 1; z < splits; ++z) {
      const float* src = tile + ((z - 1) * heads + wh) * kRows * P;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 lo = *reinterpret_cast<const float2*>(src + g * P + 8 * j + 2 * t);
        const float2 hi = *reinterpret_cast<const float2*>(src + (g + 8) * P + 8 * j + 2 * t);
        acc[j][0] += lo.x;
        acc[j][1] += lo.y;
        acc[j][2] += hi.x;
        acc[j][3] += hi.y;
      }
    }
  }

  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  bf16* ob = out + b * os.b + (h0 + wh) * os.h + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + g + 8 * r;
    if (row >= T_len) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(ob + row * os.t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      orow[4 * j] = pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
  }
}

template <int D>
int launch_mma(const Problem& p, int heads, int splits, int smem, cudaStream_t stream) {
  if (heads < 1 || splits < 1 || heads * splits > kMaxWarps || p.group % heads != 0 ||
      smem != mma_smem_bytes(D, heads, splits))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_mma_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((p.T_len + kRows - 1) / kRows, p.Hq / heads, p.B);
  kernel<<<grid, 32 * heads * splits, smem, stream>>>(
      static_cast<const bf16*>(p.q), static_cast<const bf16*>(p.k), static_cast<const bf16*>(p.v),
      static_cast<bf16*>(p.out), p.T_len, p.S, p.group, heads, splits, p.window, p.qs,
      p.ks, p.vs, p.os);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte cp.async reads: base pointers on 16 bytes, strides in whole 8-element chunks.
bool mma_aligned(const void* ptr, const Strides& s) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s.b % 8 == 0 && s.t % 8 == 0 &&
         s.h % 8 == 0;
}

int dispatch_mma(int D, const Problem& p, int heads, int splits, int smem,
                 cudaStream_t stream) {
  if (!mma_aligned(p.q, p.qs) || !mma_aligned(p.k, p.ks) || !mma_aligned(p.v, p.vs) ||
      !mma_aligned(p.out, p.os))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (D) {
    case 32: return launch_mma<32>(p, heads, splits, smem, stream);
    case 64: return launch_mma<64>(p, heads, splits, smem, stream);
    case 128: return launch_mma<128>(p, heads, splits, smem, stream);
    case 256: return launch_mma<256>(p, heads, splits, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// is_bf16: 1 for bfloat16 tensors, 0 for float32. D in {32, 64, 128, 256}.
// window <= 0: no sliding window. strides: (b, t, h) of q, k, v, out in
// elements. The launch plan (ops/kernels/flash_attention.py::fa_plan):
// route 1 is the mma route (bfloat16; 16-byte-aligned bases and strides in
// multiples of 8 elements), with `heads` query heads and `splits` key splits
// a block and `smem` bytes of shared memory (checked against the kernel's
// own layout); route 0 the simt route (float32; the other plan fields
// unused). Returns cudaGetLastError() after the launch.
extern "C" int oqt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   int is_bf16, int B, int T_len, int S, int Hq, int Hkv,
                                   int D, int window, const long long* strides, int route,
                                   int heads, int splits, int smem, void* stream) {
  const Problem p{q, k, v, out, B, T_len, S, Hq, Hq / Hkv, window,
                  Strides{strides[0], strides[1], strides[2]},
                  Strides{strides[3], strides[4], strides[5]},
                  Strides{strides[6], strides[7], strides[8]},
                  Strides{strides[9], strides[10], strides[11]}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_mma(D, p, heads, splits, smem, st);
  }
  if (is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_simt(D, p, st);
}
