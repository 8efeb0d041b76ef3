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
// int32; out (B, Hkv * G, D) float32. D % 16 == 0, D <= 256, G <= 8.
//
// What bounds it on the card: the live int8 K/V bytes (B = 32, 640 live
// slots, D = 256: 10.5 MB per global layer, ~3 us at 3.35 TB/s). A decode
// step has few (sequence, kv head) pairs (32 at B = 32 on Gemma-3-270M's one
// KV head) for 132 SMs, so the live range is split across blocks too; and a
// block walks few tiles, so its own latency (load, four barriers, the two
// products) sets the time.
//
// Design: the grid is (kv head, sequence, split); the launch plan
// (ops/kernels/flash_decode.py::fd_plan) sets the splits so that the grid
// fills the SMs. A block reads pos[b], computes its sequence's live range,
// cuts it into 64-key tiles counted from its first key, and walks the tiles
// [z * T / splits, (z + 1) * T / splits) of the range's T: whole tiles,
// balanced within each sequence, with no host sync. The in-block loop
// replaces the TPU's sequential S grid axis and its clamped index maps, so
// dead slots are never read. The G query heads of the group share each K/V
// tile, so each live byte is read once per step. Per tile:
//   - load: K and V rows and their scales by 16-byte loads into registers,
//     issued while the previous tile computes (the first tile's beside q's
//     loads, so a block waits on device memory about once for its tiles),
//     then into shared memory rows padded by four words (the score phase's 8
//     keys x 4 lanes of a warp hit 32 banks);
//   - scores: four lanes a key, each over every fourth word of the row, all
//     G heads at once, so each K byte is converted to float once (not once a
//     head); two shuffles sum the four parts;
//   - softmax: one warp a head, online (m, l) in shared memory; v's scale
//     folds into p;
//   - PV: a thread owns one word (4 columns) of every head for every fourth
//     key, each V byte converted once, the accumulators in registers across
//     tiles (rescaled by each tile's factor); the four key quarters are
//     summed in order at the end.
// Bytes become floats without I2F (a quarter-rate unit): a byte biased by
// 128 is the low mantissa byte of 2^23, and one subtraction leaves its
// value, exactly. All products are float32 on the CUDA cores, as the
// reference's HIGHEST precision (tf32 would change its numbers).
//
// The merge: the splits of a (sequence, kv head) pair are launched as one
// thread block cluster (at most 8 blocks, the portable size). Each block
// leaves its (acc, m, l) partial in its own shared memory; after a cluster
// barrier, warp g of every block reads the splits' m and l of head g through
// distributed shared memory (a lane a split) and takes the factors exp(m_z -
// max m); then block z writes the z-th share of the pair's outputs, each
// element summed over the splits' partials in split order; a second barrier
// keeps every block's shared memory alive until the others have read it. One
// launch, no scratch and no counters, no round trip through device memory
// (a merge through scratch, the last block of a pair counting itself in,
// costs its fence, count and reads: 6-12 us of a 25-40 us layer on the
// H100); deterministic and replayable in a CUDA graph. A plan of one split
// writes the output directly.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 64;      // keys per tile
constexpr int kThreads = 256;  // 8 warps: four quarters of 64 keys in the score phase
constexpr int kMaxD = 256;     // PV: one word of 4 columns x 4 key quarters a thread
constexpr int kMaxClusterSplits = 8;  // the portable cluster size
constexpr float kNegInf = -1e30f;
static_assert(kTile * 4 == kThreads, "four lanes a key");

// The four signed bytes of w as floats, exactly: byte i XOR 0x80 (its value
// plus 128) becomes the low byte of 2^23's mantissa, and subtracting 2^23 +
// 128 leaves the value.
__device__ __forceinline__ float4 bytes_to_float4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr uint32_t kTwo23 = 0x4B000000u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, kTwo23, 0x7540)) - kBias,
                     __uint_as_float(__byte_perm(u, kTwo23, 0x7541)) - kBias,
                     __uint_as_float(__byte_perm(u, kTwo23, 0x7542)) - kBias,
                     __uint_as_float(__byte_perm(u, kTwo23, 0x7543)) - kBias);
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

// MAXG: the group sizes up to MAXG share one build (G <= MAXG heads used).
template <int MAXG>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const int8_t* __restrict__ k,
                    const float* __restrict__ ks, const int8_t* __restrict__ v,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    float* __restrict__ out, int S, int Hkv, int G, int D, int window) {
  // A thread's float4s of q and 16-byte chunks of a K (or V) tile.
  constexpr int kQVecs = (MAXG * kMaxD / 4 + kThreads - 1) / kThreads;
  constexpr int kTileLoads = kTile * (kMaxD / 16) / kThreads;
  extern __shared__ float4 smem4[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D4 = D / 4;          // 32-bit words (4 codes) per K/V row
  const int row_words = D4 + 4;  // padded, 16-byte aligned rows

  uint32_t* kt = reinterpret_cast<uint32_t*>(smem4);  // (kTile, row_words)
  uint32_t* vt = kt + kTile * row_words;
  float* qs = reinterpret_cast<float*>(vt + kTile * row_words);  // (G, D)
  float* sc = qs + G * D;            // (G, kTile): scores, then p * vs
  float* ksc = sc + G * kTile;       // (kTile)
  float* vsc = ksc + kTile;          // (kTile)
  float* m_run = vsc + kTile;        // (G)
  float* l_run = m_run + G;          // (G)
  float* alpha = l_run + G;          // (G)

  // Every global load of the first tile is issued before any is used: a
  // block walks few tiles, so it waits on device memory about once.
  const int p = pos[b];
  const size_t head_base = (static_cast<size_t>(b) * Hkv + h) * G * D;  // q and out
  float4 qreg[kQVecs];
#pragma unroll
  for (int e = 0; e < kQVecs; ++e) {
    const int i = tid + e * kThreads;
    if (i < G * D4) qreg[e] = reinterpret_cast<const float4*>(q + head_base)[i];
  }

  // Score phase: key sj, words sc0, sc0 + 4, ... of its row.
  const int sj = tid >> 2, sc0 = tid & 3;
  // PV phase: word pw (columns 4pw .. 4pw + 3) of every head, keys pq, pq + 4, ...
  const int pw = tid % D4, pq = tid / D4;
  const bool pv_on = tid < 4 * D4;
  float4 acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int hi = min(p, S - 1);
  const int lo = window > 0 ? max(p - window + 1, 0) : 0;
  const int chunks = D / 16;  // 16-byte chunks per row
  // This split's whole tiles of the live range [lo, hi].
  const int tiles = (max(hi - lo + 1, 0) + kTile - 1) / kTile;
  const int first = lo + kTile * (z * tiles / splits);
  const int end = min(lo + kTile * ((z + 1) * tiles / splits), hi + 1);

  // A tile's K/V rows and scales, through registers: loaded while the
  // previous tile is computed, stored once it is consumed.
  uint4 kreg[kTileLoads], vreg[kTileLoads];
  float ks_reg = 0.f, vs_reg = 0.f;
  auto load_tile = [&](int s0) {
    const int n = min(kTile, end - s0);
#pragma unroll
    for (int e = 0; e < kTileLoads; ++e) {
      const int i = tid + e * kThreads;
      if (i < n * chunks) {
        const int r = i / chunks;
        const size_t off =
            ((static_cast<size_t>(b) * S + s0 + r) * Hkv + h) * D + 16 * (i - r * chunks);
        kreg[e] = *reinterpret_cast<const uint4*>(k + off);
        vreg[e] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
    if (tid < n) {
      const size_t off = (static_cast<size_t>(b) * S + s0 + tid) * Hkv + h;
      ks_reg = ks[off];
      vs_reg = vs[off];
    }
  };
  auto store_tile = [&](int n) {
#pragma unroll
    for (int e = 0; e < kTileLoads; ++e) {
      const int i = tid + e * kThreads;
      if (i < n * chunks) {
        const int r = i / chunks;
        const int c = i - r * chunks;
        *reinterpret_cast<uint4*>(kt + r * row_words + 4 * c) = kreg[e];
        *reinterpret_cast<uint4*>(vt + r * row_words + 4 * c) = vreg[e];
      }
    }
    if (tid < n) {
      ksc[tid] = ks_reg;
      vsc[tid] = vs_reg;
    }
  };
  if (first < end) load_tile(first);

#pragma unroll
  for (int e = 0; e < kQVecs; ++e) {
    const int i = tid + e * kThreads;
    if (i < G * D4) reinterpret_cast<float4*>(qs)[i] = qreg[e];
  }
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
  }

  for (int s0 = first; s0 < end; s0 += kTile) {
    const int n = min(kTile, end - s0);
    __syncthreads();  // the previous tile is consumed (and the init is visible)
    store_tile(n);
    __syncthreads();
    if (s0 + kTile < end) load_tile(s0 + kTile);  // in flight while this tile computes

    // Scores: the four lanes of key sj sum every fourth word, all heads.
    float d[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) d[g] = 0.f;
    if (sj < n) {
      const uint32_t* kr = kt + sj * row_words;
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      for (int w = sc0; w < D4; w += 4) {
        const float4 kv = bytes_to_float4(kr[w]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float4 qv = q4[g * D4 + w];
            d[g] = fmaf(qv.x, kv.x, d[g]);
            d[g] = fmaf(qv.y, kv.y, d[g]);
            d[g] = fmaf(qv.z, kv.z, d[g]);
            d[g] = fmaf(qv.w, kv.w, d[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      d[g] += __shfl_xor_sync(0xffffffffu, d[g], 1);
      d[g] += __shfl_xor_sync(0xffffffffu, d[g], 2);
    }
    if (sc0 == 0) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) sc[g * kTile + sj] = sj < n ? d[g] * ksc[sj] : kNegInf;
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

    // acc[g] = alpha[g] * acc[g] + sum over this thread's keys of pv[g, j] * V[j, word pw].
    if (pv_on) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float a = alpha[g];
          acc[g].x *= a;
          acc[g].y *= a;
          acc[g].z *= a;
          acc[g].w *= a;
        }
      }
      for (int j = pq; j < n; j += 4) {
        const float4 vv = bytes_to_float4(vt[j * row_words + pw]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
            const float pj = sc[g * kTile + j];
            acc[g].x = fmaf(pj, vv.x, acc[g].x);
            acc[g].y = fmaf(pj, vv.y, acc[g].y);
            acc[g].z = fmaf(pj, vv.z, acc[g].z);
            acc[g].w = fmaf(pj, vv.w, acc[g].w);
          }
        }
      }
    }
  }

  // The four key quarters' accumulators, summed in order: red (4, G, D) over
  // the (drained) K/V tiles.
  __syncthreads();
  float* red = reinterpret_cast<float*>(kt);
  if (pv_on) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) reinterpret_cast<float4*>(red + (pq * G + g) * D)[pw] = acc[g];
  }
  __syncthreads();
  auto summed = [&](int i) {
    return ((red[i] + red[G * D + i]) + red[2 * G * D + i]) + red[3 * G * D + i];
  };
  if (splits == 1) {
    for (int i = tid; i < G * D; i += kThreads) {
      out[head_base + i] = summed(i) / fmaxf(l_run[i / D], 1e-30f);
    }
    return;
  }

  // The merge, inside the cluster of the pair's splits (block rank z). This
  // block's partial acc goes to qs (q is spent); m and l are in m_run, l_run.
  for (int i = tid; i < G * D; i += kThreads) qs[i] = summed(i);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial of the pair is written and visible
  // Warp g: the split factors exp(m_z - max m) of head g (a lane a split; 0
  // for an empty split) into sc, and the merged l = sum f_z * l_z into alpha.
  for (int g = warp; g < G; g += kThreads / 32) {
    const bool on = lane < splits;
    const float mz = on ? *cluster.map_shared_rank(m_run + g, lane) : kNegInf;
    const float lz = on ? *cluster.map_shared_rank(l_run + g, lane) : 0.f;
    const float mx = warp_max(mz);
    const float f = mz <= kNegInf / 2 ? 0.f : expf(mz - mx);
    if (on) sc[g * kTile + lane] = f;
    const float l = warp_sum(f * lz);
    if (lane == 0) alpha[g] = l;
  }
  __syncthreads();
  // This block's share of the outputs, [z * chunk, (z + 1) * chunk): each
  // split's partial read from its block's shared memory, summed in split
  // order.
  const int chunk = (G * D + splits - 1) / splits;
  for (int i = z * chunk + tid; i < min((z + 1) * chunk, G * D); i += kThreads) {
    const int g = i / D;
    float parts[kMaxClusterSplits];
#pragma unroll
    for (int zz = 0; zz < kMaxClusterSplits; ++zz)
      parts[zz] = zz < splits ? *cluster.map_shared_rank(qs + i, zz) : 0.f;
    float o = 0.f;
#pragma unroll
    for (int zz = 0; zz < kMaxClusterSplits; ++zz)
      if (zz < splits) o += sc[g * kTile + zz] * parts[zz];
    out[head_base + i] = o / fmaxf(alpha[g], 1e-30f);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Dynamic shared memory for group size G and head dim D (39.5 KB at G = 4,
// D = 256; above 48 KB the launch needs the opt-in attribute). The K/V tiles
// also hold the end's (4, G, D) reduction (G <= 8).
int smem_bytes(int G, int D) {
  const int floats = G * D + G * kTile + 2 * kTile + 3 * G;
  return 2 * kTile * (D / 4 + 4) * 4 + static_cast<int>(sizeof(float)) * floats;
}

template <int MAXG>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* pos, void* out, int B, int S, int Hkv, int G, int D, int window,
           int splits, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<MAXG>;
  const int smem = smem_bytes(G, D);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // The splits of a (sequence, kv head) pair form one thread block cluster.
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(Hkv, B, splits);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const float*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v), static_cast<const float*>(vs),
      static_cast<const int*>(pos), static_cast<float*>(out), S, Hkv, G, D, window);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// window <= 0: no sliding window. splits: blocks a (sequence, kv head) pair
// and the size of its cluster (the launch plan,
// ops/kernels/flash_decode.py::fd_plan; at most 8). Takes D % 16 == 0,
// D <= 256 and G <= 8. Returns the launch's error, or cudaGetLastError()
// after it (a launch refused for its shared memory or cluster never runs).
extern "C" int oqt_flash_decode(const void* q, const void* k, const void* ks, const void* v,
                                const void* vs, const void* pos, void* out, int B, int S,
                                int Hkv, int G, int D, int window, int splits, void* stream) {
  if (splits < 1 || splits > kMaxClusterSplits || D % 16 != 0 || D > kMaxD || G < 1 || G > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto fn = G == 1 ? &launch<1> : G == 2 ? &launch<2> : G <= 4 ? &launch<4> : &launch<8>;
  return fn(q, k, ks, v, vs, pos, out, B, S, Hkv, G, D, window, splits,
            static_cast<cudaStream_t>(stream));
}
