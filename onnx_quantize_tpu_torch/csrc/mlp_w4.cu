// Fused W4 GeGLU MLP for Hopper (sm_90a): one launch per layer.
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/mlp_w4.py
// (_mlp_call -> _mlp_kernel):
//     h   = x @ dequant(W_gate_up)              (M, 2I), float32
//     act = gelu_tanh(h[:, :I]) * h[:, I:]      float32, rounded to x's type
//     y   = act @ dequant(W_down)               (M, N), float32
// with both weights packed W4 in the group-pair layout (matmul_w4.cu) and
// the dequant affine applied to each group's partial dot:
//     x . ((w - zp) * s) == (x . w - sum(x) * zp) * s.
//
// The TPU kernel runs as one grid instance; here the intermediate dimension
// is split across blocks, and each block's partial y is summed inside the
// launch in a fixed order (two launches give the same bits).
//
// Shapes: x (M, K_pad) float32/bfloat16, K_pad = 2 * gate-up packed rows;
// wg (K_pad/2, 2I) uint8, sg/zg (pairs_g, 2, 2I) float32; wd (I_pad/2, N)
// uint8, sd/zd (pairs_d, 2, N) float32; out (M, N) float32. Pad groups carry
// scale 1 and zero point 0; zero x columns null the gate-up pad rows, and the
// down pad rows (j >= I) belong to no block.
//
// What bounds it on the card: Gemma-3-270M's two packed weights and their
// scales are ~2.6 MB a layer, ~0.8 us at 3.35 TB/s; at decode the work is a
// chain of dependent steps (load, gate-up product, GeGLU, down product,
// reduction) on every SM, so latency sets the time. Two routes, chosen by
// the launch plan (ops/kernels/mlp_w4.py::mlp_w4_plan):
//
// mma (bf16 x; group sizes and I multiples of 16, N of 8 x the cluster size;
//   16-byte-aligned operands): W4's tensor-core core (matmul_w4.cu). Block b
//   owns the 16 intermediate columns j0 = 16 b .. j0 + 15 of the gate-up
//   product (128 blocks at Gemma-3-270M's I = 2048, one wave). The blocks
//   form thread block clusters (at most 16, beyond 8 a non-portable size), and
//   in the down product block rank r of a cluster owns the N / cs columns of
//   y from n0 = r N / cs over the cluster's cs x 16 intermediate columns.
//   1. Staging: by 16-byte cp.async, one commit group a group pair, the
//      block's 16 gate and 16 up columns of the pair's packed rows (a 32-byte
//      row, padded to 48 so the fragment reads hit 32 banks) and their scales
//      and zero points; then the down rows and scales of its N / cs columns
//      for each of the cluster's 16-column K steps. x, which every block
//      reads whole, comes by bulk copies (cp.async.bulk) multicast to the
//      whole cluster, each block issuing every cs-th row, one mbarrier a
//      pair, so each row leaves L2 once a cluster in one request (16-byte
//      copies by every block cost ~5 us at M = 32 on the H100).
//   2. Gate-up product on mma.sync m16n8k16 bf16 -> f32: nibbles become exact
//      bf16 through oqt::nibble_pairs; each 16-row slice of packed rows feeds
//      a low- and a high-nibble mma, and a mma against ones gives x's sums.
//      Warp (nt, kh) takes n-tile nt of the 32 staged columns for every
//      m-tile (one B fragment built per slice) and the even or odd slices of
//      each pair, starting on a pair when its data has landed; it folds
//      (d - xsum * zp) * s at the pair's end, which is exact per chunk, as in
//      W4's K split. The two K halves are summed in shared memory in order.
//   3. GeGLU in float32, rounded to bf16 into the block's (BM x 16) act tile.
//   4. After a cluster barrier each warp copies the act tiles of its K steps
//      (K step kk is rank kk's tile) from the cluster's blocks through
//      distributed shared memory: the A operands of the down product.
//   5. Down product: per K step, A times the step's 16 packed down rows (one
//      nibble half, picked by the step's group) for the block's columns,
//      folded with the group's scale and zero point against the act tile's
//      row sums (a mma against ones); the 8 warps' partials are summed in
//      shared memory in warp order.
//   6. The block's (BM x N / cs) piece of the cluster's y goes out directly
//      with one cluster; otherwise to scratch, then the block fences and
//      counts itself on its (pass, rank) counter, and the last cluster's
//      block of that rank to arrive sums the pieces in cluster order, writes
//      the output and sets the counter back to 0. One launch: no memset, no
//      cooperative launch, no float atomics; replayable in a CUDA graph.
//   M is walked in passes of BM = 16 (M <= 16) or 32 rows. At most 128
//   registers a thread and 108 KB of shared memory a block at 270M, so two
//   blocks fit an SM and all the clusters run at once.
//
// simt (float32 x, or any other shape or alignment): the CUDA-core kernel of
//   the first port. Block b owns the TJ = 32 intermediate columns j0 = b*TJ ..
//   j0+TJ-1 (a slice never crosses a down scale group, since the group size is
//   a multiple of 32):
//   1. it computes its gate columns j and up columns I + j over all of K,
//      32 rows of M at a time (thread tx owns column j0 + tx, ty four rows),
//      applies GeGLU in float32 and rounds act to x's type in shared memory;
//   2. it multiplies its act slice by its TJ rows of dequant(W_down) into a
//      partial (M, N) tile in scratch;
//   3. after a grid-wide barrier (a counter and __threadfence; the launch is
//      cooperative, so every block is resident), every block sums its share
//      of the (M, N) outputs over all partials, in block order; the last
//      block to leave sets the barrier's two counters back to 0.

#include <cooperative_groups.h>

#include <initializer_list>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

__device__ __forceinline__ float gelu_tanh(float v) {
  // Gemma's approximate gelu: 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3))).
  const float c = 0.7978845608028654f;
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
}

// ---- simt route ---------------------------------------------------------------

constexpr int kTJ = 32;  // intermediate columns per block (one per lane)
constexpr int kBM = 32;  // rows of M per pass (4 per thread row)
constexpr int kRPT = kBM / oqt::kThreadsM;
using oqt::kRowChunk;
using oqt::kThreadsM;
using oqt::kThreadsN;

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float nibble(int b, int high, int sign_off) {
  const int v = high ? (b >> 4) : (b & 0x0F);
  return static_cast<float>((v ^ sign_off) - sign_off);
}

// Every block arrives on count[0], then waits until all have: the launch is
// cooperative (all blocks resident), and a stuck wait traps instead of
// hanging the card.
__device__ __forceinline__ void grid_barrier(unsigned int* count, unsigned int n_blocks) {
  __threadfence();  // this thread's partial writes are visible device-wide
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    atomicAdd(count, 1u);
    unsigned int spins = 0;
    while (atomicAdd(count, 0u) < n_blocks) {
      __nanosleep(64);
      if (++spins > (1u << 26)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(oqt::kThreads)
mlp_w4_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wg,
              const float* __restrict__ sg, const float* __restrict__ zg,
              const uint8_t* __restrict__ wd, const float* __restrict__ sd,
              const float* __restrict__ zd, float* __restrict__ ws,
              unsigned int* __restrict__ counter, float* __restrict__ out, int M, int K_pad,
              int inter, int N, int gs_g, int gs_d, int sign_g, int sign_d) {
  __shared__ float xs[2][kBM][kRowChunk];
  __shared__ float xsum[2][kBM];
  __shared__ float act[kBM][kTJ + 1];
  __shared__ float asum[kBM];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsN + tx;
  const int n_blocks = gridDim.x;
  const int b = blockIdx.x;
  const int j0 = b * kTJ;
  const int n2 = 2 * inter;
  const int pairs_g = K_pad / (2 * gs_g);
  // The slice's down rows: logical group g, packed rows from `drow`.
  const int g = j0 / gs_d;
  const int dhigh = g & 1;
  const size_t drow = static_cast<size_t>(g >> 1) * gs_d + (j0 % gs_d);

  for (int mc = 0; mc < M; mc += kBM) {
    // 1. h for gate column j0 + tx (c = 0) and up column inter + j0 + tx (c = 1).
    float acc[kRPT][2];
#pragma unroll
    for (int i = 0; i < kRPT; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int p = 0; p < pairs_g; ++p) {
      float dlo[kRPT][2], dhi[kRPT][2];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) dlo[i][0] = dlo[i][1] = dhi[i][0] = dhi[i][1] = 0.f;
      __syncthreads();  // the previous pair's epilogue has read xsum
      if (tid < 2 * kBM) xsum[tid / kBM][tid % kBM] = 0.f;
      for (int r0 = 0; r0 < gs_g; r0 += kRowChunk) {
        const int rc = min(kRowChunk, gs_g - r0);
        __syncthreads();  // the previous chunk is consumed
        oqt::stage_rows<T, kBM>(xs[0], x, M, K_pad, mc, (2 * p) * gs_g + r0, rc, tid);
        oqt::stage_rows<T, kBM>(xs[1], x, M, K_pad, mc, (2 * p + 1) * gs_g + r0, rc, tid);
        __syncthreads();
        if (tid < 2 * kBM) {
          const int h = tid / kBM, m = tid % kBM;
          float s = 0.f;
          for (int r = 0; r < rc; ++r) s += xs[h][m][r];
          xsum[h][m] += s;
        }
        const uint8_t* wrow = wg + static_cast<size_t>(p * gs_g + r0) * n2 + j0 + tx;
        for (int r = 0; r < rc; ++r, wrow += n2) {
          const int bg = wrow[0], bu = wrow[inter];
          const float glo = nibble(bg, 0, sign_g), ghi = nibble(bg, 1, sign_g);
          const float ulo = nibble(bu, 0, sign_g), uhi = nibble(bu, 1, sign_g);
#pragma unroll
          for (int i = 0; i < kRPT; ++i) {
            const float xl = xs[0][ty + i * kThreadsM][r];
            const float xh = xs[1][ty + i * kThreadsM][r];
            dlo[i][0] = fmaf(xl, glo, dlo[i][0]);
            dhi[i][0] = fmaf(xh, ghi, dhi[i][0]);
            dlo[i][1] = fmaf(xl, ulo, dlo[i][1]);
            dhi[i][1] = fmaf(xh, uhi, dhi[i][1]);
          }
        }
      }
      __syncthreads();  // xsum is complete
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const size_t lo_row = static_cast<size_t>(2 * p) * n2 + c * inter + j0 + tx;
        const float s_lo = sg[lo_row], z_lo = zg[lo_row];
        const float s_hi = sg[lo_row + n2], z_hi = zg[lo_row + n2];
#pragma unroll
        for (int i = 0; i < kRPT; ++i) {
          const int m = ty + i * kThreadsM;
          acc[i][c] += (dlo[i][c] - xsum[0][m] * z_lo) * s_lo +
                       (dhi[i][c] - xsum[1][m] * z_hi) * s_hi;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
      act[ty + i * kThreadsM][tx] = round_to(gelu_tanh(acc[i][0]) * acc[i][1], T());
    __syncthreads();
    if (tid < kBM) {
      float s = 0.f;
      for (int t = 0; t < kTJ; ++t) s += act[tid][t];
      asum[tid] = s;
    }
    __syncthreads();

    // 2. The slice's partial of y: act (kBM, TJ) @ dequant(down rows).
    const int rows = min(kBM, M - mc);
    for (int n = tid; n < N; n += oqt::kThreads) {
      float a[kBM];
#pragma unroll
      for (int m = 0; m < kBM; ++m) a[m] = 0.f;
      const uint8_t* wcol = wd + drow * N + n;
      for (int t = 0; t < kTJ; ++t) {
        const float wv = nibble(wcol[static_cast<size_t>(t) * N], dhigh, sign_d);
#pragma unroll
        for (int m = 0; m < kBM; ++m) a[m] = fmaf(act[m][t], wv, a[m]);
      }
      const float s = sd[static_cast<size_t>(g) * N + n], z = zd[static_cast<size_t>(g) * N + n];
      float* dst = ws + (static_cast<size_t>(b) * M + mc) * N + n;
#pragma unroll
      for (int m = 0; m < kBM; ++m)
        if (m < rows) dst[static_cast<size_t>(m) * N] = (a[m] - asum[m] * z) * s;
    }
    __syncthreads();  // act is read before the next pass overwrites it
  }

  // 3. Every block sums its share of the outputs over all partials, in order.
  grid_barrier(counter, n_blocks);
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t idx = static_cast<size_t>(b) * oqt::kThreads + tid; idx < total;
       idx += static_cast<size_t>(n_blocks) * oqt::kThreads) {
    float s = 0.f;
    for (int bb = 0; bb < n_blocks; ++bb) s += __ldcg(ws + static_cast<size_t>(bb) * total + idx);
    out[idx] = s;
  }
  // Every block left the barrier before counting itself out, so the last one
  // out may clear both counters for the next launch (or graph replay).
  __syncthreads();
  if (tid == 0 && atomicAdd(counter + 1, 1u) == static_cast<unsigned>(n_blocks - 1)) {
    counter[0] = 0u;
    counter[1] = 0u;
  }
}

template <typename T>
int launch_simt(const void* x, const void* wg, const void* sg, const void* zg, const void* wd,
                const void* sd, const void* zd, void* ws, void* counter, void* out, int M,
                int K_pad, int inter, int N, int gs_g, int gs_d, int sign_g, int sign_d,
                cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wgp = static_cast<const uint8_t*>(wg);
  const float* sgp = static_cast<const float*>(sg);
  const float* zgp = static_cast<const float*>(zg);
  const uint8_t* wdp = static_cast<const uint8_t*>(wd);
  const float* sdp = static_cast<const float*>(sd);
  const float* zdp = static_cast<const float*>(zd);
  float* wsp = static_cast<float*>(ws);
  unsigned int* cp = static_cast<unsigned int*>(counter);
  float* op = static_cast<float*>(out);
  void* args[] = {&xp, &wgp, &sgp, &zgp, &wdp, &sdp, &zdp, &wsp, &cp, &op, &M, &K_pad,
                  &inter, &N, &gs_g, &gs_d, &sign_g, &sign_d};
  const dim3 grid(inter / kTJ);
  const dim3 block(kThreadsN, kThreadsM);
  const cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)mlp_w4_kernel<T>, grid, block, args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- mma route ----------------------------------------------------------------

constexpr int kSlice = 16;        // packed rows an mma slice; intermediate columns a block
constexpr int kWarps = 8;
constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster size
constexpr int kNT = 3;            // n-tiles of y a warp accumulates at a time (no spills)
constexpr int kMaxPairs = 16;     // gate-up group pairs (one x mbarrier each)
constexpr int kWgPitch = 48;      // bytes a staged gate-up row: 16 gate + 16 up, padded
constexpr int kHPitch = 33;       // floats a row of the h tile
constexpr int kActPitch = 24;     // bf16 a row of an act tile (48 bytes: ldmatrix's
                                  // eight rows fall in distinct bank groups)

using oqt::cp_async16;
using oqt::cp_async_commit;
using oqt::cp_async_wait;
using oqt::ldmatrix_x4;
using oqt::mma_bf16;
using oqt::nibble_pairs;

constexpr uint32_t kOnes = oqt::kBf16x2Ones;

// cp.async.wait_group with a run-time count: at most n groups still pending
// (more than 7 waits as for 7, which is stricter and still correct).
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// 8 bytes global -> shared (both 8-byte aligned).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(oqt::smem_u32(dst)), "l"(src));
}

// The x tile arrives by bulk copies (multicast to every block of the
// cluster) that complete the transaction count of an mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(oqt::smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   oqt::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(oqt::smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16) global -> the same offset of the shared memory of
// every block in mask (this block alone when !multicast), counted on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint16_t mask, bool multicast) {
  if (multicast)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(oqt::smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(oqt::smem_u32(bar)), "h"(mask)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(oqt::smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(oqt::smem_u32(bar))
        : "memory");
}

// The cluster barrier in two halves: arrive (release: this block's shared
// memory reads and writes are done) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::);
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::);
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// The dynamic shared memory of the mma route, carved in this order (each
// part a multiple of 16 bytes); ops/kernels/mlp_w4.py::_mma_smem_bytes
// mirrors the sum.
struct MmaSmem {
  int wg, sg, wd, wd_pitch, sd, act, xs, x_pitch, h, gath, part, part_pitch, total;
  __host__ __device__ MmaSmem(int bm, int K_pad, int N, int gs_g, int cs) {
    const int pairs_g = K_pad / (2 * gs_g);
    const int ncols = N / cs;                   // y columns a block
    const int words = ncols / 4;
    wd_pitch = 4 * (words + ((4 - words) % 8 + 8) % 8);  // 4 (mod 8) words: 32 banks
    x_pitch = K_pad + 8;                        // bf16; an odd number of 16-byte groups
    part_pitch = ncols + 4;                     // floats
    const int ksplit = 2;                       // gate-up K halves
    const int kparts = kWarps;                  // warps along the cluster's K
    wg = 0;                                     // (K_pad/2) x 48 bytes
    sg = wg + (K_pad / 2) * kWgPitch;           // [pair][half][scale, zp][32] floats
    wd = sg + pairs_g * 2 * 2 * 32 * 4;         // [cs][16 rows] x wd_pitch bytes
    sd = wd + cs * kSlice * wd_pitch;           // [cs][scale, zp][ncols] floats
    act = sd + cs * 2 * ncols * 4;              // bm x kActPitch bf16, read by the cluster
    xs = act + bm * kActPitch * 2;              // union: x tile + h tile, then the
    h = xs + bm * x_pitch * 2;                  //   cluster's act tiles + the warps'
    gath = xs;                                  //   partials of y
    part = gath + cs * bm * kActPitch * 2;
    const int phase1 = bm * x_pitch * 2 + ksplit * bm * kHPitch * 4;
    const int phase2 = cs * bm * kActPitch * 2 + kparts * bm * part_pitch * 4;
    total = xs + (phase1 > phase2 ? phase1 : phase2);
  }
};

// A block of kWarps warps owns intermediate columns j0 .. j0 + 15 for the
// gate-up product and, in the down product, the cluster's N / cs columns
// n0 .. of y over the cluster's cs x 16 intermediate columns. M is walked in
// passes of BM = 16 * WM rows. At most 128 registers a thread, so that two
// blocks fit an SM and the clusters run in one wave.
template <int WM>
__global__ void __launch_bounds__(32 * kWarps, 2)
mlp_w4_mma_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ wg,
                  const float* __restrict__ sg, const float* __restrict__ zg,
                  const uint8_t* __restrict__ wd, const float* __restrict__ sd,
                  const float* __restrict__ zd, float* __restrict__ ws,
                  unsigned int* __restrict__ counters, float* __restrict__ out, int M, int K_pad,
                  int inter, int N, int gs_g, int gs_d, int signed_g, int signed_d) {
  constexpr int BM = 16 * WM;
  constexpr int kKSplit = 2;              // gate-up warps: 4 n-tiles x 2 K halves
  constexpr int kParts = kWarps;          // down warps: parts of the cluster's K
  constexpr int kSets = WM == 1 ? 2 : 1;  // gate-up accumulator sets (alternate slices)
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned int s_last;
  __shared__ __align__(8) uint64_t xbar[kMaxPairs];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / cs;
  const int cid = blockIdx.x / cs;
  const MmaSmem L(BM, K_pad, N, gs_g, cs);
  uint8_t* wgs = smem + L.wg;
  float* sgs = reinterpret_cast<float*>(smem + L.sg);
  uint8_t* wds = smem + L.wd;
  float* sds = reinterpret_cast<float*>(smem + L.sd);
  uint16_t* acts = reinterpret_cast<uint16_t*>(smem + L.act);
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem + L.xs);
  float* hs = reinterpret_cast<float*>(smem + L.h);
  uint16_t* gath = reinterpret_cast<uint16_t*>(smem + L.gath);
  float* part = reinterpret_cast<float*>(smem + L.part);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kSlice;
  const int n2 = 2 * inter;
  const int half_g = K_pad / 2;
  const int pairs_g = half_g / gs_g;
  const int spp = gs_g / kSlice;  // slices a group pair
  const int ncols = N / cs;       // this block's columns of y: n0 .. n0 + ncols - 1
  const int n0 = rank * ncols;
  const int passes = (M + BM - 1) / BM;
  const int m_pad = passes * BM;
  const uint32_t nib_g = signed_g ? 0x43084308u : 0x43004300u;
  const uint32_t off_g = signed_g ? 0xC308C308u : 0xC300C300u;  // -136 or -128
  const uint32_t nib_d = signed_d ? 0x43084308u : 0x43004300u;
  const uint32_t off_d = signed_d ? 0xC308C308u : 0xC300C300u;

  // Every warp covers all WM m-tiles, so that each B fragment is built once.
  // Gate-up: n-tile nt of the 32 staged columns (gate 0..15, up 16..31; lane
  // g feeds staged column 4g + nt), the slices c with c % 2 == kh of every
  // pair. Down: the cluster's 16-column K steps [k_begin, k_end).
  const int nt = warp & 3;
  const int kh = warp >> 2;
  const uint32_t sel = nt | (nt << 4) | ((nt + 4) << 8) | ((nt + 4) << 12);
  const int k_begin = warp * cs / kParts, k_end = (warp + 1) * cs / kParts;

  // 1. Stage by cp.async what every pass reads, one commit group a group
  // pair, so that the product of pair p starts when its group has landed:
  // the pair's gate-up rows (gate 16 bytes, up 16) and their scales; then a
  // last group with the down rows and scales of this block's columns of y for
  // each of the cluster's K steps (kk: intermediate columns J0 + 16 kk ...,
  // one nibble half of 16 packed rows). x comes by bulk copies, one mbarrier
  // a pair, initialized (and armed for the first pass) before any block of
  // the cluster multicasts into it.
  const bool multicast = cs > 1;
  const uint16_t mask = static_cast<uint16_t>((1u << cs) - 1u);
  if (tid == 0) {
    const int valid = min(BM, M);
    for (int pp = 0; pp < pairs_g; ++pp) {
      mbar_init(&xbar[pp], 1);
      mbar_expect_tx(&xbar[pp], valid * 4 * gs_g);
    }
    mbar_init_fence();
  }
  cluster_arrive();
  for (int pp = 0; pp < pairs_g; ++pp) {
    for (int i = tid; i < gs_g * 2; i += blockDim.x) {
      const int r = pp * gs_g + (i >> 1), u = i & 1;
      cp_async16(wgs + r * kWgPitch + u * 16, wg + static_cast<size_t>(r) * n2 + u * inter + j0,
                 true);
    }
    if (tid < 32) {
      const int q = tid & 3, u = (tid >> 2) & 1, sz = (tid >> 3) & 1, h = tid >> 4;
      const float* src =
          (sz ? zg : sg) + static_cast<size_t>(2 * pp + h) * n2 + u * inter + j0 + 4 * q;
      cp_async16(sgs + ((pp * 2 + h) * 2 + sz) * 32 + u * 16 + 4 * q, src, true);
    }
    cp_async_commit();
  }
  {
    const int row8 = ncols / 8;
    for (int i = tid; i < cs * kSlice * row8; i += blockDim.x) {
      const int kk = i / (kSlice * row8), r = (i / row8) % kSlice, c = (i % row8) * 8;
      const int jb = (cid * cs + kk) * kSlice;  // the K step's first intermediate column
      const int gd = jb / gs_d;
      const size_t row = static_cast<size_t>(gd >> 1) * gs_d + jb % gs_d + r;
      cp_async8(wds + (kk * kSlice + r) * L.wd_pitch + c, wd + row * N + n0 + c);
    }
    const int row4 = ncols / 4;
    for (int i = tid; i < cs * 2 * row4; i += blockDim.x) {
      const int kk = i / (2 * row4), sz = (i / row4) & 1, c = (i % row4) * 4;
      const int gd = (cid * cs + kk) * kSlice / gs_d;
      cp_async16(sds + (kk * 2 + sz) * ncols + c,
                 (sz ? zd : sd) + static_cast<size_t>(gd) * N + n0 + c, true);
    }
    cp_async_commit();
  }
  cluster_wait();  // every block's x mbarriers exist

  for (int pass = 0; pass < passes; ++pass) {
    const int m0 = pass * BM;
    const int valid = min(BM, M - m0);
    if (pass > 0) {
      // Every block of the cluster is done with the previous pass's tiles
      // (x, gathered act, partials: the same shared memory) before x is
      // multicast into it again.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cluster_wait();
      cluster.sync();
      if (tid == 0)
        for (int pp = 0; pp < pairs_g; ++pp) mbar_expect_tx(&xbar[pp], valid * 4 * gs_g);
    }
    // The pass's x rows in their natural layout: this block copies rows
    // rank, rank + cs, ... (each pair's 2 gs columns at once) to every block
    // of the cluster; rows past M are zeros.
    for (int i = tid; i < (BM - valid) * (L.x_pitch / 8); i += blockDim.x)
      reinterpret_cast<uint4*>(xs + valid * L.x_pitch)[i] = make_uint4(0u, 0u, 0u, 0u);
    const int mine = valid > rank ? (valid - rank + cs - 1) / cs : 0;
    for (int i = tid; i < mine * pairs_g; i += blockDim.x) {
      const int m = rank + (i / pairs_g) * cs, pp = i % pairs_g;
      bulk_copy(xs + m * L.x_pitch + 2 * pp * gs_g,
                x + static_cast<size_t>(m0 + m) * K_pad + 2 * pp * gs_g, 4 * gs_g, &xbar[pp],
                mask, multicast);
    }

    // 2. Gate-up product. At WM = 1 two accumulator sets (alternate slices of a
    // pair) halve the mma chains; at WM = 2 the two m-tiles do. A fold adds
    // (d - xsum * zp) * s of both groups of pair p to acc and restarts the
    // partials. C element e: row g + 8 (e >> 1), staged column
    // 4 (2t + (e & 1)) + nt; x's sum of row g is element 0 of the ones-mma, of
    // row g + 8 element 2.
    float acc[WM][4], dlo[kSets][WM][4], dhi[kSets][WM][4], xlo[kSets][WM][4],
        xhi[kSets][WM][4];
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[m][e] = 0.f;
#pragma unroll
        for (int s = 0; s < kSets; ++s) dlo[s][m][e] = dhi[s][m][e] = xlo[s][m][e] = xhi[s][m][e] = 0.f;
      }
    auto fold = [&](int p) {
      const float* s_lo = sgs + (p * 2 + 0) * 2 * 32;
      const float* s_hi = sgs + (p * 2 + 1) * 2 * 32;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (2 * t + (e & 1)) + nt;
        const float sl = s_lo[c], zl = s_lo[32 + c], sh = s_hi[c], zh = s_hi[32 + c];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          float d_l = dlo[0][m][e], d_h = dhi[0][m][e];
          float x_l = xlo[0][m][e & 2], x_h = xhi[0][m][e & 2];
#pragma unroll
          for (int s = 1; s < kSets; ++s) {
            d_l += dlo[s][m][e];
            d_h += dhi[s][m][e];
            x_l += xlo[s][m][e & 2];
            x_h += xhi[s][m][e & 2];
          }
          acc[m][e] += (d_l - x_l * zl) * sl + (d_h - x_h * zh) * sh;
        }
      }
#pragma unroll
      for (int s = 0; s < kSets; ++s)
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) dlo[s][m][e] = dhi[s][m][e] = xlo[s][m][e] = xhi[s][m][e] = 0.f;
    };
    // One slice c (packed rows 16c ..; x columns xc .. of the low nibbles,
    // xc + gs .. of the high) of every m-tile into accumulator set s.
    auto slice = [&](int c, int xc, int s) {
      const uint8_t* wrow = wgs + (c * kSlice + 2 * t) * kWgPitch + 4 * g;
      uint32_t lo0, hi0, lo1, hi1;
      nibble_pairs(*reinterpret_cast<const uint32_t*>(wrow),
                   *reinterpret_cast<const uint32_t*>(wrow + kWgPitch), sel, nib_g, off_g, lo0,
                   hi0);
      nibble_pairs(*reinterpret_cast<const uint32_t*>(wrow + 8 * kWgPitch),
                   *reinterpret_cast<const uint32_t*>(wrow + 9 * kWgPitch), sel, nib_g, off_g,
                   lo1, hi1);
#pragma unroll
      for (int m = 0; m < WM; ++m) {
        uint32_t alo[4], ahi[4];
        const uint16_t* a = xs + (m * 16 + (lane & 15)) * L.x_pitch + xc + (lane >> 4) * 8;
        ldmatrix_x4(alo, a);
        ldmatrix_x4(ahi, a + gs_g);
        mma_bf16(dlo[s][m], alo, lo0, lo1);
        mma_bf16(dhi[s][m], ahi, hi0, hi1);
        mma_bf16(xlo[s][m], alo, kOnes, kOnes);
        mma_bf16(xhi[s][m], ahi, kOnes, kOnes);
      }
    };
    for (int pp = 0; pp < pairs_g; ++pp) {
      // The down group is last; the last pair also waits for it.
      if (pass == 0) cp_async_wait_pending(pp + 1 < pairs_g ? pairs_g - pp : 0);
      mbar_wait(&xbar[pp], pass & 1);
      __syncthreads();  // pair pp has landed for every thread
      const int c_stop = (pp + 1) * spp;
      const int xc = 2 * pp * gs_g - pp * spp * kSlice;  // x column of packed row 16c: xc + 16c
#pragma unroll 2
      for (int c = pp * spp + kh; c < c_stop; c += 2 * kKSplit) {
        slice(c, xc + c * kSlice, 0);
        if (c + kKSplit < c_stop) slice(c + kKSplit, xc + (c + kKSplit) * kSlice, kSets - 1);
      }
      fold(pp);
    }
    float* hp = hs + kh * BM * kHPitch;
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hp[(m * 16 + g + 8 * (e >> 1)) * kHPitch + 4 * (2 * t + (e & 1)) + nt] = acc[m][e];
    __syncthreads();

    // 3. GeGLU on h (the K halves summed in order), rounded to bf16 into the
    // act tile the cluster reads.
    for (int i = tid; i < BM * kSlice; i += blockDim.x) {
      const int m = i / kSlice, c = i % kSlice;
      float hg = 0.f, hu = 0.f;
#pragma unroll
      for (int k = 0; k < kKSplit; ++k) {
        hg += hs[(k * BM + m) * kHPitch + c];
        hu += hs[(k * BM + m) * kHPitch + kSlice + c];
      }
      acts[m * kActPitch + c] = __bfloat16_as_ushort(__float2bfloat16_rn(gelu_tanh(hg) * hu));
    }

    // 4. The act tiles of this warp's K steps (K step kk is rank kk's tile),
    // copied through distributed shared memory into this block (over the spent
    // x tile), four loads in flight.
    cluster.sync();
    const int n_copy = (k_end - k_begin) * BM * 2;
    for (int i0 = 0; i0 < n_copy; i0 += 4 * 32) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * 32 + lane;
        if (i < n_copy)
          v[k] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(
              acts + ((i >> 1) % BM) * kActPitch + (i & 1) * 8, k_begin + i / (BM * 2)));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = i0 + k * 32 + lane;
        if (i < n_copy)
          *reinterpret_cast<float4*>(
              gath + ((k_begin + i / (BM * 2)) * BM + (i >> 1) % BM) * kActPitch + (i & 1) * 8) =
              v[k];
      }
    }
    cluster_arrive();  // this warp is done reading the cluster's act tiles
    __syncwarp();

    // 5. Down product: this warp's K steps of the cluster for every m-tile and
    // the block's ncols / 8 n-tiles (kNT at a time). K step kk: A is rank kk's
    // act (its row sums from a mma against ones), B its 16 packed down rows
    // (lane g: column 8q + g of n-tile q, one byte of a 32-bit word), folded
    // with its group's scale and zero point; the warps' partials then sum in
    // warp order.
    for (int q0 = 0; q0 < ncols / 8; q0 += kNT) {
      float acc2[kNT][WM][4];
#pragma unroll
      for (int q = 0; q < kNT; ++q)
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[q][m][e] = 0.f;
      for (int kk = k_begin; kk < k_end; ++kk) {
        uint32_t a[WM][4];
        float asum[WM][4];
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          ldmatrix_x4(a[m], gath + (kk * BM + m * 16 + (lane & 15)) * kActPitch + (lane >> 4) * 8);
#pragma unroll
          for (int e = 0; e < 4; ++e) asum[m][e] = 0.f;
          mma_bf16(asum[m], a[m], kOnes, kOnes);
        }
        const int dhigh = ((cid * cs + kk) * kSlice / gs_d) & 1;
        const uint8_t* wrow = wds + (kk * kSlice + 2 * t) * L.wd_pitch;
        const float* sk = sds + kk * 2 * ncols;
#pragma unroll
        for (int q = 0; q < kNT; ++q) {
          if (q0 + q >= ncols / 8) break;
          const int col = 8 * (q0 + q) + g;
          const int wo = col & ~3, b = col & 3;
          const uint32_t sb = b | (b << 4) | ((b + 4) << 8) | ((b + 4) << 12);
          uint32_t lo0, hi0, lo1, hi1;
          nibble_pairs(*reinterpret_cast<const uint32_t*>(wrow + wo),
                       *reinterpret_cast<const uint32_t*>(wrow + L.wd_pitch + wo), sb, nib_d,
                       off_d, lo0, hi0);
          nibble_pairs(*reinterpret_cast<const uint32_t*>(wrow + 8 * L.wd_pitch + wo),
                       *reinterpret_cast<const uint32_t*>(wrow + 9 * L.wd_pitch + wo), sb, nib_d,
                       off_d, lo1, hi1);
          const uint32_t b0 = dhigh ? hi0 : lo0, b1 = dhigh ? hi1 : lo1;
          const int c = 8 * (q0 + q) + 2 * t;
          const float s0 = sk[c], s1 = sk[c + 1], z0 = sk[ncols + c], z1 = sk[ncols + c + 1];
#pragma unroll
          for (int m = 0; m < WM; ++m) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(d, a[m], b0, b1);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc2[q][m][e] += (d[e] - asum[m][e & 2] * (e & 1 ? z1 : z0)) * (e & 1 ? s1 : s0);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
        if (q0 + q >= ncols / 8) break;
#pragma unroll
        for (int m = 0; m < WM; ++m)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(part + (warp * BM + m * 16 + g + 8 * r) * L.part_pitch +
                                       8 * (q0 + q) + 2 * t) =
                make_float2(acc2[q][m][2 * r], acc2[q][m][2 * r + 1]);
      }
    }
    __syncthreads();

    // 6. The block's (BM x ncols) piece of the cluster's y: the warps' partials
    // summed in order, written out (one cluster) or to scratch; then the last
    // cluster's block of this rank to arrive sums the pieces in cluster order.
    const int row4 = ncols / 4;
    for (int i = tid; i < BM * row4; i += blockDim.x) {
      const int m = i / row4, c = (i % row4) * 4;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kParts; ++k)
        add4(sum, *reinterpret_cast<const float4*>(part + (k * BM + m) * L.part_pitch + c));
      if (n_clusters == 1) {
        if (m0 + m < M)
          *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + m) * N + n0 + c) = sum;
      } else {
        *reinterpret_cast<float4*>(ws + (static_cast<size_t>(cid) * m_pad + m0 + m) * N + n0 + c) =
            sum;
      }
    }
    if (n_clusters > 1) {
      __threadfence();  // the piece is visible device-wide before the count
      __syncthreads();
      const int counter = pass * cs + rank;
      if (tid == 0)
        s_last = atomicAdd(counters + counter, 1u) == static_cast<unsigned>(n_clusters - 1);
      __syncthreads();
      if (s_last) {
        __threadfence();
        const size_t stride = static_cast<size_t>(m_pad) * N;
        for (int i = tid; i < BM * row4; i += blockDim.x) {
          const int m = i / row4, c = (i % row4) * 4;
          if (m0 + m >= M) continue;
          const float* src = ws + static_cast<size_t>(m0 + m) * N + n0 + c;
          float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int c0 = 0; c0 < n_clusters; c0 += 8) {
            float4 v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if (c0 + k < n_clusters)
                v[k] = __ldcg(reinterpret_cast<const float4*>(src + (c0 + k) * stride));
#pragma unroll
            for (int k = 0; k < 8; ++k)
              if (c0 + k < n_clusters) add4(sum, v[k]);
          }
          *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + m) * N + n0 + c) = sum;
        }
        if (tid == 0) counters[counter] = 0u;  // ready for the next launch (or graph replay)
      }
    }
    __syncthreads();  // the partials (and s_last) are read before the next pass
  }
  cluster_wait();  // no block leaves while another may read its act tile
}

template <int WM>
int launch_mma(const void* x, const void* wg, const void* sg, const void* zg, const void* wd,
               const void* sd, const void* zd, void* ws, void* counters, void* out, int M,
               int K_pad, int inter, int N, int gs_g, int gs_d, int signed_g, int signed_d,
               int cluster, cudaStream_t stream) {
  auto kernel = mlp_w4_mma_kernel<WM>;
  const int smem = MmaSmem(16 * WM, K_pad, N, gs_g, cluster).total;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (cluster > 8) {  // beyond the portable size
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(inter / kSlice);
  config.blockDim = dim3(32 * kWarps);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(wg),
      static_cast<const float*>(sg), static_cast<const float*>(zg),
      static_cast<const uint8_t*>(wd), static_cast<const float*>(sd),
      static_cast<const float*>(zd), static_cast<float*>(ws),
      static_cast<unsigned int*>(counters), static_cast<float*>(out), M, K_pad, inter, N, gs_g,
      gs_d, signed_g, signed_d);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x_bf16: 1 for bfloat16 x, 0 for float32. signed_g / signed_d: int4 (1) or
// uint4 (0) gate-up / down weights. The launch plan
// (ops/kernels/mlp_w4.py::mlp_w4_plan): route 1 is the mma route (bf16 x;
// gs_g, gs_d and inter multiples of 16, N of 8 * cluster; every operand
// 16-byte aligned), bm 16 or 32 rows of M a pass, cluster blocks a thread
// block cluster (at most 16, dividing inter / 16); with more than one
// cluster, ws holds (inter / 16 / cluster) x (M rounded up to bm) x N floats
// and counters one zeroed uint32 for each (pass, rank). Route 0 is the simt
// route (inter and gs_d multiples of 32): ws holds (inter / 32) x M x N
// floats, counters two zeroed uint32. Every counter is back at 0 when the
// launch ends. Returns the launch's error, or cudaGetLastError() after it.
extern "C" int oqt_mlp_w4(const void* x, int x_bf16, const void* wg, const void* sg,
                          const void* zg, const void* wd, const void* sd, const void* zd,
                          void* ws, void* counters, void* out, int M, int K_pad, int inter, int N,
                          int gs_g, int gs_d, int signed_g, int signed_d, int route, int bm,
                          int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    const int blocks = inter / kSlice;
    if (!x_bf16 || gs_g % kSlice || gs_d % kSlice || inter % kSlice || blocks < 1 ||
        cluster < 1 || cluster > kMaxCluster || blocks % cluster || N % (8 * cluster) ||
        K_pad / (2 * gs_g) > kMaxPairs || (bm != 16 && bm != 32))
      return static_cast<int>(cudaErrorInvalidValue);
    for (const void* p : {x, wg, sg, zg, wd, sd, zd})
      if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
    const auto fn = bm == 16 ? &launch_mma<1> : &launch_mma<2>;
    return fn(x, wg, sg, zg, wd, sd, zd, ws, counters, out, M, K_pad, inter, N, gs_g, gs_d,
              signed_g, signed_d, cluster, st);
  }
  if (inter % kTJ || gs_d % kTJ) return static_cast<int>(cudaErrorInvalidValue);
  const int sign_g = signed_g ? 8 : 0, sign_d = signed_d ? 8 : 0;
  if (x_bf16)
    return launch_simt<__nv_bfloat16>(x, wg, sg, zg, wd, sd, zd, ws, counters, out, M, K_pad,
                                      inter, N, gs_g, gs_d, sign_g, sign_d, st);
  return launch_simt<float>(x, wg, sg, zg, wd, sd, zd, ws, counters, out, M, K_pad, inter, N,
                            gs_g, gs_d, sign_g, sign_d, st);
}
