// Fused W4 GeGLU MLP for Hopper (sm_90a): one launch per layer.
//
// Replaces the Pallas kernel onnx_quantize_tpu/ops/kernels/mlp_w4.py
// (_mlp_call -> _mlp_kernel):
//     h   = x @ dequant(W_gate_up)              (M, 2I), float32
//     act = gelu_tanh(h[:, :I]) * h[:, I:]      float32, rounded to x's type
//     y   = act @ dequant(W_down)               (M, N), float32
// with both weights packed W4 in the group-pair layout (matmul_w4.cu) and
// the dequant affine applied to each group's partial dot.
//
// The TPU kernel runs as one grid instance; here the intermediate dimension
// is split across blocks instead. Block b owns the TJ = 32 intermediate
// columns j0 = b*TJ .. j0+TJ-1 (a slice never crosses a down scale group,
// since the group size is a multiple of 64):
//   1. it computes its gate columns j and up columns I + j over all of K,
//      32 rows of M at a time (thread tx owns column j0 + tx, ty four rows),
//      applies GeGLU in float32 and rounds act to x's type in shared memory;
//   2. it multiplies its act slice by its TJ rows of dequant(W_down) (one
//      nibble of each packed row: the slice's group picks low or high) into
//      a partial (M, N) tile in a workspace;
//   3. after a grid-wide barrier (a counter and __threadfence; the launch
//      is cooperative, so every block is resident), every block sums its
//      share of the (M, N) outputs over all partials, in block order.
// The reduction is deterministic and spread over all blocks: float atomics
// would change the sum's order from run to run, and a last-block reduction
// would read every partial (5 MB at M = 32 for Gemma-3-270M) on one SM.
//
// Shapes: x (M, K_pad) float32/bfloat16, K_pad = 2 * gate-up packed rows;
// wg (K_pad/2, 2I) uint8, sg/zg (pairs_g, 2, 2I) float32; wd (I_pad/2, N)
// uint8, sd/zd (pairs_d, 2, N) float32; ws (I/TJ, M, N) float32 scratch;
// counter one uint32 (zeroed before each launch); out (M, N) float32.
// Pad groups carry scale 1 and zero point 0; zero x columns null the gate-up
// pad rows, and the down pad rows (j >= I) belong to no block.
// What bounds it on the card: Gemma-3-270M's two packed weights and scales
// are ~2.5 MB a layer, ~0.75 us at 3.35 TB/s; the FMAs run on the CUDA
// cores and the partials' round trip through L2 cost more in this first
// version.

#include "common.cuh"

namespace {

constexpr int kTJ = 32;  // intermediate columns per block (one per lane)
constexpr int kBM = 32;  // rows of M per pass (4 per thread row)
constexpr int kRPT = kBM / oqt::kThreadsM;
using oqt::kRowChunk;
using oqt::kThreadsM;
using oqt::kThreadsN;

__device__ __forceinline__ float gelu_tanh(float v) {
  // Gemma's approximate gelu: 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3))).
  const float c = 0.7978845608028654f;
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float nibble(int b, int high, int sign_off) {
  const int v = high ? (b >> 4) : (b & 0x0F);
  return static_cast<float>((v ^ sign_off) - sign_off);
}

// Every block arrives, then waits until all have: the launch is cooperative
// (all blocks resident), and a stuck wait traps instead of hanging the card.
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
}

template <typename T>
int launch(const void* x, const void* wg, const void* sg, const void* zg, const void* wd,
           const void* sd, const void* zd, void* ws, void* counter, void* out, int M, int K_pad,
           int inter, int N, int gs_g, int gs_d, int sign_g, int sign_d, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  err = cudaLaunchCooperativeKernel((const void*)mlp_w4_kernel<T>, grid, block, args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_bf16: 1 for bfloat16 x, 0 for float32. signed_g / signed_d: int4 (1) or
// uint4 (0) gate-up / down weights. inter must be a multiple of 32 and
// gs_d of 32. Returns the first CUDA error of the memset and the launch.
extern "C" int oqt_mlp_w4(const void* x, int x_bf16, const void* wg, const void* sg,
                          const void* zg, const void* wd, const void* sd, const void* zd,
                          void* ws, void* counter, void* out, int M, int K_pad, int inter, int N,
                          int gs_g, int gs_d, int signed_g, int signed_d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sign_g = signed_g ? 8 : 0, sign_d = signed_d ? 8 : 0;
  if (x_bf16)
    return launch<__nv_bfloat16>(x, wg, sg, zg, wd, sd, zd, ws, counter, out, M, K_pad, inter, N,
                                 gs_g, gs_d, sign_g, sign_d, st);
  return launch<float>(x, wg, sg, zg, wd, sd, zd, ws, counter, out, M, K_pad, inter, N, gs_g,
                       gs_d, sign_g, sign_d, st);
}
