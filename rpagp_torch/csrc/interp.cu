// K2 / K3: SKI cubic-convolution interpolation, both directions.
//
// K2 `interp_transpose`:  U[j] = W_j^T V      tfrac (J, n), V^T (t, n) -> (J, t, m)
// K3 `interp_apply_sum`:  out = sum_j W_j G_j  tfrac (J, n), G (J, t, m) -> (n, t)
//
// Replace rpagp/ops/pallas_interp.py `_transpose_kernel` and
// `_apply_kernel`. W_j has 4 Keys-cubic taps (a = -0.5) per point, at
// cells floor(tfrac) + {-1, 0, 1, 2}, with the Horner tap weights of
// pallas_interp._tap_weights. A tap is kept when its cell lies in [0, m)
// (the XLA dense plan's semantics, ski.py `_cubic_kernel` over all cells);
// the -100 padding convention and any point far off the grid give zero.
// Sums are plain f32 (the TPU kernel used a bf16 hi+lo split).
//
// What bounds them on the H100: both read tfrac (4 J n bytes, J = 20 and
// n = 1.84M at the flagship) once per call plus t n values; the
// arithmetic is tiny. K3 is one thread per point, streaming tfrac with
// coalesced loads and gathering its 4 taps of G through the read-only
// cache. K2 is a scatter: each block takes one (point range, j), stages
// 256 points' base cells and weights in shared memory, and every thread
// owns grid cells, so it accumulates in registers with no atomics; the
// per-block (t, m) partial sums are then added in a fixed order by a
// second kernel, so the result is the same from run to run. The K2 inner
// loop visits every staged point from every cell-owning thread, so its
// cost is ~3 J n m integer ops: it is compute-bound, not memory-bound.

#include <cuda_runtime.h>

namespace {

constexpr int T_MAX = 8;     // columns per launch (the wrapper chunks t)
constexpr int CPT_MAX = 4;   // cells per thread: m <= 4 * 256
constexpr int NT = 256;      // threads per block
constexpr int TILE = 256;    // points staged per pass in K2
constexpr int NO_CELL = -1000000;

__device__ __forceinline__ float inner_w(float s) {
  return ((1.5f * s - 2.5f) * s) * s + 1.0f;
}
__device__ __forceinline__ float outer_w(float s) {
  return ((-0.5f * s + 2.5f) * s - 4.0f) * s + 2.0f;
}

// base cell and the 4 tap weights; NO_CELL for padding / off-grid points
__device__ __forceinline__ int taps(float tf, int m, float w[4]) {
  if (!(tf > -8.0f && tf < (float)(m + 8))) {
    w[0] = w[1] = w[2] = w[3] = 0.0f;
    return NO_CELL;
  }
  float fl = floorf(tf);
  float f = tf - fl, g = 1.0f - f;
  w[0] = outer_w(1.0f + f);
  w[1] = inner_w(f);
  w[2] = inner_w(g);
  w[3] = outer_w(1.0f + g);
  return (int)fl;
}

// grid (nchunk, J): partial[ch, j, k, c] = sum over the chunk's points of
// W_j[i, c] V[i, k]
__global__ void __launch_bounds__(NT)
transpose_partial_kernel(const float* __restrict__ tfrac,
                         const float* __restrict__ VT,
                         float* __restrict__ partial, int J, int n, int t,
                         int m, int chunk) {
  __shared__ int s_i0[TILE];
  __shared__ float s_w[4][TILE];
  __shared__ float s_v[T_MAX][TILE];

  const int j = blockIdx.y, ch = blockIdx.x, tid = threadIdx.x;
  const int start = ch * chunk;
  const int end = min(n, start + chunk);
  float acc[CPT_MAX][T_MAX];
#pragma unroll
  for (int cc = 0; cc < CPT_MAX; ++cc)
#pragma unroll
    for (int k = 0; k < T_MAX; ++k) acc[cc][k] = 0.0f;

  for (int base = start; base < end; base += TILE) {
    const int i = base + tid;
    float w[4];
    int i0 = taps(i < end ? tfrac[(size_t)j * n + i] : -100.0f, m, w);
    s_i0[tid] = i0;
#pragma unroll
    for (int d = 0; d < 4; ++d) s_w[d][tid] = w[d];
#pragma unroll
    for (int k = 0; k < T_MAX; ++k)
      if (k < t) s_v[k][tid] = i < end ? VT[(size_t)k * n + i] : 0.0f;
    __syncthreads();
    const int np = min(TILE, end - base);
    for (int p = 0; p < np; ++p) {
      const int pi0 = s_i0[p];
#pragma unroll
      for (int cc = 0; cc < CPT_MAX; ++cc) {
        const int c = tid + cc * NT;
        const unsigned d = (unsigned)(c - pi0 + 1);
        if (d < 4u && c < m) {
          const float wd = s_w[d][p];
#pragma unroll
          for (int k = 0; k < T_MAX; ++k)
            if (k < t) acc[cc][k] += wd * s_v[k][p];
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int cc = 0; cc < CPT_MAX; ++cc) {
    const int c = tid + cc * NT;
    if (c < m) {
#pragma unroll
      for (int k = 0; k < T_MAX; ++k)
        if (k < t)
          partial[(((size_t)ch * J + j) * t + k) * m + c] = acc[cc][k];
    }
  }
}

// U[e] = sum_ch partial[ch, e], in chunk order
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ U, int nchunk,
                                       int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.0f;
  for (int ch = 0; ch < nchunk; ++ch) s += partial[(size_t)ch * total + e];
  U[e] = s;
}

// out[i, k] (row stride ld) = sum_j sum_taps w G[j, k, cell]
__global__ void __launch_bounds__(NT)
apply_sum_kernel(const float* __restrict__ tfrac, const float* __restrict__ G,
                 float* __restrict__ out, int J, int n, int t, int m,
                 int ld) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc[T_MAX];
#pragma unroll
  for (int k = 0; k < T_MAX; ++k) acc[k] = 0.0f;
  for (int j = 0; j < J; ++j) {
    float w[4];
    const int i0 = taps(tfrac[(size_t)j * n + i], m, w);
    if (i0 == NO_CELL) continue;
    const float* Gj = G + (size_t)j * t * m;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int c = i0 - 1 + d;
      if (c >= 0 && c < m) {
#pragma unroll
        for (int k = 0; k < T_MAX; ++k)
          if (k < t) acc[k] += w[d] * __ldg(Gj + (size_t)k * m + c);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < T_MAX; ++k)
    if (k < t) out[(size_t)i * ld + k] = acc[k];
}

}  // namespace

// tfrac (J, n), VT (t, n), partial (nchunk, J, t, m) scratch, U (J, t, m);
// t <= 8, m <= 1024, nchunk = ceil(n / chunk). Returns cudaGetLastError().
extern "C" int rpagp_interp_transpose(const float* tfrac, const float* VT,
                                      float* partial, float* U, int J, int n,
                                      int t, int m, int chunk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nchunk = (n + chunk - 1) / chunk;
  dim3 grid(nchunk, J);
  transpose_partial_kernel<<<grid, NT, 0, s>>>(tfrac, VT, partial, J, n, t,
                                               m, chunk);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int total = J * t * m;
  reduce_partials_kernel<<<(total + NT - 1) / NT, NT, 0, s>>>(partial, U,
                                                             nchunk, total);
  return (int)cudaGetLastError();
}

// tfrac (J, n), G (J, t, m) contiguous, out rows of stride ld (>= t);
// t <= 8. Returns cudaGetLastError().
extern "C" int rpagp_interp_apply_sum(const float* tfrac, const float* G,
                                      float* out, int J, int n, int t, int m,
                                      int ld, void* stream) {
  apply_sum_kernel<<<(n + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
      tfrac, G, out, J, n, t, m, ld);
  return (int)cudaGetLastError();
}
