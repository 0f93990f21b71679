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
// cache. K2 is a scatter whose work follows the taps: one warp takes a
// chunk of points of one component, lane l its points l, l + 32, .., and
// every lane adds its points' taps into its own copy of the (t, m)
// accumulator in shared memory, so no two lanes ever add to one word and
// crowded points cost no more than spread ones. The copies are
// interleaved, word (k m + c) 32 + lane, so the 32 lanes of any access
// sit on 32 different banks. At the end lane l adds the 32 copies of
// cells l, l + 32, .. (starting at copy l, again one bank a lane) into
// the chunk's partial (t, m), and a second kernel adds the chunks'
// partials in chunk order: no atomics, the same bits on every run, each
// sum in an order fixed by the point index. The copies' shared memory
// sets how many warps an SM holds (six or seven at m = 256, one column),
// and the scatter is bound by their latency, not by HBM: so a warp holds
// at most 256 accumulator floats a lane (m of them a column), and wider t
// runs in passes over the columns, each reading tfrac again (at m = 256
// one pass a column: two columns in one pass halve the warps an SM holds
// and were slower on the H100 than two passes).

#include <cuda_runtime.h>

namespace {

constexpr int T_MAX = 8;     // columns per launch (the wrapper chunks t)
constexpr int M_MAX = 1024;  // grid cells
constexpr int NT = 256;      // threads per block of K3 and the reduction
constexpr int LANE_FLOATS = 256;  // K2: a lane's accumulator floats a pass
// K2: points a lane loads a batch, the next batch's loads in flight
// while this one's taps are added: 16 at one column, fewer at more
__host__ __device__ constexpr int batch_points(int tc) {
  return tc == 1 ? 16 : (16 / tc > 2 ? 16 / tc : 2);
}
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

// tfrac and V^T of points base + 32 p + lane, p < PF (padding past end)
template <int TC, int PF>
__device__ __forceinline__ void load_points(float tv[PF], float vv[PF][TC],
                                            const float* tf, const float* VT,
                                            int base, int end, int n,
                                            int k0) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int p = 0; p < PF; ++p) {
    const int i = base + 32 * p + lane;
    const bool in = i < end;
    tv[p] = in ? __ldg(tf + i) : -100.0f;
#pragma unroll
    for (int k = 0; k < TC; ++k)
      vv[p][k] = in ? __ldg(VT + (size_t)(k0 + k) * n + i) : 0.0f;
  }
}

// grid (nchunk, J), one warp a block: partial[ch, j, k0 + k, c] = sum over
// the chunk's points of W_j[i, c] V[i, k0 + k], k < TC. Dynamic shared
// memory: TC m 32 floats, the 32 lanes' copies of the accumulator. A
// point whose four cells all lie on the grid (every point of data the
// grid covers) takes a path with no bounds test, its four
// read-modify-writes at fixed offsets from one address, so all four can
// be in flight at once; points at the edges take a path that tests each
// tap; padding and points off the grid add nothing.
template <int TC>
__global__ void __launch_bounds__(32)
transpose_partial_kernel(const float* __restrict__ tfrac,
                         const float* __restrict__ VT,
                         float* __restrict__ partial, int J, int n, int t,
                         int m, int chunk, int k0) {
  constexpr int PF = batch_points(TC);
  extern __shared__ float acc[];  // acc[(k m + c) 32 + lane]
  const int lane = threadIdx.x, j = blockIdx.y, ch = blockIdx.x;
  const int start = ch * chunk;
  const int end = min(n, start + chunk);
  for (int e = lane; e < TC * m * 32; e += 32) acc[e] = 0.0f;
  __syncwarp();
  const float* tf = tfrac + (size_t)j * n;
  float tv[PF], vv[PF][TC], tn[PF], vn[PF][TC];
  load_points<TC, PF>(tv, vv, tf, VT, start, end, n, k0);
  for (int base = start; base < end; base += 32 * PF) {
    load_points<TC, PF>(tn, vn, tf, VT, base + 32 * PF, end, n, k0);
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      float w[4];
      const int i0 = taps(tv[p], m, w);
      if (i0 >= 1 && i0 <= m - 3) {  // cells i0 - 1 .. i0 + 2 on the grid
        float* a = acc + (size_t)(i0 - 1) * 32 + lane;
#pragma unroll
        for (int k = 0; k < TC; ++k) {
          float* ak = a + (size_t)k * m * 32;
          const float a0 = ak[0], a1 = ak[32], a2 = ak[64], a3 = ak[96];
          ak[0] = a0 + w[0] * vv[p][k];
          ak[32] = a1 + w[1] * vv[p][k];
          ak[64] = a2 + w[2] * vv[p][k];
          ak[96] = a3 + w[3] * vv[p][k];
        }
      } else if (i0 != NO_CELL) {
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const int c = i0 - 1 + d;
          if ((unsigned)c < (unsigned)m) {
#pragma unroll
            for (int k = 0; k < TC; ++k) {
              float* ak = acc + (size_t)(k * m + c) * 32 + lane;
              *ak = *ak + w[d] * vv[p][k];
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      tv[p] = tn[p];
#pragma unroll
      for (int k = 0; k < TC; ++k) vv[p][k] = vn[p][k];
    }
  }
  __syncwarp();
  float* out = partial + (((size_t)ch * J + j) * t + k0) * m;
  for (int r = lane; r < TC * m; r += 32) {
    const float* row = acc + (size_t)r * 32;
    float v = 0.0f;
    for (int q = 0; q < 32; ++q) v += row[(lane + q) & 31];
    out[r] = v;
  }
}

template <int TC>
int launch_transpose(const float* tfrac, const float* VT, float* partial,
                     int J, int n, int t, int m, int chunk, int k0,
                     cudaStream_t s) {
  const size_t bytes = sizeof(float) * TC * m * 32;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        transpose_partial_kernel<TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((n + chunk - 1) / chunk, J);
  transpose_partial_kernel<TC><<<grid, 32, bytes, s>>>(tfrac, VT, partial, J,
                                                       n, t, m, chunk, k0);
  return (int)cudaGetLastError();
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
// t <= 8, m <= 1024, nchunk = ceil(n / chunk). Passes over the columns of
// 8, 4, 2 or 1, the widest whose accumulator fits LANE_FLOATS (one column
// where m alone is more). Returns cudaGetLastError().
extern "C" int rpagp_interp_transpose(const float* tfrac, const float* VT,
                                      float* partial, float* U, int J, int n,
                                      int t, int m, int chunk, void* stream) {
  if (J < 1 || n < 1 || t < 1 || t > T_MAX || m < 1 || m > M_MAX ||
      chunk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int cap = LANE_FLOATS / m > 1 ? LANE_FLOATS / m : 1;
  for (int k0 = 0; k0 < t; ) {
    const int left = t - k0 < cap ? t - k0 : cap;
    const int tc = left >= 8 ? 8 : left >= 4 ? 4 : left >= 2 ? 2 : 1;
    const int err =
        tc == 8   ? launch_transpose<8>(tfrac, VT, partial, J, n, t, m, chunk,
                                        k0, s)
        : tc == 4 ? launch_transpose<4>(tfrac, VT, partial, J, n, t, m, chunk,
                                        k0, s)
        : tc == 2 ? launch_transpose<2>(tfrac, VT, partial, J, n, t, m, chunk,
                                        k0, s)
                  : launch_transpose<1>(tfrac, VT, partial, J, n, t, m, chunk,
                                        k0, s);
    if (err) return err;
    k0 += tc;
  }
  const int nchunk = (n + chunk - 1) / chunk;
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
