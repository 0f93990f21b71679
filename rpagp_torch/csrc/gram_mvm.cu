// K4 / K5: the fused projected additive Gram x V product, forward and
// backward, without storing the Gram.
//
// K4 `gram_mvm`:      out = K V,  K[i, l] = sum_j w_j k1d(z1[i, j] - z2[l, j])
//                     z1 (n, J), z2 (m, J), w (J,), V (m, t) -> out (n, t)
// K5 `gram_mvm_bwd`:  Gm = G V^T (n, m) on the fly;
//                     dz[i, j] = w_j sum_l Gm[i, l] k1d'(z1[i, j] - z2[l, j])
//                     dw[j]    = sum_{i, l} Gm[i, l] k1d(z1[i, j] - z2[l, j])
//                     z1, z2, w, V (m, t), G (n, t) -> dz (n, J), dw (J,)
//
// Replace rpagp/ops/pallas_gram.py `_gram_mvm_kernel` (forward) and
// `_gram_mvm_bwd_kernel` (backward). The four stationary 1-D bases
// (rbf, matern12/32/52) are one template parameter. Everything is f32
// with the accurate expf (no fast-math); k1d' is 0 at d = 0 for the
// Matern bases, as jnp.sign(0) = 0 makes it in the TPU kernel.
//
// What bounds them on the H100: n m J exponentials per call (2.2e9 at
// n = m = 14,939, J = 10), on the SFU's 16 per clock per SM, next to
// 2 n m (J + t) f32 operations and a few MB of inputs, so both are
// bound by the exp pipe (and the ~10 f32 instructions around each exp).
// The design: one block owns 64 output rows and walks all of z2 in
// tiles of 64 inside its own loop (the TPU's sequential `l` grid axis).
// Thread (r, part) holds row r against the 16 columns l of its part: it
// builds those 16 Gram values in registers, summed over all J components,
// and contracts them with the V tile itself in f32 FMAs, so the Gram
// never leaves registers. The four parts of a row are added in a fixed
// order at the end and each block writes only its own rows: no atomics,
// and the result is the same bit for bit on every run. K5 holds the
// per-row dz sums the same way; its dw partials are reduced within the
// block in a fixed tree and then across blocks by a second kernel, in
// block order, in f64.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int TI = 64;      // rows per block
constexpr int TL = 64;      // z2 rows per tile
constexpr int NPART = NT / TI;
constexpr int LQ = TL / NPART;  // columns per thread per tile (16)
constexpr int TCH = 32;     // K5: columns of t per staged chunk
constexpr int J_MAX = 64;   // per launch (K5 keeps J sums per thread)

constexpr float SQRT3 = 1.7320508075688772f;
constexpr float SQRT5 = 2.23606797749979f;

enum Base { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

template <int BASE>
__device__ __forceinline__ float k1d(float d) {
  if (BASE == RBF) return expf(-0.5f * d * d);
  const float a = fabsf(d);
  if (BASE == MATERN12) return expf(-a);
  if (BASE == MATERN32) {
    const float s = SQRT3 * a;
    return (1.0f + s) * expf(-s);
  }
  const float s = SQRT5 * a;
  return (1.0f + s + s * s / 3.0f) * expf(-s);
}

// k1d(d) and its derivative d k1d / d d from one exp
template <int BASE>
__device__ __forceinline__ void k1d_and_grad(float d, float& k, float& g) {
  if (BASE == RBF) {
    const float e = expf(-0.5f * d * d);
    k = e;
    g = -d * e;
    return;
  }
  const float a = fabsf(d);
  const float sgn = (float)((d > 0.0f) - (d < 0.0f));
  if (BASE == MATERN12) {
    const float e = expf(-a);
    k = e;
    g = -sgn * e;
  } else if (BASE == MATERN32) {
    const float s = SQRT3 * a;
    const float e = expf(-s);
    k = (1.0f + s) * e;
    g = -sgn * SQRT3 * s * e;
  } else {
    const float s = SQRT5 * a;
    const float e = expf(-s);
    k = (1.0f + s + s * s / 3.0f) * e;
    g = -sgn * SQRT5 * (s + s * s) / 3.0f * e;
  }
}

// s[j * TI + r] = z[(row0 + r) * J + j], zero past the last row
__device__ __forceinline__ void stage_coords(float* s, const float* z,
                                             int row0, int rows, int J) {
  for (int e = threadIdx.x; e < J * TI; e += NT) {
    const int j = e / TI, r = e % TI;
    s[e] = (row0 + r < rows) ? z[(size_t)(row0 + r) * J + j] : 0.0f;
  }
}

// grid (ceil(n / TI), ceil(t / TC)); dynamic shared memory
// (2 J TI + TL TC + TI TC + J) floats
template <int BASE, int TC>
__global__ void __launch_bounds__(NT)
gram_mvm_kernel(const float* __restrict__ z1, const float* __restrict__ z2,
                const float* __restrict__ w, const float* __restrict__ V,
                float* __restrict__ out, int n, int m, int J, int t) {
  extern __shared__ float smem[];
  float* s_z1 = smem;               // (J, TI)
  float* s_z2 = s_z1 + J * TI;      // (J, TL)
  float* s_v = s_z2 + J * TL;       // (TL, TC)
  float* s_red = s_v + TL * TC;     // (TI, TC)
  float* s_w = s_red + TI * TC;     // (J,)

  const int tid = threadIdx.x;
  const int r = tid % TI, part = tid / TI, lq = part * LQ;
  const int row0 = blockIdx.x * TI;
  const int c0 = blockIdx.y * TC;
  const int tc = min(TC, t - c0);

  stage_coords(s_z1, z1, row0, n, J);
  for (int j = tid; j < J; j += NT) s_w[j] = w[j];

  float acc[TC];
#pragma unroll
  for (int c = 0; c < TC; ++c) acc[c] = 0.0f;

  for (int l0 = 0; l0 < m; l0 += TL) {
    __syncthreads();  // the previous tile is consumed
    stage_coords(s_z2, z2, l0, m, J);
    for (int e = tid; e < TL * TC; e += NT) {
      const int ll = e / TC, c = e % TC;
      s_v[e] = (l0 + ll < m && c < tc) ? V[(size_t)(l0 + ll) * t + c0 + c]
                                       : 0.0f;
    }
    __syncthreads();

    // the 16 Gram values of this thread, summed over the J components
    float ks[LQ];
#pragma unroll
    for (int q = 0; q < LQ; ++q) ks[q] = 0.0f;
    for (int j = 0; j < J; ++j) {
      const float zr = s_z1[j * TI + r];
      const float wj = s_w[j];
      const float* zc = s_z2 + j * TL + lq;
#pragma unroll
      for (int q = 0; q < LQ; ++q) ks[q] += wj * k1d<BASE>(zr - zc[q]);
    }
    // contract with the V tile (rows past m are zero in s_v)
#pragma unroll
    for (int q = 0; q < LQ; ++q) {
      const float* vrow = s_v + (lq + q) * TC;
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[c] += ks[q] * vrow[c];
    }
  }

  // add the parts of each row in order 0, 1, 2, 3
  for (int p = 0; p < NPART; ++p) {
    __syncthreads();
    if (part == p) {
#pragma unroll
      for (int c = 0; c < TC; ++c)
        s_red[r * TC + c] = (p == 0) ? acc[c] : s_red[r * TC + c] + acc[c];
    }
  }
  __syncthreads();
  for (int e = tid; e < TI * TC; e += NT) {
    const int rr = e / TC, c = e % TC;
    if (row0 + rr < n && c < tc)
      out[(size_t)(row0 + rr) * t + c0 + c] = s_red[e];
  }
}

// grid ceil(n / TI); dynamic shared memory
// (2 J TI + TL (TCH + 1) + TCH TI + TI J + NT + J) floats
template <int BASE>
__global__ void __launch_bounds__(NT)
gram_mvm_bwd_kernel(const float* __restrict__ z1, const float* __restrict__ z2,
                    const float* __restrict__ w, const float* __restrict__ V,
                    const float* __restrict__ G, float* __restrict__ dz,
                    float* __restrict__ dw_partial, int n, int m, int J,
                    int t) {
  extern __shared__ float smem[];
  float* s_z1 = smem;                    // (J, TI)
  float* s_z2 = s_z1 + J * TI;           // (J, TL)
  float* s_v = s_z2 + J * TL;            // (TL, TCH + 1)
  float* s_g = s_v + TL * (TCH + 1);     // (TCH, TI): G chunk, transposed
  float* s_red = s_g + TCH * TI;         // (TI, J)
  float* s_tree = s_red + TI * J;        // (NT,)
  float* s_w = s_tree + NT;              // (J,)

  const int tid = threadIdx.x;
  const int r = tid % TI, part = tid / TI, lq = part * LQ;
  const int row0 = blockIdx.x * TI;

  stage_coords(s_z1, z1, row0, n, J);
  for (int j = tid; j < J; j += NT) s_w[j] = w[j];

  // per-thread sums over its columns, indexed by component
  float dz_acc[J_MAX], dw_acc[J_MAX];
  for (int j = 0; j < J; ++j) dz_acc[j] = dw_acc[j] = 0.0f;

  for (int l0 = 0; l0 < m; l0 += TL) {
    __syncthreads();
    stage_coords(s_z2, z2, l0, m, J);

    // Gm[r, lq + q] = sum_c G[row0 + r, c] V[l0 + lq + q, c]
    float gm[LQ];
#pragma unroll
    for (int q = 0; q < LQ; ++q) gm[q] = 0.0f;
    for (int cb = 0; cb < t; cb += TCH) {
      const int tc = min(TCH, t - cb);
      __syncthreads();
      for (int e = tid; e < TL * TCH; e += NT) {
        const int ll = e / TCH, c = e % TCH;
        s_v[ll * (TCH + 1) + c] =
            (l0 + ll < m && c < tc) ? V[(size_t)(l0 + ll) * t + cb + c] : 0.0f;
      }
      for (int e = tid; e < TI * TCH; e += NT) {
        const int rr = e / TCH, c = e % TCH;
        s_g[c * TI + rr] =
            (row0 + rr < n && c < tc) ? G[(size_t)(row0 + rr) * t + cb + c]
                                      : 0.0f;
      }
      __syncthreads();
      for (int c = 0; c < tc; ++c) {
        const float gr = s_g[c * TI + r];
#pragma unroll
        for (int q = 0; q < LQ; ++q) gm[q] += gr * s_v[(lq + q) * (TCH + 1) + c];
      }
    }

    for (int j = 0; j < J; ++j) {
      const float zr = s_z1[j * TI + r];
      const float* zc = s_z2 + j * TL + lq;
      float a_dz = 0.0f, a_dw = 0.0f;
#pragma unroll
      for (int q = 0; q < LQ; ++q) {
        float k, g;
        k1d_and_grad<BASE>(zr - zc[q], k, g);
        a_dw += gm[q] * k;
        a_dz += gm[q] * g;
      }
      dz_acc[j] += a_dz;
      dw_acc[j] += a_dw;
    }
  }

  // dz: add the parts of each row in order 0, 1, 2, 3, then scale by w_j
  for (int p = 0; p < NPART; ++p) {
    __syncthreads();
    if (part == p)
      for (int j = 0; j < J; ++j)
        s_red[r * J + j] = (p == 0) ? dz_acc[j] : s_red[r * J + j] + dz_acc[j];
  }
  __syncthreads();
  for (int e = tid; e < TI * J; e += NT) {
    const int rr = e / J, j = e % J;
    if (row0 + rr < n) dz[(size_t)(row0 + rr) * J + j] = s_w[j] * s_red[e];
  }

  // dw: a fixed-shape tree over the block's threads, one component at a time
  for (int j = 0; j < J; ++j) {
    __syncthreads();
    s_tree[tid] = dw_acc[j];
    for (int h = NT / 2; h > 0; h >>= 1) {
      __syncthreads();
      if (tid < h) s_tree[tid] += s_tree[tid + h];
    }
    if (tid == 0) dw_partial[(size_t)blockIdx.x * J + j] = s_tree[0];
  }
}

// dw[j] = sum_b dw_partial[b, j], in block order, in f64
__global__ void dw_reduce_kernel(const float* __restrict__ dw_partial,
                                 float* __restrict__ dw, int nblocks, int J) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= J) return;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b) s += (double)dw_partial[(size_t)b * J + j];
  dw[j] = (float)s;
}

template <int BASE, int TC>
int launch_fwd(const float* z1, const float* z2, const float* w,
               const float* V, float* out, int n, int m, int J, int t,
               cudaStream_t s) {
  dim3 grid((n + TI - 1) / TI, (t + TC - 1) / TC);
  const size_t bytes = sizeof(float) * (2 * J * TI + TL * TC + TI * TC + J);
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(gram_mvm_kernel<BASE, TC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  gram_mvm_kernel<BASE, TC><<<grid, NT, bytes, s>>>(z1, z2, w, V, out, n, m,
                                                    J, t);
  return (int)cudaGetLastError();
}

template <int BASE>
int launch_fwd_tc(int tc_tile, const float* z1, const float* z2,
                  const float* w, const float* V, float* out, int n, int m,
                  int J, int t, cudaStream_t s) {
  switch (tc_tile) {
    case 1: return launch_fwd<BASE, 1>(z1, z2, w, V, out, n, m, J, t, s);
    case 16: return launch_fwd<BASE, 16>(z1, z2, w, V, out, n, m, J, t, s);
    case 32: return launch_fwd<BASE, 32>(z1, z2, w, V, out, n, m, J, t, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int BASE>
int launch_bwd(const float* z1, const float* z2, const float* w,
               const float* V, const float* G, float* dz, float* dw_partial,
               float* dw, int n, int m, int J, int t, cudaStream_t s) {
  const int nblocks = (n + TI - 1) / TI;
  const size_t bytes = sizeof(float) * (2 * J * TI + TL * (TCH + 1) +
                                        TCH * TI + TI * J + NT + J);
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(gram_mvm_bwd_kernel<BASE>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  gram_mvm_bwd_kernel<BASE><<<nblocks, NT, bytes, s>>>(
      z1, z2, w, V, G, dz, dw_partial, n, m, J, t);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dw_reduce_kernel<<<(J + 63) / 64, 64, 0, s>>>(dw_partial, dw, nblocks, J);
  return (int)cudaGetLastError();
}

}  // namespace

// z1 (n, J), z2 (m, J), w (J,), V (m, t), out (n, t), all contiguous f32;
// base 0..3 = rbf, matern12, matern32, matern52; tc_tile in {1, 16, 32}
// is the number of V columns per block (grid.y covers t); 1 <= J <= 64
// (the wrapper sums the launches over groups of 64 components).
// Returns cudaGetLastError().
extern "C" int rpagp_gram_mvm(const float* z1, const float* z2, const float* w,
                              const float* V, float* out, int n, int m, int J,
                              int t, int base, int tc_tile, void* stream) {
  if (J < 1 || J > J_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (base) {
    case RBF: return launch_fwd_tc<RBF>(tc_tile, z1, z2, w, V, out, n, m, J, t, s);
    case MATERN12:
      return launch_fwd_tc<MATERN12>(tc_tile, z1, z2, w, V, out, n, m, J, t, s);
    case MATERN32:
      return launch_fwd_tc<MATERN32>(tc_tile, z1, z2, w, V, out, n, m, J, t, s);
    case MATERN52:
      return launch_fwd_tc<MATERN52>(tc_tile, z1, z2, w, V, out, n, m, J, t, s);
  }
  return (int)cudaErrorInvalidValue;
}

// z1 (n, J), z2 (m, J), w (J,), V (m, t), G (n, t) contiguous f32; dz (n, J),
// dw_partial (ceil(n / 64), J) scratch, dw (J,). 1 <= J <= 64 (the
// wrapper launches once per group of 64 components).
// Returns cudaGetLastError().
extern "C" int rpagp_gram_mvm_bwd(const float* z1, const float* z2,
                                  const float* w, const float* V,
                                  const float* G, float* dz, float* dw_partial,
                                  float* dw, int n, int m, int J, int t,
                                  int base, void* stream) {
  if (J < 1 || J > J_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (base) {
    case RBF:
      return launch_bwd<RBF>(z1, z2, w, V, G, dz, dw_partial, dw, n, m, J, t, s);
    case MATERN12:
      return launch_bwd<MATERN12>(z1, z2, w, V, G, dz, dw_partial, dw, n, m, J,
                                  t, s);
    case MATERN32:
      return launch_bwd<MATERN32>(z1, z2, w, V, G, dz, dw_partial, dw, n, m, J,
                                  t, s);
    case MATERN52:
      return launch_bwd<MATERN52>(z1, z2, w, V, G, dz, dw_partial, dw, n, m, J,
                                  t, s);
  }
  return (int)cudaErrorInvalidValue;
}
