// K1: batched Cholesky factor AND inverse, (B, b, b) -> (L, Linv, ok).
//
// Replaces rpagp/ops/pallas_chol.py `_panel_kernel` / `_leaf_kernel`
// (chol_linv, one block) and `_fused_panel_kernel`
// (chol_linv_batched_fused, J blocks). On the TPU the batched form needed
// its own kernel because Pallas grid programs run one after another on one
// core; here one thread block per matrix serves both entry points.
//
// Algorithm: right-looking blocked elimination in 32-wide panels. The L
// output is the working matrix (the in-place layout of
// `_fused_panel_kernel`): it starts as tril(A) and its trailing region
// holds the current Schur complement until the panels overwrite it. Per
// panel k (rows/cols o .. o+31):
//   1. factor the 32x32 diagonal block in shared memory, column by column;
//   2. invert it in shared memory (forward substitution, one column per
//      thread);
//   3. inverse rows: Linv[o:o+32, :o] = -Dinv (L[o:o+32, :o] Linv[:o, :o]);
//   4. panel: L[o+32:, o:o+32] = W[o+32:, o:o+32] D^{-T} (substitution);
//   5. trailing update of the lower-triangular 32x32 tiles of W[o+32:, o+32:].
// Steps 3 and 5 are 32x32 tile products staged through shared memory.
//
// Failure contract (pallas_chol._rank1_block): a pivot d <= 0 (or NaN)
// takes rsd = 1 and a unit column, every output stays finite, ok = 0.
// L is exactly lower-triangular; only the lower triangle of A is read.
//
// What bounds it on the H100: one SM per matrix. At B = 20 (the jitter
// ladder's 256x256 Toeplitz blocks) 20 of 132 SMs work; at B = 1 (the
// 512x512 diagonal leaf of the p x p blocked factor) one SM does all of
// the ~b^3/3 FMAs through L2-resident global memory, with two block-wide
// barriers per tile. Spreading one matrix over several SMs is the first
// performance item in ROADMAP.md.

#include <cuda_runtime.h>

namespace {

constexpr int NB = 32;   // panel width
constexpr int NT = 256;  // threads per block: 4 outputs of a 32x32 tile each

typedef float Tile[NB][NB + 1];

__device__ __forceinline__ void load_tile(Tile s, const float* src, int ld,
                                          int row0, int col0) {
  for (int e = threadIdx.x; e < NB * NB; e += NT) {
    int r = e >> 5, c = e & 31;
    s[r][c] = src[(size_t)(row0 + r) * ld + col0 + c];
  }
}

// acc[u] (row r = tid/8, col c = tid%8 + 8u) += sum_q a[r][q] * b[c][q]
__device__ __forceinline__ void mm_nt(float acc[4], Tile a,
                                      Tile b) {
  int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    float x = a[r][q];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += x * b[c0 + 8 * u][q];
  }
}

// acc[u] += sum_q a[r][q] * b[q][c]
__device__ __forceinline__ void mm_nn(float acc[4], Tile a,
                                      Tile b) {
  int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    float x = a[r][q];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += x * b[q][c0 + 8 * u];
  }
}

__global__ void __launch_bounds__(NT)
chol_linv_kernel(const float* __restrict__ A_all, float* L_all,
                 float* Linv_all, float* __restrict__ ok_all, int b) {
  __shared__ Tile sA, sB, sD, sDinv;
  __shared__ float sCol[NB];
  __shared__ int sOk;

  const int tid = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * b * b;
  const float* A = A_all + off;
  float* L = L_all + off;
  float* Linv = Linv_all + off;
  const int r = tid >> 3, c0 = tid & 7;

  for (int i = 0; i < b; ++i) {
    for (int k = tid; k < b; k += NT) {
      const size_t e = (size_t)i * b + k;
      L[e] = k <= i ? A[e] : 0.0f;
      Linv[e] = 0.0f;
    }
  }
  if (tid == 0) sOk = 1;
  __syncthreads();

  const int npan = b / NB;
  for (int kp = 0; kp < npan; ++kp) {
    const int o = kp * NB;

    // 1. diagonal block, unblocked, in shared memory
    load_tile(sD, L, b, o, o);
    __syncthreads();
    for (int j = 0; j < NB; ++j) {
      float d = sD[j][j];
      bool okj = d > 0.0f;
      float rsd = okj ? 1.0f / sqrtf(d) : 1.0f;
      if (tid < NB) {
        float v = 0.0f;
        if (tid >= j) v = okj ? sD[tid][j] * rsd : (tid == j ? 1.0f : 0.0f);
        sCol[tid] = v;
      }
      if (tid == 0 && !okj) sOk = 0;
      __syncthreads();
      for (int e = tid; e < NB * NB; e += NT) {
        int i = e >> 5, k = e & 31;
        if (k > j && k <= i) sD[i][k] -= sCol[i] * sCol[k];
      }
      if (tid < NB) sD[tid][j] = sCol[tid];  // zero above the diagonal
      __syncthreads();
    }

    // 2. Dinv = D^{-1}, one column per thread
    if (tid < NB) {
      const int c = tid;
      for (int i = 0; i < NB; ++i) {
        float x = 0.0f;
        if (i >= c) {
          x = (i == c) ? 1.0f : 0.0f;
          for (int q = c; q < i; ++q) x -= sD[i][q] * sDinv[q][c];
          x /= sD[i][i];
        }
        sDinv[i][c] = x;
      }
    }
    __syncthreads();
    for (int e = tid; e < NB * NB; e += NT) {
      int i = e >> 5, k = e & 31;
      L[(size_t)(o + i) * b + o + k] = sD[i][k];
      Linv[(size_t)(o + i) * b + o + k] = sDinv[i][k];
    }

    // 3. inverse rows left of the diagonal block, one 32-column tile at a
    //    time: Linv[o.., 32cj..] = -Dinv sum_{kk=cj}^{kp-1} L[o.., kk] Linv[kk, cj]
    for (int cj = 0; cj < kp; ++cj) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = cj; kk < kp; ++kk) {
        __syncthreads();
        load_tile(sA, L, b, o, kk * NB);
        load_tile(sB, Linv, b, kk * NB, cj * NB);
        __syncthreads();
        mm_nn(acc, sA, sB);
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 4; ++u) sB[r][c0 + 8 * u] = acc[u];
      __syncthreads();
      float out[4] = {0.f, 0.f, 0.f, 0.f};
      mm_nn(out, sDinv, sB);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        Linv[(size_t)(o + r) * b + cj * NB + c0 + 8 * u] = -out[u];
    }
    if (kp == npan - 1) break;

    // 4. panel below the diagonal block, L[i, o..] = W[i, o..] D^{-T}, by
    //    forward substitution, one row per thread. (A product with the
    //    explicit Dinv, as the TPU kernel does, loses the last pivots of
    //    the ill-conditioned ladder blocks to rounding.)
    const int s0 = o + NB;
    __syncthreads();
    for (int i = s0 + tid; i < b; i += NT) {
      float* row = L + (size_t)i * b + o;
      float l[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) l[c] = row[c];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        float x = l[c];
#pragma unroll
        for (int q = 0; q < c; ++q) x -= l[q] * sD[c][q];
        l[c] = x / sD[c][c];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) row[c] = l[c];
    }
    __syncthreads();

    // 5. trailing update, lower-triangular tiles only (diagonal tiles in
    //    full: their upper halves are rewritten by step 1 later)
    for (int ti = s0; ti < b; ti += NB) {
      for (int tk = s0; tk <= ti; tk += NB) {
        load_tile(sA, L, b, ti, o);
        load_tile(sB, L, b, tk, o);
        __syncthreads();
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        mm_nt(acc, sA, sB);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          L[(size_t)(ti + r) * b + tk + c0 + 8 * u] -= acc[u];
        __syncthreads();
      }
    }
    __syncthreads();
  }
  __syncthreads();
  if (tid == 0) ok_all[blockIdx.x] = sOk ? 1.0f : 0.0f;
}

}  // namespace

// A, L, Linv: (B, b, b) f32 contiguous on the device; ok: (B,) f32.
// b must be a positive multiple of 32. Returns cudaGetLastError().
extern "C" int rpagp_chol_linv(const float* A, float* L, float* Linv,
                               float* ok, int B, int b, void* stream) {
  chol_linv_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(A, L, Linv, ok, b);
  return (int)cudaGetLastError();
}
