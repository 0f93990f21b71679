// K1's one-block kernel: Cholesky factor AND inverse, (B, b, b) ->
// (L, Linv, ok), one thread block per matrix.
//
// The first port of rpagp/ops/pallas_chol.py's kernels (`_panel_kernel`,
// `_leaf_kernel`, `_fused_panel_kernel`). The path no longer launches it:
// both entry points run chol_linv_coop.cu, which spreads this kernel's
// panel schedule over the card's SMs and gives every element the same
// operations in the same order. This kernel stays as that one's oracle:
// the card tests and chip_smoke.py hold the two bit for bit against each
// other (cuda_chol.chol_linv_cuda(A, "chol_linv_oneblock")).
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
//   4. panel: L[o+32:, o:o+32] = W[o+32:, o:o+32] D^{-T} (substitution),
//      0 in a failed pivot's column;
//   5. trailing update of the lower-triangular 32x32 tiles of W[o+32:, o+32:].
// Steps 3 and 5 are 32x32 tile products staged through shared memory.
//
// Failure contract (pallas_chol._rank1_block): a pivot d <= 0 (or NaN)
// takes rsd = 1 and a unit column, ok = 0, and the failed column is
// decoupled from the rest of the matrix: the diagonal tile's rows below
// it get a 0 there (the unit column), and so do the panel rows below the
// tile (step 4 overwrites their entry, W's residual over the unit pivot,
// with 0). The trailing update is then the Schur complement of the matrix
// with that row and column taken out, so a failed matrix's outputs stay
// finite garbage: L is the factor of the decoupled matrix, Linv its
// inverse. Only that branch differs from the plain elimination, so a
// matrix with ok = 1 never takes it, and the first failing pivot, hence
// ok, is what it would be without it. (Leaving W's residual in the panel
// rows instead, against a column the diagonal tile never eliminated,
// grew panel by panel and overflowed at b = 512.)
// L is exactly lower-triangular; only the lower triangle of A is read.
//
// What bounds it on the H100: one SM per matrix, with the ~b^3/3 FMAs
// read and written through L2-resident global memory and two block-wide
// barriers per tile. At B = 20 (the jitter ladder's 256x256 Toeplitz
// blocks) 20 of 132 SMs work.

#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace {

using namespace k1;

__global__ void __launch_bounds__(NT)
chol_linv_kernel(const float* __restrict__ A_all, float* L_all,
                 float* Linv_all, float* __restrict__ ok_all, int b) {
  __shared__ Tile sA, sB, sD, sDinv;
  __shared__ float sCol[NB];
  __shared__ int sOk;
  __shared__ unsigned sFail;  // the panel's failed pivots, bit j = column j

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
    if (tid == 0) sFail = 0u;
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
      if (tid == 0 && !okj) {
        sOk = 0;
        sFail |= 1u << j;
      }
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
    //    A failed pivot's column gets 0 after the substitution, as the
    //    diagonal tile's rows below it do (its column of D is the unit
    //    column, so its entry enters no other column's substitution).
    const int s0 = o + NB;
    __syncthreads();
    const unsigned fail = sFail;
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
      if (fail) {
#pragma unroll
        for (int c = 0; c < NB; ++c) l[c] = (fail >> c) & 1u ? 0.0f : l[c];
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
