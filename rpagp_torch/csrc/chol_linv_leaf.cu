// K1, the leaf: Cholesky factor AND inverse of ONE symmetric (b, b) f32
// matrix, (L, Linv, ok), as one cooperative launch over many SMs.
//
// Replaces rpagp/ops/pallas_chol.py `_panel_kernel` (:190) and
// `_leaf_kernel` (:67), both behind `chol_linv` (pallas_call at :242).
// The main path runs it on the 512x512 diagonal leaves of the p x p
// blocked factor (block_chol._elimination): ten per factor at p = 5120,
// in prepare, every training step and the posterior.
//
// Contract: that of the one-block kernel (chol_linv.cu). b is a multiple
// of 32; only tril(A) is read; L is exactly lower-triangular; a pivot
// d <= 0 (or NaN) takes rsd = 1 and a unit column, every output stays
// finite, ok = 0. Each element goes through the one-block kernel's
// operations in its order (the tile products through the same routines,
// chol_tile.cuh), so on a (1, b, b) input the two agree bit for bit.
//
// What bounds it on the H100: neither FLOPs nor bytes (2 b^3 / 3 flops
// and 3 b^2 floats are ~1 us of the card at b = 512) but a serial chain:
// per 32-wide panel, one row-tile substitution (32 dependent divisions),
// one tile update and the next 32x32 diagonal factor (32 dependent square
// roots and reciprocals), plus two grid barriers. The one-block kernel
// also did every other tile of every panel on the same SM.
//
// Design: G co-resident blocks of 256 threads (the occupancy limit times
// the SM count, capped at 1 + the most tiles a phase deals out) walk the
// one-block kernel's right-looking panel schedule. The working matrices
// are the outputs in global memory (3 MB at b = 512, resident in the
// 50 MB L2, read through L2 only). Block 0 carries the diagonal chain, on
// one warp; blocks 1 .. G-1 share the rest, item w of a phase on block
// 1 + w mod (G-1). Per panel kp (T = b/32 - 1 - kp panels below it), two
// phases, each ended by grid.sync():
//   A. block 0, the look-ahead: the rows of row tile kp+1, L <- W D^{-T};
//      their update of the diagonal tile (kp+1, kp+1); that tile's factor,
//      the next panel's D. The others: the rows of row tiles kp+2 .., and
//      the inverse tiles of row kp, Linv[kp, cj] = -Dinv acc[kp, cj].
//   B. block 0: the next panel's Dinv. The others: the other lower
//      trailing tiles, L[ti, tk] -= L[ti, kp] L[tk, kp]^T, and the inverse
//      accumulations acc[k, cj] += L[k, kp] Linv[kp, cj], k > kp, cj <= kp.
// acc[k, cj] lives in Linv[k, cj] (zero at the start) until phase A of
// panel k finishes it: its terms are added in the one-block kernel's order
// (kk = cj .. k-1), but as soon as they exist, so no phase holds a chain
// longer than one tile product. A cooperative launch the card cannot hold
// at once is refused with its CUDA error; nothing assumes co-residency.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace k1;

__host__ __device__ __forceinline__ int trail_tiles(int T) {
  return T * (T + 1) / 2;
}

// 1 + the most items a phase deals to blocks 1 .. G-1 at size b: more
// blocks would idle
int max_blocks(int b) {
  const int npan = b / NB;
  int most = 0;
  for (int kp = 0; kp < npan; ++kp) {
    const int T = npan - 1 - kp;
    const int na = (T > 0 ? T - 1 : 0) + kp;
    const int nb = T > 0 ? trail_tiles(T) - 1 + T * (kp + 1) : 0;
    most = na > most ? na : most;
    most = nb > most ? nb : most;
  }
  return 1 + most;
}

// D^T, unpadded, so that a row of it (a column of D) is read as float4s.
typedef float TileT[NB][NB];

// Every step below runs chol_linv.cu's operations on each element in the
// same order, so the results agree with it bit for bit; what differs is
// how one warp schedules them.
// - Substitutions are turned around: once an entry is divided out, it is
//   taken off every later entry at once (chol_linv.cu: each entry walks
//   its own chain of dependent FMAs). The dependent chain is one division
//   and one FMA per column; the other FMAs are independent.
// - Each step reads its column of D as one row of D^T, loaded a step ahead,
//   so shared-memory latency stays off that chain.

// the row q of D^T as registers
__device__ __forceinline__ void load_row(float v[NB], const TileT sDT,
                                         int q) {
  const float4* p = reinterpret_cast<const float4*>(sDT[q]);
#pragma unroll
  for (int m = 0; m < NB / 4; ++m) {
    const float4 x = p[m];
    v[4 * m] = x.x, v[4 * m + 1] = x.y, v[4 * m + 2] = x.z,
    v[4 * m + 3] = x.w;
  }
}

// One panel row, in registers: l <- l D^{-T}.
__device__ __forceinline__ void solve_row(float l[NB], const TileT sDT) {
  float cur[NB], nxt[NB];
  load_row(nxt, sDT, 0);
#pragma unroll
  for (int q = 0; q < NB; ++q) {
#pragma unroll
    for (int c = 0; c < NB; ++c) cur[c] = nxt[c];
    if (q + 1 < NB) load_row(nxt, sDT, q + 1);
    l[q] = l[q] / cur[q];
#pragma unroll
    for (int c = q + 1; c < NB; ++c) l[c] -= l[q] * cur[c];
  }
}

// The diagonal tile s (the Schur complement's lower triangle, in shared
// memory) to D = chol(s): D^T in sDT, D in L at (o, o); a failed pivot
// clears *ok. On one warp, lane i keeping row i in registers: a column
// costs a shuffle and two warp barriers (chol_linv.cu: two block
// barriers), the next pivot's update is made first from the lane's own
// value, and lanes outside a column's rows keep their values by a select,
// not a branch. Called by all NT threads of the block; ends with a block
// barrier.
__device__ __forceinline__ void factor_tile(Tile s, TileT sDT, float* sCol,
                                            int* ok, float* L, int b,
                                            int o) {
  const int tid = threadIdx.x;
  if (tid < NB) {
    const int i = tid;
    float a[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) a[k] = s[i][k];
    float next = a[0];  // on lane j: its pivot of column j, updated
    bool all = true;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float d = __shfl_sync(0xffffffffu, next, j);
      const bool okj = d > 0.0f;
      const float rsd = okj ? 1.0f / sqrtf(d) : 1.0f;
      const float vj = okj ? a[j] * rsd : (i == j ? 1.0f : 0.0f);
      const float v = i >= j ? vj : 0.0f;
      all = all && okj;
      // on lane j+1 the same FMA as its a[j+1] below (sCol[j+1] is its v)
      if (j + 1 < NB) next = a[j + 1] - v * v;
      sCol[i] = v;
      __syncwarp();
#pragma unroll
      for (int k = j + 1; k < NB; ++k) {
        const float t = a[k] - v * sCol[k];
        a[k] = k <= i ? t : a[k];
      }
      a[j] = v;  // zero above the diagonal
      __syncwarp();
    }
    if (i == 0 && !all) *ok = 0;
#pragma unroll
    for (int k = 0; k < NB; ++k) sDT[k][i] = a[k];
    float4* row = reinterpret_cast<float4*>(L + (size_t)(o + i) * b + o);
#pragma unroll
    for (int m = 0; m < NB / 4; ++m)
      row[m] = make_float4(a[4 * m], a[4 * m + 1], a[4 * m + 2],
                           a[4 * m + 3]);
  }
  __syncthreads();
}

// Dinv = D^{-1} from sDT, in sDinv and in Linv at (o, o): lane c solves
// column c in registers, the other lanes' steps masked by selects. Called
// by all NT threads of the block; ends with a block barrier.
__device__ __forceinline__ void invert_tile(const TileT sDT, Tile sDinv,
                                            float* Linv, int b, int o) {
  const int tid = threadIdx.x;
  if (tid < NB) {
    const int c = tid;
    float y[NB], cur[NB], nxt[NB];
#pragma unroll
    for (int r = 0; r < NB; ++r) y[r] = r == c ? 1.0f : 0.0f;
    load_row(nxt, sDT, 0);
#pragma unroll
    for (int q = 0; q < NB; ++q) {
#pragma unroll
      for (int r = 0; r < NB; ++r) cur[r] = nxt[r];
      if (q + 1 < NB) load_row(nxt, sDT, q + 1);
      const bool act = q >= c;
      // an idle lane divides 1, not its 0: a zero numerator takes the
      // division's slow path
      const float yq = (act ? y[q] : 1.0f) / cur[q];
      y[q] = act ? yq : y[q];
#pragma unroll
      for (int r = q + 1; r < NB; ++r) {
        const float t = y[r] - cur[r] * yq;
        y[r] = act ? t : y[r];
      }
    }
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      sDinv[r][c] = y[r];
      Linv[(size_t)(o + r) * b + o + c] = y[r];
    }
  }
  __syncthreads();
}

// The rows of row tile ti in panel column o, L <- W D^{-T}, one row per
// thread of the first warp; each row also to out (a tile) if given.
__device__ __forceinline__ void solve_rows(float* L, int b, int ti, int o,
                                           const TileT sDT, Tile out) {
  const int tid = threadIdx.x;
  if (tid < NB) {
    float4* row = reinterpret_cast<float4*>(L + (size_t)(ti * NB + tid) * b
                                            + o);
    float l[NB];
#pragma unroll
    for (int c = 0; c < NB / 4; ++c) {
      const float4 v = __ldcg(row + c);
      l[4 * c] = v.x, l[4 * c + 1] = v.y, l[4 * c + 2] = v.z,
      l[4 * c + 3] = v.w;
    }
    solve_row(l, sDT);
#pragma unroll
    for (int c = 0; c < NB / 4; ++c)
      row[c] = make_float4(l[4 * c], l[4 * c + 1], l[4 * c + 2],
                           l[4 * c + 3]);
    if (out != nullptr) {
#pragma unroll
      for (int c = 0; c < NB; ++c) out[tid][c] = l[c];
    }
  }
}

__global__ void __launch_bounds__(NT)
chol_linv_leaf_kernel(const float* __restrict__ A, float* L, float* Linv,
                      float* ok, int b) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Tile sA, sB, sDinv;
  __shared__ __align__(16) TileT sDT;
  __shared__ __align__(16) float sCol[NB];
  __shared__ int sOk;

  const int tid = threadIdx.x, g = blockIdx.x, G = gridDim.x;
  const int r = tid >> 3, c0 = tid & 7;
  const int npan = b / NB;

  // L = tril(A), Linv = 0 but for the first diagonal tile, which block 0
  // factors and inverts meanwhile
  const size_t bb = (size_t)b * b;
  for (size_t e = (size_t)g * NT + tid; e < bb; e += (size_t)G * NT) {
    const int i = (int)(e / b), k = (int)(e % b);
    if (i < NB && k < NB) continue;
    L[e] = k <= i ? A[e] : 0.0f;
    Linv[e] = 0.0f;
  }
  if (g == 0) {
    if (tid == 0) sOk = 1;
    for (int e = tid; e < NB * NB; e += NT) {
      int i = e >> 5, k = e & 31;
      sB[i][k] = k <= i ? A[(size_t)i * b + k] : 0.0f;
    }
    __syncthreads();
    factor_tile(sB, sDT, sCol, &sOk, L, b, 0);
    invert_tile(sDT, sDinv, Linv, b, 0);
  }
  grid.sync();

  // Block 0 takes the diagonal chain: the look-ahead of each phase A and
  // the inverse of each phase B, and keeps the current panel's D^T and Dinv
  // in sDT and sDinv. The other items of a phase go to blocks 1 .. G-1 in
  // turn (all to block 0 if G = 1, before its own).
  const int first = G > 1 ? 1 : 0, nb = G - first;
  for (int kp = 0; kp < npan; ++kp) {
    const int o = kp * NB, T = npan - 1 - kp;

    // Phase A. items w < T-1: the rows of row tile kp+2+w; items T-1 ..
    // T+kp-2: inverse tile cj = w - (T-1) of row tile kp. Block 0: the
    // look-ahead (T > 0).
    const int na = (T > 0 ? T - 1 : 0) + kp;
    bool have_d = g == 0, have_dinv = g == 0;
    for (int w = g - first; w >= 0 && w < na; w += nb) {
      if (w < T - 1) {
        if (!have_d) {
          for (int e = tid; e < NB * NB; e += NT) {  // D^T from D
            const int i = e & 31, k = e >> 5;
            sDT[k][i] = __ldcg(L + (size_t)(o + i) * b + o + k);
          }
          __syncthreads();
          have_d = true;
        }
        solve_rows(L, b, kp + 2 + w, o, sDT, nullptr);
      } else {
        const int cj = w - (T > 0 ? T - 1 : 0);
        if (!have_dinv) {
          load_tile<true>(sDinv, Linv, b, o, o);
          have_dinv = true;
        }
        load_tile<true>(sB, Linv, b, o, cj * NB);
        __syncthreads();
        float out[4] = {0.f, 0.f, 0.f, 0.f};
        mm_nn(out, sDinv, sB);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          Linv[(size_t)(o + r) * b + cj * NB + c0 + 8 * u] = -out[u];
        __syncthreads();
      }
    }
    if (T == 0) break;
    if (g == 0) {
      // the look-ahead: row tile kp+1, its trailing update of tile
      // (kp+1, kp+1), and that tile's factor, the next panel's D
      const int t1 = (kp + 1) * NB;
      load_tile<true>(sB, L, b, t1, t1);
      solve_rows(L, b, kp + 1, o, sDT, sA);
      __syncthreads();
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mm_nt(acc, sA, sA);
#pragma unroll
      for (int u = 0; u < 4; ++u) sB[r][c0 + 8 * u] -= acc[u];
      __syncthreads();
      factor_tile(sB, sDT, sCol, &sOk, L, b, t1);
    }
    grid.sync();

    // Phase B. items w < T(T+1)/2 - 1: trailing tile w+1 (ti, tk), kp <
    // tk <= ti, row by row, tile 0 (kp+1, kp+1) being the look-ahead's;
    // then the inverse accumulations (k, cj), k > kp, cj <= kp. Block 0:
    // the next panel's Dinv.
    const int nt = trail_tiles(T) - 1;
    for (int w = g - first; w >= 0 && w < nt + T * (kp + 1); w += nb) {
      if (w < nt) {
        const int x = w + 1;
        int i = (int)((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
        while (trail_tiles(i + 1) <= x) ++i;
        while (trail_tiles(i) > x) --i;
        const int ti = (kp + 1 + i) * NB;
        const int tk = (kp + 1 + x - trail_tiles(i)) * NB;
        load_tile<true>(sA, L, b, ti, o);
        load_tile<true>(sB, L, b, tk, o);
        __syncthreads();
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        mm_nt(acc, sA, sB);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* p = L + (size_t)(ti + r) * b + tk + c0 + 8 * u;
          *p = __ldcg(p) - acc[u];
        }
        __syncthreads();
      } else {
        const int v = w - nt;
        const int k = kp + 1 + v / (kp + 1), cj = v % (kp + 1);
        load_tile<true>(sA, L, b, k * NB, o);
        load_tile<true>(sB, Linv, b, o, cj * NB);
        __syncthreads();
        float* dst = Linv + (size_t)(k * NB + r) * b + cj * NB + c0;
        float acc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = __ldcg(dst + 8 * u);
        mm_nn(acc, sA, sB);
#pragma unroll
        for (int u = 0; u < 4; ++u) dst[8 * u] = acc[u];
        __syncthreads();
      }
    }
    if (g == 0) invert_tile(sDT, sDinv, Linv, b, (kp + 1) * NB);
    grid.sync();
  }
  if (g == 0 && tid == 0) ok[0] = sOk ? 1.0f : 0.0f;
}

}  // namespace

// G for size b on the current device, the blocks of the leaf kernel's
// cooperative launch: the occupancy limit times the SM count, capped at
// max_blocks(b). Returns a cudaError_t (cudaErrorNotSupported where the
// device has no cooperative launch).
extern "C" int rpagp_chol_linv_leaf_grid(int b, int* G) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chol_linv_leaf_kernel, NT, 0);
  if (e != cudaSuccess) return (int)e;
  const int most = max_blocks(b);
  *G = per_sm * sms < most ? per_sm * sms : most;
  return *G >= 1 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// A, L, Linv: (b, b) f32 contiguous on the device; ok: (1,) f32. b a
// positive multiple of 32, G from rpagp_chol_linv_leaf_grid. Returns the
// cooperative launch's error (cudaErrorCooperativeLaunchTooLarge if the
// G blocks cannot all be resident), else cudaGetLastError().
extern "C" int rpagp_chol_linv_leaf(const float* A, float* L, float* Linv,
                                    float* ok, int b, int G, void* stream) {
  void* args[] = {(void*)&A, (void*)&L, (void*)&Linv, (void*)&ok, (void*)&b};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)chol_linv_leaf_kernel, dim3(G), dim3(NT), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();  // clear it: the wrapper raises with e
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// The name of a CUDA error code, for the wrappers' exceptions.
extern "C" const char* rpagp_cuda_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
