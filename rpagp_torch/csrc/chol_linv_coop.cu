// K1: Cholesky factor AND inverse of B symmetric (b, b) f32 matrices,
// (L, Linv, ok), as one cooperative launch over many SMs.
//
// Replaces rpagp/ops/pallas_chol.py `_panel_kernel` (:190) and
// `_leaf_kernel` (:67), behind `chol_linv` (pallas_call at :242), and
// `_fused_panel_kernel` (:381), behind `chol_linv_batched_fused`
// (pallas_call at :471). Both entry points of the port launch it: the
// 512x512 diagonal leaves of the p x p blocked factor
// (block_chol._elimination, B = 1: ten per factor at p = 5120, in
// prepare, every training step and the posterior) and the jitter ladder's
// Toeplitz blocks (grid_solve._chol_ladder, B = J = 20, b = 256: once a
// step and in the posterior).
//
// Contract: that of the one-block kernel (chol_linv.cu), per matrix. b is
// a multiple of 32; only tril(A) is read; L is exactly lower-triangular; a
// pivot d <= 0 (or NaN) takes rsd = 1 and a unit column, that matrix alone
// gets ok = 0, and the failed column is decoupled: the panel rows below
// the diagonal tile get a 0 in it, as the tile's own rows do, so a failed
// matrix's outputs stay finite (the factor and inverse of the matrix with
// that row and column taken out). The diagonal chain records each panel's
// failed pivots as a bit mask in `fail` (B x b/32 words) for the blocks
// that substitute the panel's rows. Each element goes
// through the one-block kernel's operations in its order (the tile
// products through the same routines, chol_tile.cuh), so the two agree
// bit for bit on every matrix.
//
// What bounds it on the H100: neither FLOPs nor bytes (2 B b^3 / 3 flops
// and 3 B b^2 floats are a few us of the card) but a serial chain per
// matrix: per 32-wide panel, one row-tile substitution (32 dependent
// divisions), one tile update and the next 32x32 diagonal factor (32
// dependent square roots and reciprocals), plus two grid barriers. The
// one-block kernel ran each matrix's chain AND every other tile of that
// matrix on one SM, so at B = 20 it used 20 of the 132 SMs.
//
// Design: G co-resident blocks of 256 threads (the occupancy limit times
// the SM count, capped at C + the most items a phase deals out) walk the
// one-block kernel's right-looking panel schedule for all B matrices at
// once. The working matrices are the outputs in global memory (read
// through L2 only). Blocks 0 .. C-1 carry the diagonal chains, on one warp
// each: block c those of matrices c, c + C, ... in turn (C = B unless the
// card holds fewer than 2 B blocks). Blocks C .. G-1 share the rest of
// each phase: its items over all matrices, (matrix, item) pair W = B w +
// matrix on block C + W mod (G-C), so the matrices are interleaved and a
// block takes items of several. Per panel kp (T = b/32 - 1 - kp panels
// below it), two phases, each ended by grid.sync():
//   A. chain blocks, the look-ahead: the rows of row tile kp+1,
//      L <- W D^{-T} (0 in a failed pivot's column); their update of the
//      diagonal tile (kp+1, kp+1); that tile's factor, the next panel's D. The others: the rows of row
//      tiles kp+2 .., and the inverse tiles of row kp,
//      Linv[kp, cj] = -Dinv acc[kp, cj].
//   B. chain blocks: the next panel's Dinv. The others: the other lower
//      trailing tiles, L[ti, tk] -= L[ti, kp] L[tk, kp]^T, and the inverse
//      accumulations acc[k, cj] += L[k, kp] Linv[kp, cj], k > kp, cj <= kp.
// acc[k, cj] lives in Linv[k, cj] (zero at the start) until phase A of
// panel k finishes it: its terms are added in the one-block kernel's order
// (kk = cj .. k-1), but as soon as they exist, so no phase holds a chain
// longer than one tile product. A block keeps the D^T and Dinv it last
// used in shared memory, tagged with their (matrix, panel), and reloads
// them from L and Linv when an item needs another. A worker runs its
// phase-B tile products one behind their loads (the next item's tiles come
// into registers while this one multiplies), and the workers alone copy
// tril(A) into L at the start, while the chain blocks factor the first
// diagonal tiles. A cooperative launch the card cannot hold at once is
// refused with its CUDA error; nothing assumes co-residency.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "chol_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace k1;

__host__ __device__ __forceinline__ int trail_tiles(int T) {
  return T * (T + 1) / 2;
}

// items of phases A and B of panel kp, per matrix
__host__ __device__ __forceinline__ int items_a(int npan, int kp) {
  const int T = npan - 1 - kp;
  return (T > 0 ? T - 1 : 0) + kp;
}
__host__ __device__ __forceinline__ int items_b(int npan, int kp) {
  const int T = npan - 1 - kp;
  return T > 0 ? trail_tiles(T) - 1 + T * (kp + 1) : 0;
}

// the most items a phase deals out over B matrices of size b: more worker
// blocks would idle
long most_items(int B, int b) {
  const int npan = b / NB;
  int most = 0;
  for (int kp = 0; kp < npan; ++kp) {
    most = items_a(npan, kp) > most ? items_a(npan, kp) : most;
    most = items_b(npan, kp) > most ? items_b(npan, kp) : most;
  }
  return (long)B * most;
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
// memory) to D = chol(s): D^T in sDT, D in L at (o, o), the failed pivots'
// mask in *sFail and *failp. Returns false on thread 0 if a pivot failed.
// On one warp, lane i keeping row i in registers: a column costs a shuffle
// and two warp barriers (chol_linv.cu: two block barriers), the next
// pivot's update is made first from the lane's own value, and lanes
// outside a column's rows keep their values by a select, not a branch.
// Called by all NT threads of the block; ends with a block barrier.
__device__ __forceinline__ bool factor_tile(Tile s, TileT sDT, float* sCol,
                                            unsigned* sFail, unsigned* failp,
                                            float* L, int b, int o) {
  const int tid = threadIdx.x;
  unsigned fail = 0u;
  if (tid < NB) {
    const int i = tid;
    float a[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) a[k] = s[i][k];
    float next = a[0];  // on lane j: its pivot of column j, updated
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float d = __shfl_sync(0xffffffffu, next, j);
      const bool okj = d > 0.0f;
      const float rsd = okj ? 1.0f / sqrtf(d) : 1.0f;
      const float vj = okj ? a[j] * rsd : (i == j ? 1.0f : 0.0f);
      const float v = i >= j ? vj : 0.0f;
      fail |= okj ? 0u : 1u << j;
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
#pragma unroll
    for (int k = 0; k < NB; ++k) sDT[k][i] = a[k];
    float4* row = reinterpret_cast<float4*>(L + (size_t)(o + i) * b + o);
#pragma unroll
    for (int m = 0; m < NB / 4; ++m)
      row[m] = make_float4(a[4 * m], a[4 * m + 1], a[4 * m + 2],
                           a[4 * m + 3]);
    if (i == 0) {
      *sFail = fail;
      *failp = fail;
    }
  }
  __syncthreads();
  return fail == 0u;
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
// thread of the first warp; each row also to out (a tile) if given. Then
// the columns of the panel's failed pivots (*sFail) get 0: a failed
// pivot's column of D is the unit column, so its entry (W's residual over
// a unit pivot) entered no other column's substitution, and a matrix with
// ok = 1 runs the substitution and nothing else.
__device__ __forceinline__ void solve_rows(float* L, int b, int ti, int o,
                                           const TileT sDT,
                                           const unsigned* sFail, Tile out) {
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
    for (unsigned f = *sFail; f != 0u; f &= f - 1u) {
      const int c = __ffs(f) - 1;
      reinterpret_cast<float*>(row)[c] = 0.0f;
      if (out != nullptr) out[tid][c] = 0.0f;
    }
  }
}

// An item of phase B of panel kp: a lower trailing tile,
// L[ti, tk] -= L[ti, kp] L[tk, kp]^T (trail), or an inverse accumulation,
// Linv[k, cj] += L[k, kp] Linv[kp, cj]; the top-left corners of its two
// factors and of its destination.
struct ItemB {
  const float* a;
  const float* bt;
  float* dst;
  bool trail;
};

// item W = B w + matrix of phase B of panel kp (nt trailing items a
// matrix, then the accumulations)
__device__ __forceinline__ ItemB item_b(int W, int B, int nt, int kp, int b,
                                        float* L_all, float* Linv_all) {
  const int mt = W % B, w = W / B, o = kp * NB;
  float* L = L_all + (size_t)mt * b * b;
  float* Linv = Linv_all + (size_t)mt * b * b;
  if (w < nt) {
    const int x = w + 1;
    int i = (int)((sqrtf(8.0f * x + 1.0f) - 1.0f) * 0.5f);
    while (trail_tiles(i + 1) <= x) ++i;
    while (trail_tiles(i) > x) --i;
    const int ti = (kp + 1 + i) * NB;
    const int tk = (kp + 1 + x - trail_tiles(i)) * NB;
    return {L + (size_t)ti * b + o, L + (size_t)tk * b + o,
            L + (size_t)ti * b + tk, true};
  }
  const int v = w - nt;
  const int k = (kp + 1 + v / (kp + 1)) * NB, cj = (v % (kp + 1)) * NB;
  return {L + (size_t)k * b + o, Linv + (size_t)o * b + cj,
          Linv + (size_t)k * b + cj, false};
}

// the thread's share of an item, through L2 only: the elements of the two
// factors that load_tile would give it (rows tid/32 + 8u, column tid%32),
// and the 4 destination values its tile product updates (row tid/8,
// columns tid%8 + 8u)
__device__ __forceinline__ void fetch_b(const ItemB& it, int b, float pa[4],
                                        float pb[4], float pd[4]) {
  const int lr = threadIdx.x >> 5, lc = threadIdx.x & 31;
  const int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    pa[u] = __ldcg(it.a + (size_t)(lr + 8 * u) * b + lc);
    pb[u] = __ldcg(it.bt + (size_t)(lr + 8 * u) * b + lc);
    pd[u] = __ldcg(it.dst + (size_t)r * b + c0 + 8 * u);
  }
}

// D^T of panel kp of one matrix from its L, into sDT, and its failed
// pivots' mask from failp into *sFail (all threads; a block barrier
// before, so that no warp still reads the old ones, and after)
__device__ __forceinline__ void reload_dt(TileT sDT, unsigned* sFail,
                                          const float* L, int b, int o,
                                          const unsigned* failp) {
  __syncthreads();
  for (int e = threadIdx.x; e < NB * NB; e += NT) {
    const int i = e & 31, k = e >> 5;
    sDT[k][i] = __ldcg(L + (size_t)(o + i) * b + o + k);
  }
  if (threadIdx.x == 0) *sFail = __ldcg(failp);
  __syncthreads();
}

// ONE: the B = 1 instantiation (the leaf), B and C known at compile time
template <bool ONE>
__global__ void __launch_bounds__(NT)
chol_linv_coop_kernel(const float* __restrict__ A_all, float* L_all,
                      float* Linv_all, float* ok, unsigned* fail, int B_arg,
                      int b, int C_arg) {
  const int B = ONE ? 1 : B_arg, C = ONE ? 1 : C_arg;
  cg::grid_group grid = cg::this_grid();
  __shared__ Tile sA, sB, sDinv;
  __shared__ __align__(16) TileT sDT;
  __shared__ __align__(16) float sCol[NB];
  __shared__ unsigned sFail;  // the failed pivots of the D^T in sDT

  const int tid = threadIdx.x, g = blockIdx.x, G = gridDim.x;
  const int r = tid >> 3, c0 = tid & 7;
  const int npan = b / NB;
  const size_t bb = (size_t)b * b;
  // the matrices whose chain this block carries: g, g + C, ... < B
  const int chain0 = g < C ? g : B;
  // the items go to blocks C .. G-1 in turn (to all blocks, before their
  // chains, if G = C)
  const int first = G > C ? C : 0, nw = G - first, wid = g - first;
  // the (matrix, panel) of the D^T in sDT and of the Dinv in sDinv
  int dt_at = -1, dinv_at = -1;

  // L = tril(A), Linv = 0 but for each first diagonal tile, which the
  // matrix's chain block factors and inverts meanwhile: on the worker
  // blocks (on all blocks if there are none), four columns a thread (b is
  // a multiple of 32) and four loads in flight, in 32-bit indices
  if (wid >= 0) {
    const int q4 = b / 4, n4 = b * q4, total = B * n4, step = nw * NT;
    const float4* A4 = reinterpret_cast<const float4*>(A_all);
    float4* L4 = reinterpret_cast<float4*>(L_all);
    float4* Li4 = reinterpret_cast<float4*>(Linv_all);
    for (int e0 = wid * NT + tid; e0 < total; e0 += 4 * step) {
      float4 a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e0 + u * step < total) a[u] = A4[e0 + u * step];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * step;
        if (e >= total) break;
        const int x = e % n4, i = x / q4, k = 4 * (x - i * q4);
        if (i < NB && k < NB) continue;
        L4[e] = make_float4(k <= i ? a[u].x : 0.0f, k + 1 <= i ? a[u].y : 0.0f,
                            k + 2 <= i ? a[u].z : 0.0f,
                            k + 3 <= i ? a[u].w : 0.0f);
        Li4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
  }
  for (int mt = chain0; mt < B; mt += C) {
    const float* A = A_all + mt * bb;
    for (int e = tid; e < NB * NB; e += NT) {
      int i = e >> 5, k = e & 31;
      sB[i][k] = k <= i ? A[(size_t)i * b + k] : 0.0f;
    }
    __syncthreads();
    const bool okm = factor_tile(sB, sDT, sCol, &sFail, fail + mt * npan,
                                 L_all + mt * bb, b, 0);
    if (tid == 0) ok[mt] = okm ? 1.0f : 0.0f;
    invert_tile(sDT, sDinv, Linv_all + mt * bb, b, 0);
    dt_at = dinv_at = mt * npan;
  }
  grid.sync();

  for (int kp = 0; kp < npan; ++kp) {
    const int o = kp * NB, T = npan - 1 - kp;

    // Phase A. items w < T-1: the rows of row tile kp+2+w; items T-1 ..
    // T+kp-2: inverse tile cj = w - (T-1) of row tile kp. Chain blocks:
    // the look-ahead (T > 0).
    const int na = items_a(npan, kp);
    for (int W = wid; W >= 0 && W < B * na; W += nw) {
      const int mt = W % B, w = W / B, at = mt * npan + kp;
      float* L = L_all + mt * bb;
      float* Linv = Linv_all + mt * bb;
      if (w < T - 1) {
        if (dt_at != at) {
          reload_dt(sDT, &sFail, L, b, o, fail + at);
          dt_at = at;
        }
        solve_rows(L, b, kp + 2 + w, o, sDT, &sFail, nullptr);
      } else {
        const int cj = w - (T > 0 ? T - 1 : 0);
        if (dinv_at != at) {  // every reader of sDinv passed a barrier
          load_tile<true>(sDinv, Linv, b, o, o);
          dinv_at = at;
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
    for (int mt = chain0; mt < B; mt += C) {
      // the look-ahead: row tile kp+1, its trailing update of tile
      // (kp+1, kp+1), and that tile's factor, the next panel's D
      float* L = L_all + mt * bb;
      const int t1 = (kp + 1) * NB;
      if (dt_at != mt * npan + kp)
        reload_dt(sDT, &sFail, L, b, o, fail + mt * npan + kp);
      load_tile<true>(sB, L, b, t1, t1);
      solve_rows(L, b, kp + 1, o, sDT, &sFail, sA);
      __syncthreads();
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mm_nt(acc, sA, sA);
#pragma unroll
      for (int u = 0; u < 4; ++u) sB[r][c0 + 8 * u] -= acc[u];
      __syncthreads();
      if (!factor_tile(sB, sDT, sCol, &sFail, fail + mt * npan + kp + 1, L,
                       b, t1) && tid == 0)
        ok[mt] = 0.0f;
      dt_at = mt * npan + kp + 1;
    }
    grid.sync();

    // Phase B. items w < T(T+1)/2 - 1: trailing tile w+1 (ti, tk), kp <
    // tk <= ti, row by row, tile 0 (kp+1, kp+1) being the look-ahead's;
    // then the inverse accumulations (k, cj), k > kp, cj <= kp. Chain
    // blocks: the next panel's Dinv.
    // A block's items run one behind their loads: the next item's tiles
    // and destination are read into registers while this one multiplies
    // (no item of the phase writes what another reads).
    const int nt = trail_tiles(T) - 1, nW = B * items_b(npan, kp);
    if (wid >= 0 && wid < nW) {
      ItemB cur = item_b(wid, B, nt, kp, b, L_all, Linv_all);
      float pa[4], pb[4], pd[4];
      fetch_b(cur, b, pa, pb, pd);
      for (int W = wid;; W += nw) {
        const int lr = tid >> 5, lc = tid & 31;
        float acc[4], dcur[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sA[lr + 8 * u][lc] = pa[u];
          sB[lr + 8 * u][lc] = pb[u];
          dcur[u] = pd[u];
          acc[u] = cur.trail ? 0.0f : pd[u];  // L -= A B^T; Linv += A B
        }
        __syncthreads();
        const bool more = W + nw < nW;
        ItemB nxt = cur;
        if (more) {
          nxt = item_b(W + nw, B, nt, kp, b, L_all, Linv_all);
          fetch_b(nxt, b, pa, pb, pd);
        }
        float* dst = cur.dst + (size_t)r * b + c0;
        if (cur.trail) {
          mm_nt(acc, sA, sB);
#pragma unroll
          for (int u = 0; u < 4; ++u) dst[8 * u] = dcur[u] - acc[u];
        } else {
          mm_nn(acc, sA, sB);
#pragma unroll
          for (int u = 0; u < 4; ++u) dst[8 * u] = acc[u];
        }
        __syncthreads();
        if (!more) break;
        cur = nxt;
      }
    }
    for (int mt = chain0; mt < B; mt += C) {
      const int at = mt * npan + kp + 1;
      if (dt_at != at) {
        reload_dt(sDT, &sFail, L_all + mt * bb, b, (kp + 1) * NB, fail + at);
        dt_at = at;
      }
      invert_tile(sDT, sDinv, Linv_all + mt * bb, b, (kp + 1) * NB);
      dinv_at = at;
    }
    grid.sync();
  }
}

// The cooperative launch for B matrices of size b on the current device:
// G blocks, the occupancy limit times the SM count (Gmax) capped at C + the
// most items a phase deals out, and C chain blocks, min(B, Gmax / 2) (at
// least 1). Returns a cudaError_t (cudaErrorNotSupported where the device
// has no cooperative launch).
// the instantiation that serves B matrices with C chain blocks
const void* coop_kernel(int B, int C) {
  return B == 1 && C == 1 ? (const void*)chol_linv_coop_kernel<true>
                          : (const void*)chol_linv_coop_kernel<false>;
}

}  // namespace

extern "C" int rpagp_chol_linv_coop_grid(int B, int b, int* G, int* C) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int gmax = 0;
  for (int one = 0; one < 2 && e == cudaSuccess; ++one) {
    // the smaller grid of the two instantiations, so that C and G do not
    // depend on which one the occupancy favours
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, coop_kernel(one ? 1 : 2, one ? 1 : 2), NT, 0);
    if (e == cudaSuccess && (one == 0 || per_sm * sms < gmax))
      gmax = per_sm * sms;
  }
  if (e != cudaSuccess) return (int)e;
  const int half = gmax / 2 > 1 ? gmax / 2 : 1;
  *C = B < half ? B : half;
  const long want = *C + most_items(B, b);
  *G = want < gmax ? (int)want : gmax;
  return *G >= 1 && B >= 1 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// A, L, Linv: (B, b, b) f32 contiguous on the device; ok: (B,) f32; fail:
// B * b/32 words of scratch (the failed pivots' masks). b a positive
// multiple of 32, G and C from rpagp_chol_linv_coop_grid (any
// 1 <= C <= min(B, G) is valid). Returns the cooperative launch's error
// (cudaErrorCooperativeLaunchTooLarge if the G blocks cannot all be
// resident), else cudaGetLastError().
extern "C" int rpagp_chol_linv_coop(const float* A, float* L, float* Linv,
                                    float* ok, unsigned* fail, int B, int b,
                                    int G, int C, void* stream) {
  if (C < 1 || C > B || C > G) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&A,    (void*)&L, (void*)&Linv, (void*)&ok,
                  (void*)&fail, (void*)&B, (void*)&b,    (void*)&C};
  cudaError_t e = cudaLaunchCooperativeKernel(
      coop_kernel(B, C), dim3(G), dim3(NT), args, 0, (cudaStream_t)stream);
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
