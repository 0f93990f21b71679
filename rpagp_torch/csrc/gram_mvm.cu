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
// (rbf, matern12/32/52) are one template parameter. Everything is f32;
// k1d' is 0 at d = 0 for the Matern bases, as jnp.sign(0) = 0 makes it in
// the TPU kernel. No output is summed with atomics: every call repeats
// bit for bit.
//
// What bounds them on the H100: n m J exponentials per call (2.2e9 at
// n = m = 14,939, J = 10) on the exp unit's 16 per clock per SM, next to
// 2 n m (J + t) f32 operations and a few MB of inputs. At t = 256 (the
// posterior's cross product) the 2 n m t FMAs of the contraction bound K4
// instead.
//
// K4 is built around the exp unit. A first pass writes the coordinates
// transposed, padded to the tile and prescaled per base (c = sqrt(log2(e)
// / 2) for rbf; log2(e), sqrt(3) log2(e) and sqrt(5) log2(e) for
// matern12/32/52), so that a tile is staged with 16-byte copies and k1d is
// one 2^x of d' = c z1 - c z2: rbf 2^(-d'^2), the Matern bases 2^(-|d'|)
// times their polynomial in s = |d'| ln 2, with w_j folded into it. A pair
// and component then costs an FADD, an FMUL (an FFMA or two for the
// Matern polynomial), one MUFU.EX2 (ex2.approx.ftz.f32: results below
// 2^-126 flush to 0, far below the sums' rounding) and an FFMA with w_j:
// few enough issue slots that the exp unit sets the pace. A thread owns a
// 4 x 4 block of the 64 x 64 Gram tile (rows ty*4 + i, columns tx + 16 q),
// so 8 coordinate loads serve 16 exps. The z2 and V tiles are
// double-buffered in shared memory with cp.async, the next tile's copies
// in flight while this one's exps run. The grid is persistent, sized to
// the card, over work items (row tile, z2 chunk); the wrapper picks the
// number of chunks so that the items fill the blocks evenly. Each item
// writes its partial sums to its own slot, and a second kernel adds the
// slots in chunk order. Two forms of the contraction with V:
//   narrow (t <= 16): each thread contracts its Gram values with V in
//     registers, t rounded up to 1, 4, 8, 12 or 16 columns; the 16
//     threads of a row group then add their partial rows by a fixed
//     butterfly of shuffles.
//   wide (t > 16): the block writes its Gram tile once to shared memory
//     and every thread contracts it against V's columns, 64, 128 or 256
//     at a time (slabs of 256 beyond that), so the Gram is not recomputed
//     per column tile.
//
// K5 (not redesigned yet) computes with the accurate expf. One block owns
// 64 rows and walks all of z2 in tiles of 64; its per-row dz sums stay in
// registers and are added in a fixed order, its dw partials are reduced
// within the block in a fixed tree and then across blocks by a second
// kernel, in block order, in f64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int J_MAX = 64;   // per launch (K5 keeps J sums per thread)
// K5's tiles
constexpr int TI = 64;      // rows per block
constexpr int TL = 64;      // z2 rows per tile
constexpr int NPART = NT / TI;
constexpr int LQ = TL / NPART;  // columns per thread per tile (16)
constexpr int TCH = 32;     // columns of t per staged chunk

constexpr float SQRT3 = 1.7320508075688772f;
constexpr float SQRT5 = 2.23606797749979f;

enum Base { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

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

// ---------------------------------------------------------------- K4 ----

constexpr int FT = 64;      // rows (z1) and columns (z2) of a Gram tile
constexpr int FR = 4;       // rows per thread: ty * FR + i, ty = tid / 16
constexpr int FQ = 4;       // columns per thread: tx + 16 q, tx = tid % 16
constexpr int FK = FT + 4;  // the wide form's Gram tile stride, s_k[l][row]
constexpr float LN2 = 0.6931471805599453f;

// the coordinates' scale per base: k1d(z1 - z2) is then a function of
// d' = c z1 - c z2 through one 2^x
template <int BASE>
__host__ __device__ constexpr float coord_scale() {
  return BASE == RBF        ? 0.8493218002880191f   // sqrt(log2(e) / 2)
         : BASE == MATERN12 ? 1.4426950408889634f   // log2(e)
         : BASE == MATERN32 ? 2.4988211106473432f   // sqrt(3) log2(e)
                            : 3.225964182229561f;   // sqrt(5) log2(e)
}

// 2^x on the exp unit, one MUFU.EX2; results below 2^-126 flush to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte and 16-byte asynchronous copies global -> shared; a copy with
// in = false reads nothing and writes zeros
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most one group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// zt[j, r] = c z[r, j] for r < rows, 0 for rows <= r < rp: the
// coordinates as K4 stages them, transposed, prescaled, and padded to rp,
// a multiple of the tile
__global__ void coords_t_kernel(const float* __restrict__ z,
                                float* __restrict__ zt, int rows, int rp,
                                int J, float c) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rp) return;
  for (int j = 0; j < J; ++j)
    zt[(size_t)j * rp + r] = r < rows ? c * z[(size_t)r * J + j] : 0.0f;
}

// columns x0 .. x0+63 of zt (J, xp) into s (J, FT), 16 bytes a copy
__device__ __forceinline__ void stage_coords_t(float* s, const float* zt,
                                               int x0, int xp, int J) {
  for (int e = threadIdx.x; e < J * (FT / 4); e += NT) {
    const int j = e >> 4, c = 4 * (e & 15);
    cp_async16(s + j * FT + c, zt + (size_t)j * xp + x0 + c, true);
  }
}

// the z2 tile of rows l0 .. l0+63 into s_z2 (J, FT), and V's rows there,
// columns c0 .. c0+tcols-1, into s_v (FT, vs): asynchronously, V zero past
// m and t. vec: t, c0 and tcols are multiples of 4 and V is 16-byte
// aligned.
__device__ __forceinline__ void stage_tile(float* s_z2, float* s_v,
                                           const float* z2t, const float* V,
                                           int l0, int mp, int m, int J,
                                           int t, int c0, int tcols, int vs,
                                           bool vec) {
  stage_coords_t(s_z2, z2t, l0, mp, J);
  if (vec) {
    const int q4 = tcols / 4;
    for (int e = threadIdx.x; e < FT * q4; e += NT) {
      const int ll = e / q4, c = 4 * (e - ll * q4);
      const bool in = l0 + ll < m && c0 + c < t;
      cp_async16(s_v + ll * vs + c,
                 in ? V + (size_t)(l0 + ll) * t + c0 + c : V, in);
    }
  } else {
    for (int e = threadIdx.x; e < FT * tcols; e += NT) {
      const int ll = e / tcols, c = e - ll * tcols;
      const bool in = l0 + ll < m && c0 + c < t;
      cp_async4(s_v + ll * vs + c,
                in ? V + (size_t)(l0 + ll) * t + c0 + c : V, in);
    }
  }
}

// ks[i][q] = sum_j w_j k1d(z1[row ty*FR + i, j] - z2[col tx + 16 q, j]) of
// one tile, from the prescaled coordinates z1s and z2s (J, FT)
template <int BASE>
__device__ __forceinline__ void gram_tile(float ks[FR][FQ], const float* z1s,
                                          const float* z2s, const float* ws,
                                          int J, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int q = 0; q < FQ; ++q) ks[i][q] = 0.0f;
#pragma unroll 2
  for (int j = 0; j < J; ++j) {
    const float4 a4 = *reinterpret_cast<const float4*>(z1s + j * FT + ty * FR);
    const float a[FR] = {a4.x, a4.y, a4.z, a4.w};
    float bq[FQ];
#pragma unroll
    for (int q = 0; q < FQ; ++q) bq[q] = z2s[j * FT + tx + 16 * q];
    const float wj = ws[j];
    if (BASE == RBF || BASE == MATERN12) {
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int q = 0; q < FQ; ++q) {
          const float d = a[i] - bq[q];
          const float e = BASE == RBF ? ex2(-d * d) : ex2(-fabsf(d));
          ks[i][q] = fmaf(wj, e, ks[i][q]);
        }
    } else if (BASE == MATERN32) {
      // w (1 + s) 2^-|d'|, s = |d'| ln 2
      const float wl = wj * LN2;
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int q = 0; q < FQ; ++q) {
          const float d = fabsf(a[i] - bq[q]);
          ks[i][q] = fmaf(fmaf(d, wl, wj), ex2(-d), ks[i][q]);
        }
    } else {
      // w (1 + s + s^2 / 3) 2^-|d'|, s = |d'| ln 2
      const float wl = wj * LN2, w2 = wj * (LN2 * LN2 / 3.0f);
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int q = 0; q < FQ; ++q) {
          const float d = fabsf(a[i] - bq[q]);
          const float p = fmaf(d, fmaf(d, w2, wl), wj);
          ks[i][q] = fmaf(p, ex2(-d), ks[i][q]);
        }
    }
  }
}

// the narrow form's V row stride in shared memory: a multiple of 4 (float4
// reads) whose quarter is odd, so that 8 lanes reading rows tx, tx + 1, ..
// hit distinct banks
template <int TCP>
__host__ __device__ constexpr int narrow_vs() {
  return TCP == 1 ? 1 : ((TCP / 4) % 2 ? TCP : TCP + 4);
}

// The z2 chunk of item `it`: tiles [lt0, lt1) of the LT tiles of 64
__device__ __forceinline__ void chunk_tiles(int s, int S, int LT, int* lt0,
                                            int* lt1) {
  *lt0 = (int)((long long)s * LT / S);
  *lt1 = (int)((long long)(s + 1) * LT / S);
}

// narrow form, t <= TCP in {1, 4, 8, 12, 16}. z1t (J, np), z2t (J, mp):
// the coordinates from coords_t_kernel. Items (row tile rt, z2 chunk s),
// it = s RT + rt, over a persistent grid; the item's rows go to slot s of
// dst, (S, n, t). Dynamic shared memory: (2 FT VS + 3 J FT + J) floats.
template <int BASE, int TCP>
__global__ void __launch_bounds__(NT, 2)
gram_mvm_narrow_kernel(const float* __restrict__ z1t,
                       const float* __restrict__ z2t,
                       const float* __restrict__ w,
                       const float* __restrict__ V, float* __restrict__ dst,
                       int n, int m, int J, int t, int S, int vec) {
  constexpr int VS = narrow_vs<TCP>();
  extern __shared__ __align__(16) float smem[];
  float* s_v = smem;                 // 2 x (FT, VS)
  float* s_z1 = s_v + 2 * FT * VS;   // (J, FT), scaled
  float* s_z2 = s_z1 + J * FT;       // 2 x (J, FT), scaled
  float* s_w = s_z2 + 2 * J * FT;    // (J,)

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int RT = (n + FT - 1) / FT, LT = (m + FT - 1) / FT;
  const int np = RT * FT, mp = LT * FT;
  for (int j = tid; j < J; j += NT) s_w[j] = w[j];

  for (int it = blockIdx.x; it < RT * S; it += gridDim.x) {
    const int rt = it % RT, s = it / RT, row0 = rt * FT;
    int lt0, lt1;
    chunk_tiles(s, S, LT, &lt0, &lt1);
    __syncthreads();  // the last item is done with the shared tiles
    stage_coords_t(s_z1, z1t, row0, np, J);
    stage_tile(s_z2, s_v, z2t, V, lt0 * FT, mp, m, J, t, 0, TCP, VS, vec);
    cp_async_commit();

    float acc[FR][TCP];
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int c = 0; c < TCP; ++c) acc[i][c] = 0.0f;
    for (int lt = lt0; lt < lt1; ++lt) {
      const int buf = (lt - lt0) & 1;
      if (lt + 1 < lt1)
        stage_tile(s_z2 + (buf ^ 1) * J * FT, s_v + (buf ^ 1) * FT * VS,
                   z2t, V, (lt + 1) * FT, mp, m, J, t, 0, TCP, VS, vec);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();  // tile lt has landed, for every thread's copies

      float ks[FR][FQ];
      gram_tile<BASE>(ks, s_z1, s_z2 + buf * J * FT, s_w, J, ty, tx);
      const float* vt = s_v + buf * FT * VS;
#pragma unroll
      for (int q = 0; q < FQ; ++q) {
        const float* vr = vt + (tx + 16 * q) * VS;
        if (TCP == 1) {
          const float v = vr[0];
#pragma unroll
          for (int i = 0; i < FR; ++i) acc[i][0] = fmaf(ks[i][q], v, acc[i][0]);
        } else {
#pragma unroll
          for (int c4 = 0; c4 < TCP / 4; ++c4) {
            const float4 v = reinterpret_cast<const float4*>(vr)[c4];
#pragma unroll
            for (int i = 0; i < FR; ++i) {
              acc[i][4 * c4] = fmaf(ks[i][q], v.x, acc[i][4 * c4]);
              acc[i][4 * c4 + 1] = fmaf(ks[i][q], v.y, acc[i][4 * c4 + 1]);
              acc[i][4 * c4 + 2] = fmaf(ks[i][q], v.z, acc[i][4 * c4 + 2]);
              acc[i][4 * c4 + 3] = fmaf(ks[i][q], v.w, acc[i][4 * c4 + 3]);
            }
          }
        }
      }
      __syncthreads();  // buffer buf is free for tile lt + 2
    }

    // the 16 lanes of a row group hold sums over their own columns: a
    // butterfly gives each lane the same total, in a fixed order
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int c = 0; c < TCP; ++c)
#pragma unroll
        for (int h = 8; h >= 1; h >>= 1)
          acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], h);
    float* out = dst + (size_t)s * n * t;
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      const int row = row0 + ty * FR + i;
#pragma unroll
      for (int c = 0; c < TCP; ++c)
        if ((i * TCP + c) % 16 == tx && row < n && c < t)
          out[(size_t)row * t + c] = acc[i][c];
    }
  }
}

// wide form, slabs of TS = 16 TSC columns of V (TSC in {4, 8, 16}). Items
// (row tile rt, z2 chunk s, slab sl), it = (sl S + s) RT + rt; a thread
// owns rows ty*FR + i and columns 64 c4 + 4 tx + u of the slab. Dynamic
// shared memory: (2 FT TS + FT FK + 3 J FT + J) floats.
template <int BASE, int TSC>
__global__ void __launch_bounds__(NT, 1)
gram_mvm_wide_kernel(const float* __restrict__ z1t,
                     const float* __restrict__ z2t,
                     const float* __restrict__ w,
                     const float* __restrict__ V, float* __restrict__ dst,
                     int n, int m, int J, int t, int S, int vec) {
  constexpr int TS = 16 * TSC;
  extern __shared__ __align__(16) float smem[];
  float* s_v = smem;                 // 2 x (FT, TS)
  float* s_k = s_v + 2 * FT * TS;    // (FT, FK): s_k[l][row], the Gram tile
  float* s_z1 = s_k + FT * FK;       // (J, FT), scaled
  float* s_z2 = s_z1 + J * FT;       // 2 x (J, FT), scaled
  float* s_w = s_z2 + 2 * J * FT;    // (J,)

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int RT = (n + FT - 1) / FT, LT = (m + FT - 1) / FT;
  const int np = RT * FT, mp = LT * FT;
  const int NSL = (t + TS - 1) / TS;
  for (int j = tid; j < J; j += NT) s_w[j] = w[j];

  for (int it = blockIdx.x; it < RT * S * NSL; it += gridDim.x) {
    const int rt = it % RT, s = (it / RT) % S, sl = it / (RT * S);
    const int row0 = rt * FT, c0 = sl * TS;
    int lt0, lt1;
    chunk_tiles(s, S, LT, &lt0, &lt1);
    __syncthreads();
    stage_coords_t(s_z1, z1t, row0, np, J);
    stage_tile(s_z2, s_v, z2t, V, lt0 * FT, mp, m, J, t, c0, TS, TS, vec);
    cp_async_commit();

    float acc[FR][TSC];
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int c = 0; c < TSC; ++c) acc[i][c] = 0.0f;
    for (int lt = lt0; lt < lt1; ++lt) {
      const int buf = (lt - lt0) & 1;
      if (lt + 1 < lt1)
        stage_tile(s_z2 + (buf ^ 1) * J * FT, s_v + (buf ^ 1) * FT * TS,
                   z2t, V, (lt + 1) * FT, mp, m, J, t, c0, TS, TS, vec);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();

      float ks[FR][FQ];
      gram_tile<BASE>(ks, s_z1, s_z2 + buf * J * FT, s_w, J, ty, tx);
#pragma unroll
      for (int q = 0; q < FQ; ++q)
        *reinterpret_cast<float4*>(s_k + (tx + 16 * q) * FK + ty * FR) =
            make_float4(ks[0][q], ks[1][q], ks[2][q], ks[3][q]);
      __syncthreads();

      const float* vt = s_v + buf * FT * TS;
#pragma unroll 4
      for (int l = 0; l < FT; ++l) {
        const float4 k4 = *reinterpret_cast<const float4*>(s_k + l * FK +
                                                           ty * FR);
        const float kk[FR] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int c4 = 0; c4 < TSC / 4; ++c4) {
          const float4 v = *reinterpret_cast<const float4*>(
              vt + l * TS + 64 * c4 + 4 * tx);
#pragma unroll
          for (int i = 0; i < FR; ++i) {
            acc[i][4 * c4] = fmaf(kk[i], v.x, acc[i][4 * c4]);
            acc[i][4 * c4 + 1] = fmaf(kk[i], v.y, acc[i][4 * c4 + 1]);
            acc[i][4 * c4 + 2] = fmaf(kk[i], v.z, acc[i][4 * c4 + 2]);
            acc[i][4 * c4 + 3] = fmaf(kk[i], v.w, acc[i][4 * c4 + 3]);
          }
        }
      }
      __syncthreads();  // s_k and buffer buf are free
    }

    float* out = dst + (size_t)s * n * t;
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      const int row = row0 + ty * FR + i;
#pragma unroll
      for (int c4 = 0; c4 < TSC / 4; ++c4)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int col = c0 + 64 * c4 + 4 * tx + u;
          if (row < n && col < t)
            out[(size_t)row * t + col] = acc[i][4 * c4 + u];
        }
    }
  }
}

// out[e] = sum_s part[s][e], s = 0 .. S-1 in order
__global__ void chunk_sum_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, size_t count,
                                 int S) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = part[e];
    for (int k = 1; k < S; ++k) v += part[(size_t)k * count + e];
    out[e] = v;
  }
}

// The forward kernel for width t and J components: its function, its
// dynamic shared memory, and the slabs of t it covers per item
struct FwdKernel {
  const void* fn;
  size_t bytes;
  int slabs;
};

template <int BASE, int TCP>
FwdKernel narrow(int J) {
  return {(const void*)gram_mvm_narrow_kernel<BASE, TCP>,
          sizeof(float) * (2 * FT * narrow_vs<TCP>() + 3 * J * FT + J),
          1};
}

template <int BASE, int TSC>
FwdKernel wide(int J, int t) {
  constexpr int TS = 16 * TSC;
  return {(const void*)gram_mvm_wide_kernel<BASE, TSC>,
          sizeof(float) * (2 * FT * TS + FT * FK + 3 * J * FT + J),
          (t + TS - 1) / TS};
}

template <int BASE>
FwdKernel fwd_kernel_of(int J, int t) {
  if (t <= 16) {
    switch (t == 1 ? 1 : (t + 3) / 4 * 4) {
      case 1: return narrow<BASE, 1>(J);
      case 4: return narrow<BASE, 4>(J);
      case 8: return narrow<BASE, 8>(J);
      case 12: return narrow<BASE, 12>(J);
      default: return narrow<BASE, 16>(J);
    }
  }
  if (t <= 64) return wide<BASE, 4>(J, t);
  if (t <= 128) return wide<BASE, 8>(J, t);
  return wide<BASE, 16>(J, t);
}

// the kernel for (base, J, t), its shared-memory limit raised where it
// needs more than 48 KB; fn = nullptr for an unknown base
FwdKernel fwd_kernel(int base, int J, int t) {
  FwdKernel k{nullptr, 0, 0};
  switch (base) {
    case RBF: k = fwd_kernel_of<RBF>(J, t); break;
    case MATERN12: k = fwd_kernel_of<MATERN12>(J, t); break;
    case MATERN32: k = fwd_kernel_of<MATERN32>(J, t); break;
    case MATERN52: k = fwd_kernel_of<MATERN52>(J, t); break;
  }
  if (k.fn != nullptr && k.bytes > 48 * 1024)
    cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)k.bytes);
  return k;
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

// K4's persistent grid on the current device for (J, t, base): G, the
// blocks of the chosen forward kernel the card holds at once, and the
// slabs of t that kernel covers per item (1 for t <= 16, else slabs of up
// to 256 columns). Returns a cudaError_t.
extern "C" int rpagp_gram_mvm_grid(int J, int t, int base, int* G,
                                   int* slabs) {
  if (J < 1 || J > J_MAX || t < 1) return (int)cudaErrorInvalidValue;
  const FwdKernel k = fwd_kernel(base, J, t);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.fn, NT,
                                                      k.bytes);
  if (e != cudaSuccess) return (int)e;
  *G = per_sm * sms;
  *slabs = k.slabs;
  return *G >= 1 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// z1 (n, J), z2 (m, J), w (J,), V (m, t), out (n, t), all contiguous f32;
// base 0..3 = rbf, matern12, matern32, matern52; 1 <= J <= 64 (the
// wrapper sums the launches over groups of 64 components). zt: f32
// scratch of J (np + mp) floats, np and mp being n and m rounded up to 64
// (the coordinates, transposed and prescaled; z1's serve z2 where z1 == z2
// and n == m). S >= 1 z2 chunks, at most ceil(m / 64); part: (S, n, t) f32
// scratch where S > 1 (the chunks' partial sums, added in chunk order
// into out), unused at S = 1. G: the persistent grid, at most
// rpagp_gram_mvm_grid's. Returns cudaGetLastError().
extern "C" int rpagp_gram_mvm(const float* z1, const float* z2, const float* w,
                              const float* V, float* out, float* part,
                              float* zt, int n, int m, int J, int t, int base,
                              int S, int G, void* stream) {
  if (J < 1 || J > J_MAX || S < 1 || S > (m + FT - 1) / FT || G < 1 ||
      n < 1 || t < 1)
    return (int)cudaErrorInvalidValue;
  const FwdKernel k = fwd_kernel(base, J, t);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float c = base == RBF        ? coord_scale<RBF>()
                  : base == MATERN12 ? coord_scale<MATERN12>()
                  : base == MATERN32 ? coord_scale<MATERN32>()
                                     : coord_scale<MATERN52>();
  const int np = (n + FT - 1) / FT * FT, mp = (m + FT - 1) / FT * FT;
  const float* z1t = zt;
  const float* z2t = zt + (size_t)J * np;
  coords_t_kernel<<<(np + 255) / 256, 256, 0, s>>>(z1, zt, n, np, J, c);
  if (z2 == z1 && m == n)
    z2t = z1t;
  else
    coords_t_kernel<<<(mp + 255) / 256, 256, 0, s>>>(
        z2, zt + (size_t)J * np, m, mp, J, c);
  const long long items = (long long)(np / FT) * S * k.slabs;
  const int grid = items < G ? (int)items : G;
  float* dst = S > 1 ? part : out;
  int vec = t % 4 == 0 && ((uintptr_t)V & 15) == 0;
  void* args[] = {(void*)&z1t, (void*)&z2t, (void*)&w,   (void*)&V,
                  (void*)&dst, (void*)&n,   (void*)&m,   (void*)&J,
                  (void*)&t,   (void*)&S,   (void*)&vec};
  cudaError_t e = cudaLaunchKernel(k.fn, dim3(grid), dim3(NT), args, k.bytes, s);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)e;
  }
  if (S > 1) {
    const size_t count = (size_t)n * t;
    const size_t blocks = (count + 255) / 256;
    chunk_sum_kernel<<<blocks < 4096 ? (int)blocks : 4096, 256, 0, s>>>(
        part, out, count, S);
  }
  return (int)cudaGetLastError();
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
