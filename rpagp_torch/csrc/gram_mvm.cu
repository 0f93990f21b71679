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
// K5 takes the same route, with k1d and k1d' from one 2^x (the chain rule
// for c folded into one factor per base, applied with w_j at the end). Its
// tile is 64 rows by 128 z2 columns: thread tid owns row tid / 4 and 32
// columns, so the Gm = G V^T tile is formed in registers (t FMAs a pair,
// V^T staged by cp.async and double-buffered with the z2 coordinates, the
// thread's row of G held in registers) and shared by all J components.
// The component loop is outermost inside a tile, so no register array is
// indexed by a component: per component a thread adds its 32 pairs into
// one row sum for dz and one for dw (rbf: FADD, FMUL, MUFU.EX2, FMUL,
// FFMA, FADD), the row's 4 lanes are added by a fixed butterfly, and one
// lane adds the totals into the row's slots in shared memory. A
// persistent grid walks (row tile, z2 chunk) items; each item writes its
// dz rows to its chunk's slot and its dw sums to its own slot, and two
// small kernels add the slots in order (dw in f64).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int J_MAX = 64;   // components per launch

enum Base { RBF = 0, MATERN12 = 1, MATERN32 = 2, MATERN52 = 3 };

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

// rows x width floats from src (row stride xp, starting at column x0) into
// s (row stride width), 16 bytes a copy, asynchronously; width % 4 == 0:
// a tile of the coordinates from coords_t_kernel, or of V^T
__device__ __forceinline__ void stage_rows(float* s, const float* src, int x0,
                                           int xp, int rows, int width) {
  const int w4 = width / 4;
  for (int e = threadIdx.x; e < rows * w4; e += NT) {
    const int r = e / w4, c = 4 * (e - r * w4);
    cp_async16(s + r * width + c, src + (size_t)r * xp + x0 + c, true);
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
  stage_rows(s_z2, z2t, l0, mp, J, FT);
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
    stage_rows(s_z1, z1t, row0, np, J, FT);
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
    stage_rows(s_z1, z1t, row0, np, J, FT);
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

// ---------------------------------------------------------------- K5 ----

constexpr int BR = 64;   // K5: rows of a tile, one per group of 4 lanes
constexpr int BL = 128;  // K5: z2 columns of a tile
constexpr int BQ = 32;   // K5: columns per thread: 16 k + 4 g + u, k < 8, u < 4
constexpr float LN2SQ3 = 0.16015100463940046f;  // ln(2)^2 / 3

// dz[i, j] = w_j * dz_scale * (the kernel's sum), the chain rule for the
// prescaled coordinates: k1d'(d) is, with d' = c d and e = 2^(-d'^2) or
// 2^(-|d'|), -d' e / c (rbf), -sign(d') e (matern12), -sqrt(3) ln2 d' e
// (matern32), -(sqrt(5) ln2 / 3) d' (1 + |d'| ln2) e (matern52)
template <int BASE>
__host__ __device__ constexpr float dz_scale() {
  return BASE == RBF        ? -1.1774100225154747f   // -1 / c = -sqrt(2 ln 2)
         : BASE == MATERN12 ? -1.0f
         : BASE == MATERN32 ? -1.2005661338529436f   // -sqrt(3) ln 2
                            : -0.5166414047147861f;  // -sqrt(5) ln 2 / 3
}

// one pair of one component: the Gram cotangent gm at prescaled difference
// d adds its k1d to adw and its (unscaled) k1d' to adz
template <int BASE>
__device__ __forceinline__ void bwd_pair(float d, float gm, float& adz,
                                         float& adw) {
  if (BASE == RBF) {
    const float ge = gm * ex2(-d * d);
    adz = fmaf(ge, d, adz);
    adw += ge;
  } else if (BASE == MATERN12) {
    const float ge = gm * ex2(-fabsf(d));
    adw += ge;
    adz += d > 0.0f ? ge : (d < 0.0f ? -ge : 0.0f);  // sign(0) = 0
  } else if (BASE == MATERN32) {
    const float u = fabsf(d);
    const float ge = gm * ex2(-u);
    adw = fmaf(ge, fmaf(u, LN2, 1.0f), adw);
    adz = fmaf(ge, d, adz);
  } else {
    const float u = fabsf(d);
    const float ge = gm * ex2(-u);
    adw = fmaf(ge, fmaf(u, fmaf(u, LN2SQ3, LN2), 1.0f), adw);
    adz = fmaf(ge * d, fmaf(u, LN2, 1.0f), adz);
  }
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// columns c0 .. c0+TC-1 of G's row `row`, zero past n and t
template <int TC>
__device__ __forceinline__ void load_g(float gr[TC], const float* G, int row,
                                       int n, int t, int c0) {
#pragma unroll
  for (int c = 0; c < TC; ++c)
    gr[c] = (row < n && c0 + c < t) ? __ldg(G + (size_t)row * t + c0 + c)
                                    : 0.0f;
}

// gm[4 k + u] += sum_c gr[c] V^T[c, 16 k + 4 g + u] over TC rows of the
// staged V^T tile sv (TC, BL)
template <int TC>
__device__ __forceinline__ void contract_g(float gm[BQ], const float gr[TC],
                                           const float* sv, int g) {
#pragma unroll
  for (int c = 0; c < TC; ++c)
#pragma unroll
    for (int k = 0; k < BQ / 4; ++k) {
      const float4 v =
          *reinterpret_cast<const float4*>(sv + c * BL + 16 * k + 4 * g);
      gm[4 * k] = fmaf(gr[c], v.x, gm[4 * k]);
      gm[4 * k + 1] = fmaf(gr[c], v.y, gm[4 * k + 1]);
      gm[4 * k + 2] = fmaf(gr[c], v.z, gm[4 * k + 2]);
      gm[4 * k + 3] = fmaf(gr[c], v.w, gm[4 * k + 3]);
    }
}

// vt[c, l] = V[l, c] for l < m and c < t, 0 elsewhere: V^T padded to
// (tp, mp), so that a tile's rows are staged with 16-byte copies
__global__ void vt_kernel(const float* __restrict__ V, float* __restrict__ vt,
                          int m, int mp, int t, int tp) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= mp) return;
  for (int c = 0; c < tp; ++c)
    vt[(size_t)c * mp + l] = (l < m && c < t) ? V[(size_t)l * t + c] : 0.0f;
}

// K5, columns of V and G in passes of TC (TC in {1, 4, 8, 12, 16}: one pass
// for t <= 16, passes of 16 beyond). z1t (J, np), z2t (J, mp): the
// coordinates from coords_t_kernel, np = RT * BR, mp = LT * BL; vt (tp, mp)
// from vt_kernel. Thread tid owns row tid / 4 of the 64-row tile and
// columns 16 k + 4 g + u of the 128-column z2 tile, g = tid % 4. Items (row
// tile rt, z2 chunk s), it = s RT + rt, over a persistent grid: item it
// adds its rows' dz sums into slot s of dzp (S, n, J) and its dw sums into
// dwp[it] (J,). Per tile: the thread's 32 Gm values in registers (t FMAs
// each, shared by all components), then per component its 32 exps into a
// row sum for dz and one for dw, the 4 lanes of the row added by a fixed
// butterfly into the row's (dz, dw) slots in shared memory. Dynamic shared
// memory: (2 TC BL + 2 J BL + J BR + 2 BR (J | 1)) floats.
template <int BASE, int TC>
__global__ void __launch_bounds__(NT, 2)
gram_mvm_bwd_kernel(const float* __restrict__ z1t,
                    const float* __restrict__ z2t,
                    const float* __restrict__ vt, const float* __restrict__ G,
                    float* __restrict__ dzp, float* __restrict__ dwp, int n,
                    int m, int J, int t, int S) {
  extern __shared__ __align__(16) float smem[];
  const int JS = J | 1;  // odd row stride of the slabs: rows on distinct banks
  float* s_v = smem;                // 2 x (TC, BL): V^T tiles
  float* s_z2 = s_v + 2 * TC * BL;  // 2 x (J, BL), scaled
  float* s_z1 = s_z2 + 2 * J * BL;  // (J, BR), scaled
  float* s_dz = s_z1 + J * BR;      // (BR, JS): the item's dz row sums
  float* s_dw = s_dz + BR * JS;     // (BR, JS): the item's dw row sums

  const int tid = threadIdx.x, row = tid >> 2, g = tid & 3;
  const int RT = (n + BR - 1) / BR, LT = (m + BL - 1) / BL;
  const int np = RT * BR, mp = LT * BL;
  const int tp = (t + TC - 1) / TC * TC;
  const bool wide = tp > TC;  // uniform over the grid

  for (int it = blockIdx.x; it < RT * S; it += gridDim.x) {
    const int rt = it % RT, s = it / RT, row0 = rt * BR;
    int lt0, lt1;
    chunk_tiles(s, S, LT, &lt0, &lt1);
    __syncthreads();  // the last item is done with the tiles and slabs
    for (int e = tid; e < 2 * BR * JS; e += NT) s_dz[e] = 0.0f;
    stage_rows(s_z1, z1t, row0, np, J, BR);
    stage_rows(s_z2, z2t, lt0 * BL, mp, J, BL);
    if (!wide) stage_rows(s_v, vt, lt0 * BL, mp, TC, BL);
    cp_async_commit();
    float gr[TC];
    if (!wide) load_g<TC>(gr, G, row0 + row, n, t, 0);

    for (int lt = lt0; lt < lt1; ++lt) {
      const int buf = (lt - lt0) & 1;
      if (lt + 1 < lt1) {
        stage_rows(s_z2 + (buf ^ 1) * J * BL, z2t, (lt + 1) * BL, mp, J, BL);
        if (!wide)
          stage_rows(s_v + (buf ^ 1) * TC * BL, vt, (lt + 1) * BL, mp, TC,
                     BL);
      }
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();  // tile lt has landed, for every thread's copies

      float gm[BQ];
#pragma unroll
      for (int q = 0; q < BQ; ++q) gm[q] = 0.0f;
      if (!wide) {
        contract_g<TC>(gm, gr, s_v + buf * TC * BL, g);
      } else {
        for (int c0 = 0; c0 < tp; c0 += TC) {
          if (c0 > 0) __syncthreads();  // every thread is done with s_v
          stage_rows(s_v, vt + (size_t)c0 * mp, lt * BL, mp, TC, BL);
          cp_async_commit();
          cp_async_wait0();
          __syncthreads();
          load_g<TC>(gr, G, row0 + row, n, t, c0);
          contract_g<TC>(gm, gr, s_v, g);
        }
      }

      const float* z2s = s_z2 + buf * J * BL;
#pragma unroll 2
      for (int j = 0; j < J; ++j) {
        const float a = s_z1[j * BR + row];
        float adz = 0.0f, adw = 0.0f;
#pragma unroll
        for (int k = 0; k < BQ / 4; ++k) {
          const float4 b =
              *reinterpret_cast<const float4*>(z2s + j * BL + 16 * k + 4 * g);
          bwd_pair<BASE>(a - b.x, gm[4 * k], adz, adw);
          bwd_pair<BASE>(a - b.y, gm[4 * k + 1], adz, adw);
          bwd_pair<BASE>(a - b.z, gm[4 * k + 2], adz, adw);
          bwd_pair<BASE>(a - b.w, gm[4 * k + 3], adz, adw);
        }
        // the row's 4 lanes: every lane gets the same total, in one order
        adz += __shfl_xor_sync(0xffffffffu, adz, 1);
        adw += __shfl_xor_sync(0xffffffffu, adw, 1);
        adz += __shfl_xor_sync(0xffffffffu, adz, 2);
        adw += __shfl_xor_sync(0xffffffffu, adw, 2);
        if (g == 0) {
          s_dz[row * JS + j] += adz;
          s_dw[row * JS + j] += adw;
        }
      }
      __syncthreads();  // buffer buf is free for tile lt + 2
    }

    __syncthreads();
    float* out = dzp + (size_t)s * n * J;
    for (int e = tid; e < BR * J; e += NT) {
      const int r = e / J, j = e - r * J;
      if (row0 + r < n) out[(size_t)(row0 + r) * J + j] = s_dz[r * JS + j];
    }
    for (int j = tid; j < J; j += NT) {
      float v = 0.0f;
      for (int r = 0; r < BR; ++r) v += s_dw[r * JS + j];
      dwp[(size_t)it * J + j] = v;
    }
  }
}

// dz[i, j] = w_j scale sum_s dzp[s, i, j], s = 0 .. S-1 in order
__global__ void bwd_dz_kernel(const float* __restrict__ dzp,
                              const float* __restrict__ w,
                              float* __restrict__ dz, size_t count, int J,
                              int S, float scale) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = dzp[e];
    for (int k = 1; k < S; ++k) v += dzp[(size_t)k * count + e];
    dz[e] = (scale * w[e % J]) * v;
  }
}

// dw[j] = sum_it dwp[it, j], one block per j: thread x adds items x,
// x + 256, .. in f64, then a fixed tree over the threads
__global__ void __launch_bounds__(NT)
bwd_dw_kernel(const float* __restrict__ dwp, float* __restrict__ dw,
              int items, int J) {
  __shared__ double s[NT];
  const int j = blockIdx.x, tid = threadIdx.x;
  double v = 0.0;
  for (int it = tid; it < items; it += NT) v += (double)dwp[(size_t)it * J + j];
  s[tid] = v;
  for (int h = NT / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (tid < h) s[tid] += s[tid + h];
  }
  if (tid == 0) dw[j] = (float)s[0];
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

// K5 for width t and J components: its function, its dynamic shared
// memory and its column pass TC
struct BwdKernel {
  const void* fn;
  size_t bytes;
  int tc;
};

template <int BASE, int TC>
BwdKernel bwd(int J) {
  return {(const void*)gram_mvm_bwd_kernel<BASE, TC>,
          sizeof(float) * (2 * TC * BL + 2 * J * BL + J * BR + 2 * BR * (J | 1)),
          TC};
}

template <int BASE>
BwdKernel bwd_kernel_of(int J, int t) {
  switch (t == 1 ? 1 : t <= 16 ? (t + 3) / 4 * 4 : 16) {
    case 1: return bwd<BASE, 1>(J);
    case 4: return bwd<BASE, 4>(J);
    case 8: return bwd<BASE, 8>(J);
    case 12: return bwd<BASE, 12>(J);
    default: return bwd<BASE, 16>(J);
  }
}

// the kernel for (base, J, t), its shared-memory limit raised where it
// needs more than 48 KB; fn = nullptr for an unknown base
BwdKernel bwd_kernel(int base, int J, int t) {
  BwdKernel k{nullptr, 0, 0};
  switch (base) {
    case RBF: k = bwd_kernel_of<RBF>(J, t); break;
    case MATERN12: k = bwd_kernel_of<MATERN12>(J, t); break;
    case MATERN32: k = bwd_kernel_of<MATERN32>(J, t); break;
    case MATERN52: k = bwd_kernel_of<MATERN52>(J, t); break;
  }
  if (k.fn != nullptr && k.bytes > 48 * 1024)
    cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)k.bytes);
  return k;
}

// the blocks of kernel fn the current device holds at once
int resident_blocks(const void* fn, size_t bytes, int* G) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NT, bytes);
  if (e != cudaSuccess) return (int)e;
  *G = per_sm * sms;
  return *G >= 1 ? 0 : (int)cudaErrorInvalidConfiguration;
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
  *slabs = k.slabs;
  return resident_blocks(k.fn, k.bytes, G);
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

// K5's persistent grid on the current device for (J, t, base): G, the
// blocks of the chosen kernel the card holds at once. Returns a
// cudaError_t.
extern "C" int rpagp_gram_mvm_bwd_grid(int J, int t, int base, int* G) {
  if (J < 1 || J > J_MAX || t < 1) return (int)cudaErrorInvalidValue;
  const BwdKernel k = bwd_kernel(base, J, t);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  return resident_blocks(k.fn, k.bytes, G);
}

// z1 (n, J), z2 (m, J), w (J,), V (m, t), G (n, t) contiguous f32 -> dz
// (n, J), dw (J,); base 0..3 = rbf, matern12, matern32, matern52;
// 1 <= J <= 64 (the wrapper launches once per group of 64 components).
// scratch: f32 of J (np + mp) + tp mp + S n J + RT S J floats, RT =
// ceil(n / 64), np = 64 RT, mp = m rounded up to 128, tp = t rounded up to
// the kernel's pass (1 for t = 1, else 4 up to 16, then 16): the
// coordinates, V^T, the chunks' dz sums and the items' dw sums. S >= 1 z2
// chunks, at most ceil(m / 128); Gb: the persistent grid, at most
// rpagp_gram_mvm_bwd_grid's. Returns cudaGetLastError().
extern "C" int rpagp_gram_mvm_bwd(const float* z1, const float* z2,
                                  const float* w, const float* V,
                                  const float* G, float* dz, float* dw,
                                  float* scratch, int n, int m, int J, int t,
                                  int base, int S, int Gb, void* stream) {
  if (J < 1 || J > J_MAX || n < 1 || m < 1 || t < 1 || S < 1 ||
      S > (m + BL - 1) / BL || Gb < 1)
    return (int)cudaErrorInvalidValue;
  const BwdKernel k = bwd_kernel(base, J, t);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float c = base == RBF        ? coord_scale<RBF>()
                  : base == MATERN12 ? coord_scale<MATERN12>()
                  : base == MATERN32 ? coord_scale<MATERN32>()
                                     : coord_scale<MATERN52>();
  const float scale = base == RBF        ? dz_scale<RBF>()
                      : base == MATERN12 ? dz_scale<MATERN12>()
                      : base == MATERN32 ? dz_scale<MATERN32>()
                                         : dz_scale<MATERN52>();
  const int RT = (n + BR - 1) / BR, np = RT * BR;
  const int mp = (m + BL - 1) / BL * BL;
  const int tp = (t + k.tc - 1) / k.tc * k.tc;
  float* z1t = scratch;
  float* z2t = z1t + (size_t)J * np;
  float* vt = z2t + (size_t)J * mp;
  float* dzp = vt + (size_t)tp * mp;
  float* dwp = dzp + (size_t)S * n * J;
  coords_t_kernel<<<(np + 255) / 256, 256, 0, s>>>(z1, z1t, n, np, J, c);
  coords_t_kernel<<<(mp + 255) / 256, 256, 0, s>>>(z2, z2t, m, mp, J, c);
  vt_kernel<<<(mp + 255) / 256, 256, 0, s>>>(V, vt, m, mp, t, tp);
  const int items = RT * S;
  const int grid = items < Gb ? items : Gb;
  const float* z1c = z1t;
  const float* z2c = z2t;
  const float* vtc = vt;
  void* args[] = {(void*)&z1c, (void*)&z2c, (void*)&vtc, (void*)&G,
                  (void*)&dzp, (void*)&dwp, (void*)&n,   (void*)&m,
                  (void*)&J,   (void*)&t,   (void*)&S};
  cudaError_t e = cudaLaunchKernel(k.fn, dim3(grid), dim3(NT), args, k.bytes, s);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)e;
  }
  const size_t count = (size_t)n * J;
  const size_t blocks = (count + 255) / 256;
  bwd_dz_kernel<<<blocks < 4096 ? (int)blocks : 4096, 256, 0, s>>>(
      dzp, w, dz, count, J, S, scale);
  bwd_dw_kernel<<<J, NT, 0, s>>>(dwp, dw, items, J);
  return (int)cudaGetLastError();
}
