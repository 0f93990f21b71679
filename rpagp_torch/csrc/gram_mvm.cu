// K4 / K5: the fused projected additive Gram x V product, forward and
// backward, without storing the Gram. K6 / K7 (after K5): the dense
// projected Gram and its backward, without storing the (J, n, m)
// differences.
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

// w_j k1d of one pair at prescaled difference d added to acc: rbf
// w 2^(-d^2), matern12 w 2^-|d|, matern32 w (1 + s) 2^-|d|, matern52 w (1 +
// s + s^2 / 3) 2^-|d|, s = |d| ln 2; wl = w_j ln 2, w2 = w_j ln(2)^2 / 3
template <int BASE>
__device__ __forceinline__ float fwd_pair(float d, float wj, float wl,
                                          float w2, float acc) {
  if (BASE == RBF) return fmaf(wj, ex2(-d * d), acc);
  const float u = fabsf(d);
  if (BASE == MATERN12) return fmaf(wj, ex2(-u), acc);
  if (BASE == MATERN32) return fmaf(fmaf(u, wl, wj), ex2(-u), acc);
  return fmaf(fmaf(u, fmaf(u, w2, wl), wj), ex2(-u), acc);
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
    const float wj = ws[j], wl = wj * LN2, w2 = wj * (LN2 * LN2 / 3.0f);
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int q = 0; q < FQ; ++q)
        ks[i][q] = fwd_pair<BASE>(a[i] - bq[q], wj, wl, w2, ks[i][q]);
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

// the coordinates' scale and dz's factor of base 0..3 (rbf, matern12,
// matern32, matern52)
float coord_scale_of(int base) {
  return base == RBF        ? coord_scale<RBF>()
         : base == MATERN12 ? coord_scale<MATERN12>()
         : base == MATERN32 ? coord_scale<MATERN32>()
                            : coord_scale<MATERN52>();
}

float dz_scale_of(int base) {
  return base == RBF        ? dz_scale<RBF>()
         : base == MATERN12 ? dz_scale<MATERN12>()
         : base == MATERN32 ? dz_scale<MATERN32>()
                            : dz_scale<MATERN52>();
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
  const float c = coord_scale_of(base);
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
  const float c = coord_scale_of(base);
  const float scale = dz_scale_of(base);
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

// ------------------------------------------------------------ K6 / K7 ----
//
// K6 `dense_gram`:     K[i, k] = sum_j w_j k1d(u1[j, i] - u2[j, k])
//                      u1 (J, n), u2 (J, m), w (J,) -> K (n, m)
// K7 `dense_gram_bwd`: for the cotangent G (n, m) of K
//                      du1[j, i] =  w_j sum_k G[i, k] k1d'(u1[j, i] - u2[j, k])
//                      du2[j, k] = -w_j sum_i G[i, k] k1d'(u1[j, i] - u2[j, k])
//                      dw[j]     =  sum_{i, k} G[i, k] k1d(u1[j, i] - u2[j, k])
//                      (where u2 is u1, du = du1 + du2)
//
// They replace no TPU kernel: the JAX package's dense Gram
// (rpagp/ops/kernels.py `_projection_gram`) is plain jnp, which builds the
// (J, n, m) differences and values and keeps them for its backward. They
// were added for the exact GP's training step, whose Gram and its backward
// took ~24 ms of a ~36 ms step at n = 3,723, J = 20 as plain PyTorch passes
// over (20, n, n) tensors, 2.2 GB of them kept for the backward. Here no (J,
// n, m) tensor exists: each pass recomputes the values from the
// coordinates, in the layout the projection gives them, (J, n).
//
// What bounds them: J n m exponentials each way (277M at the exact cell's
// shape) on the exp unit, 16 a clock an SM, with 5-7 other f32
// instructions a pair; K and G are n m floats, written or read once. Both
// take k1d as one 2^x of prescaled coordinates as K4 and K5 do, the scale
// applied as a tile is staged into shared memory (no coordinate pass).
//
// K6: a block a 64 x 64 tile of K, its J x 64 row and column coordinates in
// shared memory, each thread K4's 4 x 4 block of the tile (gram_tile), K
// stored once.
//
// K7: a block of 4 warps a 64 x 64 tile of G; warp (wy, wx) its 32 x 32
// quarter, lane (ly, lx) = (lane / 4, lane % 4) rows wy 32 + 4 ly + i (i < 4)
// and columns wx 32 + 8 lx + q (q < 8), its 32 values of G in registers for
// all J components. Per component a pair costs a difference, one 2^x, the
// cotangent's product and adds into the thread's row sums (for du1 and dw)
// and column sums (for du2); the warp then reduce-scatters them by
// shuffles in a fixed order (row sums over the 4 lanes of lx, column sums
// over the 8 lanes of ly), each lane left with one row's and one column's
// totals, which it stores into the tile's slabs in shared memory. At the
// tile's end the block adds the two warps' slabs and writes the tile's row
// sums to slot ct of du1p (CT, J, n), its column sums to slot rt of du2p
// (RT, J, m) and its dw sums to dwp (RT CT, J). A second launch adds the
// slots in order (dw in f64). No float atomics: every call repeats bit for
// bit.

namespace {

constexpr int BJ_MAX = 32;    // K7: components per launch (its slabs)
constexpr int BT = 64;        // K7: rows and columns of a tile
constexpr int BNT = 128;      // K7: threads per block
constexpr int SP = BT + 1;    // K7: slab row stride, odd: columns of it on distinct banks

// s[j * BT + r] = c * u[j, r0 + r] for r < BT, 0 past `rows`: a tile's
// coordinates, prescaled; u is (J, rows)
__device__ __forceinline__ void stage_coords(float* s, const float* u,
                                             int r0, int rows, int J,
                                             float c, int nthreads) {
  for (int e = threadIdx.x; e < J * BT; e += nthreads) {
    const int j = e / BT, r = e - j * BT;
    s[e] = r0 + r < rows ? c * __ldg(u + (size_t)j * rows + r0 + r) : 0.0f;
  }
}

// K6: block t is tile (t / CT, t % CT) of 64 x 64, rows past n and
// columns past m computed on zero coordinates and not stored. Dynamic
// shared memory: (2 J FT + J) floats. acc: add to K instead of storing.
template <int BASE>
__global__ void __launch_bounds__(NT, 3)
dense_gram_kernel(const float* __restrict__ u1, const float* __restrict__ u2,
                  const float* __restrict__ w, float* __restrict__ K, int n,
                  int m, int J, int acc) {
  extern __shared__ __align__(16) float smem[];
  float* s_z1 = smem;           // (J, FT), scaled
  float* s_z2 = s_z1 + J * FT;  // (J, FT), scaled
  float* s_w = s_z2 + J * FT;   // (J,)
  const int CT = (m + FT - 1) / FT;
  const int rt = blockIdx.x / CT, ct = blockIdx.x - rt * CT;
  const int row0 = rt * FT, col0 = ct * FT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float c = coord_scale<BASE>();
  stage_coords(s_z1, u1, row0, n, J, c, NT);
  stage_coords(s_z2, u2, col0, m, J, c, NT);
  for (int j = tid; j < J; j += NT) s_w[j] = w[j];
  __syncthreads();
  float ks[FR][FQ];
  gram_tile<BASE>(ks, s_z1, s_z2, s_w, J, ty, tx);
#pragma unroll
  for (int i = 0; i < FR; ++i) {
    const int row = row0 + ty * FR + i;
    if (row >= n) continue;
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const int col = col0 + tx + 16 * q;
      if (col < m) {
        float* dst = K + (size_t)row * m + col;
        *dst = acc ? *dst + ks[i][q] : ks[i][q];
      }
    }
  }
}

// one pair of one component: the cotangent gm at prescaled difference d
// gives its (unscaled) k1d' term tdz and its k1d term tdw (bwd_pair's
// arithmetic)
template <int BASE>
__device__ __forceinline__ void bwd_terms(float d, float gm, float& tdz,
                                          float& tdw) {
  if (BASE == RBF) {
    const float ge = gm * ex2(-d * d);
    tdz = ge * d;
    tdw = ge;
  } else if (BASE == MATERN12) {
    const float ge = gm * ex2(-fabsf(d));
    tdw = ge;
    tdz = d > 0.0f ? ge : (d < 0.0f ? -ge : 0.0f);  // sign(0) = 0
  } else if (BASE == MATERN32) {
    const float u = fabsf(d);
    const float ge = gm * ex2(-u);
    tdw = ge * fmaf(u, LN2, 1.0f);
    tdz = ge * d;
  } else {
    const float u = fabsf(d);
    const float ge = gm * ex2(-u);
    tdw = ge * fmaf(u, fmaf(u, LN2SQ3, LN2), 1.0f);
    tdz = (ge * d) * fmaf(u, LN2, 1.0f);
  }
}

// one halving step of a reduce-scatter: of v[0 .. 2h) this lane keeps the
// upper half if `upper`, its partner (lane ^ mask) the other, each adding
// the partner's copy of the half it keeps: out[k] = keep[k] + partner's
template <int H>
__device__ __forceinline__ void halve(const float* v, float* out, bool upper,
                                      int mask) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = upper ? v[k] : v[k + H];
    const float keep = upper ? v[k + H] : v[k];
    out[k] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// K7: block t is tile (rt, ct) = (t / CT, t % CT) of G. Dynamic shared
// memory: (2 J BT + 6 J SP) floats. same: u2 is u1 (n == m).
template <int BASE>
__global__ void __launch_bounds__(BNT, 4)
dense_gram_bwd_kernel(const float* __restrict__ u1,
                      const float* __restrict__ u2,
                      const float* __restrict__ G, float* __restrict__ du1p,
                      float* __restrict__ du2p, float* __restrict__ dwp,
                      int n, int m, int J) {
  extern __shared__ __align__(16) float smem[];
  float* s_z1 = smem;               // (J, BT), scaled
  float* s_z2 = s_z1 + J * BT;      // (J, BT), scaled
  float* s_rdz = s_z2 + J * BT;     // 2 x (J, SP): row sums of k1d' by wx
  float* s_rdw = s_rdz + 2 * J * SP;  // 2 x (J, SP): row sums of k1d by wx
  float* s_cdz = s_rdw + 2 * J * SP;  // 2 x (J, SP): column sums by wy

  const int CT = (m + BT - 1) / BT;
  const int rt = blockIdx.x / CT, ct = blockIdx.x - rt * CT;
  const int row0 = rt * BT, col0 = ct * BT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wy = warp >> 1, wx = warp & 1, ly = lane >> 2, lx = lane & 3;
  const int r0 = wy * 32 + ly * 4;  // the thread's first row in the tile
  const int q0 = wx * 32 + lx * 8;  // its first column
  const float c = coord_scale<BASE>();
  stage_coords(s_z1, u1, row0, n, J, c, BNT);
  stage_coords(s_z2, u2, col0, m, J, c, BNT);

  float g[4][8];  // G at the thread's rows and columns, 0 past n and m
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + r0 + i;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int col = col0 + q0 + q;
      g[i][q] = row < n && col < m ? __ldg(G + (size_t)row * m + col) : 0.0f;
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int j = 0; j < J; ++j) {
    const float4 a4 = *reinterpret_cast<const float4*>(s_z1 + j * BT + r0);
    const float4 b0 = *reinterpret_cast<const float4*>(s_z2 + j * BT + q0);
    const float4 b1 =
        *reinterpret_cast<const float4*>(s_z2 + j * BT + q0 + 4);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float rs[8];  // (row i's k1d' sum, its k1d sum) at 2 i, 2 i + 1
    float cs[8];  // column q's k1d' sum
#pragma unroll
    for (int k = 0; k < 8; ++k) rs[k] = cs[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float tdz, tdw;
        bwd_terms<BASE>(a[i] - b[q], g[i][q], tdz, tdw);
        rs[2 * i] += tdz;
        rs[2 * i + 1] += tdw;
        cs[q] += tdz;
      }
    // columns over the 8 lanes of ly (lane bits 4, 3, 2 pick q's bits 2,
    // 1, 0): lane (ly, lx) is left with column q = ly
    float c4[4], c2[2], c1[1];
    halve<4>(cs, c4, lane & 16, 16);
    halve<2>(c4, c2, lane & 8, 8);
    halve<1>(c2, c1, lane & 4, 4);
    // rows over the 4 lanes of lx (lane bits 1, 0 pick i's bits 1, 0):
    // lane (ly, lx) is left with row i = lx, (k1d' sum, k1d sum)
    float r4[4], r2[2];
    halve<4>(rs, r4, lane & 2, 2);
    halve<2>(r4, r2, lane & 1, 1);
    s_cdz[(wy * J + j) * SP + q0 + ly] = c1[0];
    s_rdz[(wx * J + j) * SP + r0 + lx] = r2[0];
    s_rdw[(wx * J + j) * SP + r0 + lx] = r2[1];
  }
  __syncthreads();

  for (int e = tid; e < J * BT; e += BNT) {
    const int j = e / BT, r = e - j * BT;
    if (row0 + r < n)
      du1p[((size_t)ct * J + j) * n + row0 + r] =
          s_rdz[j * SP + r] + s_rdz[(J + j) * SP + r];
    if (col0 + r < m)
      du2p[((size_t)rt * J + j) * m + col0 + r] =
          s_cdz[j * SP + r] + s_cdz[(J + j) * SP + r];
  }
  for (int j = tid; j < J; j += BNT) {
    float v = 0.0f;
    for (int r = 0; r < BT; ++r) v += s_rdw[j * SP + r];
    for (int r = 0; r < BT; ++r) v += s_rdw[(J + j) * SP + r];
    dwp[(size_t)blockIdx.x * J + j] = v;
  }
}

// K7's second launch. Blocks [0, du_blocks): du1[j, i] = scale w_j (sum_ct
// du1p[ct, j, i] - (same ? sum_rt du2p[rt, j, i] : 0)), and where not same
// du2[j, k] = -scale w_j sum_rt du2p[rt, j, k], the slots in order. Block
// du_blocks + j: dw[j] = the sum of the tiles' dwp[t, j], thread x adding
// tiles x, x + NT, .. in f64, then a fixed tree over the threads.
__global__ void __launch_bounds__(NT)
dense_gram_bwd_sum_kernel(const float* __restrict__ du1p,
                          const float* __restrict__ du2p,
                          const float* __restrict__ dwp,
                          const float* __restrict__ w, float* __restrict__ du1,
                          float* __restrict__ du2, float* __restrict__ dw,
                          int n, int m, int J, int same, float scale,
                          int du_blocks) {
  if (blockIdx.x >= du_blocks) {
    __shared__ double s[NT];
    const int j = blockIdx.x - du_blocks, tid = threadIdx.x;
    const int tiles = ((n + BT - 1) / BT) * ((m + BT - 1) / BT);
    double v = 0.0;
    for (int t = tid; t < tiles; t += NT) v += (double)dwp[(size_t)t * J + j];
    s[tid] = v;
    for (int h = NT / 2; h > 0; h >>= 1) {
      __syncthreads();
      if (tid < h) s[tid] += s[tid + h];
    }
    if (tid == 0) dw[j] = (float)s[0];
    return;
  }
  const int RT = (n + BT - 1) / BT, CT = (m + BT - 1) / BT;
  const size_t rows = (size_t)J * n, total = same ? rows : rows + (size_t)J * m;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < total;
       e += (size_t)du_blocks * NT) {
    if (e < rows) {
      const int j = (int)(e / n), i = (int)(e - (size_t)j * n);
      float v = 0.0f;
      for (int ct = 0; ct < CT; ++ct) v += du1p[((size_t)ct * J + j) * n + i];
      if (same) {
        float u = 0.0f;
        for (int rt = 0; rt < RT; ++rt)
          u += du2p[((size_t)rt * J + j) * m + i];
        v -= u;
      }
      du1[e] = (scale * w[j]) * v;
    } else {
      const size_t e2 = e - rows;
      const int j = (int)(e2 / m), k = (int)(e2 - (size_t)j * m);
      float v = 0.0f;
      for (int rt = 0; rt < RT; ++rt) v += du2p[((size_t)rt * J + j) * m + k];
      du2[e2] = -(scale * w[j]) * v;
    }
  }
}

// the kernel of base `base` among a template's four instances
#define RPAGP_BY_BASE(kernel, base)                              \
  ((base) == RBF        ? (const void*)kernel<RBF>               \
   : (base) == MATERN12 ? (const void*)kernel<MATERN12>          \
   : (base) == MATERN32 ? (const void*)kernel<MATERN32>          \
   : (base) == MATERN52 ? (const void*)kernel<MATERN52>          \
                        : nullptr)

cudaError_t launch(const void* fn, int grid, int threads, void** args,
                   size_t bytes, cudaStream_t s) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, bytes, s);
  if (e != cudaSuccess) (void)cudaGetLastError();
  return e;
}

}  // namespace

// K6. u1 (J, n), u2 (J, m), w (J,) contiguous f32 -> K (n, m) contiguous
// f32; base 0..3 = rbf, matern12, matern32, matern52; 1 <= J <= 64 (the
// wrapper adds the launches of groups of 64 components, acc = 1 after the
// first). Returns cudaGetLastError().
extern "C" int rpagp_dense_gram(const float* u1, const float* u2,
                                const float* w, float* K, int n, int m, int J,
                                int base, int acc, void* stream) {
  if (J < 1 || J > J_MAX || n < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const void* fn = RPAGP_BY_BASE(dense_gram_kernel, base);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((n + FT - 1) / FT) * ((m + FT - 1) / FT);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (2 * J * FT + J);
  void* args[] = {(void*)&u1, (void*)&u2, (void*)&w, (void*)&K,
                  (void*)&n,  (void*)&m,  (void*)&J, (void*)&acc};
  cudaError_t e = launch(fn, (int)tiles, NT, args, bytes, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// K7. u1 (J, n), u2 (J, m), w (J,), G (n, m) contiguous f32 -> du1 (J, n),
// du2 (J, m) (unused where same), dw (J,); same: u2 is u1 and n == m, du1
// then takes du1 + du2. 1 <= J <= 32 (the wrapper launches once a group of
// 32 components). scratch: f32 of CT J n + RT J m + RT CT J floats, RT =
// ceil(n / 64), CT = ceil(m / 64): the tiles' row sums, column sums and dw
// sums. Returns cudaGetLastError().
extern "C" int rpagp_dense_gram_bwd(const float* u1, const float* u2,
                                    const float* w, const float* G,
                                    float* du1, float* du2, float* dw,
                                    float* scratch, int n, int m, int J,
                                    int base, int same, void* stream) {
  if (J < 1 || J > BJ_MAX || n < 1 || m < 1 || (same && n != m))
    return (int)cudaErrorInvalidValue;
  const void* fn = RPAGP_BY_BASE(dense_gram_bwd_kernel, base);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long RT = (n + BT - 1) / BT, CT = (m + BT - 1) / BT;
  if (RT * CT > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* du1p = scratch;
  float* du2p = du1p + (size_t)CT * J * n;
  float* dwp = du2p + (size_t)RT * J * m;
  const size_t bytes = sizeof(float) * (2 * J * BT + 6 * J * SP);
  void* args[] = {(void*)&u1,  (void*)&u2, (void*)&G, (void*)&du1p,
                  (void*)&du2p, (void*)&dwp, (void*)&n, (void*)&m,
                  (void*)&J};
  cudaError_t e = launch(fn, (int)(RT * CT), BNT, args, bytes, s);
  if (e != cudaSuccess) return (int)e;
  const size_t total = (size_t)J * n + (same ? 0 : (size_t)J * m);
  const size_t need = (total + NT - 1) / NT;
  const int du_blocks = need < 4096 ? (int)need : 4096;
  const float scale = dz_scale_of(base);
  dense_gram_bwd_sum_kernel<<<du_blocks + J, NT, 0, s>>>(
      du1p, du2p, dwp, w, du1, du2, dw, n, m, J, same, scale, du_blocks);
  return (int)cudaGetLastError();
}
