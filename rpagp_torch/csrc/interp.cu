// K2 / K3: SKI cubic-convolution interpolation, both directions.
//
// K2 `interp_transpose`:  U[j] = W_j^T V      tfrac (J, n), V (n, t) -> (J, t, m)
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
// arithmetic is tiny. K3 is a gather: one block of 512 threads an SM, each
// block a contiguous range of points, a thread 4 consecutive points (one
// 16-byte load of tfrac a component, the next 4 components' loads in
// flight while these are added). The taps come from a table of G staged
// in shared memory once a block and sweep (cp.async). At t = 1 it is the
// TPU kernel's shifted G (`_shift_last`): entry c + 3 of a component holds
// G[c - 1 .. c + 2], zero off the grid, so a point's four taps are one
// 16-byte shared load and a point's tfrac, clamped to [-3, m + 1], needs
// no bounds test (off the grid, padding included, it lands on an entry of
// zeros); the loads of the next 4 components go out while these are
// added, and out is written as one 16-byte store a thread. At t >= 2 the
// table is G's cells as rows of 4 or 8 columns (passes of 8 columns), and
// 4 or 8 lanes take a point: each reads one 16-byte piece of the point's
// 4 contiguous rows, so at 8 columns a quarter-warp reads 128 contiguous
// bytes, free of bank conflicts (at 4, two 64-byte blocks that may share
// banks). A lane a point on that table reads 8 random rows a
// quarter-warp, and its bank conflicts made t = 8 no faster than the
// kernel before. Each lane computes its own tap's weight; the 4 taps'
// sums meet in two
// butterfly steps at the end of a tile. Components past the table's 220 KB
// run in further sweeps that add to out. No atomics: every sum has a
// fixed order (at t = 1 one FMA a tap, over the components and then the
// taps in order), so repeats are bit for bit the same.
// K2 is a scatter: each (point, component, column) adds 4 taps into the
// m cells. Its bytes are K3's (0.064 ms at the flagship's t = 9), its
// FMAs 2.7 GFLOP at t = 9 (0.04 ms), so on the H100 it is bound by how
// the taps reach the cells, not by HBM. Three routes, by shape; each
// block or warp writes its chunk's (t, m) partial and a last kernel adds
// the chunks' partials in chunk order: no atomics, the same bits on every
// run.
//
// Runs (`runs_route`: 3 <= t <= runs_width(m), all t columns a block,
// where the blocks, one a (component, tile of points), fill the card).
// Adding each (point, column)'s 4 taps into shared memory costs four
// read-modify-writes (the slots route below: 1.37 ms at the flagship's
// t = 9). This route sorts instead: a block of RUNS_NT threads takes one
// component and a chunk of points, in tiles of RUNS_T = 1024 points, and
// for each tile
//  1. stages its V rows at an odd row stride, so random rows spread over
//     the banks: one bulk copy by the copy engine, completing on an
//     mbarrier, where the rows are one 16-byte aligned block (t odd),
//     else cp.async of 4 bytes; the copy runs under the sort, the next
//     tile's tfrac is in flight in registers meanwhile, and the second
//     block an SM (two fit at m = 256, t = 9) covers the rest;
//  2. counting-sorts the tile by base cell (tfrac clamped to [-3, m + 1],
//     NaN to -3; m + 5 bins): warp w holds points w T/4 .. (w + 1) T/4 -
//     1, in rounds of 32 it counts them per bin with __match_any_sync
//     (the round's first lane of a bin adds the bin's lanes, the others
//     take their rank from the lanes below them), so counts and ranks
//     need no atomics; an exclusive scan over (bin, warp) gives each
//     point its slot, in point order within a bin (a stable sort), and
//     the scatter writes (local row, clamped tfrac) there, at index
//     e + e / 32 (so the 32 lanes of the walk, each on its own 8 entries,
//     sit on distinct banks);
//  3. walks the sorted tile, thread l on entries lo + l L / NT .. (the L
//     entries of bins 1 .. m + 3: a split by points, not by cells, since
//     the densest cell holds 3-4x the mean), summing each piece (a run of
//     one base cell inside its entries) in registers, w_k(frac) V[row,
//     col] for the 4 taps and t columns, in the sorted (point) order, on
//     top of the block's per-(base cell, tap, column) sum S[cell], which
//     no other piece of the tile touches, and storing it back once;
//  4. a run split between threads: its later pieces start from zero and
//     are left in HB, and after a barrier the thread holding its start
//     adds them in thread order (a table of each thread's first bin says
//     whose they are) before storing it into S.
// At the chunk's end the 4 taps' sums of each cell are added in tap order
// into the partial. Each sum has a fixed order (point order inside a run,
// tile order in S, chunk order in U), so a repeat gives the same bits.
// Bins 0 (base cell -3) and m + 4 (base cell m + 1) hold the points whose
// 4 taps all lie off the grid (the -100 padding, NaN, a ragged tile's
// empty slots): they are sorted but not walked, and a tap of a walked
// point that lands off the grid goes into a sum the fold never reads, so
// they add exactly zero. What bounds it (H100, t = 9, flagship tfrac,
// 0.78 ms a call): shared-memory instructions. About half of the time is
// the sort (ranks, scan, scatter, 5 barriers a tile); in the walk a
// piece's store and the next piece's load (2 C 16-byte accesses) are
// issued by the whole warp whenever any of its lanes ends a piece, which
// happens in nearly every step of runs 8 entries long, so the writes cost
// about as much as the gathers and FMAs of the walk; a (point, column)
// costs about one shared load and a share of those writes, where the
// slots route paid four read-modify-writes. V is read by the J blocks of
// a chunk side by side (block j + J chunk), so from HBM about once. Where
// the blocks would not fill the card (sml's 3,723 points) or t is wider
// than a block (the posteriors' t = 512-513), the slots route is faster
// and takes the call.
//
// Slots (t >= 3 that the runs route does not take: tiles of 32 columns
// and one of the rest) and own (t <= 2: one column a tile, so that each
// column of grid prepare's U^T [y, 1] adds in a one-column call's order,
// the same bits; also a rest of one column). A warp takes a chunk of
// points of one component and a tile of C <= 32 of the t columns. Its
// lanes are P = floor(32 / C) point slots of C column lanes, lane p C + k
// (lanes past P C idle): lane (p, k) adds the taps of slot p's points for
// column k0 + k into its own copy of the m cells in shared memory, so no
// two lanes ever add to one word. The copy of lane l holds cell c at word
// (c + 4) 32 + l, so the 32 lanes of any access sit on 32 different banks,
// and a warp holds 32 (m + 8) floats at any C. At P < 32 a batch of 32
// points runs in ceil(32 / P) rounds: lane l computes point l's base cell
// and weights once and stages them in shared memory, and in round r slot p
// takes point r P + p, reading V[i, k0 + k] in V's own (n, t) row-major
// layout. At P = 32 lane l takes points l, l + 32, .. itself. tfrac is
// clamped as above, and every tap off the grid lands in the padding cells
// -4 .. -1 or m .. m + 3, which no sum reads. At the end lane l adds the P
// copies of each of its (column, cell) outputs, starting at copy c mod P,
// into the chunk's partial. A (point, column) costs four shared
// read-modify-writes, so these routes are bound by the shared-memory pipe
// (scripts/torch_ab_k2k5.py --smem measures it). Blocks hold two
// independent warps.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int M_MAX = 1024;  // grid cells
constexpr int NT = 256;      // threads per block of K2's reduction
constexpr int K2_TILE = 32;  // K2: columns a warp carries at most
constexpr int K2_PAD = 4;    // K2: padding cells at each end of a copy
constexpr int K2_OWN_NB = 16;  // K2, one-column tiles: batches in flight
// K2: warps a block at most, each its own (component, tile, chunk) and
// copies (fewer where their shared memory does not fit)
constexpr int K2_WARPS = 2;
constexpr size_t K2_SMEM = 227 * 1024;  // shared memory a block may hold

// 4-byte asynchronous copy global -> shared; with in = false it reads
// nothing and writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// an mbarrier in shared memory: init (one arrival a phase), arrive with
// the bytes a bulk copy will bring, wait for the phase of parity `parity`
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from global to shared by the copy engine,
// both 16-byte aligned, completing on bar; the fence orders the block's
// earlier reads of dst before the engine's writes
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float inner_w(float s) {
  return ((1.5f * s - 2.5f) * s) * s + 1.0f;
}
__device__ __forceinline__ float outer_w(float s) {
  return ((-0.5f * s + 2.5f) * s - 4.0f) * s + 2.0f;
}

// the 4 tap weights of tf clamped to [-3, hi = m + 1] (NaN to -3), and
// the word offset of its first tap, cell floor - 1, in a padded copy
__device__ __forceinline__ int taps(float tf, float hi, float4& w) {
  tf = fminf(fmaxf(tf, -3.0f), hi);
  const float fl = floorf(tf);
  const float f = tf - fl, g = 1.0f - f;
  w = make_float4(outer_w(1.0f + f), inner_w(f), inner_w(g),
                  outer_w(1.0f + g));
  return ((int)fl + 3) * 32;
}

// a point's 4 taps into the lane's copy a: four read-modify-writes at
// fixed offsets from one address, all four in flight at once
__device__ __forceinline__ void add_taps(float* a, int off, float4 w,
                                         float v) {
  float* q = a + off;
  const float a0 = q[0], a1 = q[32], a2 = q[64], a3 = q[96];
  q[0] = fmaf(w.x, v, a0);
  q[32] = fmaf(w.y, v, a1);
  q[64] = fmaf(w.z, v, a2);
  q[96] = fmaf(w.w, v, a3);
}

// the warp's item b = W block + warp: chunk ch of the points [start,
// end), component j, tile q (columns k0 + q width .. + C - 1); ok is
// false past the last item. With one tile the chunk is the fastest index
// (b = ch + nchunk j), so that neighbouring warps stream neighbouring
// tfrac; with several, the component and then the tile (b = j + J (q +
// tiles ch)), so that the J tiles warps that read the same V rows run
// side by side and share them through L2
struct Tile {
  int j, kt, C, ch, start, end;
  bool ok;
};
__device__ __forceinline__ Tile k2_tile(int J, int n, int t, int chunk,
                                        int k0, int tiles, int width) {
  const int nchunk = (n + chunk - 1) / chunk;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool one = tiles == 1;
  const int ch = one ? b % nchunk : b / J / tiles;
  const int j = one ? b / nchunk : b % J, q = one ? 0 : b / J % tiles;
  const int kt = k0 + q * width, start = ch * chunk;
  return {j, kt, min(width, t - kt), ch, start, min(n, start + chunk),
          one ? j < J : ch < nchunk};
}

// the warp's copies in the block's dynamic shared memory
__device__ __forceinline__ float* warp_copies(float* smem, int m) {
  return smem + (threadIdx.x >> 5) * (m + 2 * K2_PAD) * 32;
}

// zeros the 32 lanes' copies, 32 (m + 2 K2_PAD) floats
__device__ __forceinline__ void zero_copies(float* acc, int m) {
  float4* a4 = reinterpret_cast<float4*>(acc);
  for (int e = threadIdx.x & 31; e < (m + 2 * K2_PAD) * 8; e += 32)
    a4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// lane l sums outputs o = l, l + 32, .. of the tile's C m into out (the
// tile's (C, m) rows of the chunk's partial): column k = o mod C, cell
// c = o / C, over its copies c mod P, .., P - 1, 0, .. in turn
__device__ __forceinline__ void fold_copies(const float* acc, float* out,
                                            int C, int P, int m) {
  for (int o = threadIdx.x & 31; o < C * m; o += 32) {
    const int c = o / C, k = o - c * C;
    const float* row = acc + (c + K2_PAD) * 32 + k;
    float s = 0.0f;
    for (int u = 0, p = c % P; u < P; ++u, p = p + 1 == P ? 0 : p + 1)
      s += row[p * C];
    out[(size_t)k * m + c] = s;
  }
}

// one-column tiles (P = 32), a warp an item: lane l takes the chunk's
// points l, l + 32, .. in order, the next K2_OWN_NB batches' loads in
// flight while these are added. Dynamic shared memory: the copies.
__global__ void __launch_bounds__(32 * K2_WARPS)
transpose_own_kernel(const float* __restrict__ tfrac,
                     const float* __restrict__ V,
                     float* __restrict__ partial, int J, int n, int t,
                     int m, int chunk, int k0, int tiles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NB = K2_OWN_NB;
  const Tile T = k2_tile(J, n, t, chunk, k0, tiles, 1);
  if (!T.ok) return;
  const int lane = threadIdx.x & 31;
  float* const acc = warp_copies(smem, m);
  zero_copies(acc, m);
  __syncwarp();
  const float* tf = tfrac + (size_t)T.j * n;
  const float* Vk = V + T.kt;
  const float hi = (float)(m + 1);
  float* a = acc + lane;
  float tv[NB], vv[NB], tn[NB], vn[NB];
  auto load = [&](float* tq, float* vq, int b0) {
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int i = b0 + 32 * u + lane;
      const bool in = i < T.end;
      tq[u] = in ? __ldg(tf + i) : -100.0f;
      vq[u] = in ? __ldg(Vk + (size_t)i * t) : 0.0f;
    }
  };
  load(tv, vv, T.start);
  for (int b0 = T.start; b0 < T.end; b0 += 32 * NB) {
    load(tn, vn, b0 + 32 * NB);
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      float4 w;
      const int off = taps(tv[u], hi, w);
      add_taps(a, off, w, vv[u]);
    }
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      tv[u] = tn[u];
      vv[u] = vn[u];
    }
  }
  __syncwarp();
  fold_copies(acc, partial + (((size_t)T.ch * J + T.j) * t + T.kt) * m, 1,
              32, m);
}

// tiles of C = width >= 2 columns, P = 32 / C slots of C column lanes,
// R = ceil(32 / P) rounds a batch of 32 points. Lane (p, k) = p C + k; a
// lane past P C takes slot P - 1 with V = 0 and adds into its own copy,
// which no sum reads. Lane l computes point l's weights and offset once
// and stages them at entry (l mod P) R + l / P (offsets at (l mod P) R4 +
// l / P, so that one 16-byte read gives 4 rounds'); in round r slot p
// reads entry p R + r, point r P + p, the weights and offsets of 4 rounds
// ahead of their read-modify-writes. The entries of rounds past the
// batch's 32 points are never written: they keep the zeros the kernel
// starts with, and V = 0 there, so they add nothing. The next batch's
// tfrac and V go out before this batch's rounds. The stage is static
// shared memory, apart from the copies (the dynamic shared memory).
template <int P>
__global__ void __launch_bounds__(32 * K2_WARPS)
transpose_slots_kernel(const float* __restrict__ tfrac,
                       const float* __restrict__ V,
                       float* __restrict__ partial, int J, int n, int t,
                       int m, int chunk, int k0, int tiles, int width) {
  constexpr int R = (32 + P - 1) / P, R4 = (R + 3) / 4 * 4;
  __shared__ float4 sws[K2_WARPS][P * R];
  __shared__ __align__(16) int sos[K2_WARPS][P * R4];
  extern __shared__ __align__(16) float smem[];
  const Tile T = k2_tile(J, n, t, chunk, k0, tiles, width);
  if (!T.ok) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C = T.C;
  float4* const sw = sws[warp];
  int* const so = sos[warp];
  float* const acc = warp_copies(smem, m);
  zero_copies(acc, m);
  for (int e = lane; e < P * R; e += 32)
    sw[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int e = lane; e < P * R4; e += 32) so[e] = 0;
  __syncwarp();
  const bool live = lane < P * C;
  const int p = live ? lane / C : P - 1;
  const int k = live ? lane - p * C : 0;
  const float* tf = tfrac + (size_t)T.j * n;
  const float* Vk = V + T.kt + k;
  const float hi = (float)(m + 1);
  float* a = acc + lane;
  const float4* wp = sw + p * R;
  const int4* op = reinterpret_cast<const int4*>(so + p * R4);
  float tv, vv[R], tn, vn[R];
  auto load = [&](float& tq, float* vq, int b0) {
    tq = b0 + lane < T.end ? __ldg(tf + b0 + lane) : -100.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = b0 + r * P + p;
      vq[r] = live && r * P + p < 32 && i < T.end ? __ldg(Vk + (size_t)i * t)
                                                  : 0.0f;
    }
  };
  load(tv, vv, T.start);
  for (int b0 = T.start; b0 < T.end; b0 += 32) {
    load(tn, vn, b0 + 32);
    float4 w;
    const int off = taps(tv, hi, w);
    __syncwarp();  // the last batch's rounds have read the stage
    sw[lane % P * R + lane / P] = w;
    so[lane % P * R4 + lane / P] = off;
    __syncwarp();
#pragma unroll
    for (int r4 = 0; r4 < R; r4 += 4) {
      const int4 o = op[r4 / 4];
      const int offs[4] = {o.x, o.y, o.z, o.w};
      float4 ws[4];
#pragma unroll
      for (int r = r4; r < r4 + 4 && r < R; ++r) ws[r - r4] = wp[r];
#pragma unroll
      for (int r = r4; r < r4 + 4 && r < R; ++r)
        add_taps(a, offs[r - r4], ws[r - r4], vv[r]);
    }
    tv = tn;
#pragma unroll
    for (int r = 0; r < R; ++r) vv[r] = vn[r];
  }
  __syncwarp();
  fold_copies(acc, partial + (((size_t)T.ch * J + T.j) * t + T.kt) * m, C,
              P, m);
}

// ------------------------------------------------------------- K2 runs --
// (the note at the top of this file)

constexpr int RUNS_NT = 128;                 // threads a block
constexpr int RUNS_NW = RUNS_NT / 32;        // warps a block
constexpr int RUNS_T = 1024;                 // points a tile
constexpr int RUNS_R = RUNS_T / RUNS_NT;     // points a thread ranks
constexpr int RUNS_E = RUNS_T + RUNS_T / 32;  // sorted entries, skewed
constexpr int RUNS_C_MAX = 16;               // columns a tile at most
constexpr int RUNS_MIN_BLOCKS = 2 * 132;     // two blocks an SM of the H100

// dynamic shared memory of a block: S (m + 5 bins of 4 C floats), HB (a
// piece of 4 C floats a thread, at an odd count of 16-byte words), the V
// tile (RUNS_T rows of C | 1 floats), the sorted tfrac, the per-warp
// counts (m + 5 ints a warp) and the sorted rows (16-bit)
size_t runs_smem(int m, int C) {
  const size_t nb = m + 5, odd = C | 1;
  return 4 * (nb * 4 * C + (size_t)RUNS_NT * odd * 4 + (size_t)RUNS_T * odd +
              RUNS_E + RUNS_NW * nb) +
         2 * (size_t)RUNS_E;
}

// the columns a runs block carries at m: the most, up to RUNS_C_MAX, whose
// block fits in K2_SMEM with 1 KB to spare for its static shared memory
// (16 at m = 256, 9 at m = 1024)
int runs_width(int m) {
  int C = RUNS_C_MAX;
  while (C > 3 && runs_smem(m, C) + 1024 > K2_SMEM) --C;
  return C;
}

// the runs route takes a call whose t >= 3 columns fit one block and
// whose blocks, one a (component, tile of points), fill the card
bool runs_route(int J, int n, int t, int m) {
  return t >= 3 && t <= runs_width(m) &&
         (long long)J * ((n + RUNS_T - 1) / RUNS_T) >= RUNS_MIN_BLOCKS;
}

// the index of sorted entry e: e + e / 32, so that 32 lanes each on its
// own run of 8 consecutive entries read 32 distinct banks
__device__ __forceinline__ int skew(int e) { return e + (e >> 5); }

// block b: component b mod J, chunk b / J of the points, all C = t
// columns; the J blocks of one chunk run side by side and share its V
// rows through L2. vec: C is odd and every tile's rows start 16-byte
// aligned, so that a tile of rows is one block of floats at the tile's
// row stride
template <int C>
__global__ void __launch_bounds__(RUNS_NT, 2)
transpose_slots_kernel_runs(const float* __restrict__ tfrac,
                            const float* __restrict__ V,
                            float* __restrict__ partial, int J, int n,
                            int m, int chunk, int vec) {
  constexpr int SC = C | 1, HQ = C | 1, W4 = 4 * C;
  extern __shared__ __align__(16) float smem[];
  __shared__ int wsum[RUNS_NW];
  __shared__ int span[2];
  __shared__ int fbin[RUNS_NT];  // each thread's first bin in the walk
  __shared__ unsigned long long vbar;  // the V tile's bulk copy
  const int NB = m + 5;
  float* const S = smem;
  float4* const HB = reinterpret_cast<float4*>(S + (size_t)NB * W4);
  float* const Vt = reinterpret_cast<float*>(HB + RUNS_NT * HQ);
  float* const stf = Vt + RUNS_T * SC;
  int* const hist = reinterpret_cast<int*>(stf + RUNS_E);
  unsigned short* const srow =
      reinterpret_cast<unsigned short*>(hist + RUNS_NW * NB);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int j = b % J, ch = b / J;
  const int start = ch * chunk, end = min(n, start + chunk);
  const float* tf = tfrac + (size_t)j * n;
  const float hi = (float)(m + 1);
  int* const hw = hist + warp * NB;
  const unsigned below = (1u << lane) - 1u;
  const int r0 = warp * (RUNS_T / RUNS_NW) + lane;  // local row of round 0

  for (int e = tid; e < NB * W4; e += RUNS_NT) S[e] = 0.0f;
  float tv[RUNS_R];
  auto load_tf = [&](int t0) {
#pragma unroll
    for (int r = 0; r < RUNS_R; ++r) {
      const int i = t0 + r0 + 32 * r;
      tv[r] = i < end ? __ldcs(tf + i) : -100.0f;
    }
  };
  auto bin_of = [&](int e) { return (int)floorf(stf[skew(e)]) + 3; };
  // a run's 4 C sums: S[bin] into acc, acc into S[bin] or into HB (the
  // piece of a run continued from the thread before, for its owner)
  auto load_s = [&](float* acc, int bin) {
    const float4* s4 = reinterpret_cast<const float4*>(S + (size_t)bin * W4);
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const float4 a = s4[u];
      acc[4 * u] = a.x;
      acc[4 * u + 1] = a.y;
      acc[4 * u + 2] = a.z;
      acc[4 * u + 3] = a.w;
    }
  };
  auto store = [&](float4* dst, const float* acc) {
#pragma unroll
    for (int u = 0; u < C; ++u)
      dst[u] = make_float4(acc[4 * u], acc[4 * u + 1], acc[4 * u + 2],
                           acc[4 * u + 3]);
  };
  auto store_s = [&](const float* acc, int bin) {
    store(reinterpret_cast<float4*>(S + (size_t)bin * W4), acc);
  };

  if (vec && tid == 0) mbar_init(&vbar);
  __syncthreads();
  unsigned tiles_done = 0;
  load_tf(start);
  for (int t0 = start; t0 < end; t0 += RUNS_T) {
    const int P = min(RUNS_T, end - t0);
    // 1. the tile's V rows at row stride SC
    if (vec) {  // one block of floats, by the copy engine
      const float* src = V + (size_t)t0 * C;
      const int total = P * C, n4 = total >> 2;
      if (tid == 0) {
        mbar_expect(&vbar, 16u * n4);
        if (n4) bulk_copy(Vt, src, 16u * n4, &vbar);
      }
      for (int e = 4 * n4 + tid; e < total; e += RUNS_NT)
        cp_async4(Vt + e, src + e, true);
    } else {
      for (int e = tid; e < P * C; e += RUNS_NT) {
        const int r = e / C, c = e - r * C;
        cp_async4(Vt + r * SC + c, V + (size_t)(t0 + r) * C + c, true);
      }
    }
    // 2. bins (slots past P in bin 0); the next tile's tfrac goes out
    int bin[RUNS_R], rank[RUNS_R];
    float tc[RUNS_R];
#pragma unroll
    for (int r = 0; r < RUNS_R; ++r) {
      tc[r] = r0 + 32 * r < P ? fminf(fmaxf(tv[r], -3.0f), hi) : -3.0f;
      bin[r] = (int)floorf(tc[r]) + 3;
    }
    load_tf(t0 + RUNS_T);
    // 3. this warp's counts and each point's rank among its warp's points
    // of the same bin, in point order
    for (int e = lane; e < NB; e += 32) hw[e] = 0;
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RUNS_R; ++r) {
      const unsigned same = __match_any_sync(0xffffffffu, bin[r]);
      const int before = hw[bin[r]];
      __syncwarp();
      if ((same & below) == 0) hw[bin[r]] = before + __popc(same);
      __syncwarp();
      rank[r] = before + __popc(same & below);
    }
    __syncthreads();
    // 4. counts -> first slots, in (bin, warp) order: thread tid takes bins
    // tid BPT .. + BPT - 1
    {
      const int bpt = (NB + RUNS_NT - 1) / RUNS_NT;
      const int b0 = min(NB, tid * bpt), b1 = min(NB, b0 + bpt);
      int tot = 0;
      for (int x = b0; x < b1; ++x)
#pragma unroll
        for (int w = 0; w < RUNS_NW; ++w) tot += hist[w * NB + x];
      int inc = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      if (lane == 31) wsum[warp] = inc;
      __syncthreads();
      int base = inc - tot;
      for (int w = 0; w < warp; ++w) base += wsum[w];
      for (int x = b0; x < b1; ++x) {
        if (x == 1) span[0] = base;
        if (x == NB - 1) span[1] = base;
#pragma unroll
        for (int w = 0; w < RUNS_NW; ++w) {
          const int c = hist[w * NB + x];
          hist[w * NB + x] = base;
          base += c;
        }
      }
    }
    __syncthreads();
    // 5. the stable scatter of (local row, clamped tfrac)
#pragma unroll
    for (int r = 0; r < RUNS_R; ++r) {
      const int x = skew(hw[bin[r]] + rank[r]);
      srow[x] = (unsigned short)(r0 + 32 * r);
      stf[x] = tc[r];
    }
    cp_async_wait_all();
    if (vec) mbar_wait(&vbar, tiles_done & 1);
    ++tiles_done;
    __syncthreads();
    // 6. the walk over bins 1 .. m + 3: thread tid on entries [s, e1)
    const int lo = span[0], hi_e = span[1], L = hi_e - lo;
    const int s = lo + tid * L / RUNS_NT, e1 = lo + (tid + 1) * L / RUNS_NT;
    float acc[W4];
    bool owner = false;
    int cur = s < e1 ? bin_of(s) : -1;  // -1: no entries
    fbin[tid] = cur;
    if (s < e1) {
      const bool cin = s > lo && bin_of(s - 1) == cur;
      const bool cout = e1 < hi_e && bin_of(e1) == bin_of(e1 - 1);
      // a piece this thread writes adds on top of S[cur]; the piece of a
      // run continued from the thread before starts from zero
      bool first = true;
      if (cin) {
#pragma unroll
        for (int u = 0; u < W4; ++u) acc[u] = 0.0f;
      } else {
        load_s(acc, cur);
      }
      for (int e = s; e < e1; ++e) {
        const int x = skew(e);
        const float tfe = stf[x];
        const float* vr = Vt + (int)srow[x] * SC;
        const float fl = floorf(tfe);
        const int be = (int)fl + 3;
        if (be != cur) {  // the piece of bin cur ended before e
          store(first && cin ? HB + tid * HQ
                             : reinterpret_cast<float4*>(S + (size_t)cur * W4),
                acc);
          first = false;
          cur = be;
          load_s(acc, cur);
        }
        const float f = tfe - fl, g = 1.0f - f;
        const float w0 = outer_w(1.0f + f), w1 = inner_w(f), w2 = inner_w(g),
                    w3 = outer_w(1.0f + g);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float v = vr[c];
          acc[c] = fmaf(w0, v, acc[c]);
          acc[C + c] = fmaf(w1, v, acc[C + c]);
          acc[2 * C + c] = fmaf(w2, v, acc[2 * C + c]);
          acc[3 * C + c] = fmaf(w3, v, acc[3 * C + c]);
        }
      }
      owner = !(first && cin) && cout;
      if (!owner)
        store(first && cin ? HB + tid * HQ
                           : reinterpret_cast<float4*>(S + (size_t)cur * W4),
              acc);
    }
    __syncthreads();
    // 7. a run split between threads: its first thread, holding S[bin] and
    // its own piece, adds the others' pieces in thread order and writes it
    if (owner) {
      for (int l = tid + 1; l < RUNS_NT; ++l) {
        const int bl = fbin[l];
        if (bl < 0) continue;  // no entries
        if (bl != cur) break;
        const float4* h4 = HB + l * HQ;
#pragma unroll
        for (int u = 0; u < C; ++u) {
          const float4 h = h4[u];
          acc[4 * u] += h.x;
          acc[4 * u + 1] += h.y;
          acc[4 * u + 2] += h.z;
          acc[4 * u + 3] += h.w;
        }
      }
      store_s(acc, cur);
    }
  }
  __syncthreads();
  // cell c = sum over taps k of S[bin c + 4 - k][k]
  float* out = partial + ((size_t)ch * J + j) * C * m;
  for (int o = tid; o < C * m; o += RUNS_NT) {
    const int c = o / C, k = o - c * C;
    const float* sb = S + (size_t)(c + 1) * W4 + k;
    out[(size_t)k * m + c] =
        ((sb[3 * W4] + sb[2 * W4 + C]) + sb[W4 + 2 * C]) + sb[3 * C];
  }
}

// raises a kernel's dynamic shared memory limit to `bytes` on the current
// device, once a device (a limit is set, not read, on every call)
template <auto kernel>
cudaError_t k2_smem(size_t bytes) {
  static size_t set[64] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && bytes <= set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 64) set[dev] = bytes;
  return e;
}

// `items` warps' work in blocks of W <= K2_WARPS warps, as many as fit,
// each with `per_warp` bytes of dynamic shared memory
template <auto kernel, typename... Args>
int k2_launch(int items, size_t per_warp, cudaStream_t s, Args... args) {
  int w = K2_WARPS;
  while (w > 1 && w * per_warp > K2_SMEM) w /= 2;
  const size_t bytes = w * per_warp;
  const cudaError_t e = k2_smem<kernel>(bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(items + w - 1) / w, 32 * w, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

// K2's scatter over `tiles` tiles of `width` columns from column k0, one
// warp a (component, tile, chunk)
int k2_tiles(const float* tfrac, const float* V, float* partial, int J,
             int n, int t, int m, int chunk, int nchunk, int k0, int tiles,
             int width, cudaStream_t s) {
  const int items = J * tiles * nchunk;
  const size_t copies = sizeof(float) * (size_t)(m + 2 * K2_PAD) * 32;
#define K2_SLOTS(P)                                                    \
  k2_launch<transpose_slots_kernel<P>>(items, copies, s, tfrac, V,    \
                                       partial, J, n, t, m, chunk, k0, \
                                       tiles, width)
  switch (K2_TILE / width) {
    case 32:
      return k2_launch<transpose_own_kernel>(items, copies, s, tfrac, V,
                                             partial, J, n, t, m, chunk, k0,
                                             tiles);
    case 16: return K2_SLOTS(16);
    case 10: return K2_SLOTS(10);
    case 8: return K2_SLOTS(8);
    case 6: return K2_SLOTS(6);
    case 5: return K2_SLOTS(5);
    case 4: return K2_SLOTS(4);
    case 3: return K2_SLOTS(3);
    case 2: return K2_SLOTS(2);
    default: return K2_SLOTS(1);
  }
#undef K2_SLOTS
}

// K2's runs route: one block a (component, chunk), all t = C columns
template <int C>
int runs_launch(const float* tfrac, const float* V, float* partial, int J,
                int n, int m, int chunk, int nchunk, cudaStream_t s) {
  const size_t bytes = runs_smem(m, C);
  const cudaError_t e = k2_smem<transpose_slots_kernel_runs<C>>(bytes);
  if (e != cudaSuccess) return (int)e;
  const int vec = (C & 1) && chunk % 4 == 0 &&
                  (reinterpret_cast<size_t>(V) & 15) == 0;
  transpose_slots_kernel_runs<C><<<J * nchunk, RUNS_NT, bytes, s>>>(
      tfrac, V, partial, J, n, m, chunk, vec);
  return (int)cudaGetLastError();
}

int k2_runs(const float* tfrac, const float* V, float* partial, int J,
            int n, int t, int m, int chunk, int nchunk, cudaStream_t s) {
#define K2_RUNS(C)                                                         \
  case C:                                                                  \
    return runs_launch<C>(tfrac, V, partial, J, n, m, chunk, nchunk, s)
  switch (t) {
    K2_RUNS(3); K2_RUNS(4); K2_RUNS(5); K2_RUNS(6); K2_RUNS(7); K2_RUNS(8);
    K2_RUNS(9); K2_RUNS(10); K2_RUNS(11); K2_RUNS(12); K2_RUNS(13);
    K2_RUNS(14); K2_RUNS(15); K2_RUNS(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K2_RUNS
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

// ---------------------------------------------------------------- K3 ----

constexpr int K3_NT = 512;  // threads a block
constexpr int K3_BLOCKS_PER_SM = 1;
constexpr int K3_JC = 4;  // t = 1: components whose tfrac loads go out together
constexpr int K3_JC_ROWS = 4;  // t >= 2: the same
constexpr int K3_TC = 8;  // columns a pass of the rows table
constexpr int K3_SMEM = 220 * 1024;  // table bytes a block may hold

__device__ __forceinline__ float lane_of(float4 v, int p) {
  return p == 0 ? v.x : p == 1 ? v.y : p == 2 ? v.z : v.w;
}

// tf clamped to [-3, m + 1] (hi = m + 1), so that a point off the grid
// (the -100 padding, NaN and infinities too) lands on a base cell whose
// taps are all zero in the tables
__device__ __forceinline__ float k3_clamp(float tf, float hi) {
  return fminf(fmaxf(tf, -3.0f), hi);
}
// e = fl + 3 for fl = floor of a clamped tf, in [0, m + 4]: the point's
// table entry (shifted) or first row (rows); the low bits of
// 2^23 + fl + 3, which is exact
__device__ __forceinline__ int k3_entry(float fl) {
  return __float_as_int(fl + 8388611.0f) - 0x4B000000;
}

// shifted table of components j0 .. j0 + jn - 1 (t = 1): float4 entry
// jl (m + 5) + e holds G[c - 1], G[c], G[c + 1], G[c + 2] of base cell
// c = e - 3, zero off the grid
__device__ __forceinline__ void stage_shifted(float* tab,
                                              const float* __restrict__ G,
                                              int j0, int jn, int m) {
  const int E = m + 5;
  for (int x = threadIdx.x; x < jn * E; x += K3_NT) {
    const int jl = x / E;
    const int c = x - jl * E - 3;
    const float* g = G + (size_t)(j0 + jl) * m;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int cc = c - 1 + d;
      const bool in = (unsigned)cc < (unsigned)m;
      cp_async4(tab + 4 * x + d, in ? g + cc : G, in);
    }
  }
}

// rows table of columns k0 .. k0 + tc - 1 of components j0 .. j0 + jn - 1:
// cell c (-4 <= c < m + 4) at row jl (m + 8) + c + 4 of tp floats (4 or 8),
// zero off the grid and past tc; a warp copies one (component, column)
// row of G at a time, its lanes along the cells
__device__ __forceinline__ void stage_rows(float* tab,
                                           const float* __restrict__ G,
                                           int j0, int jn, int t, int m,
                                           int k0, int tc, int tp) {
  const int R = m + 8, lane = threadIdx.x & 31;
  for (int row = threadIdx.x >> 5; row < jn * tp; row += K3_NT / 32) {
    const int jl = row / tp, k = row - jl * tp;
    const bool col = k < tc;
    const float* g = G + ((size_t)(j0 + jl) * t + k0 + (col ? k : 0)) * m;
    float* dst = tab + (size_t)jl * R * tp + k;
    for (int r = lane; r < R; r += 32) {
      const int c = r - 4;
      const bool in = col && (unsigned)c < (unsigned)m;
      cp_async4(dst + r * tp, in ? g + c : G, in);
    }
  }
}

// tfrac of quad q (points 4q .. 4q + 3) of one component row; -100 (a
// point that adds nothing) where in is false or past the row's end
template <bool VEC>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ row,
                                            int q, bool in, int n) {
  if constexpr (VEC) {
    // evict-first: each byte is read once (2-3% faster than __ldg here)
    return in ? __ldcs(reinterpret_cast<const float4*>(row) + q)
              : make_float4(-100.0f, -100.0f, -100.0f, -100.0f);
  } else {
    float v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = 4 * q + p;
      v[p] = in && i < n ? __ldg(row + i) : -100.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// t = 1. grid (blocks), K3_NT threads. Block b takes quads
// [b Q / nb, (b + 1) Q / nb) of the Q = ceil(n / 4), a thread the quad
// q_lo + K3_NT tile + tid of each tile, and per component one 16-byte load
// and, per point, one 16-byte table load: out[i] adds w_d tap_d over the
// components and taps in order. Components in sweeps of jg (the table's
// capacity), each after the first adding to out. VEC: rows of whole
// 16-byte quads (n % 4 == 0, tfrac 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(K3_NT, K3_BLOCKS_PER_SM)
apply_sum_shifted_kernel(const float* __restrict__ tfrac,
                         const float* __restrict__ G, float* __restrict__ out,
                         int J, int n, int m, int jg) {
  extern __shared__ __align__(16) float tab[];
  const int Q = (n + 3) / 4;
  const int q_lo = (int)((long long)blockIdx.x * Q / gridDim.x);
  const int q_hi = (int)((long long)(blockIdx.x + 1) * Q / gridDim.x);
  const int ntile = (q_hi - q_lo + K3_NT - 1) / K3_NT;
  const float hi = (float)(m + 1);
  const float4* tab4 = reinterpret_cast<const float4*>(tab);
  for (int j0 = 0; j0 < J; j0 += jg) {
    const int jn = min(jg, J - j0);
    const int nch = (jn + K3_JC - 1) / K3_JC;
    // quad q of the sweep's components ch K3_JC .. + K3_JC - 1
    auto load = [&](float4 v[K3_JC], int ch, int q) {
#pragma unroll
      for (int u = 0; u < K3_JC; ++u) {
        const int jl = ch * K3_JC + u;
        v[u] = load_quad<VEC>(tfrac + (size_t)(j0 + min(jl, jn - 1)) * n, q,
                              q < q_hi && jl < jn, n);
      }
    };
    float4 cur[K3_JC], nxt[K3_JC];
    load(cur, 0, q_lo + threadIdx.x);  // out before the table is staged
    __syncthreads();  // every read of the last sweep's table is done
    stage_shifted(tab, G, j0, jn, m);
    cp_async_wait_all();
    __syncthreads();
    float acc[4];
    for (int tile = 0, ch = 0;;) {
      int tile2 = tile, ch2 = ch + 1;
      if (ch2 == nch) {
        ch2 = 0;
        ++tile2;
      }
      if (tile2 < ntile) load(nxt, ch2, q_lo + tile2 * K3_NT + threadIdx.x);
      const int q = q_lo + tile * K3_NT + threadIdx.x;
      const bool in = q < q_hi;
      if (ch == 0) {
#pragma unroll
        for (int p = 0; p < 4; ++p) acc[p] = 0.0f;
        if (j0 > 0 && in) {  // a later sweep adds to the earlier ones
          if constexpr (VEC) {
            const float4 o = reinterpret_cast<const float4*>(out)[q];
#pragma unroll
            for (int p = 0; p < 4; ++p) acc[p] = lane_of(o, p);
          } else {
#pragma unroll
            for (int p = 0; p < 4; ++p)
              if (4 * q + p < n) acc[p] = out[4 * q + p];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < K3_JC; ++u) {
        const int jl = ch * K3_JC + u;
        if (jl >= jn) continue;
        const float4* tj = tab4 + jl * (m + 5);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float tf = k3_clamp(lane_of(cur[u], p), hi);
          const float fl = floorf(tf);
          const float f = tf - fl, g = 1.0f - f;
          const float4 v = tj[k3_entry(fl)];
          acc[p] = fmaf(outer_w(1.0f + f), v.x, acc[p]);
          acc[p] = fmaf(inner_w(f), v.y, acc[p]);
          acc[p] = fmaf(inner_w(g), v.z, acc[p]);
          acc[p] = fmaf(outer_w(1.0f + g), v.w, acc[p]);
        }
      }
      if (ch == nch - 1 && in) {
        if constexpr (VEC) {
          reinterpret_cast<float4*>(out)[q] =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p)
            if (4 * q + p < n) out[4 * q + p] = acc[p];
        }
      }
      if (tile2 >= ntile) break;
      tile = tile2;
      ch = ch2;
#pragma unroll
      for (int u = 0; u < K3_JC; ++u) cur[u] = nxt[u];
    }
  }
}

// t >= 2, one sweep of the rows table (tp = TP floats a row): TP lanes a
// point. Lane s of a point's group reads the float4 at 4 s of the point's
// rows e .. e + 3 (4 TP contiguous floats, so the 8 lanes of a
// quarter-warp read 128 contiguous bytes or two 64-byte blocks): tap
// d = 4 s / TP, columns 4 (s % (TP / 4)) .. + 3, and computes that tap's
// weight alone. A warp's 32 points per tile: lane l loads point l's tfrac;
// in round r group g takes point r 32 / TP + g (its tfrac by a shuffle).
// Each lane adds its tap over the components in order; at the tile's end
// the point's 4 taps are added by two butterfly steps, ((d0 + d1) +
// (d2 + d3)), and lane d = 0 writes its 4 columns.
template <int TP>
__device__ __forceinline__ void rows_sweep(const float* tab,
                                           const float* __restrict__ tfrac,
                                           float* __restrict__ out, int n,
                                           int t, int m, int j0, int jn,
                                           int k0, int tc, int p_lo,
                                           int p_hi, int ntile, float hi) {
  constexpr int GW = 32 / TP;  // points a warp takes at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / TP, s = lane % TP, d = 4 * s / TP, h = s % (TP / 4);
  // the lane's tap: taps()'s Horner polynomial in x = 1 + f, f, g or
  // 1 + g for d = 0 .. 3, from f by one FMA and one add whose constants
  // are the lane's (the same roundings as taps()'s)
  const bool outer = d == 0 || d == 3;
  const float cS = d < 2 ? 1.0f : -1.0f, cO = d < 2 ? 0.0f : 1.0f;
  const float cX = outer ? 1.0f : 0.0f;
  const float cA = outer ? -0.5f : 1.5f, cB = outer ? 2.5f : -2.5f;
  const float cC = outer ? -4.0f : 0.0f, cD = outer ? 2.0f : 1.0f;
  const int nch = (jn + K3_JC_ROWS - 1) / K3_JC_ROWS;
  const int R = m + 8;
  auto load = [&](float v[K3_JC_ROWS], int tile, int ch) {
    const int i = p_lo + tile * K3_NT + warp * 32 + lane;
#pragma unroll
    for (int u = 0; u < K3_JC_ROWS; ++u) {
      const int jl = ch * K3_JC_ROWS + u;
      v[u] = i < p_hi && jl < jn ? __ldg(tfrac + (size_t)(j0 + jl) * n + i)
                                 : -100.0f;
    }
  };
  // clamped once by the loading lane, not by each of the point's TP lanes
  float cur[K3_JC_ROWS], nxt[K3_JC_ROWS], acc[TP][4];
  load(cur, 0, 0);
#pragma unroll
  for (int u = 0; u < K3_JC_ROWS; ++u) cur[u] = k3_clamp(cur[u], hi);
  for (int tile = 0, ch = 0;;) {
    int tile2 = tile, ch2 = ch + 1;
    if (ch2 == nch) {
      ch2 = 0;
      ++tile2;
    }
    if (tile2 < ntile) load(nxt, tile2, ch2);
    if (ch == 0) {
#pragma unroll
      for (int r = 0; r < TP; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < K3_JC_ROWS; ++u) {
      const int jl = ch * K3_JC_ROWS + u;
      if (jl >= jn) continue;  // the same for the whole block
      const float* tj = tab + (size_t)jl * R * TP + 4 * s;
#pragma unroll
      for (int r = 0; r < TP; ++r) {
        const float tf = __shfl_sync(0xffffffffu, cur[u], r * GW + g);
        const float fl = floorf(tf);
        const int e = k3_entry(fl);
        const float x = fmaf(cS, tf - fl, cO) + cX;
        const float w = fmaf(fmaf(fmaf(cA, x, cB), x, cC), x, cD);
        const float4 v = *reinterpret_cast<const float4*>(tj + e * TP);
        acc[r][0] = fmaf(w, v.x, acc[r][0]);
        acc[r][1] = fmaf(w, v.y, acc[r][1]);
        acc[r][2] = fmaf(w, v.z, acc[r][2]);
        acc[r][3] = fmaf(w, v.w, acc[r][3]);
      }
    }
    if (ch == nch - 1) {
      const int base = p_lo + tile * K3_NT + warp * 32;
#pragma unroll
      for (int r = 0; r < TP; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int o = TP / 4; o < TP; o *= 2)
            acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], o);
        }
        const int i = base + r * GW + g;
        if (d == 0 && i < p_hi) {
          float* o = out + (size_t)i * t + k0 + 4 * h;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (4 * h + c < tc) o[c] = j0 > 0 ? o[c] + acc[r][c] : acc[r][c];
        }
      }
    }
    if (tile2 >= ntile) break;
    tile = tile2;
    ch = ch2;
#pragma unroll
    for (int u = 0; u < K3_JC_ROWS; ++u) cur[u] = k3_clamp(nxt[u], hi);
  }
}

// t >= 2. grid (blocks), K3_NT threads. Block b takes points
// [b n / nb, (b + 1) n / nb) in tiles of K3_NT; passes of K3_TC columns,
// each in sweeps of jg components (the table's capacity), each after the
// first adding to out.
__global__ void __launch_bounds__(K3_NT, K3_BLOCKS_PER_SM)
apply_sum_rows_kernel(const float* __restrict__ tfrac,
                      const float* __restrict__ G, float* __restrict__ out,
                      int J, int n, int t, int m, int jg) {
  extern __shared__ __align__(16) float tab[];
  const int p_lo = (int)((long long)blockIdx.x * n / gridDim.x);
  const int p_hi = (int)((long long)(blockIdx.x + 1) * n / gridDim.x);
  const int ntile = (p_hi - p_lo + K3_NT - 1) / K3_NT;
  const float hi = (float)(m + 1);
  for (int k0 = 0; k0 < t; k0 += K3_TC) {
    const int tc = min(K3_TC, t - k0), tp = tc > 4 ? 8 : 4;
    for (int j0 = 0; j0 < J; j0 += jg) {
      const int jn = min(jg, J - j0);
      __syncthreads();  // every read of the last sweep's table is done
      stage_rows(tab, G, j0, jn, t, m, k0, tc, tp);
      cp_async_wait_all();
      __syncthreads();
      if (tp == 8)
        rows_sweep<8>(tab, tfrac, out, n, t, m, j0, jn, k0, tc, p_lo, p_hi,
                      ntile, hi);
      else
        rows_sweep<4>(tab, tfrac, out, n, t, m, j0, jn, k0, tc, p_lo, p_hi,
                      ntile, hi);
    }
  }
}

// lets a kernel take more than 48 KB of dynamic shared memory
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// tfrac (J, n), V (n, t) row-major, partial (nchunk, J, t, m) scratch, U
// (J, t, m), all contiguous; any t, 1 <= m <= M_MAX, nchunk = ceil(n /
// chunk). One scatter launch for each width of column tile, then the
// chunks' sum. Tiles: one column each at t <= 2 (own); all t columns where
// `runs_route` takes the call (runs); else all t columns at t <= 32
// (slots), else 32 columns and the rest (a rest of one on own). Returns
// cudaGetLastError() or the error of a refused attribute.
extern "C" int rpagp_interp_transpose(const float* tfrac, const float* V,
                                      float* partial, float* U, int J, int n,
                                      int t, int m, int chunk, void* stream) {
  if (J < 1 || n < 1 || t < 1 || m < 1 || m > M_MAX || chunk < 1)
    return (int)cudaErrorInvalidValue;
  const long long nchunk = ((long long)n + chunk - 1) / chunk;
  const long long total = (long long)J * t * m;
  if ((long long)J * t * nchunk > INT_MAX || total > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = (int)nchunk;
  int err;
  if (t <= 2) {
    err = k2_tiles(tfrac, V, partial, J, n, t, m, chunk, nc, 0, t, 1, s);
  } else if (runs_route(J, n, t, m)) {
    err = k2_runs(tfrac, V, partial, J, n, t, m, chunk, nc, s);
  } else if (t <= K2_TILE) {
    err = k2_tiles(tfrac, V, partial, J, n, t, m, chunk, nc, 0, 1, t, s);
  } else {
    const int full = t / K2_TILE, rest = t - full * K2_TILE;
    err = k2_tiles(tfrac, V, partial, J, n, t, m, chunk, nc, 0, full,
                   K2_TILE, s);
    if (!err && rest)
      err = k2_tiles(tfrac, V, partial, J, n, t, m, chunk, nc,
                     full * K2_TILE, 1, rest, s);
  }
  if (err) return err;
  reduce_partials_kernel<<<(int)((total + NT - 1) / NT), NT, 0, s>>>(
      partial, U, nc, (int)total);
  return (int)cudaGetLastError();
}

// tfrac (J, n), G (J, t, m) and out (n, t) contiguous; any J and t,
// 1 <= m <= M_MAX. One launch. Returns cudaGetLastError() or the error of a
// refused attribute.
extern "C" int rpagp_interp_apply_sum(const float* tfrac, const float* G,
                                      float* out, int J, int n, int t, int m,
                                      void* stream) {
  if (J < 1 || n < 1 || t < 1 || m < 1 || m > M_MAX)
    return (int)cudaErrorInvalidValue;
  // a component's table: m + 5 float4 entries, or m + 8 rows of 4 or 8
  // floats (at most 33 KB at M_MAX, so jg >= 1)
  const size_t per = t == 1 ? sizeof(float) * 4 * (m + 5)
                            : sizeof(float) * (m + 8) * (t > 4 ? 8 : 4);
  const int jg = (int)(J < (int)(K3_SMEM / per) ? J : K3_SMEM / per);
  const size_t bytes = per * jg;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // tiles of K3_NT quads (t = 1) or points
  const int units = t == 1 ? (n + 3) / 4 : n;
  const int tiles = (units + K3_NT - 1) / K3_NT;
  const int blocks =
      tiles < K3_BLOCKS_PER_SM * sms ? tiles : K3_BLOCKS_PER_SM * sms;
  cudaStream_t s = (cudaStream_t)stream;
  if (t == 1) {
    const bool vec = n % 4 == 0 &&
                     (reinterpret_cast<size_t>(tfrac) & 15) == 0 &&
                     (reinterpret_cast<size_t>(out) & 15) == 0;
    const auto kernel = vec ? apply_sum_shifted_kernel<true>
                            : apply_sum_shifted_kernel<false>;
    e = allow_smem(kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, K3_NT, bytes, s>>>(tfrac, G, out, J, n, m, jg);
  } else {
    e = allow_smem(apply_sum_rows_kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    apply_sum_rows_kernel<<<blocks, K3_NT, bytes, s>>>(tfrac, G, out, J, n,
                                                       t, m, jg);
  }
  return (int)cudaGetLastError();
}
