// K1's shared 32x32 tile routines, for the one-block kernel (chol_linv.cu)
// and the grid-synchronised kernel (chol_linv_coop.cu): the tile
// products of both run through these, in the same order. Every routine is
// called by all NT threads of a block.

#pragma once

#include <cuda_runtime.h>

namespace k1 {

constexpr int NB = 32;   // panel width
constexpr int NT = 256;  // threads per block: 4 outputs of a 32x32 tile each

typedef float Tile[NB][NB + 1];

// s = src[row0:row0+32, col0:col0+32]. The coop kernel reads through L2
// only (kCG): other blocks rewrite the tiles between its grid barriers.
template <bool kCG = false>
__device__ __forceinline__ void load_tile(Tile s, const float* src, int ld,
                                          int row0, int col0) {
  for (int e = threadIdx.x; e < NB * NB; e += NT) {
    int r = e >> 5, c = e & 31;
    const float* p = src + (size_t)(row0 + r) * ld + col0 + c;
    s[r][c] = kCG ? __ldcg(p) : *p;
  }
}

// acc[u] (row r = tid/8, col c = tid%8 + 8u) += sum_q a[r][q] * b[c][q]
__device__ __forceinline__ void mm_nt(float acc[4], Tile a, Tile b) {
  int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    float x = a[r][q];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += x * b[c0 + 8 * u][q];
  }
}

// acc[u] += sum_q a[r][q] * b[q][c]
__device__ __forceinline__ void mm_nn(float acc[4], Tile a, Tile b) {
  int r = threadIdx.x >> 3, c0 = threadIdx.x & 7;
#pragma unroll 8
  for (int q = 0; q < NB; ++q) {
    float x = a[r][q];
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[u] += x * b[q][c0 + 8 * u];
  }
}

}  // namespace k1
