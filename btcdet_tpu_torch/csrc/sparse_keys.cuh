// Tap matching over key-sorted sparse voxel tables: the neighbour map of
// the sparse conv (sparse_nbr.cu) searches with it, and K1's gather-GEMM
// (sparse_conv.cu) takes its KMAX. K1 and K2 (sparse_pool.cu) and K3
// (sparse_conv_dw.cu) read the map and search nothing.
//
// An input table is sorted by the y-major linear key
// ((b*ny + y)*nz + z)*nx + x of its rows, with INT32_MAX on padding rows.
// Tap k = (dz, dy, dx) (row-major over the kernel, the weights' order) of
// output site (b, z, y, x) reads the input site
// (z, y, x)*stride - pad + (dz, dy, dx); the match is the table row holding
// that site's key, found by a binary search over the whole table, or -1
// when the site is off the input grid, the output row is padding (b < 0)
// or no row holds the key.
//
// Transpose-query mode (Geom::transpose = 1, the df of a strided conv, K1
// only): the table is the strided conv's OUTPUT table and the query sites
// are its input sites; tap k of input site s reads the output site
// (s + pad - (dz, dy, dx)) / stride, matched only where every component
// divides exactly and is >= 0 (the JAX package's
// `pallas_conv.qkeys_conv(transpose=True)`).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 27;  // most taps a kernel may have (3x3x3)

struct Geom {
  int kz, ky, kx;
  int sz, sy, sx;
  int pz, py, px;
  int nz, ny, nx;  // grid of the searched table
  int transpose;   // 1: transpose-query mode (see above)
};

// Table coordinate of query coordinate c along one axis, or -1.
__device__ __forceinline__ int tap_coord(const Geom& g, int c, int s, int p, int d) {
  if (!g.transpose) return c * s - p + d;
  const int num = c + p - d;
  return (num >= 0 && num % s == 0) ? num / s : -1;
}

// First row of keys[0, n) not below `key` (keys ascending).
__device__ __forceinline__ int key_lower_bound(const int* __restrict__ keys, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Input row matched by tap k of the output site (b, z, y, x), or -1.
__device__ __forceinline__ int match_tap(const Geom& g, int b, int z, int y, int x, int k,
                                         const int* __restrict__ in_keys, int n_in) {
  if (b < 0) return -1;
  const int dz = k / (g.ky * g.kx);
  const int dy = (k / g.kx) % g.ky;
  const int dx = k % g.kx;
  const int iz = tap_coord(g, z, g.sz, g.pz, dz);
  const int iy = tap_coord(g, y, g.sy, g.py, dy);
  const int ix = tap_coord(g, x, g.sx, g.px, dx);
  if (iz < 0 || iz >= g.nz || iy < 0 || iy >= g.ny || ix < 0 || ix >= g.nx) return -1;
  const int key = ((b * g.ny + iy) * g.nz + iz) * g.nx + ix;
  const int lo = key_lower_bound(in_keys, n_in, key);
  return (lo < n_in && in_keys[lo] == key) ? lo : -1;
}

}  // namespace
