// Neighbour map of a sparse conv: the pair search of kernel K1, run once
// per (input table, output sites, geometry) and shared by every conv that
// pairs the same way (ops/sparse.py `neighbor_map_cached`).
//
// Replaces the match half of the Pallas TPU kernel
// btcdet_tpu/ops/pallas_conv.py::_fused_call (its per-tile query keys from
// `qkeys_subm` / `qkeys_conv` and the in-kernel key compare). It writes
//     nbr[k, m] = the input row matched by tap k of output row m, or -1
// with the matching rules of sparse_keys.cuh (strided, submanifold and
// transpose-query modes; exact binary search over the whole sorted table,
// so nothing is dropped). It equals `where(found, idx, -1)` of
// ops/cuda_conv.py::conv_rulebook bit for bit.
//
// Design: one thread per (tap, output row), taps on blockIdx.y, so a warp
// searches 32 consecutive output rows of one tap: their keys ascend
// (subm: key + a constant shift), and the warp's binary searches walk
// the same upper levels of the table, which stay in L1 / L2.
//
// What bounds it on an H100: the dependent loads of the binary searches
// (about log2(N) L2 round trips a thread), not bytes: it reads the output
// coords and writes K*M int32.

#include <cuda_runtime.h>

#include "sparse_keys.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) sparse_nbr_kernel(
    const int* __restrict__ in_keys, int n_in, const int4* __restrict__ out_coords, int n_out,
    int* __restrict__ nbr, Geom g) {
  const int m = blockIdx.x * NT + threadIdx.x;
  const int k = blockIdx.y;
  if (m >= n_out) return;
  const int4 c = out_coords[m];
  nbr[(long long)k * n_out + m] = match_tap(g, c.x, c.y, c.z, c.w, k, in_keys, n_in);
}

}  // namespace

// in_keys (n_in,) int32 ascending; out_coords (n_out, 4) int32 (b, z, y, x),
// 16-byte aligned; nbr (K, n_out) int32. transpose selects the
// transpose-query mode. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int sparse_conv_nbr(const int* in_keys, int n_in, const int* out_coords, int n_out,
                               int* nbr, int kz, int ky, int kx, int sz, int sy, int sx, int pz,
                               int py, int px, int nz, int ny, int nx, int transpose,
                               void* stream) {
  const int K = kz * ky * kx;
  if (n_out == 0) return 0;
  if (K > KMAX || K <= 0) return (int)cudaErrorInvalidValue;
  const Geom g{kz, ky, kx, sz, sy, sx, pz, py, px, nz, ny, nx, transpose};
  const dim3 grid((n_out + NT - 1) / NT, K);
  sparse_nbr_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      in_keys, n_in, reinterpret_cast<const int4*>(out_coords), n_out, nbr, g);
  return (int)cudaGetLastError();
}
