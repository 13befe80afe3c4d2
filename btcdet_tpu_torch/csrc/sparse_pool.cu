// Sparse 3D max-pool forward over key-sorted voxel tables (kernel K2 of the
// port, max mode).
//
// Replaces the Pallas TPU kernel btcdet_tpu/ops/pallas_conv.py::_fused_call,
// mode "max" (kernel body _make_kernel), which runs SparseMaxPool3d on the
// occ-code side branch of the det backbone. It computes, for every output
// row m of a site table out_coords (b, z, y, x) (padding rows b < 0),
//     out[m, c] = max over the taps k that match an input row i of feats[i, c]
// and 0 where no tap matches (padding rows included). Matching is the shared
// binary search of sparse_keys.cuh over the whole sorted input table.
//
// Unlike the TPU kernel there are no fixed match windows (which drop matches
// outside them) and no rounding of the table to bf16: the max is taken in
// float32 over every match, so the result equals the plain version
// (rulebook, gather, max) bit for bit.
//
// Design: one thread per output row. The thread resolves the row's taps
// (up to 27 binary searches) into registers, then takes each channel's max
// over the matched rows and writes the row. At the flagship's occ code
// width (2 channels) the work is a few loads per row: launch latency and
// the dependent loads of the searches bound it, not bandwidth.

#include <cfloat>
#include <cuda_runtime.h>

#include "sparse_keys.cuh"

namespace {

constexpr int NT = 256;  // threads (output rows) per block

__global__ void __launch_bounds__(NT) sparse_maxpool_kernel(
    const float* __restrict__ feats, const int* __restrict__ in_keys, int n_in,
    const int* __restrict__ out_coords, int n_out, float* __restrict__ out, int C, Geom g) {
  const int m = blockIdx.x * NT + threadIdx.x;
  if (m >= n_out) return;
  const int K = g.kz * g.ky * g.kx;
  const int b = out_coords[(long long)m * 4];
  const int z = out_coords[(long long)m * 4 + 1];
  const int y = out_coords[(long long)m * 4 + 2];
  const int x = out_coords[(long long)m * 4 + 3];
  int rows[KMAX];
  int n_found = 0;
  for (int k = 0; k < K; ++k) {
    const int r = match_tap(g, b, z, y, x, k, in_keys, n_in);
    if (r >= 0) rows[n_found++] = r;
  }
  for (int c = 0; c < C; ++c) {
    float acc = -FLT_MAX;
    for (int i = 0; i < n_found; ++i) acc = fmaxf(acc, feats[(long long)rows[i] * C + c]);
    out[(long long)m * C + c] = n_found > 0 ? acc : 0.f;
  }
}

}  // namespace

// feats (n_in, C) float32; in_keys (n_in,) int32 ascending, INT32_MAX
// padding; out_coords (n_out, 4) int32; out (n_out, C) float32. Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sparse_maxpool_fwd(const float* feats, const int* in_keys, int n_in,
                                  const int* out_coords, int n_out, float* out, int C,
                                  int kz, int ky, int kx, int sz, int sy, int sx, int pz,
                                  int py, int px, int nz, int ny, int nx, void* stream) {
  if (n_out == 0) return 0;
  if (kz * ky * kx > KMAX || C <= 0) return (int)cudaErrorInvalidValue;
  const Geom g{kz, ky, kx, sz, sy, sx, pz, py, px, nz, ny, nx, 0};
  const dim3 grid((n_out + NT - 1) / NT);
  sparse_maxpool_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, in_keys, n_in, out_coords, n_out, out, C, g);
  return (int)cudaGetLastError();
}
