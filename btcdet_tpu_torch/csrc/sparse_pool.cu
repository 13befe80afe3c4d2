// Sparse 3D pooling forward over key-sorted voxel tables: kernel K2 of the
// port, in its max mode and its sum mode.
//
// Replaces the Pallas TPU kernel btcdet_tpu/ops/pallas_conv.py::_fused_call
// (kernel body _make_kernel) in its modes "max" and "sum". Max runs
// SparseMaxPool3d on the occ-code side branch of the det backbone; sum runs
// FixedSparseConv3d, the `fix` and `avgpool` occ-code downsamplers. For every
// output row m of a site table out_coords (b, z, y, x) (padding rows b < 0):
//     max: out[m, c] = max over the taps k that match an input row i of feats[i, c]
//     sum: out[m, c] = sum over the taps k that match an input row i of feats[i, c],
//          added in tap order
// and 0 where no tap matches (padding rows included). Matching is the shared
// binary search of sparse_keys.cuh over the whole sorted input table. The
// sum's constant weight (FixedSparseConv3d's default_value) multiplies the
// result outside the kernel, as in the JAX package.
//
// Unlike the TPU kernel there are no fixed match windows (which drop matches
// outside them) and no rounding of the table to bf16: the reduction runs in
// float32 over every match, in the same order as the plain version
// (rulebook, gather, then a max or a sum tap by tap), so the two are equal
// bit for bit.
//
// Design: one thread per output row. The thread resolves the row's taps
// (up to 27 binary searches) into registers, then reduces each channel over
// the matched rows and writes the row. At the flagship's occ code width (2
// channels) the work is a few loads per row: launch latency and the
// dependent loads of the searches bound it, not bandwidth.

#include <cfloat>
#include <cuda_runtime.h>

#include "sparse_keys.cuh"

namespace {

constexpr int NT = 256;  // threads (output rows) per block

template <bool kSum>
__global__ void __launch_bounds__(NT) sparse_pool_kernel(
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
    float acc = kSum ? 0.f : -FLT_MAX;
    for (int i = 0; i < n_found; ++i) {
      const float v = feats[(long long)rows[i] * C + c];
      acc = kSum ? acc + v : fmaxf(acc, v);
    }
    out[(long long)m * C + c] = (kSum || n_found > 0) ? acc : 0.f;
  }
}

template <bool kSum>
int launch(const float* feats, const int* in_keys, int n_in, const int* out_coords, int n_out,
           float* out, int C, int kz, int ky, int kx, int sz, int sy, int sx, int pz, int py,
           int px, int nz, int ny, int nx, void* stream) {
  if (n_out == 0) return 0;
  if (kz * ky * kx > KMAX || C <= 0) return (int)cudaErrorInvalidValue;
  const Geom g{kz, ky, kx, sz, sy, sx, pz, py, px, nz, ny, nx, 0};
  const dim3 grid((n_out + NT - 1) / NT);
  sparse_pool_kernel<kSum><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, in_keys, n_in, out_coords, n_out, out, C, g);
  return (int)cudaGetLastError();
}

}  // namespace

// feats (n_in, C) float32; in_keys (n_in,) int32 ascending, INT32_MAX
// padding; out_coords (n_out, 4) int32; out (n_out, C) float32. Each launches
// on `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int sparse_maxpool_fwd(const float* feats, const int* in_keys, int n_in,
                                  const int* out_coords, int n_out, float* out, int C,
                                  int kz, int ky, int kx, int sz, int sy, int sx, int pz,
                                  int py, int px, int nz, int ny, int nx, void* stream) {
  return launch<false>(feats, in_keys, n_in, out_coords, n_out, out, C, kz, ky, kx, sz, sy, sx,
                       pz, py, px, nz, ny, nx, stream);
}

extern "C" int sparse_sumpool_fwd(const float* feats, const int* in_keys, int n_in,
                                  const int* out_coords, int n_out, float* out, int C,
                                  int kz, int ky, int kx, int sz, int sy, int sx, int pz,
                                  int py, int px, int nz, int ny, int nx, void* stream) {
  return launch<true>(feats, in_keys, n_in, out_coords, n_out, out, C, kz, ky, kx, sz, sy, sx,
                      pz, py, px, nz, ny, nx, stream);
}
