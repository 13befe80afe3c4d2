// Sparse 3D pooling forward over a neighbour map: kernel K2 of the port, in
// its max mode and its sum mode.
//
// Replaces the Pallas TPU kernel btcdet_tpu/ops/pallas_conv.py::_fused_call
// (kernel body _make_kernel) in its modes "max" and "sum". Max runs
// SparseMaxPool3d on the occ-code side branch of the det backbone; sum runs
// FixedSparseConv3d, the `fix` and `avgpool` occ-code downsamplers. For every
// output row m:
//     max: out[m, c] = max over the taps k with nbr[k, m] >= 0 of feats[nbr[k, m], c]
//     sum: out[m, c] = sum over the taps k with nbr[k, m] >= 0 of feats[nbr[k, m], c],
//          added in tap order
// and 0 where no tap matches (padding rows included). nbr (K, M) is the
// neighbour map of sparse_nbr.cu: a pool reads the map that the trunk's
// strided conv built for the same input table, sites and geometry
// (ops/sparse.py `neighbor_map_cached`), so it searches no key. The sum's
// constant weight (FixedSparseConv3d's default_value) multiplies the
// result outside the kernel, as in the JAX package.
//
// Unlike the TPU kernel there are no fixed match windows (which drop matches
// outside them) and no rounding of the table to bf16: the reduction runs in
// float32 over every match, in the same order as the plain version (a
// gather over the map, then a max or a sum tap by tap), so the two are
// equal bit for bit.
//
// Design: one thread per (output row, channel). The thread loads the row's
// K map entries (independent loads, coalesced across the warp's rows),
// then reduces its channel over the matched rows in tap order. At the
// flagship's occ-code width (2 channels) the work is a few loads per row:
// the launch and two dependent round trips to memory bound it, not
// bandwidth.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 27;  // most taps a kernel may have (3x3x3)
constexpr int NT = 256;   // threads per block

template <bool kSum>
__global__ void __launch_bounds__(NT) sparse_pool_kernel(
    const float* __restrict__ feats, const int* __restrict__ nbr, int n_out, int K,
    float* __restrict__ out, int C) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= (long long)n_out * C) return;
  const int m = (int)(t / C);
  const int c = (int)(t - (long long)m * C);
  int rows[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) rows[k] = k < K ? nbr[(long long)k * n_out + m] : -1;
  float acc = kSum ? 0.f : -FLT_MAX;
  bool any = false;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (rows[k] < 0) continue;
    const float v = feats[(long long)rows[k] * C + c];
    acc = kSum ? acc + v : fmaxf(acc, v);
    any = true;
  }
  out[t] = (kSum || any) ? acc : 0.f;
}

template <bool kSum>
int launch(const float* feats, const int* nbr, int n_out, int K, float* out, int C,
           void* stream) {
  if (n_out == 0) return 0;
  if (K <= 0 || K > KMAX || C <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)n_out * C;
  sparse_pool_kernel<kSum><<<(unsigned)((n + NT - 1) / NT), NT, 0,
                             static_cast<cudaStream_t>(stream)>>>(feats, nbr, n_out, K, out, C);
  return (int)cudaGetLastError();
}

}  // namespace

// feats (n_in, C) float32; nbr (K, n_out) int32, the input row of tap k of
// output row m or -1; out (n_out, C) float32. Each launches on `stream`,
// allocates nothing, and returns cudaGetLastError().
extern "C" int sparse_maxpool_fwd(const float* feats, const int* nbr, int n_out, int K,
                                  float* out, int C, void* stream) {
  return launch<false>(feats, nbr, n_out, K, out, C, stream);
}

extern "C" int sparse_sumpool_fwd(const float* feats, const int* nbr, int n_out, int K,
                                  float* out, int C, void* stream) {
  return launch<true>(feats, nbr, n_out, K, out, C, stream);
}
