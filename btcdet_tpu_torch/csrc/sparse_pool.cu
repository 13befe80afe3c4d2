// Sparse 3D pooling over a neighbour map: kernel K2 of the port, in its max
// mode and its sum mode, and the max mode's backward.
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
//
// The backward (OCC_PNT_UPDATE.PASS_GRAD, where the occ code carries a
// gradient) is the VJP that the JAX package takes of the pool's XLA twin
// (btcdet_tpu/ops/sparse.py::_pallas_pool_ad_bwd):
//     max: df[i, c] = sum over the (k, m) with nbr[k, m] == i and
//                     feats[i, c] == out[m, c] of g[m, c] / count[m, c],
//          count[m, c] the number of matched taps of row m whose value equals
//          out[m, c]: tied maxima share the gradient evenly, as the VJP of
//          jnp.max does (the occ code's 0/1 flags and shared probabilities
//          tie often, so this is the function, not a corner case);
//     sum: df[i, c] = sum over the (k, m) with nbr[k, m] == i of g[m, c],
//          which is the sum mode's forward with g as the table, over the
//          transpose-query map: it launches sparse_sumpool_fwd.
// Both gather over the transpose-query map tnbr (K, n_in) of the same
// geometry (sparse_nbr.cu with transpose set: tnbr[k, i] is the output row m
// whose tap k reads input row i, or -1), one thread per (input row,
// channel), adding in tap order: no atomics, so the result repeats bit for
// bit and equals the plain version, which adds in the same order.
//
// The max mode's backward follows the plain version's two steps, so each
// tie is counted once per output, not once per input that reads it (the
// flags tie almost everywhere, and a recount per input walked 27 taps of
// the forward's map 2-3 times a thread): sparse_maxpool_share_kernel, one
// thread per (output row, channel), writes share = g / count (count at
// least 1) into a scratch the wrapper allocates, reading the forward's
// map as the forward does; sparse_maxpool_bwd_kernel, one thread per
// (input row, channel), adds share[m, c] over the transpose taps in tap
// order where feats[i, c] == out[m, c]. The division and the order of the
// sum are the plain version's. At the occ code's 2 channels both kernels
// are a few dependent loads a thread: the launch and those round trips
// bound them, not bandwidth.

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

// the max mode's backward, first kernel: one thread per (output row m,
// channel c) counts the matched taps whose value ties out[m, c], reading the
// forward's map as the forward does, and writes the share of each tie,
// g[m, c] / count (count at least 1, as the plain version clamps it)
__global__ void __launch_bounds__(NT) sparse_maxpool_share_kernel(
    const float* __restrict__ feats, const float* __restrict__ out,
    const float* __restrict__ g, const int* __restrict__ nbr, int n_out, int K,
    float* __restrict__ share, int C) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= (long long)n_out * C) return;
  const int m = (int)(t / C);
  const int c = (int)(t - (long long)m * C);
  int rows[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) rows[k] = k < K ? nbr[(long long)k * n_out + m] : -1;
  const float o = out[t];
  int count = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
    if (rows[k] >= 0 && feats[(long long)rows[k] * C + c] == o) ++count;
  share[t] = g[t] / (float)max(count, 1);
}

// second kernel: one thread per (input row i, channel c) adds, in tap order
// over the transpose-query map, the share of every output row m that reads
// it where its value ties out[m, c]
__global__ void __launch_bounds__(NT) sparse_maxpool_bwd_kernel(
    const float* __restrict__ feats, const float* __restrict__ out,
    const float* __restrict__ share, const int* __restrict__ tnbr, int n_in, int K,
    float* __restrict__ df, int C) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= (long long)n_in * C) return;
  const int i = (int)(t / C);
  const int c = (int)(t - (long long)i * C);
  int outs[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) outs[k] = k < K ? tnbr[(long long)k * n_in + i] : -1;
  const float f = feats[t];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    if (outs[k] < 0) continue;
    const long long mc = (long long)outs[k] * C + c;
    if (f == out[mc]) acc += share[mc];
  }
  df[t] = acc;
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

// Max mode's backward. feats (n_in, C), out (n_out, C) the forward's output,
// g (n_out, C), all float32; nbr (K, n_out) the forward's map; tnbr
// (K, n_in) the transpose-query map of the same geometry; share (n_out, C)
// float32 scratch; df (n_in, C) float32, every element written.
extern "C" int sparse_maxpool_bwd(const float* feats, const float* out, const float* g,
                                  const int* nbr, const int* tnbr, int n_in, int n_out, int K,
                                  float* share, float* df, int C, void* stream) {
  if (n_in == 0) return 0;
  if (K <= 0 || K > KMAX || C <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_sh = (long long)n_out * C;
  if (n_sh > 0)
    sparse_maxpool_share_kernel<<<(unsigned)((n_sh + NT - 1) / NT), NT, 0, s>>>(
        feats, out, g, nbr, n_out, K, share, C);
  const long long n = (long long)n_in * C;
  sparse_maxpool_bwd_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, s>>>(feats, out, share,
                                                                         tnbr, n_in, K, df, C);
  return (int)cudaGetLastError();
}
