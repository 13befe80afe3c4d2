// Sparse 3D convolution forward: exact gather-GEMM over key-sorted voxel
// tables (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel btcdet_tpu/ops/pallas_conv.py::_fused_call,
// mode "conv" (kernel body _make_kernel). It computes, for every output row
// m of a key-sorted output site table,
//     out[m, :] = sum_k in[match(q(m, k)), :] @ W[k]
// where q(m, k) is the y-major linear key ((b*ny + y)*nz + z)*nx + x of the
// input site out_zyx*stride - pad + tap_k, a tap whose site lies outside the
// input grid or has no active voxel adds 0, and rows whose coords are padding
// (b < 0) are 0. Submanifold convs are the case stride 1, pad k/2 with the
// output sites equal to the input sites.
//
// The same kernel computes the df of a sparse conv's backward: for a
// submanifold conv it runs over the same sites with tap-reversed,
// transposed weights; for a strided conv in transpose-query mode
// (`transpose` = 1, see sparse_keys.cuh) over the forward's output table
// with per-tap transposed weights (pallas_conv.py subm_conv_bwd /
// strided_conv_bwd).
//
// Unlike the TPU kernel there are no fixed match windows, no 128-channel
// limit and no tap padding: every match is found by a binary search over the
// whole sorted input key table (sparse_keys.cuh), so nothing is dropped.
//
// Design: one block of 256 threads per tile of 32 output rows. The block
// first resolves the matches of all K taps for its rows (K*32 binary searches
// into shared memory), then, per tap that has any match in the tile and per
// 32-channel chunk of the input, gathers the matched input rows and the tap's
// weight slice into shared memory (as f32) and accumulates with FMAs; each
// thread owns one output channel of a set of rows. Each output element is
// written by exactly one thread: no atomics, deterministic results.
//
// What bounds it on an H100: at the backbone's widths (Cin <= 256, Cout <=
// 128) the ideal kernel is memory-bound, but this first version runs its
// products on the CUDA cores (f32 FMA from shared memory), not on the tensor
// cores, and pays the binary searches' dependent L2 loads; both are left to
// a later change (mma/wgmma on bf16 tiles, hashed lookups).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sparse_keys.cuh"

namespace {

constexpr int NT = 256;    // threads per block
constexpr int TM = 32;     // output rows per block
constexpr int CK = 32;     // input channels per shared-memory chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int COUT_P>
__global__ void __launch_bounds__(NT) sparse_conv_kernel(
    const T* __restrict__ feats, const int* __restrict__ in_keys, int n_in,
    const int* __restrict__ out_coords, int n_out, const T* __restrict__ weights,
    float* __restrict__ out, int cin, int cout, Geom g) {
  constexpr int NRG = NT / COUT_P;  // row groups
  constexpr int RPT = TM / NRG;     // rows per thread
  static_assert(NRG * RPT == TM, "tile rows must split evenly");

  __shared__ int s_coord[TM][4];
  __shared__ int s_idx[KMAX][TM];
  __shared__ int s_any[KMAX];
  __shared__ float s_a[TM][CK + 1];
  __shared__ float s_w[CK][COUT_P];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * TM;
  const int K = g.kz * g.ky * g.kx;

  if (tid < TM) {
    const int m = m0 + tid;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      s_coord[tid][j] = (m < n_out) ? out_coords[(long long)m * 4 + j] : -1;
  }
  if (tid < KMAX) s_any[tid] = 0;
  __syncthreads();

  // match every (tap, row) of the tile: canonical (dz, dy, dx) tap order
  for (int e = tid; e < K * TM; e += NT) {
    const int k = e / TM;
    const int r = e - k * TM;
    const int found = match_tap(g, s_coord[r][0], s_coord[r][1], s_coord[r][2], s_coord[r][3],
                                k, in_keys, n_in);
    s_idx[k][r] = found;
    if (found >= 0) s_any[k] = 1;  // benign race: every writer stores 1
  }
  __syncthreads();

  const int co = tid % COUT_P;
  const int rg = tid / COUT_P;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int k = 0; k < K; ++k) {
    if (!s_any[k]) continue;  // block-uniform: read from shared memory
    for (int c0 = 0; c0 < cin; c0 += CK) {
      const int cw = min(CK, cin - c0);
      for (int e = tid; e < TM * CK; e += NT) {
        const int r = e / CK;
        const int c = e - r * CK;
        const int i = s_idx[k][r];
        s_a[r][c] = (i >= 0 && c < cw) ? to_f(feats[(long long)i * cin + c0 + c]) : 0.f;
      }
      for (int e = tid; e < CK * COUT_P; e += NT) {
        const int c = e / COUT_P;
        const int o = e - c * COUT_P;
        s_w[c][o] = (c < cw && o < cout)
                        ? to_f(weights[((long long)k * cin + c0 + c) * cout + o])
                        : 0.f;
      }
      __syncthreads();
      for (int c = 0; c < cw; ++c) {
        const float w = s_w[c][co];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = fmaf(s_a[rg + i * NRG][c], w, acc[i]);
      }
      __syncthreads();
    }
  }

  if (co < cout) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int m = m0 + rg + i * NRG;
      if (m < n_out) out[(long long)m * cout + co] = acc[i];
    }
  }
}

template <typename T, int P>
void launch(const void* feats, const int* in_keys, int n_in, const int* out_coords,
            int n_out, const void* weights, float* out, int cin, int cout, Geom g,
            cudaStream_t stream) {
  const dim3 grid((n_out + TM - 1) / TM);
  sparse_conv_kernel<T, P><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(feats), in_keys, n_in, out_coords, n_out,
      static_cast<const T*>(weights), out, cin, cout, g);
}

template <typename T>
int dispatch(int cout_p, const void* feats, const int* in_keys, int n_in,
             const int* out_coords, int n_out, const void* weights, float* out,
             int cin, int cout, Geom g, cudaStream_t stream) {
  switch (cout_p) {
    case 8: launch<T, 8>(feats, in_keys, n_in, out_coords, n_out, weights, out, cin, cout, g, stream); break;
    case 16: launch<T, 16>(feats, in_keys, n_in, out_coords, n_out, weights, out, cin, cout, g, stream); break;
    case 32: launch<T, 32>(feats, in_keys, n_in, out_coords, n_out, weights, out, cin, cout, g, stream); break;
    case 64: launch<T, 64>(feats, in_keys, n_in, out_coords, n_out, weights, out, cin, cout, g, stream); break;
    case 128: launch<T, 128>(feats, in_keys, n_in, out_coords, n_out, weights, out, cin, cout, g, stream); break;
    case 256: launch<T, 256>(feats, in_keys, n_in, out_coords, n_out, weights, out, cin, cout, g, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// features (n_in, cin) and weights (K, cin, cout) are float32 (is_bf16 = 0)
// or bfloat16 (is_bf16 = 1); in_keys (n_in,) int32 ascending; out_coords
// (n_out, 4) int32 (b, z, y, x); out (n_out, cout) float32; transpose
// selects the transpose-query mode (sparse_keys.cuh). Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sparse_conv_fwd(const void* feats, int is_bf16, const int* in_keys, int n_in,
                               const int* out_coords, int n_out, const void* weights,
                               float* out, int cin, int cout, int kz, int ky, int kx,
                               int sz, int sy, int sx, int pz, int py, int px, int nz,
                               int ny, int nx, int transpose, void* stream) {
  if (n_out == 0) return 0;
  if (kz * ky * kx > KMAX || cin <= 0 || cout <= 0 || cout > 256) return (int)cudaErrorInvalidValue;
  int cout_p = 8;
  while (cout_p < cout) cout_p <<= 1;
  const Geom g{kz, ky, kx, sz, sy, sx, pz, py, px, nz, ny, nx, transpose};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(cout_p, feats, in_keys, n_in, out_coords, n_out, weights, out,
                                   cin, cout, g, s);
  return dispatch<float>(cout_p, feats, in_keys, n_in, out_coords, n_out, weights, out, cin,
                         cout, g, s);
}
