// Sparse 3D convolution weight gradient (kernel K3 of the port).
//
// Replaces the Pallas TPU kernel btcdet_tpu/ops/pallas_conv.py::_fused_call_dw
// (kernel body _make_kernel_dw). For a conv whose forward is
//     out[m, :] = sum_k in[match(q(m, k)), :] @ W[k]
// (sparse_conv.cu, the same query q and the same binary search over the
// whole sorted input key table, sparse_keys.cuh) it computes
//     dW[k] = sum_m in[match(q(m, k)), :]^T @ g[m, :]
// over every match: there are no windows, so nothing is dropped. Inputs are
// f32 or bf16 features, f32 g; the sums run in f32.
//
// Design: the output rows are split into n_chunks contiguous chunks. Pass 1
// runs one block of 256 threads per (32-input x 64-output channel tile,
// tap, chunk): it walks its chunk 32 rows at a time, resolves the tap's
// match of each row (a block-uniform skip when none of the 32 rows
// matches), gathers the matched input rows and the rows of g into shared
// memory and accumulates the tile with FMAs, 8 outputs a thread; it writes
// the chunk's partial (K, Cin, Cout) tile to a workspace. Pass 2 sums the
// partials over the chunks in chunk order. Every sum runs in a fixed order
// and no float atomics are used, so the result is the same bit for bit from
// run to run. The wrapper bounds the workspace (n_chunks * K * Cin * Cout
// floats) and picks n_chunks from the shapes alone.
//
// What bounds it on an H100: the products run on the CUDA cores in f32
// (2 * Cin * Cout flops per match, at most 67 TFLOP/s) and every
// (tile, tap) block searches its rows' matches again; the ideal kernel is
// memory-bound at these widths. Tensor cores and one search per (tap, row)
// are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sparse_keys.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int TM = 32;           // rows per step
constexpr int TCI = 32;          // input channels per block tile
constexpr int TCO = 64;          // output channels per block tile
constexpr int TX = 16;           // threads along the output channels
constexpr int TY = NT / TX;      // threads along the input channels
constexpr int RI = TCI / TY;     // input channels per thread
constexpr int RO = TCO / TX;     // output channels per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(NT) dw_partial_kernel(
    const T* __restrict__ feats, const int* __restrict__ in_keys, int n_in,
    const int* __restrict__ out_coords, int n_out, const float* __restrict__ g,
    float* __restrict__ ws, int cin, int cout, int rows_per_chunk, Geom geo) {
  __shared__ int s_idx[TM];
  __shared__ float s_a[TM][TCI + 1];
  __shared__ float s_g[TM][TCO + 1];

  const int co_tiles = (cout + TCO - 1) / TCO;
  const int ci0 = (blockIdx.x / co_tiles) * TCI;
  const int co0 = (blockIdx.x % co_tiles) * TCO;
  const int k = blockIdx.y;
  const int chunk = blockIdx.z;
  const int K = geo.kz * geo.ky * geo.kx;
  const int m_begin = chunk * rows_per_chunk;
  const int m_end = min(n_out, m_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid - ty * TX;

  float acc[RI][RO];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) acc[i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += TM) {
    int found = -1;
    if (tid < TM) {
      const int m = m0 + tid;
      if (m < m_end) {
        const int* c = out_coords + (long long)m * 4;
        found = match_tap(geo, c[0], c[1], c[2], c[3], k, in_keys, n_in);
      }
      s_idx[tid] = found;
    }
    if (!__syncthreads_or(found >= 0)) continue;  // block-uniform

    for (int e = tid; e < TM * TCI; e += NT) {
      const int r = e / TCI;
      const int c = e - r * TCI;
      const int i = s_idx[r];
      s_a[r][c] = (i >= 0 && ci0 + c < cin) ? to_f(feats[(long long)i * cin + ci0 + c]) : 0.f;
    }
    for (int e = tid; e < TM * TCO; e += NT) {
      const int r = e / TCO;
      const int o = e - r * TCO;
      s_g[r][o] = (s_idx[r] >= 0 && co0 + o < cout)
                      ? g[(long long)(m0 + r) * cout + co0 + o] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < TM; ++r) {
      float a[RI], b[RO];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = s_a[r][ty + i * TY];
#pragma unroll
      for (int j = 0; j < RO; ++j) b[j] = s_g[r][tx + j * TX];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RO; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* part = ws + ((long long)chunk * K + k) * cin * cout;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int ci = ci0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int co = co0 + tx + j * TX;
      if (ci < cin && co < cout) part[(long long)ci * cout + co] = acc[i][j];
    }
  }
}

// dw[e] = sum over chunks c, in order, of ws[c][e].
__global__ void dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                 int n_chunks, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += ws[(long long)c * n + e];
  dw[e] = s;
}

template <typename T>
void launch_partial(const void* feats, const int* in_keys, int n_in, const int* out_coords,
                    int n_out, const float* g, float* ws, int cin, int cout, int n_chunks,
                    int rows_per_chunk, Geom geo, cudaStream_t stream) {
  const int K = geo.kz * geo.ky * geo.kx;
  const dim3 grid(((cin + TCI - 1) / TCI) * ((cout + TCO - 1) / TCO), K, n_chunks);
  dw_partial_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(feats), in_keys, n_in,
                                                out_coords, n_out, g, ws, cin, cout,
                                                rows_per_chunk, geo);
}

}  // namespace

// features (n_in, cin) float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// in_keys (n_in,) int32 ascending; out_coords (n_out, 4) int32 (b, z, y, x);
// g (n_out, cout) float32; dw (K, cin, cout) float32. With n_chunks > 1, ws
// holds n_chunks * K * cin * cout floats of scratch; with n_chunks == 1 the
// single partial is dw itself and ws is unused. Rows [c * rows_per_chunk,
// (c + 1) * rows_per_chunk) form chunk c. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int sparse_conv_dw(const void* feats, int is_bf16, const int* in_keys, int n_in,
                              const int* out_coords, int n_out, const float* g, float* dw,
                              float* ws, int n_chunks, int rows_per_chunk, int cin, int cout,
                              int kz, int ky, int kx, int sz, int sy, int sx, int pz, int py,
                              int px, int nz, int ny, int nx, void* stream) {
  const int K = kz * ky * kx;
  if (K > KMAX || cin <= 0 || cout <= 0 || n_chunks <= 0 || n_chunks > 65535 ||
      rows_per_chunk <= 0 || (long long)n_chunks * rows_per_chunk < n_out)
    return (int)cudaErrorInvalidValue;
  const Geom geo{kz, ky, kx, sz, sy, sx, pz, py, px, nz, ny, nx, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = n_chunks == 1 ? dw : ws;
  if (is_bf16)
    launch_partial<__nv_bfloat16>(feats, in_keys, n_in, out_coords, n_out, g, part, cin, cout,
                                  n_chunks, rows_per_chunk, geo, s);
  else
    launch_partial<float>(feats, in_keys, n_in, out_coords, n_out, g, part, cin, cout,
                          n_chunks, rows_per_chunk, geo, s);
  int err = (int)cudaGetLastError();
  if (err != 0 || n_chunks == 1) return err;
  const long long n = (long long)K * cin * cout;
  const int threads = 256;
  dw_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(ws, dw, n_chunks, n);
  return (int)cudaGetLastError();
}
