// Sparse 3D convolution forward: exact gather-GEMM over a neighbour map
// (kernel K1 of the port).
//
// Replaces the Pallas TPU kernel btcdet_tpu/ops/pallas_conv.py::_fused_call,
// mode "conv" (kernel body _make_kernel). It computes, for every output row
// m,
//     out[m, :] = sum over the taps k with nbr[k, m] >= 0 of in[nbr[k, m], :] @ W[k]
// where nbr (K, M) is the neighbour map that sparse_nbr.cu builds once per
// (input table, output sites, geometry): the input row of tap k of output
// row m, or -1 for a tap off the grid, with no active voxel, or of a
// padding row. Padding rows therefore come out 0.
//
// The same kernel computes the df of a sparse conv's backward: for a
// submanifold conv over the forward's own map with tap-reversed, transposed
// weights; for a strided conv over a transpose-query map (sparse_keys.cuh)
// with per-tap transposed weights (pallas_conv.py subm_conv_bwd /
// strided_conv_bwd).
//
// Two bodies, picked by the features' dtype:
//
// bf16 (the model's path): tensor cores. One block per tile of BM = 64
// output rows by the whole Cout (8-256), 4 warps along the rows, 2 along
// Cout when Cout > 64; each warp owns a 16-row strip of its columns, so
// every output element is summed by one warp in a fixed order (taps
// ascending, then 32-channel chunks, then the 16-deep mma steps): no
// atomics, no split-K, bit for bit repeatable. The block reads its K x 64
// slice of the map, lists the taps with any match in the tile, and walks
// the (tap, chunk) steps through a 3-stage cp.async ring in shared memory:
// the A tile (the 64 matched input rows, 32 channels) is gathered with
// 16-byte cp.async copies, an unmatched row or a chunk past Cin by the
// src-size-0 form, which zero-fills; the W tile (32 x Cout) the same way.
// Fragments come out of shared memory with ldmatrix (rows padded by 16
// bytes, so neither ldmatrix conflicts) and go through
// mma.sync.m16n8k16 bf16 -> f32. The wrapper pads a Cin that is not a
// multiple of 8 (the features and the weights, one small copy) and a Cout
// that is not a multiple of 8 (the weights), so that every 16-byte copy is
// aligned.
//
// f32 (BTCDET_F32=1 and the f32 checks): exact f32 FMA on the CUDA cores,
// one block per 32 rows, each thread one output channel of a set of rows,
// matched rows and weights staged in shared memory as f32. No TF32: the
// card-vs-CPU checks hold the f32 path to 1e-3 / 1e-4.
//
// What bounds it on an H100: at the backbone's widths (Cin <= 256, Cout <=
// 256) the work a run's data needs (matched rows once, the weights once,
// the output once; 2*Cin*Cout flops a match) is a few microseconds of
// HBM. The bf16 body instead pays the L2 traffic of re-reading each tap's
// weights per 64-row tile and of the gathered rows, and mma work on the
// unmatched rows of a tile's active taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sparse_keys.cuh"

namespace {

// ------------------------------------------------------------ f32 body

constexpr int F_NT = 256;  // threads per block
constexpr int F_TM = 32;   // output rows per block
constexpr int F_CK = 32;   // input channels per shared-memory chunk

template <int COUT_P>
__global__ void __launch_bounds__(F_NT) sparse_conv_f32_kernel(
    const float* __restrict__ feats, const int* __restrict__ nbr, int n_out, int K,
    const float* __restrict__ weights, float* __restrict__ out, int cin, int cout) {
  constexpr int NRG = F_NT / COUT_P;  // row groups
  constexpr int RPT = F_TM / NRG;     // rows per thread
  static_assert(NRG * RPT == F_TM, "tile rows must split evenly");

  __shared__ int s_idx[KMAX][F_TM];
  __shared__ int s_any[KMAX];
  __shared__ float s_a[F_TM][F_CK + 1];
  __shared__ float s_w[F_CK][COUT_P];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * F_TM;
  if (tid < KMAX) s_any[tid] = 0;
  __syncthreads();
  for (int e = tid; e < K * F_TM; e += F_NT) {
    const int k = e / F_TM;
    const int m = m0 + (e - k * F_TM);
    const int i = (m < n_out) ? nbr[(long long)k * n_out + m] : -1;
    s_idx[k][e - k * F_TM] = i;
    if (i >= 0) s_any[k] = 1;  // benign race: every writer stores 1
  }
  __syncthreads();

  const int co = tid % COUT_P;
  const int rg = tid / COUT_P;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int k = 0; k < K; ++k) {
    if (!s_any[k]) continue;  // block-uniform: read from shared memory
    for (int c0 = 0; c0 < cin; c0 += F_CK) {
      const int cw = min(F_CK, cin - c0);
      for (int e = tid; e < F_TM * F_CK; e += F_NT) {
        const int r = e / F_CK;
        const int c = e - r * F_CK;
        const int i = s_idx[k][r];
        s_a[r][c] = (i >= 0 && c < cw) ? feats[(long long)i * cin + c0 + c] : 0.f;
      }
      for (int e = tid; e < F_CK * COUT_P; e += F_NT) {
        const int c = e / COUT_P;
        const int o = e - c * COUT_P;
        s_w[c][o] = (c < cw && o < cout) ? weights[((long long)k * cin + c0 + c) * cout + o] : 0.f;
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

template <int P>
void launch_f32(const float* feats, const int* nbr, int n_out, int K, const float* weights,
                float* out, int cin, int cout, cudaStream_t stream) {
  sparse_conv_f32_kernel<P><<<(n_out + F_TM - 1) / F_TM, F_NT, 0, stream>>>(
      feats, nbr, n_out, K, weights, out, cin, cout);
}

// ----------------------------------------------------------- bf16 body

constexpr int BM = 64;         // output rows per block
constexpr int BK = 32;         // input channels per k-step
constexpr int NSTAGE = 3;      // cp.async ring depth
constexpr int A_LD = BK + 8;   // A row in shared memory (bf16): 80 bytes

template <int COUT_P>
struct Tile {
  static constexpr int WARPS_N = COUT_P > 64 ? 2 : 1;
  static constexpr int THREADS = 32 * 4 * WARPS_N;
  static constexpr int WN = COUT_P / WARPS_N;     // columns of one warp
  static constexpr int NT8 = WN / 8;              // its n8 mma tiles
  static constexpr int W_LD = COUT_P + 8;         // W row in shared memory (bf16)
  static constexpr int A_ELEMS = BM * A_LD;
  static constexpr int W_ELEMS = BK * W_LD;
  static constexpr int SMEM = NSTAGE * (A_ELEMS + W_ELEMS) * 2 + KMAX * BM * 4 + (KMAX + 1) * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes 0 writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async_ca16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// feats (N, cin) bf16 and weights (K, cin, cout8) bf16 with cin and cout8
// multiples of 8; out (n_out, cout) f32.
template <int COUT_P>
__global__ void __launch_bounds__(Tile<COUT_P>::THREADS) sparse_conv_mma_kernel(
    const __nv_bfloat16* __restrict__ feats, const int* __restrict__ nbr, int n_out, int K,
    const __nv_bfloat16* __restrict__ weights, float* __restrict__ out, int cin, int cout,
    int cout8) {
  using T = Tile<COUT_P>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_w = s_a + NSTAGE * T::A_ELEMS;
  int* s_idx = reinterpret_cast<int*>(s_w + NSTAGE * T::W_ELEMS);  // [KMAX][BM]
  int* s_taps = s_idx + KMAX * BM;                                 // [KMAX], then the count

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  __shared__ int s_any[KMAX];
  if (tid < KMAX) s_any[tid] = 0;
  __syncthreads();
  for (int e = tid; e < K * BM; e += T::THREADS) {
    const int k = e / BM;
    const int m = m0 + (e - k * BM);
    const int i = (m < n_out) ? nbr[(long long)k * n_out + m] : -1;
    s_idx[e] = i;
    if (i >= 0) s_any[k] = 1;  // benign race: every writer stores 1
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < K; ++k)
      if (s_any[k]) s_taps[n++] = k;
    s_taps[KMAX] = n;
  }
  __syncthreads();

  const int n_chunks = (cin + BK - 1) / BK;
  const int n_steps = s_taps[KMAX] * n_chunks;

  // gather step `step` = (tap, chunk) into ring slot `slot`
  auto load = [&](int step, int slot) {
    const int t = step / n_chunks;
    const int k = s_taps[t];
    const int c0 = (step - t * n_chunks) * BK;
    __nv_bfloat16* a = s_a + slot * T::A_ELEMS;
    for (int e = tid; e < BM * (BK / 8); e += T::THREADS) {
      const int r = e / (BK / 8);
      const int c = c0 + (e - r * (BK / 8)) * 8;
      const int i = s_idx[k * BM + r];
      const bool ok = i >= 0 && c < cin;
      cp_async_ca16(a + r * A_LD + (c - c0), ok ? feats + (long long)i * cin + c : feats,
                    ok ? 16 : 0);
    }
    __nv_bfloat16* w = s_w + slot * T::W_ELEMS;
    constexpr int CPR = COUT_P / 8;  // 16-byte copies per W row
    for (int e = tid; e < BK * CPR; e += T::THREADS) {
      const int r = e / CPR;
      const int n = (e - r * CPR) * 8;
      const int c = c0 + r;
      const bool ok = c < cin && n < cout8;
      cp_async_cg16(w + r * T::W_LD + n,
                    ok ? weights + ((long long)k * cin + c) * cout8 + n : weights, ok ? 16 : 0);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3;   // 16-row strip
  const int wn = warp >> 2;  // column block
  float acc[T::NT8][4];
#pragma unroll
  for (int j = 0; j < T::NT8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // step `it` has landed; slot (it - 1) % NSTAGE is free
    const int nxt = it + NSTAGE - 1;
    if (nxt < n_steps) load(nxt, nxt % NSTAGE);
    cp_async_commit();

    const __nv_bfloat16* a = s_a + (it % NSTAGE) * T::A_ELEMS;
    const __nv_bfloat16* w = s_w + (it % NSTAGE) * T::W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (wm * 16 + (lane & 15)) * A_LD + kk + (lane >> 4) * 8);
      const __nv_bfloat16* wrow = w + (kk + (lane & 15)) * T::W_LD + wn * T::WN;
      if constexpr (T::NT8 == 1) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, wrow);
        mma_bf16(acc[0], af, b0, b1);
      } else {
#pragma unroll
        for (int p = 0; p < T::NT8 / 2; ++p) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, wrow + p * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * p], af, bf[0], bf[1]);
          mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
        }
      }
    }
  }

  // c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < T::NT8; ++j) {
    const int n = wn * T::WN + j * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 16 + g + h * 8;
      if (m >= n_out) continue;
      float* o = out + (long long)m * cout;
      if (n < cout) o[n] = acc[j][2 * h];
      if (n + 1 < cout) o[n + 1] = acc[j][2 * h + 1];
    }
  }
}

template <int P>
int launch_mma(const void* feats, const int* nbr, int n_out, int K, const void* weights,
               float* out, int cin, int cout, int cout8, cudaStream_t stream) {
  using T = Tile<P>;
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_conv_mma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  sparse_conv_mma_kernel<P><<<(n_out + BM - 1) / BM, T::THREADS, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), nbr, n_out, K,
      static_cast<const __nv_bfloat16*>(weights), out, cin, cout, cout8);
  return (int)cudaGetLastError();
}

}  // namespace

// features (n_in, cin) and weights (K, cin, cout8) are float32 (is_bf16 = 0;
// then cout8 = cout) or bfloat16 (is_bf16 = 1; cin and cout8 multiples of 8,
// cout8 >= cout, the weights' extra columns ignored); nbr (K, n_out) int32;
// out (n_out, cout) float32. Launches on `stream`, allocates nothing,
// returns cudaGetLastError().
extern "C" int sparse_conv_fwd(const void* feats, int is_bf16, const int* nbr, int n_out, int K,
                               const void* weights, float* out, int cin, int cout, int cout8,
                               void* stream) {
  if (n_out == 0) return 0;
  if (K > KMAX || K <= 0 || cin <= 0 || cout <= 0 || cout > 256 || cout8 < cout)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && (cin % 8 != 0 || cout8 % 8 != 0)) return (int)cudaErrorInvalidValue;
  int cout_p = 8;
  while (cout_p < cout) cout_p <<= 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (cout_p) {
      case 8: return launch_mma<8>(feats, nbr, n_out, K, weights, out, cin, cout, cout8, s);
      case 16: return launch_mma<16>(feats, nbr, n_out, K, weights, out, cin, cout, cout8, s);
      case 32: return launch_mma<32>(feats, nbr, n_out, K, weights, out, cin, cout, cout8, s);
      case 64: return launch_mma<64>(feats, nbr, n_out, K, weights, out, cin, cout, cout8, s);
      case 128: return launch_mma<128>(feats, nbr, n_out, K, weights, out, cin, cout, cout8, s);
      case 256: return launch_mma<256>(feats, nbr, n_out, K, weights, out, cin, cout, cout8, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const float* f = static_cast<const float*>(feats);
  const float* w = static_cast<const float*>(weights);
  switch (cout_p) {
    case 8: launch_f32<8>(f, nbr, n_out, K, w, out, cin, cout, s); break;
    case 16: launch_f32<16>(f, nbr, n_out, K, w, out, cin, cout, s); break;
    case 32: launch_f32<32>(f, nbr, n_out, K, w, out, cin, cout, s); break;
    case 64: launch_f32<64>(f, nbr, n_out, K, w, out, cin, cout, s); break;
    case 128: launch_f32<128>(f, nbr, n_out, K, w, out, cin, cout, s); break;
    case 256: launch_f32<256>(f, nbr, n_out, K, w, out, cin, cout, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
