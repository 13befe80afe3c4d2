// Sparse 3D convolution weight gradient (kernel K3 of the port), and the
// per-tap compaction of the neighbour map that it reads.
//
// Replaces the Pallas TPU kernel btcdet_tpu/ops/pallas_conv.py::_fused_call_dw
// (kernel body _make_kernel_dw). For a conv whose forward is
//     out[m, :] = sum over the taps k with nbr[k, m] >= 0 of in[nbr[k, m], :] @ W[k]
// (sparse_conv.cu, over the (K, M) neighbour map of sparse_nbr.cu, which the
// forward saves for the backward) it computes
//     dW[k] = sum over the rows m with nbr[k, m] >= 0 of in[nbr[k, m], :]^T @ g[m, :]
// over every match: there are no windows, so nothing is dropped. No key is
// searched here: the map holds every match.
//
// Compaction (sparse_conv_dw_pairs): for every tap, the list of its matched
// (input row, output row) pairs in ascending output row, written to a (K, M)
// pair buffer (its capacity) with the count per tap. Two launches, no host
// synchronisation: a count per (tap, block of 1024 rows), then a scatter in
// which each block sums the counts of the blocks before it and writes its
// pairs in row order. The contraction then runs over matched pairs only
// (about half of a subm conv's (tap, row) slots are empty).
//
// Contraction (sparse_conv_dw): each tap's pair list is cut into n_chunks
// chunks of rows_per_chunk pairs, both fixed by the shapes alone. One block
// per (Cin x Cout tile, tap, chunk) with any pair writes the chunk's
// partial tile to a workspace; a second pass sums, for each element, the
// partials of the chunks that hold pairs, in chunk order. Every sum runs in
// a fixed order and no float atomics are used, so the result is the same
// bit for bit from run to run. The wrapper bounds the workspace.
//
// Two bodies, picked by the features' dtype:
//
// bf16 (the model's path): tensor cores, with the TPU kernel's rounding:
// the gathered rows and g are bf16 (the wrapper rounds g, pallas_conv.py
// `gt = g_ref[...].astype(jnp.bfloat16)`) and the products accumulate in
// f32. A block tile is BM input x BN output channels (16-128 each, from
// Cin and Cout); its warps own 32 x 64 sub-tiles (smaller for narrow
// tiles), so every element is summed by one warp in a fixed order. The
// block walks its pairs 32 at a time through a 3-stage cp.async ring: the
// 32 input rows (BM channels) and the 32 rows of g (BN channels) are
// gathered with 16-byte cp.async copies, a pair past the chunk's end or a
// channel past Cin / Cout by the src-size-0 form, which zero-fills. The pair
// indices themselves arrive by cp.async two steps ahead of the gathers
// that use them, so no gather waits on an index load. The contraction runs
// over the pairs: A = the gathered rows (pairs x Cin) transposed, read
// with ldmatrix.trans, against G = the rows of g (pairs x Cout), read with
// ldmatrix.trans as K1 reads its weights, through
// mma.sync.m16n8k16 bf16 -> f32. Rows are padded by 16 bytes in shared
// memory, so ldmatrix has no bank conflicts. The wrapper pads a Cin or a
// Cout that is not a multiple of 8 (conv1's 6, conv2_combine_0's 34).
//
// f32 (BTCDET_F32=1 and the f32 checks): exact f32 FMAs on the CUDA cores,
// g not rounded, one block per (32 x 64 tile, tap, chunk) over the same
// pair lists, 8 outputs a thread.
//
// What bounds it on an H100: the work a run's data needs (the matched
// input rows and the rows of g once, dW once; 2*Cin*Cout flops a match) is
// a few microseconds. The bf16 body pays instead the L2 traffic of
// gathering each pair's rows once per channel tile, the partial tiles of
// the chunks (written, then read by the reduction), and at narrow widths
// the launches and the dependent latency of each 32-pair step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KMAX = 27;  // most taps a kernel may have (3x3x3)

// ----------------------------------------------------------- compaction

constexpr int P_NT = 256;           // threads per compaction block
constexpr int P_PER = 4;            // consecutive rows of one tap per thread
constexpr int P_CB = P_NT * P_PER;  // rows per compaction block

// Exclusive scan of v over the block (P_NT threads); *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int s_warp[P_NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  __syncthreads();  // s_warp may still be read by an earlier call
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < P_NT / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < P_NT / 32) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[P_NT / 32 - 1];
  return (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
}

// blk_cnt[k, b] = matches of tap k among rows [b * P_CB, (b + 1) * P_CB)
__global__ void __launch_bounds__(P_NT) pair_count_kernel(const int* __restrict__ nbr,
                                                          int n_out, int* __restrict__ blk_cnt,
                                                          int nb) {
  const int k = blockIdx.y, b = blockIdx.x;
  const int* row = nbr + (long long)k * n_out;
  const int m0 = b * P_CB + threadIdx.x * P_PER;
  int c = 0;
#pragma unroll
  for (int j = 0; j < P_PER; ++j) c += (m0 + j < n_out && row[m0 + j] >= 0);
  int total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) blk_cnt[k * nb + b] = total;
}

// pairs[k, p] = (input row, output row) of tap k's p-th match in row order;
// tap_cnt[k] = its number of matches
__global__ void __launch_bounds__(P_NT) pair_scatter_kernel(
    const int* __restrict__ nbr, int n_out, const int* __restrict__ blk_cnt, int nb,
    int2* __restrict__ pairs, int* __restrict__ tap_cnt) {
  const int k = blockIdx.y, b = blockIdx.x;
  int before = 0;
  for (int j = threadIdx.x; j < b; j += P_NT) before += blk_cnt[k * nb + j];
  int off;
  block_exclusive_scan(before, &off);
  const int* row = nbr + (long long)k * n_out;
  const int m0 = b * P_CB + threadIdx.x * P_PER;
  int idx[P_PER];
  int c = 0;
#pragma unroll
  for (int j = 0; j < P_PER; ++j) {
    idx[j] = m0 + j < n_out ? row[m0 + j] : -1;
    c += idx[j] >= 0;
  }
  int total;
  int2* out = pairs + (long long)k * n_out + off + block_exclusive_scan(c, &total);
#pragma unroll
  for (int j = 0; j < P_PER; ++j)
    if (idx[j] >= 0) *out++ = make_int2(idx[j], m0 + j);
  if (b == nb - 1 && threadIdx.x == 0) tap_cnt[k] = off + total;
}

// ------------------------------------------------------------ the ring

constexpr int BR = 32;      // pairs per step
constexpr int NSTAGE = 3;   // cp.async ring depth of the gathered rows
constexpr int IRING = 4;    // slots of pair indices (steps it+2 .. it+4 live)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// async copies; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async_ca16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_ca8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// ----------------------------------------------------------- bf16 body

template <int BM, int BN>
struct DwTile {
  static constexpr int WM = BM < 32 ? BM : 32;  // input channels of one warp
  static constexpr int WN = BN < 64 ? BN : 64;  // output channels of one warp
  static constexpr int WARPS_M = BM / WM;
  static constexpr int THREADS = 32 * WARPS_M * (BN / WN);
  static constexpr int MT = WM / 16;            // its m16 tiles
  static constexpr int NT8 = WN / 8;            // its n8 tiles
  static constexpr int A_LD = BM + 8;           // row of A in shared memory (bf16)
  static constexpr int G_LD = BN + 8;           // row of G in shared memory (bf16)
  static constexpr int A_ELEMS = BR * A_LD;
  static constexpr int G_ELEMS = BR * G_LD;
  static constexpr int SMEM = NSTAGE * (A_ELEMS + G_ELEMS) * 2 + IRING * BR * 8;
};

// feats (N, cin_k) bf16, g (n_out, cout_k) bf16, cin_k and cout_k multiples
// of 8; part (chunks, K, cin, cout) f32.
template <int BM, int BN>
__global__ void __launch_bounds__(DwTile<BM, BN>::THREADS) dw_mma_kernel(
    const __nv_bfloat16* __restrict__ feats, const __nv_bfloat16* __restrict__ g,
    const int2* __restrict__ pairs, const int* __restrict__ tap_cnt, int n_out,
    float* __restrict__ part, int cin_k, int cout_k, int cin, int cout, int rows_per_chunk) {
  using T = DwTile<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_g = s_a + NSTAGE * T::A_ELEMS;
  int2* s_p = reinterpret_cast<int2*>(s_g + NSTAGE * T::G_ELEMS);  // [IRING][BR]

  const int co_tiles = (cout_k + BN - 1) / BN;
  const int ci0 = (blockIdx.x / co_tiles) * BM;
  const int co0 = (blockIdx.x % co_tiles) * BN;
  const int k = blockIdx.y;
  const int chunk = blockIdx.z;
  const int beg = chunk * rows_per_chunk;
  const int end = min(beg + rows_per_chunk, tap_cnt[k]);
  if (beg >= end) return;  // the reduction reads no partial of this chunk
  const int n_steps = (end - beg + BR - 1) / BR;
  const int2* tp = pairs + (long long)k * n_out;
  const int tid = threadIdx.x;

  auto load_idx = [&](int step) {
    if (tid < BR) {
      const int pos = beg + step * BR + tid;
      const bool ok = pos < end;
      cp_async_ca8(s_p + (step % IRING) * BR + tid, ok ? tp + pos : tp, ok ? 8 : 0);
    }
  };
  // gather step `step` into ring slot `slot`; its indices have landed
  auto load = [&](int step, int slot) {
    const int2* pr = s_p + (step % IRING) * BR;
    const int left = end - (beg + step * BR);
    __nv_bfloat16* a = s_a + slot * T::A_ELEMS;
    constexpr int ACP = BM / 8;  // 16-byte copies per A row
    for (int e = tid; e < BR * ACP; e += T::THREADS) {
      const int r = e / ACP;
      const int c = ci0 + (e - r * ACP) * 8;
      const bool ok = r < left && c < cin_k;
      cp_async_ca16(a + r * T::A_LD + (c - ci0),
                    ok ? feats + (long long)pr[r].x * cin_k + c : feats, ok ? 16 : 0);
    }
    __nv_bfloat16* gs = s_g + slot * T::G_ELEMS;
    constexpr int GCP = BN / 8;  // 16-byte copies per G row
    for (int e = tid; e < BR * GCP; e += T::THREADS) {
      const int r = e / GCP;
      const int n = co0 + (e - r * GCP) * 8;
      const bool ok = r < left && n < cout_k;
      cp_async_cg16(gs + r * T::G_LD + (n - co0),
                    ok ? g + (long long)pr[r].y * cout_k + n : g, ok ? 16 : 0);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % T::WARPS_M;
  const int wn = warp / T::WARPS_M;
  float acc[T::MT][T::NT8][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // group j carries the gathers of step j and the indices of step j + 2
  load_idx(0);
  load_idx(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_steps) load(s, s);
    load_idx(s + 2);
    cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // step `it` and the indices of step it + 2 have landed
    const int nxt = it + NSTAGE - 1;
    if (nxt < n_steps) load(nxt, nxt % NSTAGE);
    load_idx(nxt + 2);
    cp_async_commit();

    const __nv_bfloat16* a = s_a + (it % NSTAGE) * T::A_ELEMS;
    const __nv_bfloat16* gs = s_g + (it % NSTAGE) * T::G_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BR; kk += 16) {
      // A^T fragments: matrix q of the x4 is (channels +8*(q&1), pairs +8*(q>>1))
      uint32_t af[T::MT][4];
      const int q = lane >> 3;
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldmatrix_x4_trans(af[mt], a + (kk + (q >> 1) * 8 + (lane & 7)) * T::A_LD + wm * T::WM +
                                      mt * 16 + (q & 1) * 8);
      const __nv_bfloat16* grow = gs + (kk + (lane & 15)) * T::G_LD + wn * T::WN;
#pragma unroll
      for (int p = 0; p < T::NT8 / 2; ++p) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, grow + p * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          mma_bf16(acc[mt][2 * p], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * p + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }

  // c0, c1: input channel g, output channels 2t, 2t+1; c2, c3: channel g + 8
  float* out = part + ((long long)chunk * gridDim.y + k) * cin * cout;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int j = 0; j < T::NT8; ++j) {
      const int co = co0 + wn * T::WN + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + wm * T::WM + mt * 16 + gq + h * 8;
        if (ci >= cin) continue;
        float* o = out + (long long)ci * cout;
        if (co < cout) o[co] = acc[mt][j][2 * h];
        if (co + 1 < cout) o[co + 1] = acc[mt][j][2 * h + 1];
      }
    }
}

template <int BM, int BN>
int launch_mma(const void* feats, const void* g, const int2* pairs, const int* tap_cnt,
               int n_out, int K, float* part, int n_chunks, int rows_per_chunk, int cin,
               int cin_k, int cout, int cout_k, cudaStream_t stream) {
  using T = DwTile<BM, BN>;
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw_mma_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(((cin_k + BM - 1) / BM) * ((cout_k + BN - 1) / BN), K, n_chunks);
  dw_mma_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), static_cast<const __nv_bfloat16*>(g), pairs,
      tap_cnt, n_out, part, cin_k, cout_k, cin, cout, rows_per_chunk);
  return (int)cudaGetLastError();
}

template <int BM>
int dispatch_bn(int bn, const void* feats, const void* g, const int2* pairs, const int* tap_cnt,
                int n_out, int K, float* part, int n_chunks, int rows, int cin, int cin_k,
                int cout, int cout_k, cudaStream_t s) {
  switch (bn) {
    case 16: return launch_mma<BM, 16>(feats, g, pairs, tap_cnt, n_out, K, part, n_chunks, rows, cin, cin_k, cout, cout_k, s);
    case 32: return launch_mma<BM, 32>(feats, g, pairs, tap_cnt, n_out, K, part, n_chunks, rows, cin, cin_k, cout, cout_k, s);
    case 64: return launch_mma<BM, 64>(feats, g, pairs, tap_cnt, n_out, K, part, n_chunks, rows, cin, cin_k, cout, cout_k, s);
    default: return launch_mma<BM, 128>(feats, g, pairs, tap_cnt, n_out, K, part, n_chunks, rows, cin, cin_k, cout, cout_k, s);
  }
}

// ------------------------------------------------------------ f32 body

constexpr int NT = 256;          // threads per block
constexpr int TM = 32;           // pairs per step
constexpr int TCI = 32;          // input channels per block tile
constexpr int TCO = 64;          // output channels per block tile
constexpr int TX = 16;           // threads along the output channels
constexpr int TY = NT / TX;      // threads along the input channels
constexpr int RI = TCI / TY;     // input channels per thread
constexpr int RO = TCO / TX;     // output channels per thread

__global__ void __launch_bounds__(NT) dw_f32_kernel(
    const float* __restrict__ feats, const float* __restrict__ g, const int2* __restrict__ pairs,
    const int* __restrict__ tap_cnt, int n_out, float* __restrict__ part, int cin, int cout,
    int rows_per_chunk) {
  __shared__ int2 s_pr[TM];
  __shared__ float s_a[TM][TCI + 1];
  __shared__ float s_g[TM][TCO + 1];

  const int co_tiles = (cout + TCO - 1) / TCO;
  const int ci0 = (blockIdx.x / co_tiles) * TCI;
  const int co0 = (blockIdx.x % co_tiles) * TCO;
  const int k = blockIdx.y;
  const int chunk = blockIdx.z;
  const int beg = chunk * rows_per_chunk;
  const int end = min(beg + rows_per_chunk, tap_cnt[k]);
  if (beg >= end) return;
  const int2* tp = pairs + (long long)k * n_out;
  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid - ty * TX;

  float acc[RI][RO];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RO; ++j) acc[i][j] = 0.f;

  for (int p0 = beg; p0 < end; p0 += TM) {
    if (tid < TM) s_pr[tid] = p0 + tid < end ? tp[p0 + tid] : make_int2(-1, -1);
    __syncthreads();
    for (int e = tid; e < TM * TCI; e += NT) {
      const int r = e / TCI;
      const int c = e - r * TCI;
      const int i = s_pr[r].x;
      s_a[r][c] = (i >= 0 && ci0 + c < cin) ? feats[(long long)i * cin + ci0 + c] : 0.f;
    }
    for (int e = tid; e < TM * TCO; e += NT) {
      const int r = e / TCO;
      const int o = e - r * TCO;
      const int m = s_pr[r].y;
      s_g[r][o] = (m >= 0 && co0 + o < cout) ? g[(long long)m * cout + co0 + o] : 0.f;
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

  float* out = part + ((long long)chunk * gridDim.y + k) * cin * cout;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int ci = ci0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      const int co = co0 + tx + j * TX;
      if (ci < cin && co < cout) out[(long long)ci * cout + co] = acc[i][j];
    }
  }
}

// ------------------------------------------------------------ reduction

// dw[e] = sum over the chunks c that hold pairs of tap k(e), in order, of ws[c][e]
__global__ void dw_reduce_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                 const int* __restrict__ tap_cnt, int n_chunks,
                                 int rows_per_chunk, long long per_tap, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int busy = min(n_chunks, (tap_cnt[e / per_tap] + rows_per_chunk - 1) / rows_per_chunk);
  float s = 0.f;
  for (int c = 0; c < busy; ++c) s += ws[(long long)c * n + e];
  dw[e] = s;
}

int pow2_tile(int c) {
  int t = 16;
  while (t < c && t < 128) t <<= 1;
  return t;
}

}  // namespace

// nbr (K, n_out) int32 neighbour map; blk_cnt holds K * ceil(n_out / 1024)
// ints of scratch; pairs (K, n_out) int2 gets each tap's matched
// (input row, output row) pairs in row order, first tap_cnt[k] of row k
// valid. Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
extern "C" int sparse_conv_dw_pairs(const int* nbr, int n_out, int K, int* blk_cnt, int* pairs,
                                    int* tap_cnt, void* stream) {
  if (n_out == 0) return 0;
  if (K > KMAX || K <= 0) return (int)cudaErrorInvalidValue;
  const int nb = (n_out + P_CB - 1) / P_CB;
  const dim3 grid(nb, K);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  pair_count_kernel<<<grid, P_NT, 0, s>>>(nbr, n_out, blk_cnt, nb);
  pair_scatter_kernel<<<grid, P_NT, 0, s>>>(nbr, n_out, blk_cnt, nb,
                                            reinterpret_cast<int2*>(pairs), tap_cnt);
  return (int)cudaGetLastError();
}

// feats (n_in, cin_k) and g (n_out, cout_k): bfloat16 (is_bf16 = 1; cin_k,
// cout_k multiples of 8, the extra channels ignored) or float32 (is_bf16 =
// 0; cin_k = cin, cout_k = cout); pairs / tap_cnt from sparse_conv_dw_pairs;
// dw (K, cin, cout) float32, zeroed by the caller when n_chunks == 1 (then
// the single partial is dw itself and ws is unused); with n_chunks > 1, ws
// holds n_chunks * K * cin * cout floats of scratch. Pairs
// [c * rows_per_chunk, (c + 1) * rows_per_chunk) of a tap form chunk c.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int sparse_conv_dw(const void* feats, int is_bf16, const void* g, const int* pairs,
                              const int* tap_cnt, int n_out, int K, float* dw, float* ws,
                              int n_chunks, int rows_per_chunk, int cin, int cin_k, int cout,
                              int cout_k, void* stream) {
  if (n_out == 0) return 0;
  if (K > KMAX || K <= 0 || cin <= 0 || cout <= 0 || cin_k < cin || cout_k < cout ||
      n_chunks <= 0 || n_chunks > 65535 || rows_per_chunk <= 0 ||
      (long long)n_chunks * rows_per_chunk < n_out)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && (cin_k % 8 != 0 || cout_k % 8 != 0)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int2* pr = reinterpret_cast<const int2*>(pairs);
  float* part = n_chunks == 1 ? dw : ws;
  int err;
  if (is_bf16) {
    const int bm = pow2_tile(cin_k), bn = pow2_tile(cout_k);
    switch (bm) {
      case 16: err = dispatch_bn<16>(bn, feats, g, pr, tap_cnt, n_out, K, part, n_chunks, rows_per_chunk, cin, cin_k, cout, cout_k, s); break;
      case 32: err = dispatch_bn<32>(bn, feats, g, pr, tap_cnt, n_out, K, part, n_chunks, rows_per_chunk, cin, cin_k, cout, cout_k, s); break;
      case 64: err = dispatch_bn<64>(bn, feats, g, pr, tap_cnt, n_out, K, part, n_chunks, rows_per_chunk, cin, cin_k, cout, cout_k, s); break;
      default: err = dispatch_bn<128>(bn, feats, g, pr, tap_cnt, n_out, K, part, n_chunks, rows_per_chunk, cin, cin_k, cout, cout_k, s); break;
    }
  } else {
    const dim3 grid(((cin + TCI - 1) / TCI) * ((cout + TCO - 1) / TCO), K, n_chunks);
    dw_f32_kernel<<<grid, NT, 0, s>>>(static_cast<const float*>(feats),
                                      static_cast<const float*>(g), pr, tap_cnt, n_out, part,
                                      cin, cout, rows_per_chunk);
    err = (int)cudaGetLastError();
  }
  if (err != 0 || n_chunks == 1) return err;
  const long long per_tap = (long long)cin * cout;
  const long long n = K * per_tap;
  const int threads = 256;
  dw_reduce_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      ws, dw, tap_cnt, n_chunks, rows_per_chunk, per_tap, n);
  return (int)cudaGetLastError();
}
