// ROI trilinear sampler (kernel K4 of the port).
//
// Replaces the Pallas TPU kernel btcdet_tpu/ops/pallas_interp.py::_interp_call
// (kernel body _make_kernel), the ConvHead x_combine sampler. It computes,
// for every roi r and sample s, the trilinear interpolation of the dense
// channels-last volume vol[b_r] (D, H, W, C) at the float voxel coordinate
// (z, y, x) = zyx[r, s]:
//     out[r, s, :] = sum over the 8 corners of w_corner * vol[b_r, corner, :]
// with w = |1-|z-z0-dz|| * |1-|y-y0-dy|| * |1-|x-x0-dx|| (z0 = floor(z)),
// corners outside the volume weighing 0 (and not read), and 0 for invalid
// samples and for rois of no frame in [0, B). This is
// pallas_interp._xla_reference_pool, summed in f32 and rounded once to the
// volume's dtype at the store.
//
// The TPU kernel only sees a 24x24-cell window around each roi and drops
// corners outside it (pallas_interp.window_miss_count); here every corner is
// read from the volume, so nothing is dropped.
//
// Design: a gather-and-stream kernel. The volume is read in place through
// its (b, z, y, x) element strides (the channel stride is 1), so the
// permuted view that SparseTensor.dense() returns needs no copy. Each
// thread owns 8 channels of a sample: one 16-byte load per corner (a uint4
// of bf16, or two float4 of f32) and one 16-byte streaming store (__stcs)
// of the result; C/8 neighbouring threads cover a sample's row, so a
// corner read is one contiguous C-wide row. A thread handles one sample's
// 8 channels: its 8 corner loads (16 in f32) are all in flight before the
// first add, and the rows stay packed until they are added. Occupancy,
// not loads per thread, sets the rate: one sample a thread needs 64
// registers, so 4 blocks share an SM; two or four samples a thread (16 or
// 32 loads in flight) needed 148 or 255 and ran about twice as long.
// The corner offsets, in-volume flags and weights of a block's samples are
// computed once per sample (not once per 8-channel group) into shared
// memory. Weights and sums follow the twin's f32 arithmetic step by step
// in round-to-nearest (no contraction into FMAs), corners in the twin's
// order, so the output equals the plain version's bit for bit: an FMA
// would move a sum that cancels to near 0 by more than a bf16 ulp of it.
// The 1-D grid walks the rois in order and each roi's samples in order,
// so consecutive blocks read one roi's cells while they sit in L2.
//
// What bounds it on an H100: memory. The output (R*S*C in the volume's
// dtype) is the largest stream; the touched cells are a few MB, read
// mostly from L1 / L2 since a roi's samples are spatially clustered.
//
// The gradient with respect to the volume (trilinear_pool_bwd, below) is
// the scatter transpose of the same sampling, which the JAX package runs
// as the XLA VJP of pallas_interp._xla_reference_pool (pallas_interp.py
// :284-288): each valid sample (r, s) adds g[r, s, :] * w_corner to each of
// its in-volume corner cells. It is written as an ordered gather so that
// two calls give the same bits (float atomics would add in another order
// each run):
//   1. one thread per sample writes, per corner (entry e = 8 * sample +
//      corner), the corner's linear cell (or the sentinel M = B*D*H*W for
//      a corner outside the volume or an invalid sample) and its weight in
//      the forward's f32 arithmetic, and counts entries per cell with an
//      integer atomic (one for a warp's lanes of one cell) whose ticket is
//      the entry's slot in its cell;
//   2. an exclusive scan of the counts gives each cell's segment, and each
//      entry goes to its slot there (an order that differs from run to run);
//   3. each segment is sorted by entry index (bitonic): one warp per cell
//      in shared memory for segments of at most SEG_CAP entries, a block
//      per longer segment (in shared memory up to LONG_CAP entries), so a
//      cell's entries come in ascending (r, s, corner) order on every call;
//   4. one warp per cell of the volume walks its sorted segment, lanes
//      over channels with 16-byte loads of g (4 loads in flight per lane;
//      for C <= 128 the warp's lane groups take every other entry and are
//      added in group order at the end), sums g * w in f32 with a Kahan
//      compensation, and writes the cell's row once, in the volume's dtype
//      (0 for an untouched cell): one rounding, as the plain version's
//      .to(dtype). No float atomics anywhere.
// Its floor is memory (g and the whole output volume); on the train call
// most of its time is step 4, whose warps walk segments of hundreds to a
// few thousand entries (overlapping rois) one row after another.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

// 8 channels of one row as loaded (16 bytes of bf16, or 32 of f32); they
// are widened to f32 only when added, so a thread's loads in flight cost 4
// (8) registers each
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
};
template <>
struct Raw8<float> {
  float4 a, b;
};

__device__ __forceinline__ Raw8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Raw8<float> load8(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)), __ldg(reinterpret_cast<const float4*>(p) + 1)};
}

__device__ __forceinline__ void widen(const Raw8<__nv_bfloat16>& r, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void widen(const Raw8<float>& r, float (&f)[8]) {
  f[0] = r.a.x; f[1] = r.a.y; f[2] = r.a.z; f[3] = r.a.w;
  f[4] = r.b.x; f[5] = r.b.y; f[6] = r.b.z; f[7] = r.b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

// |1 - |c - c0 - d||, in the twin's order of f32 operations
__device__ __forceinline__ float axis_weight(float c, float c0, int d) {
  return fabsf(__fsub_rn(1.f, fabsf(__fsub_rn(__fsub_rn(c, c0), (float)d))));
}

// one item a thread: (sample, 8-channel group)
template <typename T>
__global__ void __launch_bounds__(NT) trilinear_pool_kernel(
    const T* __restrict__ vol, int B, int D, int H, int W, int C, long long sb, long long sz,
    long long sy, long long sx, const float* __restrict__ zyx,
    const uint8_t* __restrict__ valid, const int* __restrict__ roi_b, int S, int tiles,
    T* __restrict__ out) {
  // per sample of the block: the element offset of its corner (z0, y0, x0),
  // which corners are read (bit j = dz*4 + dy*2 + dx; none for an invalid
  // sample), and the 8 corner weights
  __shared__ long long s_base[NT];
  __shared__ unsigned s_mask[NT];
  __shared__ float4 s_w[NT][2];

  const int G = C / 8;               // threads per sample
  const int spt = NT / G;            // samples per block
  const int r = blockIdx.x / tiles;
  const int s0 = (blockIdx.x - r * tiles) * spt;
  const int b = roi_b[r];
  const bool roi_ok = b >= 0 && b < B;

  // the setup of each sample, once (not once per 8-channel group)
  if (threadIdx.x < spt) {
    const int i = threadIdx.x;
    const int s = s0 + i;
    const long long rs = (long long)r * S + s;
    unsigned m = 0;
    float w[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    long long base = 0;
    if (s < S && roi_ok && valid[rs] != 0) {
      const float z = zyx[rs * 3 + 0], y = zyx[rs * 3 + 1], x = zyx[rs * 3 + 2];
      const float z0 = floorf(z), y0 = floorf(y), x0 = floorf(x);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int dz = j >> 2, dy = (j >> 1) & 1, dx = j & 1;
        const float zf = z0 + dz, yf = y0 + dy, xf = x0 + dx;
        if (zf >= 0.f && zf < (float)D && yf >= 0.f && yf < (float)H && xf >= 0.f &&
            xf < (float)W)
          m |= 1u << j;
        w[j] = __fmul_rn(__fmul_rn(axis_weight(z, z0, dz), axis_weight(y, y0, dy)),
                         axis_weight(x, x0, dx));
      }
      base = b * sb + (long long)z0 * sz + (long long)y0 * sy + (long long)x0 * sx;
    }
    s_base[i] = base;
    s_mask[i] = m;
    s_w[i][0] = make_float4(w[0], w[1], w[2], w[3]);
    s_w[i][1] = make_float4(w[4], w[5], w[6], w[7]);
  }
  __syncthreads();

  const int sl = threadIdx.x / G;
  const int grp = threadIdx.x - sl * G;
  if (sl >= spt || s0 + sl >= S) return;
  const unsigned inb = s_mask[sl];
  const long long base = s_base[sl] + grp * 8;

  // every in-volume corner is in flight before the first add
  Raw8<T> v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (inb >> j & 1) v[j] = load8(vol + base + (j >> 2) * sz + ((j >> 1) & 1) * sy + (j & 1) * sx);

  const float4 wa = s_w[sl][0], wb = s_w[sl][1];
  const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (!(inb >> j & 1)) continue;
    float f[8];
    widen(v[j], f);
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(f[c], w[j]));
  }
  store8(out + ((long long)r * S + s0 + sl) * C + grp * 8, acc);
}

template <typename T>
int launch(const void* vol, int B, int D, int H, int W, int C, const long long* strides,
           const float* zyx, const uint8_t* valid, const int* roi_b, int R, int S, void* out,
           cudaStream_t stream) {
  const int spt = NT / (C / 8);
  const int tiles = (S + spt - 1) / spt;
  const long long blocks = (long long)R * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  trilinear_pool_kernel<T><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const T*>(vol), B, D, H, W, C, strides[0], strides[1], strides[2], strides[3],
      zyx, valid, roi_b, S, tiles, static_cast<T*>(out));
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------- backward

constexpr unsigned FULL = 0xffffffffu;
constexpr int BW_NT = 256;                           // threads of the entry kernels
constexpr int SCAN_NT = 1024;                        // 32 warps
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_NT * SCAN_ITEMS;
constexpr int SUM_NT = 128;                          // 4 warps, one cell each
constexpr int SUM_UNROLL = 4;                        // g rows in flight per lane
constexpr int SEG_CAP = 1024;                        // longest segment a warp sorts in shared memory
constexpr int LONG_NT = 256;                         // threads of the long-segment sort
constexpr int LONG_CAP = 4096;                       // longest segment it sorts in shared memory
constexpr int LONG_BLOCKS = 1056;                     // 8 an SM

// exclusive scan of v over a block of SCAN_NT threads; *total gets the sum
__device__ __forceinline__ int block_scan_excl(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, t, o);
      if (lane >= o) t += y;
    }
    warp_sums[lane] = t;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[31];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// partials[b] = sum of data over block b's SCAN_TILE items
__global__ void __launch_bounds__(SCAN_NT) scan_reduce_kernel(const int* __restrict__ data,
                                                              long long n,
                                                              int* __restrict__ partials) {
  const long long base = (long long)blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  int s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k)
    if (base + k < n) s += data[base + k];
  int total;
  block_scan_excl(s, &total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// exclusive scan of partials[0, P) in place, one block, chunk by chunk
__global__ void __launch_bounds__(SCAN_NT) scan_partials_kernel(int* __restrict__ partials,
                                                                long long P) {
  int carry = 0;
  for (long long c0 = 0; c0 < P; c0 += SCAN_TILE) {
    const long long base = c0 + threadIdx.x * SCAN_ITEMS;
    int v[SCAN_ITEMS], s = 0;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      v[k] = base + k < P ? partials[base + k] : 0;
      s += v[k];
    }
    int total;
    int ex = block_scan_excl(s, &total) + carry;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (base + k < P) partials[base + k] = ex;
      ex += v[k];
    }
    carry += total;
  }
}

// data <- exclusive scan of data, block b starting from partials[b]
__global__ void __launch_bounds__(SCAN_NT) scan_apply_kernel(int* __restrict__ data, long long n,
                                                             const int* __restrict__ partials) {
  const long long base = (long long)blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS], s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = base + k < n ? data[base + k] : 0;
    s += v[k];
  }
  int total;
  int ex = block_scan_excl(s, &total) + partials[blockIdx.x];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (base + k < n) data[base + k] = ex;
    ex += v[k];
  }
}

int exclusive_scan(int* data, long long n, int* partials, cudaStream_t s) {
  const long long P = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (P == 0) return 0;
  if (P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_reduce_kernel<<<(unsigned)P, SCAN_NT, 0, s>>>(data, n, partials);
  scan_partials_kernel<<<1, SCAN_NT, 0, s>>>(partials, P);
  scan_apply_kernel<<<(unsigned)P, SCAN_NT, 0, s>>>(data, n, partials);
  return 0;
}

// step 1: per (sample, corner) entry its cell (M when out), its slot among
// the cell's entries (an integer atomic's ticket, one atomic for the lanes
// of a warp with the same cell: any order) and weight; cnt[cell] counts
// the entries of each cell
__global__ void __launch_bounds__(BW_NT) corner_entries_kernel(
    const float* __restrict__ zyx, const uint8_t* __restrict__ valid,
    const int* __restrict__ roi_b, int B, int D, int H, int W, long long RS, int S, int M,
    int* __restrict__ keys, int* __restrict__ slots, float* __restrict__ wts,
    int* __restrict__ cnt) {
  const long long rs = (long long)blockIdx.x * BW_NT + threadIdx.x;
  const bool live = rs < RS;
  const int b = live ? roi_b[rs / S] : -1;
  const bool ok = live && b >= 0 && b < B && valid[rs] != 0;
  float z = 0.f, y = 0.f, x = 0.f;
  if (ok) {
    z = zyx[rs * 3 + 0];
    y = zyx[rs * 3 + 1];
    x = zyx[rs * 3 + 2];
  }
  const float z0 = floorf(z), y0 = floorf(y), x0 = floorf(x);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int dz = j >> 2, dy = (j >> 1) & 1, dx = j & 1;
    const float zf = z0 + dz, yf = y0 + dy, xf = x0 + dx;
    int key = M;
    float w = 0.f;
    if (ok && zf >= 0.f && zf < (float)D && yf >= 0.f && yf < (float)H && xf >= 0.f &&
        xf < (float)W) {
      key = (int)((((long long)b * D + (int)zf) * H + (int)yf) * W + (int)xf);
      w = __fmul_rn(__fmul_rn(axis_weight(z, z0, dz), axis_weight(y, y0, dy)),
                    axis_weight(x, x0, dx));
    }
    const unsigned peers = __match_any_sync(FULL, live ? key : -1);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (live && key != M && lane == leader) base = atomicAdd(cnt + key, __popc(peers));
    base = __shfl_sync(FULL, base, leader);
    if (live) {
      const long long e = rs * 8 + j;
      keys[e] = key;
      slots[e] = base + __popc(peers & ((1u << lane) - 1u));
      wts[e] = w;
    }
  }
}

// step 2: each in-volume entry to its slot of its cell's segment (off holds
// the exclusive scan of the counts, off[M + 1] the number of long
// segments); the first entry of a segment longer than SEG_CAP lists it
__global__ void __launch_bounds__(BW_NT) entry_scatter_kernel(
    const int* __restrict__ keys, const int* __restrict__ slots, long long N, int M,
    int* __restrict__ off, int* __restrict__ vals, int* __restrict__ long_cells) {
  const long long e = (long long)blockIdx.x * BW_NT + threadIdx.x;
  if (e >= N) return;
  const int key = keys[e];
  if (key == M) return;
  const int slot = slots[e];
  const int start = off[key];
  vals[start + slot] = (int)e;
  if (slot == 0 && off[key + 1] - start > SEG_CAP) long_cells[atomicAdd(off + M + 1, 1)] = key;
}

// ascending sort of a[0, n) (distinct keys) by a bitonic network whose
// merges flip the lower half, so every comparator puts the smaller key at
// the lower index and the positions past n act as +inf and never move.
// The threads tid, tid + nt, ... of a group of nt take the comparators;
// sync() separates the steps.
template <typename Sync>
__device__ __forceinline__ void bitonic_sort(int* a, int n, int tid, int nt, Sync sync) {
  int P = 2;
  while (P < n) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      for (int p = tid; p < P / 2; p += nt) {
        const int i = ((p & ~(h - 1)) << 1) | (p & (h - 1));
        const int j = h == k >> 1 ? i ^ (k - 1) : i + h;  // the flip, then half-cleaners
        if (j < n) {
          const int x = a[i], y = a[j];
          if (x > y) {
            a[i] = y;
            a[j] = x;
          }
        }
      }
      sync();
    }
  }
}

struct BlockSync {
  __device__ void operator()() const { __syncthreads(); }
};
struct WarpSync {
  __device__ void operator()() const { __syncwarp(); }
};

// step 3: the segments longer than SEG_CAP, one block each: in shared
// memory up to LONG_CAP entries, in place in global memory beyond
__global__ void __launch_bounds__(LONG_NT) long_segment_sort_kernel(
    const int* __restrict__ off, int M, const int* __restrict__ long_cells, int* vals) {
  __shared__ int buf[LONG_CAP];
  const int n_long = off[M + 1];
  for (int i = blockIdx.x; i < n_long; i += gridDim.x) {
    const int cell = long_cells[i];
    const int start = off[cell], n = off[cell + 1] - start;
    int* seg = vals + start;
    if (n > LONG_CAP) {
      bitonic_sort(seg, n, threadIdx.x, LONG_NT, BlockSync{});
      continue;
    }
    for (int k = threadIdx.x; k < n; k += LONG_NT) buf[k] = seg[k];
    __syncthreads();
    bitonic_sort(buf, n, threadIdx.x, LONG_NT, BlockSync{});
    for (int k = threadIdx.x; k < n; k += LONG_NT) seg[k] = buf[k];
    __syncthreads();
  }
}

// compensated (Kahan) f32 accumulation, in round-to-nearest, no FMAs
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// step 4: one warp per cell; a segment of at most SEG_CAP entries is
// sorted by entry in the warp's shared buffer (longer ones were sorted by
// step 3). Lanes of a group of Lp (a power of two, Lp * 8 channels a pass)
// cover the channels, the 32 / Lp groups take every (32 / Lp)-th entry of
// the segment and are added in group order
template <typename T>
__global__ void __launch_bounds__(SUM_NT) cell_sum_kernel(
    const T* __restrict__ g, int C, int Lp, const int* __restrict__ off, const int* vals,
    const float* __restrict__ wts, int M, T* __restrict__ out) {
  __shared__ int buf[SUM_NT / 32][SEG_CAP];
  const int lane = threadIdx.x & 31;
  const long long cell = (long long)blockIdx.x * (SUM_NT / 32) + (threadIdx.x >> 5);
  if (cell >= M) return;  // the whole warp
  const int start = off[cell], n = off[cell + 1] - start;
  const int* seg = vals + start;
  if (n > 1 && n <= SEG_CAP) {
    int* a = buf[threadIdx.x >> 5];
    for (int i = lane; i < n; i += 32) a[i] = seg[i];
    __syncwarp();
    bitonic_sort(a, n, lane, 32, WarpSync{});
    seg = a;
  }
  const int groups = 32 / Lp, q = lane / Lp, u = lane - q * Lp;
  for (int ch0 = 0; ch0 < C; ch0 += Lp * 8) {
    const int ch = ch0 + u * 8;
    const bool ch_ok = ch < C;
    float s[8], c[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = c[k] = 0.f;
    for (int k0 = 0; k0 < n; k0 += 32) {
      const int nb = min(32, n - k0);
      int e = 0;
      float we = 0.f;
      if (lane < nb) {
        e = seg[k0 + lane];
        we = wts[e];
      }
      for (int t0 = 0; t0 < nb; t0 += groups * SUM_UNROLL) {
        Raw8<T> v[SUM_UNROLL];
        float wv[SUM_UNROLL];
        bool okv[SUM_UNROLL];
#pragma unroll
        for (int k = 0; k < SUM_UNROLL; ++k) {
          const int t = t0 + k * groups + q;
          const int et = __shfl_sync(FULL, e, t & 31);
          wv[k] = __shfl_sync(FULL, we, t & 31);
          okv[k] = t < nb && ch_ok;
          if (okv[k]) v[k] = load8(g + (long long)(et >> 3) * C + ch);
        }
#pragma unroll
        for (int k = 0; k < SUM_UNROLL; ++k) {
          if (!okv[k]) continue;
          float f[8];
          widen(v[k], f);
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) kahan_add(s[cc], c[cc], __fmul_rn(f[cc], wv[k]));
        }
      }
    }
    // the groups' compensated sums, added in group order into group 0
    float acc[8], comp[8];
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      acc[cc] = __fsub_rn(s[cc], c[cc]);
      comp[cc] = 0.f;
    }
    for (int gq = 1; gq < groups; ++gq) {
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float other = __shfl_sync(FULL, __fsub_rn(s[cc], c[cc]), (lane + gq * Lp) & 31);
        kahan_add(acc[cc], comp[cc], other);
      }
    }
    if (q == 0 && ch_ok) {
      float r[8];
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) r[cc] = __fsub_rn(acc[cc], comp[cc]);
      store8(out + cell * C + ch, r);
    }
  }
}

// the workspace's parts, each 256-byte aligned
struct BwdWorkspace {
  int *keys, *slots, *vals, *off, *long_cells, *partials;
  float* wts;
  long long bytes;
};

BwdWorkspace carve(char* base, long long RS, long long M) {
  const long long N = RS * 8;
  BwdWorkspace w{};
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  w.keys = reinterpret_cast<int*>(take(4 * N));
  w.slots = reinterpret_cast<int*>(take(4 * N));
  w.vals = reinterpret_cast<int*>(take(4 * N));
  w.wts = reinterpret_cast<float*>(take(4 * N));
  w.off = reinterpret_cast<int*>(take(4 * (M + 2)));
  w.long_cells = reinterpret_cast<int*>(take(4 * (N / (SEG_CAP + 1) + 1)));
  w.partials = reinterpret_cast<int*>(take(4 * ((M + 1 + SCAN_TILE - 1) / SCAN_TILE)));
  w.bytes = at;
  return w;
}

template <typename T>
int launch_bwd(const void* g, int B, int D, int H, int W, int C, const float* zyx,
               const uint8_t* valid, const int* roi_b, long long RS, int S,
               const BwdWorkspace& ws, void* out, cudaStream_t s) {
  const long long M = (long long)B * D * H * W;
  const long long N = RS * 8;
  // the counts, then (scanned) the segments' offsets, and the long segments' count
  cudaError_t err = cudaMemsetAsync(ws.off, 0, 4 * (M + 2), s);
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    corner_entries_kernel<<<(unsigned)((RS + BW_NT - 1) / BW_NT), BW_NT, 0, s>>>(
        zyx, valid, roi_b, B, D, H, W, RS, S, (int)M, ws.keys, ws.slots, ws.wts, ws.off);
  const int e = exclusive_scan(ws.off, M + 1, ws.partials, s);
  if (e) return e;
  if (N > 0) {
    entry_scatter_kernel<<<(unsigned)((N + BW_NT - 1) / BW_NT), BW_NT, 0, s>>>(
        ws.keys, ws.slots, N, (int)M, ws.off, ws.vals, ws.long_cells);
    long_segment_sort_kernel<<<LONG_BLOCKS, LONG_NT, 0, s>>>(ws.off, (int)M, ws.long_cells,
                                                             ws.vals);
  }
  int lanes = C / 8 < 32 ? C / 8 : 32;
  int Lp = 1;
  while (Lp < lanes) Lp <<= 1;
  const long long blocks = (M + SUM_NT / 32 - 1) / (SUM_NT / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cell_sum_kernel<T><<<(unsigned)blocks, SUM_NT, 0, s>>>(
      static_cast<const T*>(g), C, Lp, ws.off, ws.vals, ws.wts, (int)M, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// vol (B, D, H, W, C) float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1) with
// element strides sb, sz, sy, sx (multiples of 8) and a unit channel
// stride, C a multiple of 8 and at most 2048, 16-byte aligned; zyx (R, S,
// 3) float32; valid (R, S) uint8; roi_b (R,) int32; out (R, S, C)
// contiguous, in the volume's dtype. Launches on `stream`, allocates
// nothing, returns cudaGetLastError().
extern "C" int trilinear_pool_fwd(const void* vol, int is_bf16, int B, int D, int H, int W,
                                  int C, long long sb, long long sz, long long sy, long long sx,
                                  const float* zyx, const uint8_t* valid, const int* roi_b,
                                  int R, int S, void* out, void* stream) {
  if (R == 0 || S == 0) return 0;
  if (C <= 0 || C % 8 != 0 || C > 8 * NT) return (int)cudaErrorInvalidValue;
  const long long strides[4] = {sb, sz, sy, sx};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(vol, B, D, H, W, C, strides, zyx, valid, roi_b, R, S, out, s);
  return launch<float>(vol, B, D, H, W, C, strides, zyx, valid, roi_b, R, S, out, s);
}


// Bytes of the workspace trilinear_pool_bwd needs for R*S samples and a
// volume of M = B*D*H*W cells.
extern "C" long long trilinear_pool_bwd_workspace(long long RS, long long M) {
  return carve(nullptr, RS, M).bytes;
}

// Gradient of trilinear_pool with respect to the volume. g (R, S, C) in the
// volume's dtype (float32: is_bf16 = 0, bfloat16: 1), contiguous and
// 16-byte aligned, C a multiple of 8 and at most 2048; zyx, valid, roi_b as
// for trilinear_pool_fwd; ws a device workspace of
// trilinear_pool_bwd_workspace(R * S, B*D*H*W) bytes; out (B, D, H, W, C)
// contiguous, in the volume's dtype, every element written. B*D*H*W and
// 8*R*S must stay below 2^31 - 1. Launches on `stream`, allocates nothing,
// returns cudaGetLastError() (or the first error met).
extern "C" int trilinear_pool_bwd(const void* g, int is_bf16, int B, int D, int H, int W, int C,
                                  const float* zyx, const uint8_t* valid, const int* roi_b,
                                  int R, int S, void* ws, long long ws_bytes, void* out,
                                  void* stream) {
  const long long M = (long long)B * D * H * W;
  const long long RS = (long long)R * S;
  if (C <= 0 || C % 8 != 0 || C > 2048 || M <= 0 || M >= 0x7fffffffLL ||
      RS * 8 >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const BwdWorkspace w = carve(static_cast<char*>(ws), RS, M);
  if (w.bytes > ws_bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(g, B, D, H, W, C, zyx, valid, roi_b, RS, S, w, out, s);
  return launch_bwd<float>(g, B, D, H, W, C, zyx, valid, roi_b, RS, S, w, out, s);
}
