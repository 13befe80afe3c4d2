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
// its in-volume corner cells. Float atomics would add in another order on
// every run, so it is an ordered gather whose order is fixed by
// construction: each cell sums its entries (e = 8 * sample + corner)
// ascending by e, in chunks of at most CH entries, each chunk Kahan-
// compensated in round-to-nearest f32, the chunks' values added in chunk
// order (Kahan again), and the row rounded once to the volume's dtype.
// cuda_interp.trilinear_pool_volume_grad_ordered is this order in plain
// PyTorch, equal bit for bit.
//
// What bounds it on an H100: the function needs g's rows once (170 MB in
// bf16 on the flagship train call) and the whole output volume written
// once (90 MB): 0.08 ms of HBM time. The kernel moves more: every sample's
// g row is read once per corner cell (5.3 M gathers of 256 B, mostly from
// L2), its f32 Kahan sums take 5 float operations per (entry, channel),
// and grouping 5.3 M entries by cell costs a sort. The design:
//   1. corner_entries: one thread a sample writes its 8 entries' cell keys
//      (a sentinel past the volume) and weights, and the first sort pass's
//      digit histogram of its tile (shared-memory integer atomics). Keys
//      walk tiles of 8 x 8 cells in (y, x) over all z, and 2 x 2 x 2 cubes
//      inside a tile, so cells that share samples have near keys.
//   2. an LSD radix sort by key, 10-bit digits (2 passes at the flagship's
//      422 400 keys): per pass a digit histogram of each 8 192-entry tile,
//      their scan, and a stable scatter that ranks a tile's entries in
//      shared memory (__match_any_sync per 32 entries, warps in order) and
//      writes each digit's run out contiguously. Stable, so each cell's
//      entries stay ascending by e; it carries (e, weight) pairs.
//   3. segment_bounds: each cell's segment from where the sorted keys
//      change (no atomics); a scan of the cells' entry, chunk, partial-row
//      and multi-chunk counts; chunk_list: the (cell, chunk) work list,
//      ordered by cube, then chunk, then cell, so the chunks summed side by
//      side read the same samples' rows; zero_fill: one coalesced pass of
//      0s over the untouched cells' rows.
//   4. chunk_sum: one thread a (chunk, 8 channels), 16-byte loads of g, 4
//      rows in flight, no chunk longer than CH: a cell of thousands of
//      entries is summed by dozens of threads at once. A cell of one chunk
//      writes its row; longer cells write f32 partial rows.
//   5. chunk_combine: one thread a (cell of several chunks, 8 channels)
//      adds the partial rows in chunk order and writes the row once.
// Bit for bit on a repeat, no float atomics, nothing allocated: the
// workspace (trilinear_pool_bwd_workspace) holds keys, weights, pairs,
// offsets, the work list and the partial rows.

#include <algorithm>

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
constexpr int SCAN_NT = 1024;                        // 32 warps
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_NT * SCAN_ITEMS;
constexpr int RADIX_BITS = 10;                       // digit of one sort pass
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SORT_NT = 512;                         // 16 warps
constexpr int SORT_WARPS = SORT_NT / 32;
constexpr int SORT_ROUNDS = 16;                      // 32-entry rounds of a warp
constexpr int SORT_TILE = SORT_NT * SORT_ROUNDS;     // entries of a sort block
constexpr int ENT_NT = SORT_TILE / 8;                // samples of an entry block: one sort tile
constexpr int CH = 64;                               // most entries of a chunk
constexpr int NT_1D = 256;                           // threads of the one-pass kernels
constexpr int SUM_NT = 512;                          // threads of the chunk sum
constexpr int SUM_UNROLL = 4;                        // g rows in flight per thread
constexpr int COMBINE_UNROLL = 4;                    // partial rows in flight per thread
constexpr int TILE = 8;                              // cells of a key tile along y and x

// The cells in the order of their sort key: tiles of 8 x 8 cells in (y, x)
// over every z (D rounded up to even), tile after tile (frame-major); in a
// tile, cubes of 2 x 2 x 2 cells (z, then y, then x), the 8 cells of a
// cube consecutive. A sample's corners are the cells of one such cube
// where its corner (z0, y0, x0) has even coordinates, and of neighbouring
// cubes otherwise, so the chunks summed close in time share g rows. Keys
// of cells past D, H or W exist but never hold an entry.
struct KeyGeom {
  int D, H, W, ty, tx;  // tiles along y and x
  int tile_keys;        // (D rounded up to even) * TILE * TILE

  __device__ __forceinline__ int key(int b, int z, int y, int x) const {
    const int tile = (b * ty + y / TILE) * tx + x / TILE;
    const int ly = y % TILE, lx = x % TILE;
    const int cube = ((z >> 1) * (TILE / 2) + (ly >> 1)) * (TILE / 2) + (lx >> 1);
    return tile * tile_keys + cube * 8 + (z & 1) * 4 + (ly & 1) * 2 + (lx & 1);
  }
  // the linear (b, z, y, x) cell of a key that holds entries
  __device__ __forceinline__ long long cell(int k) const {
    const int tile = k / tile_keys, r = k - tile * tile_keys;
    const int cube = r >> 3;
    const int lx = (cube % (TILE / 2)) * 2 + (r & 1);
    const int ly = (cube / (TILE / 2) % (TILE / 2)) * 2 + ((r >> 1) & 1);
    const int z = (cube / (TILE * TILE / 4)) * 2 + ((r >> 2) & 1);
    const int x = tile % tx * TILE + lx, y = tile / tx % ty * TILE + ly, b = tile / tx / ty;
    return (((long long)b * D + z) * H + y) * W + x;
  }
};

KeyGeom key_geom(int D, int H, int W) {
  return {D, H, W, (H + TILE - 1) / TILE, (W + TILE - 1) / TILE, (D + 1) / 2 * 2 * TILE * TILE};
}

// keys of a volume: every cell has one below the returned count
long long key_count(int B, int D, int H, int W) {
  const KeyGeom k = key_geom(D, H, W);
  return (long long)B * k.ty * k.tx * k.tile_keys;
}

// per cell key: its entries, chunks, partial rows (the chunks of a cell of
// more than one) and whether it has more than one chunk; scanned together
struct Seg {
  int n, nch, np, nm;
};
__device__ __forceinline__ Seg operator+(const Seg& a, const Seg& b) {
  return {a.n + b.n, a.nch + b.nch, a.np + b.np, a.nm + b.nm};
}
__device__ __forceinline__ Seg operator-(const Seg& a, const Seg& b) {
  return {a.n - b.n, a.nch - b.nch, a.np - b.np, a.nm - b.nm};
}
__device__ __forceinline__ int shfl_up(int v, int o) { return __shfl_up_sync(FULL, v, o); }
__device__ __forceinline__ Seg shfl_up(const Seg& v, int o) {
  return {shfl_up(v.n, o), shfl_up(v.nch, o), shfl_up(v.np, o), shfl_up(v.nm, o)};
}

// exclusive scan of v over a block of NT threads; *total gets the sum
template <typename V, int NT = SCAN_NT>
__device__ __forceinline__ V block_scan_excl(V v, V* total) {
  __shared__ V warp_sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = shfl_up(x, o);
    if (lane >= o) x = x + y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    V t = lane < NT / 32 ? warp_sums[lane] : V{};
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const V y = shfl_up(t, o);
      if (lane >= o) t = t + y;
    }
    warp_sums[lane] = t;
  }
  __syncthreads();
  const V before = warp ? warp_sums[warp - 1] : V{};
  *total = warp_sums[NT / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// an int array scanned in place
struct IntScan {
  int* data;
  __device__ int load(long long i) const { return data[i]; }
  __device__ void store(long long i, int v) const { data[i] = v; }
};

// the cell keys' segments [lo, hi) scanned into entry, chunk, partial-row
// and multi-chunk-cell offsets (key `last` = the sentinel's, counted 0:
// its offsets are the totals)
struct SegScan {
  const int *lo, *hi;
  int *off, *choff, *poff, *moff;
  long long last;
  __device__ Seg load(long long i) const {
    const int n = i < last ? hi[i] - lo[i] : 0;
    const int nch = (n + CH - 1) / CH;
    return {n, nch, nch > 1 ? nch : 0, nch > 1 ? 1 : 0};
  }
  __device__ void store(long long i, const Seg& v) const {
    off[i] = v.n;
    choff[i] = v.nch;
    poff[i] = v.np;
    moff[i] = v.nm;
  }
};

// partials[b] = sum of the items of block b's SCAN_TILE
template <typename V, typename Op>
__global__ void __launch_bounds__(SCAN_NT) scan_reduce_kernel(Op op, long long n,
                                                              V* __restrict__ partials) {
  const long long base = (long long)blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  V s{};
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k)
    if (base + k < n) s = s + op.load(base + k);
  V total;
  block_scan_excl(s, &total);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// exclusive scan of partials[0, P) in place, one block, chunk by chunk
template <typename V>
__global__ void __launch_bounds__(SCAN_NT) scan_partials_kernel(V* __restrict__ partials,
                                                                long long P) {
  V carry{};
  for (long long c0 = 0; c0 < P; c0 += SCAN_TILE) {
    const long long base = c0 + threadIdx.x * SCAN_ITEMS;
    V v[SCAN_ITEMS], s{};
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      v[k] = base + k < P ? partials[base + k] : V{};
      s = s + v[k];
    }
    V total;
    V ex = block_scan_excl(s, &total) + carry;
#pragma unroll
    for (int k = 0; k < SCAN_ITEMS; ++k) {
      if (base + k < P) partials[base + k] = ex;
      ex = ex + v[k];
    }
    carry = carry + total;
  }
}

// item i <- the exclusive scan at i, block b starting from partials[b]
template <typename V, typename Op>
__global__ void __launch_bounds__(SCAN_NT) scan_apply_kernel(Op op, long long n,
                                                             const V* __restrict__ partials) {
  const long long base = (long long)blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_ITEMS;
  V v[SCAN_ITEMS], s{};
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    v[k] = base + k < n ? op.load(base + k) : V{};
    s = s + v[k];
  }
  V total;
  V ex = block_scan_excl(s, &total) + partials[blockIdx.x];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    if (base + k < n) op.store(base + k, ex);
    ex = ex + v[k];
  }
}

template <typename V, typename Op>
int exclusive_scan(Op op, long long n, V* partials, cudaStream_t s) {
  const long long P = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (P == 0) return 0;
  if (P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_reduce_kernel<V, Op><<<(unsigned)P, SCAN_NT, 0, s>>>(op, n, partials);
  scan_partials_kernel<V><<<1, SCAN_NT, 0, s>>>(partials, P);
  scan_apply_kernel<V, Op><<<(unsigned)P, SCAN_NT, 0, s>>>(op, n, partials);
  return 0;
}


// step 1: one thread a sample writes the sort keys of its 8 (sample,
// corner) entries, e = 8 * sample + corner: the corner's cell key, or the
// sentinel Mkey for a corner outside the volume or an invalid sample, and
// their weights in the forward's f32 arithmetic; and,
// a block being one sort tile, the tile's histogram of the first sort
// pass's digit (sentinels included; shared-memory integer atomics)
__global__ void __launch_bounds__(ENT_NT) corner_entries_kernel(
    const float* __restrict__ zyx, const uint8_t* __restrict__ valid,
    const int* __restrict__ roi_b, int B, KeyGeom kg, long long RS, int S, int Mkey,
    int* __restrict__ keys, float* __restrict__ wts, int* __restrict__ hist, int nblk) {
  __shared__ int h[RADIX];
  for (int d = threadIdx.x; d < RADIX; d += ENT_NT) h[d] = 0;
  __syncthreads();
  const long long rs = (long long)blockIdx.x * ENT_NT + threadIdx.x;
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
  int key[8];
  float w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int dz = j >> 2, dy = (j >> 1) & 1, dx = j & 1;
    const float zf = z0 + dz, yf = y0 + dy, xf = x0 + dx;
    key[j] = Mkey;
    w[j] = 0.f;
    if (ok && zf >= 0.f && zf < (float)kg.D && yf >= 0.f && yf < (float)kg.H && xf >= 0.f &&
        xf < (float)kg.W) {
      key[j] = kg.key(b, (int)zf, (int)yf, (int)xf);
      w[j] = __fmul_rn(__fmul_rn(axis_weight(z, z0, dz), axis_weight(y, y0, dy)),
                       axis_weight(x, x0, dx));
    }
    if (live) atomicAdd(h + (key[j] & (RADIX - 1)), 1);
  }
  if (live) {
    int4* p = reinterpret_cast<int4*>(keys + rs * 8);
    p[0] = make_int4(key[0], key[1], key[2], key[3]);
    p[1] = make_int4(key[4], key[5], key[6], key[7]);
    float4* q = reinterpret_cast<float4*>(wts + rs * 8);
    q[0] = make_float4(w[0], w[1], w[2], w[3]);
    q[1] = make_float4(w[4], w[5], w[6], w[7]);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += ENT_NT)
    hist[(long long)d * nblk + blockIdx.x] = h[d];
}

// a later sort pass's histogram of its digit, one column per sort tile
__global__ void __launch_bounds__(SORT_NT) radix_upsweep_kernel(const int* __restrict__ keys,
                                                                long long n, int shift, int nblk,
                                                                int* __restrict__ hist) {
  __shared__ int h[RADIX];
  for (int d = threadIdx.x; d < RADIX; d += SORT_NT) h[d] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * SORT_TILE;
  for (int i = threadIdx.x; i < SORT_TILE; i += SORT_NT) {
    const long long p = base + i;
    if (p < n) atomicAdd(h + ((keys[p] >> shift) & (RADIX - 1)), 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += SORT_NT) hist[(long long)d * nblk + blockIdx.x] = h[d];
}

// shared memory of radix_downsweep_kernel: per-warp digit counts, the
// digits' block-local starts, the tile's keys and their slots in the tile,
// in digit order
constexpr int DOWN_SMEM = SORT_WARPS * RADIX * 2 + RADIX * 4 + SORT_TILE * 6;

// one stable counting-sort pass by the digit at `shift`: hist holds the
// exclusive scan of the (digit, tile) counts, digit-major, so a tile's
// entries of digit d start at hist[d * nblk + tile]. Inside a tile, warp w
// ranks its 512 entries in order, 32 a round (lanes of one digit by
// __match_any_sync, earlier rounds by a per-warp count), and the warps'
// counts are added in warp order: the pass keeps the entries' order within
// a digit. The tile is put in digit order in shared memory first, so each
// digit's run is written out contiguously. The values are (entry, weight
// bits) pairs; pairs_in null (the first pass): the entry is the position
// and its weight wts[position]
__global__ void __launch_bounds__(SORT_NT) radix_downsweep_kernel(
    const int* __restrict__ keys_in, const int2* __restrict__ pairs_in,
    const float* __restrict__ wts, long long n, int shift, int nblk,
    const int* __restrict__ hist, int* __restrict__ keys_out, int2* __restrict__ pairs_out) {
  extern __shared__ int4 smem4[];
  unsigned short(*s_cnt)[RADIX] = reinterpret_cast<unsigned short(*)[RADIX]>(smem4);
  int* s_base = reinterpret_cast<int*>(s_cnt + SORT_WARPS);
  int* s_key = s_base + RADIX;
  unsigned short* s_slot = reinterpret_cast<unsigned short*>(s_key + SORT_TILE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < SORT_WARPS * RADIX; i += SORT_NT) (&s_cnt[0][0])[i] = 0;
  __syncthreads();
  const long long tile0 = (long long)blockIdx.x * SORT_TILE;
  const int slot0 = warp * (SORT_ROUNDS * 32) + lane;
  int key[SORT_ROUNDS], rank[SORT_ROUNDS];
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const long long p = tile0 + slot0 + r * 32;
    key[r] = p < n ? keys_in[p] : -1;
  }
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    const int d = key[r] < 0 ? -1 : (key[r] >> shift) & (RADIX - 1);
    const unsigned peers = __match_any_sync(FULL, d);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (lane == leader && d >= 0) {
      before = s_cnt[warp][d];
      s_cnt[warp][d] = (unsigned short)(before + __popc(peers));
    }
    rank[r] = __shfl_sync(FULL, before, leader) + __popc(peers & lt);
    __syncwarp();
  }
  __syncthreads();
  // per digit: the warps' starts within the digit, then the digits'
  // block-local starts (a block scan of the digits' totals)
  constexpr int DPT = RADIX / SORT_NT;  // digits a thread
  int tot[DPT], sum = 0;
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    const int d = threadIdx.x * DPT + j;
    int run = 0;
#pragma unroll
    for (int w = 0; w < SORT_WARPS; ++w) {
      const int c = s_cnt[w][d];
      s_cnt[w][d] = (unsigned short)run;
      run += c;
    }
    tot[j] = run;
    sum += run;
  }
  int total;
  int start = block_scan_excl<int, SORT_NT>(sum, &total);
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    s_base[threadIdx.x * DPT + j] = start;
    start += tot[j];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < SORT_ROUNDS; ++r) {
    if (key[r] < 0) continue;
    const int d = (key[r] >> shift) & (RADIX - 1);
    const int at = s_base[d] + s_cnt[warp][d] + rank[r];
    s_key[at] = key[r];
    s_slot[at] = (unsigned short)(slot0 + r * 32);
  }
  __syncthreads();
  // s_base becomes the shift from a digit-ordered slot to its global position
  for (int d = threadIdx.x; d < RADIX; d += SORT_NT)
    s_base[d] = hist[(long long)d * nblk + blockIdx.x] - s_base[d];
  __syncthreads();
  const int live = (int)min((long long)SORT_TILE, n - tile0);
  for (int i = threadIdx.x; i < live; i += SORT_NT) {
    const int k = s_key[i];
    const int pos = s_base[(k >> shift) & (RADIX - 1)] + i;
    const long long src = tile0 + s_slot[i];
    keys_out[pos] = k;
    pairs_out[pos] = pairs_in ? pairs_in[src] : make_int2((int)src, __float_as_int(wts[src]));
  }
}

// step 3: each cell key's segment [lo, hi) of the sorted entries, from
// where the sorted keys change (keys without entries keep lo = hi = 0)
__global__ void __launch_bounds__(NT_1D) segment_bounds_kernel(const int* __restrict__ keys,
                                                                long long n, int Mkey,
                                                                int* __restrict__ lo,
                                                                int* __restrict__ hi) {
  const long long p = (long long)blockIdx.x * NT_1D + threadIdx.x;
  if (p >= n) return;
  const int k = keys[p];
  if (k == Mkey) return;
  if (p == 0 || keys[p - 1] != k) lo[k] = (int)p;
  if (p + 1 == n || keys[p + 1] != k) hi[k] = (int)p + 1;
}

// the work lists, one thread a cube of 8 cell keys: every chunk as (cell
// key, chunk in the cell), in the cube's chunk range ordered by chunk,
// then cell (the cube's cells' first chunks, then their second ones, ...),
// so the chunks summed side by side cover the same stretch of samples;
// and the keys of the cells of more than one chunk
__global__ void __launch_bounds__(NT_1D) chunk_list_kernel(
    const int* __restrict__ choff, const int* __restrict__ moff, int Mkey,
    int2* __restrict__ work, int* __restrict__ multi_key) {
  const int c0 = (blockIdx.x * NT_1D + threadIdx.x) * 8;
  if (c0 >= Mkey) return;
  int q = choff[c0], nch[8], most = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    nch[i] = choff[c0 + i + 1] - choff[c0 + i];
    most = max(most, nch[i]);
    if (nch[i] > 1) multi_key[moff[c0 + i]] = c0 + i;
  }
  for (int k = 0; k < most; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k < nch[i]) work[q++] = make_int2(c0 + i, k);
}

// 0 in every row of a cell without entries, 16 bytes a thread, in the
// output's order
template <typename T>
__global__ void __launch_bounds__(NT_1D) zero_fill_kernel(const int* __restrict__ off,
                                                          KeyGeom kg, long long units,
                                                          int row_units, T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * NT_1D;
  for (long long u = (long long)blockIdx.x * NT_1D + threadIdx.x; u < units; u += stride) {
    long long cell = u / row_units;
    const int x = (int)(cell % kg.W);
    cell /= kg.W;
    const int y = (int)(cell % kg.H);
    cell /= kg.H;
    const int z = (int)(cell % kg.D);
    const int k = kg.key((int)(cell / kg.D), z, y, x);
    if (off[k + 1] == off[k]) __stcs(reinterpret_cast<uint4*>(out) + u, make_uint4(0, 0, 0, 0));
  }
}

// compensated (Kahan) f32 accumulation, in round-to-nearest, no FMAs
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// step 4: one thread a (chunk, 8 channels), over the work list in a
// grid-stride loop, so the resident threads sum neighbouring chunks. The
// chunk's entries (at most CH, ascending by entry) are summed in order,
// g[sample] * weight (the weight beside the entry in the sorted pairs),
// Kahan in f32, SUM_UNROLL g rows in flight. A cell of one chunk writes
// its row (rounded once to the volume's dtype), a longer cell the chunk's
// value s - c, in f32, to its partial row.
template <typename T>
__global__ void __launch_bounds__(SUM_NT) chunk_sum_kernel(
    const T* __restrict__ g, int C, const int* __restrict__ off,
    const int* __restrict__ choff, const int* __restrict__ poff, const int2* __restrict__ work,
    const int2* __restrict__ pairs, int Mkey, KeyGeom kg, float* __restrict__ partial,
    T* __restrict__ out) {
  const int slices = C / 8;
  const long long items = (long long)choff[Mkey] * slices;
  const long long stride = (long long)gridDim.x * SUM_NT;
  for (long long it = (long long)blockIdx.x * SUM_NT + threadIdx.x; it < items; it += stride) {
    const long long q = it / slices;
    const int ch = (int)(it - q * slices) * 8;
    const int2 wk = work[q];
    const int c = wk.x, k = wk.y, nch = choff[c + 1] - choff[c];
    const int begin = off[c] + k * CH, len = min(CH, off[c + 1] - begin);
    float s[8], cp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = cp[i] = 0.f;
    for (int t0 = 0; t0 < len; t0 += SUM_UNROLL) {
      int2 pr[SUM_UNROLL];
#pragma unroll
      for (int u = 0; u < SUM_UNROLL; ++u)
        pr[u] = t0 + u < len ? pairs[begin + t0 + u] : make_int2(-1, 0);
      Raw8<T> v[SUM_UNROLL];
#pragma unroll
      for (int u = 0; u < SUM_UNROLL; ++u)
        if (pr[u].x >= 0) v[u] = load8(g + (long long)(pr[u].x >> 3) * C + ch);
#pragma unroll
      for (int u = 0; u < SUM_UNROLL; ++u) {
        if (pr[u].x < 0) continue;
        const float w = __int_as_float(pr[u].y);
        float f[8];
        widen(v[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) kahan_add(s[i], cp[i], __fmul_rn(f[i], w));
      }
    }
    float r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = __fsub_rn(s[i], cp[i]);
    if (nch == 1) {
      store8(out + kg.cell(c) * C + ch, r);
    } else {
      float4* p = reinterpret_cast<float4*>(partial + ((long long)poff[c] + k) * C + ch);
      p[0] = make_float4(r[0], r[1], r[2], r[3]);
      p[1] = make_float4(r[4], r[5], r[6], r[7]);
    }
  }
}

// step 5: one thread a (cell of more than one chunk, 8 channels): the
// chunks' values added in chunk order, Kahan in f32, and the row written
// once in the volume's dtype
template <typename T>
__global__ void __launch_bounds__(NT_1D) chunk_combine_kernel(
    int C, const int* __restrict__ choff, const int* __restrict__ poff,
    const int* __restrict__ moff, const int* __restrict__ multi_key, int Mkey, KeyGeom kg,
    const float* __restrict__ partial, T* __restrict__ out) {
  const int slices = C / 8;
  const long long items = (long long)moff[Mkey] * slices;
  const long long stride = (long long)gridDim.x * NT_1D;
  for (long long it = (long long)blockIdx.x * NT_1D + threadIdx.x; it < items; it += stride) {
    const long long mi = it / slices;
    const int ch = (int)(it - mi * slices) * 8;
    const int c = multi_key[mi];
    const int nch = choff[c + 1] - choff[c];
    const float* row = partial + (long long)poff[c] * C + ch;
    float s[8], cp[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = cp[i] = 0.f;
    for (int k0 = 0; k0 < nch; k0 += COMBINE_UNROLL) {
      float4 v[COMBINE_UNROLL][2];
#pragma unroll
      for (int u = 0; u < COMBINE_UNROLL; ++u)
        if (k0 + u < nch) {
          const float4* p = reinterpret_cast<const float4*>(row + (long long)(k0 + u) * C);
          v[u][0] = p[0];
          v[u][1] = p[1];
        }
#pragma unroll
      for (int u = 0; u < COMBINE_UNROLL; ++u) {
        if (k0 + u >= nch) continue;
        const float f[8] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                            v[u][1].x, v[u][1].y, v[u][1].z, v[u][1].w};
#pragma unroll
        for (int i = 0; i < 8; ++i) kahan_add(s[i], cp[i], f[i]);
      }
    }
    float r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = __fsub_rn(s[i], cp[i]);
    store8(out + kg.cell(c) * C + ch, r);
  }
}

// the workspace's parts, each 256-byte aligned
struct BwdWorkspace {
  int *keys_a, *keys_b, *lo, *hi, *off, *choff, *poff, *moff, *hist, *multi_key;
  int2 *pairs_a, *pairs_b, *work;
  float* wts;
  Seg* partials;
  float* partial;
  long long bytes;
};

long long sort_blocks(long long N) { return (N + SORT_TILE - 1) / SORT_TILE; }

BwdWorkspace carve(char* base, long long RS, long long Mkey, int C) {
  const long long N = RS * 8;
  const long long nblk = sort_blocks(N);
  BwdWorkspace w{};
  long long at = 0;
  auto take = [&](long long bytes) {
    char* p = base ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  w.keys_a = reinterpret_cast<int*>(take(4 * N));
  w.keys_b = reinterpret_cast<int*>(take(4 * N));
  w.wts = reinterpret_cast<float*>(take(4 * N));
  w.pairs_a = reinterpret_cast<int2*>(take(8 * N));
  w.pairs_b = reinterpret_cast<int2*>(take(8 * N));
  w.lo = reinterpret_cast<int*>(take(4 * 2 * (Mkey + 1)));  // lo, then hi: one memset
  w.hi = w.lo ? w.lo + Mkey + 1 : nullptr;
  w.off = reinterpret_cast<int*>(take(4 * (Mkey + 1)));
  w.choff = reinterpret_cast<int*>(take(4 * (Mkey + 1)));
  w.poff = reinterpret_cast<int*>(take(4 * (Mkey + 1)));
  w.moff = reinterpret_cast<int*>(take(4 * (Mkey + 1)));
  w.hist = reinterpret_cast<int*>(take(4 * RADIX * nblk));
  const long long P = (std::max(RADIX * nblk, Mkey + 1) + SCAN_TILE - 1) / SCAN_TILE;
  w.partials = reinterpret_cast<Seg*>(take(sizeof(Seg) * P));
  // chunks: at most N / CH full ones and one part-full one a cell with
  // entries; the cells of more than one chunk hold more than CH entries
  // each, and their chunks number less than 2 N / CH
  w.work = reinterpret_cast<int2*>(take(8 * (N / CH + std::min(N, Mkey) + 1)));
  w.multi_key = reinterpret_cast<int*>(take(4 * (N / (CH + 1) + 1)));
  w.partial = reinterpret_cast<float*>(take(4 * (2 * N / CH + 1) * (long long)C));
  w.bytes = at;
  return w;
}

// resident blocks of a grid-stride kernel: enough to fill every SM
template <typename K>
int fill_grid(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return std::max(1, sms * std::max(1, per_sm));
}

template <typename T>
int launch_bwd(const void* g, int B, int D, int H, int W, int C, const float* zyx,
               const uint8_t* valid, const int* roi_b, long long RS, int S,
               const BwdWorkspace& ws, void* out, cudaStream_t s) {
  const KeyGeom kg = key_geom(D, H, W);
  const long long Mkey = key_count(B, D, H, W);
  const long long N = RS * 8;
  const long long nblk = sort_blocks(N);
  cudaError_t err = cudaMemsetAsync(ws.lo, 0, 4 * 2 * (Mkey + 1), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(radix_downsweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DOWN_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int2* sorted = nullptr;
  if (N > 0) {
    // 1. keys and the first pass's histogram; 2. LSD radix passes by cell
    // key, stable, so each cell's entries stay ascending by entry
    corner_entries_kernel<<<(unsigned)nblk, ENT_NT, 0, s>>>(
        zyx, valid, roi_b, B, kg, RS, S, (int)Mkey, ws.keys_a, ws.wts, ws.hist, (int)nblk);
    int bits = 0;
    while ((Mkey >> bits) > 0) ++bits;  // the sentinel Mkey's bits
    const int* kin = ws.keys_a;
    int* kout = ws.keys_b;
    const int2* pin = nullptr;
    int2* pout = ws.pairs_a;
    for (int shift = 0; shift < bits; shift += RADIX_BITS) {
      if (shift > 0)
        radix_upsweep_kernel<<<(unsigned)nblk, SORT_NT, 0, s>>>(kin, N, shift, (int)nblk,
                                                                ws.hist);
      int e = exclusive_scan<int>(IntScan{ws.hist}, RADIX * nblk,
                                  reinterpret_cast<int*>(ws.partials), s);
      if (e) return e;
      radix_downsweep_kernel<<<(unsigned)nblk, SORT_NT, DOWN_SMEM, s>>>(
          kin, pin, ws.wts, N, shift, (int)nblk, ws.hist, kout, pout);
      sorted = pout;
      kin = kout;
      kout = kin == ws.keys_a ? ws.keys_b : ws.keys_a;
      pin = pout;
      pout = pout == ws.pairs_a ? ws.pairs_b : ws.pairs_a;
    }
    segment_bounds_kernel<<<(unsigned)((N + NT_1D - 1) / NT_1D), NT_1D, 0, s>>>(
        kin, N, (int)Mkey, ws.lo, ws.hi);
  }
  // the cells' entry, chunk, partial-row and multi-chunk-cell offsets
  const SegScan seg{ws.lo, ws.hi, ws.off, ws.choff, ws.poff, ws.moff, Mkey};
  const int e = exclusive_scan<Seg>(seg, Mkey + 1, ws.partials, s);
  if (e) return e;
  chunk_list_kernel<<<(unsigned)((Mkey / 8 + NT_1D - 1) / NT_1D), NT_1D, 0, s>>>(
      ws.choff, ws.moff, (int)Mkey, ws.work, ws.multi_key);
  const int row_units = C * (int)sizeof(T) / 16;
  zero_fill_kernel<T><<<fill_grid(zero_fill_kernel<T>, NT_1D), NT_1D, 0, s>>>(
      ws.off, kg, (long long)B * D * H * W * row_units, row_units, static_cast<T*>(out));
  if (sorted) {
    chunk_sum_kernel<T><<<fill_grid(chunk_sum_kernel<T>, SUM_NT), SUM_NT, 0, s>>>(
        static_cast<const T*>(g), C, ws.off, ws.choff, ws.poff, ws.work, sorted,
        (int)Mkey, kg, ws.partial, static_cast<T*>(out));
    chunk_combine_kernel<T><<<fill_grid(chunk_combine_kernel<T>, NT_1D), NT_1D, 0, s>>>(
        C, ws.choff, ws.poff, ws.moff, ws.multi_key, (int)Mkey, kg, ws.partial,
        static_cast<T*>(out));
  }
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


// Bytes of the workspace trilinear_pool_bwd needs for R*S samples, a
// (B, D, H, W) volume and C channels.
extern "C" long long trilinear_pool_bwd_workspace(long long RS, int B, int D, int H, int W,
                                                  int C) {
  return carve(nullptr, RS, key_count(B, D, H, W), C).bytes;
}

// Gradient of trilinear_pool with respect to the volume. g (R, S, C) in the
// volume's dtype (float32: is_bf16 = 0, bfloat16: 1), contiguous and
// 16-byte aligned, C a multiple of 8 and at most 2048; zyx, valid, roi_b as
// for trilinear_pool_fwd; ws a device workspace of
// trilinear_pool_bwd_workspace(R * S, B, D, H, W, C) bytes; out (B, D, H, W,
// C) contiguous and 16-byte aligned, in the volume's dtype, every element
// written. The cell keys (B*D*H*W with H and W rounded up to multiples of
// 8) and 8*R*S must stay below 2^31 - 1. Launches on `stream`, allocates
// nothing, returns cudaGetLastError() (or the first error met).
extern "C" int trilinear_pool_bwd(const void* g, int is_bf16, int B, int D, int H, int W, int C,
                                  const float* zyx, const uint8_t* valid, const int* roi_b,
                                  int R, int S, void* ws, long long ws_bytes, void* out,
                                  void* stream) {
  const long long Mkey = key_count(B, D, H, W);
  const long long RS = (long long)R * S;
  if (C <= 0 || C % 8 != 0 || C > 2048 || B <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      Mkey >= 0x7fffffffLL || RS * 8 >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const BwdWorkspace w = carve(static_cast<char*>(ws), RS, Mkey, C);
  if (w.bytes > ws_bytes) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(g, B, D, H, W, C, zyx, valid, roi_b, RS, S, w, out, s);
  return launch_bwd<float>(g, B, D, H, W, C, zyx, valid, roi_b, RS, S, w, out, s);
}
