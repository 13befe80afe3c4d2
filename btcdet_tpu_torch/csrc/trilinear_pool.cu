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
