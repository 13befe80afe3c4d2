// Furthest point sampling of a batch of frames, one launch a call: PV-RCNN's
// 2048 keypoints a frame, picked on the card with nothing read back.
//
// Replaces no Pallas kernel. The JAX package samples in XLA
// (btcdet_tpu/ops/group_ops.py::furthest_point_sample, a fori_loop), and the
// port first ran the same loop in plain PyTorch
// (ops/group_ops.py::furthest_point_sample_plain): npoint - 1 dependent steps
// of about six launches each, some 12 000 launches for 2048 keypoints, so the
// host's launch rate bounded it.
//
// What it computes, frame by frame, is the plain loop's indices exactly. The
// first pick is the frame's first valid point (0 when it has none). A valid
// point's running distance starts at 1e10, a masked point's sits at -1; each
// step lowers every valid point's distance to its squared distance from the
// last pick, formed as (dx * dx + dy * dy) + dz * dz with d = p - last, every
// operation rounded on its own as PyTorch rounds its elementwise ops (the
// __f*_rn intrinsics, so nothing is contracted into an FMA), and picks the
// point of the largest distance, the lowest index among equals. A masked
// point (-1) is never picked while a valid one (>= 0) is left.
//
// What bounds it: npoint - 1 steps, each a pass over the frame's N points and
// an argmax over them that the next step waits for. The arithmetic is about
// 10 operations a point a step (2.7 GFLOP for 8 frames of 16 384 points and
// 2048 picks: 40 us at the card's float32 rate), so the dependent chain of
// block-wide argmaxes, not throughput, bounds it. The design keeps the whole
// walk of a frame on chip: one block a frame, 1024 threads; the frame's
// coordinates in shared memory as three arrays (196 KB for 16 384 points; a
// frame too large for shared memory reads them from global memory, where L1
// and L2 hold them), each thread's running distances in registers, PER of
// them a thread (points t, t + 1024, ...); an argmax a step as one 64-bit key
// (the distance's bits in an order-preserving map, then the complement of the
// index, so the largest key is the largest distance at its lowest index)
// reduced by warp shuffles and one round through shared memory. A frame of
// more than 32 running distances a thread (over 32 768 points) keeps them in
// a scratch buffer in global memory instead (fps_kernel_large), each thread
// reading and writing only its own points; L2 holds them between steps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 1024;              // threads a block
constexpr int NWARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

// float bits mapped to an unsigned int of the same order
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long key_of(float v, int i) {
  return ((unsigned long long)ordered(v) << 32) | (unsigned)(0x7fffffff - i);
}

__device__ __forceinline__ int index_of(unsigned long long key) {
  return 0x7fffffff - (int)(unsigned)(key & 0xffffffffu);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, k, off);
    k = o > k ? o : k;
  }
  return k;
}

// (dx * dx + dy * dy) + dz * dz, each operation rounded on its own
__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx, float ly,
                                         float lz) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// the index of the block's largest key; every thread calls it and gets it
__device__ __forceinline__ int block_argmax(unsigned long long best, unsigned long long* wkeys) {
  const int t = threadIdx.x;
  best = warp_max(best);
  if ((t & 31) == 0) wkeys[t >> 5] = best;
  __syncthreads();
  if (t < 32) {
    unsigned long long k = t < NWARPS ? wkeys[t] : 0ull;
    k = warp_max(k);
    if (t == 0) wkeys[0] = k;
  }
  __syncthreads();
  const int i = index_of(wkeys[0]);
  __syncthreads();                          // wkeys[0] is written again next call
  return i;
}

template <int PER, bool SMEM>
__global__ void __launch_bounds__(NT) fps_kernel(const float* __restrict__ xyz,
                                                  const uint8_t* __restrict__ mask, int N,
                                                  int npoint, int64_t* __restrict__ out) {
  extern __shared__ float coords[];         // x[N], y[N], z[N] when SMEM
  __shared__ unsigned long long wkeys[NWARPS];
  __shared__ int first_valid;
  const int b = blockIdx.x, t = threadIdx.x;
  const float* fx = xyz + (size_t)b * N * 3;
  const uint8_t* fm = mask + (size_t)b * N;
  int64_t* fo = out + (size_t)b * npoint;
  float* sx = coords;
  float* sy = coords + N;
  float* sz = coords + 2 * N;
  if (t == 0) first_valid = N;
  __syncthreads();

  float dist[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = t + j * NT;
    dist[j] = -1.f;
    if (p < N) {
      if (SMEM) {
        sx[p] = fx[3 * p];
        sy[p] = fx[3 * p + 1];
        sz[p] = fx[3 * p + 2];
      }
      if (fm[p]) {
        dist[j] = 1e10f;
        atomicMin(&first_valid, p);
      }
    }
  }
  __syncthreads();
  int last = first_valid < N ? first_valid : 0;
  if (t == 0) fo[0] = last;

  for (int i = 1; i < npoint; ++i) {
    const float lx = SMEM ? sx[last] : fx[3 * last];
    const float ly = SMEM ? sy[last] : fx[3 * last + 1];
    const float lz = SMEM ? sz[last] : fx[3 * last + 2];
    unsigned long long best = 0ull;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int p = t + j * NT;
      if (p < N) {
        if (dist[j] >= 0.f) {
          dist[j] = fminf(dist[j], sq_dist(SMEM ? sx[p] : fx[3 * p], SMEM ? sy[p] : fx[3 * p + 1],
                                           SMEM ? sz[p] : fx[3 * p + 2], lx, ly, lz));
        }
        const unsigned long long k = key_of(dist[j], p);
        best = k > best ? k : best;
      }
    }
    last = block_argmax(best, wkeys);
    if (t == 0) fo[i] = last;
  }
}

// the same walk with the running distances in `dist` (B, N), for frames of
// more points than 32 a thread
__global__ void __launch_bounds__(NT) fps_kernel_large(const float* __restrict__ xyz,
                                                        const uint8_t* __restrict__ mask, int N,
                                                        int npoint, float* __restrict__ dist,
                                                        int64_t* __restrict__ out) {
  __shared__ unsigned long long wkeys[NWARPS];
  __shared__ int first_valid;
  const int b = blockIdx.x, t = threadIdx.x;
  const float* fx = xyz + (size_t)b * N * 3;
  const uint8_t* fm = mask + (size_t)b * N;
  float* fd = dist + (size_t)b * N;
  int64_t* fo = out + (size_t)b * npoint;
  if (t == 0) first_valid = N;
  __syncthreads();
  for (int p = t; p < N; p += NT) {
    fd[p] = fm[p] ? 1e10f : -1.f;
    if (fm[p]) atomicMin(&first_valid, p);
  }
  __syncthreads();
  int last = first_valid < N ? first_valid : 0;
  if (t == 0) fo[0] = last;

  for (int i = 1; i < npoint; ++i) {
    const float lx = fx[3 * last], ly = fx[3 * last + 1], lz = fx[3 * last + 2];
    unsigned long long best = 0ull;
    for (int p = t; p < N; p += NT) {
      float dv = fd[p];
      if (dv >= 0.f) {
        dv = fminf(dv, sq_dist(fx[3 * p], fx[3 * p + 1], fx[3 * p + 2], lx, ly, lz));
        fd[p] = dv;
      }
      const unsigned long long k = key_of(dv, p);
      best = k > best ? k : best;
    }
    last = block_argmax(best, wkeys);
    if (t == 0) fo[i] = last;
  }
}

template <int PER>
int launch(const float* xyz, const uint8_t* mask, int B, int N, int npoint, int64_t* out,
           cudaStream_t stream) {
  const size_t smem = (size_t)3 * N * sizeof(float);
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // the static shared memory (the warps' keys) comes out of the same budget
  if (smem + NWARPS * sizeof(unsigned long long) + 64 <= (size_t)limit) {
    cudaFuncSetAttribute(fps_kernel<PER, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    fps_kernel<PER, true><<<B, NT, smem, stream>>>(xyz, mask, N, npoint, out);
  } else {
    fps_kernel<PER, false><<<B, NT, 0, stream>>>(xyz, mask, N, npoint, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) float32 and mask (B, N) bool, contiguous on one device;
// out (B, npoint) int64, every element written. dist is a (B, N) float32
// scratch buffer, needed only for N over 32 * NT (group_ops.FPS_REG_POINTS)
// and otherwise unread (may be null).
extern "C" int furthest_point_sample(const float* xyz, const uint8_t* mask, int B, int N,
                                     int npoint, float* dist, int64_t* out, void* stream) {
  if (B <= 0 || npoint <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (N + NT - 1) / NT;
  if (per <= 1) return launch<1>(xyz, mask, B, N, npoint, out, s);
  if (per <= 2) return launch<2>(xyz, mask, B, N, npoint, out, s);
  if (per <= 4) return launch<4>(xyz, mask, B, N, npoint, out, s);
  if (per <= 8) return launch<8>(xyz, mask, B, N, npoint, out, s);
  if (per <= 16) return launch<16>(xyz, mask, B, N, npoint, out, s);
  if (per <= 32) return launch<32>(xyz, mask, B, N, npoint, out, s);
  if (dist == nullptr) return (int)cudaErrorInvalidValue;
  fps_kernel_large<<<B, NT, 0, s>>>(xyz, mask, N, npoint, dist, out);
  return (int)cudaGetLastError();
}
