// Rotated-BEV NMS of a batch of frames, one launch a call: every keep is
// decided on the card, and nothing is read back.
//
// Replaces no Pallas kernel. The JAX package does its NMS in XLA
// (btcdet_tpu/ops/iou3d.py::nms_rotated, impl "chunked"), and the port first
// kept it as plain PyTorch (ops/iou3d.py::nms_rotated_plain): a host loop a
// frame, about 40 small clipping ops a chunk and four read-backs a call. On
// the eval path that loop held the host for most of a batch while the card
// sat idle, for work the card does in tens of microseconds.
//
// What it computes, frame by frame, is the plain version's decisions exactly.
// The top k candidates in score order (sorted and gathered by the wrapper)
// are visited in chunks of CHUNK (iou3d.NMS_CHUNK). A valid candidate is first
// suppressed by the survivors of earlier chunks, by IoU(A = candidate,
// B = survivor) > thresh; then, greedily in order, each candidate still alive
// suppresses the later ones of its chunk by IoU(A = it, B = later) > thresh.
// The clip is not symmetric in floating point, so both orientations are the
// plain version's. An invalid candidate is never kept and suppresses nothing.
// The walk stops once post survivors are kept; the survivors of the last chunk
// are cut at post.
//
// The IoU is the plain version's arithmetic, each float32 operation rounded as
// PyTorch rounds it (the __f*_rn intrinsics, so nothing is contracted into an
// FMA): B's winding sign, the Sutherland-Hodgman clip of A by B's four edges,
// the shoelace area, area_a + area_b - inter clamped at 1e-6, the division and
// the comparison with thresh as a float32. The plain version keeps the clipped
// polygon in a ring whose slots double at each edge (4 to 64) and fills empty
// slots with the vertex before them. Here each edge takes the compact polygon,
// in a loop that every lane of a warp runs alike, and every vertex carries the
// slot the ring would give it: at edge e a vertex in slot a goes to slot 2a,
// and the crossing point of the pair (a, next) to slot 2 next - 1. A repeated
// vertex adds an exact 0 to the shoelace sum, so only the last slot of each
// vertex's run holds a term; the 64 terms are then added in the order of
// PyTorch's CUDA sum over a row of 64 (the first and the last 32 paired, then a
// warp-shuffle tree, whose offsets rise or fall with the PyTorch version: the
// wrapper finds which once a process and passes it as sum_order). So the IoU is
// the plain version's to the bit, and so are the decisions.
//
// What bounds it: the work is tens of thousands of polygon clips a frame
// (256 x 255 / 2 within a chunk, plus 256 x the survivors from the second
// chunk on), about 0.1 GFLOP for a batch of 8: microseconds at the card's
// float32 rate. The greedy scan is sequential within a frame, so a frame is
// one block, and a batch of B frames fills B of the card's 132 SMs: latency,
// not throughput, bounds it (on an H100, 0.47 ms for the proposal NMS of 8
// crowded frames, k 1024 -> 100, against 84-96 ms for the plain version). The
// design keeps the whole walk of a frame on chip: one block a frame,
// persistent over its chunks; the chunk's corners and areas and its 256 x 256
// suppression bits (8 KB) in shared memory; a warp a candidate row, its lanes
// on 32 columns, the bits of a column word from one ballot; each lane's clip a
// loop over its polygon's vertices, the same code in every lane, so the lanes
// of a warp part only in their trip counts; then one warp runs the greedy scan
// over the rows with a word-wide AND NOT a kept row. The block walks only as
// many chunks as it needs to keep post boxes, as the host loop did. The
// survivors are kept as positions in the output buffer and turned into input
// indices at the end.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 256;            // candidates a chunk (iou3d.NMS_CHUNK)
constexpr int NT = 512;               // threads a block
constexpr int NWARPS = NT / 32;
constexpr int WORDS = CHUNK / 32;     // suppression words a row
constexpr int RING = 64;              // the plain clipper's ring after four edges
constexpr unsigned FULL = 0xffffffffu;

// A vertex of the clipped polygon and the ring slot the plain clipper gives it.
struct Pt {
  float x, y;
  int slot;
};

__device__ __forceinline__ float cross(float ax, float ay, float bx, float by) {
  return __fsub_rn(__fmul_rn(ax, by), __fmul_rn(bx, ay));
}

__device__ __forceinline__ float sign(float v) { return (float)((0.f < v) - (v < 0.f)); }

// B's edge: its start, its direction and -winding, as the plain clipper has them.
struct Edge {
  float x, y, dx, dy, negw;
  __device__ __forceinline__ float dist(float px, float py) const {
    return __fmul_rn(__fsub_rn(__fmul_rn(dx, __fsub_rn(py, y)), __fmul_rn(dy, __fsub_rn(px, x))),
                     negw);
  }
};

// The crossing point of the pair (a, b) with the edge, from their distances.
__device__ __forceinline__ void crossing(const Pt& a, const Pt& b, float da, float db, float& x,
                                         float& y) {
  const float den = __fsub_rn(da, db);
  const float t = __fdiv_rn(da, fabsf(den) < 1e-12f ? 1.f : den);
  x = __fadd_rn(a.x, __fmul_rn(t, __fsub_rn(b.x, a.x)));
  y = __fadd_rn(a.y, __fmul_rn(t, __fsub_rn(b.y, a.y)));
}

// One edge of the clip: the n vertices of `in` (a ring of 4 << E slots) to
// `out` (8 << E slots), each pair (a, b) in order giving a if inside, then the
// crossing point if the pair crosses the edge. Returns the vertices out.
template <int E>
__device__ __forceinline__ int clip_edge(const Pt* in, int n, const Edge& edge, Pt* out) {
  constexpr int OUT = 8 << E;
  const float d0 = edge.dist(in[0].x, in[0].y);
  float da = d0;
  int m = 0;
  for (int j = 0; j < n; ++j) {
    const Pt a = in[j];
    const int jb = j + 1 == n ? 0 : j + 1;
    const Pt b = in[jb];
    const float db = jb == 0 ? d0 : edge.dist(b.x, b.y);
    const bool in_a = da >= 0.f, in_b = db >= 0.f;
    if (in_a) out[m++] = Pt{a.x, a.y, 2 * a.slot};
    if (in_a != in_b) {
      Pt p;
      crossing(a, b, da, db, p.x, p.y);
      p.slot = (2 * b.slot - 1) & (OUT - 1);
      out[m++] = p;
    }
    da = db;
  }
  return m;
}

// The polygon out of the last edge, streamed into the shoelace terms: each
// vertex's term lands in the last slot of its run in the ring of RING slots.
struct Shoelace {
  float fx, fy, px, py;
  int fslot, n;
  unsigned long long filled;   // slots holding a term
  float* term;                 // [RING]
  __device__ __forceinline__ void add(float x, float y, int slot) {
    if (n) {
      const int p = (slot - 1) & (RING - 1);
      term[p] = cross(px, py, x, y);
      filled |= 1ull << p;
    } else {
      fx = x, fy = y, fslot = slot;
    }
    px = x, py = y, ++n;
  }
  __device__ __forceinline__ void close() {
    const int p = (fslot - 1) & (RING - 1);
    term[p] = cross(px, py, fx, fy);
    filled |= 1ull << p;
  }
};

// The shoelace sum of the ring's slots in PyTorch's order (header note).
__device__ __forceinline__ float ring_sum(const Shoelace& sh, int sum_order) {
  float s[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const float lo = (sh.filled >> x) & 1 ? sh.term[x] : 0.f;
    const float hi = (sh.filled >> (x + 32)) & 1 ? sh.term[x + 32] : 0.f;
    s[x] = __fadd_rn(lo, hi);
  }
  if (sum_order) {                     // offsets 16, 8, 4, 2, 1
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int x = 0; x < o; ++x) s[x] = __fadd_rn(s[x], s[x + o]);
  } else {                             // offsets 1, 2, 4, 8, 16
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
      for (int x = 0; x < 32; x += 2 * o) s[x] = __fadd_rn(s[x], s[x + o]);
  }
  return s[0];
}

// Rotated BEV IoU of A (corners ax, ay; area aa) clipped by B, as the plain
// version computes it. A polygon has at most 2n vertices after an edge that
// took n, and no more than the ring's slots: 8, 16, 32, then 64 streamed.
__device__ float rotated_iou(const float (&ax)[4], const float (&ay)[4], float aa,
                             const float (&bx)[4], const float (&by)[4], float ba,
                             int sum_order) {
  Edge edge[4];
  float w = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = (e + 1) & 3;
    edge[e].x = bx[e];
    edge[e].y = by[e];
    edge[e].dx = __fsub_rn(bx[n], bx[e]);
    edge[e].dy = __fsub_rn(by[n], by[e]);
    w += sign(__fmul_rn(edge[e].dx, __fadd_rn(by[n], by[e])));
  }
  const float negw = -(w == 0.f ? 1.f : sign(w));
#pragma unroll
  for (int e = 0; e < 4; ++e) edge[e].negw = negw;

  Pt p4[4], p8[8], p16[16], p32[32];
#pragma unroll
  for (int i = 0; i < 4; ++i) p4[i] = Pt{ax[i], ay[i], i};
  int n = clip_edge<0>(p4, 4, edge[0], p8);
  if (n) n = clip_edge<1>(p8, n, edge[1], p16);
  if (n) n = clip_edge<2>(p16, n, edge[2], p32);
  float inter = 0.f;
  if (n) {
    float term[RING];
    Shoelace sh{0.f, 0.f, 0.f, 0.f, 0, 0, 0ull, term};
    const float d0 = edge[3].dist(p32[0].x, p32[0].y);
    float da = d0;
    for (int j = 0; j < n; ++j) {
      const Pt a = p32[j];
      const int jb = j + 1 == n ? 0 : j + 1;
      const Pt b = p32[jb];
      const float db = jb == 0 ? d0 : edge[3].dist(b.x, b.y);
      const bool in_a = da >= 0.f, in_b = db >= 0.f;
      if (in_a) sh.add(a.x, a.y, 2 * a.slot);
      if (in_a != in_b) {
        float x, y;
        crossing(a, b, da, db, x, y);
        sh.add(x, y, (2 * b.slot - 1) & (RING - 1));
      }
      da = db;
    }
    if (sh.n) {
      sh.close();
      inter = __fmul_rn(0.5f, fabsf(ring_sum(sh, sum_order)));
    }
  }
  float u = __fsub_rn(__fadd_rn(aa, ba), inter);
  u = u < 1e-6f ? 1e-6f : u;           // torch.clamp(min=1e-6): NaN stays NaN
  return __fdiv_rn(inter, u);
}

__device__ __forceinline__ void load_quad(const float* p, float (&x)[4], float (&y)[4]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x, y[0] = lo.y, x[1] = lo.z, y[1] = lo.w;
  x[2] = hi.x, y[2] = hi.y, x[3] = hi.z, y[3] = hi.w;
}

// One block a frame. corners (B, k, 4, 2) and areas (B, k) of the top k
// candidates in score order, valid (B, k), order (B, k) their input indices;
// out_idx (B, post) int64 and out_valid (B, post) written whole; chunks (B,)
// the chunks walked that held a valid candidate.
__global__ void __launch_bounds__(NT) nms_rotated_kernel(
    const float* __restrict__ corners, const float* __restrict__ areas,
    const uint8_t* __restrict__ valid, const int64_t* __restrict__ order, int k, int post,
    float thresh, int sum_order, int64_t* __restrict__ out_idx,
    uint8_t* __restrict__ out_valid, int* __restrict__ chunks) {
  __shared__ float cx[CHUNK][4], cy[CHUNK][4], carea[CHUNK];
  __shared__ uint32_t over[CHUNK][WORDS];  // over[i] bit j: IoU(A = i, B = j) > thresh, j > i
  __shared__ uint32_t live[WORDS];         // candidates still in the running
  __shared__ int n_kept, n_chunks;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* fc = corners + (size_t)b * k * 8;
  const float* fa = areas + (size_t)b * k;
  const uint8_t* fv = valid + (size_t)b * k;
  int64_t* kept = out_idx + (size_t)b * post;  // chunk positions until the end
  if (tid == 0) n_kept = 0, n_chunks = 0;

  for (int c0 = 0; c0 < k; c0 += CHUNK) {
    __syncthreads();
    if (n_kept >= post) break;
    const int m = min(CHUNK, k - c0);
    for (int i = tid; i < m; i += NT) {
      float x[4], y[4];
      load_quad(fc + (size_t)(c0 + i) * 8, x, y);
#pragma unroll
      for (int v = 0; v < 4; ++v) cx[i][v] = x[v], cy[i][v] = y[v];
      carea[i] = fa[c0 + i];
    }
    if (warp < WORDS) {
      const int i = warp * 32 + lane;
      const uint32_t bits = __ballot_sync(FULL, i < m && fv[c0 + i] != 0);
      if (lane == 0) live[warp] = bits;
    }
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) any |= live[w] != 0;
    if (!any) continue;
    const int nk = n_kept;

    // against the survivors of earlier chunks: a warp a candidate, lanes on survivors
    if (nk > 0) {
      for (int i = warp; i < m; i += NWARPS) {
        if (!((live[i >> 5] >> (i & 31)) & 1)) continue;
        float ax[4], ay[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) ax[v] = cx[i][v], ay[v] = cy[i][v];
        const float aa = carea[i];
        bool hit = false;
        for (int s0 = 0; s0 < nk && !hit; s0 += 32) {
          bool o = false;
          if (s0 + lane < nk) {
            const int p = (int)kept[s0 + lane];
            float bx[4], by[4];
            load_quad(fc + (size_t)p * 8, bx, by);
            o = rotated_iou(ax, ay, aa, bx, by, fa[p], sum_order) > thresh;
          }
          hit = __any_sync(FULL, o);
        }
        if (hit && lane == 0) atomicAnd(&live[i >> 5], ~(1u << (i & 31)));
      }
      __syncthreads();
    }

    // within the chunk: a warp a row i, each column word j = 32 w + lane from one ballot
    for (int i = warp; i < m; i += NWARPS) {
      const bool row = (live[i >> 5] >> (i & 31)) & 1;
      float ax[4], ay[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) ax[v] = cx[i][v], ay[v] = cy[i][v];
      const float aa = carea[i];
      for (int w = 0; w < WORDS; ++w) {
        uint32_t bits = 0;
        if (row && 32 * w + 31 > i && 32 * w < m) {
          const int j = 32 * w + lane;
          bool o = false;
          if (j > i && j < m && ((live[w] >> lane) & 1)) {
            float bx[4], by[4];
#pragma unroll
            for (int v = 0; v < 4; ++v) bx[v] = cx[j][v], by[v] = cy[j][v];
            o = rotated_iou(ax, ay, aa, bx, by, carea[j], sum_order) > thresh;
          }
          bits = __ballot_sync(FULL, o);
        }
        if (lane == 0) over[i][w] = bits;
      }
    }
    __syncthreads();

    // the greedy scan, then the survivors in order, cut at post
    if (warp == 0) {
      uint32_t word = lane < WORDS ? live[lane] : 0u;
      for (int i = 0; i < m; ++i) {
        const uint32_t wi = __shfl_sync(FULL, word, i >> 5);
        if (((wi >> (i & 31)) & 1) && lane < WORDS) word &= ~over[i][lane];
      }
      if (lane < WORDS) live[lane] = word;
      __syncwarp();
      if (lane == 0) {
        int n = nk;
        for (int i = 0; i < m && n < post; ++i)
          if ((live[i >> 5] >> (i & 31)) & 1) kept[n++] = c0 + i;
        n_kept = n;
        ++n_chunks;
      }
    }
  }
  __syncthreads();
  const int nk = n_kept;
  for (int r = tid; r < post; r += NT) {
    const bool ok = r < nk;
    out_idx[(size_t)b * post + r] = ok ? order[(size_t)b * k + kept[r]] : 0;
    out_valid[(size_t)b * post + r] = ok;
  }
  if (tid == 0) chunks[b] = n_chunks;
}

// IoU(A = a_i, B = b_j) of every pair, for the tests: the same device function.
__global__ void rotated_iou_kernel(const float* __restrict__ ca, const float* __restrict__ aa,
                                   int n, const float* __restrict__ cb,
                                   const float* __restrict__ ab, int m, int sum_order,
                                   float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * m) return;
  const int i = (int)(t / m), j = (int)(t - (long long)i * m);
  float ax[4], ay[4], bx[4], by[4];
  load_quad(ca + (size_t)i * 8, ax, ay);
  load_quad(cb + (size_t)j * 8, bx, by);
  out[t] = rotated_iou(ax, ay, aa[i], bx, by, ab[j], sum_order);
}

}  // namespace

// corners (B, k, 4, 2) float32, areas (B, k) float32, valid (B, k) bool,
// order (B, k) int64, all contiguous on one device; out_idx (B, post) int64,
// out_valid (B, post) bool, chunks (B,) int32, every element written.
extern "C" int nms_rotated(const float* corners, const float* areas, const uint8_t* valid,
                           const int64_t* order, int B, int k, int post, float thresh,
                           int sum_order, int64_t* out_idx, uint8_t* out_valid, int* chunks,
                           void* stream) {
  if (B <= 0 || post <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  nms_rotated_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      corners, areas, valid, order, k, post, thresh, sum_order, out_idx, out_valid, chunks);
  return (int)cudaGetLastError();
}

// out (n, m) float32: IoU(A = a_i, B = b_j); corners (n or m, 4, 2), areas (n or m).
extern "C" int rotated_iou(const float* ca, const float* aa, int n, const float* cb,
                           const float* ab, int m, int sum_order, float* out, void* stream) {
  const long long total = (long long)n * m;
  if (total == 0) return 0;
  constexpr int T = 128;
  rotated_iou_kernel<<<(unsigned)((total + T - 1) / T), T, 0, static_cast<cudaStream_t>(stream)>>>(
      ca, aa, n, cb, ab, m, sum_order, out);
  return (int)cudaGetLastError();
}
