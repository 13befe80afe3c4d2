// Point -> voxel binning for the host data pipeline (g++, loaded with
// ctypes by btcdet_tpu_torch/ops/voxelizer.py).
//
// Stands in for the reference's spconv.utils.VoxelGenerator (external C++;
// used by btcdet/datasets/processor/data_processor.py:64-73), with the
// semantics of the numpy twin btcdet_tpu_torch/ops/voxelizer.py::
// voxelize_np_plain, bit for bit: key-sorted voxel selection (lowest
// linear (z, y, x) keys win under the max_voxels cap), original point
// order within each voxel, max_points cap per voxel.
//
// Single-threaded by design: the dataloader parallelizes across workers.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// points: (n, c) float32 row-major, xyz leading.
// out_voxels: (max_voxels, max_points, c) float32 (zeroed here).
// out_coords: (max_voxels, 3) int32 (z, y, x), -1 padding.
// out_num:    (max_voxels,) int32.
// Returns the number of voxels written (<= max_voxels).
int voxelize(const float* points, long n, long c,
             const float* pc_range,   // (6,) lo xyz, hi xyz
             const float* voxel_size, // (3,) vx, vy, vz
             long max_points, long max_voxels,
             float* out_voxels, int* out_coords, int* out_num) {
    // cell math in float32, matching the numpy twin bit-for-bit
    // (boundary points are dtype-sensitive)
    const float vx = voxel_size[0], vy = voxel_size[1], vz = voxel_size[2];
    const long nx = (long)std::llround((double)(pc_range[3] - pc_range[0]) / vx);
    const long ny = (long)std::llround((double)(pc_range[4] - pc_range[1]) / vy);
    const long nz = (long)std::llround((double)(pc_range[5] - pc_range[2]) / vz);

    std::memset(out_voxels, 0, sizeof(float) * max_voxels * max_points * c);
    std::memset(out_num, 0, sizeof(int) * max_voxels);
    for (long i = 0; i < max_voxels * 3; ++i) out_coords[i] = -1;

    // pack (key, point index) into one u64: key in the high bits, point
    // index in the low 24 -- a plain sort is then stable by point order
    const int IDX_BITS = 24;
    std::vector<uint64_t> kv;
    kv.reserve(n);
    for (long i = 0; i < n; ++i) {
        const float* p = points + i * c;
        const long cx = (long)std::floor((p[0] - pc_range[0]) / vx);
        const long cy = (long)std::floor((p[1] - pc_range[1]) / vy);
        const long cz = (long)std::floor((p[2] - pc_range[2]) / vz);
        // (all-float expression: operands are float, division in float)
        if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz)
            continue;
        const uint64_t key = (uint64_t)((cz * ny + cy) * nx + cx);
        kv.push_back((key << IDX_BITS) | (uint64_t)i);
    }
    std::sort(kv.begin(), kv.end());

    long vid = -1;
    int64_t prev_key = INT64_MIN;
    for (const uint64_t packed : kv) {
        const int64_t key = (int64_t)(packed >> IDX_BITS);
        const long pi = (long)(packed & ((1u << IDX_BITS) - 1));
        if (key != prev_key) {
            ++vid;
            prev_key = key;
            if (vid >= max_voxels) break;
            out_coords[vid * 3 + 0] = (int)(key / (ny * nx));
            out_coords[vid * 3 + 1] = (int)((key % (ny * nx)) / nx);
            out_coords[vid * 3 + 2] = (int)(key % nx);
        }
        if (vid >= max_voxels) break;
        const int s = out_num[vid];
        if (s < max_points) {
            std::memcpy(out_voxels + (vid * max_points + s) * c,
                        points + pi * c, sizeof(float) * c);
            out_num[vid] = s + 1;
        }
    }
    return (int)std::min<long>(vid + 1, max_voxels);
}

}  // extern "C"
