// Host-side voxel-grid subsampling (KPConv style).
//
// Host-side equivalent of the reference's C++ grid subsampling
// (PointCloud/openpoints/cpp/subsampling/grid_subsampling.cpp): points
// falling in the same voxel of size `dl` are averaged (features too).
// Runs in the input pipeline on the host CPU - the card gets fixed-size,
// pre-subsampled clouds.
//
// C ABI for ctypes. Built by metatransformer_tpu_torch/runtime/native.py
// (g++ -O3 -shared -fPIC) at first use.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct VoxelKey {
    int64_t x, y, z;
    bool operator==(const VoxelKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct VoxelHash {
    size_t operator()(const VoxelKey& k) const {
        // 3D spatial hash with large primes.
        return static_cast<size_t>(k.x * 73856093LL ^ k.y * 19349669LL ^
                                   k.z * 83492791LL);
    }
};

struct Accum {
    double px = 0, py = 0, pz = 0;
    std::vector<double> feat;
    int64_t count = 0;
};

}  // namespace

extern "C" {

// points: [n, 3] float32; features: [n, fdim] float32 (fdim may be 0).
// out_points: [n, 3]; out_features: [n, fdim] (capacity n, only the first
// *out_n rows are written). Returns 0 on success.
int grid_subsample(const float* points, int64_t n, const float* features,
                   int64_t fdim, float dl, float* out_points,
                   float* out_features, int64_t* out_n) {
    if (n <= 0 || dl <= 0) return 1;
    std::unordered_map<VoxelKey, Accum, VoxelHash> voxels;
    voxels.reserve(static_cast<size_t>(n));
    std::vector<VoxelKey> order;  // first-seen order (deterministic output)
    order.reserve(static_cast<size_t>(n));

    const double inv = 1.0 / dl;
    for (int64_t i = 0; i < n; ++i) {
        const float* p = points + i * 3;
        VoxelKey key{static_cast<int64_t>(std::floor(p[0] * inv)),
                     static_cast<int64_t>(std::floor(p[1] * inv)),
                     static_cast<int64_t>(std::floor(p[2] * inv))};
        auto it = voxels.find(key);
        if (it == voxels.end()) {
            it = voxels.emplace(key, Accum{}).first;
            it->second.feat.assign(static_cast<size_t>(fdim), 0.0);
            order.push_back(key);
        }
        Accum& a = it->second;
        a.px += p[0];
        a.py += p[1];
        a.pz += p[2];
        for (int64_t f = 0; f < fdim; ++f)
            a.feat[static_cast<size_t>(f)] += features[i * fdim + f];
        a.count += 1;
    }

    int64_t m = 0;
    for (const VoxelKey& key : order) {
        const Accum& a = voxels[key];
        const double c = static_cast<double>(a.count);
        out_points[m * 3 + 0] = static_cast<float>(a.px / c);
        out_points[m * 3 + 1] = static_cast<float>(a.py / c);
        out_points[m * 3 + 2] = static_cast<float>(a.pz / c);
        for (int64_t f = 0; f < fdim; ++f)
            out_features[m * fdim + f] =
                static_cast<float>(a.feat[static_cast<size_t>(f)] / c);
        ++m;
    }
    *out_n = m;
    return 0;
}

}  // extern "C"
