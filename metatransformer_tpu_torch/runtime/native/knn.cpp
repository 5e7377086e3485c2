// Host-side k-nearest-neighbors with a uniform-grid index.
//
// Equivalent of the reference's nanoflann-based kNN used by the
// SemanticKITTI pipeline (PointCloud/openpoints/dataset/semantic_kitti/
// utils/nearest_neighbors/knn.cpp) - batched queries against a point set
// on CPU, for the host data pipeline.
//
// Grid-bucket index: points are binned into cells of size `cell`; each
// query scans rings of cells outward until k hits are guaranteed.
// Falls back to brute force for tiny inputs.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
    int64_t x, y, z;
    bool operator==(const CellKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};
struct CellHash {
    size_t operator()(const CellKey& k) const {
        return static_cast<size_t>(k.x * 73856093LL ^ k.y * 19349669LL ^
                                   k.z * 83492791LL);
    }
};

inline double dist2(const float* a, const float* b) {
    const double dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
    return dx * dx + dy * dy + dz * dz;
}

}  // namespace

extern "C" {

// support: [n, 3]; queries: [m, 3]; out_idx: [m, k] int64;
// out_dist2: [m, k] float32. k must be <= n. Returns 0 on success.
int knn_search(const float* support, int64_t n, const float* queries,
               int64_t m, int64_t k, int64_t* out_idx, float* out_dist2) {
    if (n <= 0 || m <= 0 || k <= 0 || k > n) return 1;

    // Brute force for small support sets.
    if (n <= 512) {
        std::vector<std::pair<double, int64_t>> d(static_cast<size_t>(n));
        for (int64_t q = 0; q < m; ++q) {
            for (int64_t i = 0; i < n; ++i)
                d[static_cast<size_t>(i)] = {dist2(queries + q * 3,
                                                   support + i * 3), i};
            std::partial_sort(d.begin(), d.begin() + k, d.end());
            for (int64_t j = 0; j < k; ++j) {
                out_idx[q * k + j] = d[static_cast<size_t>(j)].second;
                out_dist2[q * k + j] =
                    static_cast<float>(d[static_cast<size_t>(j)].first);
            }
        }
        return 0;
    }

    // Build grid with cell size ~ average spacing * cbrt(k).
    float lo[3] = {support[0], support[1], support[2]};
    float hi[3] = {support[0], support[1], support[2]};
    for (int64_t i = 1; i < n; ++i)
        for (int d = 0; d < 3; ++d) {
            lo[d] = std::min(lo[d], support[i * 3 + d]);
            hi[d] = std::max(hi[d], support[i * 3 + d]);
        }
    const double vol = std::max(1e-9,
        (double)(hi[0] - lo[0]) * (hi[1] - lo[1]) * (hi[2] - lo[2]));
    const double spacing = std::cbrt(vol / static_cast<double>(n));
    const double cell = std::max(1e-9, spacing * std::cbrt((double)k) * 1.5);
    const double inv = 1.0 / cell;

    std::unordered_map<CellKey, std::vector<int64_t>, CellHash> grid;
    grid.reserve(static_cast<size_t>(n));
    auto key_of = [&](const float* p) {
        return CellKey{static_cast<int64_t>(std::floor(p[0] * inv)),
                       static_cast<int64_t>(std::floor(p[1] * inv)),
                       static_cast<int64_t>(std::floor(p[2] * inv))};
    };
    for (int64_t i = 0; i < n; ++i) grid[key_of(support + i * 3)].push_back(i);

    using Hit = std::pair<double, int64_t>;  // (dist2, idx) max-heap
    std::priority_queue<Hit> heap;
    for (int64_t q = 0; q < m; ++q) {
        const float* qp = queries + q * 3;
        const CellKey c = key_of(qp);
        while (!heap.empty()) heap.pop();
        for (int64_t ring = 0;; ++ring) {
            // scan the shell of cells at Chebyshev distance `ring`
            for (int64_t dx = -ring; dx <= ring; ++dx)
                for (int64_t dy = -ring; dy <= ring; ++dy)
                    for (int64_t dz = -ring; dz <= ring; ++dz) {
                        if (std::max({std::llabs(dx), std::llabs(dy),
                                      std::llabs(dz)}) != ring)
                            continue;
                        auto it = grid.find(
                            CellKey{c.x + dx, c.y + dy, c.z + dz});
                        if (it == grid.end()) continue;
                        for (int64_t i : it->second) {
                            const double d = dist2(qp, support + i * 3);
                            if (heap.size() <
                                static_cast<size_t>(k))
                                heap.emplace(d, i);
                            else if (d < heap.top().first) {
                                heap.pop();
                                heap.emplace(d, i);
                            }
                        }
                    }
            // done when k found and the next ring cannot contain closer
            // points (ring boundary distance > current kth distance).
            if (heap.size() == static_cast<size_t>(k)) {
                const double ring_min = static_cast<double>(ring) * cell;
                if (ring_min * ring_min > heap.top().first) break;
            }
            if (ring > 1 &&
                static_cast<double>(ring - 1) * cell >
                    std::sqrt(vol) * 2.0)  // safety: scanned far past the box
                break;
        }
        // empty remaining (shouldn't happen when k<=n)
        std::vector<Hit> hits;
        hits.reserve(static_cast<size_t>(k));
        while (!heap.empty()) {
            hits.push_back(heap.top());
            heap.pop();
        }
        std::sort(hits.begin(), hits.end());
        for (int64_t j = 0; j < k; ++j) {
            const Hit& h = hits[static_cast<size_t>(
                std::min<int64_t>(j, (int64_t)hits.size() - 1))];
            out_idx[q * k + j] = h.second;
            out_dist2[q * k + j] = static_cast<float>(h.first);
        }
    }
    return 0;
}

}  // extern "C"
