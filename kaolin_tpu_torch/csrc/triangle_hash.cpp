// 2D spatial hash for point-in-triangle candidate queries.
//
// Native equivalent of the reference's Cython extension
// kaolin/cython/ops/mesh/triangle_hash.pyx (used by the CPU path of
// check_sign).  Exposed through a C ABI consumed via ctypes
// (kaolin_tpu/_native.py).

#include <cstdint>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

struct TriangleHash {
    int resolution;
    double min_x, min_y, inv_cell_x, inv_cell_y;
    // spine[cell] .. spine[cell+1] index into items (triangle ids)
    std::vector<int64_t> spine;
    std::vector<int32_t> items;
};

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// triangles: (n_tri, 3, 2) doubles
void* th_create(const double* triangles, int64_t n_tri, int resolution) {
    auto* h = new TriangleHash();
    h->resolution = resolution;

    double min_x = 1e300, min_y = 1e300, max_x = -1e300, max_y = -1e300;
    for (int64_t t = 0; t < n_tri; ++t) {
        for (int v = 0; v < 3; ++v) {
            double x = triangles[t * 6 + v * 2 + 0];
            double y = triangles[t * 6 + v * 2 + 1];
            min_x = std::min(min_x, x); max_x = std::max(max_x, x);
            min_y = std::min(min_y, y); max_y = std::max(max_y, y);
        }
    }
    if (n_tri == 0) { min_x = min_y = 0.0; max_x = max_y = 1.0; }
    double span_x = std::max(max_x - min_x, 1e-12);
    double span_y = std::max(max_y - min_y, 1e-12);
    h->min_x = min_x;
    h->min_y = min_y;
    h->inv_cell_x = resolution / span_x;
    h->inv_cell_y = resolution / span_y;

    const int64_t n_cells = (int64_t)resolution * resolution;
    std::vector<int64_t> counts(n_cells + 1, 0);

    auto cell_range = [&](int64_t t, int& x0, int& x1, int& y0, int& y1) {
        double tmin_x = 1e300, tmin_y = 1e300, tmax_x = -1e300,
               tmax_y = -1e300;
        for (int v = 0; v < 3; ++v) {
            double x = triangles[t * 6 + v * 2 + 0];
            double y = triangles[t * 6 + v * 2 + 1];
            tmin_x = std::min(tmin_x, x); tmax_x = std::max(tmax_x, x);
            tmin_y = std::min(tmin_y, y); tmax_y = std::max(tmax_y, y);
        }
        x0 = clampi((int)((tmin_x - min_x) * h->inv_cell_x), 0,
                    resolution - 1);
        x1 = clampi((int)((tmax_x - min_x) * h->inv_cell_x), 0,
                    resolution - 1);
        y0 = clampi((int)((tmin_y - min_y) * h->inv_cell_y), 0,
                    resolution - 1);
        y1 = clampi((int)((tmax_y - min_y) * h->inv_cell_y), 0,
                    resolution - 1);
    };

    for (int64_t t = 0; t < n_tri; ++t) {
        int x0, x1, y0, y1;
        cell_range(t, x0, x1, y0, y1);
        for (int x = x0; x <= x1; ++x)
            for (int y = y0; y <= y1; ++y)
                counts[(int64_t)x * resolution + y + 1]++;
    }
    for (int64_t c = 0; c < n_cells; ++c) counts[c + 1] += counts[c];
    h->spine = counts;
    h->items.resize(counts[n_cells]);
    std::vector<int64_t> cursor(h->spine.begin(), h->spine.end() - 1);
    for (int64_t t = 0; t < n_tri; ++t) {
        int x0, x1, y0, y1;
        cell_range(t, x0, x1, y0, y1);
        for (int x = x0; x <= x1; ++x)
            for (int y = y0; y <= y1; ++y) {
                int64_t c = (int64_t)x * resolution + y;
                h->items[cursor[c]++] = (int32_t)t;
            }
    }
    return h;
}

void th_destroy(void* handle) {
    delete static_cast<TriangleHash*>(handle);
}

// Count candidate (point, triangle) pairs for points (n_pts, 2).
int64_t th_query_count(void* handle, const double* points, int64_t n_pts) {
    auto* h = static_cast<TriangleHash*>(handle);
    int64_t total = 0;
    for (int64_t p = 0; p < n_pts; ++p) {
        int cx = (int)((points[p * 2 + 0] - h->min_x) * h->inv_cell_x);
        int cy = (int)((points[p * 2 + 1] - h->min_y) * h->inv_cell_y);
        if (cx < 0 || cy < 0 || cx >= h->resolution || cy >= h->resolution)
            continue;
        int64_t c = (int64_t)cx * h->resolution + cy;
        total += h->spine[c + 1] - h->spine[c];
    }
    return total;
}

// Fill candidate pairs; out arrays must have th_query_count entries.
void th_query(void* handle, const double* points, int64_t n_pts,
              int64_t* out_pidx, int32_t* out_tidx) {
    auto* h = static_cast<TriangleHash*>(handle);
    int64_t k = 0;
    for (int64_t p = 0; p < n_pts; ++p) {
        int cx = (int)((points[p * 2 + 0] - h->min_x) * h->inv_cell_x);
        int cy = (int)((points[p * 2 + 1] - h->min_y) * h->inv_cell_y);
        if (cx < 0 || cy < 0 || cx >= h->resolution || cy >= h->resolution)
            continue;
        int64_t c = (int64_t)cx * h->resolution + cy;
        for (int64_t i = h->spine[c]; i < h->spine[c + 1]; ++i) {
            out_pidx[k] = p;
            out_tidx[k] = h->items[i];
            ++k;
        }
    }
}

}  // extern "C"
