// MISE: Multiresolution IsoSurface Extraction octree refinement.
//
// Native equivalent of the reference's Cython extension
// kaolin/cython/ops/conversions/mise.pyx (Occupancy Networks' MISE),
// used by sdf_to_voxelgrids.  Incrementally refines active cells so only
// grid points near the iso-surface get evaluated.
//
// C ABI for ctypes: the host (python) evaluates the SDF; this module
// tracks which grid points need values and produces the final dense grid.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Mise {
    int64_t resolution;       // current refinement resolution
    int64_t final_resolution; // R: grid has (R+1)^3 points
    // known occupancy at final-grid coordinates
    std::unordered_map<int64_t, uint8_t> occ;
    std::vector<int64_t> to_query;  // flat final-grid ids awaiting values

    int64_t side() const { return final_resolution + 1; }
    int64_t key(int64_t x, int64_t y, int64_t z) const {
        return (x * side() + y) * side() + z;
    }
};

}  // namespace

extern "C" {

void* mise_create(int64_t init_res, int64_t upsampling_steps) {
    auto* m = new Mise();
    m->resolution = init_res;
    m->final_resolution = init_res << upsampling_steps;
    const int64_t step = m->final_resolution / init_res;
    for (int64_t x = 0; x <= init_res; ++x)
        for (int64_t y = 0; y <= init_res; ++y)
            for (int64_t z = 0; z <= init_res; ++z)
                m->to_query.push_back(m->key(x * step, y * step, z * step));
    return m;
}

void mise_destroy(void* handle) { delete static_cast<Mise*>(handle); }

int64_t mise_num_query(void* handle) {
    return (int64_t)static_cast<Mise*>(handle)->to_query.size();
}

// out: (n, 3) int64 coords in [0, final_resolution] to evaluate
void mise_get_query(void* handle, int64_t* out) {
    auto* m = static_cast<Mise*>(handle);
    const int64_t side = m->side();
    for (size_t i = 0; i < m->to_query.size(); ++i) {
        int64_t k = m->to_query[i];
        out[i * 3 + 2] = k % side;
        out[i * 3 + 1] = (k / side) % side;
        out[i * 3 + 0] = k / (side * side);
    }
}

// occupancies: n uint8 values matching the last mise_get_query order
void mise_update(void* handle, const uint8_t* occupancies) {
    auto* m = static_cast<Mise*>(handle);
    for (size_t i = 0; i < m->to_query.size(); ++i)
        m->occ[m->to_query[i]] = occupancies[i];
    m->to_query.clear();
}

// Refine: double the resolution, mark new points of active (mixed-sign)
// cells for querying.  Returns the new resolution, or 0 when done.
int64_t mise_refine(void* handle) {
    auto* m = static_cast<Mise*>(handle);
    if (m->resolution >= m->final_resolution) return 0;
    const int64_t res = m->resolution;
    const int64_t step = m->final_resolution / res;       // current stride
    const int64_t half = step / 2;                        // new stride
    std::unordered_map<int64_t, uint8_t> pending;

    for (int64_t cx = 0; cx < res; ++cx)
        for (int64_t cy = 0; cy < res; ++cy)
            for (int64_t cz = 0; cz < res; ++cz) {
                int inside = 0;
                for (int corner = 0; corner < 8; ++corner) {
                    int64_t x = (cx + ((corner >> 2) & 1)) * step;
                    int64_t y = (cy + ((corner >> 1) & 1)) * step;
                    int64_t z = (cz + (corner & 1)) * step;
                    auto it = m->occ.find(m->key(x, y, z));
                    if (it != m->occ.end() && it->second) ++inside;
                }
                bool active = inside > 0 && inside < 8;
                // fine-grid points of this cell (3x3x3 at half stride)
                for (int dx = 0; dx <= 2; ++dx)
                    for (int dy = 0; dy <= 2; ++dy)
                        for (int dz = 0; dz <= 2; ++dz) {
                            int64_t x = cx * step + dx * half;
                            int64_t y = cy * step + dy * half;
                            int64_t z = cz * step + dz * half;
                            int64_t k = m->key(x, y, z);
                            if (m->occ.count(k)) continue;
                            if (active) {
                                pending[k] = 2;  // needs evaluation
                            } else if (!pending.count(k)) {
                                // propagate the cell sign (floor corner)
                                auto it = m->occ.find(
                                    m->key(cx * step, cy * step,
                                           cz * step));
                                uint8_t v = (it != m->occ.end() &&
                                             it->second) ? 1 : 0;
                                pending[k] = v;
                            }
                        }
            }
    for (auto& kv : pending) {
        if (kv.second == 2) {
            m->to_query.push_back(kv.first);
        } else {
            m->occ[kv.first] = kv.second;
        }
    }
    m->resolution = res * 2;
    return m->resolution;
}

// Fill the dense (R+1)^3 uint8 grid (points never evaluated -> 0).
void mise_to_dense(void* handle, uint8_t* out) {
    auto* m = static_cast<Mise*>(handle);
    const int64_t side = m->side();
    std::memset(out, 0, (size_t)(side * side * side));
    for (auto& kv : m->occ)
        out[kv.first] = kv.second ? 1 : 0;
}

}  // extern "C"
