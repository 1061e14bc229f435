// Fast OBJ tokenizer.
//
// Native data-loader component: parses v/vt/vn/f records of an OBJ file in
// one pass (the reference leans on torch tensor construction from python
// lists; large ShapeNet meshes make pure-python tokenization the io
// bottleneck).  Two-call C ABI: parse once (counts), then copy out.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ObjData {
    std::vector<float> vertices;       // x y z triples
    std::vector<float> uvs;            // u v pairs
    std::vector<float> normals;        // x y z triples
    std::vector<int64_t> face_v;       // flat vertex indices (raw, 1-based)
    std::vector<int64_t> face_vt;      // flat uv indices (0 if absent)
    std::vector<int64_t> face_vn;      // flat normal indices (0 if absent)
    std::vector<int64_t> face_counts;  // vertices per face
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

}  // namespace

extern "C" {

void* obj_parse(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(size + 1);
    if (fread(buf.data(), 1, size, f) != (size_t)size) {
        fclose(f);
        return nullptr;
    }
    fclose(f);
    buf[size] = '\n';

    auto* d = new ObjData();
    const char* p = buf.data();
    const char* end = buf.data() + size;
    while (p < end) {
        const char* line_end = (const char*)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);
        if (q + 1 < line_end && q[0] == 'v' &&
            (q[1] == ' ' || q[1] == '\t')) {
            char* next;
            for (int i = 0; i < 3; ++i) {
                float val = strtof(q + 1, &next);
                d->vertices.push_back(val);
                q = next;
            }
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't' &&
                   (q[2] == ' ' || q[2] == '\t')) {
            char* next;
            q += 2;
            for (int i = 0; i < 2; ++i) {
                float val = strtof(q, &next);
                d->uvs.push_back(val);
                q = next;
            }
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n' &&
                   (q[2] == ' ' || q[2] == '\t')) {
            char* next;
            q += 2;
            for (int i = 0; i < 3; ++i) {
                float val = strtof(q, &next);
                d->normals.push_back(val);
                q = next;
            }
        } else if (q + 1 < line_end && q[0] == 'f' &&
                   (q[1] == ' ' || q[1] == '\t')) {
            ++q;
            int64_t count = 0;
            while (true) {
                q = skip_ws(q, line_end);
                if (q >= line_end) break;
                char* next;
                long v = strtol(q, &next, 10);
                if (next == q) break;
                q = next;
                long vt = 0, vn = 0;
                if (q < line_end && *q == '/') {
                    ++q;
                    if (q < line_end && *q != '/') {
                        vt = strtol(q, &next, 10);
                        q = next;
                    }
                    if (q < line_end && *q == '/') {
                        ++q;
                        vn = strtol(q, &next, 10);
                        q = next;
                    }
                }
                d->face_v.push_back(v);
                d->face_vt.push_back(vt);
                d->face_vn.push_back(vn);
                ++count;
            }
            if (count > 0) d->face_counts.push_back(count);
        }
        p = line_end + 1;
    }
    return d;
}

void obj_destroy(void* handle) { delete static_cast<ObjData*>(handle); }

void obj_counts(void* handle, int64_t* out) {
    auto* d = static_cast<ObjData*>(handle);
    out[0] = (int64_t)d->vertices.size() / 3;
    out[1] = (int64_t)d->uvs.size() / 2;
    out[2] = (int64_t)d->normals.size() / 3;
    out[3] = (int64_t)d->face_counts.size();
    out[4] = (int64_t)d->face_v.size();
}

void obj_copy(void* handle, float* vertices, float* uvs, float* normals,
              int64_t* face_counts, int64_t* face_v, int64_t* face_vt,
              int64_t* face_vn) {
    auto* d = static_cast<ObjData*>(handle);
    memcpy(vertices, d->vertices.data(),
           d->vertices.size() * sizeof(float));
    memcpy(uvs, d->uvs.data(), d->uvs.size() * sizeof(float));
    memcpy(normals, d->normals.data(), d->normals.size() * sizeof(float));
    memcpy(face_counts, d->face_counts.data(),
           d->face_counts.size() * sizeof(int64_t));
    memcpy(face_v, d->face_v.data(), d->face_v.size() * sizeof(int64_t));
    memcpy(face_vt, d->face_vt.data(),
           d->face_vt.size() * sizeof(int64_t));
    memcpy(face_vn, d->face_vn.data(),
           d->face_vn.size() * sizeof(int64_t));
}

}  // extern "C"
