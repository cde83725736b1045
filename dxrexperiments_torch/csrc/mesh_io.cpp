// Native OBJ parser of the port (a copy of the JAX package's
// native/mesh_io.cpp; the port builds this copy, never that one).
//
// scene/mesh.py's Python OBJ parser is the reference; this is the fast path
// for multi-million-triangle assets (a buffered scan of the whole file). It
// reads v, vn, f (v, v/vt, v//vn, v/vt/vn, negative indices, polygons fanned
// into triangles) and usemtl; vt is skipped, so load_obj sends a textured OBJ
// to the Python parser.
//
// C ABI (ctypes, utils/native.py): parse into an opaque handle, query the
// sizes, copy out, free.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> positions;   // 3 per vertex
  std::vector<float> normals;     // 3 per normal
  std::vector<int32_t> face_pos;  // 3 per triangle
  std::vector<int32_t> face_nrm;  // 3 per triangle (-1 if absent)
  std::vector<int32_t> face_mat;  // 1 per triangle
  std::string error;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* parse_float(const char* p, const char* end, float* out) {
  char* q = nullptr;
  *out = strtof(p, &q);
  return (q && q <= end) ? q : p;
}

inline const char* parse_int(const char* p, const char* end, long* out) {
  char* q = nullptr;
  *out = strtol(p, &q, 10);
  return (q && q <= end) ? q : p;
}

int resolve(long idx, size_t n) {
  if (idx > 0) return static_cast<int>(idx - 1);
  if (idx < 0) return static_cast<int>(static_cast<long>(n) + idx);
  return -1;
}

}  // namespace

extern "C" {

void* obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  auto* d = new ObjData();
  if (!f) {
    d->error = "cannot open file";
    return d;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    d->error = "short read";
    fclose(f);
    return d;
  }
  fclose(f);
  buf[size] = '\0';

  const char* p = buf.data();
  const char* end = buf.data() + size;
  int cur_mat = 0;
  int mat_count = 0;
  std::vector<std::string> mat_names;

  // corner scratch for polygon fan triangulation
  std::vector<int> vs, ns;

  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);

    if (q + 1 < line_end && q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
      float x = 0, y = 0, z = 0;
      q = parse_float(q + 1, line_end, &x);
      q = parse_float(q, line_end, &y);
      q = parse_float(q, line_end, &z);
      d->positions.push_back(x);
      d->positions.push_back(y);
      d->positions.push_back(z);
    } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n') {
      float x = 0, y = 0, z = 0;
      q = parse_float(q + 2, line_end, &x);
      q = parse_float(q, line_end, &y);
      q = parse_float(q, line_end, &z);
      d->normals.push_back(x);
      d->normals.push_back(y);
      d->normals.push_back(z);
    } else if (q + 1 < line_end && q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
      vs.clear();
      ns.clear();
      q = q + 1;
      while (q < line_end) {
        q = skip_ws(q, line_end);
        if (q >= line_end || !(*q == '-' || isdigit(*q))) break;
        long vi = 0;
        q = parse_int(q, line_end, &vi);
        long ni = 0;
        bool has_n = false;
        if (q < line_end && *q == '/') {
          ++q;  // texcoord or empty
          if (q < line_end && *q != '/') {
            long ti;
            q = parse_int(q, line_end, &ti);
          }
          if (q < line_end && *q == '/') {
            ++q;
            q = parse_int(q, line_end, &ni);
            has_n = true;
          }
        }
        vs.push_back(resolve(vi, d->positions.size() / 3));
        ns.push_back(has_n ? resolve(ni, d->normals.size() / 3) : -1);
      }
      for (size_t i = 1; i + 1 < vs.size(); ++i) {
        d->face_pos.push_back(vs[0]);
        d->face_pos.push_back(vs[i]);
        d->face_pos.push_back(vs[i + 1]);
        d->face_nrm.push_back(ns[0]);
        d->face_nrm.push_back(ns[i]);
        d->face_nrm.push_back(ns[i + 1]);
        d->face_mat.push_back(cur_mat);
      }
    } else if (line_end - q > 7 && memcmp(q, "usemtl ", 7) == 0) {
      std::string name(q + 7, line_end - (q + 7));
      while (!name.empty() && (name.back() == '\r' || name.back() == ' '))
        name.pop_back();
      int found = -1;
      for (size_t i = 0; i < mat_names.size(); ++i)
        if (mat_names[i] == name) found = static_cast<int>(i);
      if (found < 0) {
        mat_names.push_back(name);
        found = mat_count++;
      }
      cur_mat = found;
    }
    p = line_end + 1;
  }
  return d;
}

const char* obj_error(void* h) {
  auto* d = static_cast<ObjData*>(h);
  return d->error.empty() ? nullptr : d->error.c_str();
}

int64_t obj_num_vertices(void* h) {
  return static_cast<ObjData*>(h)->positions.size() / 3;
}
int64_t obj_num_normals(void* h) {
  return static_cast<ObjData*>(h)->normals.size() / 3;
}
int64_t obj_num_triangles(void* h) {
  return static_cast<ObjData*>(h)->face_pos.size() / 3;
}

void obj_copy(void* h, float* positions, float* normals, int32_t* face_pos,
              int32_t* face_nrm, int32_t* face_mat) {
  auto* d = static_cast<ObjData*>(h);
  memcpy(positions, d->positions.data(), d->positions.size() * sizeof(float));
  memcpy(normals, d->normals.data(), d->normals.size() * sizeof(float));
  memcpy(face_pos, d->face_pos.data(), d->face_pos.size() * sizeof(int32_t));
  memcpy(face_nrm, d->face_nrm.data(), d->face_nrm.size() * sizeof(int32_t));
  memcpy(face_mat, d->face_mat.data(), d->face_mat.size() * sizeof(int32_t));
}

void obj_free(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
