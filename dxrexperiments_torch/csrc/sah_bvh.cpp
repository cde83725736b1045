// Binned SAH/SBVH BVH builder (host, C++), the port's own copy of
// native/sah_bvh.cpp (same code, so the same trees bit for bit).
//
// Static scenes get a surface-area-heuristic tree built once on the host;
// without a C++ compiler the port takes the Morton build
// (dxrexperiments_torch/accel/bvh.py). Both emit the same explicit node-array
// format consumed by the traversal kernels:
//
//   nodes_lo/hi [M, 3] f32, child [M, 2] i32:
//     internal: child[m] = {left_node, right_node}
//     leaf:     child[m] = {-(start+1), count}  (range into `order`)
//   order [R] i32: triangle REFERENCES, leaves own contiguous runs. With
//     spatial splits a triangle may be referenced by several leaves
//     (R >= T); every consumer resolves slots through this table
//     (pack_for_traversal's slot_tri), so duplicates are transparent.
//
// 16-bin object SAH with leaf cutoff, nodes in DFS order (left child
// immediately follows its parent). When the two object-split children
// overlap significantly (SBVH, Stich et al. 2009: overlap area / root area
// > 1e-5), a 16-bin SPATIAL split is also evaluated — references straddling
// the winning plane are clipped (exact triangle-polygon clipping) and
// duplicated into both children, shrinking the packet-traversal unions that
// random soups otherwise suffer. Total references are budgeted at 1.5x the
// triangle count; past the budget splitting reverts to object-only.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

constexpr int BINS = 16;
constexpr float SBVH_ALPHA = 1e-5f;  // overlap/root area gate (Stich 4.1)

struct AABB {
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const AABB& o) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], o.lo[k]);
      hi[k] = std::max(hi[k], o.hi[k]);
    }
  }
  void grow(const float* p) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], p[k]);
      hi[k] = std::max(hi[k], p[k]);
    }
  }
  bool valid() const { return lo[0] <= hi[0] && lo[1] <= hi[1] && lo[2] <= hi[2]; }
  void clamp_to(const AABB& o) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::max(lo[k], o.lo[k]);
      hi[k] = std::min(hi[k], o.hi[k]);
    }
  }
  float area() const {
    float d[3] = {std::max(hi[0] - lo[0], 0.f), std::max(hi[1] - lo[1], 0.f),
                  std::max(hi[2] - lo[2], 0.f)};
    return 2.f * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0]);
  }
  float centroid(int k) const { return 0.5f * (lo[k] + hi[k]); }
};

// One triangle reference: with spatial splits the box is the triangle's
// AABB CLIPPED to this reference's region (a subset of the full tri box).
struct Ref {
  int32_t tri;
  AABB box;
};

// AABB of the triangle polygon clipped to the axis slab [s_lo, s_hi]
// (Sutherland-Hodgman against the two planes). Invalid AABB when the
// triangle misses the slab.
AABB clip_tri_to_slab(const float* a, const float* b, const float* c,
                      int axis, float s_lo, float s_hi) {
  float poly[8][3], tmp[8][3];
  int np_ = 3;
  memcpy(poly[0], a, 12);
  memcpy(poly[1], b, 12);
  memcpy(poly[2], c, 12);
  // clip against axis >= s_lo, then axis <= s_hi
  for (int pass = 0; pass < 2; ++pass) {
    const float plane = pass ? s_hi : s_lo;
    const float sign = pass ? -1.f : 1.f;  // inside test: sign*(v-plane) >= 0
    int m = 0;
    for (int i = 0; i < np_; ++i) {
      const float* cur = poly[i];
      const float* nxt = poly[(i + 1) % np_];
      const float dc = sign * (cur[axis] - plane);
      const float dn = sign * (nxt[axis] - plane);
      if (dc >= 0.f) memcpy(tmp[m++], cur, 12);
      if ((dc >= 0.f) != (dn >= 0.f)) {
        const float t = dc / (dc - dn);
        for (int k = 0; k < 3; ++k) tmp[m][k] = cur[k] + t * (nxt[k] - cur[k]);
        ++m;
      }
      if (m >= 8) break;  // numeric safety; 5 is the true max
    }
    memcpy(poly, tmp, sizeof(tmp));
    np_ = m;
    if (np_ == 0) return AABB{};
  }
  AABB out;
  for (int i = 0; i < np_; ++i) out.grow(poly[i]);
  return out;
}

struct Builder {
  const float* v0;
  const float* e1;
  const float* e2;
  int64_t n;
  int leaf_size;
  bool spatial;
  float root_area = 0.f;
  int64_t extra_budget = 0;  // remaining duplicate references allowed
  std::vector<int32_t> order;  // leaf-contiguous reference emission
  std::vector<float> nodes_lo, nodes_hi;
  std::vector<int32_t> child;

  void tri_verts(int32_t t, float* a, float* b, float* c) const {
    for (int k = 0; k < 3; ++k) {
      a[k] = v0[t * 3 + k];
      b[k] = a[k] + e1[t * 3 + k];
      c[k] = a[k] + e2[t * 3 + k];
    }
  }

  int32_t new_node() {
    nodes_lo.insert(nodes_lo.end(), {0, 0, 0});
    nodes_hi.insert(nodes_hi.end(), {0, 0, 0});
    child.insert(child.end(), {0, 0});
    return static_cast<int32_t>(child.size() / 2 - 1);
  }

  void set_box(int32_t node, const AABB& b) {
    memcpy(&nodes_lo[node * 3], b.lo, 12);
    memcpy(&nodes_hi[node * 3], b.hi, 12);
  }

  int32_t emit_leaf(int32_t node, const std::vector<Ref>& refs) {
    const auto start = static_cast<int64_t>(order.size());
    for (const Ref& r : refs) order.push_back(r.tri);
    child[node * 2] = static_cast<int32_t>(-(start + 1));
    child[node * 2 + 1] = static_cast<int32_t>(refs.size());
    return node;
  }

  // Subset recursion (refs moved in): object binned SAH, plus a spatial
  // split candidate when the object children overlap enough. Children own
  // disjoint (duplicated where straddling) reference subsets.
  int32_t build(std::vector<Ref> refs) {
    const int64_t count = static_cast<int64_t>(refs.size());
    AABB box, cbox;
    for (const Ref& r : refs) {
      box.grow(r.box);
      const float c[3] = {r.box.centroid(0), r.box.centroid(1),
                          r.box.centroid(2)};
      cbox.grow(c);
    }
    const int32_t node = new_node();
    set_box(node, box);
    if (count <= leaf_size) return emit_leaf(node, refs);

    // ---- object split: 16-bin SAH over the widest centroid axis ----------
    int o_axis = 0;
    float o_extent = 0;
    for (int k = 0; k < 3; ++k) {
      const float e = cbox.hi[k] - cbox.lo[k];
      if (e > o_extent) {
        o_extent = e;
        o_axis = k;
      }
    }
    float obj_cost = FLT_MAX;
    int obj_split = -1;
    AABB obj_lbox, obj_rbox;
    float o_scale = 0.f;
    if (o_extent >= 1e-12f) {
      o_scale = BINS / o_extent;
      AABB bin_box[BINS];
      int64_t bin_cnt[BINS] = {0};
      for (const Ref& r : refs) {
        const int b = std::min(
            std::max(static_cast<int>((r.box.centroid(o_axis) - cbox.lo[o_axis]) *
                                      o_scale),
                     0),
            BINS - 1);
        bin_box[b].grow(r.box);
        ++bin_cnt[b];
      }
      AABB racc[BINS];
      AABB acc;
      for (int b = BINS - 1; b > 0; --b) {
        acc.grow(bin_box[b]);
        racc[b] = acc;
      }
      AABB lacc;
      int64_t lcnt = 0;
      for (int b = 0; b < BINS - 1; ++b) {
        lacc.grow(bin_box[b]);
        lcnt += bin_cnt[b];
        if (lcnt == 0 || lcnt == count) continue;
        const float cost =
            lacc.area() * lcnt + racc[b + 1].area() * (count - lcnt);
        if (cost < obj_cost) {
          obj_cost = cost;
          obj_split = b;
          obj_lbox = lacc;
          obj_rbox = racc[b + 1];
        }
      }
    }

    // ---- spatial split candidate (SBVH) ---------------------------------
    // Gate: object children overlap enough relative to the root, and the
    // duplicate-reference budget is not exhausted.
    float spa_cost = FLT_MAX;
    int spa_axis = 0, spa_split = -1;
    float spa_plane = 0.f;
    if (spatial && extra_budget > 0 && obj_split >= 0) {
      AABB ov = obj_lbox;
      ov.clamp_to(obj_rbox);
      if (ov.valid() && ov.area() > SBVH_ALPHA * root_area) {
        int axis = 0;
        float extent = 0;
        for (int k = 0; k < 3; ++k) {
          const float e = box.hi[k] - box.lo[k];
          if (e > extent) {
            extent = e;
            axis = k;
          }
        }
        if (extent >= 1e-12f) {
          const float scale = BINS / extent;
          const float inv_scale = extent / BINS;
          AABB bin_box[BINS];
          int64_t entry[BINS] = {0}, exit_[BINS] = {0};
          float a[3], b3[3], c3[3];
          for (const Ref& r : refs) {
            int b_lo = std::min(
                std::max(static_cast<int>((r.box.lo[axis] - box.lo[axis]) * scale),
                         0),
                BINS - 1);
            int b_hi = std::min(
                std::max(static_cast<int>((r.box.hi[axis] - box.lo[axis]) * scale),
                         b_lo),
                BINS - 1);
            ++entry[b_lo];
            ++exit_[b_hi];
            if (b_lo == b_hi) {
              bin_box[b_lo].grow(r.box);
              continue;
            }
            tri_verts(r.tri, a, b3, c3);
            for (int b = b_lo; b <= b_hi; ++b) {
              AABB clipped = clip_tri_to_slab(
                  a, b3, c3, axis, box.lo[axis] + b * inv_scale,
                  box.lo[axis] + (b + 1) * inv_scale);
              clipped.clamp_to(r.box);
              if (clipped.valid()) bin_box[b].grow(clipped);
            }
          }
          AABB racc[BINS];
          AABB acc;
          int64_t rsum[BINS];
          int64_t rs = 0;
          for (int b = BINS - 1; b > 0; --b) {
            acc.grow(bin_box[b]);
            racc[b] = acc;
            rs += exit_[b];
            rsum[b] = rs;
          }
          AABB lacc;
          int64_t lcnt = 0;
          for (int b = 0; b < BINS - 1; ++b) {
            lacc.grow(bin_box[b]);
            lcnt += entry[b];
            const int64_t rcnt = rsum[b + 1];
            if (lcnt == 0 || rcnt == 0) continue;
            const float cost = lacc.area() * lcnt + racc[b + 1].area() * rcnt;
            if (cost < spa_cost) {
              spa_cost = cost;
              spa_split = b;
              spa_axis = axis;
              spa_plane = box.lo[axis] + (b + 1) * inv_scale;
            }
          }
        }
      }
    }

    std::vector<Ref> left, right;
    if (spa_split >= 0 && spa_cost < obj_cost) {
      // ---- apply the spatial split: straddlers clipped into both sides --
      left.reserve(refs.size());
      right.reserve(refs.size());
      float a[3], b3[3], c3[3];
      int64_t dups = 0;
      for (Ref& r : refs) {
        if (r.box.hi[spa_axis] <= spa_plane) {
          left.push_back(r);
        } else if (r.box.lo[spa_axis] >= spa_plane) {
          right.push_back(r);
        } else {
          tri_verts(r.tri, a, b3, c3);
          AABB lb = clip_tri_to_slab(a, b3, c3, spa_axis, -FLT_MAX, spa_plane);
          AABB rb = clip_tri_to_slab(a, b3, c3, spa_axis, spa_plane, FLT_MAX);
          lb.clamp_to(r.box);
          rb.clamp_to(r.box);
          const bool lv = lb.valid(), rv = rb.valid();
          if (lv && rv) {
            left.push_back({r.tri, lb});
            right.push_back({r.tri, rb});
            ++dups;
          } else if (lv) {
            left.push_back({r.tri, lb});
          } else if (rv) {
            right.push_back({r.tri, rb});
          } else {
            left.push_back(r);  // numeric fallback: keep the original
          }
        }
      }
      if (dups > extra_budget || left.empty() || right.empty()) {
        // over budget (keeps the 1.5x reference invariant exact) or
        // numeric degeneracy: fall back to the object split
        left.clear();
        right.clear();
      } else {
        extra_budget -= dups;
      }
    }
    if (left.empty() && right.empty()) {
      // ---- object split (or median fallback) ---------------------------
      int64_t mid;
      auto by_centroid = [&](const Ref& x, const Ref& y) {
        return x.box.centroid(o_axis) < y.box.centroid(o_axis);
      };
      if (obj_split < 0) {
        mid = count / 2;
        std::nth_element(refs.begin(), refs.begin() + mid, refs.end(),
                         by_centroid);
      } else {
        auto it = std::partition(refs.begin(), refs.end(), [&](const Ref& r) {
          const int b = std::min(
              std::max(static_cast<int>((r.box.centroid(o_axis) - cbox.lo[o_axis]) *
                                        o_scale),
                       0),
              BINS - 1);
          return b <= obj_split;
        });
        mid = it - refs.begin();
        if (mid == 0 || mid == count) {
          mid = count / 2;
          std::nth_element(refs.begin(), refs.begin() + mid, refs.end(),
                           by_centroid);
        }
      }
      left.assign(refs.begin(), refs.begin() + mid);
      right.assign(refs.begin() + mid, refs.end());
    }
    refs.clear();
    refs.shrink_to_fit();

    const int32_t l = build(std::move(left));
    const int32_t r = build(std::move(right));
    child[node * 2] = l;
    child[node * 2 + 1] = r;
    return node;
  }
};

}  // namespace

extern "C" {

// Build; returns opaque handle. v0/e1/e2 are [n,3] row-major float32.
// spatial != 0 enables SBVH spatial splits (duplicated references; query
// sah_num_refs for the resulting `order` length).
void* sah_build(const float* v0, const float* e1, const float* e2, int64_t n,
                int32_t leaf_size, int32_t spatial) {
  auto* b = new Builder{v0, e1, e2, n, leaf_size, spatial != 0};
  std::vector<Ref> refs(n);
  AABB root;
  for (int64_t i = 0; i < n; ++i) {
    float a[3], p1[3], p2[3];
    b->tri_verts(static_cast<int32_t>(i), a, p1, p2);
    Ref& r = refs[i];
    r.tri = static_cast<int32_t>(i);
    r.box.grow(a);
    r.box.grow(p1);
    r.box.grow(p2);
    root.grow(r.box);
  }
  b->root_area = root.area();
  b->extra_budget = n / 2;  // reference duplication cap: 1.5x tri count
  b->order.reserve(n + n / 2);
  if (n > 0) b->build(std::move(refs));
  return b;
}

int64_t sah_num_nodes(void* h) {
  return static_cast<Builder*>(h)->child.size() / 2;
}

// Total triangle references (= `order` length; > n when spatial splits
// duplicated references).
int64_t sah_num_refs(void* h) {
  return static_cast<int64_t>(static_cast<Builder*>(h)->order.size());
}

void sah_copy(void* h, float* nodes_lo, float* nodes_hi, int32_t* child,
              int32_t* order) {
  auto* b = static_cast<Builder*>(h);
  memcpy(nodes_lo, b->nodes_lo.data(), b->nodes_lo.size() * sizeof(float));
  memcpy(nodes_hi, b->nodes_hi.data(), b->nodes_hi.size() * sizeof(float));
  memcpy(child, b->child.data(), b->child.size() * sizeof(int32_t));
  memcpy(order, b->order.data(), b->order.size() * sizeof(int32_t));
}

void sah_free(void* h) { delete static_cast<Builder*>(h); }

}  // extern "C"
