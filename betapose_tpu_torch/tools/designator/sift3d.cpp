// sift3d — 3D SIFT keypoint designation over a mesh point cloud.
//
// Native replacement for the reference's PCL-based designator
// (1_keypoint_designator/main.cpp): detects scale-space extrema of the
// z-field (PCL's SIFTKeypointFieldSelector<PointXYZ> uses p.z as the
// "intensity") over a kd-tree scale space, with the same parameters:
//   min_scale = 0.01, n_octaves = 10, n_scales_per_octave = 5,
//   min_contrast = 0.2
// Algorithm follows pcl::SIFTKeypoint semantics: per octave, build
// nr_scales+3 Gaussian-smoothed versions of the field (weighted average of
// neighbors within 2*max_scale), difference adjacent scales, and mark
// points whose interior-scale DoG value is a strict extremum among the
// 25 nearest neighbors across the three adjacent scales and exceeds the
// contrast threshold.
//
// Self-contained: own PLY reader (ascii + binary_little_endian), own
// kd-tree. CLI: sift3d <in.ply> <out.ply> [vis]   (vis is accepted for
// interface parity and ignored — no GUI in this build).
//
// Build: g++ -O3 -march=native -std=c++17 -o sift3d sift3d.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <numeric>
#include <queue>
#include <sstream>
#include <string>
#include <vector>

struct P3 { float x, y, z; };

// ---------------------------------------------------------------------------
// Minimal PLY reader: extracts the vertex x/y/z properties.
// ---------------------------------------------------------------------------
static bool read_ply(const std::string &path, std::vector<P3> &pts) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::string line;
  if (!std::getline(f, line)) return false;
  // strip \r
  auto strip = [](std::string &s) {
    while (!s.empty() && (s.back() == '\r' || s.back() == '\n')) s.pop_back();
  };
  strip(line);
  if (line != "ply") return false;

  bool binary = false;
  size_t n_vertex = 0;
  struct Prop { std::string name; int size; bool is_list; int count_size; int item_size; };
  std::vector<Prop> vprops;
  bool in_vertex = false;
  std::vector<std::pair<size_t, int>> other_elements;  // (count, row bytes) after vertex

  auto type_size = [](const std::string &t) -> int {
    if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
    if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
    if (t == "int" || t == "uint" || t == "int32" || t == "uint32" || t == "float" || t == "float32") return 4;
    if (t == "double" || t == "float64") return 8;
    return 4;
  };

  bool vertex_seen_first = true;
  while (std::getline(f, line)) {
    strip(line);
    std::istringstream ss(line);
    std::string tok; ss >> tok;
    if (tok == "format") {
      std::string fmt; ss >> fmt;
      binary = (fmt == "binary_little_endian");
      if (fmt == "binary_big_endian") { std::cerr << "big endian unsupported\n"; return false; }
    } else if (tok == "element") {
      std::string name; size_t cnt; ss >> name >> cnt;
      if (name == "vertex") { n_vertex = cnt; in_vertex = true; }
      else { in_vertex = false; if (n_vertex == 0) vertex_seen_first = false; }
    } else if (tok == "property" && in_vertex) {
      std::string t; ss >> t;
      Prop p; p.is_list = false;
      if (t == "list") {
        std::string ct, it; ss >> ct >> it >> p.name;
        p.is_list = true; p.count_size = type_size(ct); p.item_size = type_size(it);
        p.size = 0;
      } else {
        ss >> p.name; p.size = type_size(t);
        if (t == "double" || t == "float64") p.size = -8;  // mark double
      }
      vprops.push_back(p);
    } else if (tok == "end_header") {
      break;
    }
  }
  (void)vertex_seen_first;
  if (n_vertex == 0) return false;
  pts.resize(n_vertex);

  int xi = -1, yi = -1, zi = -1;
  for (size_t i = 0; i < vprops.size(); ++i) {
    if (vprops[i].name == "x") xi = (int)i;
    if (vprops[i].name == "y") yi = (int)i;
    if (vprops[i].name == "z") zi = (int)i;
  }
  if (xi < 0 || yi < 0 || zi < 0) return false;

  if (!binary) {
    for (size_t r = 0; r < n_vertex; ++r) {
      if (!std::getline(f, line)) return false;
      std::istringstream ss(line);
      std::vector<double> vals;
      double v;
      while (ss >> v) vals.push_back(v);
      if ((int)vals.size() < 3) return false;
      pts[r].x = (float)vals[xi]; pts[r].y = (float)vals[yi]; pts[r].z = (float)vals[zi];
    }
  } else {
    for (size_t r = 0; r < n_vertex; ++r) {
      double coord[3] = {0, 0, 0};
      for (size_t p = 0; p < vprops.size(); ++p) {
        const Prop &pr = vprops[p];
        if (pr.is_list) { std::cerr << "list property in vertex unsupported\n"; return false; }
        int sz = pr.size < 0 ? -pr.size : pr.size;
        unsigned char buf[8];
        f.read((char *)buf, sz);
        double val = 0;
        if (pr.size == -8) { double d; std::memcpy(&d, buf, 8); val = d; }
        else if (sz == 4 && ((int)p == xi || (int)p == yi || (int)p == zi)) { float fv; std::memcpy(&fv, buf, 4); val = fv; }
        else if (sz == 4) { float fv; std::memcpy(&fv, buf, 4); val = fv; }
        else if (sz == 2) { uint16_t u; std::memcpy(&u, buf, 2); val = u; }
        else if (sz == 1) { val = buf[0]; }
        if ((int)p == xi) coord[0] = val;
        if ((int)p == yi) coord[1] = val;
        if ((int)p == zi) coord[2] = val;
      }
      pts[r].x = (float)coord[0]; pts[r].y = (float)coord[1]; pts[r].z = (float)coord[2];
    }
  }
  return true;
}

static void write_ply_ascii(const std::string &path,
                            const std::vector<P3> &pts) {
  std::ofstream f(path);
  f << "ply\nformat ascii 1.0\n";
  f << "element vertex " << pts.size() << "\n";
  f << "property float x\nproperty float y\nproperty float z\n";
  f << "end_header\n";
  for (const auto &p : pts) f << p.x << " " << p.y << " " << p.z << "\n";
}

// ---------------------------------------------------------------------------
// kd-tree (3D) with radius and k-nearest queries.
// ---------------------------------------------------------------------------
class KdTree {
 public:
  explicit KdTree(const std::vector<P3> &pts) : pts_(pts) {
    idx_.resize(pts.size());
    std::iota(idx_.begin(), idx_.end(), 0);
    nodes_.reserve(pts.size() * 2);
    root_ = build(0, (int)pts.size(), 0);
  }

  void radius_search(const P3 &q, float radius,
                     std::vector<int> &out_idx,
                     std::vector<float> &out_d2) const {
    out_idx.clear(); out_d2.clear();
    radius_rec(root_, q, radius * radius, out_idx, out_d2);
  }

  void knn(const P3 &q, int k, std::vector<int> &out_idx) const {
    // max-heap of (d2, idx)
    std::priority_queue<std::pair<float, int>> heap;
    knn_rec(root_, q, k, heap);
    out_idx.resize(heap.size());
    for (int i = (int)heap.size() - 1; i >= 0; --i) {
      out_idx[i] = heap.top().second;
      heap.pop();
    }
  }

 private:
  struct Node { int left, right, axis; int begin, end; float split; };
  static constexpr int LEAF = 16;

  int build(int b, int e, int depth) {
    Node n; n.begin = b; n.end = e; n.left = n.right = -1; n.axis = depth % 3;
    int id = (int)nodes_.size();
    nodes_.push_back(n);
    if (e - b <= LEAF) return id;
    int m = (b + e) / 2;
    int ax = n.axis;
    std::nth_element(idx_.begin() + b, idx_.begin() + m, idx_.begin() + e,
                     [&](int a, int c) { return coord(a, ax) < coord(c, ax); });
    nodes_[id].split = coord(idx_[m], ax);
    int l = build(b, m, depth + 1);
    int r = build(m, e, depth + 1);
    nodes_[id].left = l; nodes_[id].right = r;
    return id;
  }

  float coord(int i, int ax) const {
    const P3 &p = pts_[i];
    return ax == 0 ? p.x : (ax == 1 ? p.y : p.z);
  }
  static float qcoord(const P3 &q, int ax) {
    return ax == 0 ? q.x : (ax == 1 ? q.y : q.z);
  }
  static float d2(const P3 &a, const P3 &b) {
    float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
    return dx * dx + dy * dy + dz * dz;
  }

  void radius_rec(int id, const P3 &q, float r2,
                  std::vector<int> &oi, std::vector<float> &od) const {
    const Node &n = nodes_[id];
    if (n.left < 0) {
      for (int i = n.begin; i < n.end; ++i) {
        float d = d2(pts_[idx_[i]], q);
        if (d <= r2) { oi.push_back(idx_[i]); od.push_back(d); }
      }
      return;
    }
    float diff = qcoord(q, n.axis) - n.split;
    int near = diff <= 0 ? n.left : n.right;
    int far = diff <= 0 ? n.right : n.left;
    radius_rec(near, q, r2, oi, od);
    if (diff * diff <= r2) radius_rec(far, q, r2, oi, od);
  }

  void knn_rec(int id, const P3 &q, int k,
               std::priority_queue<std::pair<float, int>> &heap) const {
    const Node &n = nodes_[id];
    if (n.left < 0) {
      for (int i = n.begin; i < n.end; ++i) {
        float d = d2(pts_[idx_[i]], q);
        if ((int)heap.size() < k) heap.push({d, idx_[i]});
        else if (d < heap.top().first) { heap.pop(); heap.push({d, idx_[i]}); }
      }
      return;
    }
    float diff = qcoord(q, n.axis) - n.split;
    int near = diff <= 0 ? n.left : n.right;
    int far = diff <= 0 ? n.right : n.left;
    knn_rec(near, q, k, heap);
    if ((int)heap.size() < k || diff * diff < heap.top().first)
      knn_rec(far, q, k, heap);
  }

  const std::vector<P3> &pts_;
  std::vector<int> idx_;
  std::vector<Node> nodes_;
  int root_;
};

// ---------------------------------------------------------------------------
// 3D SIFT (pcl::SIFTKeypoint semantics)
// ---------------------------------------------------------------------------
struct SiftParams {
  float min_scale = 0.01f;
  int n_octaves = 10;
  int n_scales_per_octave = 5;
  float min_contrast = 0.2f;
};

static void compute_scale_space(const std::vector<P3> &pts, const KdTree &tree,
                                const std::vector<float> &field,
                                const std::vector<float> &scales,
                                std::vector<std::vector<float>> &dog) {
  const size_t n = pts.size();
  const int ns = (int)scales.size();
  const float max_radius = 2.0f * scales.back();
  std::vector<std::vector<float>> smoothed(
      ns, std::vector<float>(n, 0.0f));
  std::vector<int> nn;
  std::vector<float> nd;
  for (size_t i = 0; i < n; ++i) {
    tree.radius_search(pts[i], max_radius, nn, nd);
    for (int s = 0; s < ns; ++s) {
      const float sigma2 = scales[s] * scales[s];
      double num = 0.0, den = 0.0;
      for (size_t j = 0; j < nn.size(); ++j) {
        const float w = std::exp(-nd[j] / (2.0f * sigma2));
        num += (double)field[nn[j]] * w;
        den += w;
      }
      smoothed[s][i] = den > 0 ? (float)(num / den) : field[i];
    }
  }
  dog.assign(ns - 1, std::vector<float>(n));
  for (int s = 0; s < ns - 1; ++s)
    for (size_t i = 0; i < n; ++i)
      dog[s][i] = smoothed[s + 1][i] - smoothed[s][i];
}

static void find_extrema(const std::vector<P3> &pts, const KdTree &tree,
                         const std::vector<std::vector<float>> &dog,
                         float min_contrast,
                         std::vector<int> &out_indices) {
  const int K = 25;  // pcl::SIFTKeypoint::findScaleSpaceExtrema
  const size_t n = pts.size();
  const int nr = (int)dog.size();
  std::vector<int> nn;
  for (size_t i = 0; i < n; ++i) {
    tree.knn(pts[i], K, nn);
    for (int s = 1; s < nr - 1; ++s) {
      const float v = dog[s][i];
      if (std::fabs(v) < min_contrast) continue;
      bool is_min = true, is_max = true;
      for (int ds = s - 1; ds <= s + 1 && (is_min || is_max); ++ds) {
        for (size_t j = 0; j < nn.size(); ++j) {
          if (ds == s && nn[j] == (int)i) continue;
          const float nv = dog[ds][nn[j]];
          if (nv >= v) is_max = false;
          if (nv <= v) is_min = false;
          if (!is_min && !is_max) break;
        }
      }
      if (is_min || is_max) {
        out_indices.push_back((int)i);
        break;  // one detection per point per octave (first extremal scale)
      }
    }
  }
}

static std::vector<P3> extract_sift(const std::vector<P3> &pts,
                                    const SiftParams &prm) {
  KdTree tree(pts);
  std::vector<float> field(pts.size());
  for (size_t i = 0; i < pts.size(); ++i) field[i] = pts[i].z;

  std::vector<P3> result;
  float scale = prm.min_scale;
  for (int o = 0; o < prm.n_octaves; ++o) {
    const int s = prm.n_scales_per_octave;
    std::vector<float> scales(s + 3);
    for (int i = 0; i < s + 3; ++i)
      scales[i] = scale * std::pow(2.0f, (float)(i - 1) / (float)s);
    std::vector<std::vector<float>> dog;
    compute_scale_space(pts, tree, field, scales, dog);
    std::vector<int> idxs;
    find_extrema(pts, tree, dog, prm.min_contrast, idxs);
    for (int id : idxs) result.push_back(pts[id]);
    scale *= 2.0f;
  }
  return result;
}

int main(int argc, char **argv) {
  if (argc < 3) {
    std::cerr << "Usage: sift3d <in.ply> <out.ply> [vis]\n";
    return -1;
  }
  std::vector<P3> pts;
  if (!read_ply(argv[1], pts)) {
    std::cerr << "failed to read " << argv[1] << "\n";
    return -1;
  }
  std::cerr << "loaded " << pts.size() << " points\n";
  SiftParams prm;
  if (const char *e = std::getenv("SIFT3D_MIN_SCALE")) prm.min_scale = std::stof(e);
  if (const char *e = std::getenv("SIFT3D_OCTAVES")) prm.n_octaves = std::stoi(e);
  if (const char *e = std::getenv("SIFT3D_SCALES")) prm.n_scales_per_octave = std::stoi(e);
  if (const char *e = std::getenv("SIFT3D_MIN_CONTRAST")) prm.min_contrast = std::stof(e);
  auto result = extract_sift(pts, prm);
  std::cerr << "# of SIFT points in the result are " << result.size() << "\n";
  write_ply_ascii(argv[2], result);
  if (argc >= 4) std::cerr << "(visualization not supported in this build)\n";
  return 0;
}
