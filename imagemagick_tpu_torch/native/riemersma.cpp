// Native color-quantization kernels: octree quantizer + error-diffusion
// dithers (Riemersma Hilbert-curve and serpentine Floyd-Steinberg).
//
// Re-derivation of the reference pipeline (ImageMagick's MagickCore/
// quantize.c — QuantizeImage:3260, ClassifyImageColors:755,
// ReduceImageColors:3655, Reduce:3556, PruneChild:3107,
// DefineImageColormap:1252, AssignImageColors:554, DitherImage:1973,
// RiemersmaDither:1688, FloydSteinbergDither:300, ClosestColor:1107,
// PosterizeImage:2236):
//
//  * classification inserts run-length-merged pixels into an octree
//    keyed by the 8-bit channel bits (MSB down), accumulating a
//    per-node quantization error = count * sqrt(sum((pixel-cellmid)^2))
//    in QuantumScale units; the first rows classify at depth 8 until
//    the color count exceeds the target, then the tree is pruned to the
//    computed cube depth (Log4(colors)+2, -1 for dither, -1 for alpha);
//  * reduction repeatedly prunes all nodes with error <= threshold,
//    raising the threshold to the minimum surviving error (with the
//    "rapid reduction" pre-threshold from the sorted error array);
//  * the colormap is the mean color of each surviving node
//    (children-first traversal order);
//  * assignment is deliberately LOCAL: descend the octree along the
//    pixel's bits until a child is missing, back up to the parent, and
//    take the closest (<=, ties to last-visited) colormap color within
//    that subtree — not always the global nearest.  Dithered paths add
//    a 6-bit/channel color cache (CacheShift=2 on non-Apple builds)
//    where the first pixel hashed into a cell decides for all later
//    ones.
//
// Error diffusion is inherently host-sequential (each step depends on
// the previous 16 errors), hence native code rather than TPU.  This
// file shares no code with the reference; constants and structure are
// re-stated from its published behavior.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int kQueue = 16;
constexpr int kDepth = 8;
constexpr long kMaxQNodes = 266817;

inline unsigned scale_to_char(double quantum) {
  // ScaleQuantumToChar, Q16 HDRI: (uchar)(q/257.0f + 0.5f), clamped.
  if (!(quantum > 0.0)) return 0;
  float f = (float)quantum / 257.0f;
  if (f >= 255.0f) return 255;
  return (unsigned)(f + 0.5f);
}

struct Node {
  Node *child[16];
  Node *parent;
  long number_unique = 0;
  double total[4] = {0, 0, 0, 0};   // QuantumScale-accumulated sums
  double quantize_error = 0.0;
  int level = 0;
  unsigned id = 0;
  int color_number = -1;
  Node() { std::memset(child, 0, sizeof(child)); parent = nullptr; }
};

struct Ctx {
  float *img;          // H*W*C, [0,1]
  long h, w, c;
  double diffusion = 1.0;
  double err[kQueue][4];    // err[0] = oldest
  double weights[kQueue];   // weights[0] applies to err[0]
  long x, y;
  std::vector<Node *> pool;
  Node *root = nullptr;
  long nodes = 0;
  long colors = 0;
  long maximum_colors = 0;
  int cube_depth = kDepth;
  double pruning_threshold = 0.0, next_threshold = 0.0;
  std::vector<double> colormap;   // color_number*4 + ch, quantum units
  std::vector<int> cache;         // 6-bit/channel key -> color_number
  bool use_alpha = false;

  // ClosestColor state
  double target[4];
  double best_distance;
  int best_number;

  Ctx() {
    std::memset(err, 0, sizeof(err));
    double weight = 1.0;
    for (int i = 0; i < kQueue; i++) {
      weights[i] = 1.0 / weight;
      weight *= std::exp(std::log(16.0) / (kQueue - 1.0));
    }
  }
  ~Ctx() { for (Node *n : pool) delete n; }

  Node *new_node(Node *parent, unsigned id, int level) {
    Node *n = new Node();
    n->parent = parent;
    n->id = id;
    n->level = level;
    pool.push_back(n);
    nodes++;
    return n;
  }

  int nkids() const { return use_alpha ? 16 : 8; }

  unsigned node_id(const unsigned c8[4], int index) const {
    unsigned id = ((c8[0] >> index) & 1u) | (((c8[1] >> index) & 1u) << 1) |
                  (((c8[2] >> index) & 1u) << 2);
    if (use_alpha) id |= ((c8[3] >> index) & 1u) << 3;
    return id;
  }

  // pixel `q` in quantum units with channel layout (r,g,b,a); gray
  // inputs mirror the gray value into g/b, alpha already associated
  // (premultiplied) by the caller.
  void channels8(const double q[4], unsigned c8[4]) const {
    c8[0] = scale_to_char(q[0]);
    c8[1] = scale_to_char(q[1]);
    c8[2] = scale_to_char(q[2]);
    c8[3] = use_alpha ? scale_to_char(q[3]) : 0;
  }

  // --- classification ------------------------------------------------

  // Insert one (possibly run-length `count`) pixel at `depth`,
  // accumulating the cell-midpoint quantization error along the path.
  void insert(const double q[4], long count, int depth) {
    unsigned c8[4];
    channels8(q, c8);
    int index = kDepth - 1;
    double bisect = 65536.0 / 2.0;
    double mid[4] = {32767.5, 32767.5, 32767.5, 32767.5};
    Node *node = root;
    for (int level = 1; level <= depth; level++) {
      bisect *= 0.5;
      unsigned id = node_id(c8, index);
      mid[0] += (id & 1) ? bisect : -bisect;
      mid[1] += (id & 2) ? bisect : -bisect;
      mid[2] += (id & 4) ? bisect : -bisect;
      mid[3] += (id & 8) ? bisect : -bisect;
      if (node->child[id] == nullptr) {
        node->child[id] = new_node(node, id, level);
        if (level == depth) colors++;
      }
      node = node->child[id];
      double er = (q[0] - mid[0]) / 65535.0;
      double eg = (q[1] - mid[1]) / 65535.0;
      double eb = (q[2] - mid[2]) / 65535.0;
      double ea = use_alpha ? (q[3] - mid[3]) / 65535.0 : 0.0;
      double distance = er * er + eg * eg + eb * eb + ea * ea;
      if (std::isnan(distance)) distance = 0.0;
      node->quantize_error += count * std::sqrt(distance);
      root->quantize_error += node->quantize_error;
      index--;
    }
    node->number_unique += count;
    for (int ch = 0; ch < 4; ch++)
      node->total[ch] += count * q[ch] / 65535.0;
    if (!use_alpha) node->total[3] += count * 1.0;
  }

  void load_pixel(const float *px, double q[4]) const {
    if (c >= 3) {
      q[0] = (double)px[0] * 65535.0;
      q[1] = (double)px[1] * 65535.0;
      q[2] = (double)px[2] * 65535.0;
      q[3] = c == 4 ? (double)px[3] * 65535.0 : 65535.0;
    } else {
      q[0] = q[1] = q[2] = (double)px[0] * 65535.0;
      q[3] = c == 2 ? (double)px[1] * 65535.0 : 65535.0;
    }
    if (use_alpha && q[3] != 65535.0) {
      double a = q[3] / 65535.0;
      q[0] *= a; q[1] *= a; q[2] *= a;
    }
  }

  void classify_image() {
    root = new_node(nullptr, 0, 0);
    long yy = 0;
    bool full_depth = true;
    for (yy = 0; yy < h; yy++) {
      if (nodes > kMaxQNodes) {
        prune_level(root);
        cube_depth--;
      }
      const float *row = img + yy * w * c;
      for (long xx = 0; xx < w;) {
        long count = 1;
        while (xx + count < w &&
               std::memcmp(row + xx * c, row + (xx + count) * c,
                           c * sizeof(float)) == 0)
          count++;
        double q[4];
        load_pixel(row + xx * c, q);
        insert(q, count, full_depth ? kDepth : cube_depth);
        xx += count;
      }
      if (full_depth && colors > maximum_colors) {
        prune_to_cube_depth(root);
        full_depth = false;
      }
    }
  }

  // --- pruning / reduction -------------------------------------------

  void prune_child(Node *node) {
    for (int i = 0; i < nkids(); i++)
      if (node->child[i]) prune_child(node->child[i]);
    if (nodes > maximum_colors && node->parent != nullptr) {
      Node *parent = node->parent;
      parent->number_unique += node->number_unique;
      for (int ch = 0; ch < 4; ch++) parent->total[ch] += node->total[ch];
      parent->child[node->id] = nullptr;
      nodes--;
    }
  }

  void prune_level(Node *node) {
    for (int i = 0; i < nkids(); i++)
      if (node->child[i]) prune_level(node->child[i]);
    if (node->level == cube_depth) prune_child(node);
  }

  void prune_to_cube_depth(Node *node) {
    for (int i = 0; i < nkids(); i++)
      if (node->child[i]) prune_to_cube_depth(node->child[i]);
    if (node->level > cube_depth) prune_child(node);
  }

  void flatten_errors(const Node *node, std::vector<double> &out) const {
    if ((long)out.size() >= nodes) return;
    out.push_back(node->quantize_error);
    for (int i = 0; i < nkids(); i++)
      if (node->child[i]) flatten_errors(node->child[i], out);
  }

  void reduce(Node *node) {
    for (int i = 0; i < nkids(); i++)
      if (node->child[i]) reduce(node->child[i]);
    if (node->quantize_error <= pruning_threshold)
      prune_child(node);
    else {
      if (node->number_unique > 0) colors++;
      if (node->quantize_error < next_threshold)
        next_threshold = node->quantize_error;
    }
  }

  void reduce_colors() {
    next_threshold = 0.0;
    if (colors > maximum_colors) {
      std::vector<double> errs;
      errs.reserve(nodes);
      flatten_errors(root, errs);
      std::sort(errs.begin(), errs.end());
      long cutoff = 110 * (maximum_colors + 1) / 100;
      if (nodes > cutoff) next_threshold = errs[nodes - cutoff];
    }
    while (colors > maximum_colors) {
      pruning_threshold = next_threshold;
      next_threshold = root->quantize_error - 1;
      colors = 0;
      reduce(root);
    }
  }

  // --- colormap ------------------------------------------------------

  void define_colormap(Node *node) {
    for (int i = 0; i < nkids(); i++)
      if (node->child[i]) define_colormap(node->child[i]);
    if (node->number_unique != 0) {
      double inv = 1.0 / (double)node->number_unique;
      node->color_number = (int)(colormap.size() / 4);
      if (!use_alpha) {
        colormap.push_back(inv * 65535.0 * node->total[0]);
        colormap.push_back(inv * 65535.0 * node->total[1]);
        colormap.push_back(inv * 65535.0 * node->total[2]);
        colormap.push_back(65535.0);
      } else {
        double a = inv * 65535.0 * node->total[3];
        // PerceptibleReciprocal of QuantumScale*alpha (1e12 floor)
        double gamma = a == 65535.0 ? 1.0
                       : (a / 65535.0 > 1e-12 ? 65535.0 / a : 1e12);
        colormap.push_back(inv * gamma * 65535.0 * node->total[0]);
        colormap.push_back(inv * gamma * 65535.0 * node->total[1]);
        colormap.push_back(inv * gamma * 65535.0 * node->total[2]);
        colormap.push_back(a);
      }
    }
  }

  // --- assignment ----------------------------------------------------

  void closest_color(const Node *node) {
    for (int i = 0; i < nkids(); i++)
      if (node->child[i]) closest_color(node->child[i]);
    if (node->number_unique != 0) {
      const double *p = &colormap[node->color_number * 4];
      // associate_alpha: color channels weighted by each side's alpha
      double aw = use_alpha ? p[3] / 65535.0 : 1.0;
      double bw = use_alpha ? target[3] / 65535.0 : 1.0;
      double d = aw * p[0] - bw * target[0];
      double distance = d * d;
      if (distance <= best_distance) {
        d = aw * p[1] - bw * target[1];
        distance += d * d;
        if (distance <= best_distance) {
          d = aw * p[2] - bw * target[2];
          distance += d * d;
          if (use_alpha) {
            double da = p[3] - target[3];
            distance += da * da;
          }
          if (distance <= best_distance) {
            best_distance = distance;
            best_number = node->color_number;
          }
        }
      }
    }
  }

  int lookup(const double q[4]) {
    unsigned c8[4];
    channels8(q, c8);
    Node *node = root;
    for (int index = kDepth - 1; index > 0; index--) {
      unsigned id = node_id(c8, index);
      if (node->child[id] == nullptr) break;
      node = node->child[id];
    }
    for (int ch = 0; ch < 4; ch++) target[ch] = q[ch];
    best_distance = 4.0 * 65536.0 * 65536.0 + 1.0;
    best_number = 0;
    closest_color(node->parent ? node->parent : node);
    return best_number;
  }

  int assign(const double q[4]) {   // cached variant (dither paths)
    unsigned c8[4];
    channels8(q, c8);
    // CacheShift=2 on non-Apple builds: 6 bits/channel cells
    unsigned key = (c8[0] >> 2) | ((c8[1] >> 2) << 6) | ((c8[2] >> 2) << 12);
    if (use_alpha) key |= (c8[3] >> 2) << 18;
    if (cache[key] >= 0) return cache[key];
    int number = lookup(q);
    cache[key] = number;
    return number;
  }

  // write colormap entry `number` to pixel `px`, return the premultiplied
  // quantum color used for the error term
  void emit(float *px, int number, double chosen_q[4]) const {
    const double *cm = &colormap[number * 4];
    double a = use_alpha ? cm[3] / 65535.0 : 1.0;
    // error is vs the ASSOCIATED (premultiplied) colormap color
    chosen_q[0] = cm[0] * (use_alpha && cm[3] != 65535.0 ? a : 1.0);
    chosen_q[1] = cm[1] * (use_alpha && cm[3] != 65535.0 ? a : 1.0);
    chosen_q[2] = cm[2] * (use_alpha && cm[3] != 65535.0 ? a : 1.0);
    chosen_q[3] = cm[3];
    if (c >= 3) {
      px[0] = (float)(cm[0] / 65535.0);
      px[1] = (float)(cm[1] / 65535.0);
      px[2] = (float)(cm[2] / 65535.0);
      if (c == 4) px[3] = (float)(cm[3] / 65535.0);
    } else {
      px[0] = (float)(cm[0] / 65535.0);
      if (c == 2) px[1] = (float)(cm[3] / 65535.0);
    }
  }
};

enum Dir { kNone, kWest, kEast, kNorth, kSouth };

void dither_step(Ctx &s, Dir dir) {
  if (s.x >= 0 && s.x < s.w && s.y >= 0 && s.y < s.h) {
    float *px = s.img + (s.y * s.w + s.x) * s.c;
    double pixel[4];
    s.load_pixel(px, pixel);
    int nch = s.use_alpha ? 4 : 3;
    for (int ch = 0; ch < nch; ch++) {
      double v = pixel[ch];
      for (int i = 0; i < kQueue; i++)
        v += (1.0 / 16.0) * s.diffusion * s.weights[i] * s.err[i][ch];
      if (v < 0.0) v = 0.0;
      if (v > 65535.0) v = 65535.0;
      pixel[ch] = v;
    }
    int number = s.assign(pixel);
    double chosen[4];
    s.emit(px, number, chosen);
    std::memmove(s.err, s.err + 1, (kQueue - 1) * sizeof(s.err[0]));
    for (int ch = 0; ch < 4; ch++)
      s.err[kQueue - 1][ch] = ch < nch ? pixel[ch] - chosen[ch] : 0.0;
  }
  switch (dir) {
    case kWest: s.x--; break;
    case kEast: s.x++; break;
    case kNorth: s.y--; break;
    case kSouth: s.y++; break;
    default: break;
  }
}

void riemersma(Ctx &s, int level, Dir dir) {
  if (level == 1) {
    switch (dir) {
      case kWest:
        dither_step(s, kEast); dither_step(s, kSouth);
        dither_step(s, kWest); break;
      case kEast:
        dither_step(s, kWest); dither_step(s, kNorth);
        dither_step(s, kEast); break;
      case kNorth:
        dither_step(s, kSouth); dither_step(s, kEast);
        dither_step(s, kNorth); break;
      case kSouth:
        dither_step(s, kNorth); dither_step(s, kWest);
        dither_step(s, kSouth); break;
      default: break;
    }
    return;
  }
  switch (dir) {
    case kWest:
      riemersma(s, level - 1, kNorth); dither_step(s, kEast);
      riemersma(s, level - 1, kWest);  dither_step(s, kSouth);
      riemersma(s, level - 1, kWest);  dither_step(s, kWest);
      riemersma(s, level - 1, kSouth); break;
    case kEast:
      riemersma(s, level - 1, kSouth); dither_step(s, kWest);
      riemersma(s, level - 1, kEast);  dither_step(s, kNorth);
      riemersma(s, level - 1, kEast);  dither_step(s, kEast);
      riemersma(s, level - 1, kNorth); break;
    case kNorth:
      riemersma(s, level - 1, kWest);  dither_step(s, kSouth);
      riemersma(s, level - 1, kNorth); dither_step(s, kEast);
      riemersma(s, level - 1, kNorth); dither_step(s, kNorth);
      riemersma(s, level - 1, kEast);  break;
    case kSouth:
      riemersma(s, level - 1, kEast);  dither_step(s, kNorth);
      riemersma(s, level - 1, kSouth); dither_step(s, kWest);
      riemersma(s, level - 1, kSouth); dither_step(s, kSouth);
      riemersma(s, level - 1, kWest);  break;
    default: break;
  }
}

void run_riemersma(Ctx &s) {
  s.x = 0; s.y = 0;
  long extent = s.h > s.w ? s.h : s.w;
  int level = (int)std::log2((double)extent);
  if ((1L << level) < extent) level++;
  if (level > 0) riemersma(s, level, kNorth);
  dither_step(s, kNone);
}

void run_floyd_steinberg(Ctx &s) {
  // FloydSteinbergDither: serpentine scan; the corrected pixel gains
  // 7/16 of the previous pixel's error plus 1/16 (ahead), 5/16 (below),
  // 3/16 (behind) of the previous row's.
  long h = s.h, w = s.w;
  std::vector<double> errbuf(2 * w * 4, 0.0);
  int nch = s.use_alpha ? 4 : 3;
  for (long y = 0; y < h; y++) {
    double *current = &errbuf[(y & 1) * w * 4];
    double *previous = &errbuf[((y + 1) & 1) * w * 4];
    long v = (y & 1) ? -1 : 1;
    for (long x = 0; x < w; x++) {
      long u = (y & 1) ? (w - 1 - x) : x;
      float *px = s.img + (y * w + u) * s.c;
      double pixel[4];
      s.load_pixel(px, pixel);
      if (x > 0)
        for (int ch = 0; ch < nch; ch++)
          pixel[ch] += 7.0 * s.diffusion * current[(u - v) * 4 + ch] / 16.0;
      if (y > 0) {
        if (x < w - 1)
          for (int ch = 0; ch < nch; ch++)
            pixel[ch] += s.diffusion * previous[(u + v) * 4 + ch] / 16.0;
        for (int ch = 0; ch < nch; ch++)
          pixel[ch] += 5.0 * s.diffusion * previous[u * 4 + ch] / 16.0;
        if (x > 0)
          for (int ch = 0; ch < nch; ch++)
            pixel[ch] += 3.0 * s.diffusion * previous[(u - v) * 4 + ch] / 16.0;
      }
      for (int ch = 0; ch < nch; ch++) {
        if (pixel[ch] < 0.0) pixel[ch] = 0.0;
        if (pixel[ch] > 65535.0) pixel[ch] = 65535.0;
      }
      int number = s.assign(pixel);
      double chosen[4];
      s.emit(px, number, chosen);
      for (int ch = 0; ch < 4; ch++)
        current[u * 4 + ch] = ch < nch ? pixel[ch] - chosen[ch] : 0.0;
    }
  }
}

void run_plain_assign(Ctx &s) {
  // AssignImageColors non-dither path: run-length groups, octree
  // lookup WITHOUT the color cache.
  for (long y = 0; y < s.h; y++) {
    float *row = s.img + y * s.w * s.c;
    for (long x = 0; x < s.w;) {
      long count = 1;
      while (x + count < s.w &&
             std::memcmp(row + x * s.c, row + (x + count) * s.c,
                         s.c * sizeof(float)) == 0)
        count++;
      double q[4];
      s.load_pixel(row + x * s.c, q);
      int number = s.lookup(q);
      double chosen[4];
      for (long i = 0; i < count; i++)
        s.emit(row + (x + i) * s.c, number, chosen);
      x += count;
    }
  }
}

void posterize_classify(Ctx &s, int levels) {
  // PosterizeImage map: lattice color x has channel j value
  // scale * ((x / levels^j) % levels), scale = QuantumRange/(levels-1).
  s.root = s.new_node(nullptr, 0, 0);
  long nch = s.use_alpha ? s.c : (s.c >= 3 ? 3 : 1);
  long ncolors = 1;
  for (long ch = 0; ch < nch; ch++) ncolors *= levels;
  double scale = 65535.0 / (levels - 1.0);
  for (long xcol = 0; xcol < ncolors; xcol++) {
    long rem = xcol;
    double raw[4] = {0, 0, 0, 0};
    for (long ch = 0; ch < nch; ch++) {
      raw[ch] = scale * (double)(rem % levels);
      rem /= levels;
    }
    double q[4];
    if (s.c >= 3) {
      q[0] = raw[0]; q[1] = raw[1]; q[2] = raw[2];
      q[3] = s.use_alpha ? raw[3] : 65535.0;
    } else {
      q[0] = q[1] = q[2] = raw[0];
      q[3] = s.use_alpha ? raw[1] : 65535.0;
    }
    if (s.use_alpha && q[3] != 65535.0) {
      double a = q[3] / 65535.0;
      q[0] *= a; q[1] *= a; q[2] *= a;
    }
    unsigned c8[4];
    s.channels8(q, c8);
    Node *node = s.root;
    for (int level = 1; level <= kDepth; level++) {
      unsigned id = s.node_id(c8, kDepth - level);
      if (node->child[id] == nullptr)
        node->child[id] = s.new_node(node, id, level);
      node = node->child[id];
    }
    if (node->number_unique == 0) {
      node->number_unique = 1;
      for (int ch = 0; ch < 3; ch++) node->total[ch] = q[ch] / 65535.0;
      node->total[3] = q[3] / 65535.0;
    }
  }
  s.define_colormap(s.root);
}

}  // namespace

extern "C" int rz_riemersma_posterize(float *img, long h, long w, long c,
                                      int levels, double diffusion) {
  if (levels < 2 || c < 1 || c > 4) return 1;
  Ctx s;
  s.img = img; s.h = h; s.w = w; s.c = c;
  s.diffusion = diffusion;
  s.use_alpha = (c == 4 || c == 2);
  s.maximum_colors = 65536;
  s.cache.assign(1u << 24, -1);
  posterize_classify(s, levels);
  run_riemersma(s);
  return 0;
}

extern "C" int rz_floyd_steinberg_posterize(float *img, long h, long w,
                                            long c, int levels,
                                            double diffusion) {
  if (levels < 2 || c < 1 || c > 4) return 1;
  Ctx s;
  s.img = img; s.h = h; s.w = w; s.c = c;
  s.diffusion = diffusion;
  s.use_alpha = (c == 4 || c == 2);
  s.maximum_colors = 65536;
  s.cache.assign(1u << 24, -1);
  posterize_classify(s, levels);
  run_floyd_steinberg(s);
  return 0;
}

// RemapImage: classify the palette colors at full depth (no reduction,
// maximum_colors = MaxColormapSize), then assign the target image with
// the octree/cache machinery.  dither_method: 0/1/2 as rz_quantize.
extern "C" int rz_remap(float *img, long h, long w, long c,
                        const float *palette, long npal, long pal_c,
                        int dither_method, double diffusion) {
  if (npal < 1 || c < 1 || c > 4 || pal_c < 1 || pal_c > 4) return 1;
  Ctx s;
  s.diffusion = diffusion;
  s.use_alpha = (pal_c == 4 || pal_c == 2);
  s.maximum_colors = 65536;
  s.cube_depth = kDepth;
  // classify the palette as a 1-row image
  s.img = const_cast<float *>(palette);
  s.h = 1; s.w = npal; s.c = pal_c;
  s.classify_image();
  s.define_colormap(s.root);
  // assign the target
  s.img = img; s.h = h; s.w = w; s.c = c;
  if (dither_method == 1) {
    s.cache.assign(1u << 24, -1);
    run_riemersma(s);
  } else if (dither_method == 2) {
    s.cache.assign(1u << 24, -1);
    run_floyd_steinberg(s);
  } else {
    run_plain_assign(s);
  }
  return 0;
}

// dither_method: 0 = none, 1 = Riemersma, 2 = Floyd-Steinberg.
// tree_depth 0 = the reference's automatic Log4 rule.
// palette_out must hold 4*max(max_colors, 256) floats ([0,1] RGBA);
// returns the palette size in *ncolors_out.
extern "C" int rz_quantize(float *img, long h, long w, long c,
                           long max_colors, int dither_method,
                           int tree_depth, double diffusion,
                           float *palette_out, long *ncolors_out) {
  if (max_colors < 1 || c < 1 || c > 4) return 1;
  if (max_colors > 65536) max_colors = 65536;
  Ctx s;
  s.img = img; s.h = h; s.w = w; s.c = c;
  s.diffusion = diffusion;
  s.use_alpha = (c == 4 || c == 2);
  s.maximum_colors = max_colors;
  int depth = tree_depth;
  if (depth == 0) {
    long colors = max_colors;
    for (depth = 1; colors != 0; depth++) colors >>= 2;
    if (dither_method != 0 && depth > 2) depth--;
    if (s.use_alpha && depth > 5) depth--;
  }
  if (depth > kDepth) depth = kDepth;
  if (depth < 2) depth = 2;
  s.cube_depth = depth;
  s.classify_image();
  if (s.colors > s.maximum_colors) s.reduce_colors();
  s.define_colormap(s.root);
  if (dither_method == 1) {
    s.cache.assign(1u << 24, -1);
    run_riemersma(s);
  } else if (dither_method == 2) {
    s.cache.assign(1u << 24, -1);
    run_floyd_steinberg(s);
  } else {
    run_plain_assign(s);
  }
  long n = (long)(s.colormap.size() / 4);
  if (ncolors_out) *ncolors_out = n;
  if (palette_out)
    for (long i = 0; i < n && i < 65536; i++)
      for (int ch = 0; ch < 4; ch++)
        palette_out[i * 4 + ch] = (float)(s.colormap[i * 4 + ch] / 65535.0);
  return 0;
}
