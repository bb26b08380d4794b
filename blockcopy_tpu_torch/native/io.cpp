// Native data-loading runtime: PNG decode + bilinear resize + normalize.
//
// The port's counterpart of the JAX package's clip IO library, its
// arithmetic unchanged, so that both decode the same bytes to the same
// floats: a small self-contained library (zlib for inflate, no other deps)
// that decodes Cityscapes-style PNGs, resizes, and normalizes straight into
// a float32 NHWC buffer, with a std::thread pool for batch/clip decode, and
// CPU NMS / soft-NMS.  Exposed to Python over a C ABI via ctypes
// (blockcopy_tpu_torch/native/__init__.py), built by g++ at first use
// (blockcopy_tpu_torch/ops/kernels/build.py) with -O3 and no fast-math.
//
// Supported PNGs: 8-bit gray (0), RGB (2), palette (3), gray+alpha (4),
// RGBA (6); no interlacing (Cityscapes/CityPersons images are plain RGB8).

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> data;     // HWC, palette expanded to RGB
  std::vector<uint8_t> indices;  // raw palette indices (color_type 3 only):
                                 // label PNGs need the index, not its color
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  bool ok = fread(out.data(), 1, n, f) == size_t(n);
  fclose(f);
  return ok;
}

bool inflate_all(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = n;
  std::vector<uint8_t> buf(1 << 20);
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    zs.next_out = buf.data();
    zs.avail_out = buf.size();
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), buf.data(), buf.data() + (buf.size() - zs.avail_out));
  }
  inflateEnd(&zs);
  return true;
}

bool decode_png(const char* path, Image& img) {
  std::vector<uint8_t> file;
  if (!read_file(path, file) || file.size() < 45) return false;
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (memcmp(file.data(), magic, 8) != 0) return false;

  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // RGB triples
  size_t pos = 8;
  while (pos + 8 <= file.size()) {
    uint32_t len = rd_u32(&file[pos]);
    const char* type = reinterpret_cast<const char*>(&file[pos + 4]);
    const uint8_t* dat = &file[pos + 8];
    if (pos + 12 + len > file.size()) return false;
    if (!memcmp(type, "IHDR", 4)) {
      w = rd_u32(dat);
      h = rd_u32(dat + 4);
      bit_depth = dat[8];
      color_type = dat[9];
      interlace = dat[12];
      if (bit_depth != 8 || interlace != 0) return false;
    } else if (!memcmp(type, "PLTE", 4)) {
      palette.assign(dat, dat + len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), dat, dat + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (w <= 0 || h <= 0) return false;

  int src_c;
  switch (color_type) {
    case 0: src_c = 1; break;
    case 2: src_c = 3; break;
    case 3: src_c = 1; break;
    case 4: src_c = 2; break;
    case 6: src_c = 4; break;
    default: return false;
  }
  std::vector<uint8_t> raw;
  raw.reserve(size_t(h) * (size_t(w) * src_c + 1));
  if (!inflate_all(idat.data(), idat.size(), raw)) return false;
  size_t stride = size_t(w) * src_c;
  if (raw.size() < size_t(h) * (stride + 1)) return false;

  // unfilter in place into `un`
  std::vector<uint8_t> un(size_t(h) * stride);
  for (int y = 0; y < h; y++) {
    uint8_t filter = raw[size_t(y) * (stride + 1)];
    const uint8_t* src = &raw[size_t(y) * (stride + 1) + 1];
    uint8_t* dst = &un[size_t(y) * stride];
    const uint8_t* up = y > 0 ? &un[size_t(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= size_t(src_c) ? dst[x - src_c] : 0;
      int b = up ? up[x] : 0;
      int c = (up && x >= size_t(src_c)) ? up[x - src_c] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
  }

  // expand to 3-channel RGB (gray/palette/alpha handled)
  img.w = w;
  img.h = h;
  img.c = 3;
  img.data.resize(size_t(w) * h * 3);
  for (size_t i = 0; i < size_t(w) * h; i++) {
    uint8_t r, g, b;
    switch (color_type) {
      case 0: r = g = b = un[i]; break;
      case 2: r = un[i * 3]; g = un[i * 3 + 1]; b = un[i * 3 + 2]; break;
      case 3: {
        uint8_t p = un[i];
        if (img.indices.empty()) img.indices.resize(size_t(w) * h);
        img.indices[i] = p;  // label consumers want the raw index
        if (size_t(p) * 3 + 2 < palette.size()) {
          r = palette[p * 3]; g = palette[p * 3 + 1]; b = palette[p * 3 + 2];
        } else {
          r = g = b = p;
        }
        break;
      }
      case 4: r = g = b = un[i * 2]; break;
      default: r = un[i * 4]; g = un[i * 4 + 1]; b = un[i * 4 + 2]; break;
    }
    img.data[i * 3] = r;
    img.data[i * 3 + 1] = g;
    img.data[i * 3 + 2] = b;
  }
  return true;
}

// PIL-style antialiased bilinear resampling (separable triangle filter with
// support scaled by the downscale factor — what Image.resize(BILINEAR)
// does), then normalize ((x/255 - mean) / std) into float32 NHWC.  Matches
// the reference's PIL-based ExtResize transform.
struct Taps {
  std::vector<int> start;     // per output index: first source index
  std::vector<int> count;     // taps per output index
  std::vector<double> coef;   // flattened weights, max_taps per output
  int max_taps = 0;
};

Taps make_taps(int in_size, int out_size) {
  Taps t;
  double scale = double(in_size) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;  // triangle filter support
  int max_taps = int(ceil(support)) * 2 + 1;
  t.max_taps = max_taps;
  t.start.resize(out_size);
  t.count.resize(out_size);
  t.coef.assign(size_t(out_size) * max_taps, 0.0);
  for (int o = 0; o < out_size; o++) {
    double center = (o + 0.5) * scale;
    int xmin = int(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = int(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    double total = 0.0;
    for (int x = xmin; x < xmax; x++) {
      double d = (x - center + 0.5) / filterscale;
      double w = d < 0 ? (d > -1 ? 1 + d : 0) : (d < 1 ? 1 - d : 0);
      t.coef[size_t(o) * max_taps + (x - xmin)] = w;
      total += w;
    }
    if (total != 0.0)
      for (int k = 0; k < xmax - xmin; k++)
        t.coef[size_t(o) * max_taps + k] /= total;
    t.start[o] = xmin;
    t.count[o] = xmax - xmin;
  }
  return t;
}

void resize_normalize(const Image& img, int out_w, int out_h,
                      const float* mean, const float* std_, float* out) {
  if (img.w == out_w && img.h == out_h) {
    for (size_t i = 0; i < size_t(out_w) * out_h; i++)
      for (int c = 0; c < 3; c++)
        out[i * 3 + c] = (img.data[i * 3 + c] / 255.0f - mean[c]) / std_[c];
    return;
  }
  Taps tx = make_taps(img.w, out_w);
  Taps ty = make_taps(img.h, out_h);
  // horizontal pass: (h, out_w, 3) doubles
  std::vector<double> tmp(size_t(img.h) * out_w * 3);
  for (int y = 0; y < img.h; y++) {
    const uint8_t* row = &img.data[size_t(y) * img.w * 3];
    for (int ox = 0; ox < out_w; ox++) {
      const double* cf = &tx.coef[size_t(ox) * tx.max_taps];
      int s = tx.start[ox], n = tx.count[ox];
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < n; k++) {
        double w = cf[k];
        const uint8_t* px = &row[(s + k) * 3];
        acc[0] += w * px[0];
        acc[1] += w * px[1];
        acc[2] += w * px[2];
      }
      double* dst = &tmp[(size_t(y) * out_w + ox) * 3];
      dst[0] = acc[0]; dst[1] = acc[1]; dst[2] = acc[2];
    }
  }
  // vertical pass + normalize
  for (int oy = 0; oy < out_h; oy++) {
    const double* cf = &ty.coef[size_t(oy) * ty.max_taps];
    int s = ty.start[oy], n = ty.count[oy];
    for (int ox = 0; ox < out_w; ox++) {
      double acc[3] = {0, 0, 0};
      for (int k = 0; k < n; k++) {
        const double* px = &tmp[(size_t(s + k) * out_w + ox) * 3];
        double w = cf[k];
        acc[0] += w * px[0];
        acc[1] += w * px[1];
        acc[2] += w * px[2];
      }
      float* dst = &out[(size_t(oy) * out_w + ox) * 3];
      for (int c = 0; c < 3; c++)
        dst[c] = (float(acc[c]) / 255.0f - mean[c]) / std_[c];
    }
  }
}

}  // namespace

extern "C" {

// Decode one image to float32 NHWC (resized to out_w x out_h, normalized).
// Returns 0 on success.
int bc_decode_image(const char* path, int out_w, int out_h,
                    const float* mean, const float* std_, float* out) {
  Image img;
  if (!decode_png(path, img)) return 1;
  resize_normalize(img, out_w, out_h, mean, std_, out);
  return 0;
}

// Decode raw label PNG (no resize/normalize); out must hold w*h uint8;
// returns 0 on success and writes dims.
int bc_decode_label(const char* path, uint8_t* out, int* w, int* h,
                    int max_bytes) {
  Image img;
  if (!decode_png(path, img)) return 1;
  if (img.w * img.h > max_bytes) return 2;
  *w = img.w;
  *h = img.h;
  if (!img.indices.empty()) {
    // palette PNG: the class id is the palette INDEX, never its RGB color
    for (size_t i = 0; i < size_t(img.w) * img.h; i++)
      out[i] = img.indices[i];
  } else {
    for (size_t i = 0; i < size_t(img.w) * img.h; i++)
      out[i] = img.data[i * 3];  // gray value replicated in R
  }
  return 0;
}

// Threaded clip decode: n images into one contiguous (n, out_h, out_w, 3)
// buffer.  Returns number of failures.
int bc_decode_batch(const char** paths, int n, int out_w, int out_h,
                    const float* mean, const float* std_, float* out,
                    int num_threads) {
  std::atomic<int> next(0), failures(0);
  int nt = num_threads > 0 ? num_threads : 4;
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (bc_decode_image(paths[i], out_w, out_h, mean, std_,
                          out + size_t(i) * out_w * out_h * 3) != 0)
        failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Greedy NMS on (n, 5) xyxy+score dets (score-sorted not required).
// keep_out gets indices of kept dets; returns count.
int bc_nms(const float* dets, int n, float iou_thr, int* keep_out) {
  std::vector<int> order(n);
  for (int i = 0; i < n; i++) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  std::vector<char> suppressed(n, 0);
  int kept = 0;
  for (int oi = 0; oi < n; oi++) {
    int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = i;
    float x1 = dets[i * 5], y1 = dets[i * 5 + 1];
    float x2 = dets[i * 5 + 2], y2 = dets[i * 5 + 3];
    float ai = std::max(x2 - x1 + 1, 0.f) * std::max(y2 - y1 + 1, 0.f);
    for (int oj = oi + 1; oj < n; oj++) {
      int j = order[oj];
      if (suppressed[j]) continue;
      float xx1 = std::max(x1, dets[j * 5]);
      float yy1 = std::max(y1, dets[j * 5 + 1]);
      float xx2 = std::min(x2, dets[j * 5 + 2]);
      float yy2 = std::min(y2, dets[j * 5 + 3]);
      float w = std::max(xx2 - xx1 + 1, 0.f), h = std::max(yy2 - yy1 + 1, 0.f);
      float inter = w * h;
      float aj = std::max(dets[j * 5 + 2] - dets[j * 5] + 1, 0.f) *
                 std::max(dets[j * 5 + 3] - dets[j * 5 + 1] + 1, 0.f);
      if (inter / std::max(ai + aj - inter, 1e-10f) > iou_thr)
        suppressed[j] = 1;
    }
  }
  return kept;
}

// Soft-NMS (method: 0=linear, 1=gaussian, 2=naive); modifies dets_inout
// ((n,5) row-major) in place, writes kept original indices, returns count.
// Protocol-exact port of the reference's Cython soft_nms_cpu
// (Pedestron/mmdet/ops/nms/src/soft_nms_cpu.pyx): a box whose decayed
// score drops below min_score is REMOVED immediately (swapped with the
// last active row) so it can never act as a suppression pivot later.
// Decay + removal run only inside the positive-overlap (iw>0 && ih>0)
// branch, as in the pyx — a never-overlapping box below min_score
// survives.
// On return rows [0, count) are the kept detections in processed order,
// positionally aligned with keep_out.
int bc_soft_nms(float* dets, int n, float iou_thr, int method, float sigma,
                float min_score, int* keep_out) {
  std::vector<int> inds(n);
  for (int i = 0; i < n; i++) inds[i] = i;
  int n_act = n;
  for (int i = 0; i < n_act; i++) {
    int max_pos = i;
    for (int j = i + 1; j < n_act; j++)
      if (dets[j * 5 + 4] > dets[max_pos * 5 + 4]) max_pos = j;
    for (int k = 0; k < 5; k++) std::swap(dets[i * 5 + k], dets[max_pos * 5 + k]);
    std::swap(inds[i], inds[max_pos]);
    float x1 = dets[i * 5], y1 = dets[i * 5 + 1];
    float x2 = dets[i * 5 + 2], y2 = dets[i * 5 + 3];
    float ai = std::max(x2 - x1 + 1, 0.f) * std::max(y2 - y1 + 1, 0.f);
    for (int j = i + 1; j < n_act; j++) {
      float xx1 = std::max(x1, dets[j * 5]);
      float yy1 = std::max(y1, dets[j * 5 + 1]);
      float xx2 = std::min(x2, dets[j * 5 + 2]);
      float yy2 = std::min(y2, dets[j * 5 + 3]);
      float w = std::max(xx2 - xx1 + 1, 0.f), h = std::max(yy2 - yy1 + 1, 0.f);
      float inter = w * h;
      float aj = std::max(dets[j * 5 + 2] - dets[j * 5] + 1, 0.f) *
                 std::max(dets[j * 5 + 3] - dets[j * 5 + 1] + 1, 0.f);
      if (w > 0 && h > 0) {
        float ov = inter / std::max(ai + aj - inter, 1e-10f);
        float weight = 1.0f;
        if (method == 0) weight = ov > iou_thr ? 1 - ov : 1.0f;
        else if (method == 1) weight = expf(-(ov * ov) / sigma);
        else weight = ov > iou_thr ? 0.0f : 1.0f;
        dets[j * 5 + 4] *= weight;
        if (dets[j * 5 + 4] < min_score) {
          // reference pyx: replace with the last active box and re-examine
          n_act--;
          for (int k = 0; k < 5; k++) dets[j * 5 + k] = dets[n_act * 5 + k];
          inds[j] = inds[n_act];
          j--;
        }
      }
    }
  }
  for (int i = 0; i < n_act; i++) keep_out[i] = inds[i];
  return n_act;
}

}  // extern "C"
