// pathtracer native runtime: image codec + glTF accessor unpacking.
//
// The counterpart of the reference's vendored native components:
// stb_image's texture decode (texture.cpp:5-13) and tinygltf's buffer/
// accessor extraction (model_loader.cpp:86-138). JAX/XLA owns the compute
// path; this library owns the host-side data path (asset IO), exposed to
// Python via ctypes (see pathtracer/utils/native.py).
//
// Build: make -C native   (g++ -O3 -shared -fPIC, links system zlib)
//
// Scope: 8-bit PNG decode (gray / gray+alpha / RGB / RGBA / palette,
// non-interlaced - Adam7 falls back to the Python path), PNG encode
// (RGB/RGBA/gray, filter 0), and strided glTF accessor unpacking for all
// component types. Anything unsupported returns a nonzero code and the
// Python caller falls back to PIL / numpy.

#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint8_t kPngSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(uint8_t(x >> 24));
  v.push_back(uint8_t(x >> 16));
  v.push_back(uint8_t(x >> 8));
  v.push_back(uint8_t(x));
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool inflate_all(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = static_cast<uInt>(n);
  uint8_t buf[1 << 16];
  int ret = Z_OK;
  while (ret != Z_STREAM_END) {
    zs.next_out = buf;
    zs.avail_out = sizeof(buf);
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.insert(out.end(), buf, buf + (sizeof(buf) - zs.avail_out));
  }
  inflateEnd(&zs);
  return true;
}

}  // namespace

extern "C" {

namespace {

// Scan the chunk list for a tRNS chunk (transparency for palette /
// colorkey images). Returns its body, or nullptr if absent.
const uint8_t* find_trns(const uint8_t* data, int64_t n, size_t* trns_n) {
  int64_t off = 8;
  while (off + 12 <= n) {
    uint32_t len = be32(data + off);
    const uint8_t* type = data + off + 4;
    if (off + 12 + len > n) return nullptr;
    if (std::memcmp(type, "tRNS", 4) == 0) {
      *trns_n = len;
      return data + off + 8;
    }
    if (std::memcmp(type, "IDAT", 4) == 0 ||
        std::memcmp(type, "IEND", 4) == 0)
      return nullptr;  // tRNS must precede IDAT
    off += 12 + len;
  }
  return nullptr;
}

}  // namespace

// Probe a PNG header: fills (width, height, channels) of the DECODED RGBA8
// output this library would produce. Returns 0 on "can decode", nonzero on
// "fall back to Python".
int pt_png_probe(const uint8_t* data, int64_t n, int32_t* width,
                 int32_t* height, int32_t* channels) {
  if (n < 33 || std::memcmp(data, kPngSig, 8) != 0) return 1;
  if (std::memcmp(data + 12, "IHDR", 4) != 0) return 2;
  uint32_t w = be32(data + 16), h = be32(data + 20);
  uint8_t depth = data[24], color = data[25], interlace = data[28];
  if (depth != 8 || interlace != 0) return 3;
  size_t trns_n = 0;
  const uint8_t* trns = find_trns(data, n, &trns_n);
  int ch;
  switch (color) {
    case 0: ch = 1; break;   // gray
    case 2: ch = 3; break;   // rgb
    case 3: ch = trns ? 4 : 3; break;  // palette -> rgb / rgba (tRNS)
    case 4: ch = 2; break;   // gray+alpha
    case 6: ch = 4; break;   // rgba
    default: return 4;
  }
  // gray/RGB colorkey transparency: rare; defer to the Python decoder
  if (trns && color != 3) return 6;
  if (w == 0 || h == 0 || w > (1u << 20) || h > (1u << 20)) return 5;
  *width = int32_t(w);
  *height = int32_t(h);
  *channels = ch;
  return 0;
}

// Decode an 8-bit non-interlaced PNG into out[h*w*channels] (layout as
// probed). Returns 0 on success.
int pt_png_decode(const uint8_t* data, int64_t n, uint8_t* out) {
  int32_t w, h, out_ch;
  if (pt_png_probe(data, n, &w, &h, &out_ch) != 0) return 1;
  uint8_t color = data[25];
  int src_ch = (color == 0) ? 1 : (color == 2) ? 3 : (color == 3) ? 1
               : (color == 4) ? 2 : 4;

  // gather IDAT, PLTE
  std::vector<uint8_t> idat;
  const uint8_t* plte = nullptr;
  size_t plte_n = 0;
  int64_t off = 8;
  while (off + 12 <= n) {
    uint32_t len = be32(data + off);
    const uint8_t* type = data + off + 4;
    const uint8_t* body = data + off + 8;
    if (off + 12 + len > n) return 2;
    if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      plte = body;
      plte_n = len;
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  if (idat.empty()) return 3;
  if (color == 3 && (plte == nullptr || plte_n % 3 != 0)) return 4;

  std::vector<uint8_t> raw;
  raw.reserve(size_t(h) * (size_t(w) * src_ch + 1));
  if (!inflate_all(idat.data(), idat.size(), raw)) return 5;
  size_t stride = size_t(w) * src_ch;
  if (raw.size() < size_t(h) * (stride + 1)) return 6;

  // unfilter in place into a scanline buffer
  std::vector<uint8_t> img(size_t(h) * stride);
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw.data() + size_t(y) * (stride + 1);
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    uint8_t* dst = img.data() + size_t(y) * stride;
    for (size_t x = 0; x < stride; ++x) {
      int a = (x >= size_t(src_ch)) ? dst[x - src_ch] : 0;
      int b = prev[x];
      int c = (x >= size_t(src_ch)) ? ((y > 0) ? prev[x - src_ch] : 0) : 0;
      int v = line[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return 7;
      }
      dst[x] = uint8_t(v);
    }
    std::memcpy(prev.data(), dst, stride);
  }

  // expand palette (+ tRNS alpha when probed as RGBA) / copy out
  if (color == 3) {
    size_t trns_n = 0;
    const uint8_t* trns = find_trns(data, n, &trns_n);
    for (size_t i = 0; i < size_t(h) * w; ++i) {
      uint8_t idx = img[i];
      if (size_t(idx) * 3 + 2 >= plte_n) return 8;
      out[i * out_ch + 0] = plte[idx * 3 + 0];
      out[i * out_ch + 1] = plte[idx * 3 + 1];
      out[i * out_ch + 2] = plte[idx * 3 + 2];
      if (out_ch == 4)
        out[i * 4 + 3] = (size_t(idx) < trns_n) ? trns[idx] : 255;
    }
  } else {
    std::memcpy(out, img.data(), img.size());
  }
  return 0;
}

// Encode u8 image [h, w, channels] (1, 3 or 4) as a PNG into out (caller
// allocates via pt_png_encode_bound). Writes actual size to *out_n.
int64_t pt_png_encode_bound(int32_t w, int32_t h, int32_t ch) {
  return compressBound(uLong(size_t(h) * (size_t(w) * ch + 1))) + 1024;
}

int pt_png_encode(const uint8_t* img, int32_t w, int32_t h, int32_t ch,
                  uint8_t* out, int64_t* out_n) {
  if (ch != 1 && ch != 3 && ch != 4) return 1;
  uint8_t color = (ch == 1) ? 0 : (ch == 3) ? 2 : 6;
  size_t stride = size_t(w) * ch;
  std::vector<uint8_t> raw(size_t(h) * (stride + 1));
  for (int y = 0; y < h; ++y) {
    raw[size_t(y) * (stride + 1)] = 0;  // filter: None
    std::memcpy(raw.data() + size_t(y) * (stride + 1) + 1,
                img + size_t(y) * stride, stride);
  }
  uLongf comp_n = compressBound(uLong(raw.size()));
  std::vector<uint8_t> comp(comp_n);
  if (compress2(comp.data(), &comp_n, raw.data(), uLong(raw.size()), 6) !=
      Z_OK)
    return 2;

  std::vector<uint8_t> png;
  png.reserve(comp_n + 1024);
  png.insert(png.end(), kPngSig, kPngSig + 8);
  auto chunk = [&png](const char* type, const uint8_t* body, size_t len) {
    put_be32(png, uint32_t(len));
    size_t start = png.size();
    png.insert(png.end(), type, type + 4);
    png.insert(png.end(), body, body + len);
    uint32_t crc = uint32_t(
        crc32(0, png.data() + start, uInt(4 + len)));
    put_be32(png, crc);
  };
  uint8_t ihdr[13];
  ihdr[0] = uint8_t(w >> 24); ihdr[1] = uint8_t(w >> 16);
  ihdr[2] = uint8_t(w >> 8); ihdr[3] = uint8_t(w);
  ihdr[4] = uint8_t(h >> 24); ihdr[5] = uint8_t(h >> 16);
  ihdr[6] = uint8_t(h >> 8); ihdr[7] = uint8_t(h);
  ihdr[8] = 8; ihdr[9] = color; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  chunk("IHDR", ihdr, 13);
  chunk("IDAT", comp.data(), comp_n);
  chunk("IEND", nullptr, 0);
  if (int64_t(png.size()) > *out_n) return 3;
  std::memcpy(out, png.data(), png.size());
  *out_n = int64_t(png.size());
  return 0;
}

// Unpack a (possibly strided) glTF accessor into contiguous float32.
// component_type: 5120 i8, 5121 u8, 5122 i16, 5123 u16, 5125 u32, 5126 f32
// normalized: apply the glTF normalization rules for integer types.
int pt_accessor_to_f32(const uint8_t* buf, int64_t buf_n, int64_t offset,
                       int32_t count, int32_t n_comp, int32_t component_type,
                       int32_t stride, int32_t normalized, float* out) {
  int comp_size;
  switch (component_type) {
    case 5120: case 5121: comp_size = 1; break;
    case 5122: case 5123: comp_size = 2; break;
    case 5125: case 5126: comp_size = 4; break;
    default: return 1;
  }
  int64_t elem = int64_t(comp_size) * n_comp;
  int64_t step = stride > 0 ? stride : elem;
  if (offset + (count > 0 ? (int64_t(count) - 1) * step + elem : 0) > buf_n)
    return 2;
  for (int32_t i = 0; i < count; ++i) {
    const uint8_t* p = buf + offset + int64_t(i) * step;
    for (int32_t c = 0; c < n_comp; ++c) {
      const uint8_t* q = p + int64_t(c) * comp_size;
      float v;
      switch (component_type) {
        case 5120: {
          int8_t x; std::memcpy(&x, q, 1);
          v = normalized ? (x < -127 ? -1.f : x / 127.f) : float(x);
          break;
        }
        case 5121: {
          uint8_t x = *q;
          v = normalized ? x / 255.f : float(x);
          break;
        }
        case 5122: {
          int16_t x; std::memcpy(&x, q, 2);
          v = normalized ? (x < -32767 ? -1.f : x / 32767.f) : float(x);
          break;
        }
        case 5123: {
          uint16_t x; std::memcpy(&x, q, 2);
          v = normalized ? x / 65535.f : float(x);
          break;
        }
        case 5125: {
          uint32_t x; std::memcpy(&x, q, 4);
          v = float(x);
          break;
        }
        default: {
          std::memcpy(&v, q, 4);
          break;
        }
      }
      out[int64_t(i) * n_comp + c] = v;
    }
  }
  return 0;
}

// Unpack index accessors (u8/u16/u32) into contiguous int32.
int pt_accessor_to_i32(const uint8_t* buf, int64_t buf_n, int64_t offset,
                       int32_t count, int32_t component_type, int32_t stride,
                       int32_t* out) {
  int comp_size;
  switch (component_type) {
    case 5121: comp_size = 1; break;
    case 5123: comp_size = 2; break;
    case 5125: comp_size = 4; break;
    default: return 1;
  }
  int64_t step = stride > 0 ? stride : comp_size;
  if (offset + (count > 0 ? (int64_t(count) - 1) * step + comp_size : 0) >
      buf_n)
    return 2;
  for (int32_t i = 0; i < count; ++i) {
    const uint8_t* q = buf + offset + int64_t(i) * step;
    uint32_t v = 0;
    switch (comp_size) {
      case 1: v = *q; break;
      case 2: { uint16_t x; std::memcpy(&x, q, 2); v = x; break; }
      default: { std::memcpy(&v, q, 4); break; }
    }
    out[i] = int32_t(v);
  }
  return 0;
}

// ---------------------------------------------------------------------
// Radiance RGBE (.hdr) scanline decode: fills the stb_image role for HDR
// environment maps (reference decodes textures via stb_image,
// pathtracer/source/core/texture.cpp:5-13; stb also handles .hdr).
// `data` points at the first scanline (caller parses the text header),
// output is linear f32 RGB [h*w*3]. Handles new-RLE scanlines
// (0x02 0x02 hi lo + 4 run-length-coded planes) and flat RGBE with
// old-style (1,1,1,n) repeats. Returns 0 on success.
int pt_hdr_decode(const uint8_t* data, int64_t n, int32_t w, int32_t h,
                  float* out) {
  if (w <= 0 || h <= 0) return 1;
  std::vector<uint8_t> row(size_t(w) * 4);
  int64_t pos = 0;
  for (int32_t y = 0; y < h; ++y) {
    if (w >= 8 && w <= 0x7FFF && pos + 4 <= n && data[pos] == 2 &&
        data[pos + 1] == 2 &&
        ((int32_t(data[pos + 2]) << 8) | data[pos + 3]) == w) {
      pos += 4;  // new-RLE scanline: four component planes
      for (int c = 0; c < 4; ++c) {
        int32_t x = 0;
        while (x < w) {
          if (pos >= n) return 2;
          int count = data[pos++];
          if (count > 128) {  // run
            count -= 128;
            if (pos >= n || x + count > w) return 2;
            uint8_t v = data[pos++];
            for (int i = 0; i < count; ++i) row[size_t(x + i) * 4 + c] = v;
          } else {            // literals
            if (pos + count > n || x + count > w) return 2;
            for (int i = 0; i < count; ++i)
              row[size_t(x + i) * 4 + c] = data[pos++];
          }
          x += count;
        }
      }
    } else {  // flat RGBE with old-style repeats
      int32_t x = 0;
      int shift = 0;
      while (x < w) {
        if (pos + 4 > n) return 2;
        const uint8_t* px = data + pos;
        pos += 4;
        if (px[0] == 1 && px[1] == 1 && px[2] == 1) {
          int64_t count = int64_t(px[3]) << shift;
          if (x == 0 || x + count > w) return 2;
          for (int64_t i = 0; i < count; ++i)
            std::memcpy(&row[size_t(x + i) * 4], &row[size_t(x - 1) * 4], 4);
          x += int32_t(count);
          shift += 8;
        } else {
          std::memcpy(&row[size_t(x) * 4], px, 4);
          ++x;
          shift = 0;
        }
      }
    }
    float* o = out + size_t(y) * w * 3;
    for (int32_t x = 0; x < w; ++x) {
      int e = row[size_t(x) * 4 + 3];
      float scale = e == 0 ? 0.0f : std::ldexp(1.0f, e - 136);
      o[x * 3 + 0] = row[size_t(x) * 4 + 0] * scale;
      o[x * 3 + 1] = row[size_t(x) * 4 + 1] * scale;
      o[x * 3 + 2] = row[size_t(x) * 4 + 2] * scale;
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Spatial-split SAH leaf build (SBVH-style) - the host-side accel build.
//
// Native counterpart of accel/cluster.py:_sah_split_leaves (which stays as
// the pure-Python fallback and the semantics oracle). The reference gets
// its acceleration structure from the driver's native build
// (core/accel.h:21-45, buildAccelerationStructuresKHR); here the "driver"
// is this library: top-down binned SAH over triangle references with
// SBVH spatial splits (straddling triangles are duplicated into clipped
// boxes, capped at dup_budget * T references), producing flat leaves of
// <= k triangles for the cluster/packet traversal.
//
// Semantics mirror the Python build (same binning, same cost model, same
// commit rules); floating-point tie-breaks may differ, which only moves
// leaf boundaries - coverage invariants and traversal exactness are
// independent of the partition (tests/test_packet.py).

namespace {

struct SahRef {
  int32_t tri;
  float lo[3];
  float hi[3];
};

inline float box_area(const float lo[3], const float hi[3]) {
  float e0 = hi[0] - lo[0], e1 = hi[1] - lo[1], e2 = hi[2] - lo[2];
  if (e0 < 0) e0 = 0;
  if (e1 < 0) e1 = 0;
  if (e2 < 0) e2 = 0;
  return e0 * e1 + e1 * e2 + e0 * e2;
}

constexpr float kInf = std::numeric_limits<float>::infinity();

struct BinBox {
  float lo[3] = {kInf, kInf, kInf};
  float hi[3] = {-kInf, -kInf, -kInf};
  void extend(const float l[3], const float h[3]) {
    for (int c = 0; c < 3; ++c) {
      if (l[c] < lo[c]) lo[c] = l[c];
      if (h[c] > hi[c]) hi[c] = h[c];
    }
  }
};

}  // namespace

extern "C" {

// Build SBVH-style SAH leaves over t triangles. Outputs:
//   n_leaves_out      <- number of leaves L
//   leaf_off[0..L]    <- prefix offsets into leaf_ids (leaf i owns
//                        ids[leaf_off[i]..leaf_off[i+1])), deduplicated
//   leaf_ids          <- triangle ids per leaf
//   leaf_lo/leaf_hi   <- [L, 3] clipped-union cluster AABBs
// Capacities: cap_leaves rows in leaf_off-1/leaf_lo/leaf_hi, cap_ids in
// leaf_ids; both are satisfied by int(dup_budget * t) + 8. Returns 0 on
// success, 1 on capacity overflow, 2 on bad arguments.
int pt_sah_split_build(const float* v0, const float* v1, const float* v2,
                       int64_t t, int32_t k, int32_t n_bins,
                       float dup_budget, int32_t* n_leaves_out,
                       int32_t* leaf_off, int32_t* leaf_ids, float* leaf_lo,
                       float* leaf_hi, int32_t cap_leaves, int64_t cap_ids) {
  if (t <= 0 || k <= 0 || n_bins < 2 || n_bins > 256 || dup_budget < 1.0f)
    return 2;
  const int64_t budget = int64_t(dup_budget * double(t));

  // refs: one per triangle initially; spatial splits append clipped copies
  std::vector<SahRef> refs(static_cast<size_t>(t));
  for (int64_t i = 0; i < t; ++i) {
    SahRef& r = refs[size_t(i)];
    r.tri = int32_t(i);
    for (int c = 0; c < 3; ++c) {
      float a = v0[i * 3 + c], b = v1[i * 3 + c], d = v2[i * 3 + c];
      r.lo[c] = std::min(a, std::min(b, d));
      r.hi[c] = std::max(a, std::max(b, d));
    }
  }
  int64_t refs_total = t;

  std::vector<std::vector<int32_t>> stack;
  {
    std::vector<int32_t> all(static_cast<size_t>(t));
    for (int64_t i = 0; i < t; ++i) all[size_t(i)] = int32_t(i);
    stack.push_back(std::move(all));
  }

  int32_t n_leaves = 0;
  int64_t ids_used = 0;
  leaf_off[0] = 0;
  std::vector<BinBox> bins(static_cast<size_t>(n_bins));
  std::vector<int64_t> cnt(static_cast<size_t>(n_bins));
  std::vector<int64_t> enter_c(static_cast<size_t>(n_bins)), exit_c(static_cast<size_t>(n_bins));
  std::vector<BinBox> pre(static_cast<size_t>(n_bins)), suf(static_cast<size_t>(n_bins));

  auto sweep_cost = [&](const std::vector<BinBox>& bb,
                        const std::vector<int64_t>& nl,
                        const std::vector<int64_t>& nr, int* best_j) {
    // prefix/suffix box sweeps + SAH cost; nl[j]/nr[j] are counts for the
    // plane after bin j (left = bins 0..j, right = bins j+1..)
    pre[0] = bb[0];
    for (int j = 1; j < n_bins; ++j) {
      pre[size_t(j)] = pre[size_t(j - 1)];
      pre[size_t(j)].extend(bb[size_t(j)].lo, bb[size_t(j)].hi);
    }
    suf[size_t(n_bins - 1)] = bb[size_t(n_bins - 1)];
    for (int j = n_bins - 2; j >= 0; --j) {
      suf[size_t(j)] = suf[size_t(j + 1)];
      suf[size_t(j)].extend(bb[size_t(j)].lo, bb[size_t(j)].hi);
    }
    float best = kInf;
    *best_j = -1;
    for (int j = 0; j < n_bins - 1; ++j) {
      if (nl[size_t(j)] == 0 || nr[size_t(j)] == 0) continue;
      float c = box_area(pre[size_t(j)].lo, pre[size_t(j)].hi) *
                    float(nl[size_t(j)]) +
                box_area(suf[size_t(j + 1)].lo, suf[size_t(j + 1)].hi) *
                    float(nr[size_t(j)]);
      if (c < best) {
        best = c;
        *best_j = j;
      }
    }
    return best;
  };

  while (!stack.empty()) {
    std::vector<int32_t> idx = std::move(stack.back());
    stack.pop_back();
    const int64_t n = int64_t(idx.size());

    if (n <= k) {  // emit a leaf: dedup tri ids, clipped-union box
      if (n_leaves >= cap_leaves) return 1;
      BinBox u;
      std::vector<int32_t> ids;
      ids.reserve(size_t(n));
      for (int32_t ri : idx) {
        const SahRef& r = refs[size_t(ri)];
        u.extend(r.lo, r.hi);
        ids.push_back(r.tri);
      }
      std::sort(ids.begin(), ids.end());
      ids.erase(std::unique(ids.begin(), ids.end()), ids.end());
      if (ids_used + int64_t(ids.size()) > cap_ids) return 1;
      for (int32_t id : ids) leaf_ids[ids_used++] = id;
      leaf_off[n_leaves + 1] = int32_t(ids_used);
      for (int c = 0; c < 3; ++c) {
        leaf_lo[n_leaves * 3 + c] = u.lo[c];
        leaf_hi[n_leaves * 3 + c] = u.hi[c];
      }
      ++n_leaves;
      continue;
    }

    // node bounds: centroid box (clo/chi) for object bins, ref box
    // (nlo/nhi) for spatial planes
    float clo[3] = {kInf, kInf, kInf}, chi[3] = {-kInf, -kInf, -kInf};
    float nlo[3] = {kInf, kInf, kInf}, nhi[3] = {-kInf, -kInf, -kInf};
    for (int32_t ri : idx) {
      const SahRef& r = refs[size_t(ri)];
      for (int c = 0; c < 3; ++c) {
        float cen = (r.lo[c] + r.hi[c]) * 0.5f;
        if (cen < clo[c]) clo[c] = cen;
        if (cen > chi[c]) chi[c] = cen;
        if (r.lo[c] < nlo[c]) nlo[c] = r.lo[c];
        if (r.hi[c] > nhi[c]) nhi[c] = r.hi[c];
      }
    }

    // --- object split (centroid bins, SAH over ref boxes) ---
    float obj_cost = kInf;
    int obj_axis = -1, obj_bin = -1;
    for (int ax = 0; ax < 3; ++ax) {
      const float ext = chi[ax] - clo[ax];
      if (!(ext > 0)) continue;
      const float scale = float(n_bins) / ext;
      for (int j = 0; j < n_bins; ++j) {
        bins[size_t(j)] = BinBox();
        cnt[size_t(j)] = 0;
      }
      for (int32_t ri : idx) {
        const SahRef& r = refs[size_t(ri)];
        int b = int(((r.lo[ax] + r.hi[ax]) * 0.5f - clo[ax]) * scale);
        if (b > n_bins - 1) b = n_bins - 1;
        if (b < 0) b = 0;
        bins[size_t(b)].extend(r.lo, r.hi);
        ++cnt[size_t(b)];
      }
      std::vector<int64_t> nl(size_t(n_bins), 0), nr(size_t(n_bins), 0);
      int64_t acc = 0;
      for (int j = 0; j < n_bins; ++j) {
        acc += cnt[size_t(j)];
        nl[size_t(j)] = acc;
        nr[size_t(j)] = n - acc;
      }
      int j;
      float c = sweep_cost(bins, nl, nr, &j);
      if (j >= 0 && c < obj_cost) {
        obj_cost = c;
        obj_axis = ax;
        obj_bin = j;
      }
    }

    // --- spatial split (uniform planes over the node box) ---
    float spa_cost = kInf, spa_px = 0.0f;
    int spa_axis = -1;
    if (refs_total < budget) {
      for (int ax = 0; ax < 3; ++ax) {
        const float nex = nhi[ax] - nlo[ax];
        if (!(nex > 0)) continue;
        const float scale = float(n_bins) / nex;
        for (int j = 0; j < n_bins; ++j) {
          bins[size_t(j)] = BinBox();
          enter_c[size_t(j)] = 0;
          exit_c[size_t(j)] = 0;
        }
        for (int32_t ri : idx) {
          const SahRef& r = refs[size_t(ri)];
          int lob = int((r.lo[ax] - nlo[ax]) * scale);
          int hib = int((r.hi[ax] - nlo[ax]) * scale);
          if (lob < 0) lob = 0;
          if (lob > n_bins - 1) lob = n_bins - 1;
          if (hib < 0) hib = 0;
          if (hib > n_bins - 1) hib = n_bins - 1;
          ++enter_c[size_t(lob)];
          ++exit_c[size_t(hib)];
          for (int bb = lob; bb <= hib; ++bb) {
            float l[3] = {r.lo[0], r.lo[1], r.lo[2]};
            float h[3] = {r.hi[0], r.hi[1], r.hi[2]};
            const float slab_lo = nlo[ax] + float(bb) / scale;
            const float slab_hi = nlo[ax] + float(bb + 1) / scale;
            if (l[ax] < slab_lo) l[ax] = slab_lo;
            if (h[ax] > slab_hi) h[ax] = slab_hi;
            bins[size_t(bb)].extend(l, h);
          }
        }
        std::vector<int64_t> nl(size_t(n_bins), 0), nr(size_t(n_bins), 0);
        int64_t ein = 0, eout = 0;
        for (int j = 0; j < n_bins; ++j) {
          ein += enter_c[size_t(j)];
          eout += exit_c[size_t(j)];
          nl[size_t(j)] = ein;       // refs with lob <= j
          nr[size_t(j)] = n - eout;  // refs with hib > j
        }
        int j;
        float c = sweep_cost(bins, nl, nr, &j);
        if (j >= 0 && c < spa_cost) {
          spa_cost = c;
          spa_axis = ax;
          spa_px = nlo[ax] + float(j + 1) / scale;
        }
      }
    }

    if (spa_axis >= 0 && spa_cost < obj_cost) {
      const int ax = spa_axis;
      const float px = spa_px;
      // one classification pass: 0 = left, 1 = right, 2 = straddler
      // (degenerate box == plane goes left)
      std::vector<uint8_t> side(idx.size());
      int64_t n_new = 0, cl = 0, cr = 0;
      for (size_t i = 0; i < idx.size(); ++i) {
        const SahRef& r = refs[size_t(idx[i])];
        const bool gl = r.lo[ax] < px || r.hi[ax] <= px;
        const bool gr = r.hi[ax] > px;
        side[i] = (gl && gr) ? 2 : (gl ? 0 : 1);
        if (side[i] == 2) ++n_new;
        if (gl) ++cl;
        if (gr) ++cr;
      }
      if (refs_total + n_new <= budget && cl > 0 && cr > 0) {
        std::vector<int32_t> li, ri_;
        li.reserve(idx.size());
        ri_.reserve(idx.size());
        for (size_t i = 0; i < idx.size(); ++i) {
          const int32_t ri = idx[i];
          if (side[i] == 2) {  // straddler: left keeps clip, right a copy
            SahRef& r = refs[size_t(ri)];
            SahRef nr_ = r;
            nr_.lo[ax] = std::max(nr_.lo[ax], px);
            r.hi[ax] = px;
            li.push_back(ri);
            ri_.push_back(int32_t(refs.size()));
            refs.push_back(nr_);
          } else if (side[i] == 0) {
            li.push_back(ri);
          } else {
            ri_.push_back(ri);
          }
        }
        refs_total += n_new;
        stack.push_back(std::move(li));
        stack.push_back(std::move(ri_));
        continue;
      }
      // budget blown or one-sided plane: fall through to object split
    }

    if (obj_axis >= 0) {
      const int ax = obj_axis;
      const float scale = float(n_bins) / (chi[ax] - clo[ax]);
      std::vector<int32_t> li, ri_;
      li.reserve(idx.size());
      ri_.reserve(idx.size());
      for (int32_t ri : idx) {
        const SahRef& r = refs[size_t(ri)];
        int b = int(((r.lo[ax] + r.hi[ax]) * 0.5f - clo[ax]) * scale);
        if (b > n_bins - 1) b = n_bins - 1;
        if (b < 0) b = 0;
        (b <= obj_bin ? li : ri_).push_back(ri);
      }
      stack.push_back(std::move(li));
      stack.push_back(std::move(ri_));
      continue;
    }

    // degenerate centroids AND no spatial split: split by index halves
    std::vector<int32_t> li(idx.begin(), idx.begin() + idx.size() / 2);
    std::vector<int32_t> ri_(idx.begin() + idx.size() / 2, idx.end());
    stack.push_back(std::move(li));
    stack.push_back(std::move(ri_));
  }

  *n_leaves_out = n_leaves;
  return 0;
}

}  // extern "C"
