/* Native image IO: 8-bit RGB/RGBA PNG encode/decode (zlib) + PFM float maps.
 *
 * Replaces the reference's Blender-side image plumbing
 * (bpy.data.images.load / RenderResult "Combined" pass,
 * raytracer/RelativisticRenderEngine.py:78-90,158-168) for the standalone
 * framework's output path; the async frame writer (writer.cpp) calls the
 * encoder off the render thread.
 */
#include "bgc.h"

#include <zlib.h>

#include <cmath>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

inline void put_be32(std::vector<uint8_t>* out, uint32_t v) {
  out->push_back((uint8_t)(v >> 24));
  out->push_back((uint8_t)(v >> 16));
  out->push_back((uint8_t)(v >> 8));
  out->push_back((uint8_t)v);
}

void put_chunk(std::vector<uint8_t>* out, const char tag[4],
               const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out->size();
  out->insert(out->end(), (const uint8_t*)tag, (const uint8_t*)tag + 4);
  if (len) out->insert(out->end(), data, data + len);
  uint32_t crc =
      crc32(0, out->data() + start, (uInt)(4 + len));
  put_be32(out, crc);
}

/* Paeth predictor (PNG spec 9.4). */
inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

int bgc_write_png(const char* path, const uint8_t* data, int32_t h, int32_t w,
                  int32_t c, int32_t compress_level) {
  if (!path || !data || h < 1 || w < 1 || (c != 3 && c != 4)) return 1;
  if (compress_level < 0 || compress_level > 9) compress_level = 6;
  const size_t stride = (size_t)w * c;

  /* Filter: Sub for the first row, Up for the rest -- cheap and compresses
   * rendered gradients far better than filter 0. */
  std::vector<uint8_t> raw((stride + 1) * h);
  for (int32_t y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + (stride + 1) * y;
    const uint8_t* src = data + stride * y;
    if (y == 0) {
      row[0] = 1; /* Sub */
      for (size_t i = 0; i < stride; ++i)
        row[1 + i] = (uint8_t)(src[i] - (i >= (size_t)c ? src[i - c] : 0));
    } else {
      row[0] = 2; /* Up */
      const uint8_t* up = src - stride;
      for (size_t i = 0; i < stride; ++i)
        row[1 + i] = (uint8_t)(src[i] - up[i]);
    }
  }

  uLongf zcap = compressBound((uLong)raw.size());
  std::vector<uint8_t> zbuf(zcap);
  if (compress2(zbuf.data(), &zcap, raw.data(), (uLong)raw.size(),
                compress_level) != Z_OK)
    return 2;

  std::vector<uint8_t> out;
  out.reserve(zcap + 128);
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (uint8_t)(w >> 24); ihdr[1] = (uint8_t)(w >> 16);
  ihdr[2] = (uint8_t)(w >> 8);  ihdr[3] = (uint8_t)w;
  ihdr[4] = (uint8_t)(h >> 24); ihdr[5] = (uint8_t)(h >> 16);
  ihdr[6] = (uint8_t)(h >> 8);  ihdr[7] = (uint8_t)h;
  ihdr[8] = 8;                        /* bit depth */
  ihdr[9] = (c == 3) ? 2 : 6;         /* color type */
  ihdr[10] = ihdr[11] = ihdr[12] = 0; /* deflate / adaptive / no interlace */
  put_chunk(&out, "IHDR", ihdr, 13);
  put_chunk(&out, "IDAT", zbuf.data(), zcap);
  put_chunk(&out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return 3;
  size_t nw = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return nw == out.size() ? 0 : 4;
}

int bgc_read_png(const char* path, uint8_t* data, int32_t* h, int32_t* w,
                 int32_t* c) {
  if (!path || !h || !w || !c) return 1;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 2;
  std::fseek(f, 0, SEEK_END);
  long fsz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsz < 45) { std::fclose(f); return 3; }
  std::vector<uint8_t> buf((size_t)fsz);
  if (std::fread(buf.data(), 1, (size_t)fsz, f) != (size_t)fsz) {
    std::fclose(f);
    return 3;
  }
  std::fclose(f);

  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (std::memcmp(buf.data(), sig, 8) != 0) return 4;

  int32_t W = 0, H = 0, C = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    const uint8_t* tag = &buf[pos + 4];
    const uint8_t* payload = &buf[pos + 8];
    if (pos + 12 + len > buf.size()) return 5;
    if (!std::memcmp(tag, "IHDR", 4)) {
      if (len != 13) return 5;
      W = (int32_t)be32(payload);
      H = (int32_t)be32(payload + 4);
      int depth = payload[8], color = payload[9], interlace = payload[12];
      if (depth != 8 || interlace != 0) return 6; /* unsupported */
      if (color == 2) C = 3;
      else if (color == 6) C = 4;
      else return 6;
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (W < 1 || H < 1 || C == 0) return 5;
  if (!data) { /* shape query */
    *h = H; *w = W; *c = C;
    return 0;
  }
  if (*h != H || *w != W || *c != C) return 7; /* caller buffer mismatch */

  const size_t stride = (size_t)W * C;
  std::vector<uint8_t> raw((stride + 1) * H);
  uLongf rawlen = (uLongf)raw.size();
  if (uncompress(raw.data(), &rawlen, idat.data(), (uLong)idat.size()) != Z_OK
      || rawlen != raw.size())
    return 8;

  /* Unfilter (all 5 filter types). */
  for (int32_t y = 0; y < H; ++y) {
    const uint8_t* row = raw.data() + (stride + 1) * y;
    uint8_t ft = row[0];
    const uint8_t* src = row + 1;
    uint8_t* dst = data + stride * y;
    const uint8_t* up = y > 0 ? dst - stride : nullptr;
    for (size_t i = 0; i < stride; ++i) {
      int a = i >= (size_t)C ? dst[i - C] : 0;
      int b = up ? up[i] : 0;
      int cc = (up && i >= (size_t)C) ? up[i - C] : 0;
      int v = src[i];
      switch (ft) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, cc); break;
        default: return 9;
      }
      dst[i] = (uint8_t)v;
    }
  }
  return 0;
}

int bgc_write_pfm(const char* path, const float* data, int32_t h, int32_t w) {
  if (!path || !data || h < 1 || w < 1) return 1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return 2;
  /* scale -1.0 -> little-endian; rows bottom-to-top per spec */
  std::fprintf(f, "PF\n%d %d\n-1.0\n", w, h);
  int rc = 0;
  for (int32_t y = h - 1; y >= 0; --y) {
    if (std::fwrite(data + (size_t)y * w * 3, sizeof(float), (size_t)w * 3,
                    f) != (size_t)w * 3) {
      rc = 3;
      break;
    }
  }
  std::fclose(f);
  return rc;
}

int bgc_read_pfm(const char* path, float* data, int32_t* h, int32_t* w) {
  if (!path || !h || !w) return 1;
  FILE* f = std::fopen(path, "rb");
  if (!f) return 2;
  char magic[3] = {0};
  int W, H;
  float scale;
  if (std::fscanf(f, "%2s %d %d %f", magic, &W, &H, &scale) != 4 ||
      std::strcmp(magic, "PF") != 0 || scale >= 0) {
    std::fclose(f);
    return 3; /* only little-endian color PFM (what we write) */
  }
  std::fgetc(f); /* single whitespace after the header */
  if (!data) {
    *h = H; *w = W;
    std::fclose(f);
    return 0;
  }
  if (*h != H || *w != W) { std::fclose(f); return 7; }
  int rc = 0;
  for (int32_t y = H - 1; y >= 0; --y) {
    if (std::fread(data + (size_t)y * W * 3, sizeof(float), (size_t)W * 3, f)
        != (size_t)W * 3) {
      rc = 4;
      break;
    }
  }
  std::fclose(f);
  return rc;
}

void bgc_quantize(const float* in, uint8_t* out, int64_t n_px, int32_t c,
                  int32_t srgb) {
  const int64_t n = n_px * c;
  for (int64_t i = 0; i < n; ++i) {
    float v = in[i];
    if (srgb && (c != 4 || (i % c) != 3)) { /* alpha stays linear */
      v = v <= 0.0031308f ? 12.92f * v
                          : 1.055f * std::pow(v, 1.0f / 2.4f) - 0.055f;
    }
    v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    out[i] = (uint8_t)(v * 255.0f + 0.5f);
  }
}

}  // extern "C"
