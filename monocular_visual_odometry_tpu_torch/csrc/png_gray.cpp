// PNG rows to grayscale float32: undo the five row filters and convert to
// gray the way libpng's read transformations do.
//
// The caller (runtime/__init__.py) has parsed the chunks and inflated the
// IDAT stream with zlib; this function gets the filtered scanlines (one
// filter-type byte, then the row's bytes), undoes the filters in place
// (Paeth and Average depend on the byte to the left, so a row is
// sequential along x) and writes [height, width] float32 in 0..255:
//   - 16-bit samples keep their high byte (png_set_strip_16);
//   - gray of 1, 2 or 4 bits is scaled to 8 (png_set_expand_gray_1_2_4_to_8);
//   - palette indices expand to the palette's RGB (png_set_palette_to_rgb;
//     a tRNS chunk is not read, so there is no alpha);
//   - alpha is dropped (png_set_strip_alpha);
//   - RGB goes to gray with png_set_rgb_to_gray_fixed's default weights
//     (6968, 23434, 2366)/32768, truncated for 8-bit samples, rounded at 16
//     bits before the high byte is kept, as png_do_rgb_to_gray computes it
//     without gamma.
// Non-interlaced images only (the caller rejects Adam7).
//
// C ABI (ctypes):
//   int mvo_png_to_gray(uint8_t* rows, int64_t n_bytes, int width, int height,
//                       int bit_depth, int color_type, const uint8_t* palette,
//                       int n_palette, float* out, char* err, int err_len)
// returns 0, or -3 with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstdlib>

namespace {

constexpr uint32_t kRed = 6968, kGreen = 23434, kBlue = 32768 - kRed - kGreen;

int fail(char* err, int err_len, const char* msg, long long a = 0, long long b = 0) {
  if (err && err_len > 0) std::snprintf(err, (size_t)err_len, msg, a, b);
  return -3;
}

int channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
    default: return 0;
  }
}

bool depth_allowed(int color_type, int depth) {
  switch (color_type) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  if (pb <= pc) return (uint8_t)b;
  return (uint8_t)c;
}

// Undo row filter `type` on `cur` (rowbytes bytes); `prev` is the previous
// unfiltered row or nullptr for the first row; bpp the byte distance.
bool unfilter(int type, uint8_t* cur, const uint8_t* prev, long long rowbytes, int bpp) {
  switch (type) {
    case 0:
      return true;
    case 1:
      for (long long i = bpp; i < rowbytes; ++i) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
      return true;
    case 2:
      if (prev)
        for (long long i = 0; i < rowbytes; ++i) cur[i] = (uint8_t)(cur[i] + prev[i]);
      return true;
    case 3:
      for (long long i = 0; i < rowbytes; ++i) {
        int left = i >= bpp ? cur[i - bpp] : 0;
        int up = prev ? prev[i] : 0;
        cur[i] = (uint8_t)(cur[i] + ((left + up) >> 1));
      }
      return true;
    case 4:
      for (long long i = 0; i < rowbytes; ++i) {
        int left = i >= bpp ? cur[i - bpp] : 0;
        int up = prev ? prev[i] : 0;
        int upleft = (prev && i >= bpp) ? prev[i - bpp] : 0;
        cur[i] = (uint8_t)(cur[i] + paeth(left, up, upleft));
      }
      return true;
    default:
      return false;
  }
}

// Sample `x` of a row of samples of `depth` bits (1, 2, 4, 8 or 16).
inline uint32_t sample(const uint8_t* row, long long x, int depth) {
  switch (depth) {
    case 1: return (row[x >> 3] >> (7 - (x & 7))) & 1u;
    case 2: return (row[x >> 2] >> (6 - 2 * (x & 3))) & 3u;
    case 4: return (row[x >> 1] >> (4 - 4 * (x & 1))) & 15u;
    case 8: return row[x];
    default: return ((uint32_t)row[2 * x] << 8) | row[2 * x + 1];
  }
}

uint8_t rgb_to_gray8(uint32_t r, uint32_t g, uint32_t b) {
  if (r == g && r == b) return (uint8_t)r;
  return (uint8_t)((kRed * r + kGreen * g + kBlue * b) >> 15);
}

uint8_t rgb_to_gray16(uint32_t r, uint32_t g, uint32_t b) {
  uint32_t gray16 = (kRed * r + kGreen * g + kBlue * b + 16384) >> 15;
  return (uint8_t)(gray16 >> 8);
}

}  // namespace

extern "C" int mvo_png_to_gray(uint8_t* rows, int64_t n_bytes, int width, int height,
                               int bit_depth, int color_type, const uint8_t* palette,
                               int n_palette, float* out, char* err, int err_len) {
  int ch = channels_of(color_type);
  if (ch == 0 || !depth_allowed(color_type, bit_depth))
    return fail(err, err_len, "invalid color type %lld with bit depth %lld", color_type,
                bit_depth);
  if (color_type == 3 && n_palette <= 0) return fail(err, err_len, "palette image without PLTE");
  const long long bits = (long long)ch * bit_depth;
  const long long rowbytes = ((long long)width * bits + 7) / 8;
  const int bpp = bits >= 8 ? (int)(bits / 8) : 1;
  if (n_bytes < (long long)height * (rowbytes + 1))
    return fail(err, err_len, "image data too short: %lld bytes, %lld expected",
                (long long)n_bytes, (long long)height * (rowbytes + 1));
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    uint8_t* line = rows + (long long)y * (rowbytes + 1);
    uint8_t* cur = line + 1;
    if (!unfilter(line[0], cur, prev, rowbytes, bpp))
      return fail(err, err_len, "bad filter type %lld in row %lld", line[0], y);
    prev = cur;
    float* dst = out + (long long)y * width;
    const bool wide = bit_depth == 16;
    for (long long x = 0; x < width; ++x) {
      uint8_t v;
      if (color_type == 0 || color_type == 4) {
        // gray (the first of the pixel's samples; alpha dropped)
        uint32_t s = sample(cur, x * (color_type == 4 ? 2 : 1), bit_depth);
        v = wide ? (uint8_t)(s >> 8) : (uint8_t)(s * (255u / ((1u << bit_depth) - 1u)));
      } else if (color_type == 3) {
        uint32_t i = sample(cur, x, bit_depth);
        const uint8_t* p = (int)i < n_palette ? palette + 3 * i : nullptr;
        v = p ? rgb_to_gray8(p[0], p[1], p[2]) : 0;
      } else {
        long long s0 = x * ch;  // RGB or RGBA: alpha dropped
        uint32_t r = sample(cur, s0, bit_depth), g = sample(cur, s0 + 1, bit_depth),
                 b = sample(cur, s0 + 2, bit_depth);
        v = wide ? rgb_to_gray16(r, g, b) : rgb_to_gray8(r, g, b);
      }
      dst[x] = (float)v;
    }
  }
  return 0;
}
