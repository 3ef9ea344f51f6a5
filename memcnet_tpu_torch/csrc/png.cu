// Host code, no kernel: undo the per-row filters of a non-interlaced 8-bit
// PNG (PNG spec 9.2) for io/png.py, whose plain Python version takes a
// Python step per byte on Average and Paeth rows -- the rows libpng's
// adaptive encoder picks for most rows of natural images.
#include "common.cuh"

#include <cstdlib>

// raw: h rows of 1 filter byte + stride bytes; out: h x stride; bpp: bytes
// per pixel.  Returns 0, or 1 + the index of the first row whose filter
// type is not 0-4 (its bytes and those below are left undefined).
MEMC_API int memc_png_unfilter(const uint8_t* raw, uint8_t* out, int h, int stride, int bpp) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + static_cast<size_t>(y) * (stride + 1);
    const uint8_t ftype = line[0];
    ++line;
    uint8_t* cur = out + static_cast<size_t>(y) * stride;
    const uint8_t* up = y > 0 ? cur - stride : nullptr;
    switch (ftype) {
      case 0:  // None
        for (int i = 0; i < stride; ++i) cur[i] = line[i];
        break;
      case 1:  // Sub
        for (int i = 0; i < stride; ++i) cur[i] = line[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:  // Up
        for (int i = 0; i < stride; ++i) cur[i] = line[i] + (up ? up[i] : 0);
        break;
      case 3:  // Average
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          cur[i] = line[i] + ((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = line[i] + pred;
        }
        break;
      default:
        return 1 + y;
    }
  }
  return 0;
}
