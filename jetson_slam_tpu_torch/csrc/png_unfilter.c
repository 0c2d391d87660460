/* Reverse the PNG row filters (PNG specification, section 9).
 *
 * src holds `height` rows of 1 + stride bytes: each row's filter type
 * (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth) and its filtered bytes; dst
 * receives height * stride bytes of raw samples.  bpp is the number of bytes
 * per complete pixel (1 for 8-bit grey, 2 for 16-bit grey, 3 RGB, 4 RGBA).
 * Returns 0, or 1 + the index of the first row with an unknown filter type.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

static uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

int png_unfilter(const uint8_t *src, int height, int stride, int bpp, uint8_t *dst) {
  for (int y = 0; y < height; ++y) {
    const uint8_t *in = src + (size_t)y * (stride + 1) + 1;
    uint8_t *out = dst + (size_t)y * stride;
    const uint8_t *up = y > 0 ? out - stride : NULL;
    int ft = in[-1];
    if (ft == 0) {
      memcpy(out, in, (size_t)stride);
      continue;
    }
    if (ft > 4) return y + 1;
    for (int i = 0; i < stride; ++i) {
      int a = i >= bpp ? out[i - bpp] : 0;
      int b = up ? up[i] : 0;
      int c = up && i >= bpp ? up[i - bpp] : 0;
      int pred = ft == 1 ? a : ft == 2 ? b : ft == 3 ? (a + b) >> 1 : paeth(a, b, c);
      out[i] = (uint8_t)(in[i] + pred);
    }
  }
  return 0;
}
