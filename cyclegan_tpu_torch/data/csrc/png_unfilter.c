/* PNG row unfiltering for cyclegan_tpu_torch/data/png.py, the decoder of
 * machines without cv2 or PIL.
 *
 * png_unfilter_row undoes one row's filter (PNG spec, section 9): None 0,
 * Sub 1, Up 2, Average 3, Paeth 4. Average and Paeth read the byte just
 * decoded bpp places to the left, a chain numpy cannot vectorize, so the
 * Python decoder took them a byte at a time; here each is one pass.
 *
 *   line  the filtered row (n bytes, without its filter-type byte)
 *   prev  the row above, already unfiltered (zeros for the first row)
 *   out   the unfiltered row (n bytes; may not alias line or prev)
 *   bpp   bytes per pixel, 1..8
 *
 * Returns 0, or -1 for an unknown filter type.
 *
 * Built at first use by cyclegan_tpu_torch/data/host_build.py:
 *   cc -O3 -std=c99 -fPIC -shared png_unfilter.c
 */
#include <stddef.h>
#include <stdint.h>

static int absdiff(int a, int b) { return a > b ? a - b : b - a; }

int png_unfilter_row(int kind, const uint8_t* line, const uint8_t* prev,
                     uint8_t* out, long n, int bpp) {
  long i;
  switch (kind) {
    case 0:
      for (i = 0; i < n; ++i) out[i] = line[i];
      return 0;
    case 1:
      for (i = 0; i < n; ++i)
        out[i] = (uint8_t)(line[i] + (i >= bpp ? out[i - bpp] : 0));
      return 0;
    case 2:
      for (i = 0; i < n; ++i) out[i] = (uint8_t)(line[i] + prev[i]);
      return 0;
    case 3:
      for (i = 0; i < n; ++i) {
        int left = i >= bpp ? out[i - bpp] : 0;
        out[i] = (uint8_t)(line[i] + ((left + prev[i]) >> 1));
      }
      return 0;
    case 4:
      for (i = 0; i < n; ++i) {
        int a = i >= bpp ? out[i - bpp] : 0;
        int b = prev[i];
        int c = i >= bpp ? prev[i - bpp] : 0;
        int p = a + b - c;
        int pa = absdiff(p, a), pb = absdiff(p, b), pc = absdiff(p, c);
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        out[i] = (uint8_t)(line[i] + pred);
      }
      return 0;
    default:
      return -1;
  }
}
