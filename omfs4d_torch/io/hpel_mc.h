// H.263's half-sample prediction as FFmpeg's x86 build (cv2's) makes it
// (hpeldsp's put / put_no_rnd pixels), shared by the host decoders of MPEG-4
// Part 2 (mpeg4dec.cpp) and Microsoft's MPEG-4 family (msmpeg4dec.cpp).
// Included inside each decoder's anonymous namespace, after its <algorithm>
// and <cstdint>.  mpeg4dec.cpp finds it beside itself and its library's name
// is hashed from its own source and tables only: after an edit here, clear
// omfs4d_torch/_build/ to rebuild it.
#pragma once

// half-sample bilinear prediction of a size x size block from the window
// src ((size + 1)^2), half flags hx, hy.  An 8-wide block's horizontal or
// vertical half sample at rounding type 1 is averaged as FFmpeg's x86 build
// (cv2's) averages it: one of the two samples (the left one; of two rows,
// the one at an odd row of the block's source) is lowered by 1, saturating
// at 0, and the pair averaged rounding up, so the result is the standard's
// (a + b) >> 1 except where that sample is 0 and the other odd, where it is
// one more.
void hpel_mc(const uint8_t* src, int hx, int hy, int size, int no_rnd, uint8_t* out) {
  const int n = size + 1;
  const bool lowered = size == 8 && no_rnd;
  for (int row = 0; row < size; ++row)
    for (int col = 0; col < size; ++col) {
      const uint8_t* s = src + row * n + col;
      int a = s[0], v;
      if (!hx && !hy) {
        v = a;
      } else if (hx && !hy) {
        int b = s[1];
        v = lowered ? (std::max(a - 1, 0) + b + 1) >> 1 : (a + b + 1 - no_rnd) >> 1;
      } else if (!hx && hy) {
        int b = s[n];
        if (lowered) {
          if (row & 1) a = std::max(a - 1, 0);
          else b = std::max(b - 1, 0);
          v = (a + b + 1) >> 1;
        } else {
          v = (a + b + 1 - no_rnd) >> 1;
        }
      } else {
        v = (a + s[1] + s[n] + s[n + 1] + 2 - no_rnd) >> 2;
      }
      out[row * size + col] = (uint8_t)v;
    }
}
