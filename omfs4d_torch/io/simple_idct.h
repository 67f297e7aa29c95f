// FFmpeg's simple IDCT as cv2's x86-64 build runs it (the 8-bit
// simple_idct: rows with the DC-only shortcut, then columns), shared by the
// host decoders of MPEG-4 Part 2 (mpeg4dec.cpp), MPEG-1 / MPEG-2
// (mpeg2dec.cpp) and Microsoft's MPEG-4 family (msmpeg4dec.cpp), which
// FFmpeg's idctdsp gives the same IDCT.  Included inside each decoder's
// anonymous namespace.  mpeg4dec.cpp finds it beside itself and its
// library's name is hashed from its own source and tables only: after an
// edit here, clear omfs4d_torch/_build/ to rebuild it.
#pragma once

// ── the simple IDCT ──────────────────────────────────────────────────────
// cos(k pi / 16) sqrt(2) 2^14, rounded (W4 one below)
constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;

void simple_row(int16_t* r) {
  if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
    int16_t v = (int16_t)(uint16_t)((uint32_t)(r[0] * 8) & 0xffff);
    for (int k = 0; k < 8; ++k) r[k] = v;
    return;
  }
  int a0 = W4 * r[0] + (1 << 10), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * r[2];
  a1 += W6 * r[2];
  a2 -= W6 * r[2];
  a3 -= W2 * r[2];
  int b0 = W1 * r[1] + W3 * r[3], b1 = W3 * r[1] - W7 * r[3];
  int b2 = W5 * r[1] - W1 * r[3], b3 = W7 * r[1] - W5 * r[3];
  a0 += W4 * r[4] + W6 * r[6];
  a1 += -W4 * r[4] - W2 * r[6];
  a2 += -W4 * r[4] + W2 * r[6];
  a3 += W4 * r[4] - W6 * r[6];
  b0 += W5 * r[5] + W7 * r[7];
  b1 += -W1 * r[5] - W5 * r[7];
  b2 += W7 * r[5] + W3 * r[7];
  b3 += W3 * r[5] - W1 * r[7];
  r[0] = (int16_t)((a0 + b0) >> 11);
  r[7] = (int16_t)((a0 - b0) >> 11);
  r[1] = (int16_t)((a1 + b1) >> 11);
  r[6] = (int16_t)((a1 - b1) >> 11);
  r[2] = (int16_t)((a2 + b2) >> 11);
  r[5] = (int16_t)((a2 - b2) >> 11);
  r[3] = (int16_t)((a3 + b3) >> 11);
  r[4] = (int16_t)((a3 - b3) >> 11);
}

// one column (stride 8) into out[0..7] (stride 8), before the clip
void simple_col(const int16_t* c, int* out) {
  // 64 bits: 16-bit rows from corrupt data may overflow 32 (the values are
  // the same wherever 32 bits hold them)
  int64_t a0 = W4 * (c[0] + ((1 << 19) / W4)), a1 = a0, a2 = a0, a3 = a0;
  a0 += W2 * c[16];
  a1 += W6 * c[16];
  a2 += -W6 * c[16];
  a3 += -W2 * c[16];
  int64_t b0 = W1 * c[8] + W3 * c[24], b1 = W3 * c[8] - W7 * c[24];
  int64_t b2 = W5 * c[8] - W1 * c[24], b3 = W7 * c[8] - W5 * c[24];
  a0 += W4 * c[32] + W6 * c[48];
  a1 += -W4 * c[32] - W2 * c[48];
  a2 += -W4 * c[32] + W2 * c[48];
  a3 += W4 * c[32] - W6 * c[48];
  b0 += W5 * c[40] + W7 * c[56];
  b1 += -W1 * c[40] - W5 * c[56];
  b2 += W7 * c[40] + W3 * c[56];
  b3 += W3 * c[40] - W1 * c[56];
  out[0] = (int)((a0 + b0) >> 20);
  out[8] = (int)((a1 + b1) >> 20);
  out[16] = (int)((a2 + b2) >> 20);
  out[24] = (int)((a3 + b3) >> 20);
  out[32] = (int)((a3 - b3) >> 20);
  out[40] = (int)((a2 - b2) >> 20);
  out[48] = (int)((a1 - b1) >> 20);
  out[56] = (int)((a0 - b0) >> 20);
}

void simple_idct(int16_t* blk, int* out) {
  for (int r = 0; r < 8; ++r) simple_row(blk + 8 * r);
  for (int c = 0; c < 8; ++c) simple_col(blk + c, out + c);
}
