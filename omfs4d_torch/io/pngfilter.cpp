// PNG's row unfiltering (ISO/IEC 15948, 9.2): each row's filter byte (None,
// Sub, Up, Average, Paeth) undone against the decoded byte bpp to its left
// and the decoded row above, on the host.  The port's `decode_png` calls it
// for every PNG it reads (frame directories and PNG video alike); its plain
// version is `omfs4d_torch.io.video._unfilter_row`, which the tests hold it
// to.
//
// C API: png_unfilter(raw, height, row bytes, bytes a pixel, out) -> 0, or
// 1 + the row whose filter type is unknown.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int png_unfilter(const uint8_t *raw, int64_t height, int64_t rowbytes, int bpp,
                            uint8_t *out) {
    const uint8_t *prev = nullptr;
    for (int64_t y = 0; y < height; y++) {
        const uint8_t *in = raw + y * (rowbytes + 1);
        const int ft = in[0];
        in++;
        uint8_t *row = out + y * rowbytes;
        switch (ft) {
        case 0:
            memcpy(row, in, size_t(rowbytes));
            break;
        case 1:
            for (int64_t i = 0; i < rowbytes; i++)
                row[i] = uint8_t(in[i] + (i >= bpp ? row[i - bpp] : 0));
            break;
        case 2:
            for (int64_t i = 0; i < rowbytes; i++) row[i] = uint8_t(in[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (int64_t i = 0; i < rowbytes; i++) {
                int a = i >= bpp ? row[i - bpp] : 0, b = prev ? prev[i] : 0;
                row[i] = uint8_t(in[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t i = 0; i < rowbytes; i++) {
                int a = i >= bpp ? row[i - bpp] : 0, b = prev ? prev[i] : 0;
                int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
                int p = a + b - c, pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                row[i] = uint8_t(in[i] + pred);
            }
            break;
        default:
            return int(1 + y);
        }
        prev = row;
    }
    return 0;
}
