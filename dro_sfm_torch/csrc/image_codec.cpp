// Host image codec of the port: a JPEG decoder, the run-length BMP
// unpacker and the PNG row filters, in plain C++ with a C interface (loaded
// with ctypes, which releases the interpreter lock around each call).
//
// jpeg_info / jpeg_decode decode what cv2.imread(path, IMREAD_COLOR) gives
// (in RGB order), as libjpeg-turbo decodes it with its defaults, for 8-bit
// JPEG files of 1, 3 or 4 components:
//   * baseline and extended sequential (SOF0, SOF1, SOF9) and progressive
//     (SOF2, SOF10) frames, Huffman-coded (jdhuff.c, jdphuff.c: DC first and
//     refine, AC first and refine with end-of-band runs) or arithmetic-coded
//     (jdarith.c: the QM decoder on jaricom.c's table, DC statistics
//     conditioned by DAC's L and U, AC by Kx); every scan adds to
//     coefficient buffers that span the image, decoded once after EOI;
//   * the integer "islow" inverse DCT (jidctint.c), with its range limit,
//     on each component's quantization table as its first scan found it;
//   * fancy (triangle) upsampling for h2v1, h1v2 and h2v2 chroma
//     (jdsample.c), box replication for other integral factors (4:1:1);
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16);
//     grayscale repeated to three channels; four components read as CMYK,
//     or as YCCK (jdcolor.c:ycck_cmyk_convert) under an Adobe transform
//     other than 0, then OpenCV's CMYK -> BGR (R = K - ((255 - C) * K >> 8)).
// Lossless (SOF3, SOF11), hierarchical (SOF5-7, SOF13-15) and 12-bit files,
// and a progressive file that libjpeg would decode with block smoothing
// (jdcoefct.c:smoothing_ok: some of the first ten coefficients not sent to
// full precision) are refused as not supported. Truncated or corrupt streams
// are refused as broken: where libjpeg would warn and fill in, this decoder
// fails (a scan that breaks the progression's order, which libjpeg decodes
// with a warning, is decoded). The EXIF orientation tag is reported by
// jpeg_info; the caller applies it.
//
// bmp_rle unpacks RLE8 and RLE4 BMP pixel data into palette indices as
// OpenCV 5.0.0's grfmt_bmp.cpp does: encoded runs, absolute runs, end of
// line, end of bitmap and delta escapes, the pixels an escape skips set to
// index 0 (an RLE8 delta skips dy rows and dx pixels in reading order; RLE4
// ends only the line at an end of bitmap and skips only dx pixels at a
// delta), and a run past its row refused.
//
// gif_lzw packs palette indices as the LZW data of a GIF image (the
// variable-length codes, a clear code first and whenever the table fills,
// the end code last), in sub-blocks of at most 255 bytes.
//
// png_unfilter undoes the five PNG row filters (None, Sub, Up, Average,
// Paeth) of inflated image data (one interlace pass at a time).
//
// jpeg_encode writes baseline JPEG as cv2.imencode(".jpg", img,
// [IMWRITE_JPEG_QUALITY, q]) writes it through libjpeg-turbo's defaults:
//   * a JFIF 1.01 APP0 (no density unit, 1:1), the quality-scaled Annex K
//     quantization tables (jcparam.c, baseline-limited), SOF0, the standard
//     Huffman tables, one interleaved scan;
//   * RGB -> YCbCr with the fixed-point tables of jccolor.c, 4:2:0 (Y 2x2)
//     with h2v2 downsampling and its alternating 1, 2 bias (jcsample.c);
//   * edges as jcprepct.c and jccoefct.c pad them: the right edge and an odd
//     last row replicated, the downsampled planes' last rows replicated to
//     a whole iMCU, and blocks past a component's size filled as dummy
//     blocks (zero AC, the DC of the block before);
//   * the islow forward DCT (jfdctint.c) and the reciprocal quantization
//     of jcdctmgr.c with 16-bit DCT elements (the SIMD build's);
//   * byte stuffing and the last byte padded with 1 bits (jchuff.c).
//
// Every entry point returns 0 on success, else -1 (a broken stream) or -2 (a
// valid one that is not supported) with a message in err.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CodecError {
  std::string msg;
  bool unsupported;
};

// A stream that is broken, and a valid one that this decoder does not take.
[[noreturn]] void fail(const std::string& msg) { throw CodecError{msg, false}; }
[[noreturn]] void unsupported(const std::string& msg) { throw CodecError{msg, true}; }

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The QM coder's probability estimation (T.81 Table D.2, as jaricom.c packs
// it): Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS.
// Entry 113 is the fixed estimate of 0.5 for sign and refinement bits.
constexpr uint32_t qm(uint32_t qe, uint32_t nlps, uint32_t nmps, uint32_t sw) {
  return qe << 16 | nmps << 8 | sw << 7 | nlps;
}
const uint32_t kAritab[114] = {
    qm(0x5a1d, 1, 1, 1),     qm(0x2586, 14, 2, 0),    qm(0x1114, 16, 3, 0),
    qm(0x080b, 18, 4, 0),    qm(0x03d8, 20, 5, 0),    qm(0x01da, 23, 6, 0),
    qm(0x00e5, 25, 7, 0),    qm(0x006f, 28, 8, 0),    qm(0x0036, 30, 9, 0),
    qm(0x001a, 33, 10, 0),   qm(0x000d, 35, 11, 0),   qm(0x0006, 9, 12, 0),
    qm(0x0003, 10, 13, 0),   qm(0x0001, 12, 13, 0),   qm(0x5a7f, 15, 15, 1),
    qm(0x3f25, 36, 16, 0),   qm(0x2cf2, 38, 17, 0),   qm(0x207c, 39, 18, 0),
    qm(0x17b9, 40, 19, 0),   qm(0x1182, 42, 20, 0),   qm(0x0cef, 43, 21, 0),
    qm(0x09a1, 45, 22, 0),   qm(0x072f, 46, 23, 0),   qm(0x055c, 48, 24, 0),
    qm(0x0406, 49, 25, 0),   qm(0x0303, 51, 26, 0),   qm(0x0240, 52, 27, 0),
    qm(0x01b1, 54, 28, 0),   qm(0x0144, 56, 29, 0),   qm(0x00f5, 57, 30, 0),
    qm(0x00b7, 59, 31, 0),   qm(0x008a, 60, 32, 0),   qm(0x0068, 62, 33, 0),
    qm(0x004e, 63, 34, 0),   qm(0x003b, 32, 35, 0),   qm(0x002c, 33, 9, 0),
    qm(0x5ae1, 37, 37, 1),   qm(0x484c, 64, 38, 0),   qm(0x3a0d, 65, 39, 0),
    qm(0x2ef1, 67, 40, 0),   qm(0x261f, 68, 41, 0),   qm(0x1f33, 69, 42, 0),
    qm(0x19a8, 70, 43, 0),   qm(0x1518, 72, 44, 0),   qm(0x1177, 73, 45, 0),
    qm(0x0e74, 74, 46, 0),   qm(0x0bfb, 75, 47, 0),   qm(0x09f8, 77, 48, 0),
    qm(0x0861, 78, 49, 0),   qm(0x0706, 79, 50, 0),   qm(0x05cd, 48, 51, 0),
    qm(0x04de, 50, 52, 0),   qm(0x040f, 50, 53, 0),   qm(0x0363, 51, 54, 0),
    qm(0x02d4, 52, 55, 0),   qm(0x025c, 53, 56, 0),   qm(0x01f8, 54, 57, 0),
    qm(0x01a4, 55, 58, 0),   qm(0x0160, 56, 59, 0),   qm(0x0125, 57, 60, 0),
    qm(0x00f6, 58, 61, 0),   qm(0x00cb, 59, 62, 0),   qm(0x00ab, 61, 63, 0),
    qm(0x008f, 61, 32, 0),   qm(0x5b12, 65, 65, 1),   qm(0x4d04, 80, 66, 0),
    qm(0x412c, 81, 67, 0),   qm(0x37d8, 82, 68, 0),   qm(0x2fe8, 83, 69, 0),
    qm(0x293c, 84, 70, 0),   qm(0x2379, 86, 71, 0),   qm(0x1edf, 87, 72, 0),
    qm(0x1aa9, 87, 73, 0),   qm(0x174e, 72, 74, 0),   qm(0x1424, 72, 75, 0),
    qm(0x119c, 74, 76, 0),   qm(0x0f6b, 74, 77, 0),   qm(0x0d51, 75, 78, 0),
    qm(0x0bb6, 77, 79, 0),   qm(0x0a40, 77, 48, 0),   qm(0x5832, 80, 81, 1),
    qm(0x4d1c, 88, 82, 0),   qm(0x438e, 89, 83, 0),   qm(0x3bdd, 90, 84, 0),
    qm(0x34ee, 91, 85, 0),   qm(0x2eae, 92, 86, 0),   qm(0x299a, 93, 87, 0),
    qm(0x2516, 86, 71, 0),   qm(0x5570, 88, 89, 1),   qm(0x4ca9, 95, 90, 0),
    qm(0x44d9, 96, 91, 0),   qm(0x3e22, 97, 92, 0),   qm(0x3824, 99, 93, 0),
    qm(0x32b4, 99, 94, 0),   qm(0x2e17, 93, 86, 0),   qm(0x56a8, 95, 96, 1),
    qm(0x4f46, 101, 97, 0),  qm(0x47e5, 102, 98, 0),  qm(0x41cf, 103, 99, 0),
    qm(0x3c3d, 104, 100, 0), qm(0x375e, 99, 93, 0),   qm(0x5231, 105, 102, 0),
    qm(0x4c0f, 106, 103, 0), qm(0x4639, 107, 104, 0), qm(0x415e, 103, 99, 0),
    qm(0x5627, 105, 106, 1), qm(0x50e7, 108, 107, 0), qm(0x4b85, 109, 103, 0),
    qm(0x5597, 110, 109, 0), qm(0x504f, 111, 107, 0), qm(0x5a10, 110, 111, 1),
    qm(0x5522, 112, 109, 0), qm(0x59eb, 112, 111, 1), qm(0x5a1d, 113, 113, 0)};

// The Annex K Huffman tables (also the encoder's): 16 code counts, then the
// symbols. libjpeg-turbo's decoder installs them as tables 0 and 1 where a
// file defines none (Motion JPEG frames carry no DHT).
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLookBits];  // (length << 8) | value; length 0: longer code

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    std::memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        // Too many codes of this length: refused before the lookup table
        // is written at an index past its end.
        if (code >= (1 << len)) fail("corrupt JPEG: bad Huffman table");
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = uint16_t((len << 8) | symbols[k]);
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (counts[len - 1] && code >= (1 << len)) fail("corrupt JPEG: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int bw = 0, bh = 0;      // blocks allocated (whole MCUs)
  int dw = 0, dh = 0;      // downsampled width and height in samples
  int pred = 0;            // DC prediction (arithmetic: modulo 2^16)
  int dc_context = 0;      // arithmetic DC conditioning of this scan
  bool latched = false;    // q holds the table the component's first scan found
  uint16_t q[64] = {};     // zeros until then: libjpeg's output is then flat
  int coef_bits[64];       // progressive: the Al of each coefficient's last scan
  std::vector<int16_t> coef;  // [bh][bw][64], natural order
};

// Bit reader over entropy-coded data: byte stuffing removed, stops at a
// marker and then supplies zero bits, which it counts: consuming one of
// them means the segment ended early.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;
  int bits = 0;
  int pad = 0;
  bool hit_marker = false;

  void fill() {
    while (bits <= 56) {
      uint32_t c = 0;
      if (!hit_marker && pos < size) {
        c = data[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < size && data[q] == 0xFF) ++q;
          if (q < size && data[q] == 0x00) {
            pos = q + 1;
          } else {
            hit_marker = true;  // pos stays on the marker's first 0xFF
            c = 0;
            pad += 8;
          }
        } else {
          ++pos;
        }
      } else {
        hit_marker = true;
        pad += 8;
      }
      buf |= uint64_t(c) << (56 - bits);
      bits += 8;
    }
  }
  void consume(int n) {
    buf <<= n;
    bits -= n;
    if (bits < pad) fail("truncated or corrupt JPEG data");
  }
  int get(int n) {  // n in 1..16
    if (bits < n) fill();
    int v = int(buf >> (64 - n));
    consume(n);
    return v;
  }
  int decode(const Huffman& h) {
    if (bits < 16) fill();
    int e = h.look[buf >> (64 - kLookBits)];
    if (e >> 8) {
      consume(e >> 8);
      return e & 0xFF;
    }
    for (int len = kLookBits + 1; len <= 16; ++len) {
      int code = int(buf >> (64 - len));
      if (code <= h.maxcode[len]) {
        consume(len);
        return h.vals[h.valoffset[len] + code];
      }
    }
    fail("corrupt JPEG data: bad Huffman code");
  }
  void reset() {
    buf = 0;
    bits = 0;
    pad = 0;
    hit_marker = false;
  }
};

// The QM decoder of jdarith.c: C holds the interval's base and the bits
// read ahead (ct of them), A the interval's size. Past a marker it reads
// zeros, as the standard has it; the stream's end is a truncation.
struct ArithReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  int64_t c = 0, a = 0;
  int ct = -16;              // -16: two bytes to read first
  bool hit_marker = false;
  size_t marker_at = 0;      // the marker's first 0xFF
  size_t after_marker = 0;   // the byte after its code
  int marker_code = 0;

  int next_byte() {
    if (hit_marker) return 0;
    if (pos >= size) fail("truncated JPEG file");
    int d = data[pos++];
    if (d != 0xFF) return d;
    size_t first = pos - 1;
    do {
      if (pos >= size) fail("truncated JPEG file");
      d = data[pos++];
    } while (d == 0xFF);
    if (d == 0) return 0xFF;  // a stuffed zero
    hit_marker = true;
    marker_at = first;
    after_marker = pos;
    marker_code = d;
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // the two first bytes read
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t e = kAritab[sv & 0x7F];
    int64_t qe = e >> 16;
    int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: the MPS after all
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void restart(size_t at) {
    pos = at;
    c = a = 0;
    ct = -16;
    hit_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Jpeg {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint16_t qt[4][64];  // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  uint8_t arith_L[16], arith_U[16], arith_K[16];  // DAC: DC conditioning, AC Kx
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[4];
  int restart_interval = 0;
  bool frame = false, progressive = false, arithmetic = false, jfif = false, adobe = false;
  bool scanned = false;
  int adobe_transform = -1;
  int orientation = 1;

  // The scan being decoded.
  Component* sc[4] = {};
  int ns = 0, ss = 0, se = 63, ah = 0, al = 0;
  int eobrun = 0;                                  // progressive Huffman
  uint8_t dc_stats[16][64], ac_stats[16][256];     // arithmetic statistics
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {
    for (int i = 0; i < 16; ++i) {
      arith_L[i] = 0;
      arith_U[i] = 1;
      arith_K[i] = 5;
    }
  }

  int byte() {
    if (pos >= size) fail("truncated JPEG file");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {
    // Skip to the next 0xFF <code> (fill bytes allowed).
    while (pos < size && data[pos] != 0xFF) ++pos;
    while (pos < size && data[pos] == 0xFF) ++pos;
    if (pos >= size) fail("truncated JPEG file: no end-of-image marker");
    return data[pos++];
  }

  void read_exif(size_t start, size_t len) {
    if (len < 14 || std::memcmp(data + start, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = data + start + 6;
    size_t n = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto u16 = [&](size_t o) -> unsigned {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto u32 = [&](size_t o) -> size_t {
      return le ? size_t(t[o]) | (size_t(t[o + 1]) << 8) | (size_t(t[o + 2]) << 16) |
                      (size_t(t[o + 3]) << 24)
                : (size_t(t[o]) << 24) | (size_t(t[o + 1]) << 16) | (size_t(t[o + 2]) << 8) |
                      size_t(t[o + 3]);
    };
    size_t ifd = u32(4);
    if (ifd + 2 > n) return;
    unsigned count = u16(ifd);
    for (unsigned i = 0; i < count; ++i) {
      size_t e = ifd + 2 + 12 * size_t(i);
      if (e + 12 > n) return;
      if (u16(e) == 0x0112) {
        unsigned type = u16(e + 2);
        unsigned value = type == 3 ? u16(e + 8) : type == 4 ? unsigned(u32(e + 8)) : 1;
        orientation = (value >= 1 && value <= 8) ? int(value) : 1;
        return;
      }
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: bad quantization table");
      for (int i = 0; i < 64; ++i) qt[tq][kZigzag[i]] = uint16_t(pq ? word() : byte());
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = uint8_t(byte());
      if (total > 256 || pos + total > end) fail("corrupt JPEG: bad Huffman table");
      uint8_t symbols[256];
      for (int i = 0; i < total; ++i) symbols[i] = uint8_t(byte());
      if (tc == 0)
        for (int i = 0; i < total; ++i)
          if (symbols[i] > 15) fail("corrupt JPEG: bad DC Huffman table");
      (tc ? ac[th] : dc[th]).build(counts, symbols, total);
    }
  }

  // DAC (jdmarker.c:get_dac): L and U of a DC table, Kx of an AC table.
  void read_dac(size_t end) {
    while (pos < end) {
      if (pos + 2 > end) fail("corrupt JPEG: bad DAC segment length");
      int index = byte(), val = byte();
      if (index >= 32) fail("corrupt JPEG: bad DAC table index " + std::to_string(index));
      if (index >= 16) {
        arith_K[index - 16] = uint8_t(val);
      } else {
        arith_L[index] = uint8_t(val & 15);
        arith_U[index] = uint8_t(val >> 4);
        if (arith_L[index] > arith_U[index])
          fail("corrupt JPEG: bad DAC value " + std::to_string(val));
      }
    }
  }

  void read_sof(int marker) {
    if (frame) fail("corrupt JPEG: two frame headers");
    if (marker == 0xC3 || marker == 0xCB)
      unsupported("lossless JPEG is not supported (OpenCV's IMREAD_COLOR does not decode it)");
    if ((marker >= 0xC5 && marker <= 0xC8) || marker >= 0xCD)
      unsupported("hierarchical (differential) JPEG is not supported (nor by libjpeg)");
    progressive = marker == 0xC2 || marker == 0xCA;
    arithmetic = marker >= 0xC9;
    int precision = byte();
    if (precision != 8)
      unsupported("JPEG with " + std::to_string(precision) +
                  "-bit samples is not supported (OpenCV's IMREAD_COLOR does not decode it)");
    height = word();
    width = word();
    ncomp = byte();
    if (height <= 0 || width <= 0) fail("corrupt JPEG: empty image (or height set by DNL)");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      unsupported("JPEG with " + std::to_string(ncomp) + " components is not supported");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("corrupt JPEG: bad component sampling factors");
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
    }
    frame = true;
  }

  // Headers up to the frame header (for jpeg_info), or everything (decode).
  void parse(bool decode) {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) {
        if (!frame) fail("corrupt JPEG: no frame header");
        if (decode && !scanned) fail("corrupt JPEG: no scan");
        return;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      size_t len = size_t(word());
      if (len < 2 || pos + len - 2 > size) fail("truncated JPEG file");
      size_t start = pos, end = pos + len - 2;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
        read_sof(m);
        if (!decode) return;
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xCC) {
        read_dac(end);
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDD) {
        restart_interval = word();
      } else if (m == 0xDA) {
        if (!frame) fail("corrupt JPEG: scan before the frame header");
        read_scan(start, end);
        continue;  // pos is after the scan's entropy-coded data
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(data + start, "JFIF\0", 5) == 0) jfif = true;
      } else if (m == 0xE1) {
        read_exif(start, len - 2);
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(data + start, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[start + 11];
        }
      } else if (m == 0xDC) {
        unsupported("JPEG with a DNL marker is not supported");
      }
      pos = end;
    }
  }

  // jdcoefct.c:smoothing_ok after the last scan: libjpeg-turbo smooths the
  // blocks of a progressive file whose DC is known for every component but
  // some of coefficients 1-9 (zigzag) of one of them lack low bits.
  bool block_smoothing() const {
    if (!progressive) return false;
    static const int kFirst[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};  // natural order
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int k : kFirst)
        if (c.q[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // --- Huffman: sequential (jdhuff.c) and progressive (jdphuff.c) blocks.

  void huff_sequential(BitReader& br, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = br.decode(hd);
    int diff = s ? extend(br.get(s), s) : 0;
    c.pred += diff;
    blk[0] = int16_t(c.pred);
    for (int k = 1; k < 64;) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("corrupt JPEG data: coefficient index out of range");
        blk[kZigzag[k]] = int16_t(extend(br.get(s), s));
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
  }

  void huff_dc_first(BitReader& br, Component& c, int16_t* blk) {
    int s = br.decode(dc[c.td]);
    if (s) s = extend(br.get(s), s);
    if ((c.pred >= 0 && s > INT_MAX - c.pred) || (c.pred < 0 && s < INT_MIN - c.pred))
      fail("corrupt JPEG data: DC coefficient out of range");
    c.pred += s;
    blk[0] = int16_t(unsigned(c.pred) << al);
  }

  void huff_dc_refine(BitReader& br, int16_t* blk) {
    if (br.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void huff_ac_first(BitReader& br, Component& c, int16_t* blk) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& ha = ac[c.ta];
    for (int k = ss; k <= se; ++k) {
      int s = br.decode(ha);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        if (k > se) fail("corrupt JPEG data: coefficient index past the band");
        blk[kZigzag[k]] = int16_t(unsigned(extend(br.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  // A correction bit for each coefficient already nonzero.
  void refine_nonzero(BitReader& br, int16_t& coef, int p1, int m1) {
    if (br.get(1) && (coef & p1) == 0) coef = int16_t(coef + (coef >= 0 ? p1 : m1));
  }

  void huff_ac_refine(BitReader& br, Component& c, int16_t* blk) {
    const int p1 = 1 << al, m1 = int(~0u << al);
    int k = ss;
    if (eobrun == 0) {
      const Huffman& ha = ac[c.ta];
      for (; k <= se; ++k) {
        int s = br.decode(ha);
        int r = s >> 4;
        s &= 15;
        if (s) {
          if (s != 1) fail("corrupt JPEG data: bad Huffman code in a refinement scan");
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        // Skip r zero coefficients, refining the nonzero ones passed.
        for (; k <= se; ++k) {
          int16_t& coef = blk[kZigzag[k]];
          if (coef) {
            refine_nonzero(br, coef, p1, m1);
          } else if (--r < 0) {
            break;
          }
        }
        if (s) {
          if (k > se) fail("corrupt JPEG data: coefficient index past the band");
          blk[kZigzag[k]] = int16_t(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kZigzag[k]];
        if (coef) refine_nonzero(br, coef, p1, m1);
      }
      --eobrun;
    }
  }

  // --- Arithmetic (jdarith.c).

  // A nonzero value after its sign (F.21-F.24): the magnitude category,
  // then its bits. st is the category's first bin, x1 where its further
  // bins start (DC: X1 = 20; AC: 189 or 217 by Kx); *top is the category's
  // leading bit (0 for a magnitude of 1), which conditions the next DC.
  int arith_value(ArithReader& ar, uint8_t* st, int sign, bool is_dc, uint8_t* x1, int* top) {
    int m = ar.decode(st);
    if (m && (is_dc || ar.decode(st))) {
      if (!is_dc) m <<= 1;
      st = x1;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) fail("corrupt JPEG data: arithmetic magnitude overflow");
        ++st;
      }
    }
    *top = m;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // The DC difference of one block (F.19), the prediction and the context.
  void arith_dc_diff(ArithReader& ar, Component& c) {
    uint8_t* stats = dc_stats[c.td];
    uint8_t* st = stats + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
      return;
    }
    int sign = ar.decode(st + 1), m;
    int v = arith_value(ar, st + 2 + sign, sign, true, stats + 20, &m);
    if (m < ((1 << arith_L[c.td]) >> 1))
      c.dc_context = 0;
    else if (m > ((1 << arith_U[c.td]) >> 1))
      c.dc_context = 12 + sign * 4;
    else
      c.dc_context = 4 + sign * 4;
    c.pred = (c.pred + v) & 0xFFFF;
  }

  // AC coefficients ss..se of one block (F.20): value of each nonzero one.
  template <typename Put>
  void arith_ac_band(ArithReader& ar, Component& c, Put put) {
    uint8_t* stats = ac_stats[c.ta];
    for (int k = std::max(ss, 1); k <= se; ++k) {  // a sequential scan: 1..63
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // end of block
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) fail("corrupt JPEG data: arithmetic coefficient index past the band");
      }
      int sign = ar.decode(fixed_bin), m;
      put(k, arith_value(ar, st + 2, sign, false, stats + (k <= arith_K[c.ta] ? 189 : 217), &m));
    }
  }

  void arith_sequential(ArithReader& ar, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    arith_dc_diff(ar, c);
    blk[0] = int16_t(c.pred);
    arith_ac_band(ar, c, [&](int k, int v) { blk[kZigzag[k]] = int16_t(v); });
  }

  void arith_dc_first(ArithReader& ar, Component& c, int16_t* blk) {
    arith_dc_diff(ar, c);
    blk[0] = int16_t(unsigned(c.pred) << al);
  }

  void arith_dc_refine(ArithReader& ar, int16_t* blk) {
    if (ar.decode(fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  void arith_ac_first(ArithReader& ar, Component& c, int16_t* blk) {
    arith_ac_band(ar, c, [&](int k, int v) { blk[kZigzag[k]] = int16_t(unsigned(v) << al); });
  }

  void arith_ac_refine(ArithReader& ar, Component& c, int16_t* blk) {
    const int p1 = 1 << al, m1 = int(~0u << al);
    uint8_t* stats = ac_stats[c.ta];
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kZigzag[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // end of block
      for (;;) {
        int16_t& coef = blk[kZigzag[k]];
        if (coef) {  // nonzero before: a correction bit
          if (ar.decode(st + 2)) coef = int16_t(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          coef = int16_t(ar.decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) fail("corrupt JPEG data: arithmetic coefficient index past the band");
      }
    }
  }

  // Reset the statistics of the scan's components (start and restart).
  void arith_reset_stats() {
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      if (!progressive || (ss == 0 && ah == 0)) {
        std::memset(dc_stats[c.td], 0, sizeof(dc_stats[0]));
        c.pred = 0;
        c.dc_context = 0;
      }
      if (!progressive || ss) std::memset(ac_stats[c.ta], 0, sizeof(ac_stats[0]));
    }
  }

  void decode_block(BitReader& br, ArithReader& ar, Component& c, int16_t* blk) {
    if (arithmetic) {
      if (!progressive) arith_sequential(ar, c, blk);
      else if (ss == 0) (ah == 0) ? arith_dc_first(ar, c, blk) : arith_dc_refine(ar, blk);
      else (ah == 0) ? arith_ac_first(ar, c, blk) : arith_ac_refine(ar, c, blk);
    } else {
      if (!progressive) huff_sequential(br, c, blk);
      else if (ss == 0) (ah == 0) ? huff_dc_first(br, c, blk) : huff_dc_refine(br, blk);
      else (ah == 0) ? huff_ac_first(br, c, blk) : huff_ac_refine(br, c, blk);
    }
  }

  // The scan's parameters against the frame (jdphuff.c and jdarith.c
  // start_pass): a bad progression stops libjpeg; a scan out of the
  // progression's order only warns, and is decoded.
  void check_scan() {
    if (!progressive) {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        fail("corrupt JPEG: a sequential scan with spectral selection or successive "
             "approximation");
      return;
    }
    bool bad = ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1);
    if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
    if (bad)
      fail("corrupt JPEG: bad progression parameters Ss=" + std::to_string(ss) + " Se=" +
           std::to_string(se) + " Ah=" + std::to_string(ah) + " Al=" + std::to_string(al));
    for (int i = 0; i < ns; ++i)
      for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
  }

  void read_scan(size_t start, size_t header_end) {
    ns = byte();
    if (ns < 1 || ns > ncomp || header_end - start != size_t(4 + 2 * ns))
      fail("corrupt JPEG: bad scan header");
    for (int i = 0; i < ns; ++i) {
      int id = byte();
      int t = byte();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) found = &comp[j];
      if (!found) fail("corrupt JPEG: scan names an unknown component");
      for (int j = 0; j < i; ++j)
        if (sc[j] == found) fail("corrupt JPEG: scan names a component twice");
      found->td = t >> 4;
      found->ta = t & 15;
      sc[i] = found;
    }
    ss = byte();
    se = byte();
    int ahl = byte();
    ah = ahl >> 4;
    al = ahl & 15;
    pos = header_end;
    check_scan();
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      bool needs_dc = !progressive || (ss == 0 && ah == 0), needs_ac = !progressive || ss;
      if (arithmetic) {
        if (c.td > 15 || c.ta > 15) fail("corrupt JPEG: bad arithmetic table index");
      } else {
        if ((needs_dc && (c.td > 3 || !use_huffman(dc[c.td], c.td, true))) ||
            (needs_ac && (c.ta > 3 || !use_huffman(ac[c.ta], c.ta, false))))
          fail("corrupt JPEG: scan uses an undefined Huffman table");
      }
      if (!c.latched) {  // jdinput.c:latch_quant_tables
        if (!qt_defined[c.tq]) fail("corrupt JPEG: undefined quantization table");
        std::memcpy(c.q, qt[c.tq], sizeof(c.q));
        c.latched = true;
      }
      c.pred = 0;
      c.dc_context = 0;
    }
    for (int i = 0; i < ncomp; ++i)
      if (comp[i].coef.empty()) comp[i].coef.assign(size_t(comp[i].bw) * comp[i].bh * 64, 0);
    eobrun = 0;

    BitReader br{data, size, pos};
    ArithReader ar{data, size, pos};
    if (arithmetic) arith_reset_stats();
    long units_x, units_y;
    if (ns == 1) {  // non-interleaved: one block per unit
      units_x = (sc[0]->dw + 7) / 8;
      units_y = (sc[0]->dh + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    long total = units_x * units_y, todo_restart = restart_interval;
    int next_rst = 0;
    for (long u = 0; u < total; ++u) {
      if (restart_interval && todo_restart == 0) {
        restart(br, ar, next_rst);
        next_rst = (next_rst + 1) & 7;
        todo_restart = restart_interval;
      }
      long uy = u / units_x, ux = u % units_x;
      if (ns == 1) {
        Component& c = *sc[0];
        decode_block(br, ar, c, &c.coef[(size_t(uy) * c.bw + ux) * 64]);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              size_t row = size_t(uy) * c.v + by, col = size_t(ux) * c.h + bx;
              decode_block(br, ar, c, &c.coef[(row * c.bw + col) * 64]);
            }
        }
      }
      --todo_restart;
    }
    pos = arithmetic ? (ar.hit_marker ? ar.marker_at : ar.pos) : br.pos;
    scanned = true;
  }

  // A Huffman table a scan names: libjpeg-turbo installs the standard one
  // as table 0 or 1 where the file defined none.
  bool use_huffman(Huffman& h, int index, bool is_dc) {
    if (!h.defined && index < 2) {
      if (is_dc)
        h.build(index ? kDcChromaBits : kDcLumaBits, kDcVals, 12);
      else
        h.build(index ? kAcChromaBits : kAcLumaBits, index ? kAcChromaVals : kAcLumaVals, 162);
    }
    return h.defined;
  }

  // The segment ends; a RSTn marker follows. The decoder's state restarts.
  void restart(BitReader& br, ArithReader& ar, int next_rst) {
    int code;
    if (arithmetic) {
      // The arithmetic decoder may stop short of its segment's last bytes.
      if (!ar.hit_marker) {
        size_t p = ar.pos;
        while (p + 1 < size && !(data[p] == 0xFF && data[p + 1] != 0 && data[p + 1] != 0xFF))
          ++p;
        if (p != ar.pos) fail("corrupt JPEG data: extraneous bytes before a restart marker");
        ar.marker_at = p;
        ar.after_marker = p + 2;
        ar.marker_code = p + 1 < size ? data[p + 1] : -1;
      }
      code = ar.marker_code;
      if (code != 0xD0 + next_rst) fail("corrupt JPEG data: missing restart marker");
      ar.restart(ar.after_marker);
      arith_reset_stats();
      return;
    }
    br.reset();
    pos = br.pos;
    if (pos + 1 >= size || data[pos] != 0xFF || data[pos + 1] != 0xD0 + next_rst)
      fail("corrupt JPEG data: missing restart marker");
    pos += 2;
    br.pos = pos;
    eobrun = 0;
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
  }
};

// ---------------------------------------------------------------------------
// Inverse DCT: libjpeg's jpeg_idct_islow (jidctint.c), 8-bit samples.

constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) { return int32_t((x + (int64_t(1) << (n - 1))) >> n); }

// The post-IDCT range limit: the low 10 bits of the centred value, as a
// signed number, shifted by 128 and clamped to [0, 255].
inline uint8_t range_limit(int32_t x) {
  int v = x & 1023;
  if (v >= 512) v -= 1024;
  v += 128;
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int32_t* wp = ws + col;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dc = int32_t(ip[0]) * qp[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = int32_t(ip[16]) * qp[16], z3 = int32_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(ip[0]) * qp[0];
    z3 = int32_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(ip[56]) * qp[56];
    tmp1 = int32_t(ip[40]) * qp[40];
    tmp2 = int32_t(ip[24]) * qp[24];
    tmp3 = int32_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, sh);
    wp[56] = descale(tmp10 - tmp3, sh);
    wp[8] = descale(tmp11 + tmp2, sh);
    wp[48] = descale(tmp11 - tmp2, sh);
    wp[16] = descale(tmp12 + tmp1, sh);
    wp[40] = descale(tmp12 - tmp1, sh);
    wp[24] = descale(tmp13 + tmp0, sh);
    wp[32] = descale(tmp13 - tmp0, sh);
  }
  for (int row = 0; row < 8; ++row) {
    const int32_t* wp = ws + 8 * row;
    uint8_t* op = out + size_t(row) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = range_limit(descale(wp[0], kPass1Bits + 3));
      for (int i = 0; i < 8; ++i) op[i] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = range_limit(descale(tmp10 + tmp3, sh));
    op[7] = range_limit(descale(tmp10 - tmp3, sh));
    op[1] = range_limit(descale(tmp11 + tmp2, sh));
    op[6] = range_limit(descale(tmp11 - tmp2, sh));
    op[2] = range_limit(descale(tmp12 + tmp1, sh));
    op[5] = range_limit(descale(tmp12 - tmp1, sh));
    op[3] = range_limit(descale(tmp13 + tmp0, sh));
    op[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

// A component's samples, [dh][dw] (the blocks' padding cut off).
std::vector<uint8_t> component_plane(const Component& c) {
  int pw = c.bw * 8;
  std::vector<uint8_t> full(size_t(pw) * c.bh * 8);
  const uint16_t* q = c.q;
  for (int by = 0; by < c.bh; ++by)
    for (int bx = 0; bx < c.bw; ++bx)
      idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], q, &full[size_t(by) * 8 * pw + bx * 8], pw);
  std::vector<uint8_t> out(size_t(c.dw) * c.dh);
  for (int y = 0; y < c.dh; ++y) std::memcpy(&out[size_t(y) * c.dw], &full[size_t(y) * pw], c.dw);
  return out;
}

// Upsampled to [height][width] as jdsample.c does with fancy upsampling on.
std::vector<uint8_t> upsample(const Jpeg& j, const Component& c, std::vector<uint8_t> in) {
  int W = j.width, H = j.height, dw = c.dw, dh = c.dh;
  int fx = j.hmax / c.h, fy = j.vmax / c.v;
  if (j.hmax % c.h || j.vmax % c.v) unsupported("JPEG with fractional sampling factors is not supported");
  if (fx == 1 && fy == 1) return in;
  std::vector<uint8_t> out(size_t(W) * H);
  auto at = [&](int y, int x) -> int {  // edges replicated
    y = y < 0 ? 0 : y >= dh ? dh - 1 : y;
    x = x < 0 ? 0 : x >= dw ? dw - 1 : x;
    return in[size_t(y) * dw + x];
  };
  if (fx == 2 && fy == 1 && dw > 2) {
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) {
        int i = x >> 1, s3 = 3 * at(y, i);
        out[size_t(y) * W + x] =
            uint8_t((x & 1) ? (s3 + at(y, i + 1) + 2) >> 2 : (s3 + at(y, i - 1) + 1) >> 2);
      }
  } else if (fx == 1 && fy == 2) {
    for (int y = 0; y < H; ++y) {
      int i = y >> 1, far = (y & 1) ? i + 1 : i - 1, bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x)
        out[size_t(y) * W + x] = uint8_t((3 * at(i, x) + at(far, x) + bias) >> 2);
    }
  } else if (fx == 2 && fy == 2 && dw > 2) {
    std::vector<int> cs(size_t(dw) + 2);
    for (int y = 0; y < H; ++y) {
      int i = y >> 1, far = (y & 1) ? i + 1 : i - 1;
      for (int x = 0; x < dw; ++x) cs[x + 1] = 3 * at(i, x) + at(far, x);
      cs[0] = cs[1];
      cs[dw + 1] = cs[dw];
      for (int x = 0; x < W; ++x) {
        int k = (x >> 1) + 1, t3 = 3 * cs[k];
        out[size_t(y) * W + x] =
            uint8_t((x & 1) ? (t3 + cs[k + 1] + 7) >> 4 : (t3 + cs[k - 1] + 8) >> 4);
      }
    }
  } else {  // box replication (int_upsample, and h2v1/h2v2 at width <= 2)
    for (int y = 0; y < H; ++y)
      for (int x = 0; x < W; ++x) out[size_t(y) * W + x] = uint8_t(at(y / fy, x / fx));
  }
  return out;
}

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = int32_t(1) << (kScaleBits - 1);
inline int32_t fix(double x) { return int32_t(x * (1 << kScaleBits) + 0.5); }
inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((int64_t(fix(1.40200)) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = int((int64_t(fix(1.77200)) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
  }
};

void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr, size_t n, uint8_t* out) {
  static const YccTables t;
  for (size_t i = 0; i < n; ++i) {
    int Y = y[i], b = cb[i], r = cr[i];
    out[3 * i] = clamp255(Y + t.cr_r[r]);
    out[3 * i + 1] = clamp255(Y + int((t.cb_g[b] + t.cr_g[r]) >> kScaleBits));
    out[3 * i + 2] = clamp255(Y + t.cb_b[b]);
  }
}

// Four planes to RGB: YCCK -> CMYK (jdcolor.c:ycck_cmyk_convert, K passed
// through) where ycck, then OpenCV's icvCvt_CMYK2BGR_8u_C4C3R.
void cmyk_to_rgb(const std::vector<uint8_t>* p, size_t n, bool ycck, uint8_t* out) {
  static const YccTables t;
  for (size_t i = 0; i < n; ++i) {
    int c = p[0][i], m = p[1][i], y = p[2][i], k = p[3][i];
    if (ycck) {
      int Y = c, cb = m, cr = y;
      c = clamp255(255 - (Y + t.cr_r[cr]));
      m = clamp255(255 - (Y + int((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits)));
      y = clamp255(255 - (Y + t.cb_b[cb]));
    }
    out[3 * i] = uint8_t(k - ((255 - c) * k >> 8));
    out[3 * i + 1] = uint8_t(k - ((255 - m) * k >> 8));
    out[3 * i + 2] = uint8_t(k - ((255 - y) * k >> 8));
  }
}

// ---------------------------------------------------------------------------
// Baseline JPEG encoder (libjpeg-turbo's compression path, see the header).

const uint8_t kStdLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct HuffCode {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  HuffCode(const uint8_t* bits, const uint8_t* vals) {
    int code_ = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k, ++code_) {
        code[vals[k]] = uint16_t(code_);
        size[vals[k]] = uint8_t(len);
      }
      code_ <<= 1;
    }
  }
};

// jpeg_quality_scaling and jpeg_add_quant_table (force_baseline).
void quant_table(const uint8_t* basic, int quality, uint16_t* out) {
  quality = quality <= 0 ? 1 : quality > 100 ? 100 : quality;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (long(basic[i]) * scale + 50L) / 100L;
    out[i] = uint16_t(t <= 0 ? 1 : t > 255 ? 255 : t);
  }
}

// compute_reciprocal of jcdctmgr.c for 16-bit DCT elements: the
// reciprocal, the rounding correction and the shift of one divisor.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint16_t divisor) {
  if (divisor == 1) return {1, 0, -16};
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;    // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor, fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r - 16};
}

inline int32_t fdescale(int64_t x, int n) { return int32_t((x + (int64_t(1) << (n - 1))) >> n); }

// jpeg_fdct_islow: in place on centred samples; the output is scaled by 8.
void fdct_islow(int16_t* data) {
  int16_t* p = data;
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    for (int ctr = 0; ctr < 8; ++ctr, p += stride) {
      int64_t d[8];
      for (int i = 0; i < 8; ++i) d[i] = p[i * step];
      int64_t tmp0 = d[0] + d[7], tmp7 = d[0] - d[7], tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
      int64_t tmp2 = d[2] + d[5], tmp5 = d[2] - d[5], tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int n = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
      if (pass) {
        p[0] = int16_t(fdescale(tmp10 + tmp11, kPass1Bits));
        p[4 * step] = int16_t(fdescale(tmp10 - tmp11, kPass1Bits));
      } else {
        p[0] = int16_t((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4] = int16_t((tmp10 - tmp11) * (1 << kPass1Bits));
      }
      int64_t z1 = (tmp12 + tmp13) * 4433;
      p[2 * step] = int16_t(fdescale(z1 + tmp13 * 6270, n));
      p[6 * step] = int16_t(fdescale(z1 - tmp12 * 15137, n));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * 9633;
      tmp4 *= 2446;
      tmp5 *= 16819;
      tmp6 *= 25172;
      tmp7 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 = z3 * -16069 + z5;
      z4 = z4 * -3196 + z5;
      p[7 * step] = int16_t(fdescale(tmp4 + z1 + z3, n));
      p[5 * step] = int16_t(fdescale(tmp5 + z2 + z4, n));
      p[3 * step] = int16_t(fdescale(tmp6 + z2 + z3, n));
      p[1 * step] = int16_t(fdescale(tmp7 + z1 + z4, n));
    }
    p = data;
  }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t buf = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t byte = uint8_t(buf >> (nbits - 8));
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0);
      nbits -= 8;
    }
    buf &= (1u << nbits) - 1;
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);
  }
};

struct EncComponent {
  int h, v, tq;
  int bw, bh;                  // blocks with data (width_in_blocks, height_in_blocks)
  int pw, ph;                  // samples in the padded plane
  std::vector<uint8_t> plane;  // [ph][pw]
  std::vector<int16_t> coef;   // [MCU rows * v][MCU cols * h][64] quantized, natural order
  int pred = 0;
};

void put_marker(std::vector<uint8_t>& o, uint8_t m, const std::vector<uint8_t>& body) {
  o.push_back(0xFF);
  o.push_back(m);
  size_t n = body.size() + 2;
  o.push_back(uint8_t(n >> 8));
  o.push_back(uint8_t(n & 0xFF));
  o.insert(o.end(), body.begin(), body.end());
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals) {
  std::vector<uint8_t> b{uint8_t(cls_id)};
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  b.insert(b.end(), bits, bits + 16);
  b.insert(b.end(), vals, vals + n);
  put_marker(o, 0xC4, b);
}

std::vector<uint8_t> encode(const uint8_t* img, int height, int width, int quality) {
  if (height <= 0 || width <= 0 || height > 65535 || width > 65535)
    unsupported("JPEG of size " + std::to_string(height) + "x" + std::to_string(width));
  const int ncomp = 3, maxs = 2;
  const int mcu_cols = (width + 8 * maxs - 1) / (8 * maxs);
  const int mcu_rows = (height + 8 * maxs - 1) / (8 * maxs);
  uint16_t q[2][64];
  quant_table(kStdLumaQuant, quality, q[0]);
  quant_table(kStdChromaQuant, quality, q[1]);

  // Colour conversion at full size, rows padded to an even count (the
  // row group of jcprepct.c) by the last row.
  const int rows = (height + 1) / 2 * 2;
  std::vector<uint8_t> full[3];
  for (int c = 0; c < ncomp; ++c) full[c].resize(size_t(rows) * width);
  {
    constexpr int kSB = 16;
    const int32_t half = int32_t(1) << (kSB - 1), offset = int32_t(128) << kSB;
    auto fix = [](double x) { return int32_t(x * (1 << kSB) + 0.5); };
    const int32_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const int32_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.50000);
    const int32_t gcr = -fix(0.41869), bcr = -fix(0.08131);
    for (size_t i = 0, n = size_t(height) * width; i < n; ++i) {
      int32_t r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
      full[0][i] = uint8_t((ry * r + gy * g + by * b + half) >> kSB);
      full[1][i] = uint8_t((rcb * r + gcb * g + bcb * b + offset + half - 1) >> kSB);
      full[2][i] = uint8_t((bcb * r + gcr * g + bcr * b + offset + half - 1) >> kSB);
    }
  }
  for (int c = 0; c < ncomp; ++c)
    for (int y = height; y < rows; ++y)
      std::memcpy(&full[c][size_t(y) * width], &full[c][size_t(height - 1) * width], width);

  EncComponent comp[3];
  for (int c = 0; c < ncomp; ++c) {
    EncComponent& k = comp[c];
    k.h = k.v = c == 0 ? maxs : 1;
    k.tq = c == 0 ? 0 : 1;
    const int f = maxs / k.h;          // downsampling factor
    k.bw = (width * k.h + 8 * maxs - 1) / (8 * maxs);
    k.bh = (height * k.v + 8 * maxs - 1) / (8 * maxs);
    k.pw = mcu_cols * k.h * 8;
    k.ph = mcu_rows * k.v * 8;
    k.plane.assign(size_t(k.pw) * k.ph, 0);
    const int out_cols = k.bw * 8, down_rows = rows / f;
    std::vector<uint8_t> row(size_t(out_cols) * f);
    for (int y = 0; y < down_rows; ++y) {
      uint8_t* o = &k.plane[size_t(y) * k.pw];
      if (f == 1) {
        std::memcpy(row.data(), &full[c][size_t(y) * width], width);
        for (int x = width; x < out_cols; ++x) row[x] = row[width - 1];
        std::memcpy(o, row.data(), out_cols);
      } else {
        std::vector<uint8_t> r1(row.size());
        std::memcpy(row.data(), &full[c][size_t(2 * y) * width], width);
        std::memcpy(r1.data(), &full[c][size_t(2 * y + 1) * width], width);
        for (size_t x = width; x < row.size(); ++x) {
          row[x] = row[width - 1];
          r1[x] = r1[width - 1];
        }
        int bias = 1;
        for (int x = 0; x < out_cols; ++x) {
          o[x] = uint8_t((row[2 * x] + row[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    // the downsampled plane's last row repeated to the iMCU's height
    const int imcu_rows = (down_rows + 8 * k.v - 1) / (8 * k.v) * 8 * k.v;
    for (int y = down_rows; y < imcu_rows && y < k.ph; ++y)
      std::memcpy(&k.plane[size_t(y) * k.pw], &k.plane[size_t(down_rows - 1) * k.pw], out_cols);

    // DCT and quantization of the blocks with data; dummy blocks after.
    Divisor div[64];
    for (int i = 0; i < 64; ++i) div[i] = reciprocal(uint16_t(q[k.tq][i] << 3));
    const int cols = mcu_cols * k.h, brows = mcu_rows * k.v;
    k.coef.assign(size_t(cols) * brows * 64, 0);
    for (int by = 0; by < brows; ++by) {
      for (int bx = 0; bx < cols; ++bx) {
        int16_t* blk = &k.coef[(size_t(by) * cols + bx) * 64];
        if (by >= k.bh) {
          // A dummy row (never an MCU's first): the DC of the block coded
          // just before the row, the last of the MCU's row above.
          blk[0] = k.coef[(size_t(by - 1) * cols + (bx / k.h) * k.h + k.h - 1) * 64];
          continue;
        }
        if (bx >= k.bw) {          // a dummy column: the DC of the block to its left
          blk[0] = blk[-64];
          continue;
        }
        int16_t ws[64];
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            ws[y * 8 + x] = int16_t(int(k.plane[size_t(by * 8 + y) * k.pw + bx * 8 + x]) - 128);
        fdct_islow(ws);
        for (int i = 0; i < 64; ++i) {
          int t = ws[i];
          const bool neg = t < 0;
          uint32_t a = uint32_t(neg ? -t : t);
          uint32_t prod = ((a + div[i].corr) & 0xFFFF) * div[i].recip;
          int v = int(uint16_t(prod >> (div[i].shift + 16)));
          blk[i] = int16_t(neg ? -v : v);
        }
      }
    }
  }

  std::vector<uint8_t> out{0xFF, 0xD8};
  out.reserve(size_t(height) * width * 3 / 4 + 1024);
  put_marker(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < 2; ++t) {
    std::vector<uint8_t> b{uint8_t(t)};
    for (int i = 0; i < 64; ++i) b.push_back(uint8_t(q[t][kZigzag[i]]));
    put_marker(out, 0xDB, b);
  }
  std::vector<uint8_t> sof{8, uint8_t(height >> 8), uint8_t(height), uint8_t(width >> 8),
                           uint8_t(width), uint8_t(ncomp)};
  for (int c = 0; c < ncomp; ++c) {
    sof.push_back(uint8_t(c + 1));
    sof.push_back(uint8_t((comp[c].h << 4) | comp[c].v));
    sof.push_back(uint8_t(comp[c].tq));
  }
  put_marker(out, 0xC0, sof);
  put_dht(out, 0x00, kDcLumaBits, kDcVals);
  put_dht(out, 0x10, kAcLumaBits, kAcLumaVals);
  put_dht(out, 0x01, kDcChromaBits, kDcVals);
  put_dht(out, 0x11, kAcChromaBits, kAcChromaVals);
  std::vector<uint8_t> sos{uint8_t(ncomp)};
  for (int c = 0; c < ncomp; ++c) {
    sos.push_back(uint8_t(c + 1));
    sos.push_back(uint8_t(c == 0 ? 0x00 : 0x11));
  }
  sos.insert(sos.end(), {0, 63, 0});
  put_marker(out, 0xDA, sos);

  static const HuffCode dc[2] = {HuffCode(kDcLumaBits, kDcVals), HuffCode(kDcChromaBits, kDcVals)};
  static const HuffCode ac[2] = {HuffCode(kAcLumaBits, kAcLumaVals),
                                 HuffCode(kAcChromaBits, kAcChromaVals)};
  BitWriter bw(out);
  auto nbits_of = [](int v) {
    int n = 0;
    while (v) {
      ++n;
      v >>= 1;
    }
    return n;
  };
  for (int my = 0; my < mcu_rows; ++my)
    for (int mx = 0; mx < mcu_cols; ++mx)
      for (int c = 0; c < ncomp; ++c) {
        EncComponent& k = comp[c];
        const HuffCode &d = dc[k.tq], &a = ac[k.tq];
        const int cols = mcu_cols * k.h;
        for (int yi = 0; yi < k.v; ++yi)
          for (int xi = 0; xi < k.h; ++xi) {
            const int16_t* blk = &k.coef[(size_t(my * k.v + yi) * cols + mx * k.h + xi) * 64];
            int diff = blk[0] - k.pred;
            k.pred = blk[0];
            int t = diff < 0 ? -diff : diff, t2 = diff < 0 ? diff - 1 : diff;
            int nb = nbits_of(t);
            bw.put(d.code[nb], d.size[nb]);
            if (nb) bw.put(uint32_t(t2), nb);
            int run = 0;
            for (int i = 1; i < 64; ++i) {
              int v = blk[kZigzag[i]];
              if (v == 0) {
                ++run;
                continue;
              }
              while (run > 15) {
                bw.put(a.code[0xF0], a.size[0xF0]);
                run -= 16;
              }
              int av = v < 0 ? -v : v, v2 = v < 0 ? v - 1 : v;
              nb = nbits_of(av);
              bw.put(a.code[(run << 4) + nb], a.size[(run << 4) + nb]);
              bw.put(uint32_t(v2), nb);
              run = 0;
            }
            if (run > 0) bw.put(a.code[0], a.size[0]);
          }
      }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

int report(const CodecError& e, char* err, size_t errlen) {
  if (err && errlen) std::snprintf(err, errlen, "%s", e.msg.c_str());
  return e.unsupported ? -2 : -1;
}

}  // namespace

extern "C" {

// Frame size and EXIF orientation (1-8; 1 without the tag) of a JPEG stream.
int jpeg_info(const uint8_t* data, size_t size, int* height, int* width, int* orientation,
              char* err, size_t errlen) {
  try {
    Jpeg j(data, size);
    j.parse(false);
    *height = j.height;
    *width = j.width;
    *orientation = j.orientation;
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{"out of memory decoding JPEG", false}, err, errlen);
  }
}

// Decode into out[height][width][3] (RGB), as stored (orientation not applied).
int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, char* err,
                size_t errlen) {
  try {
    Jpeg j(data, size);
    j.parse(true);
    size_t n = size_t(j.width) * j.height;
    if (out_size != 3 * n) fail("output buffer of the wrong size");
    if (j.block_smoothing())
      unsupported("progressive JPEG whose scans leave low bits of the first coefficients "
                  "unsent: libjpeg decodes it with block smoothing, which is not supported");
    if (j.ncomp == 1) {
      std::vector<uint8_t> g = component_plane(j.comp[0]);
      const int dw = j.comp[0].dw;
      for (int y = 0; y < j.height; ++y)
        for (int x = 0; x < j.width; ++x) {
          uint8_t v = g[size_t(y) * dw + x];
          uint8_t* o = out + 3 * (size_t(y) * j.width + x);
          o[0] = o[1] = o[2] = v;
        }
      return 0;
    }
    std::vector<uint8_t> p[4];
    for (int i = 0; i < j.ncomp; ++i) p[i] = upsample(j, j.comp[i], component_plane(j.comp[i]));
    if (j.ncomp == 4) {  // jdapimin.c: Adobe transform 0 is CMYK, any other YCCK
      cmyk_to_rgb(p, n, j.adobe && j.adobe_transform != 0, out);
      return 0;
    }
    // jdapimin.c: JFIF means YCbCr; else Adobe transform 0 means RGB; else
    // the component ids 'R', 'G', 'B' do.
    bool rgb = !j.jfif && (j.adobe ? j.adobe_transform == 0
                                   : j.comp[0].id == 'R' && j.comp[1].id == 'G' &&
                                         j.comp[2].id == 'B');
    if (rgb) {
      for (size_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) out[3 * i + k] = p[k][i];
    } else {
      ycc_to_rgb(p[0].data(), p[1].data(), p[2].data(), n, out);
    }
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{"out of memory decoding JPEG", false}, err, errlen);
  }
}

// RLE8 (bits 8) or RLE4 (bits 4) BMP pixel data -> out[height][width]
// palette indices in the stream's row order (grfmt_bmp.cpp, see the header).
int bmp_rle(const uint8_t* data, size_t size, int bits, int width, int height, uint8_t* out,
            char* err, size_t errlen) {
  try {
    if ((bits != 4 && bits != 8) || width <= 0 || height <= 0) fail("bad RLE BMP parameters");
    size_t pos = 0;
    auto byte = [&]() -> int {
      if (pos >= size) fail("truncated RLE BMP data");
      return data[pos++];
    };
    long x = 0, y = 0;
    // FillUniColor: count pixels of index 0 from (x, y) on, wrapping rows.
    auto fill = [&](long count, int index) {
      do {
        long end = std::min<long>(x + count, width);
        count -= end - x;
        if (end > x) std::memset(out + size_t(y) * width + x, index, size_t(end - x));
        x = end;
        if (x >= width) {
          x = 0;
          if (++y >= height) break;
        }
      } while (count > 0);
    };
    bool wrapped = false;  // RLE8: the last run ended its row (line_end_flag)
    for (;;) {
      int len = byte(), code = byte();
      if (len) {  // encoded run
        if (x + len > width) fail("RLE BMP run past the end of its row");
        if (bits == 8) {
          long y0 = y;
          fill(len, code);
          wrapped = y != y0;
          if (y >= height) break;
        } else {
          for (int i = 0; i < len; ++i)  // two colours, alternating
            out[size_t(y) * width + x + i] = uint8_t(i & 1 ? code & 15 : code >> 4);
          x += len;
        }
      } else if (code > 2) {  // absolute run, padded to 16 bits
        if (x + code > width) fail("RLE BMP run past the end of its row");
        int nbytes = bits == 8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
        if (pos + nbytes > size) fail("truncated RLE BMP data");
        for (int i = 0; i < code; ++i) {
          int v = bits == 8 ? data[pos + i]
                            : (i & 1 ? data[pos + i / 2] & 15 : data[pos + i / 2] >> 4);
          out[size_t(y) * width + x + i] = uint8_t(v);
        }
        pos += nbytes;
        x += code;
        wrapped = false;
      } else {  // 0: end of line, 1: end of bitmap, 2: delta
        long dx = width - x, dy = height - y;
        if (bits == 8 && code == 0 && wrapped && dx == width) {
          wrapped = false;  // the run before already moved to this row
          continue;
        }
        if (code == 2) {
          dx = byte();
          dy = byte();
        }
        if (y >= height) break;
        // RLE4 (as OpenCV 5.0.0 reads it): end of bitmap ends the line
        // only, and a delta's dy is read but not applied.
        fill(dx + (code && bits == 8 ? dy * width : 0), 0);
        wrapped = false;
        if (y >= height) break;
      }
    }
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, errlen);
  }
}

// Undo the PNG row filters: rows is [height][1 + rowbytes] (filter byte
// first), out is [height][rowbytes]; bpp is the bytes of one pixel.
int png_unfilter(const uint8_t* rows, int height, int rowbytes, int bpp, uint8_t* out,
                 char* err, size_t errlen) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = rows + size_t(y) * (rowbytes + 1);
    uint8_t* cur = out + size_t(y) * rowbytes;
    const uint8_t* up = y ? cur - rowbytes : nullptr;
    int kind = src[0];
    ++src;
    switch (kind) {
      case 0:
        std::memcpy(cur, src, rowbytes);
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i) cur[i] = uint8_t(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i) cur[i] = uint8_t(src[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          cur[i] = uint8_t(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = uint8_t(src[i] + pred);
        }
        break;
      default:
        if (err && errlen) std::snprintf(err, errlen, "PNG row filter %d does not exist", kind);
        return -1;
    }
  }
  return 0;
}

// Encode img[height][width][3] (RGB) at quality 1-100 into out (capacity
// out_size); *written is the stream's length. Returns -3 when out is too
// small (*written: the length needed).
int jpeg_encode(const uint8_t* img, int height, int width, int quality, uint8_t* out,
                size_t out_size, size_t* written, char* err, size_t errlen) {
  try {
    std::vector<uint8_t> s = encode(img, height, width, quality);
    *written = s.size();
    if (s.size() > out_size) return -3;
    std::memcpy(out, s.data(), s.size());
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(CodecError{"out of memory encoding JPEG", false}, err, errlen);
  }
}

// The LZW image data of a GIF frame: indices[n] (each below 1 << min_bits,
// min_bits 2-8) -> out: the sub-blocks of at most 255 bytes and the zero
// block that ends them. Returns -3 when out is too small.
int gif_lzw(const uint8_t* indices, size_t n, int min_bits, uint8_t* out, size_t out_size,
            size_t* written, char* err, size_t errlen) {
  if (min_bits < 2 || min_bits > 8) {
    if (err && errlen) std::snprintf(err, errlen, "GIF LZW code size %d", min_bits);
    return -1;
  }
  const int clear = 1 << min_bits, end = clear + 1;
  // table[(prefix << 8) | byte] -> code, 0 where absent
  std::vector<uint16_t> table(size_t(4096) << 8, 0);
  std::vector<uint8_t> data;
  data.reserve(n / 2 + 16);
  uint32_t buf = 0;
  int nbits = 0, width = min_bits + 1, next = end + 1;
  auto emit = [&](int code) {
    buf |= uint32_t(code) << nbits;
    nbits += width;
    while (nbits >= 8) {
      data.push_back(uint8_t(buf & 0xFF));
      buf >>= 8;
      nbits -= 8;
    }
  };
  std::vector<int> used;
  emit(clear);
  if (n) {
    int prefix = indices[0];
    for (size_t i = 1; i < n; ++i) {
      const uint8_t c = indices[i];
      if (c >= clear) {
        if (err && errlen) std::snprintf(err, errlen, "GIF index %d past %d colours", c, clear);
        return -1;
      }
      const size_t key = (size_t(prefix) << 8) | c;
      if (table[key]) {
        prefix = table[key];
        continue;
      }
      emit(prefix);
      // as giflib: the table holds codes below 4095, and the decoder, one
      // entry behind, reads the code after the one that adds entry
      // 1 << width with a bit more
      if (next < 4095) {
        table[key] = uint16_t(next);
        used.push_back(int(key));
        if (next == (1 << width) && width < 12) ++width;
        ++next;
      } else {
        emit(clear);
        for (int k : used) table[k] = 0;
        used.clear();
        width = min_bits + 1;
        next = end + 1;
      }
      prefix = c;
    }
    emit(prefix);
  }
  emit(end);
  if (nbits) data.push_back(uint8_t(buf & 0xFF));
  const size_t blocks = (data.size() + 254) / 255;
  *written = data.size() + blocks + 1;
  if (*written > out_size) return -3;
  uint8_t* o = out;
  for (size_t i = 0; i < data.size(); i += 255) {
    const size_t k = std::min<size_t>(255, data.size() - i);
    *o++ = uint8_t(k);
    std::memcpy(o, &data[i], k);
    o += k;
  }
  *o = 0;
  return 0;
}

}  // extern "C"
