/* Write JPEG files that OpenCV's writer cannot: arithmetic-coded
 * (sequential or progressive, with restart intervals and DAC conditioning),
 * YCCK and CMYK, and progressive files whose scans leave low bits unsent.
 *
 *   cc -O2 -o build/torch_jpeg_arith_writer tools/torch_jpeg_arith_writer.c -ljpeg
 *   build/torch_jpeg_arith_writer in.raw out.jpg WIDTH HEIGHT CHANNELS [options]
 *
 * in.raw holds HEIGHT x WIDTH x CHANNELS bytes: 1 gray, 3 RGB, 4 CMYK.
 * Options:
 *   -arith            arithmetic coding (SOF9, or SOF10 with -progressive)
 *   -progressive      libjpeg's simple progression (jpeg_simple_progression)
 *   -partial          a progression that stops short: DC, then the AC bands
 *                     with Al = 1 and no refinement (libjpeg block-smooths it)
 *   -restart N        a restart marker every N MCUs
 *   -quality Q        quantization tables scaled to quality Q (default 90)
 *   -sample HxV       the first component's sampling factors (default 2x2;
 *                     the others 1x1, but K of YCCK as the first)
 *   -dac L U K        DC conditioning L, U and AC Kx for every table
 *   -ycck             a 4-channel input written as YCCK (Adobe transform 2);
 *                     without it, as CMYK (Adobe transform 0)
 * It links the system's libjpeg, which must be built with
 * C_ARITH_CODING_SUPPORTED (libjpeg-turbo is; the committed fixtures were
 * written with 2.1.5). tools/torch_image_kinds.py compiles it into build/
 * for tools/torch_make_jpeg_fixtures.py and the tests. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static void die(const char *msg) {
  fprintf(stderr, "torch_jpeg_arith_writer: %s\n", msg);
  exit(1);
}

int main(int argc, char **argv) {
  if (argc < 6) die("usage: in.raw out.jpg WIDTH HEIGHT CHANNELS [options]");
  int width = atoi(argv[3]), height = atoi(argv[4]), channels = atoi(argv[5]);
  int arith = 0, progressive = 0, partial = 0, restart = 0, quality = 90, ycck = 0;
  int h0 = 2, v0 = 2, dac = 0, dac_l = 0, dac_u = 1, dac_k = 5;
  for (int i = 6; i < argc; ++i) {
    if (!strcmp(argv[i], "-arith")) arith = 1;
    else if (!strcmp(argv[i], "-progressive")) progressive = 1;
    else if (!strcmp(argv[i], "-partial")) partial = 1;
    else if (!strcmp(argv[i], "-ycck")) ycck = 1;
    else if (!strcmp(argv[i], "-restart") && i + 1 < argc) restart = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-quality") && i + 1 < argc) quality = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-sample") && i + 1 < argc) {
      if (sscanf(argv[++i], "%dx%d", &h0, &v0) != 2) die("-sample takes HxV");
    } else if (!strcmp(argv[i], "-dac") && i + 3 < argc) {
      dac = 1;
      dac_l = atoi(argv[++i]);
      dac_u = atoi(argv[++i]);
      dac_k = atoi(argv[++i]);
    } else {
      die("unknown option");
    }
  }
  if (width <= 0 || height <= 0 || (channels != 1 && channels != 3 && channels != 4))
    die("bad size or channels");
  size_t n = (size_t)width * height * channels;
  unsigned char *pixels = malloc(n);
  FILE *in = fopen(argv[1], "rb");
  if (!pixels || !in || fread(pixels, 1, n, in) != n) die("cannot read the input");
  fclose(in);
  FILE *out = fopen(argv[2], "wb");
  if (!out) die("cannot open the output");

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = channels;
  cinfo.in_color_space = channels == 1 ? JCS_GRAYSCALE : channels == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  if (channels == 4) jpeg_set_colorspace(&cinfo, ycck ? JCS_YCCK : JCS_CMYK);
  jpeg_set_quality(&cinfo, quality, TRUE);
  if (channels > 1) {
    cinfo.comp_info[0].h_samp_factor = h0;
    cinfo.comp_info[0].v_samp_factor = v0;
    for (int c = 1; c < channels; ++c) {
      int like_first = channels == 4 && ycck && c == 3;
      cinfo.comp_info[c].h_samp_factor = like_first ? h0 : 1;
      cinfo.comp_info[c].v_samp_factor = like_first ? v0 : 1;
    }
  }
  cinfo.arith_code = arith ? TRUE : FALSE;
  cinfo.restart_interval = restart;
  if (dac)
    for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
      cinfo.arith_dc_L[t] = (UINT8)dac_l;
      cinfo.arith_dc_U[t] = (UINT8)dac_u;
      cinfo.arith_ac_K[t] = (UINT8)dac_k;
    }
  static jpeg_scan_info scans[2 * MAX_COMPONENTS];
  if (partial) {
    int k = 0;
    scans[k].comps_in_scan = channels;
    for (int c = 0; c < channels; ++c) scans[k].component_index[c] = c;
    scans[k].Ss = scans[k].Se = scans[k].Ah = scans[k].Al = 0;
    ++k;
    for (int c = 0; c < channels; ++c, ++k) {
      scans[k].comps_in_scan = 1;
      scans[k].component_index[0] = c;
      scans[k].Ss = 1;
      scans[k].Se = 63;
      scans[k].Ah = 0;
      scans[k].Al = 1;
    }
    cinfo.scan_info = scans;
    cinfo.num_scans = k;
  } else if (progressive) {
    jpeg_simple_progression(&cinfo);
  }
  jpeg_start_compress(&cinfo, TRUE);
  size_t stride = (size_t)width * channels;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = pixels + cinfo.next_scanline * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(pixels);
  return 0;
}
