/* Write video files with libx264 (or another encoder, encoder=NAME: mpeg4,
 * libxvid) through the system's libavcodec and libavformat, with any of the
 * encoder's options: the fixtures of the port's H.264 and MPEG-4 Part 2
 * decoders (tools/torch_make_video_fixtures.py).
 *
 *   cc -O2 -o build/torch_h264_writer tools/torch_h264_writer.c \
 *       -lavformat -lavcodec -lavutil
 *   build/torch_h264_writer in.raw out.mp4 WIDTH HEIGHT FRAMES FPS PIXFMT [name=value ...]
 *
 * in.raw holds FRAMES frames of planar PIXFMT samples, each plane whole and
 * in order (yuv420p, yuv444p, yuv420p10le: 16-bit little-endian samples).
 * The container follows the output's extension (.mp4, .mov, .avi); an AVI
 * stream carries Annex B packets with the fourcc H264 unless tag=XXXX.
 * intra_matrix=v0,...,v63 and inter_matrix=... set the quantisation matrices
 * (raster order), which have no AVOption. Every other name=value is an AVOption of the encoder or its private
 * options (x264-params=..., profile=..., preset=..., color_range=pc, g=...).
 * The encoder is flushed at the end, so that every frame is written.
 * Built against libavformat/libavcodec 59, libx264 164 and libxvidcore 4; the committed
 * fixtures name the versions that wrote them. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>

static void die(const char *msg) {
  fprintf(stderr, "torch_h264_writer: %s\n", msg);
  exit(1);
}

static void write_packets(AVCodecContext *ctx, AVFormatContext *fmt, AVStream *st,
                          AVPacket *pkt) {
  while (avcodec_receive_packet(ctx, pkt) == 0) {
    av_packet_rescale_ts(pkt, ctx->time_base, st->time_base);
    pkt->stream_index = st->index;
    if (av_interleaved_write_frame(fmt, pkt) < 0) die("av_interleaved_write_frame failed");
  }
}

int main(int argc, char **argv) {
  if (argc < 8) die("usage: in.raw out WIDTH HEIGHT FRAMES FPS PIXFMT [name=value ...]");
  int width = atoi(argv[3]), height = atoi(argv[4]), frames = atoi(argv[5]);
  int fps = atoi(argv[6]);
  enum AVPixelFormat pixfmt = av_get_pix_fmt(argv[7]);
  if (width <= 0 || height <= 0 || frames <= 0 || fps <= 0 || pixfmt == AV_PIX_FMT_NONE)
    die("bad size, count, rate or pixel format");

  AVFormatContext *fmt = NULL;
  if (avformat_alloc_output_context2(&fmt, NULL, NULL, argv[2]) < 0) die("unknown container");
  const char *encoder = "libx264";
  for (int i = 8; i < argc; ++i)
    if (!strncmp(argv[i], "encoder=", 8)) encoder = argv[i] + 8;
  const AVCodec *codec = avcodec_find_encoder_by_name(encoder);
  if (!codec) die("no such encoder in this libavcodec");
  AVCodecContext *ctx = avcodec_alloc_context3(codec);
  ctx->width = width;
  ctx->height = height;
  ctx->pix_fmt = pixfmt;
  ctx->time_base = (AVRational){1, fps};
  ctx->framerate = (AVRational){fps, 1};
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER) ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  const char *tag = NULL;
  for (int i = 8; i < argc; ++i) {
    char *eq = strchr(argv[i], '=');
    if (!eq) die("options are name=value");
    *eq = 0;
    if (!strcmp(argv[i], "tag")) {
      tag = eq + 1;
      continue;
    }
    if (!strcmp(argv[i], "encoder")) continue;
    if (!strcmp(argv[i], "intra_matrix") || !strcmp(argv[i], "inter_matrix")) {
      uint16_t *m = av_mallocz(64 * sizeof *m);
      char *p = eq + 1;
      for (int k = 0; k < 64; ++k) {
        m[k] = (uint16_t)strtol(p, &p, 10);
        if (m[k] == 0 || m[k] > 255 || (k < 63 && *p++ != ',')) die("a matrix takes 64 values 1-255");
      }
      if (!strcmp(argv[i], "intra_matrix")) ctx->intra_matrix = m;
      else ctx->inter_matrix = m;
      continue;
    }
    if (av_opt_set(ctx, argv[i], eq + 1, AV_OPT_SEARCH_CHILDREN) < 0) {
      fprintf(stderr, "torch_h264_writer: the option %s=%s\n", argv[i], eq + 1);
      die("an option the encoder does not take");
    }
  }
  if (avcodec_open2(ctx, codec, NULL) < 0) die("the encoder does not open with these options");
  AVStream *st = avformat_new_stream(fmt, NULL);
  if (avcodec_parameters_from_context(st->codecpar, ctx) < 0) die("codec parameters");
  st->time_base = ctx->time_base;
  if (tag) {
    if (strlen(tag) != 4) die("tag takes a fourcc");
    st->codecpar->codec_tag = MKTAG(tag[0], tag[1], tag[2], tag[3]);
  }
  if (avio_open(&fmt->pb, argv[2], AVIO_FLAG_WRITE) < 0) die("cannot open the output");
  if (avformat_write_header(fmt, NULL) < 0) die("avformat_write_header failed");

  AVFrame *frame = av_frame_alloc();
  frame->width = width;
  frame->height = height;
  frame->format = pixfmt;
  if (av_frame_get_buffer(frame, 0) < 0) die("av_frame_get_buffer failed");
  AVPacket *pkt = av_packet_alloc();
  const AVPixFmtDescriptor *desc = av_pix_fmt_desc_get(pixfmt);
  int bytes = desc->comp[0].depth > 8 ? 2 : 1;
  FILE *in = fopen(argv[1], "rb");
  if (!in) die("cannot open the input");
  for (int n = 0; n < frames; ++n) {
    if (av_frame_make_writable(frame) < 0) die("av_frame_make_writable failed");
    for (int p = 0; p < 3; ++p) {
      int pw = p ? AV_CEIL_RSHIFT(width, desc->log2_chroma_w) : width;
      int ph = p ? AV_CEIL_RSHIFT(height, desc->log2_chroma_h) : height;
      for (int r = 0; r < ph; ++r)
        if (fread(frame->data[p] + (size_t)r * frame->linesize[p], bytes, pw, in) != (size_t)pw)
          die("the input holds fewer frames than FRAMES");
    }
    frame->pts = n;
    if (avcodec_send_frame(ctx, frame) < 0) die("avcodec_send_frame failed");
    write_packets(ctx, fmt, st, pkt);
  }
  fclose(in);
  if (avcodec_send_frame(ctx, NULL) < 0) die("flushing the encoder failed");
  write_packets(ctx, fmt, st, pkt);
  if (av_write_trailer(fmt) < 0) die("av_write_trailer failed");
  avio_closep(&fmt->pb);
  av_packet_free(&pkt);
  av_frame_free(&frame);
  avcodec_free_context(&ctx);
  avformat_free_context(fmt);
  return 0;
}
