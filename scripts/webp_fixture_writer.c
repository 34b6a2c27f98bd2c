/* Writes the WebP files that PIL's save cannot select, with the system's
 * libwebp (encode.h, mux.h): the simple loop filter, a filter strength of
 * 0, any sharpness, one segment, 2-8 token partitions, near-lossless,
 * each ALPH filter and compression, and an animation whose first frame
 * sits at an offset inside a larger canvas.
 * scripts/make_webp_fixtures.py compiles it into the gitignored build/
 * directory and runs it; nothing else needs it.
 *
 *   webp_fixture_writer IN OUT W H CHANNELS [KEY=VALUE ...]
 *
 * IN holds FRAMES x H x W x CHANNELS bytes (RGB or RGBA). Each KEY is a
 * field of WebPConfig (lossless, quality, method, segments, sns_strength,
 * filter_strength, filter_sharpness, filter_type, autofilter,
 * alpha_compression, alpha_filtering, alpha_quality, preprocessing,
 * partitions, near_lossless, exact, use_sharp_yuv), or one of:
 *   frames=N          the number of frames in IN (default 1);
 *   canvas=CW,CH,X,Y  write an animation on a CW x CH canvas, the first
 *                     frame at (X, Y) (even), the others at (0, 0). */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <webp/encode.h>
#include <webp/mux.h>

static int set_field(WebPConfig* c, const char* key, const char* val) {
  const int v = atoi(val);
#define FIELD(name)                 \
  if (!strcmp(key, #name)) {        \
    c->name = v;                    \
    return 1;                       \
  }
  FIELD(lossless) FIELD(method) FIELD(segments) FIELD(sns_strength)
  FIELD(filter_strength) FIELD(filter_sharpness) FIELD(filter_type)
  FIELD(autofilter) FIELD(alpha_compression) FIELD(alpha_filtering)
  FIELD(alpha_quality) FIELD(preprocessing) FIELD(partitions)
  FIELD(near_lossless) FIELD(exact) FIELD(use_sharp_yuv)
#undef FIELD
  if (!strcmp(key, "quality")) {
    c->quality = (float)atof(val);
    return 1;
  }
  return 0;
}

/* One frame encoded with the config: the whole RIFF file in *out. */
static int encode(const WebPConfig* c, const uint8_t* px, int w, int h,
                  int channels, WebPMemoryWriter* out) {
  WebPPicture pic;
  if (!WebPPictureInit(&pic)) return 0;
  pic.use_argb = c->lossless;
  pic.width = w;
  pic.height = h;
  int ok = channels == 4 ? WebPPictureImportRGBA(&pic, px, w * 4)
                         : WebPPictureImportRGB(&pic, px, w * 3);
  WebPMemoryWriterInit(out);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = out;
  ok = ok && WebPEncode(c, &pic);
  if (!ok) fprintf(stderr, "encode failed: %d\n", pic.error_code);
  WebPPictureFree(&pic);
  return ok;
}

int main(int argc, char** argv) {
  if (argc < 6) {
    fprintf(stderr, "usage: see the head of webp_fixture_writer.c\n");
    return 2;
  }
  const int w = atoi(argv[3]), h = atoi(argv[4]), ch = atoi(argv[5]);
  WebPConfig c;
  if (!WebPConfigInit(&c)) return 3;
  int frames = 1, cw = 0, chh = 0, x0 = 0, y0 = 0;
  for (int i = 6; i < argc; ++i) {
    char key[64];
    const char* eq = strchr(argv[i], '=');
    if (!eq || eq - argv[i] >= (int)sizeof(key)) return 2;
    memcpy(key, argv[i], eq - argv[i]);
    key[eq - argv[i]] = 0;
    if (!strcmp(key, "frames")) {
      frames = atoi(eq + 1);
    } else if (!strcmp(key, "canvas")) {
      if (sscanf(eq + 1, "%d,%d,%d,%d", &cw, &chh, &x0, &y0) != 4) return 2;
    } else if (!set_field(&c, key, eq + 1)) {
      fprintf(stderr, "unknown key %s\n", key);
      return 2;
    }
  }
  if (!WebPValidateConfig(&c)) {
    fprintf(stderr, "invalid config\n");
    return 2;
  }
  const size_t frame_bytes = (size_t)w * h * ch;
  uint8_t* px = malloc(frame_bytes * frames);
  FILE* in = fopen(argv[1], "rb");
  if (!px || !in || fread(px, 1, frame_bytes * frames, in) !=
                        frame_bytes * frames)
    return 3;
  fclose(in);
  WebPData assembled = {NULL, 0};
  WebPMemoryWriter still;
  if (cw == 0) {
    if (!encode(&c, px, w, h, ch, &still)) return 4;
    assembled.bytes = still.mem;
    assembled.size = still.size;
  } else {
    WebPMux* mux = WebPMuxNew();
    for (int f = 0; f < frames; ++f) {
      WebPMemoryWriter one;
      if (!encode(&c, px + f * frame_bytes, w, h, ch, &one)) return 4;
      WebPMuxFrameInfo info;
      memset(&info, 0, sizeof(info));
      info.bitstream.bytes = one.mem;
      info.bitstream.size = one.size;
      info.x_offset = f == 0 ? x0 : 0;
      info.y_offset = f == 0 ? y0 : 0;
      info.duration = 100;
      info.id = WEBP_CHUNK_ANMF;
      info.dispose_method = WEBP_MUX_DISPOSE_NONE;
      info.blend_method = WEBP_MUX_NO_BLEND;
      if (WebPMuxPushFrame(mux, &info, 1) != WEBP_MUX_OK) return 5;
      WebPMemoryWriterClear(&one);
    }
    WebPMuxAnimParams params = {0xff204060u, 0};
    if (WebPMuxSetAnimationParams(mux, &params) != WEBP_MUX_OK ||
        WebPMuxSetCanvasSize(mux, cw, chh) != WEBP_MUX_OK ||
        WebPMuxAssemble(mux, &assembled) != WEBP_MUX_OK)
      return 5;
    WebPMuxDelete(mux);
  }
  FILE* out = fopen(argv[2], "wb");
  if (!out || fwrite(assembled.bytes, 1, assembled.size, out) !=
                  assembled.size)
    return 3;
  fclose(out);
  return 0;
}
