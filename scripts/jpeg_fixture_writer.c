/* Writes the JPEG kinds that PIL does not write, with libjpeg (the
 * system's jpeglib.h): arithmetic coding, YCCK, CMYK without an Adobe
 * marker, any sampling factors, restart intervals and scan scripts.
 * scripts/make_jpeg_fixtures.py compiles it into the gitignored build/
 * directory and runs it; nothing else needs it.
 *
 *   jpeg_fixture_writer IN OUT W H COMPONENTS SPACE QUALITY SAMPLING
 *                       ARITH RESTART SCANS ADOBE
 *
 * IN holds H x W x COMPONENTS bytes (RGB, grey, or CMYK as PIL stores it).
 * SPACE: ycbcr, rgb, gray, cmyk or ycck (the colour space written).
 * SAMPLING: "HxV,HxV,..." per component ("-" for libjpeg's default).
 * ARITH: 1 for arithmetic coding. RESTART: the restart interval in MCUs.
 * SCANS: "-" for one sequential scan, "p" for jpeg_simple_progression, or
 * a scan script "comps:Ss-Se:Ah-Al;..." (comps as digits, e.g. "012").
 * ADOBE: 1 or 0 to force the Adobe marker on or off, - for the default. */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static jpeg_scan_info scans[64];

static int parse_scans(const char* s) {
  int n = 0;
  while (*s && n < 64) {
    jpeg_scan_info* sc = &scans[n++];
    sc->comps_in_scan = 0;
    while (*s >= '0' && *s <= '9') sc->component_index[sc->comps_in_scan++] =
        *s++ - '0';
    if (sscanf(s, ":%d-%d:%d-%d", &sc->Ss, &sc->Se, &sc->Ah, &sc->Al) != 4)
      return -1;
    while (*s && *s != ';') ++s;
    if (*s == ';') ++s;
  }
  return n;
}

int main(int argc, char** argv) {
  if (argc != 13) {
    fprintf(stderr, "usage: see the head of jpeg_fixture_writer.c\n");
    return 2;
  }
  const int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]);
  const char* space = argv[6];
  size_t bytes = (size_t)w * h * nc;
  unsigned char* px = malloc(bytes);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(px, 1, bytes, in) != bytes) return 3;
  fclose(in);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr err;
  c.err = jpeg_std_error(&err);
  jpeg_create_compress(&c);
  FILE* out = fopen(argv[2], "wb");
  if (!out) return 3;
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : nc == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&c);
  J_COLOR_SPACE js = !strcmp(space, "ycbcr") ? JCS_YCbCr
                     : !strcmp(space, "rgb") ? JCS_RGB
                     : !strcmp(space, "gray") ? JCS_GRAYSCALE
                     : !strcmp(space, "cmyk") ? JCS_CMYK : JCS_YCCK;
  jpeg_set_colorspace(&c, js);
  jpeg_set_quality(&c, atoi(argv[7]), TRUE);
  if (strcmp(argv[8], "-")) {
    const char* s = argv[8];
    for (int i = 0; i < c.num_components && *s; ++i) {
      int hs, vs;
      if (sscanf(s, "%dx%d", &hs, &vs) != 2) return 4;
      c.comp_info[i].h_samp_factor = hs;
      c.comp_info[i].v_samp_factor = vs;
      while (*s && *s != ',') ++s;
      if (*s == ',') ++s;
    }
  }
  c.arith_code = atoi(argv[9]) ? TRUE : FALSE;
  c.restart_interval = atoi(argv[10]);
  if (!strcmp(argv[11], "p")) {
    jpeg_simple_progression(&c);
  } else if (strcmp(argv[11], "-")) {
    int n = parse_scans(argv[11]);
    if (n <= 0) return 4;
    c.scan_info = scans;
    c.num_scans = n;
  }
  if (strcmp(argv[12], "-")) c.write_Adobe_marker = atoi(argv[12]) != 0;
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  free(px);
  return 0;
}
