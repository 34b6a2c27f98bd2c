/* libjpeg as the JAX package's batch loader runs it (its native/loader.cpp:
 * jpeg_stdio_src, scale_num / 8, JCS_RGB, error_exit replaced so that
 * warnings do not stop the decode), built as a shared library against the
 * system's jpeglib.h for scripts/jpeg_recovery_oracle.py:
 *
 *   cc -O2 -shared -fPIC -o build/jpeg_recovery_oracle-<hash>.so
 *       scripts/jpeg_recovery_oracle.c -ljpeg
 *
 * jro_decode gives the raw n/8 pixels (no resize) and the number of
 * warnings; jro_coefficients each component's quantized coefficients as
 * jpeg_read_coefficients leaves them (the blocks that a damaged scan
 * never reached included), block by block, natural order. Both return 0,
 * or 1 with libjpeg's message in err.
 */
#include <setjmp.h>
#include <stdio.h>
#include <string.h>

#include <jpeglib.h>

struct err_mgr {
  struct jpeg_error_mgr mgr;
  jmp_buf jmp;
};

static void on_error(j_common_ptr cinfo) {
  longjmp(((struct err_mgr *)cinfo->err)->jmp, 1);
}

static void quiet(j_common_ptr cinfo) { (void)cinfo; }

static void message(j_common_ptr cinfo, char *err, int errlen) {
  char buf[JMSG_LENGTH_MAX];
  (*cinfo->err->format_message)(cinfo, buf);
  snprintf(err, (size_t)errlen, "%s", buf);
}

int jro_version(void) { return JPEG_LIB_VERSION; }

int jro_decode(const char *path, int n, unsigned char *out, long cap,
               int *w, int *h, long *warnings, char *err, int errlen) {
  struct jpeg_decompress_struct cinfo;
  struct err_mgr jerr;
  FILE *f = fopen(path, "rb");
  if (!f) {
    snprintf(err, (size_t)errlen, "cannot open %s", path);
    return 1;
  }
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = on_error;
  jerr.mgr.output_message = quiet;
  if (setjmp(jerr.jmp)) {
    message((j_common_ptr)&cinfo, err, errlen);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = (unsigned)n;
  cinfo.scale_denom = 8;
  jpeg_start_decompress(&cinfo);
  *w = (int)cinfo.output_width;
  *h = (int)cinfo.output_height;
  if ((long)*w * *h * 3 > cap) {
    snprintf(err, (size_t)errlen, "output of %dx%d above the buffer", *w, *h);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + (size_t)cinfo.output_scanline * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  *warnings = jerr.mgr.num_warnings;
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

/* dims[0] = components; then per component width and height in blocks */
int jro_coefficients(const char *path, short *out, long cap, int *dims,
                     char *err, int errlen) {
  struct jpeg_decompress_struct cinfo;
  struct err_mgr jerr;
  jvirt_barray_ptr *coefs;
  long used = 0;
  int ci;
  FILE *f = fopen(path, "rb");
  if (!f) {
    snprintf(err, (size_t)errlen, "cannot open %s", path);
    return 1;
  }
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = on_error;
  jerr.mgr.output_message = quiet;
  if (setjmp(jerr.jmp)) {
    message((j_common_ptr)&cinfo, err, errlen);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  coefs = jpeg_read_coefficients(&cinfo);
  dims[0] = cinfo.num_components;
  for (ci = 0; ci < cinfo.num_components; ci++) {
    jpeg_component_info *c = cinfo.comp_info + ci;
    JDIMENSION by, bx;
    int k;
    dims[1 + 2 * ci] = (int)c->width_in_blocks;
    dims[2 + 2 * ci] = (int)c->height_in_blocks;
    for (by = 0; by < c->height_in_blocks; by++) {
      JBLOCKARRAY row = (*cinfo.mem->access_virt_barray)(
          (j_common_ptr)&cinfo, coefs[ci], by, 1, FALSE);
      for (bx = 0; bx < c->width_in_blocks; bx++) {
        if (used + 64 > cap) {
          snprintf(err, (size_t)errlen, "coefficients above the buffer");
          jpeg_destroy_decompress(&cinfo);
          fclose(f);
          return 1;
        }
        for (k = 0; k < 64; k++) out[used++] = row[0][bx][k];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}
