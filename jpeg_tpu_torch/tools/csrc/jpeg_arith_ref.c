/* Ground-truth generator for arithmetic-coded JPEG tests.
 *
 * Drives the system libjpeg-turbo (which ships the Annex D/E/F QM coder)
 * to (a) encode raw RGB/gray into arithmetic-coded JPEG (SOF9/SOF10) and
 * (b) decode any JPEG back to raw, so jpeg_tpu's own arithmetic codec can
 * be validated against an independent implementation in BOTH directions.
 * Test-fixture tooling only — not part of the engine.
 *
 * Build: gcc -O2 -o tools/jpeg_arith_ref tools/jpeg_arith_ref.c -ljpeg
 * Usage:
 *   jpeg_arith_ref encode <raw.rgb> <w> <h> <ncomp> <quality> <out.jpg>
 *       [progressive] [restart_rows]
 *   jpeg_arith_ref decode <in.jpg> <out.raw>   (writes w h ncomp header line)
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

static int encode(const char *raw_path, int w, int h, int ncomp, int quality,
                  const char *out_path, int progressive, int restart_rows) {
  FILE *fin = fopen(raw_path, "rb");
  FILE *fout = fopen(out_path, "wb");
  if (!fin || !fout) return 2;
  size_t n = (size_t)w * h * ncomp;
  unsigned char *buf = malloc(n);
  if (fread(buf, 1, n, fin) != n) return 3;
  fclose(fin);

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, fout);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = ncomp;
  cinfo.in_color_space = ncomp == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.arith_code = TRUE; /* SOF9/SOF10 + DAC */
  if (progressive) jpeg_simple_progression(&cinfo);
  if (restart_rows > 0) cinfo.restart_in_rows = restart_rows;
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = buf + (size_t)cinfo.next_scanline * w * ncomp;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(fout);
  free(buf);
  return 0;
}

/* Dump raw DCT coefficients (per component, natural block raster order,
 * zigzag-ordered int16[64] per block) — entropy-layer ground truth. */
static int coeffs(const char *in_path, const char *out_path) {
  FILE *fin = fopen(in_path, "rb");
  FILE *fout = fopen(out_path, "wb");
  if (!fin || !fout) return 2;
  struct jpeg_decompress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fin);
  jpeg_read_header(&cinfo, TRUE);
  jvirt_barray_ptr *arrays = jpeg_read_coefficients(&cinfo);
  fprintf(fout, "%d\n", cinfo.num_components);
  for (int ci = 0; ci < cinfo.num_components; ci++) {
    jpeg_component_info *comp = &cinfo.comp_info[ci];
    int bw = comp->width_in_blocks, bh = comp->height_in_blocks;
    fprintf(fout, "%d %d\n", bh, bw);
    for (int by = 0; by < bh; by++) {
      JBLOCKARRAY rows = (*cinfo.mem->access_virt_barray)(
          (j_common_ptr)&cinfo, arrays[ci], by, 1, FALSE);
      fwrite(rows[0], sizeof(JBLOCK), bw, fout);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fin);
  fclose(fout);
  return 0;
}

static int decode(const char *in_path, const char *out_path) {
  FILE *fin = fopen(in_path, "rb");
  FILE *fout = fopen(out_path, "wb");
  if (!fin || !fout) return 2;
  struct jpeg_decompress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fin);
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  int nc = cinfo.output_components;
  fprintf(fout, "%d %d %d\n", w, h, nc);
  unsigned char *row = malloc((size_t)w * nc);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW r = row;
    jpeg_read_scanlines(&cinfo, &r, 1);
    fwrite(row, 1, (size_t)w * nc, fout);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fin);
  fclose(fout);
  free(row);
  return 0;
}

int main(int argc, char **argv) {
  if (argc >= 8 && !strcmp(argv[1], "encode")) {
    int progressive = argc > 8 && atoi(argv[8]) != 0;
    int restart_rows = argc > 9 ? atoi(argv[9]) : 0;
    return encode(argv[2], atoi(argv[3]), atoi(argv[4]), atoi(argv[5]),
                  atoi(argv[6]), argv[7], progressive, restart_rows);
  }
  if (argc == 4 && !strcmp(argv[1], "decode")) return decode(argv[2], argv[3]);
  if (argc == 4 && !strcmp(argv[1], "coeffs")) return coeffs(argv[2], argv[3]);
  fprintf(stderr, "usage: see header comment\n");
  return 1;
}
