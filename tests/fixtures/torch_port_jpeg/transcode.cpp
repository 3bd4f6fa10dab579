// Writes the JPEG fixtures that PIL cannot write: coefficient-identical
// transcodes of a JPEG, as jpegtran makes them (jpeg_read_coefficients,
// jpeg_copy_critical_parameters, jpeg_write_coefficients), into
// progressive Huffman, sequential or progressive arithmetic coding (with a
// DAC marker of chosen conditioning and restart markers), an incomplete
// progressive scan script, or back to sequential Huffman; and a YCCK file
// (Adobe transform 2) from a CMYK JPEG's samples. The tests read the bytes
// it wrote and never build it; `python -m tests.test_torch_port_jpeg`
// builds and runs it when it writes the fixtures anew.
//
// Build (libjpeg with arithmetic coding, e.g. libjpeg-turbo 2.1):
//   g++ -O2 -o transcode transcode.cpp -ljpeg
// Run:
//   transcode IN OUT [--progressive] [--arith] [--dac] [--restart N]
//                    [--script dc|ac] [--ycck]
//   --progressive  jpeg_simple_progression's script (DC and AC bands,
//                  successive approximation, refinement to Al 0)
//   --arith        arithmetic coding (SOF9, or SOF10 when progressive)
//   --dac          conditioning other than the defaults: DC tables 0 and
//                  1 with L/U 2/6 and 1/3, AC tables with Kx 2 and 11
//   --restart N    a restart marker every N MCUs
//   --script dc    progressive, DC only: DC Al 1, then its refinement;
//                  no AC scan (every AC coefficient unknown)
//   --script ac    progressive, AC left at Al 1: DC, AC 1-5 at Al 2,
//                  AC 6-63 at Al 1, AC 1-5 refined to Al 1, and no final
//                  refinement
//   --ycck         decompress IN (4 components) and compress its samples
//                  as YCCK at quality 90 (the default 2x2,1x1,1x1,2x2
//                  sampling), instead of a transcode

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

FILE* open_or_die(const char* path, const char* mode) {
  FILE* f = std::fopen(path, mode);
  if (!f) {
    std::perror(path);
    std::exit(2);
  }
  return f;
}

jpeg_scan_info scan(int ncomp, const int* comps, int ss, int se, int ah,
                    int al) {
  jpeg_scan_info s;
  std::memset(&s, 0, sizeof s);
  s.comps_in_scan = ncomp;
  for (int i = 0; i < ncomp; i++) s.component_index[i] = comps[i];
  s.Ss = ss;
  s.Se = se;
  s.Ah = ah;
  s.Al = al;
  return s;
}

// the incomplete scripts of --script dc and --script ac
std::vector<jpeg_scan_info> script(const char* kind, int ncomp) {
  const int all[4] = {0, 1, 2, 3};
  std::vector<jpeg_scan_info> s;
  if (!std::strcmp(kind, "dc")) {
    s.push_back(scan(ncomp, all, 0, 0, 0, 1));
    s.push_back(scan(ncomp, all, 0, 0, 1, 0));
    return s;
  }
  s.push_back(scan(ncomp, all, 0, 0, 0, 0));
  for (int c = 0; c < ncomp; c++) {
    s.push_back(scan(1, &all[c], 1, 5, 0, 2));
    s.push_back(scan(1, &all[c], 6, 63, 0, 1));
    s.push_back(scan(1, &all[c], 1, 5, 2, 1));
  }
  return s;
}

void ycck(const char* in, const char* out) {
  jpeg_decompress_struct src;
  jpeg_compress_struct dst;
  jpeg_error_mgr jerr;
  src.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&src);
  FILE* fi = open_or_die(in, "rb");
  jpeg_stdio_src(&src, fi);
  jpeg_read_header(&src, TRUE);
  src.out_color_space = JCS_CMYK;
  jpeg_start_decompress(&src);
  const int w = src.output_width, h = src.output_height;
  std::vector<JSAMPLE> px(size_t(w) * h * 4);
  while (src.output_scanline < src.output_height) {
    JSAMPROW row = &px[size_t(src.output_scanline) * w * 4];
    jpeg_read_scanlines(&src, &row, 1);
  }
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  std::fclose(fi);

  dst.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&dst);
  FILE* fo = open_or_die(out, "wb");
  jpeg_stdio_dest(&dst, fo);
  dst.image_width = w;
  dst.image_height = h;
  dst.input_components = 4;
  dst.in_color_space = JCS_CMYK;
  jpeg_set_defaults(&dst);
  jpeg_set_colorspace(&dst, JCS_YCCK);
  jpeg_set_quality(&dst, 90, TRUE);
  jpeg_start_compress(&dst, TRUE);
  while (dst.next_scanline < dst.image_height) {
    JSAMPROW row = &px[size_t(dst.next_scanline) * w * 4];
    jpeg_write_scanlines(&dst, &row, 1);
  }
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  std::fclose(fo);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s IN OUT [options]\n", argv[0]);
    return 2;
  }
  bool progressive = false, arith = false, dac = false, to_ycck = false;
  int restart = 0;
  const char* kind = nullptr;
  for (int i = 3; i < argc; i++) {
    if (!std::strcmp(argv[i], "--progressive")) progressive = true;
    else if (!std::strcmp(argv[i], "--arith")) arith = true;
    else if (!std::strcmp(argv[i], "--dac")) dac = true;
    else if (!std::strcmp(argv[i], "--ycck")) to_ycck = true;
    else if (!std::strcmp(argv[i], "--restart") && i + 1 < argc)
      restart = std::atoi(argv[++i]);
    else if (!std::strcmp(argv[i], "--script") && i + 1 < argc)
      kind = argv[++i];
    else {
      std::fprintf(stderr, "unknown option %s\n", argv[i]);
      return 2;
    }
  }
  if (to_ycck) {
    ycck(argv[1], argv[2]);
    return 0;
  }

  jpeg_decompress_struct src;
  jpeg_compress_struct dst;
  jpeg_error_mgr jerr;
  src.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&src);
  FILE* fi = open_or_die(argv[1], "rb");
  jpeg_stdio_src(&src, fi);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr* coefs = jpeg_read_coefficients(&src);

  dst.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&dst);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.optimize_coding = FALSE;
  dst.arith_code = arith ? TRUE : FALSE;
  if (progressive) jpeg_simple_progression(&dst);
  std::vector<jpeg_scan_info> scans;
  if (kind) {
    scans = script(kind, dst.num_components);
    dst.scan_info = scans.data();
    dst.num_scans = int(scans.size());
  }
  if (dac) {
    dst.arith_dc_L[0] = 2;
    dst.arith_dc_U[0] = 6;
    dst.arith_dc_L[1] = 1;
    dst.arith_dc_U[1] = 3;
    dst.arith_ac_K[0] = 2;
    dst.arith_ac_K[1] = 11;
  }
  dst.restart_interval = restart;
  FILE* fo = open_or_die(argv[2], "wb");
  jpeg_stdio_dest(&dst, fo);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  std::fclose(fi);
  std::fclose(fo);
  return 0;
}
