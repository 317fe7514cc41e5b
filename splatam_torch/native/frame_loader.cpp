// Native RGB-D frame decoding + resize for the port's data path
// (splatam_torch/data), a copy of the JAX package's decoder.
//
// The reference's host data path is Python (imageio + cv2 per frame,
// `datasets/gradslam_datasets/basedataset.py:296-341`); at SLAM frame rates
// the decode+resize dominates host time once the device work is async. This
// library decodes JPEG color / 16-bit PNG depth / 8-bit PNG color straight
// into float32 arrays with OpenCV's resize conventions (INTER_LINEAR for
// color: src = (dst + 0.5) * scale - 0.5; INTER_NEAREST for depth:
// src = floor(dst * scale)); data/base.py's numpy resize is the same
// arithmetic. ctypes releases the GIL around every call, so a Python thread
// decodes beside the device work.
//
// Build (splatam_torch/native/__init__.py does it on first use, into
// build/native/): g++ -O3 -shared -fPIC frame_loader.cpp -o libframeloader.so -ljpeg -lpng -lz

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Bilinear resize (C channels, uint8 or uint16 source) to float32.
template <typename T>
void resize_bilinear(const T* src, int sh, int sw, int c, float* dst, int dh,
                     int dw) {
  const double sx = static_cast<double>(sw) / dw;
  const double sy = static_cast<double>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    int y0 = static_cast<int>(std::floor(fy));
    double wy = fy - y0;
    int y1 = std::min(y0 + 1, sh - 1);
    y0 = std::max(y0, 0);
    for (int x = 0; x < dw; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      int x0 = static_cast<int>(std::floor(fx));
      double wx = fx - x0;
      int x1 = std::min(x0 + 1, sw - 1);
      x0 = std::max(x0, 0);
      for (int k = 0; k < c; ++k) {
        double v00 = src[(y0 * sw + x0) * c + k];
        double v01 = src[(y0 * sw + x1) * c + k];
        double v10 = src[(y1 * sw + x0) * c + k];
        double v11 = src[(y1 * sw + x1) * c + k];
        dst[(y * dw + x) * c + k] = static_cast<float>(
            v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
            v10 * wy * (1 - wx) + v11 * wy * wx);
      }
    }
  }
}

template <typename T>
void resize_nearest(const T* src, int sh, int sw, int c, float* dst, int dh,
                    int dw) {
  const double sx = static_cast<double>(sw) / dw;
  const double sy = static_cast<double>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    int ys = std::min(static_cast<int>(std::floor(y * sy)), sh - 1);
    for (int x = 0; x < dw; ++x) {
      int xs = std::min(static_cast<int>(std::floor(x * sx)), sw - 1);
      for (int k = 0; k < c; ++k) {
        dst[(y * dw + x) * c + k] =
            static_cast<float>(src[(ys * sw + xs) * c + k]);
      }
    }
  }
}

struct PngMemReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngMemReader* r = static_cast<PngMemReader*>(png_get_io_ptr(png));
  if (r->pos + n > r->size) {
    png_error(png, "read past end");
  }
  std::memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

// Decode a PNG from memory. Returns 0 on success, fills (rows, sh, sw,
// channels, bit_depth).
int decode_png_mem(const uint8_t* data, size_t size,
                   std::vector<uint8_t>& buf, int& sh, int& sw, int& ch,
                   int& bit_depth) {
  if (size < 8 || png_sig_cmp(data, 0, 8)) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return 2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return 2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 3;
  }
  PngMemReader reader{data, size, 0};
  png_set_read_fn(png, &reader, png_mem_read);
  png_read_info(png, info);

  sw = png_get_image_width(png, info);
  sh = png_get_image_height(png, info);
  bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (bit_depth == 16) png_set_swap(png);  // host little-endian
  png_read_update_info(png, info);

  ch = png_get_channels(png, info);
  size_t rowbytes = png_get_rowbytes(png, info);
  buf.resize(rowbytes * sh);
  std::vector<png_bytep> rows(sh);
  for (int y = 0; y < sh; ++y) rows[y] = buf.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

}  // namespace

extern "C" {

// JPEG -> float32 RGB (dh, dw, 3), bilinear. Returns 0 on success.
int decode_jpeg_rgb_f32(const uint8_t* data, size_t size, int dh, int dw,
                        float* out) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int sw = cinfo.output_width, sh = cinfo.output_height;
  std::vector<uint8_t> buf(static_cast<size_t>(sw) * sh * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  resize_bilinear(buf.data(), sh, sw, 3, out, dh, dw);
  return 0;
}

// PNG (8-bit RGB/gray or 16-bit gray) -> float32.
// mode 0 = bilinear (color), 1 = nearest (depth). channels_out must match
// the file (3 for RGB, 1 for gray). Returns 0 on success.
int decode_png_f32(const uint8_t* data, size_t size, int dh, int dw,
                   int channels_out, int mode, float* out) {
  std::vector<uint8_t> buf;
  int sh, sw, ch, bit_depth;
  int rc = decode_png_mem(data, size, buf, sh, sw, ch, bit_depth);
  if (rc != 0) return rc;
  if (ch != channels_out) return 10;
  if (bit_depth == 16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(buf.data());
    if (mode == 1) {
      resize_nearest(p, sh, sw, ch, out, dh, dw);
    } else {
      resize_bilinear(p, sh, sw, ch, out, dh, dw);
    }
  } else {
    if (mode == 1) {
      resize_nearest(buf.data(), sh, sw, ch, out, dh, dw);
    } else {
      resize_bilinear(buf.data(), sh, sw, ch, out, dh, dw);
    }
  }
  return 0;
}

// Query PNG header (sh, sw, channels, bit_depth) without a full decode.
int png_info_probe(const uint8_t* data, size_t size, int* sh, int* sw,
                   int* ch, int* bit_depth) {
  std::vector<uint8_t> buf;
  return decode_png_mem(data, size, buf, *sh, *sw, *ch, *bit_depth);
}

}  // extern "C"
