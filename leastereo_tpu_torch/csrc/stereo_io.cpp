// Native host-side sample loader for the input pipeline.
//
// The training hosts have few cores (2 on the dev machine) and the reference
// pipeline spends its host budget in PIL decode + numpy standardization.
// This module decodes PNG (libpng) and PFM directly into the framework's
// 8-channel float stack (channels 0-2 left RGB standardized, 3-5 right RGB
// standardized, 6/7 disparities — see data/transforms.py) in
// one pass with no intermediate allocations, releasing the GIL entirely
// (called via ctypes).
//
// The port's copy of native/stereo_io.cpp. Built with g++ by data/native.py
// at first use into leastereo_tpu_torch/build/libstereo_io.so (a host
// library: ops/_build.py compiles only csrc/*.cu with nvcc).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <png.h>

extern "C" {

// ---------------------------------------------------------------- PNG ------

// Decode an 8-bit PNG into float RGB (H*W*3). Returns 0 on success; fills
// *height/*width. Gray images are replicated to 3 channels.
int read_png_rgb(const char* path, float* out, int* height, int* width,
                 int max_pixels) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return 2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);

  if ((int)(w * h) > max_pixels) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 4;
  }

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out + (size_t)y * w * 3;
    for (png_uint_32 x = 0; x < w * 3; ++x) dst[x] = (float)row[x];
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *height = (int)h;
  *width = (int)w;
  return 0;
}

// Read only the PNG header dimensions (cheap pre-probe so callers can
// allocate exactly).
int png_dims(const char* path, int* height, int* width) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *width = (int)png_get_image_width(png, info);
  *height = (int)png_get_image_height(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// ---------------------------------------------------------------- PFM ------

// Decode a grayscale PFM (top-down output rows). Returns 0 on success.
int read_pfm(const char* path, float* out, int* height, int* width,
             int max_pixels) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  char header[3] = {0};
  int w = 0, h = 0;
  float scale = 0.f;
  if (std::fscanf(fp, "%2s %d %d %f", header, &w, &h, &scale) != 4 ||
      std::strcmp(header, "Pf") != 0 || w <= 0 || h <= 0 ||
      w * h > max_pixels) {
    std::fclose(fp);
    return 2;
  }
  std::fgetc(fp);  // single whitespace before payload
  std::vector<float> buf((size_t)w * h);
  if (std::fread(buf.data(), 4, (size_t)w * h, fp) != (size_t)w * h) {
    std::fclose(fp);
    return 3;
  }
  std::fclose(fp);
  const bool big_endian = scale > 0;
  if (big_endian) {
    for (auto& v : buf) {
      uint32_t u;
      std::memcpy(&u, &v, 4);
      u = __builtin_bswap32(u);
      std::memcpy(&v, &u, 4);
    }
  }
  // PFM rows are bottom-up; flip.
  for (int y = 0; y < h; ++y)
    std::memcpy(out + (size_t)y * w, buf.data() + (size_t)(h - 1 - y) * w,
                (size_t)w * 4);
  *height = h;
  *width = w;
  return 0;
}

// ------------------------------------------------------- standardize -------

// Per-channel standardization of an RGB image into 3 planes of the stack.
static void standardize_into(const float* rgb, int h, int w, float* planes) {
  const size_t n = (size_t)h * w;
  for (int c = 0; c < 3; ++c) {
    double sum = 0, sq = 0;
    for (size_t i = 0; i < n; ++i) {
      const double v = rgb[i * 3 + c];
      sum += v;
      sq += v * v;
    }
    const double mean = sum / n;
    // Population std (matches numpy .std()), reference common.py:119-131.
    const double var = sq / n - mean * mean;
    const double inv = 1.0 / std::sqrt(var > 0 ? var : 1e-12);
    float* dst = planes + (size_t)c * n;
    for (size_t i = 0; i < n; ++i)
      dst[i] = (float)((rgb[i * 3 + c] - mean) * inv);
  }
}

// Full SceneFlow-style sample: decode both PNGs + both PFMs and assemble the
// (8, H, W) stack. Returns 0 on success; *height/*width describe the stack.
int load_stereo_sample(const char* left_png, const char* right_png,
                       const char* disp_left_pfm, const char* disp_right_pfm,
                       float* stack, int* height, int* width, int max_pixels) {
  int h = 0, w = 0, h2 = 0, w2 = 0;
  std::vector<float> rgb((size_t)max_pixels * 3);

  if (int rc = read_png_rgb(left_png, rgb.data(), &h, &w, max_pixels)) return rc;
  const size_t n = (size_t)h * w;
  standardize_into(rgb.data(), h, w, stack);

  if (int rc = read_png_rgb(right_png, rgb.data(), &h2, &w2, max_pixels)) return rc;
  if (h2 != h || w2 != w) return 10;
  standardize_into(rgb.data(), h, w, stack + 3 * n);

  if (int rc = read_pfm(disp_left_pfm, stack + 6 * n, &h2, &w2, max_pixels)) return rc;
  if (h2 != h || w2 != w) return 11;
  if (int rc = read_pfm(disp_right_pfm, stack + 7 * n, &h2, &w2, max_pixels)) return rc;
  if (h2 != h || w2 != w) return 12;

  *height = h;
  *width = w;
  return 0;
}

}  // extern "C"
