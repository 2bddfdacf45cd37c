// gltvae_torch native data loader: multithreaded JPEG decode + bilinear
// resize (a copy of the JAX package's native/loader.cpp; only this header
// comment differs, so the two packages decode to the same bytes).
//
// The reference decodes one image at a time with PIL on the training thread
// (its utils_data.py:48-63). This pool decodes a whole batch in parallel
// with libjpeg, outside the Python GIL, writing uint8 RGB directly into a
// caller-provided buffer (shipped to the device as uint8; normalization
// happens on the device).
//
// C ABI (ctypes-friendly):
//   gltvae_decode_batch(paths, n, out_size, do_center_crop, out,
//                       num_threads) -> 0 | -index-1
//   gltvae_version() -> int
//
// Build: gltvae_torch/data/native_loader.py runs g++ on first use
// (libjpeg + pthreads; no other deps).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <csetjmp>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to an RGB uint8 buffer. Returns true on success.
bool decode_jpeg(const char* path, std::vector<uint8_t>* rgb,
                 int* width, int* height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // force RGB (handles grayscale/YCbCr)
  jpeg_start_decompress(&cinfo);

  *width = static_cast<int>(cinfo.output_width);
  *height = static_cast<int>(cinfo.output_height);
  const int stride = *width * 3;
  rgb->resize(static_cast<size_t>(stride) * *height);

  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb->data() +
        static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Bilinear resize (RGB uint8), full-image (no crop — reference semantics:
// utils_data.py:57 resizes 178x218 straight to 64x64, aspect-distorting).
void resize_bilinear(const uint8_t* src, int sw, int sh,
                     uint8_t* dst, int dw, int dh) {
  const float sx = static_cast<float>(sw) / dw;
  const float sy = static_cast<float>(sh) / dh;
  for (int y = 0; y < dh; ++y) {
    // pixel-center mapping, matching cv2.INTER_LINEAR
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = fx - x0;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[(y0 * sw + x0) * 3 + c];
        const float v01 = src[(y0 * sw + x1) * 3 + c];
        const float v10 = src[(y1 * sw + x0) * 3 + c];
        const float v11 = src[(y1 * sw + x1) * 3 + c];
        const float top = v00 + (v01 - v00) * wx;
        const float bot = v10 + (v11 - v10) * wx;
        const float v = top + (bot - top) * wy + 0.5f;
        dst[(y * dw + x) * 3 + c] = static_cast<uint8_t>(
            v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
}

// Optional center-crop to square before resize (128px config).
void center_crop_square(const std::vector<uint8_t>& src, int sw, int sh,
                        std::vector<uint8_t>* dst, int* out_w, int* out_h) {
  const int s = sw < sh ? sw : sh;
  const int left = (sw - s) / 2, top = (sh - s) / 2;
  dst->resize(static_cast<size_t>(s) * s * 3);
  for (int y = 0; y < s; ++y) {
    std::memcpy(dst->data() + static_cast<size_t>(y) * s * 3,
                src.data() + (static_cast<size_t>(y + top) * sw + left) * 3,
                static_cast<size_t>(s) * 3);
  }
  *out_w = s;
  *out_h = s;
}

}  // namespace

extern "C" {

int gltvae_version() { return 1; }

// Decode n JPEGs in parallel, resize each to out_size x out_size RGB,
// write into out[n][out_size][out_size][3]. Returns 0 on success, or
// -(failed_index+1) for the first decode failure.
int gltvae_decode_batch(const char** paths, int n, int out_size,
                        int do_center_crop, uint8_t* out, int num_threads) {
  if (n <= 0) return 0;
  if (num_threads <= 0) num_threads = 1;
  if (num_threads > n) num_threads = n;

  std::atomic<int> next(0);
  std::atomic<int> failed(0);  // 0 = ok, else index+1

  auto work = [&]() {
    std::vector<uint8_t> rgb, cropped;
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n || failed.load() != 0) break;
      int w = 0, h = 0;
      if (!decode_jpeg(paths[i], &rgb, &w, &h)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        break;
      }
      const uint8_t* src = rgb.data();
      if (do_center_crop) {
        center_crop_square(rgb, w, h, &cropped, &w, &h);
        src = cropped.data();
      }
      resize_bilinear(src, w, h,
                      out + static_cast<size_t>(i) * out_size * out_size * 3,
                      out_size, out_size);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(work);
  for (auto& t : threads) t.join();
  return failed.load() == 0 ? 0 : -failed.load();
}

}  // extern "C"
