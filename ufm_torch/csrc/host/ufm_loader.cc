// ufm_torch image loader: multithreaded image decode off the GIL.
//
// The port's own copy of the JAX package's native/ufm_loader.cc, built by
// ufm_torch/ops/_build.py with the host C++ compiler (-ljpeg -lpng) into
// build/ufm_torch/ at first use. One change: ufm_loader_shutdown, which
// wakes every thread waiting in ufm_loader_poll (it then returns -1), so
// that the owner can wait for them to leave before ufm_loader_destroy frees
// the loader (the original destroyed it under a waiting poller).
//
// Host-side image decoding is the serial bottleneck of a streaming
// correspondence pipeline (the reference decodes with cv2 on the Python
// thread, one image at a time — reference cli.py:97-106). This loader runs
// libjpeg/libpng decoding on a pthread pool entirely off the GIL and hands
// fixed-size RGB8 frames back through a completion queue; frames whose
// native size differs from the requested size are bilinearly resized in C.
//
// C API (ctypes-friendly):
//   ufm_loader_create(threads, out_h, out_w) -> handle
//   ufm_loader_submit(handle, id, path)      -> 0/-1
//   ufm_loader_poll(handle, &id, buf, timeout_us) -> 1 ok / 0 timeout /
//                                                    -2 decode error (id set) /
//                                                    -1 shut down
//   ufm_loader_shutdown(handle)              wakes pollers; submits fail
//   ufm_loader_destroy(handle)               shuts down, joins, frees

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <chrono>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  uint64_t id;
  bool ok;
  std::vector<uint8_t> rgb;  // out_h * out_w * 3
};

struct Loader {
  int out_h, out_w;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::deque<std::pair<uint64_t, std::string>> jobs;
  std::deque<Frame> done;
  bool shutdown = false;
  std::vector<std::thread> workers;
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf env;
};

void jpeg_error_jump(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->env, 1);
}

bool decode_jpeg(FILE* f, std::vector<uint8_t>* out, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_error_jump;
  if (setjmp(err.env)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize((size_t)*w * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + (size_t)cinfo.output_scanline * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, std::vector<uint8_t>* out, int* w, int* h) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY ||
      png_get_color_type(png, info) == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_read_update_info(png, info);
  *w = png_get_image_width(png, info);
  *h = png_get_image_height(png, info);
  out->resize((size_t)*w * *h * 3);
  std::vector<png_bytep> rows(*h);
  for (int y = 0; y < *h; y++) rows[y] = out->data() + (size_t)y * *w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

void resize_bilinear(const std::vector<uint8_t>& src, int sw, int sh,
                     std::vector<uint8_t>* dst, int dw, int dh) {
  dst->resize((size_t)dw * dh * 3);
  const float sx = (float)sw / dw, sy = (float)sh / dh;
  for (int y = 0; y < dh; y++) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : (int)fy;
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float ty = fy - y0;
    if (ty < 0) ty = 0;
    for (int x = 0; x < dw; x++) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : (int)fx;
      int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float tx = fx - x0;
      if (tx < 0) tx = 0;
      for (int c = 0; c < 3; c++) {
        float a = src[((size_t)y0 * sw + x0) * 3 + c] * (1 - tx) +
                  src[((size_t)y0 * sw + x1) * 3 + c] * tx;
        float b = src[((size_t)y1 * sw + x0) * 3 + c] * (1 - tx) +
                  src[((size_t)y1 * sw + x1) * 3 + c] * tx;
        (*dst)[((size_t)y * dw + x) * 3 + c] = (uint8_t)(a * (1 - ty) + b * ty + 0.5f);
      }
    }
  }
}

void worker(Loader* L) {
  while (true) {
    std::pair<uint64_t, std::string> job;
    {
      std::unique_lock<std::mutex> lock(L->mu);
      L->cv_work.wait(lock, [L] { return L->shutdown || !L->jobs.empty(); });
      if (L->shutdown && L->jobs.empty()) return;
      job = L->jobs.front();
      L->jobs.pop_front();
    }

    Frame frame;
    frame.id = job.first;
    frame.ok = false;

    FILE* f = fopen(job.second.c_str(), "rb");
    if (f) {
      uint8_t magic[8] = {0};
      size_t got = fread(magic, 1, 8, f);
      rewind(f);
      std::vector<uint8_t> raw;
      int w = 0, h = 0;
      bool ok = false;
      if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
        ok = decode_jpeg(f, &raw, &w, &h);
      } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
        ok = decode_png(f, &raw, &w, &h);
      }
      fclose(f);
      if (ok) {
        if (w == L->out_w && h == L->out_h) {
          frame.rgb = std::move(raw);
        } else {
          resize_bilinear(raw, w, h, &frame.rgb, L->out_w, L->out_h);
        }
        frame.ok = true;
      }
    }

    {
      std::lock_guard<std::mutex> lock(L->mu);
      L->done.push_back(std::move(frame));
    }
    L->cv_done.notify_one();
  }
}

}  // namespace

extern "C" {

void* ufm_loader_create(int num_threads, int out_h, int out_w) {
  if (num_threads <= 0 || out_h <= 0 || out_w <= 0) return nullptr;
  auto* L = new Loader();
  L->out_h = out_h;
  L->out_w = out_w;
  for (int i = 0; i < num_threads; i++) L->workers.emplace_back(worker, L);
  return L;
}

int ufm_loader_submit(void* handle, uint64_t id, const char* path) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(L->mu);
    if (L->shutdown) return -1;
    L->jobs.emplace_back(id, std::string(path));
  }
  L->cv_work.notify_one();
  return 0;
}

int ufm_loader_poll(void* handle, uint64_t* id_out, uint8_t* buf, int64_t timeout_us) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(L->mu);
  auto deadline = std::chrono::steady_clock::now() + std::chrono::microseconds(timeout_us);
  while (L->done.empty()) {
    if (L->shutdown) return -1;
    if (L->cv_done.wait_until(lock, deadline) == std::cv_status::timeout) return 0;
  }
  Frame frame = std::move(L->done.front());
  L->done.pop_front();
  lock.unlock();
  *id_out = frame.id;
  if (!frame.ok) return -2;
  std::memcpy(buf, frame.rgb.data(), frame.rgb.size());
  return 1;
}

// Wakes every waiter: later submits return -1, and a poll with no decoded
// frame left returns -1. The caller waits for the threads that may still be
// inside the loader before it calls ufm_loader_destroy.
void ufm_loader_shutdown(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(L->mu);
    L->shutdown = true;
  }
  L->cv_work.notify_all();
  L->cv_done.notify_all();
}

void ufm_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  ufm_loader_shutdown(handle);
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
