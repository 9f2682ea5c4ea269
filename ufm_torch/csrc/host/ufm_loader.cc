// ufm_torch image loader: multithreaded image decode off the GIL.
//
// The port's own copy of the JAX package's native/ufm_loader.cc, built by
// ufm_torch/ops/_build.py with the host C++ compiler into build/ufm_torch/
// at first use. Two changes: the decoders are the port's own
// (image_decode.h: PNG and JPEG bit for bit what the original's libpng and
// libjpeg give, with no system image library), and ufm_loader_shutdown,
// which wakes every thread waiting in ufm_loader_poll (it then returns -1),
// so that the owner can wait for them to leave before ufm_loader_destroy
// frees the loader (the original destroyed it under a waiting poller).
//
// Host-side image decoding is the serial bottleneck of a streaming
// correspondence pipeline (the reference decodes with cv2 on the Python
// thread, one image at a time — reference cli.py:97-106). This loader runs
// the decoders on a pthread pool entirely off the GIL and hands
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
//   ufm_image_decode(data, len, &h, &w, out, err, err_len, from_file)
//       one JPEG as cv2.imdecode(IMREAD_COLOR) gives it (from_file: as
//       cv2.imread gives the file holding these bytes), in RGB order (EXIF
//       orientation applied, CMYK converted): with out == NULL it sets the
//       size only, else it writes h * w * 3 bytes. 0 ok / -1 refused (the
//       reason in err).
//   ufm_image_decode_stages(data, len, seconds)
//       one JPEG decoded as the loader decodes it; seconds[0..2] receive the
//       seconds of its stages (headers and entropy decoding, the IDCT with
//       any block smoothing, upsampling and colour conversion). 0 ok / -1.

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <vector>

#include "image_decode.h"

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

// The file at ``path`` decoded as the original loader's libjpeg (JCS_RGB) /
// libpng calls decode it; false for any other file or a refused one.
bool decode_file(const std::string& path, std::vector<uint8_t>* out, int* w, int* h) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  std::vector<uint8_t> data;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = fread(chunk, 1, sizeof chunk, f)) > 0) data.insert(data.end(), chunk, chunk + got);
  fclose(f);
  static constexpr uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  ufm_image::Image img;
  std::string err;
  try {
    if (data.size() >= 3 && data[0] == 0xFF && data[1] == 0xD8) {
      err = ufm_image::decode_jpeg(data.data(), data.size(), ufm_image::JpegTarget::kRgb, &img);
    } else if (data.size() >= 8 && std::memcmp(data.data(), kPngSig, 8) == 0) {
      err = ufm_image::decode_png(data.data(), data.size(), &img);
    } else {
      return false;
    }
  } catch (const std::bad_alloc&) {  // a header asking for more memory than there is
    return false;
  }
  if (!err.empty()) return false;
  *w = img.width;
  *h = img.height;
  *out = std::move(img.rgb);
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

    std::vector<uint8_t> raw;
    int w = 0, h = 0;
    if (decode_file(job.second, &raw, &w, &h)) {
      if (w == L->out_w && h == L->out_h) {
        frame.rgb = std::move(raw);
      } else {
        resize_bilinear(raw, w, h, &frame.rgb, L->out_w, L->out_h);
      }
      frame.ok = true;
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

int ufm_image_decode(const uint8_t* data, size_t len, int* h, int* w, uint8_t* out, char* err, int err_len,
                     int from_file) {
  const ufm_image::JpegTarget target = from_file ? ufm_image::JpegTarget::kOpenCvFile : ufm_image::JpegTarget::kOpenCv;
  std::string why;
  try {
    if (!out) {
      why = ufm_image::jpeg_size(data, len, target, w, h);
    } else {
      ufm_image::Image img;
      why = ufm_image::decode_jpeg(data, len, target, &img);
      if (why.empty() && (img.width != *w || img.height != *h)) why = "decoded size differs from the header's";
      if (why.empty()) std::memcpy(out, img.rgb.data(), img.rgb.size());
    }
  } catch (const std::bad_alloc&) {
    why = "image too large to decode in memory";
  }
  if (why.empty()) return 0;
  if (err && err_len > 0) {
    std::strncpy(err, why.c_str(), (size_t)err_len - 1);
    err[err_len - 1] = 0;
  }
  return -1;
}

int ufm_image_decode_stages(const uint8_t* data, size_t len, double* seconds) {
  ufm_image::jpeg_detail::Decoder dec(data, len, ufm_image::JpegTarget::kRgb);
  ufm_image::Image img;
  try {
    if (!dec.decode(&img).empty()) return -1;
  } catch (const std::bad_alloc&) {
    return -1;
  }
  for (int i = 0; i < 3; i++) seconds[i] = dec.stage_seconds()[i];
  return 0;
}

}  // extern "C"
