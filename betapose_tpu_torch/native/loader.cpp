// Native host-side frame loader: multi-threaded PNG/JPEG decode into a
// bounded ring buffer, delivered to the consumer in order as packed
// [B,H,W,3] uint8 batches.
//
// A copy of the JAX package's native loader (`betapose_tpu/native/`), the
// replacement for the reference's C loader stack
// (`2_train_YOLO/train_yolo3/darknet/src/data.c:load_threads` — pthread
// fan-out over image decode — and the Python side's 4-process queue
// pipeline, `3_6Dpose_estimator/dataloader.py:90-763`).  Design differs
// deliberately: the reference's check-then-put queue races and stop-flag
// polling are replaced by a single ordered ring with two condition
// variables (slot-free / slot-ready), so delivery order is deterministic
// regardless of worker scheduling, and the consumer-facing API is one
// memcpy-per-frame `next_batch` call that Python invokes once per batch
// (no per-frame Python/GIL work on the feed path).
//
// Exposed C ABI (ctypes, see loader.py):
//   bp_imread_rgb(path, out, capacity, &h, &w)  one-shot decode / probe
//   bp_loader_create(paths, n, h, w, workers, window)
//   bp_loader_next(L, out, batch)               -> real frame count
//   bp_loader_error(L, buf, cap)                -> last error message
//   bp_loader_destroy(L)
//
// Error contract: a frame that fails to decode (missing file, corrupt
// stream, dimension mismatch) poisons the loader; bp_loader_next returns
// BP_ERR_DECODE and bp_loader_error reports the path, so the Python
// wrapper can raise instead of silently feeding garbage pixels.

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr int BP_OK = 0;
constexpr int BP_ERR_OPEN = -1;     // missing/unreadable file
constexpr int BP_ERR_FORMAT = -2;   // not a PNG/JPEG magic
constexpr int BP_ERR_DECODE = -3;   // codec failure mid-stream
constexpr int BP_ERR_SIZE = -4;     // buffer too small / dims mismatch

// ---------------------------------------------------------------- PNG ----
// libpng's "simplified API": one struct, no longjmp in caller code, and
// format conversion (palette/gray/alpha -> RGB8) handled inside libpng.
int decode_png(const char* path, uint8_t* out, int64_t capacity,
               int* h, int* w) {
  png_image image;
  std::memset(&image, 0, sizeof(image));
  image.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_file(&image, path)) {
    png_image_free(&image);
    return BP_ERR_DECODE;
  }
  image.format = PNG_FORMAT_RGB;
  *h = static_cast<int>(image.height);
  *w = static_cast<int>(image.width);
  if (out == nullptr) {  // probe-only call
    png_image_free(&image);
    return BP_OK;
  }
  const int64_t need = static_cast<int64_t>(PNG_IMAGE_SIZE(image));
  if (need > capacity) {
    png_image_free(&image);
    return BP_ERR_SIZE;
  }
  if (!png_image_finish_read(&image, /*background=*/nullptr, out,
                             /*row_stride=*/0, /*colormap=*/nullptr)) {
    png_image_free(&image);
    return BP_ERR_DECODE;
  }
  return BP_OK;
}

// --------------------------------------------------------------- JPEG ----
// libjpeg's error handler aborts the process by default; route it through
// setjmp so a corrupt stream surfaces as a return code instead.
struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf env;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  std::longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->env, 1);
}

int decode_jpeg(FILE* f, uint8_t* out, int64_t capacity, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.env)) {
    jpeg_destroy_decompress(&cinfo);
    return BP_ERR_DECODE;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;  // gray/YCbCr -> RGB inside libjpeg
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  if (out == nullptr) {  // probe-only call
    jpeg_destroy_decompress(&cinfo);
    return BP_OK;
  }
  jpeg_start_decompress(&cinfo);
  const int64_t stride =
      static_cast<int64_t>(cinfo.output_width) * cinfo.output_components;
  if (stride * cinfo.output_height > capacity ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return BP_ERR_SIZE;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return BP_OK;
}

// Decode dispatch on magic bytes (PNG \x89PNG, JPEG \xff\xd8).
int imread_rgb(const char* path, uint8_t* out, int64_t capacity,
               int* h, int* w) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return BP_ERR_OPEN;
  unsigned char magic[2] = {0, 0};
  const size_t got = std::fread(magic, 1, 2, f);
  int rc;
  if (got == 2 && magic[0] == 0x89 && magic[1] == 'P') {
    std::fclose(f);  // libpng's simplified reader reopens by path
    rc = decode_png(path, out, capacity, h, w);
  } else if (got == 2 && magic[0] == 0xff && magic[1] == 0xd8) {
    std::rewind(f);
    rc = decode_jpeg(f, out, capacity, h, w);
    std::fclose(f);
  } else {
    std::fclose(f);
    rc = BP_ERR_FORMAT;
  }
  return rc;
}

// -------------------------------------------------------------- loader ----
struct Loader {
  std::vector<std::string> paths;
  int h = 0, w = 0;
  int64_t frame_bytes = 0;
  int window = 0;                  // ring capacity in frames
  std::vector<uint8_t> ring;       // window * frame_bytes
  std::vector<int> state;          // 0 empty, 1 ready
  size_t claimed = 0;              // next index a worker will decode
  size_t consumed = 0;             // next index the consumer will take
  bool failed = false;
  std::string error;
  std::mutex m;
  std::condition_variable slot_free;   // consumer freed a slot
  std::condition_variable slot_ready;  // worker filled a slot
  std::vector<std::thread> threads;
  bool stopping = false;

  void worker() {
    std::unique_lock<std::mutex> lk(m);
    while (true) {
      if (stopping || failed || claimed >= paths.size()) return;
      const size_t i = claimed++;
      // Wait for slot i%window to be recycled: its previous tenant is
      // frame i-window, which must have been consumed already.
      slot_free.wait(lk, [&] {
        return stopping || failed || consumed + window > i;
      });
      if (stopping || failed) return;
      uint8_t* dst = ring.data() + (i % window) * frame_bytes;
      const std::string& path = paths[i];
      lk.unlock();
      int fh = 0, fw = 0;
      int rc = imread_rgb(path.c_str(), dst, frame_bytes, &fh, &fw);
      if (rc == BP_OK && (fh != h || fw != w)) rc = BP_ERR_SIZE;
      lk.lock();
      if (rc != BP_OK) {
        if (!failed) {
          failed = true;
          error = "decode failed (rc=" + std::to_string(rc) + "): " + path;
        }
        slot_ready.notify_all();
        slot_free.notify_all();
        return;
      }
      state[i % window] = 1;
      slot_ready.notify_all();
    }
  }

  // Copy up to `batch` frames into out; pad the tail by repeating the
  // last real frame (PrefetchLoader contract). Returns real frame count,
  // 0 when exhausted, BP_ERR_DECODE after a worker failure.
  int next(uint8_t* out, int batch) {
    std::unique_lock<std::mutex> lk(m);
    int real = 0;
    for (int j = 0; j < batch && consumed < paths.size(); ++j) {
      const size_t i = consumed;
      slot_ready.wait(lk, [&] { return failed || state[i % window] == 1; });
      if (failed) return BP_ERR_DECODE;
      std::memcpy(out + static_cast<int64_t>(j) * frame_bytes,
                  ring.data() + (i % window) * frame_bytes, frame_bytes);
      state[i % window] = 0;
      ++consumed;
      ++real;
      slot_free.notify_all();
    }
    for (int j = real; j > 0 && j < batch; ++j)  // pad tail batch
      std::memcpy(out + static_cast<int64_t>(j) * frame_bytes,
                  out + static_cast<int64_t>(real - 1) * frame_bytes,
                  frame_bytes);
    return real;
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(m);
      stopping = true;
    }
    slot_free.notify_all();
    slot_ready.notify_all();
    for (auto& t : threads) t.join();
  }
};

}  // namespace

extern "C" {

int bp_imread_rgb(const char* path, uint8_t* out, int64_t capacity,
                  int* h, int* w) {
  return imread_rgb(path, out, capacity, h, w);
}

void* bp_loader_create(const char** paths, int n, int h, int w,
                       int workers, int window) {
  if (n <= 0 || h <= 0 || w <= 0) return nullptr;
  auto* L = new Loader();
  L->paths.reserve(n);
  for (int i = 0; i < n; ++i) L->paths.emplace_back(paths[i]);
  L->h = h;
  L->w = w;
  L->frame_bytes = static_cast<int64_t>(h) * w * 3;
  L->window = std::max(2, window);
  L->ring.resize(L->window * L->frame_bytes);
  L->state.assign(L->window, 0);
  const int nthreads = std::max(1, workers);
  L->threads.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t)
    L->threads.emplace_back([L] { L->worker(); });
  return L;
}

int bp_loader_next(void* handle, uint8_t* out, int batch) {
  return static_cast<Loader*>(handle)->next(out, batch);
}

int bp_loader_error(void* handle, char* buf, int cap) {
  auto* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(L->m);
  const int n = static_cast<int>(L->error.size());
  if (buf != nullptr && cap > 0) {
    const int c = std::min(cap - 1, n);
    std::memcpy(buf, L->error.data(), c);
    buf[c] = '\0';
  }
  return n;
}

void bp_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
