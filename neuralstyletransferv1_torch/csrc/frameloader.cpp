// frameloader.cpp — threaded JPEG/PNG frame decoder with in-order delivery.
//
// The port's host frame loader: worker threads decode the frame files of
// the batched video path (libjpeg / libpng, outside the GIL) while the card
// stylizes, and hand them to Python strictly in path order. The port's own
// copy of the JAX package's loader source, decoding the same way.
//
// C ABI (consumed via ctypes from
// neuralstyletransferv1_torch/io/native_loader.py):
//   void* fl_open(const char** paths, int n, int threads, int capacity);
//   int   fl_next_info(void* h, int* hh, int* ww);   // blocks; <0 = end/err
//   int   fl_next_copy(void* h, unsigned char* out); // copy RGB, advance
//   void  fl_close(void* h);
//
// Frames are delivered strictly in path order. A bounded ring (capacity
// slots) limits prefetch memory. Decoders: libjpeg (any JFIF/EXIF baseline
// or progressive; EXIF orientation is not applied) and libpng (palette,
// grey, 16-bit and alpha normalized to RGB8).
//
// Build (io/native_loader.py does it on first use, into _build/):
//   g++ -O3 -shared -fPIC frameloader.cpp -ljpeg -lpng -o libframeloader.so

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Frame {
  std::vector<unsigned char> rgb;
  int h = 0, w = 0;
  bool ok = false;
};

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, RGB output)
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(const unsigned char* buf, size_t len, Frame* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out->ok = true;
  return true;
}

// ---------------------------------------------------------------------------
// PNG decode (libpng, normalized to RGB8)
// ---------------------------------------------------------------------------

struct PngReadState {
  const unsigned char* data;
  size_t len;
  size_t pos;
};

void png_read_fn(png_structp png, png_bytep out, png_size_t n) {
  PngReadState* s = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (s->pos + n > s->len) {
    png_error(png, "png: truncated");
  }
  std::memcpy(out, s->data + s->pos, n);
  s->pos += n;
}

bool decode_png(const unsigned char* buf, size_t len, Frame* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
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
  PngReadState state{buf, len, 0};
  png_set_read_fn(png, &state, png_read_fn);
  png_read_info(png, info);

  png_set_expand(png);          // palette/low-bit-depth/tRNS → 8-bit
  png_set_strip_16(png);        // 16-bit → 8-bit
  png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);     // frames are opaque; drop alpha
  png_read_update_info(png, info);

  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->rgb.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y) {
    rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
  }
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  out->ok = true;
  return true;
}

bool decode_file(const std::string& path, Frame* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<unsigned char> buf(len > 0 ? size_t(len) : 0);
  size_t got = buf.empty() ? 0 : std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  if (got < 8) return false;
  if (buf[0] == 0xFF && buf[1] == 0xD8) return decode_jpeg(buf.data(), got, out);
  if (buf[0] == 0x89 && buf[1] == 'P') return decode_png(buf.data(), got, out);
  return false;
}

// ---------------------------------------------------------------------------
// Loader: workers claim indices, decode, publish into a bounded ring
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  int capacity;
  std::vector<Frame> slots;        // index i lives in slots[i % capacity]
  std::vector<int> slot_seq;       // which frame index a slot currently holds
  std::mutex m;
  std::condition_variable cv_ready, cv_free;
  std::atomic<int> next_claim{0};
  int consumed = 0;                // frames handed to the consumer
  bool closing = false;
  std::vector<std::thread> workers;

  void worker() {
    for (;;) {
      int i = next_claim.fetch_add(1);
      if (i >= static_cast<int>(paths.size())) return;
      {
        std::unique_lock<std::mutex> lk(m);
        cv_free.wait(lk, [&] { return closing || i < consumed + capacity; });
        if (closing) return;
      }
      Frame fr;
      decode_file(paths[i], &fr);  // fr.ok=false on failure; still published
      {
        std::lock_guard<std::mutex> lk(m);
        slots[i % capacity] = std::move(fr);
        slot_seq[i % capacity] = i;
      }
      cv_ready.notify_all();
    }
  }
};

Frame* wait_current(Loader* L) {
  std::unique_lock<std::mutex> lk(L->m);
  int i = L->consumed;
  if (i >= static_cast<int>(L->paths.size())) return nullptr;
  L->cv_ready.wait(lk, [&] { return L->slot_seq[i % L->capacity] == i; });
  return &L->slots[i % L->capacity];
}

}  // namespace

extern "C" {

void* fl_open(const char** paths, int n, int threads, int capacity) {
  Loader* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->capacity = capacity > 0 ? capacity : 8;
  L->slots.resize(L->capacity);
  L->slot_seq.assign(L->capacity, -1);
  int nw = threads > 0 ? threads : 2;
  for (int t = 0; t < nw; ++t) {
    L->workers.emplace_back(&Loader::worker, L);
  }
  return L;
}

// Block until the next in-order frame is decoded; report its dims.
// Returns the frame index, or -1 past the end, or -2 on decode failure
// (the failed frame is skipped by fl_next_copy(NULL)).
int fl_next_info(void* h, int* hh, int* ww) {
  Loader* L = static_cast<Loader*>(h);
  Frame* fr = wait_current(L);
  if (!fr) return -1;
  if (!fr->ok) return -2;
  *hh = fr->h;
  *ww = fr->w;
  return L->consumed;
}

// Copy the current frame's RGB into out (may be NULL to skip) and advance.
int fl_next_copy(void* h, unsigned char* out) {
  Loader* L = static_cast<Loader*>(h);
  Frame* fr = wait_current(L);
  if (!fr) return -1;
  if (out && fr->ok) {
    std::memcpy(out, fr->rgb.data(), fr->rgb.size());
  }
  {
    std::lock_guard<std::mutex> lk(L->m);
    fr->rgb.clear();
    fr->rgb.shrink_to_fit();
    L->consumed += 1;
  }
  L->cv_free.notify_all();
  return 0;
}

void fl_close(void* h) {
  Loader* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->m);
    L->closing = true;
    L->consumed = static_cast<int>(L->paths.size()) + L->capacity;
  }
  L->cv_free.notify_all();
  L->next_claim.store(static_cast<int>(L->paths.size()));
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
