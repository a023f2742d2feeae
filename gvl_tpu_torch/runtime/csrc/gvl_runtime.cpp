// gvl_runtime: the port's native host runtime (a copy of the JAX
// package's gvl_tpu/runtime/csrc/gvl_runtime.cpp, bound by
// gvl_tpu_torch/runtime/native.py and built there at first use).
//
// A streaming YUV4MPEG2 decoder with fixed-point BT.601 -> RGB
// conversion, a PCM WAV reader, a producer/consumer prefetch ring that
// overlaps decode with the consumer's work, and uint8 image / mask
// resizes.  The arithmetic is the JAX package's, so every function gives
// its bytes; gvl_tpu_torch/runtime/{y4m,wav,resize}.py are the plain
// numpy versions the tests hold it to.
//
// C ABI throughout (consumed via ctypes).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// --------------------------------------------------------------------- y4m

struct Y4MHandle {
  FILE* file = nullptr;
  int width = 0;
  int height = 0;
  double fps = 30.0;
  int chroma = 420;  // 420 | 422 | 444
  long frame_bytes = 0;
  std::vector<uint8_t> buf;
};

static bool parse_y4m_header(Y4MHandle* h) {
  char line[1024];
  if (!fgets(line, sizeof(line), h->file)) return false;
  if (strncmp(line, "YUV4MPEG2", 9) != 0) return false;
  int num = 30, den = 1;
  for (char* tok = strtok(line + 9, " \n"); tok; tok = strtok(nullptr, " \n")) {
    switch (tok[0]) {
      case 'W': h->width = atoi(tok + 1); break;
      case 'H': h->height = atoi(tok + 1); break;
      case 'F': sscanf(tok + 1, "%d:%d", &num, &den); break;
      case 'C':
        if (strncmp(tok + 1, "444", 3) == 0) h->chroma = 444;
        else if (strncmp(tok + 1, "422", 3) == 0) h->chroma = 422;
        else h->chroma = 420;
        break;
      default: break;
    }
  }
  if (h->width <= 0 || h->height <= 0 || den <= 0) return false;
  h->fps = static_cast<double>(num) / den;
  const long w = h->width, hh = h->height;
  if (h->chroma == 420) h->frame_bytes = w * hh + 2 * (w / 2) * (hh / 2);
  else if (h->chroma == 422) h->frame_bytes = w * hh + 2 * (w / 2) * hh;
  else h->frame_bytes = 3 * w * hh;
  h->buf.resize(h->frame_bytes);
  return true;
}

void* y4m_open(const char* path) {
  auto* h = new Y4MHandle();
  h->file = fopen(path, "rb");
  if (!h->file || !parse_y4m_header(h)) {
    if (h->file) fclose(h->file);
    delete h;
    return nullptr;
  }
  return h;
}

int y4m_info(void* handle, int* w, int* hh, double* fps) {
  auto* h = static_cast<Y4MHandle*>(handle);
  if (!h) return -1;
  *w = h->width;
  *hh = h->height;
  *fps = h->fps;
  return 0;
}

static inline uint8_t clamp_u8(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : static_cast<uint8_t>(v));
}

// BT.601 limited range, 16.16 fixed point:
//   R = 1.164(Y-16) + 1.596(V-128)
//   G = 1.164(Y-16) - 0.392(U-128) - 0.813(V-128)
//   B = 1.164(Y-16) + 2.017(U-128)
static void yuv_to_rgb(const Y4MHandle* h, uint8_t* rgb) {
  const int w = h->width, hh = h->height;
  const uint8_t* y = h->buf.data();
  const uint8_t* u;
  const uint8_t* v;
  int cw, ch;
  if (h->chroma == 420) { cw = w / 2; ch = hh / 2; }
  else if (h->chroma == 422) { cw = w / 2; ch = hh; }
  else { cw = w; ch = hh; }
  u = y + static_cast<long>(w) * hh;
  v = u + static_cast<long>(cw) * ch;

  for (int row = 0; row < hh; ++row) {
    const int crow = (h->chroma == 420) ? row / 2 : row;
    for (int col = 0; col < w; ++col) {
      const int ccol = (h->chroma == 444) ? col : col / 2;
      const int yy = 76309 * (y[static_cast<long>(row) * w + col] - 16);
      const int uu = u[static_cast<long>(crow) * cw + ccol] - 128;
      const int vv = v[static_cast<long>(crow) * cw + ccol] - 128;
      uint8_t* px = rgb + (static_cast<long>(row) * w + col) * 3;
      px[0] = clamp_u8((yy + 104597 * vv) >> 16);
      px[1] = clamp_u8((yy - 25675 * uu - 53279 * vv) >> 16);
      px[2] = clamp_u8((yy + 132201 * uu) >> 16);
    }
  }
}

// returns 1 on frame, 0 on EOF, -1 on error
int y4m_next_frame(void* handle, uint8_t* rgb_out) {
  auto* h = static_cast<Y4MHandle*>(handle);
  if (!h) return -1;
  char line[256];
  if (!fgets(line, sizeof(line), h->file)) return 0;
  if (strncmp(line, "FRAME", 5) != 0) return 0;
  if (fread(h->buf.data(), 1, h->frame_bytes, h->file)
      != static_cast<size_t>(h->frame_bytes)) {
    return 0;
  }
  yuv_to_rgb(h, rgb_out);
  return 1;
}

void y4m_close(void* handle) {
  auto* h = static_cast<Y4MHandle*>(handle);
  if (!h) return;
  if (h->file) fclose(h->file);
  delete h;
}

// --------------------------------------------------------------------- wav

// Reads PCM16/PCM24/PCM32/float32 WAV, mixes to mono float32.
// Returns sample count (>0), or <=0 on error. Caller frees via wav_free.
long wav_read(const char* path, float** out, int* sample_rate) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  auto rd_u32 = [&]() {
    uint8_t b[4];
    if (fread(b, 1, 4, f) != 4) return 0u;
    return static_cast<uint32_t>(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24);
  };
  auto rd_u16 = [&]() {
    uint8_t b[2];
    if (fread(b, 1, 2, f) != 2) return 0u;
    return static_cast<uint32_t>(b[0] | b[1] << 8);
  };

  char tag[5] = {0};
  if (fread(tag, 1, 4, f) != 4 || strncmp(tag, "RIFF", 4)) { fclose(f); return -2; }
  rd_u32();  // riff size
  if (fread(tag, 1, 4, f) != 4 || strncmp(tag, "WAVE", 4)) { fclose(f); return -2; }

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  std::vector<uint8_t> data;
  while (fread(tag, 1, 4, f) == 4) {
    uint32_t size = rd_u32();
    if (!strncmp(tag, "fmt ", 4)) {
      fmt = static_cast<uint16_t>(rd_u16());
      channels = static_cast<uint16_t>(rd_u16());
      rate = rd_u32();
      rd_u32();  // byte rate
      rd_u16();  // block align
      bits = static_cast<uint16_t>(rd_u16());
      if (size > 16) fseek(f, size - 16, SEEK_CUR);
    } else if (!strncmp(tag, "data", 4)) {
      data.resize(size);
      if (fread(data.data(), 1, size, f) != size) { fclose(f); return -3; }
      break;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  fclose(f);
  if (data.empty() || channels == 0 || rate == 0) return -3;

  const int bytes_per = bits / 8;
  const long frames = static_cast<long>(data.size()) / (bytes_per * channels);
  float* samples = static_cast<float*>(malloc(sizeof(float) * frames));
  if (!samples) return -4;

  for (long i = 0; i < frames; ++i) {
    double acc = 0.0;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* p = data.data() + (i * channels + c) * bytes_per;
      double s = 0.0;
      if (fmt == 3 && bits == 32) {  // IEEE float
        float fv;
        memcpy(&fv, p, 4);
        s = fv;
      } else if (bits == 16) {
        int16_t v = static_cast<int16_t>(p[0] | p[1] << 8);
        s = v / 32768.0;
      } else if (bits == 24) {
        int32_t v = (p[0] << 8 | p[1] << 16 | p[2] << 24) >> 8;
        s = v / 8388608.0;
      } else if (bits == 32) {
        int32_t v;
        memcpy(&v, p, 4);
        s = v / 2147483648.0;
      }
      acc += s;
    }
    samples[i] = static_cast<float>(acc / channels);
  }
  *out = samples;
  *sample_rate = static_cast<int>(rate);
  return frames;
}

void wav_free(float* p) { free(p); }

// ---------------------------------------------------------------- prefetch

struct PrefetchHandle {
  Y4MHandle* reader = nullptr;
  int stride = 1;         // keep every Nth frame
  int capacity = 4;       // ring slots
  long frame_px = 0;      // w*h*3
  std::vector<std::vector<uint8_t>> ring;
  std::vector<double> timestamps;
  size_t head = 0, tail = 0, count = 0;
  bool eof = false;
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable can_produce, can_consume;
  std::thread worker;
};

static void prefetch_worker(PrefetchHandle* p) {
  long index = 0;
  std::vector<uint8_t> scratch(p->frame_px);
  while (!p->stop.load()) {
    int got = y4m_next_frame(p->reader, scratch.data());
    if (got != 1) break;
    if (index % p->stride == 0) {
      std::unique_lock<std::mutex> lock(p->mu);
      p->can_produce.wait(lock, [&] {
        return p->count < static_cast<size_t>(p->capacity) || p->stop.load();
      });
      if (p->stop.load()) break;
      p->ring[p->head].swap(scratch);
      p->timestamps[p->head] = index / p->reader->fps;
      p->head = (p->head + 1) % p->capacity;
      ++p->count;
      scratch.resize(p->frame_px);
      p->can_consume.notify_one();
    }
    ++index;
  }
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->eof = true;
  }
  p->can_consume.notify_all();
}

void* prefetch_create(const char* path, int capacity, int stride) {
  auto* reader = static_cast<Y4MHandle*>(y4m_open(path));
  if (!reader) return nullptr;
  auto* p = new PrefetchHandle();
  p->reader = reader;
  p->stride = stride > 0 ? stride : 1;
  p->capacity = capacity > 1 ? capacity : 2;
  p->frame_px = static_cast<long>(reader->width) * reader->height * 3;
  p->ring.resize(p->capacity);
  for (auto& slot : p->ring) slot.resize(p->frame_px);
  p->timestamps.resize(p->capacity);
  p->worker = std::thread(prefetch_worker, p);
  return p;
}

int prefetch_info(void* handle, int* w, int* h, double* fps) {
  auto* p = static_cast<PrefetchHandle*>(handle);
  if (!p) return -1;
  return y4m_info(p->reader, w, h, fps);
}

// returns 1 on frame, 0 on EOF
int prefetch_next(void* handle, uint8_t* rgb_out, double* ts) {
  auto* p = static_cast<PrefetchHandle*>(handle);
  if (!p) return -1;
  std::unique_lock<std::mutex> lock(p->mu);
  p->can_consume.wait(lock, [&] { return p->count > 0 || p->eof; });
  if (p->count == 0) return 0;
  memcpy(rgb_out, p->ring[p->tail].data(), p->frame_px);
  *ts = p->timestamps[p->tail];
  p->tail = (p->tail + 1) % p->capacity;
  --p->count;
  p->can_produce.notify_one();
  return 1;
}

void prefetch_destroy(void* handle) {
  auto* p = static_cast<PrefetchHandle*>(handle);
  if (!p) return;
  p->stop.store(true);
  p->can_produce.notify_all();
  p->can_consume.notify_all();
  if (p->worker.joinable()) p->worker.join();
  y4m_close(p->reader);
  delete p;
}

// ------------------------------------------------------------------ resize
//
// Host-side image resize is on the perception hot path (every frame is
// resized for the segmenter, every region for the encoder, every mask
// back to frame size).  PIL does this through Python per call; these are
// tight fixed-point loops the compiler vectorizes.

// Area-average downscale / bilinear upscale, uint8 interleaved channels.
// src [sh][sw][c] -> dst [dh][dw][c].
int resize_u8(const uint8_t* src, int sh, int sw, int c,
              uint8_t* dst, int dh, int dw) {
  if (!src || !dst || sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || c <= 0)
    return 0;
  const bool down = (dh <= sh && dw <= sw);
  if (down) {
    // box filter: average the source rectangle mapping to each dest px
    for (int y = 0; y < dh; ++y) {
      const float fy0 = (float)y * sh / dh;
      const float fy1 = (float)(y + 1) * sh / dh;
      int y0 = (int)fy0, y1 = (int)(fy1 + 0.9999f);
      if (y1 > sh) y1 = sh;
      if (y1 <= y0) y1 = y0 + 1;
      for (int x = 0; x < dw; ++x) {
        const float fx0 = (float)x * sw / dw;
        const float fx1 = (float)(x + 1) * sw / dw;
        int x0 = (int)fx0, x1 = (int)(fx1 + 0.9999f);
        if (x1 > sw) x1 = sw;
        if (x1 <= x0) x1 = x0 + 1;
        const int area = (y1 - y0) * (x1 - x0);
        for (int ch = 0; ch < c; ++ch) {
          uint32_t acc = 0;
          for (int yy = y0; yy < y1; ++yy) {
            const uint8_t* row = src + ((long)yy * sw) * c + ch;
            for (int xx = x0; xx < x1; ++xx) acc += row[(long)xx * c];
          }
          dst[((long)y * dw + x) * c + ch] =
              (uint8_t)((acc + area / 2) / area);
        }
      }
    }
  } else {
    // bilinear (half-pixel centers), 8.8 fixed point
    for (int y = 0; y < dh; ++y) {
      float fy = ((float)y + 0.5f) * sh / dh - 0.5f;
      if (fy < 0) fy = 0;
      int y0 = (int)fy;
      if (y0 > sh - 2) y0 = sh - 2 < 0 ? 0 : sh - 2;
      const int wy = (int)((fy - y0) * 256.0f);
      for (int x = 0; x < dw; ++x) {
        float fx = ((float)x + 0.5f) * sw / dw - 0.5f;
        if (fx < 0) fx = 0;
        int x0 = (int)fx;
        if (x0 > sw - 2) x0 = sw - 2 < 0 ? 0 : sw - 2;
        const int wx = (int)((fx - x0) * 256.0f);
        const uint8_t* p00 = src + ((long)y0 * sw + x0) * c;
        const uint8_t* p01 = p00 + (sw > 1 ? c : 0);
        const uint8_t* p10 = p00 + (sh > 1 ? (long)sw * c : 0);
        const uint8_t* p11 = p10 + (sw > 1 ? c : 0);
        for (int ch = 0; ch < c; ++ch) {
          const int top = p00[ch] * (256 - wx) + p01[ch] * wx;
          const int bot = p10[ch] * (256 - wx) + p11[ch] * wx;
          dst[((long)y * dw + x) * c + ch] =
              (uint8_t)((top * (256 - wy) + bot * wy + 32768) >> 16);
        }
      }
    }
  }
  return 1;
}

// Batched variant: n same-shape images back to back.
int resize_u8_batch(const uint8_t* src, int n, int sh, int sw, int c,
                    uint8_t* dst, int dh, int dw) {
  const long in_stride = (long)sh * sw * c;
  const long out_stride = (long)dh * dw * c;
  for (int i = 0; i < n; ++i) {
    if (!resize_u8(src + i * in_stride, sh, sw, c,
                   dst + i * out_stride, dh, dw))
      return 0;
  }
  return 1;
}

// Nearest-neighbor for masks (uint8 0/1 or 0/255).
int resize_nearest_u8(const uint8_t* src, int sh, int sw,
                      uint8_t* dst, int dh, int dw) {
  if (!src || !dst || sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0) return 0;
  for (int y = 0; y < dh; ++y) {
    int sy = (int)(((long)y * sh) / dh);
    if (sy >= sh) sy = sh - 1;
    const uint8_t* row = src + (long)sy * sw;
    for (int x = 0; x < dw; ++x) {
      int sx = (int)(((long)x * sw) / dw);
      if (sx >= sw) sx = sw - 1;
      dst[(long)y * dw + x] = row[sx];
    }
  }
  return 1;
}

}  // extern "C"
