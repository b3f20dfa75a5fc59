// pfio — native page-IO runtime for libpillowfight_tpu.
//
// The reference ships its native layer as libpillowfight.so (C kernels +
// CPython extension; SURVEY.md §1 Build A/B). Here the kernels live
// on-device (XLA/Pallas), so the native layer moves to where the host
// actually does work: feeding the devices. This translation unit
// implements
//   * PNM decode (P5/P6 binary, P2/P3 ascii) -> RGBA8,
//   * PPM/PGM encode (the ref's pf_write_bitmap_to_ppm debug path,
//     SURVEY.md §2.1), and
//   * a threaded prefetch pool: N worker threads decode + pad pages to a
//     uniform [H,W] into caller-visible batch buffers while the device is
//     busy with the previous chunk (overlap host IO with device compute,
//     SURVEY.md §7 "hard parts" item 5).
//
// Plain C ABI; bound from Python via ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- decode

// Parse one PNM header token, skipping whitespace and '#' comments.
static bool pnm_token(FILE *f, char *tok, size_t cap) {
  int c;
  do {
    c = fgetc(f);
    if (c == '#') {
      while (c != '\n' && c != EOF) c = fgetc(f);
    }
  } while (c == ' ' || c == '\t' || c == '\n' || c == '\r');
  size_t n = 0;
  while (c != EOF && c != ' ' && c != '\t' && c != '\n' && c != '\r') {
    if (n + 1 < cap) tok[n++] = (char)c;
    c = fgetc(f);
  }
  tok[n] = 0;
  return n > 0;
}

// Decode a PNM file. On success fills *w/*h and returns a malloc'd RGBA8
// buffer (caller frees via pfio_free). Returns nullptr on any parse error.
uint8_t *pfio_decode_pnm(const char *path, int32_t *h, int32_t *w) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  char tok[64];
  if (!pnm_token(f, tok, sizeof tok)) { fclose(f); return nullptr; }
  int kind = 0;  // channels; ascii if negative magic handled below
  bool ascii = false;
  if (!strcmp(tok, "P6")) kind = 3;
  else if (!strcmp(tok, "P5")) kind = 1;
  else if (!strcmp(tok, "P3")) { kind = 3; ascii = true; }
  else if (!strcmp(tok, "P2")) { kind = 1; ascii = true; }
  else { fclose(f); return nullptr; }
  long W, H, maxv;
  if (!pnm_token(f, tok, sizeof tok)) { fclose(f); return nullptr; }
  W = strtol(tok, nullptr, 10);
  if (!pnm_token(f, tok, sizeof tok)) { fclose(f); return nullptr; }
  H = strtol(tok, nullptr, 10);
  if (!pnm_token(f, tok, sizeof tok)) { fclose(f); return nullptr; }
  maxv = strtol(tok, nullptr, 10);
  if (W <= 0 || H <= 0 || W > 1 << 20 || H > 1 << 20 || maxv <= 0 ||
      maxv > 65535) {
    fclose(f);
    return nullptr;
  }
  const size_t npix = (size_t)W * (size_t)H;
  std::vector<uint16_t> raw(npix * kind);
  if (ascii) {
    for (size_t i = 0; i < raw.size(); i++) {
      if (!pnm_token(f, tok, sizeof tok)) { fclose(f); return nullptr; }
      raw[i] = (uint16_t)strtol(tok, nullptr, 10);
    }
  } else {
    const int bpc = maxv > 255 ? 2 : 1;
    std::vector<uint8_t> bytes(raw.size() * bpc);
    if (fread(bytes.data(), 1, bytes.size(), f) != bytes.size()) {
      fclose(f);
      return nullptr;
    }
    for (size_t i = 0; i < raw.size(); i++)
      raw[i] = bpc == 2 ? (uint16_t)((bytes[2 * i] << 8) | bytes[2 * i + 1])
                        : bytes[i];
  }
  fclose(f);
  uint8_t *out = (uint8_t *)malloc(npix * 4);
  if (!out) return nullptr;
  for (size_t i = 0; i < npix; i++) {
    uint8_t rgb[3];
    for (int c = 0; c < 3; c++) {
      uint32_t v = raw[i * kind + (kind == 3 ? c : 0)];
      rgb[c] = (uint8_t)(maxv == 255 ? v : (v * 255 + maxv / 2) / maxv);
    }
    out[i * 4 + 0] = rgb[0];
    out[i * 4 + 1] = rgb[1];
    out[i * 4 + 2] = rgb[2];
    out[i * 4 + 3] = 255;
  }
  *h = (int32_t)H;
  *w = (int32_t)W;
  return out;
}

void pfio_free(uint8_t *p) { free(p); }

// ---------------------------------------------------------------- encode

// Write RGBA8 [h,w,4] as binary PPM (P6). Returns 0 on success.
int32_t pfio_write_ppm(const char *path, const uint8_t *rgba, int32_t h,
                       int32_t w) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P6\n%d %d\n255\n", w, h);
  std::vector<uint8_t> row((size_t)w * 3);
  for (int32_t y = 0; y < h; y++) {
    const uint8_t *src = rgba + (size_t)y * w * 4;
    for (int32_t x = 0; x < w; x++) {
      row[(size_t)x * 3 + 0] = src[x * 4 + 0];
      row[(size_t)x * 3 + 1] = src[x * 4 + 1];
      row[(size_t)x * 3 + 2] = src[x * 4 + 2];
    }
    if (fwrite(row.data(), 1, row.size(), f) != row.size()) {
      fclose(f);
      return -1;
    }
  }
  fclose(f);
  return 0;
}

// Write the R channel of RGBA8 as binary PGM (P5). Returns 0 on success.
int32_t pfio_write_pgm(const char *path, const uint8_t *rgba, int32_t h,
                       int32_t w) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P5\n%d %d\n255\n", w, h);
  std::vector<uint8_t> row((size_t)w);
  for (int32_t y = 0; y < h; y++) {
    const uint8_t *src = rgba + (size_t)y * w * 4;
    for (int32_t x = 0; x < w; x++) row[(size_t)x] = src[x * 4];
    if (fwrite(row.data(), 1, row.size(), f) != row.size()) {
      fclose(f);
      return -1;
    }
  }
  fclose(f);
  return 0;
}

// ------------------------------------------------------------- prefetch

// Pool: worker threads pull page indices off a queue, decode + pad each
// page into its slot of a caller-owned batch buffer, and signal
// completion.  Padding: page placed at origin, remainder filled white
// (0xFF) — the unpaper filters treat white as background so padding is
// inert.  Oversized pages are cropped to [H,W].
struct PfioPool {
  std::vector<std::string> paths;
  int32_t H = 0, W = 0;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::queue<std::pair<int64_t, uint8_t *>> work;  // (path idx, dst slot)
  int64_t inflight = 0;
  std::atomic<int64_t> failed{0};
  bool stop = false;

  void worker() {
    for (;;) {
      std::pair<int64_t, uint8_t *> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop || !work.empty(); });
        if (stop && work.empty()) return;
        job = work.front();
        work.pop();
      }
      int32_t h = 0, w = 0;
      uint8_t *page = pfio_decode_pnm(paths[job.first].c_str(), &h, &w);
      uint8_t *dst = job.second;
      if (!page) {
        failed.fetch_add(1);
        memset(dst, 0xFF, (size_t)H * W * 4);
      } else {
        const int32_t ch = h < H ? h : H, cw = w < W ? w : W;
        memset(dst, 0xFF, (size_t)H * W * 4);
        for (int32_t y = 0; y < ch; y++)
          memcpy(dst + (size_t)y * W * 4, page + (size_t)y * w * 4,
                 (size_t)cw * 4);
        pfio_free(page);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (--inflight == 0) cv_done.notify_all();
      }
    }
  }
};

// paths: '\n'-joined file list.  H,W: uniform padded page shape.
void *pfio_pool_new(const char *paths, int32_t n_threads, int32_t H,
                    int32_t W) {
  auto *p = new PfioPool;
  p->H = H;
  p->W = W;
  const char *s = paths;
  while (*s) {
    const char *e = strchr(s, '\n');
    if (!e) e = s + strlen(s);
    if (e > s) p->paths.emplace_back(s, e - s);
    s = *e ? e + 1 : e;
  }
  if (n_threads < 1) n_threads = 1;
  for (int32_t i = 0; i < n_threads; i++)
    p->workers.emplace_back(&PfioPool::worker, p);
  return p;
}

int64_t pfio_pool_size(void *pool) {
  return (int64_t)((PfioPool *)pool)->paths.size();
}

// Asynchronously decode pages [start, start+n) into dst ([n,H,W,4] RGBA8,
// caller-owned, must stay alive until pfio_pool_wait returns).
void pfio_pool_submit(void *pool, int64_t start, int64_t n, uint8_t *dst) {
  auto *p = (PfioPool *)pool;
  std::lock_guard<std::mutex> lk(p->mu);
  for (int64_t i = 0; i < n; i++) {
    int64_t idx = start + i;
    uint8_t *slot = dst + (size_t)i * p->H * p->W * 4;
    if (idx < 0 || idx >= (int64_t)p->paths.size()) {
      memset(slot, 0xFF, (size_t)p->H * p->W * 4);
      continue;
    }
    p->work.emplace(idx, slot);
    p->inflight++;
  }
  p->cv_work.notify_all();
}

// Block until all submitted work is done; returns the number of pages
// that failed to decode (white-filled) since the last wait.
int64_t pfio_pool_wait(void *pool) {
  auto *p = (PfioPool *)pool;
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [&] { return p->inflight == 0; });
  return p->failed.exchange(0);
}

void pfio_pool_free(void *pool) {
  auto *p = (PfioPool *)pool;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_work.notify_all();
  for (auto &t : p->workers) t.join();
  delete p;
}

}  // extern "C"
