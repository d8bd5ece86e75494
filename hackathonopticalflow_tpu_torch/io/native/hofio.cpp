// Native host-runtime kernels of the optical-flow framework (the PyTorch
// port's copy of hackathonopticalflow_tpu/io/native/hofio.cpp; built by
// io/native_lib.py into build/native/ at the repository root).
//
// The reference delegates its host-side work to OpenCV C++ through cv2
// (SURVEY.md §2.3); this library provides the framework's own native
// equivalents for the pieces that belong on the host CPU:
//
//  - bgr2gray_u8: OpenCV-exact fixed-point Rec.601 gray conversion
//    (the per-frame preprocessing step between decode and device upload,
//    reference call site pathfinder_viewer.py:280);
//  - a single-producer/single-consumer frame ring buffer + background
//    reader thread for raw byte-stream frame files (the async prefetch
//    stage feeding device transfers — SURVEY.md §7 "design the
//    prefetcher early");
//  - trace_contours: Suzuki-Abe style border following on binary images
//    — the one inherently sequential kernel in the reference's pipeline
//    (cv2.findContours, DenseOF.py:397), kept on the host by design.
//
// Built with: g++ -O3 -shared -fPIC -std=c++17 -pthread hofio.cpp -o libhofio.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// BGR -> gray, OpenCV 5.x parity: Rec.601 in 15-bit fixed point
// (B*3735 + G*19235 + R*9798 + 16384) >> 15 — verified bit-exact against
// cv2 5.0 over the full random input space.
// ---------------------------------------------------------------------------
void hof_bgr2gray_u8(const uint8_t* bgr, uint8_t* gray, int64_t n_px) {
  for (int64_t i = 0; i < n_px; ++i) {
    const int32_t b = bgr[3 * i], g = bgr[3 * i + 1], r = bgr[3 * i + 2];
    gray[i] = (uint8_t)((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15);
  }
}

// u8 -> f32 copy (device staging)
void hof_u8_to_f32(const uint8_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = (float)src[i];
}

// ---------------------------------------------------------------------------
// Frame ring buffer with background file reader (raw frames, fixed size).
// ---------------------------------------------------------------------------
struct RingReader {
  FILE* f = nullptr;
  int64_t frame_bytes = 0;
  int n_slots = 0;
  std::vector<uint8_t> storage;
  std::atomic<int64_t> head{0};  // next slot to fill (producer)
  std::atomic<int64_t> tail{0};  // next slot to consume
  std::atomic<bool> eof{false};
  std::atomic<bool> stop{false};
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_space, cv_data;

  void run() {
    while (!stop.load()) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || head.load() - tail.load() < n_slots;
        });
      }
      if (stop.load()) break;
      uint8_t* slot = storage.data() + (head.load() % n_slots) * frame_bytes;
      size_t got = fread(slot, 1, (size_t)frame_bytes, f);
      if (got != (size_t)frame_bytes) {
        eof.store(true);
        cv_data.notify_all();
        break;
      }
      head.fetch_add(1);
      cv_data.notify_all();
    }
  }
};

void* hof_ring_open(const char* path, int64_t frame_bytes, int n_slots) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new RingReader();
  r->f = f;
  r->frame_bytes = frame_bytes;
  r->n_slots = n_slots;
  r->storage.resize((size_t)frame_bytes * n_slots);
  r->worker = std::thread([r] { r->run(); });
  return r;
}

// Blocking pop of the next frame into out. Returns 1 on success, 0 at EOF.
int hof_ring_next(void* handle, uint8_t* out) {
  auto* r = (RingReader*)handle;
  {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_data.wait(lk, [&] {
      return r->head.load() > r->tail.load() || r->eof.load() || r->stop.load();
    });
  }
  if (r->head.load() <= r->tail.load()) return 0;
  const uint8_t* slot =
      r->storage.data() + (r->tail.load() % r->n_slots) * r->frame_bytes;
  memcpy(out, slot, (size_t)r->frame_bytes);
  r->tail.fetch_add(1);
  r->cv_space.notify_all();
  return 1;
}

void hof_ring_close(void* handle) {
  auto* r = (RingReader*)handle;
  r->stop.store(true);
  r->cv_space.notify_all();
  r->cv_data.notify_all();
  if (r->worker.joinable()) r->worker.join();
  if (r->f) fclose(r->f);
  delete r;
}

// ---------------------------------------------------------------------------
// Border following on a binary image (Suzuki-Abe style outer borders).
// img: (h, w) uint8 (0 / nonzero). Emits contours as x,y pairs into
// out_xy (capacity cap_pts points); out_lens gets each contour's length
// (capacity cap_contours). Returns number of contours found.
// ---------------------------------------------------------------------------
int hof_trace_contours(const uint8_t* img, int h, int w, int32_t* out_xy,
                       int64_t cap_pts, int32_t* out_lens, int cap_contours) {
  // Moore neighborhood, clockwise starting at "west"
  const int dx8[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  const int dy8[8] = {0, -1, -1, -1, 0, 1, 1, 1};
  std::vector<uint8_t> visited((size_t)h * w, 0);
  auto at = [&](int x, int y) -> bool {
    return x >= 0 && x < w && y >= 0 && y < h && img[(size_t)y * w + x] != 0;
  };
  int n_contours = 0;
  int64_t n_pts = 0;
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      if (!at(x, y) || visited[(size_t)y * w + x]) continue;
      // outer border start: left neighbor is background
      if (at(x - 1, y)) {
        visited[(size_t)y * w + x] = 1;
        continue;
      }
      if (n_contours >= cap_contours) return n_contours;
      // Moore boundary trace
      int sx = x, sy = y;
      int cx = x, cy = y;
      int backtrack = 0;  // came from west
      int len = 0;
      do {
        if (n_pts < cap_pts) {
          out_xy[2 * n_pts] = cx;
          out_xy[2 * n_pts + 1] = cy;
          ++n_pts;
          ++len;
        } else {
          return n_contours;
        }
        visited[(size_t)cy * w + cx] = 1;
        int dir = (backtrack + 1) % 8;
        int found = -1;
        for (int k = 0; k < 8; ++k) {
          int d = (dir + k) % 8;
          if (at(cx + dx8[d], cy + dy8[d])) {
            found = d;
            break;
          }
        }
        if (found < 0) break;  // isolated pixel
        cx += dx8[found];
        cy += dy8[found];
        // direction pointing back at the cell we came from
        backtrack = (found + 4) % 8;
      } while (!(cx == sx && cy == sy && len > 1) && len < h * w);
      out_lens[n_contours++] = len;
    }
  }
  return n_contours;
}

}  // extern "C"
