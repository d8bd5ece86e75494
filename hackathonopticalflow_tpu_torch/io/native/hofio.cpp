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
//    reference call site pathfinder_viewer.py:280), into a caller-given
//    destination, its rows split in bands over a pool of parked threads;
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
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <sched.h>
#include <unistd.h>

// ---------------------------------------------------------------------------
// BGR -> gray, OpenCV 5.x parity: Rec.601 in 15-bit fixed point
// (B*3735 + G*19235 + R*9798 + 16384) >> 15 — verified bit-exact against
// cv2 5.0 over the full random input space. Each output pixel depends on
// its own input pixel alone, so any split of the rows gives the same bits.
// ---------------------------------------------------------------------------
namespace {

void gray_rows(const uint8_t* __restrict__ bgr, int64_t bgr_stride, uint8_t* __restrict__ gray,
               int64_t gray_stride, int64_t r0, int64_t r1, int64_t cols) {
  for (int64_t y = r0; y < r1; ++y) {
    const uint8_t* __restrict__ s = bgr + y * bgr_stride;
    uint8_t* __restrict__ d = gray + y * gray_stride;
    for (int64_t x = 0; x < cols; ++x) {
      const int32_t b = s[3 * x], g = s[3 * x + 1], r = s[3 * x + 2];
      d[x] = (uint8_t)((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15);
    }
  }
}

// One call's conversion; `left` counts its bands not yet converted.
struct GrayJob {
  const uint8_t* bgr;
  int64_t bgr_stride;
  uint8_t* gray;
  int64_t gray_stride;
  int64_t cols;
  std::atomic<int> left;
};

struct GrayBand {
  GrayJob* job;
  int64_t r0, r1;
};

void run_band(const GrayBand& t) {
  GrayJob* j = t.job;
  gray_rows(j->bgr, j->bgr_stride, j->gray, j->gray_stride, t.r0, t.r1, j->cols);
  // the band's last touch of the job: once `left` reads 0 its caller may
  // return and free it
  j->left.fetch_sub(1, std::memory_order_acq_rel);
}

// A parked thread takes longer to wake than a 1080p band takes to convert
// (PERF.md §6), so a pool thread polls for bands this long after
// its last one before it parks, and a caller polls for its bands' end.
// Each poll yields the CPU, to a thread it might share it with.
constexpr auto kSpin = std::chrono::milliseconds(2);

// Threads that convert other callers' bands; started as calls ask for
// more, never stopped. Callers from several threads share them: each call
// waits for its own bands only.
struct GrayPool {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<GrayBand> bands;
  std::atomic<int> queued{0};  // bands.size(), read without the lock
  int threads = 0;
  pid_t pid = getpid();

  // A thread that shares a CPU with its caller converts nothing in
  // parallel, and the scheduler was seen to wake a pool thread onto the
  // caller's CPU and keep it there (PERF.md §6): so a new thread
  // leaves out of its CPUs the one its creator runs on.
  void grow(int n) {  // under mu
    const int creator = sched_getcpu();
    for (; threads < n; ++threads) {
      std::thread([this, creator] {
        cpu_set_t cpus;
        if (creator >= 0 && sched_getaffinity(0, sizeof(cpus), &cpus) == 0 && CPU_COUNT(&cpus) > 1) {
          CPU_CLR(creator, &cpus);
          sched_setaffinity(0, sizeof(cpus), &cpus);
        }
        work();
      }).detach();
    }
  }

  bool pop(GrayBand* out) {  // under mu
    if (bands.empty()) return false;
    *out = bands.front();
    bands.pop_front();
    queued.store((int)bands.size(), std::memory_order_relaxed);
    return true;
  }

  void work() {
    for (;;) {
      GrayBand t;
      auto until = std::chrono::steady_clock::now() + kSpin;
      while (queued.load(std::memory_order_relaxed) == 0 && std::chrono::steady_clock::now() < until) {
        std::this_thread::yield();
      }
      bool got;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (!(got = pop(&t))) {
          cv.wait(lk, [&] { return !bands.empty(); });
          got = pop(&t);
        }
      }
      if (got) run_band(t);
    }
  }

  // Takes a queued band of `job` that no thread has started, if one is left.
  bool take(GrayJob* job, GrayBand* out) {
    std::lock_guard<std::mutex> lk(mu);
    for (auto it = bands.begin(); it != bands.end(); ++it) {
      if (it->job == job) {
        *out = *it;
        bands.erase(it);
        queued.store((int)bands.size(), std::memory_order_relaxed);
        return true;
      }
    }
    return false;
  }
};

GrayPool& gray_pool() {
  static std::mutex m;
  static GrayPool* pool = nullptr;  // never freed: its threads live as long as the process
  std::lock_guard<std::mutex> lk(m);
  // a child made by fork has none of the parent's threads: it starts its own
  if (pool == nullptr || pool->pid != getpid()) pool = new GrayPool();
  return *pool;
}

}  // namespace

extern "C" {

// (rows, cols) gray of (rows, cols, 3) BGR; a row starts every bgr_stride
// (gray_stride) bytes, its pixels packed. Band b of `bands` holds rows
// [b rows / bands, (b + 1) rows / bands): the calling thread converts band
// 0, the pool the others, and the calling thread takes back any of its
// bands the pool has not started before it waits for the rest.
void hof_bgr2gray_u8(const uint8_t* bgr, int64_t bgr_stride, uint8_t* gray, int64_t gray_stride,
                     int64_t rows, int64_t cols, int bands) {
  if (bands > rows) bands = (int)rows;
  if (bands <= 1) {
    gray_rows(bgr, bgr_stride, gray, gray_stride, 0, rows, cols);
    return;
  }
  GrayJob job;
  job.bgr = bgr;
  job.bgr_stride = bgr_stride;
  job.gray = gray;
  job.gray_stride = gray_stride;
  job.cols = cols;
  job.left.store(bands - 1);
  GrayPool& pool = gray_pool();
  {
    std::lock_guard<std::mutex> lk(pool.mu);
    pool.grow(bands - 1);
    for (int b = 1; b < bands; ++b) pool.bands.push_back({&job, b * rows / bands, (b + 1) * rows / bands});
    pool.queued.store((int)pool.bands.size(), std::memory_order_relaxed);
  }
  for (int b = 1; b < bands; ++b) pool.cv.notify_one();
  gray_rows(bgr, bgr_stride, gray, gray_stride, 0, rows / bands, cols);
  GrayBand t;
  while (pool.take(&job, &t)) run_band(t);
  while (job.left.load(std::memory_order_acquire) != 0) std::this_thread::yield();
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
      // every change a waiter's predicate reads is made under `mu`: one
      // made without it between the waiter's test and its sleep, and its
      // notify, would be lost, and the waiter would sleep forever
      bool at_eof = got != (size_t)frame_bytes;
      {
        std::lock_guard<std::mutex> lk(mu);
        if (at_eof) eof.store(true); else head.fetch_add(1);
      }
      cv_data.notify_all();
      if (at_eof) break;
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
  {
    std::lock_guard<std::mutex> lk(r->mu);  // see RingReader::run
    r->tail.fetch_add(1);
  }
  r->cv_space.notify_all();
  return 1;
}

void hof_ring_close(void* handle) {
  auto* r = (RingReader*)handle;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop.store(true);
  }
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
