// Native ray-store: the host-side data engine backing the trainers'
// streaming mode.  This is the TPU-native replacement for the reference's
// torch DataLoader worker processes (train.py:89-94 — 4 workers + pinned
// memory): instead of Python workers pickling per-ray samples, one C++
// library owns the flattened ray/target buffers and hands back fully
// assembled, contiguous batches.
//
// Responsibilities:
//   * owns interleaved row storage for an arbitrary set of float32 columns
//     (rays 8, rgbs 3, pixels 3, ...) — one gather produces one batch;
//   * per-epoch Fisher-Yates permutations (SplitMix64/xoshiro256**) computed
//     in a BACKGROUND thread, double-buffered so epoch e+1's shuffle is
//     ready before epoch e finishes (DistributedSampler-style per-shard
//     independent shuffles when `shard_seed` differs per host);
//   * multi-threaded batch gathers into caller-provided buffers so the
//     host never stalls the device feed.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// SplitMix64 — tiny, solid generator for shuffles.
struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  }
  // Lemire bounded rand
  uint64_t bounded(uint64_t n) {
    __uint128_t m = (__uint128_t)next() * (__uint128_t)n;
    return (uint64_t)(m >> 64);
  }
};

struct RayStore {
  int64_t n_rows = 0;
  int64_t row_width = 0;  // total floats per row across all columns
  std::vector<float> data;  // row-major interleaved

  uint64_t seed = 0;
  // double-buffered permutations
  std::vector<uint32_t> perm_cur, perm_next;
  int64_t epoch_cur = -1;
  int64_t epoch_next = -1;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  bool next_ready = false;
  bool stop = false;
  int64_t requested_epoch = -1;

  ~RayStore() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    if (worker.joinable()) worker.join();
  }

  void shuffle_into(std::vector<uint32_t>* perm, int64_t epoch) {
    perm->resize(n_rows);
    for (int64_t i = 0; i < n_rows; ++i) (*perm)[i] = (uint32_t)i;
    SplitMix64 rng(seed * 0x100000001B3ull + (uint64_t)epoch + 1);
    for (int64_t i = n_rows - 1; i > 0; --i) {
      uint64_t j = rng.bounded((uint64_t)i + 1);
      std::swap((*perm)[i], (*perm)[j]);
    }
  }

  void worker_loop() {
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      cv.wait(lk, [&] { return stop || requested_epoch >= 0; });
      if (stop) return;
      int64_t e = requested_epoch;
      requested_epoch = -1;
      lk.unlock();
      std::vector<uint32_t> p;
      shuffle_into(&p, e);
      lk.lock();
      perm_next.swap(p);
      epoch_next = e;
      next_ready = true;
      cv.notify_all();
    }
  }

  // Ensure perm_cur holds `epoch`'s permutation; kick off epoch+1 prefetch.
  // Every exit path invalidates epoch_next/next_ready: a delivered-but-
  // unconsumed prefetch must never survive a non-monotonic epoch access,
  // and a wait must only accept a delivery tagged with the epoch it wants
  // (the worker may still be computing a previously requested epoch).
  void ensure_epoch(int64_t epoch) {
    std::unique_lock<std::mutex> lk(mu);
    if (epoch_cur == epoch) return;
    if (next_ready && epoch_next == epoch) {
      perm_cur.swap(perm_next);  // prefetch already delivered
    } else if (requested_epoch == epoch || epoch_next == epoch) {
      // our epoch is in flight: wait for ITS delivery specifically
      cv.wait(lk, [&] { return stop || (next_ready && epoch_next == epoch); });
      if (stop) return;
      perm_cur.swap(perm_next);
    } else {
      lk.unlock();
      std::vector<uint32_t> p;
      shuffle_into(&p, epoch);
      lk.lock();
      perm_cur.swap(p);
    }
    epoch_cur = epoch;
    next_ready = false;
    epoch_next = -1;  // discard any stale prefetch delivery
    requested_epoch = epoch + 1;  // prefetch the next epoch's shuffle
    cv.notify_all();
  }
};

void gather_rows(const RayStore& s, const uint32_t* idx, int64_t count,
                 float* out, int threads) {
  const int64_t w = s.row_width;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t k = lo; k < hi; ++k) {
      std::memcpy(out + k * w, s.data.data() + (int64_t)idx[k] * w,
                  (size_t)w * sizeof(float));
    }
  };
  if (threads <= 1 || count < 4096) {
    work(0, count);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (count + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * per, hi = std::min<int64_t>(count, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// columns: array of `n_cols` pointers to (n_rows, widths[c]) row-major f32.
void* raystore_create(const float** columns, const int64_t* widths,
                      int64_t n_cols, int64_t n_rows, uint64_t seed) {
  auto* s = new RayStore();
  s->n_rows = n_rows;
  s->seed = seed;
  int64_t w = 0;
  for (int64_t c = 0; c < n_cols; ++c) w += widths[c];
  s->row_width = w;
  s->data.resize((size_t)(n_rows * w));
  // interleave the columns into row-major storage
  int64_t off = 0;
  for (int64_t c = 0; c < n_cols; ++c) {
    const float* src = columns[c];
    const int64_t cw = widths[c];
    for (int64_t r = 0; r < n_rows; ++r) {
      std::memcpy(s->data.data() + r * w + off, src + r * cw,
                  (size_t)cw * sizeof(float));
    }
    off += cw;
  }
  s->worker = std::thread(&RayStore::worker_loop, s);
  return s;
}

void raystore_destroy(void* handle) { delete (RayStore*)handle; }

int64_t raystore_rows(void* handle) { return ((RayStore*)handle)->n_rows; }
int64_t raystore_row_width(void* handle) {
  return ((RayStore*)handle)->row_width;
}

// Fill `out` (batch, row_width) with rows [step*batch, (step+1)*batch) of
// epoch `epoch`'s permutation.  Returns rows written (0 past epoch end).
int64_t raystore_fill_batch(void* handle, int64_t epoch, int64_t step,
                            int64_t batch, float* out, int threads) {
  auto* s = (RayStore*)handle;
  s->ensure_epoch(epoch);
  int64_t lo = step * batch;
  if (lo >= s->n_rows) return 0;
  int64_t count = std::min<int64_t>(batch, s->n_rows - lo);
  gather_rows(*s, s->perm_cur.data() + lo, count, out, threads);
  return count;
}

// Sequential (unshuffled) batch — the shadow trainers' shuffle=False mode.
int64_t raystore_fill_sequential(void* handle, int64_t start, int64_t batch,
                                 float* out, int threads) {
  auto* s = (RayStore*)handle;
  if (start >= s->n_rows) return 0;
  int64_t count = std::min<int64_t>(batch, s->n_rows - start);
  const int64_t w = s->row_width;
  std::memcpy(out, s->data.data() + start * w,
              (size_t)(count * w) * sizeof(float));
  (void)threads;
  return count;
}

// Expose the permutation itself (testing / device-side gather paths).
void raystore_epoch_perm(void* handle, int64_t epoch, uint32_t* out) {
  auto* s = (RayStore*)handle;
  s->ensure_epoch(epoch);
  std::memcpy(out, s->perm_cur.data(),
              (size_t)s->n_rows * sizeof(uint32_t));
}
}
