// ufm_torch serving runtime: continuous-batching request scheduler.
//
// The port's own copy of the JAX package's native/ufm_runtime.cc (framework
// free, unchanged in behaviour), built by ufm_torch/ops/_build.py with the
// host C++ compiler into build/ufm_torch/ at first use. For serving, the
// throughput lever is batch formation: requests arriving
// asynchronously must be coalesced into full batches without letting the
// first request wait unboundedly. This component implements that policy in
// C++ (no GIL, microsecond-precision timing):
//
//   - lock-protected ring of pending request ids,
//   - batch release when either `max_batch` requests are pending or
//     `max_delay_us` has elapsed since the oldest pending request,
//   - blocking `next_batch` for the device dispatch thread, with shutdown,
//   - running stats (submitted / dispatched / batches / occupancy).
//
// Exposed as a C API for ctypes (see ufm_torch/runtime/batcher.py). Payloads
// stay in Python (numpy arrays keyed by id); only ids cross the boundary.

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>

namespace {

using Clock = std::chrono::steady_clock;

struct Batcher {
  explicit Batcher(int max_batch, int64_t max_delay_us, int capacity)
      : max_batch(max_batch), max_delay_us(max_delay_us), capacity(capacity) {}

  const int max_batch;
  const int64_t max_delay_us;
  const int capacity;

  std::mutex mu;
  std::condition_variable cv_submit;   // signalled when queue drains
  std::condition_variable cv_dispatch; // signalled when work arrives
  std::deque<std::pair<uint64_t, Clock::time_point>> pending;
  bool shutdown = false;

  // stats
  uint64_t submitted = 0;
  uint64_t dispatched = 0;
  uint64_t batches = 0;
  uint64_t sum_batch_size = 0;
  uint64_t sum_wait_us = 0;

  bool batch_ready_locked(Clock::time_point now) const {
    if (pending.empty()) return false;
    if ((int)pending.size() >= max_batch) return true;
    auto oldest = pending.front().second;
    return std::chrono::duration_cast<std::chrono::microseconds>(now - oldest)
               .count() >= max_delay_us;
  }
};

}  // namespace

extern "C" {

void* ufm_batcher_create(int max_batch, int64_t max_delay_us, int capacity) {
  if (max_batch <= 0 || capacity < max_batch) return nullptr;
  return new Batcher(max_batch, max_delay_us, capacity);
}

// Wakes every waiter; later submits return -1 and next_batch drains what is
// pending, then returns -1. The caller joins the threads that may still be
// inside the batcher before it calls ufm_batcher_destroy.
void ufm_batcher_shutdown(void* handle) {
  auto* b = static_cast<Batcher*>(handle);
  {
    std::lock_guard<std::mutex> lock(b->mu);
    b->shutdown = true;
  }
  b->cv_dispatch.notify_all();
  b->cv_submit.notify_all();
}

void ufm_batcher_destroy(void* handle) {
  ufm_batcher_shutdown(handle);
  delete static_cast<Batcher*>(handle);
}

// Returns 0 on success, -1 if shutting down, -2 on timeout (queue full).
int ufm_batcher_submit(void* handle, uint64_t request_id, int64_t timeout_us) {
  auto* b = static_cast<Batcher*>(handle);
  std::unique_lock<std::mutex> lock(b->mu);
  auto deadline = Clock::now() + std::chrono::microseconds(timeout_us);
  while ((int)b->pending.size() >= b->capacity && !b->shutdown) {
    if (b->cv_submit.wait_until(lock, deadline) == std::cv_status::timeout)
      return -2;
  }
  if (b->shutdown) return -1;
  b->pending.emplace_back(request_id, Clock::now());
  b->submitted++;
  lock.unlock();
  b->cv_dispatch.notify_one();
  return 0;
}

// Fills out_ids (caller-allocated, >= max_batch). Returns the batch size,
// 0 on timeout, -1 on shutdown with an empty queue.
int ufm_batcher_next_batch(void* handle, uint64_t* out_ids, int64_t timeout_us) {
  auto* b = static_cast<Batcher*>(handle);
  std::unique_lock<std::mutex> lock(b->mu);
  auto deadline = Clock::now() + std::chrono::microseconds(timeout_us);

  while (true) {
    auto now = Clock::now();
    if (b->batch_ready_locked(now)) break;
    if (b->shutdown) {
      if (b->pending.empty()) return -1;
      break;  // drain remaining requests on shutdown
    }
    if (now >= deadline) return 0;
    // wake early enough to honor max_delay for the oldest pending request
    auto wake = deadline;
    if (!b->pending.empty()) {
      auto oldest_deadline =
          b->pending.front().second + std::chrono::microseconds(b->max_delay_us);
      if (oldest_deadline < wake) wake = oldest_deadline;
    }
    b->cv_dispatch.wait_until(lock, wake);
  }

  int n = 0;
  auto now = Clock::now();
  while (!b->pending.empty() && n < b->max_batch) {
    out_ids[n++] = b->pending.front().first;
    b->sum_wait_us += std::chrono::duration_cast<std::chrono::microseconds>(
                          now - b->pending.front().second)
                          .count();
    b->pending.pop_front();
  }
  b->dispatched += n;
  b->batches++;
  b->sum_batch_size += n;
  lock.unlock();
  b->cv_submit.notify_all();
  return n;
}

// out: [submitted, dispatched, batches, sum_batch_size, sum_wait_us, pending]
void ufm_batcher_stats(void* handle, uint64_t* out) {
  auto* b = static_cast<Batcher*>(handle);
  std::lock_guard<std::mutex> lock(b->mu);
  out[0] = b->submitted;
  out[1] = b->dispatched;
  out[2] = b->batches;
  out[3] = b->sum_batch_size;
  out[4] = b->sum_wait_us;
  out[5] = b->pending.size();
}

}  // extern "C"
