// Shared trace-event ring for the native host planes (hostcomm + ps).
//
// Each native engine keeps one process-wide bounded ring of fixed-size
// phase events (enqueue/start/chunk/retry/complete/error) stamped with
// CLOCK_MONOTONIC ns — the same clock Python's time.monotonic_ns() reads
// on Linux, so native events and Python spans merge onto one timeline
// without cross-clock gymnastics (torchmpi_tpu/obs/export.py).
//
// Discipline:
//   * drop-oldest on overflow, with a monotonic dropped counter — a slow
//     drainer loses the OLDEST history, never blocks the data path;
//   * trace-off is ONE relaxed atomic load + branch per emit call site,
//     so the default (obs_trace = False) costs nothing measurable on the
//     fast path;
//   * the 32-byte record layout is part of the C ABI: it is mirrored by
//     the numpy dtype in torchmpi_tpu/obs/native.py (EVENT_DTYPE) and
//     drained in bulk through tmpi_{hc,ps}_trace_drain.  Keep in sync.
#ifndef TORCHMPI_TPU_TRACE_H_
#define TORCHMPI_TPU_TRACE_H_

#include <time.h>

#include <atomic>
#include <cstdint>
#include <mutex>
#include <vector>

struct TmpiTraceEvent {
  uint64_t t_ns;         // CLOCK_MONOTONIC nanoseconds
  uint64_t correlation;  // caller-supplied id (0 = unattributed)
  uint64_t bytes;        // payload bytes of the op/chunk (0 where n/a)
  int32_t rank;          // comm rank (hostcomm) / peer id (ps) / -1
  uint8_t plane;         // TmpiTracePlane
  uint8_t op;            // engine-specific op code
  uint8_t phase;         // TmpiTracePhase
  uint8_t pad;
};
static_assert(sizeof(TmpiTraceEvent) == 32,
              "TmpiTraceEvent layout is mirrored by obs/native.py");

enum TmpiTracePlane : uint8_t { kTracePlaneHc = 0, kTracePlanePs = 1 };

enum TmpiTracePhase : uint8_t {
  kPhEnqueue = 0,   // async op accepted (ps offload pool)
  kPhStart = 1,     // op body begins
  kPhChunk = 2,     // one transfer piece / ring step moved
  kPhRetry = 3,     // a failed attempt is being retried (ps client)
  kPhComplete = 4,  // op body finished ok
  kPhError = 5,     // op failed (typed error recorded)
};

inline uint64_t tmpiMonotonicNs() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull +
         static_cast<uint64_t>(ts.tv_nsec);
}

class TmpiTraceRing {
 public:
  // capacity <= 0 keeps the current capacity (enable/disable only).
  // Resizing or DISABLING drops buffered events (the ring is a
  // diagnostic, not a log) — the ABI contract is that trace-off drains
  // return 0, so a later re-enable never resurrects a prior run's tail.
  void configure(bool enabled, int capacity) {
    std::lock_guard<std::mutex> lk(mu_);
    if (capacity > 0 && static_cast<size_t>(capacity) != cap_) {
      cap_ = static_cast<size_t>(capacity);
      buf_.assign(cap_, TmpiTraceEvent{});
      head_ = count_ = 0;
    }
    if (!enabled) head_ = count_ = 0;
    enabled_.store(enabled, std::memory_order_relaxed);
  }

  bool enabled() const { return enabled_.load(std::memory_order_relaxed); }

  // Cross-rank clock alignment (torchmpi_tpu/obs/clocksync.py): events are
  // stamped `monotonic - offset`, so N processes whose clocksync published
  // per-rank offsets against a common reference rank emit pre-aligned
  // timestamps and their drained rings merge without post-hoc shifting.
  // 0 (the default) keeps raw CLOCK_MONOTONIC — the seed behaviour.
  void setClockOffset(int64_t offset_ns) {
    clockOffsetNs_.store(offset_ns, std::memory_order_relaxed);
  }

  void emit(uint8_t plane, uint8_t op, uint8_t phase, int32_t rank,
            uint64_t bytes, uint64_t correlation) {
    if (!enabled()) return;  // the whole trace-off cost: one load + branch
    int64_t t = static_cast<int64_t>(tmpiMonotonicNs()) -
                clockOffsetNs_.load(std::memory_order_relaxed);
    // An offset exceeding this host's uptime would wrap the unsigned
    // field; clamp — a 0 stamp is visibly wrong, a wrapped one is not.
    TmpiTraceEvent ev{t > 0 ? static_cast<uint64_t>(t) : 0, correlation,
                      bytes, rank, plane, op, phase, 0};
    std::lock_guard<std::mutex> lk(mu_);
    // Re-check under the lock: a configure(false) that cleared the ring
    // while this emit waited on mu_ must win, or the event would land in
    // a disabled ring and resurface after a re-enable.
    if (!enabled()) return;
    if (buf_.empty()) buf_.assign(cap_, TmpiTraceEvent{});
    if (count_ == cap_) {  // full: drop the OLDEST event, count the loss
      head_ = (head_ + 1) % cap_;
      --count_;
      dropped_.fetch_add(1, std::memory_order_relaxed);
    }
    buf_[(head_ + count_) % cap_] = ev;
    ++count_;
  }

  // Copies up to max_events oldest-first into out and removes them.
  // Within one drain, timestamps are nondecreasing up to producer-side
  // interleaving (each event is stamped before it enters the ring).
  int drain(TmpiTraceEvent* out, int max_events) {
    if (!out || max_events <= 0) return 0;
    std::lock_guard<std::mutex> lk(mu_);
    int n = 0;
    while (n < max_events && count_ > 0) {
      out[n++] = buf_[head_];
      head_ = (head_ + 1) % cap_;
      --count_;
    }
    return n;
  }

  uint64_t dropped() const {
    return dropped_.load(std::memory_order_relaxed);
  }

 private:
  std::atomic<bool> enabled_{false};
  std::atomic<uint64_t> dropped_{0};
  std::atomic<int64_t> clockOffsetNs_{0};
  std::mutex mu_;
  std::vector<TmpiTraceEvent> buf_;
  size_t cap_ = 4096;
  size_t head_ = 0;
  size_t count_ = 0;
};

#endif  // TORCHMPI_TPU_TRACE_H_
