// Native host-side ring collectives for torchmpi_tpu.
//
// TPU-native equivalent of the reference's custom CPU p2p ring collectives
// and their communication plans (reference: lib/detail/collectives.cpp:27-326
// allreducep2p/broadcastp2p; plan generator lib/resources.cpp:588-678; the
// ring schedule documented in lib/detail/README.md:1-48).  On TPU pods the
// chips' collectives ride ICI through XLA; what remains native is the
// *host* plane: TPU-VM host processes coordinating over DCN — data-loader
// epochs, PS-adjacent reductions, metrics — without MPI.  Transport is TCP
// between ring neighbours only (each rank connects to next, accepts prev),
// exactly the neighbour-exchange shape of the reference's rings.
//
// Collectives (float32/float64/int32/int64, sum/max/min reductions) —
// the full host-plane set of the reference's CPU engine
// (lib/collectives.cpp:126-455):
//   allreduce   — chunked ring: p-1 reduce-scatter steps then p-1 allgather
//                 steps; chunk c of rank r at step s follows the reference's
//                 plan algebra (send (r-s) mod p, receive (r-s-1) mod p).
//                 Large messages sub-chunk each step by `chunk_bytes` so the
//                 incoming stream's reduction overlaps the transfer (the
//                 reference's buffer-size-bounded chunk loop,
//                 detail/collectives.cpp:128-326).
//   broadcast   — chunk-pipelined root -> ring walk (the reference's
//                 pipelined large-message path, detail/collectives.cpp:45-112);
//                 chunk geometry from `chunk_bytes` (0 = single chunk, the
//                 latency path standing in for the reference's tree mode).
//   reduce      — chunk-pipelined chain (root+1) -> ... -> root; each relay
//                 folds its contribution into the passing partial, root folds
//                 into its own buffer, non-root buffers stay untouched
//                 (reference reduce semantics, collectives.cpp:168-206).
//   sendreceive — sendrecv_replace routed src -> ... -> dst along the ring
//                 (reference: collectives.cpp sendreceive / Sendrecv_replace).
//   allgatherv  — two-phase: circulate per-rank counts, then circulate the
//                 variable-size chunks; the Python wrapper auto-resizes the
//                 output (reference: gatherv with auto-resize,
//                 collectives.cpp:245-290).
//   barrier     — two token laps.
//
// All blocking reads/writes carry a progress-warning interval
// (io_timeout_ms): a peer making no progress for that long prints a
// deadlock warning and keeps waiting — the host-plane analogue of the
// reference's spin-with-timeout deadlock detector ("this looks like a
// deadlock!", resources.cpp:124-133), which warns without aborting.
//
// Hardening beyond the reference (chaos-drill proven, runtime/chaos.py):
//   * io_deadline_ms > 0 turns the warner into an abort: a wait making NO
//     progress for that long fails the collective and records a typed
//     error (kErrTimeout) with rank/op/bytes-progressed context, readable
//     via tmpi_hc_last_error — Python raises HostcommTimeout.  0 keeps
//     the reference's warn-forever semantics exactly.
//   * frame_crc != 0 appends a CRC32 trailer to every data frame (each
//     logical transfer: a ring-step payload, a broadcast piece, a barrier
//     token) and verifies it on receive; a mismatch records kErrCorrupt
//     (HostcommCorruption) instead of silently reducing damaged bytes.
//     Off by default so the fast path is byte-identical to the seed.
//   * Any failure poisons the comm (byte streams may be desynced): later
//     collectives fail fast with the original recorded error instead of
//     reducing garbage.  Recovery is a fresh ring (run_elastic rebuilds).
//
// Instance-based (one RingComm per communicator) so a single test process
// can host all ranks on loopback — the mpirun -n K stand-in.  Per-step
// send/recv run concurrently (sender thread + receiver on the caller),
// which both avoids neighbour write-write deadlock and overlaps the two
// directions like the reference's Irecv/Issend pairs.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#include "bf16.h"
#include "crc32.h"
#include "trace.h"

namespace {

// Process-wide phase-event ring (observability plane, _native/trace.h):
// per-op start/chunk/complete/error events with rank, op, bytes, monotonic
// ns and the caller-supplied correlation id, drained over the C ABI
// (tmpi_hc_trace_drain).  Off by default (obs_trace knob) — emit() is one
// relaxed load + branch then.
TmpiTraceRing gHcTrace;

// Trace op codes, mirrored by obs/native.py:HC_OPS.
enum HcTraceOp : uint8_t {
  kTOpAllreduce = 1, kTOpBroadcast = 2, kTOpReduce = 3,
  kTOpSendreceive = 4, kTOpAllgather = 5, kTOpBarrier = 6,
};

// Typed failure codes surfaced at the C ABI (tmpi_hc_last_error) so the
// Python layer can raise HostcommTimeout / HostcommCorruption /
// HostcommError instead of one opaque RuntimeError.
enum HcErr : int {
  kErrNone = 0,
  kErrTimeout = 1,   // io_deadline_ms expired with no progress
  kErrCorrupt = 2,   // frame CRC32 trailer mismatch
  kErrClosed = 3,    // EOF / connection reset / socket error
};

enum Dtype : uint32_t { kF32 = 0, kF64 = 1, kI32 = 2, kI64 = 3, kBF16 = 4, kI8 = 5, kF16 = 6 };
enum Op : uint32_t { kSum = 0, kMax = 1, kMin = 2 };

size_t dtypeSize(uint32_t dt) {
  switch (dt) {
    case kF32: case kI32: return 4;
    case kF64: case kI64: return 8;
    case kBF16: case kF16: return 2;
    case kI8: return 1;
  }
  return 0;
}

template <typename T>
void reduceT(uint32_t op, T* dst, const T* src, size_t n) {
  switch (op) {
    case kSum: for (size_t i = 0; i < n; ++i) dst[i] += src[i]; break;
    case kMax: for (size_t i = 0; i < n; ++i) dst[i] = src[i] > dst[i] ? src[i] : dst[i]; break;
    case kMin: for (size_t i = 0; i < n; ++i) dst[i] = src[i] < dst[i] ? src[i] : dst[i]; break;
  }
}

// bf16 wire helpers: ONE shared definition (bf16.h).

void reduceBF16(uint32_t op, uint16_t* dst, const uint16_t* src, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float a = bf16ToF32(dst[i]), b = bf16ToF32(src[i]), r;
    switch (op) {
      case kSum: r = a + b; break;
      case kMax: r = b > a ? b : a; break;
      default:   r = b < a ? b : a; break;
    }
    dst[i] = f32ToBF16(r);
  }
}

void reduceF16(uint32_t op, uint16_t* dst, const uint16_t* src, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float a = f16ToF32(dst[i]), b = f16ToF32(src[i]), r;
    switch (op) {
      case kSum: r = a + b; break;
      case kMax: r = b > a ? b : a; break;
      default:   r = b < a ? b : a; break;
    }
    dst[i] = f32ToF16(r);
  }
}

void reduceI8(uint32_t op, int8_t* dst, const int8_t* src, size_t n) {
  switch (op) {
    case kSum:
      for (size_t i = 0; i < n; ++i) dst[i] = addSatI8(dst[i], src[i]);
      break;
    case kMax:
      for (size_t i = 0; i < n; ++i) dst[i] = src[i] > dst[i] ? src[i] : dst[i];
      break;
    default:
      for (size_t i = 0; i < n; ++i) dst[i] = src[i] < dst[i] ? src[i] : dst[i];
      break;
  }
}

void reduceInto(uint32_t op, uint32_t dt, void* dst, const void* src, size_t n) {
  switch (dt) {
    case kF32: reduceT(op, static_cast<float*>(dst), static_cast<const float*>(src), n); break;
    case kF64: reduceT(op, static_cast<double*>(dst), static_cast<const double*>(src), n); break;
    case kI32: reduceT(op, static_cast<int32_t*>(dst), static_cast<const int32_t*>(src), n); break;
    case kI64: reduceT(op, static_cast<int64_t*>(dst), static_cast<const int64_t*>(src), n); break;
    case kBF16: reduceBF16(op, static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src), n); break;
    case kF16: reduceF16(op, static_cast<uint16_t*>(dst), static_cast<const uint16_t*>(src), n); break;
    case kI8: reduceI8(op, static_cast<int8_t*>(dst), static_cast<const int8_t*>(src), n); break;
  }
}

// Chunk ranges: floor split + remainder spread, identical to the PS getRange
// (reference: parameterserver.cpp:282-294) and the plan chunking.
void getRange(size_t total, int p, int i, size_t* off, size_t* cnt) {
  size_t base = total / p, rem = total % p;
  *cnt = base + (static_cast<size_t>(i) < rem ? 1 : 0);
  *off = static_cast<size_t>(i) * base +
         (static_cast<size_t>(i) < rem ? static_cast<size_t>(i) : rem);
}

class RingComm {
 public:
  RingComm(int rank, int size, std::vector<std::pair<std::string, int>> endpoints,
           int ioTimeoutMs, int ioDeadlineMs, bool frameCrc)
      : rank_(rank), size_(size), endpoints_(std::move(endpoints)),
        ioTimeoutMs_(ioTimeoutMs), ioDeadlineMs_(ioDeadlineMs),
        frameCrc_(frameCrc) {}

  ~RingComm() {
    if (nextFd_ >= 0) ::close(nextFd_);
    if (prevFd_ >= 0) ::close(prevFd_);
    if (listenFd_ >= 0) ::close(listenFd_);
  }

  // Wire the ring: listen on our endpoint's port, accept the connection from
  // rank-1, connect (with retries, peers may start later) to rank+1.
  bool connectRing(int timeoutMs) {
    if (size_ == 1) return true;
    listenFd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    ::setsockopt(listenFd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(endpoints_[rank_].second));
    if (::bind(listenFd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
      return false;
    ::listen(listenFd_, 4);

    std::thread acceptor([this, timeoutMs] {
      // poll with a deadline so a missing prev-neighbour cannot hang the
      // join below past timeoutMs.
      pollfd pfd{listenFd_, POLLIN, 0};
      if (::poll(&pfd, 1, timeoutMs) <= 0) return;
      int fd = ::accept(listenFd_, nullptr, nullptr);
      if (fd >= 0) {
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        prevFd_ = fd;
      }
    });

    const auto& nxt = endpoints_[(rank_ + 1) % size_];
    int fd = -1;
    for (int waited = 0; waited < timeoutMs; waited += 50) {
      fd = ::socket(AF_INET, SOCK_STREAM, 0);
      sockaddr_in peer{};
      peer.sin_family = AF_INET;
      peer.sin_port = htons(static_cast<uint16_t>(nxt.second));
      ::inet_pton(AF_INET, nxt.first.c_str(), &peer.sin_addr);
      if (::connect(fd, reinterpret_cast<sockaddr*>(&peer), sizeof(peer)) == 0)
        break;
      ::close(fd);
      fd = -1;
      ::usleep(50 * 1000);
    }
    if (fd >= 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      nextFd_ = fd;
    }
    acceptor.join();
    // The listener exists only to wire prevFd_; close it as soon as the
    // ring is up.  Leaving it open lets a LATER ring over the same port
    // (elastic resize: survivors keep their ports) connect into this
    // ring's dead backlog — the kernel completes the handshake, nobody
    // ever accepts, and the new ring's wire times out.
    if (nextFd_ >= 0 && prevFd_ >= 0) {
      ::close(listenFd_);
      listenFd_ = -1;
    }
    return nextFd_ >= 0 && prevFd_ >= 0;
  }

  // ------------------------------------------------------------- typed I/O
  //
  // One error record per comm; the FIRST failure wins (later ones are
  // symptoms of the first: a timed-out peer manifests as resets/desyncs
  // downstream) and poisons the comm so later collectives fail fast.

  void recordError(int code, const char* what) {
    char buf[320];
    const char* kind = code == kErrTimeout  ? "deadline exceeded"
                       : code == kErrCorrupt ? "frame CRC32 mismatch"
                                             : "connection failed";
    if (code == kErrTimeout) {
      std::snprintf(buf, sizeof(buf),
                    "hostcomm %s: no %s progress for %d ms "
                    "(hc_io_deadline_ms) on rank %d/%d during %s, "
                    "%llu bytes progressed this op",
                    kind, what, ioDeadlineMs_, rank_, size_, op_,
                    static_cast<unsigned long long>(opProgressed_.load()));
    } else {
      std::snprintf(buf, sizeof(buf),
                    "hostcomm %s (%s) on rank %d/%d during %s, "
                    "%llu bytes progressed this op",
                    kind, what, rank_, size_, op_,
                    static_cast<unsigned long long>(opProgressed_.load()));
    }
    gHcTrace.emit(kTracePlaneHc, opCode_, kPhError, rank_,
                  opProgressed_.load(),
                  correlation_.load(std::memory_order_relaxed));
    std::lock_guard<std::mutex> lk(errMu_);
    poisoned_.store(true);
    if (errCode_ == kErrNone) {
      errCode_ = code;
      errMsg_ = buf;
    }
  }

  int lastError(char* buf, int buflen) {
    std::lock_guard<std::mutex> lk(errMu_);
    if (buf && buflen > 0) {
      std::snprintf(buf, static_cast<size_t>(buflen), "%s", errMsg_.c_str());
    }
    return errCode_;
  }

  // Collective prologue: refuse on a poisoned comm (original error kept),
  // else stamp the op context the error messages carry and emit the
  // kPhStart trace event.
  bool beginOp(const char* op, uint8_t code) {
    if (poisoned_.load()) return false;
    op_ = op;
    opCode_ = code;
    opBegan_ = true;
    opProgressed_.store(0);
    gHcTrace.emit(kTracePlaneHc, code, kPhStart, rank_, 0,
                  correlation_.load(std::memory_order_relaxed));
    return true;
  }

  // Collective epilogue for the C wrappers: a successful op emits
  // kPhComplete with the bytes it moved; failures already emitted
  // kPhError from recordError.  No event when the op never reached
  // beginOp — a poisoned-comm fast-fail (the original error event
  // stands) or a size-1 comm's trivial early return.
  void traceOpEnd(bool ok) {
    if (ok && opBegan_)
      gHcTrace.emit(kTracePlaneHc, opCode_, kPhComplete, rank_,
                    opProgressed_.load(),
                    correlation_.load(std::memory_order_relaxed));
    opBegan_ = false;
  }

  // Caller-supplied correlation id stamped onto this comm's subsequent
  // trace events; the Python span tracer sets it (on the comm's worker
  // thread, before the op) so native frames join the dispatching span.
  void setCorrelation(uint64_t corr) {
    correlation_.store(corr, std::memory_order_relaxed);
  }

  // Full read/write with BOTH clocks: the warn interval (ioTimeoutMs_)
  // prints the reference's deadlock diagnostic and keeps waiting; the hard
  // deadline (ioDeadlineMs_) measures time with NO progress and aborts —
  // each transferred byte resets it, so long healthy transfers never trip
  // it.  Either clock <= 0 disables that behaviour (the seed fast path is
  // ioDeadlineMs_ == 0).
  bool ioRead(int fd, void* buf, size_t n) {
    return ioFull(fd, buf, n, /*isRead=*/true);
  }
  bool ioWrite(int fd, const void* buf, size_t n) {
    return ioFull(fd, const_cast<void*>(buf), n, /*isRead=*/false);
  }

  bool ioFull(int fd, void* buf, size_t n, bool isRead) {
    char* p = static_cast<char*>(buf);
    const char* what = isRead ? "recv" : "send";
    int idleMs = 0;    // since last progress — the deadline clock
    int warnMs = 0;    // since last warning — the diagnostic clock
    while (n > 0) {
      int waitMs = -1;
      if (ioTimeoutMs_ > 0) waitMs = ioTimeoutMs_ - warnMs;
      if (ioDeadlineMs_ > 0) {
        int rem = ioDeadlineMs_ - idleMs;
        if (rem <= 0) {
          recordError(kErrTimeout, what);
          return false;
        }
        if (waitMs < 0 || rem < waitMs) waitMs = rem;
      }
      pollfd pfd{fd, static_cast<short>(isRead ? POLLIN : POLLOUT), 0};
      int rc = ::poll(&pfd, 1, waitMs);
      if (rc < 0) {
        recordError(kErrClosed, what);
        return false;
      }
      if (rc == 0) {
        idleMs += waitMs;
        warnMs += waitMs;
        if (ioTimeoutMs_ > 0 && warnMs >= ioTimeoutMs_) {
          std::fprintf(stderr,
                       "[torchmpi_tpu hostcomm] no %s progress for %d ms -- "
                       "this looks like a deadlock! (still waiting)\n",
                       what, idleMs);
          warnMs = 0;
        }
        continue;
      }
      ssize_t r = isRead ? ::read(fd, p, n) : ::write(fd, p, n);
      if (r <= 0) {
        recordError(kErrClosed, what);
        return false;
      }
      p += r;
      n -= static_cast<size_t>(r);
      opProgressed_.fetch_add(static_cast<uint64_t>(r));
      idleMs = 0;
      warnMs = 0;
    }
    return true;
  }

  // Frame = one logical transfer.  With frameCrc_ the sender appends a
  // CRC32 trailer and the receiver verifies it (incrementally for chunked
  // receives — checkCrc consumes the trailer and compares).
  bool sendFrame(int fd, const void* buf, size_t n) {
    if (!ioWrite(fd, buf, n)) return false;
    if (frameCrc_) {
      uint32_t crc = crc32Of(buf, n);
      if (!ioWrite(fd, &crc, sizeof(crc))) return false;
    }
    return true;
  }

  bool checkCrc(int fd, uint32_t acc) {
    if (!frameCrc_) return true;
    uint32_t wire = 0;
    if (!ioRead(fd, &wire, sizeof(wire))) return false;
    if (wire != crc32Final(acc)) {
      recordError(kErrCorrupt, "recv");
      return false;
    }
    return true;
  }

  bool recvFrame(int fd, void* buf, size_t n) {
    if (!ioRead(fd, buf, n)) return false;
    if (!frameCrc_) return true;
    return checkCrc(fd, crc32Update(kCrc32Init, buf, n));
  }

  // One ring step: send [sOff, sOff+sCnt) to next while receiving
  // [into scratch] from prev — the Irecv/Issend pair of the reference ring.
  // When reduce-on-the-fly args are given, the incoming stream is consumed
  // in sub-pieces of chunkBytes and each piece is reduced as soon as it
  // lands, overlapping reduction with the rest of the transfer.
  bool step(const char* sendBuf, size_t sendBytes, char* recvBuf, size_t recvBytes,
            uint32_t dt = kF32, uint32_t op = kSum, char* reduceDst = nullptr,
            size_t chunkBytes = 0) {
    std::atomic<bool> sendOk{true};
    std::thread sender([&] {
      if (sendBytes && !sendFrame(nextFd_, sendBuf, sendBytes))
        sendOk = false;
    });
    bool recvOk = true;
    const size_t esz = dtypeSize(dt);
    size_t piece = (chunkBytes && reduceDst) ? chunkBytes : recvBytes;
    uint32_t crcAcc = kCrc32Init;
    for (size_t done = 0; recvOk && done < recvBytes; done += piece) {
      size_t now = recvBytes - done < piece ? recvBytes - done : piece;
      recvOk = ioRead(prevFd_, recvBuf + done, now);
      if (recvOk && frameCrc_)
        crcAcc = crc32Update(crcAcc, recvBuf + done, now);
      if (recvOk && reduceDst)
        reduceInto(op, dt, reduceDst + done, recvBuf + done, now / esz);
    }
    if (recvOk && recvBytes) recvOk = checkCrc(prevFd_, crcAcc);
    sender.join();
    bool ok = sendOk.load() && recvOk;
    if (ok)
      gHcTrace.emit(kTracePlaneHc, opCode_, kPhChunk, rank_,
                    sendBytes + recvBytes,
                    correlation_.load(std::memory_order_relaxed));
    return ok;
  }

  // Chunk event for the piece-loop collectives (broadcast/reduce/
  // sendreceive move frames directly, not through step()).
  void traceChunk(uint64_t bytes) {
    gHcTrace.emit(kTracePlaneHc, opCode_, kPhChunk, rank_, bytes,
                  correlation_.load(std::memory_order_relaxed));
  }

  bool allreduce(void* data, size_t count, uint32_t dt, uint32_t op,
                 size_t chunkBytes) {
    if (size_ == 1) return true;
    if (!beginOp("allreduce", kTOpAllreduce)) return false;
    const size_t esz = dtypeSize(dt);
    char* base = static_cast<char*>(data);
    const int p = size_;
    std::vector<char> scratch;

    // Phase 1: reduce-scatter.  After p-1 steps rank r owns the full
    // reduction of chunk (r+1) mod p (reference plan: resources.cpp:588-678).
    for (int s = 0; s < p - 1; ++s) {
      int sendChunk = (rank_ - s + p) % p;
      int recvChunk = (rank_ - s - 1 + 2 * p) % p;
      size_t sOff, sCnt, rOff, rCnt;
      getRange(count, p, sendChunk, &sOff, &sCnt);
      getRange(count, p, recvChunk, &rOff, &rCnt);
      scratch.resize(rCnt * esz);
      if (!step(base + sOff * esz, sCnt * esz, scratch.data(), rCnt * esz,
                dt, op, base + rOff * esz, chunkBytes))
        return false;
    }
    // Phase 2: allgather the reduced chunks around the ring.
    for (int s = 0; s < p - 1; ++s) {
      int sendChunk = (rank_ + 1 - s + 2 * p) % p;
      int recvChunk = (rank_ - s + 2 * p) % p;
      size_t sOff, sCnt, rOff, rCnt;
      getRange(count, p, sendChunk, &sOff, &sCnt);
      getRange(count, p, recvChunk, &rOff, &rCnt);
      if (!step(base + sOff * esz, sCnt * esz, base + rOff * esz, rCnt * esz))
        return false;
    }
    return true;
  }

  bool broadcast(void* data, size_t count, uint32_t dt, int root,
                 size_t chunkBytes) {
    if (size_ == 1) return true;
    if (!beginOp("broadcast", kTOpBroadcast)) return false;
    const size_t esz = dtypeSize(dt);
    char* base = static_cast<char*>(data);
    const int p = size_;
    // Pipelined chunk walk root -> ... -> root-1 (reference:
    // detail/collectives.cpp:45-112 chunked pipeline over rank order).
    // Chunk count follows the caller's buffer geometry: one chunk is the
    // latency path (the tree-mode stand-in on a neighbour-wired ring),
    // buffer-size chunks pipeline large messages.
    bool isRoot = rank_ == root;
    bool isTail = (root - 1 + p) % p == rank_;
    size_t totalBytes = count * esz;
    size_t piece = chunkBytes ? chunkBytes : totalBytes;
    for (size_t off = 0; off < totalBytes; off += piece) {
      size_t now = totalBytes - off < piece ? totalBytes - off : piece;
      if (isRoot) {
        if (!sendFrame(nextFd_, base + off, now)) return false;
      } else {
        if (!recvFrame(prevFd_, base + off, now)) return false;
        if (!isTail && !sendFrame(nextFd_, base + off, now))
          return false;
      }
      traceChunk(now);
    }
    return true;
  }

  // Reduce-to-root: chunk-pipelined chain (root+1) -> ... -> root.  Each
  // relay folds its own contribution into the passing partial; only root's
  // buffer is modified (reference: reduce, collectives.cpp:168-206).
  bool reduce(void* data, size_t count, uint32_t dt, uint32_t op, int root,
              size_t chunkBytes) {
    if (size_ == 1) return true;
    if (!beginOp("reduce", kTOpReduce)) return false;
    const size_t esz = dtypeSize(dt);
    char* base = static_cast<char*>(data);
    const int p = size_;
    const int head = (root + 1) % p;
    size_t totalBytes = count * esz;
    size_t piece = chunkBytes ? chunkBytes : totalBytes;
    std::vector<char> scratch(rank_ == head ? 0 : std::min(piece, totalBytes));
    for (size_t off = 0; off < totalBytes; off += piece) {
      size_t now = totalBytes - off < piece ? totalBytes - off : piece;
      if (rank_ == head) {
        if (!sendFrame(nextFd_, base + off, now)) return false;
      } else if (rank_ == root) {
        scratch.resize(now);
        if (!recvFrame(prevFd_, scratch.data(), now)) return false;
        reduceInto(op, dt, base + off, scratch.data(), now / esz);
      } else {
        scratch.resize(now);
        if (!recvFrame(prevFd_, scratch.data(), now)) return false;
        reduceInto(op, dt, scratch.data(), base + off, now / esz);
        if (!sendFrame(nextFd_, scratch.data(), now)) return false;
      }
      traceChunk(now);
    }
    return true;
  }

  // sendrecv_replace: dst's buffer becomes src's; routed src -> ... -> dst
  // along the ring; other ranks relay or idle (reference: sendreceive,
  // collectives.cpp / Sendrecv_replace).
  bool sendreceive(void* data, size_t count, uint32_t dt, int src, int dst,
                   size_t chunkBytes) {
    if (size_ == 1 || src == dst) return true;
    if (!beginOp("sendreceive", kTOpSendreceive)) return false;
    const size_t esz = dtypeSize(dt);
    char* base = static_cast<char*>(data);
    const int p = size_;
    // Am I on the forward path src -> dst (exclusive of endpoints)?
    int distSrcMe = (rank_ - src + p) % p;
    int distSrcDst = (dst - src + p) % p;
    bool onPath = distSrcMe > 0 && distSrcMe < distSrcDst;
    size_t totalBytes = count * esz;
    size_t piece = chunkBytes ? chunkBytes : totalBytes;
    std::vector<char> scratch(onPath ? std::min(piece, totalBytes) : 0);
    for (size_t off = 0; off < totalBytes; off += piece) {
      size_t now = totalBytes - off < piece ? totalBytes - off : piece;
      if (rank_ == src) {
        if (!sendFrame(nextFd_, base + off, now)) return false;
      } else if (rank_ == dst) {
        if (!recvFrame(prevFd_, base + off, now)) return false;
      } else if (onPath) {
        scratch.resize(now);
        if (!recvFrame(prevFd_, scratch.data(), now)) return false;
        if (!sendFrame(nextFd_, scratch.data(), now)) return false;
      }
      if (rank_ == src || rank_ == dst || onPath) traceChunk(now);
    }
    return true;
  }

  // Phase 1 of allgatherv: circulate per-rank element counts so every rank
  // learns the (possibly unequal) contribution sizes — what lets the Python
  // wrapper auto-resize the output (reference: gatherv auto-resize,
  // collectives.cpp:245-290).
  bool exchangeCounts(uint64_t myCount, uint64_t* counts) {
    const int p = size_;
    counts[rank_] = myCount;
    if (p == 1) return true;
    if (!beginOp("allgather", kTOpAllgather)) return false;
    for (int s = 0; s < p - 1; ++s) {
      int sendIdx = (rank_ - s + p) % p;
      int recvIdx = (rank_ - s - 1 + 2 * p) % p;
      if (!step(reinterpret_cast<char*>(&counts[sendIdx]), sizeof(uint64_t),
                reinterpret_cast<char*>(&counts[recvIdx]), sizeof(uint64_t)))
        return false;
    }
    return true;
  }

  // Phase 2: circulate the variable-size chunks.  recv must hold
  // sum(counts) elements; on return it is the rank-order concatenation.
  bool allgatherv(const void* send, uint64_t myCount, const uint64_t* counts,
                  void* recv, uint32_t dt) {
    if (size_ > 1 && !beginOp("allgather", kTOpAllgather)) return false;
    const size_t esz = dtypeSize(dt);
    const int p = size_;
    std::vector<size_t> offs(p, 0);
    for (int i = 1; i < p; ++i) offs[i] = offs[i - 1] + counts[i - 1];
    char* out = static_cast<char*>(recv);
    std::memcpy(out + offs[rank_] * esz, send, myCount * esz);
    for (int s = 0; s < p - 1; ++s) {
      int sendIdx = (rank_ - s + p) % p;
      int recvIdx = (rank_ - s - 1 + 2 * p) % p;
      if (!step(out + offs[sendIdx] * esz, counts[sendIdx] * esz,
                out + offs[recvIdx] * esz, counts[recvIdx] * esz))
        return false;
    }
    return true;
  }

  bool barrier() {
    if (size_ == 1) return true;
    if (!beginOp("barrier", kTOpBarrier)) return false;
    // Two token laps: after lap one everyone has entered; after lap two
    // everyone knows everyone has (reference's two half-barriers,
    // resources.h:285-299).
    for (int lap = 0; lap < 2; ++lap) {
      char tok = 1;
      if (rank_ == 0) {
        if (!sendFrame(nextFd_, &tok, 1)) return false;
        if (!recvFrame(prevFd_, &tok, 1)) return false;
      } else {
        if (!recvFrame(prevFd_, &tok, 1)) return false;
        if (!sendFrame(nextFd_, &tok, 1)) return false;
      }
    }
    return true;
  }

 private:
  int rank_, size_;
  std::vector<std::pair<std::string, int>> endpoints_;
  int ioTimeoutMs_ = -1;
  int ioDeadlineMs_ = 0;
  bool frameCrc_ = false;
  int listenFd_ = -1;
  int nextFd_ = -1;
  int prevFd_ = -1;
  // Error record + poison flag (see recordError).  op_ is written only by
  // the comm's single in-flight collective before its sender thread spawns.
  std::mutex errMu_;
  int errCode_ = kErrNone;
  std::string errMsg_;
  std::atomic<bool> poisoned_{false};
  const char* op_ = "(none)";
  // opCode_ is written only by beginOp (the comm's single in-flight
  // collective, like op_); correlation_ is atomic because the Python
  // layer may stamp it from the dispatching thread.
  uint8_t opCode_ = 0;
  bool opBegan_ = false;
  std::atomic<uint64_t> correlation_{0};
  std::atomic<uint64_t> opProgressed_{0};
};

std::mutex gMu;
std::map<int, std::shared_ptr<RingComm>> gComms;
int gNext = 1;

// shared_ptr so tmpi_hc_free during an in-flight collective on another
// thread cannot destroy the comm under it.
std::shared_ptr<RingComm> find(int id) {
  std::lock_guard<std::mutex> lk(gMu);
  auto it = gComms.find(id);
  return it == gComms.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

// endpoints: "host:port,host:port,..." in rank order.  Returns comm id > 0
// once the ring is wired (neighbour connections up), or -1.  io_timeout_ms
// is the per-wait progress-warning interval (the deadlock detector warns
// and keeps waiting); <= 0 waits silently.  io_deadline_ms > 0 adds a hard
// no-progress deadline per blocking wait (typed kErrTimeout on expiry); 0
// keeps warn-forever.  frame_crc != 0 enables the CRC32 data-frame
// trailers (must match on every rank of the ring — the knob is shared
// config, runtime/config.py:hc_frame_crc).
int tmpi_hc_create(int rank, int size, const char* endpoints, int timeout_ms,
                   int io_timeout_ms, int io_deadline_ms, int frame_crc) {
  std::vector<std::pair<std::string, int>> eps;
  std::string s(endpoints ? endpoints : "");
  size_t pos = 0;
  while (pos < s.size()) {
    size_t comma = s.find(',', pos);
    if (comma == std::string::npos) comma = s.size();
    std::string item = s.substr(pos, comma - pos);
    size_t colon = item.rfind(':');
    if (colon == std::string::npos) return -1;
    int port;
    try {
      port = std::stoi(item.substr(colon + 1));
    } catch (const std::exception&) {
      return -1;  // never let a C++ exception cross the C ABI into ctypes
    }
    // A port outside uint16 range would otherwise truncate silently in
    // the htons(static_cast<uint16_t>) below and wire to the wrong peer.
    if (port <= 0 || port > 65535) return -1;
    eps.emplace_back(item.substr(0, colon), port);
    pos = comma + 1;
  }
  if (static_cast<int>(eps.size()) != size || rank < 0 || rank >= size) return -1;
  auto comm = std::make_shared<RingComm>(rank, size, std::move(eps),
                                         io_timeout_ms, io_deadline_ms,
                                         frame_crc != 0);
  if (!comm->connectRing(timeout_ms)) return -1;
  std::lock_guard<std::mutex> lk(gMu);
  int id = gNext++;
  gComms[id] = std::move(comm);
  return id;
}

void tmpi_hc_free(int id) {
  std::lock_guard<std::mutex> lk(gMu);
  gComms.erase(id);
}

int tmpi_hc_allreduce(int id, void* data, uint64_t count, uint32_t dtype,
                      uint32_t op, uint64_t chunk_bytes) {
  std::shared_ptr<RingComm> c = find(id);
  if (!c) return 0;
  bool ok = c->allreduce(data, count, dtype, op, chunk_bytes);
  c->traceOpEnd(ok);
  return ok ? 1 : 0;
}

int tmpi_hc_broadcast(int id, void* data, uint64_t count, uint32_t dtype,
                      int root, uint64_t chunk_bytes) {
  std::shared_ptr<RingComm> c = find(id);
  if (!c) return 0;
  bool ok = c->broadcast(data, count, dtype, root, chunk_bytes);
  c->traceOpEnd(ok);
  return ok ? 1 : 0;
}

int tmpi_hc_reduce(int id, void* data, uint64_t count, uint32_t dtype,
                   uint32_t op, int root, uint64_t chunk_bytes) {
  std::shared_ptr<RingComm> c = find(id);
  if (!c) return 0;
  bool ok = c->reduce(data, count, dtype, op, root, chunk_bytes);
  c->traceOpEnd(ok);
  return ok ? 1 : 0;
}

int tmpi_hc_sendreceive(int id, void* data, uint64_t count, uint32_t dtype,
                        int src, int dst, uint64_t chunk_bytes) {
  std::shared_ptr<RingComm> c = find(id);
  if (!c) return 0;
  bool ok = c->sendreceive(data, count, dtype, src, dst, chunk_bytes);
  c->traceOpEnd(ok);
  return ok ? 1 : 0;
}

int tmpi_hc_exchange_counts(int id, uint64_t my_count, uint64_t* counts) {
  std::shared_ptr<RingComm> c = find(id);
  if (!c) return 0;
  bool ok = c->exchangeCounts(my_count, counts);
  c->traceOpEnd(ok);
  return ok ? 1 : 0;
}

int tmpi_hc_allgatherv(int id, const void* send, uint64_t my_count,
                       const uint64_t* counts, void* recv, uint32_t dtype) {
  std::shared_ptr<RingComm> c = find(id);
  if (!c) return 0;
  bool ok = c->allgatherv(send, my_count, counts, recv, dtype);
  c->traceOpEnd(ok);
  return ok ? 1 : 0;
}

int tmpi_hc_barrier(int id) {
  std::shared_ptr<RingComm> c = find(id);
  if (!c) return 0;
  bool ok = c->barrier();
  c->traceOpEnd(ok);
  return ok ? 1 : 0;
}

// The comm's recorded failure: returns the HcErr code (0 none, 1 deadline
// timeout, 2 frame CRC mismatch, 3 connection closed/reset) and copies the
// human-readable message (rank/op/bytes-progressed context) into buf.  The
// FIRST failure is sticky — the comm is poisoned and later collectives
// fail fast with this record; recovery is a fresh comm.
int tmpi_hc_last_error(int id, char* buf, int buflen) {
  std::shared_ptr<RingComm> c = find(id);
  if (!c) {
    if (buf && buflen > 0) std::snprintf(buf, static_cast<size_t>(buflen),
                                         "unknown hostcomm id %d", id);
    return kErrClosed;
  }
  return c->lastError(buf, buflen);
}

// --- observability plane (_native/trace.h; Python side: torchmpi_tpu/obs) ---

// Enable/disable the process-wide trace ring and (capacity > 0) resize it;
// resizing drops buffered events.  Off by default: with tracing off every
// emit site is one relaxed atomic load + branch, so the fast path is
// byte-identical in cost to the pre-trace engine (runtime/config.py:
// obs_trace / obs_trace_ring_capacity, pushed by obs/native.apply_config).
void tmpi_hc_set_trace(int enabled, int capacity) {
  gHcTrace.configure(enabled != 0, capacity);
}

// Drain up to max_events oldest-first into out (an array of the 32-byte
// records documented in trace.h; obs/native.py:EVENT_DTYPE mirrors the
// layout).  Returns the number of events copied; the ring forgets them.
// With tracing off (or nothing buffered) this returns 0.
int tmpi_hc_trace_drain(void* out, int max_events) {
  return gHcTrace.drain(static_cast<TmpiTraceEvent*>(out), max_events);
}

// Monotonic count of events the ring dropped (drop-oldest on overflow) —
// a nonzero delta between drains means the timeline has a hole, size it
// accordingly (obs_trace_ring_capacity) or drain more often.
uint64_t tmpi_hc_trace_dropped() {
  return gHcTrace.dropped();
}

// Stamp the correlation id carried by this comm's subsequent trace events
// (0 clears).  The Python span tracer calls this on the comm's worker
// thread before each collective, so the native frames of an op share the
// dispatching span's id.
void tmpi_hc_set_correlation(int id, uint64_t correlation) {
  std::shared_ptr<RingComm> c = find(id);
  if (c) c->setCorrelation(correlation);
}

// Cross-rank clock alignment: subsequent trace events are stamped
// `CLOCK_MONOTONIC - offset_ns`, the common reference-rank timeline the
// clocksync exchange estimated (obs/clocksync.py publishes per-rank
// offsets; obs/clocksync.apply pushes them here).  0 restores raw
// monotonic stamps.
void tmpi_hc_set_clock_offset(int64_t offset_ns) {
  gHcTrace.setClockOffset(offset_ns);
}

}  // extern "C"
