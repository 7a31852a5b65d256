// Native parameter-server engine for torchmpi_tpu.
//
// TPU-native equivalent of the reference's C++ DistributedParameterServer
// (reference: lib/parameterserver.cpp:241-663): per-tensor sharding across
// hosts, each host owns a malloc'd local shard, a background server thread
// applies update rules (zero/copy/add, reference :119-213) to shards on
// client pushes and ships shards back on client pulls.
//
// Transport re-design: the reference rides MPI point-to-point tags with
// Isend(rule)+Ssend(data) for pushes and Irecv+1-byte-trigger Sends for pulls
// (reference :309-400).  On TPU pods the parameter server stays CPU-side by
// design (reference docs/parameterserver.md:1-3) and inter-host traffic rides
// DCN, so the transport here is framed TCP between host processes:
//   PUSH  = header{instance, rule, offset, count, dtype} + payload, ACKed
//           only after the rule has been applied -- the Ssend happens-before
//           guarantee the reference relies on (parameterserver.cpp:340-347).
//   PULL  = header only; server replies with its shard bytes -- the
//           trigger-then-reply protocol of clientReceive (:356-400).
// Client operations are offloaded to a small thread pool and synchronized
// through integer future handles, mirroring the PS offload pool +
// ParameterServerSynchronizationHandle (reference: lib/resources.cpp:399-434,
// :1225-1242).
//
// Exposed as a flat extern "C" ABI (ctypes-friendly), the analogue of the
// reference's torchmpi_parameterserver_* C surface (parameterserver.cpp:674-755).

#include <arpa/inet.h>
#include <dirent.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cerrno>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <future>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <set>
#include <string>
#include <thread>
#include <typeinfo>
#include <vector>
#include "bf16.h"
#include "crc32.h"
#include "trace.h"

// Server-side exceptions swallowed by serveConnection's guard (each one
// dropped a client connection); readable via
// tmpi_ps_server_exception_count() so server bugs stop hiding behind
// silent client drops.
static std::atomic<uint64_t> g_serverExceptions{0};

// Client resilience counters + knobs (tmpi_ps_retry_count /
// tmpi_ps_timeout_count / tmpi_ps_crc_failure_count and their setters):
// process-wide observables in the tmpi_ps_server_exception_count mould, so
// chaos drills and monitors can see retries happening instead of inferring
// them from latency.  Knobs mirror runtime/config.py's ps_retry_* /
// ps_request_deadline_ms / ps_frame_crc taxonomy (plumbed by
// parameterserver/native.py).
static std::atomic<uint64_t> g_retryCount{0};     // re-attempts after a failure
static std::atomic<uint64_t> g_timeoutCount{0};   // expired request deadlines
static std::atomic<uint64_t> g_crcFailCount{0};   // client-detected CRC faults

// Durability + failover observables (tmpi_ps_snapshot_* / epoch-fence
// counters at the C ABI; scraped into the metrics registry by
// obs/metrics.scrape_native alongside the retry/timeout/CRC peepholes).
static std::atomic<uint64_t> g_snapshotCount{0};       // snapshot files landed
static std::atomic<uint64_t> g_snapshotErrorCount{0};  // failed snapshot writes
static std::atomic<uint64_t> g_snapshotRestoreCount{0};  // successful restores
static std::atomic<uint64_t> g_snapshotTornCount{0};   // files REJECTED by
                                                       // restore validation
static std::atomic<uint64_t> g_epochFenceCount{0};     // pushes NACKed stale
static std::atomic<uint64_t> g_clientFencedCount{0};   // fenced NACKs SEEN by
                                                       // this process's client
                                                       // (the server-side
                                                       // counter lives in the
                                                       // server's process)
// Replication + handoff observables (tmpi_ps_forward_count /
// tmpi_ps_handoff_count etc. at the C ABI; scraped into the metrics
// registry as tmpi_ps_forward_total / tmpi_ps_handoff_total ...).  A
// forward "error" is any frame that provably did NOT land on the backup
// (send/ack failure, queue overflow drop, frames abandoned at stop) —
// replication is async best-effort by design, and every gap is repaired
// by the seeder's shadow re-seed at promotion (docs/parameterserver.md
// "Replication & shard placement").
static std::atomic<uint64_t> g_forwardCount{0};       // frames landed on backup
static std::atomic<uint64_t> g_forwardErrorCount{0};  // frames provably lost
static std::atomic<uint64_t> g_handoffCount{0};       // completed shard ships
static std::atomic<uint64_t> g_handoffTornCount{0};   // ships that failed
                                                      // mid-stream (old owner
                                                      // stays un-drained)
// Bound (items) on each server's pending-forward queue; overflow drops
// the OLDEST frame (counted as a forward error).  runtime/config.py:
// ps_forward_queue_max, plumbed by native.apply_config.
static std::atomic<int> g_forwardQueueMax{1024};

// Cadence of the background snapshot writer (runtime/config.py:
// ps_snapshot_interval_ms, plumbed by native.apply_config); 0 = on-demand
// tmpi_ps_snapshot only.  Read by the writer each cycle, so config changes
// take effect on running servers.
static std::atomic<int> g_snapshotIntervalMs{0};
// Drill seam (tmpi_ps_set_snapshot_crash_point): countdown of snapshot
// writes until the process _exit(137)s BETWEEN the tmp-file fsync and the
// atomic rename — the exact torn-file window the restore fallback exists
// for.  Armed to N, the Nth snapshot write dies mid-rename; 0 = disarmed.
static std::atomic<int> g_snapshotCrashNth{0};

// Observability plane (_native/trace.h): process-wide phase-event ring
// (enqueue/start/retry/complete/error per client op, with peer id, bytes,
// monotonic ns, correlation id) drained over tmpi_ps_trace_drain.  The
// correlation id is caller-supplied: g_psCorrelation is stamped by the
// Python span tracer before a client op; async ops capture it at enqueue
// and pass it explicitly down the request path (the `corr` parameters) so
// the pooled request's events still join the span that dispatched it.
// NOT a thread_local replay: this .so is dlopen'd (ctypes), and a
// thread_local written by a pool worker lives in a dynamic TLS block that
// glibc frees in uninstrumented ld.so code at thread teardown — TSAN
// reports that free as racing the worker's last write.
static TmpiTraceRing g_psTrace;
static std::atomic<uint64_t> g_psCorrelation{0};

// Trace op codes, mirrored by obs/native.py:PS_OPS.
enum PsTraceOp : uint8_t {
  kTOpCreate = 1, kTOpPush = 2, kTOpPull = 3, kTOpFreeInstance = 4,
  kTOpFreeAll = 5, kTOpPing = 6, kTOpSnapshot = 7, kTOpRestore = 8,
  kTOpEpoch = 9, kTOpHandoff = 10, kTOpForward = 11, kTOpPlacement = 12,
};

static uint64_t psCorr() {
  return g_psCorrelation.load(std::memory_order_relaxed);
}
static std::atomic<int> g_retryMax{4};            // attempts per request
static std::atomic<int> g_backoffMs{50};          // exp backoff base
static std::atomic<int> g_backoffMaxMs{2000};     // exp backoff cap
static std::atomic<int> g_deadlineMs{0};          // per-request socket deadline
static std::atomic<bool> g_frameCrc{false};       // CRC32 frame trailers

namespace {

// ----------------------------------------------------------------- protocol

constexpr uint32_t kMagic = 0x54505053;     // "TPPS": plain frames
// "TPPC": this request's payload carries a CRC32 trailer and the client
// wants the pull reply trailed too.  Chosen PER REQUEST by the client
// (g_frameCrc); the server accepts both magics, so crc-on and crc-off
// clients interoperate with any server.
constexpr uint32_t kMagicCrc = 0x54505043;

// Push ack values.  kAckCrcRetry means the server detected a CRC mismatch
// on the push payload and did NOT run the rule — re-sending is safe even
// for rule=add, so the client retries it regardless of idempotency.
// kAckEpochFenced means the push carried a nonzero epoch that is not the
// server's serving epoch (the server restarted from a snapshot since the
// client registered) and the rule did NOT run: the client must re-learn
// the epoch, re-register, and re-seed via idempotent `copy` before
// replaying — the exactly-once contract for rule=add across a server
// SIGKILL (docs/parameterserver.md).
constexpr uint8_t kAckApplied = 1;
constexpr uint8_t kAckCrcRetry = 2;
constexpr uint8_t kAckEpochFenced = 3;

enum Op : uint32_t {
  kCreate = 1,   // allocate instance shard on the server
  kPush = 2,     // apply rule to [offset, offset+count) of the shard
  kPull = 3,     // reply with shard bytes
  kFree = 4,     // drop one instance
  kFreeAll = 5,  // drop all instances
  kPing = 6,     // liveness / barrier probe
  kEpoch = 7,    // reply with the server's serving epoch (u64)
  // Replicated-group control plane (docs/parameterserver.md
  // "Replication & shard placement"):
  kPlacementEpoch = 8,     // reply {placement epoch u64, drained u64,
                           //        successor len u64, successor bytes}
  kSetPlacementEpoch = 9,  // header.epoch -> placement epoch (monotonic max)
  kHandoff = 10,           // payload "host:port": ship every shard there,
                           // then fence this server at header.epoch
  kSetBackup = 11,         // header.instance + payload "host:port": forward
                           // that instance's applied pushes there (empty
                           // payload clears)
  kDrain = 12,             // fence this server at header.epoch with NO
                           // successor: sent best-effort to a primary a
                           // client just PROMOTED away from, so a server
                           // that was merely unreachable to that one
                           // client (not dead) stops accepting writes
                           // and every other client converges to the
                           // same post-promotion map
};

enum Rule : uint32_t { kRuleZero = 0, kRuleCopy = 1, kRuleAdd = 2 };

enum Dtype : uint32_t {
  kF32 = 0, kF64 = 1, kI32 = 2, kI64 = 3, kU8 = 4, kBF16 = 5, kF16 = 6,
  kI8 = 7
};

size_t dtypeSize(uint32_t dt) {
  switch (dt) {
    case kF32: case kI32: return 4;
    case kF64: case kI64: return 8;
    case kU8: case kI8: return 1;
    case kBF16: case kF16: return 2;
  }
  return 0;
}

struct Header {
  uint32_t magic;
  uint32_t op;
  uint64_t instance;
  uint32_t rule;
  uint32_t dtype;
  uint64_t offset;   // element offset into the server's shard
  uint64_t count;    // element count of the payload / requested slice
  uint64_t epoch;    // push fence: server epoch the client registered at
                     // (0 = unfenced; only kPush reads it)
};

// Largest frame a header (or reply-count word) may announce: bounds every
// resize() before any allocation happens, so a corrupt/hostile count
// (2^40...) is rejected instead of throwing bad_alloc.  16 GiB admits any
// realistic shard.
constexpr uint64_t kMaxFrameBytes = 1ULL << 34;

// Overflow-safe cap check: `count * esz > cap` is bypassable by uint64
// wrap (count = 2^62 with esz 4 multiplies to 0), so compare in division
// form; esz == 0 (unknown dtype code) is likewise hostile input.
bool frameWithinCap(uint64_t count, size_t esz) {
  return esz != 0 && count <= kMaxFrameBytes / esz;
}

// An EAGAIN/EWOULDBLOCK failure is an expired SO_RCVTIMEO/SO_SNDTIMEO
// request deadline (client sockets only — the server sets none), counted
// so drills can tell "slow server" from "dead server".
bool readFull(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) {
      if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK))
        g_timeoutCount.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool writeFull(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) {
      if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK))
        g_timeoutCount.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// ---------------------------------------------------------------- update rules
// Reference: UpdateRule zero/copy/add virtual dispatch
// (lib/parameterserver.cpp:119-213).  Applied under the instance lock.

template <typename T>
void applyRuleT(uint32_t rule, T* shard, const T* in, size_t n) {
  switch (rule) {
    case kRuleZero:
      std::memset(shard, 0, n * sizeof(T));
      break;
    case kRuleCopy:
      std::memcpy(shard, in, n * sizeof(T));
      break;
    case kRuleAdd:
      for (size_t i = 0; i < n; ++i) shard[i] += in[i];
      break;
  }
}

// bf16 wire helpers: ONE shared definition (bf16.h).

void applyRuleBF16(uint32_t rule, uint16_t* shard, const uint16_t* in, size_t n) {
  switch (rule) {
    case kRuleZero:
      std::memset(shard, 0, n * sizeof(uint16_t));
      break;
    case kRuleCopy:
      std::memcpy(shard, in, n * sizeof(uint16_t));
      break;
    case kRuleAdd:
      for (size_t i = 0; i < n; ++i)
        shard[i] = f32ToBF16(bf16ToF32(shard[i]) + bf16ToF32(in[i]));
      break;
  }
}

void applyRuleF16(uint32_t rule, uint16_t* shard, const uint16_t* in, size_t n) {
  switch (rule) {
    case kRuleZero:
      std::memset(shard, 0, n * sizeof(uint16_t));
      break;
    case kRuleCopy:
      std::memcpy(shard, in, n * sizeof(uint16_t));
      break;
    case kRuleAdd:
      for (size_t i = 0; i < n; ++i)
        shard[i] = f32ToF16(f16ToF32(shard[i]) + f16ToF32(in[i]));
      break;
  }
}

void applyRuleI8(uint32_t rule, int8_t* shard, const int8_t* in, size_t n) {
  switch (rule) {
    case kRuleZero:
      std::memset(shard, 0, n);
      break;
    case kRuleCopy:
      std::memcpy(shard, in, n);
      break;
    case kRuleAdd:
      for (size_t i = 0; i < n; ++i) shard[i] = addSatI8(shard[i], in[i]);
      break;
  }
}

void applyRule(uint32_t rule, uint32_t dtype, void* shard, const void* in, size_t n) {
  switch (dtype) {
    case kF32: applyRuleT(rule, static_cast<float*>(shard), static_cast<const float*>(in), n); break;
    case kF64: applyRuleT(rule, static_cast<double*>(shard), static_cast<const double*>(in), n); break;
    case kI32: applyRuleT(rule, static_cast<int32_t*>(shard), static_cast<const int32_t*>(in), n); break;
    case kI64: applyRuleT(rule, static_cast<int64_t*>(shard), static_cast<const int64_t*>(in), n); break;
    case kU8:  applyRuleT(rule, static_cast<uint8_t*>(shard), static_cast<const uint8_t*>(in), n); break;
    case kBF16: applyRuleBF16(rule, static_cast<uint16_t*>(shard), static_cast<const uint16_t*>(in), n); break;
    case kF16: applyRuleF16(rule, static_cast<uint16_t*>(shard), static_cast<const uint16_t*>(in), n); break;
    case kI8: applyRuleI8(rule, static_cast<int8_t*>(shard), static_cast<const int8_t*>(in), n); break;
  }
}

// ---------------------------------------------------------------- snapshots
//
// Durable shard snapshots: one self-validating file per snapshot,
//
//   SnapHead{magic, version, epoch, seq, nshards}
//   nshards x { instance u64, dtype u32, pad u32, count u64, payload bytes }
//   crc32 trailer over everything above
//
// written to a tmp name, fsync'd, then atomically renamed to
// snap_<epoch:020>_<seq:09>.tmpips (zero-padded so lexical order is age
// order) — the same durability-before-visibility discipline as
// utils/checkpoint.py:save.  Restore walks newest-first and loads the
// first file that VALIDATES (magic + version + bounds + CRC); torn or
// corrupt files are counted (g_snapshotTornCount) and skipped, never
// loaded.  The serving epoch is persisted separately in an `epoch` marker
// so a restart with ZERO snapshots still bumps the epoch (the fence must
// fire even when all durable state was lost).

constexpr uint32_t kSnapMagic = 0x50414E53;  // "SNAP"
constexpr uint32_t kSnapVersion = 1;

struct SnapHead {
  uint32_t magic;
  uint32_t version;
  uint64_t epoch;    // serving epoch of the writer
  uint64_t seq;      // per-incarnation write sequence
  uint64_t nshards;
};

struct SnapEntry {
  uint64_t instance;
  uint32_t dtype;
  uint32_t pad;
  uint64_t count;
};

void appendBytes(std::string* buf, const void* p, size_t n) {
  buf->append(static_cast<const char*>(p), n);
}

// How many snapshot files to retain per directory (newest first); older
// ones are pruned after every successful write.  > 1 on purpose: the
// torn-file fallback needs an older snapshot to fall back TO.
constexpr size_t kSnapKeep = 4;

// Serving-epoch marker: u32 magic, u32 version, u64 epoch, u32 crc32
// over the first 16 bytes.  Persisted separately from the snapshots so a
// restart with ZERO valid snapshots still bumps the epoch.
constexpr uint32_t kEpochMagic = 0x48435045;  // "EPCH"

bool readWholeFile(const std::string& path, std::string* out) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  struct stat st {};
  if (::fstat(fd, &st) != 0 || st.st_size < 0 ||
      static_cast<uint64_t>(st.st_size) > kMaxFrameBytes) {
    ::close(fd);
    return false;
  }
  out->resize(static_cast<size_t>(st.st_size));
  bool ok = readFull(fd, out->empty() ? nullptr : &(*out)[0], out->size());
  ::close(fd);
  return ok || out->empty();
}

// write -> fsync -> atomic rename -> fsync(dir): the same durability-
// before-visibility discipline as utils/checkpoint.py:save.  A crash at
// any point leaves either the old state or a `.part` file restore ignores.
// ``crashSeam`` routes this write through the snapshot crash countdown
// (the mid-rename SIGKILL stand-in the failover drill arms).
bool writeDurable(const std::string& dir, const std::string& tmpName,
                  const std::string& finalName, const std::string& data,
                  bool crashSeam = false) {
  std::string tmp = dir + "/" + tmpName;
  int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return false;
  bool ok = writeFull(fd, data.data(), data.size()) && ::fsync(fd) == 0;
  ::close(fd);
  if (crashSeam && ok) {
    int c = g_snapshotCrashNth.load(std::memory_order_relaxed);
    while (c > 0 && !g_snapshotCrashNth.compare_exchange_weak(c, c - 1)) {
    }
    if (c == 1) ::_exit(137);  // die between write+fsync and rename
  }
  if (!ok || ::rename(tmp.c_str(), (dir + "/" + finalName).c_str()) != 0) {
    ::unlink(tmp.c_str());
    return false;
  }
  int dfd = ::open(dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dfd >= 0) {
    ::fsync(dfd);
    ::close(dfd);
  }
  return true;
}

// Snapshot files in lexical order == age order (zero-padded epoch + seq).
std::vector<std::string> listSnapshots(const std::string& dir) {
  std::vector<std::string> names;
  DIR* d = ::opendir(dir.c_str());
  if (!d) return names;
  while (dirent* e = ::readdir(d)) {
    std::string n = e->d_name;
    if (n.rfind("snap_", 0) == 0 && n.size() > 12 &&
        n.compare(n.size() - 7, 7, ".tmpips") == 0)
      names.push_back(n);
  }
  ::closedir(d);
  std::sort(names.begin(), names.end());
  return names;
}

uint64_t readEpochMarker(const std::string& dir) {
  std::string buf;
  if (!readWholeFile(dir + "/epoch.marker", &buf) || buf.size() != 20)
    return 0;
  uint32_t magic, ver, crc;
  uint64_t ep;
  std::memcpy(&magic, buf.data(), 4);
  std::memcpy(&ver, buf.data() + 4, 4);
  std::memcpy(&ep, buf.data() + 8, 8);
  std::memcpy(&crc, buf.data() + 16, 4);
  if (magic != kEpochMagic || ver != 1 || crc != crc32Of(buf.data(), 16))
    return 0;
  return ep;
}

bool writeEpochMarker(const std::string& dir, uint64_t ep) {
  std::string buf;
  uint32_t magic = kEpochMagic, ver = 1;
  appendBytes(&buf, &magic, 4);
  appendBytes(&buf, &ver, 4);
  appendBytes(&buf, &ep, 8);
  uint32_t crc = crc32Of(buf.data(), buf.size());
  appendBytes(&buf, &crc, 4);
  return writeDurable(dir, ".epoch.part", "epoch.marker", buf);
}

// Drain marker: a handed-off owner's fence + forwarding pointer,
// persisted like the epoch marker so a SUPERVISED RESTART of the old
// owner comes back still drained and still advertising its successor —
// without it the restart would serve its stale pre-handoff shards
// un-fenced and split ownership with the successor.  Layout: u32 magic
// "DRNM", u32 version, u64 placement epoch, u64 successor length,
// successor bytes, u32 crc32 over everything above.
constexpr uint32_t kDrainMagic = 0x4D4E5244;  // "DRNM"

bool readDrainMarker(const std::string& dir, uint64_t* epoch,
                     std::string* successor) {
  std::string buf;
  if (!readWholeFile(dir + "/drain.marker", &buf) || buf.size() < 28)
    return false;
  uint32_t magic, ver, crc;
  uint64_t ep, len;
  std::memcpy(&magic, buf.data(), 4);
  std::memcpy(&ver, buf.data() + 4, 4);
  std::memcpy(&ep, buf.data() + 8, 8);
  std::memcpy(&len, buf.data() + 16, 8);
  std::memcpy(&crc, buf.data() + buf.size() - 4, 4);
  if (magic != kDrainMagic || ver != 1 || len > 512 ||
      buf.size() != 28 + len ||
      crc != crc32Of(buf.data(), buf.size() - 4))
    return false;
  *epoch = ep;
  successor->assign(buf.data() + 24, len);
  return true;
}

bool writeDrainMarker(const std::string& dir, uint64_t ep,
                      const std::string& successor) {
  std::string buf;
  uint32_t magic = kDrainMagic, ver = 1;
  uint64_t len = successor.size();
  appendBytes(&buf, &magic, 4);
  appendBytes(&buf, &ver, 4);
  appendBytes(&buf, &ep, 8);
  appendBytes(&buf, &len, 8);
  buf.append(successor);
  uint32_t crc = crc32Of(buf.data(), buf.size());
  appendBytes(&buf, &crc, 4);
  return writeDurable(dir, ".drain.part", "drain.marker", buf);
}

struct LoadedShard {
  uint64_t instance;
  uint32_t dtype;
  uint64_t count;
  size_t off;  // payload byte offset into the snapshot buffer
};

// Full validation before ANY byte is trusted: CRC trailer over the whole
// file, magic/version, and every entry bounds-checked with the same
// overflow-safe cap as the wire protocol.  A torn or corrupt file fails
// here and is never loaded.
bool parseSnapshot(const std::string& buf, SnapHead* head,
                   std::vector<LoadedShard>* out) {
  if (buf.size() < sizeof(SnapHead) + sizeof(uint32_t)) return false;
  uint32_t wire;
  std::memcpy(&wire, buf.data() + buf.size() - 4, 4);
  if (wire != crc32Of(buf.data(), buf.size() - 4)) return false;
  std::memcpy(head, buf.data(), sizeof(SnapHead));
  if (head->magic != kSnapMagic || head->version != kSnapVersion)
    return false;
  if (head->nshards > (1u << 20)) return false;
  size_t off = sizeof(SnapHead);
  const size_t end = buf.size() - 4;
  for (uint64_t i = 0; i < head->nshards; ++i) {
    if (off + sizeof(SnapEntry) > end) return false;
    SnapEntry e;
    std::memcpy(&e, buf.data() + off, sizeof(SnapEntry));
    off += sizeof(SnapEntry);
    size_t esz = dtypeSize(e.dtype);
    if (!frameWithinCap(e.count, esz)) return false;
    size_t bytes = e.count * esz;
    if (bytes > end - off) return false;
    out->push_back({e.instance, e.dtype, e.count, off});
    off += bytes;
  }
  return off == end;
}

// -------------------------------------------------------------------- server

struct Shard {
  std::vector<char> data;
  uint32_t dtype = kF32;
  uint64_t count = 0;  // elements
  std::mutex mu;
};

// Blocking connect with send/recv deadlines: the replication forwarder
// and the handoff shipper must never park a server thread forever on a
// dead peer (the client side gets the same property via g_deadlineMs).
int connectTo(const std::string& host, int port, int timeoutMs) {
  if (port <= 0 || port > 65535) return -1;
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1 ||
      ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return -1;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  timeval tv{timeoutMs / 1000, (timeoutMs % 1000) * 1000};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  return fd;
}

// "host:port" -> (host, port); false on malformed input.
bool splitEndpoint(const std::string& ep, std::string* host, int* port) {
  size_t colon = ep.rfind(':');
  if (colon == std::string::npos || colon == 0 || colon + 1 >= ep.size())
    return false;
  *host = ep.substr(0, colon);
  char* end = nullptr;
  long p = std::strtol(ep.c_str() + colon + 1, &end, 10);
  if (end == nullptr || *end != '\0' || p <= 0 || p > 65535) return false;
  *port = static_cast<int>(p);
  return true;
}

class Server {
 public:
  explicit Server(int port) {
    listenFd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    ::setsockopt(listenFd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(listenFd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
      ::close(listenFd_);
      listenFd_ = -1;
      return;
    }
    socklen_t len = sizeof(addr);
    ::getsockname(listenFd_, reinterpret_cast<sockaddr*>(&addr), &len);
    port_ = ntohs(addr.sin_port);
    ::listen(listenFd_, 128);
    // One background accept thread; one thread per connection.  The
    // reference runs exactly one PS server thread scanning with Iprobe
    // (parameterserver.cpp:636-663); per-connection threads are the socket
    // analogue with the same per-shard locking discipline.
    acceptThread_ = std::thread([this] { acceptLoop(); });
  }

  ~Server() { stop(); }

  bool ok() const { return listenFd_ >= 0; }
  int port() const { return port_; }
  uint64_t epoch() const { return epoch_.load(std::memory_order_relaxed); }

  // Fault seam (tmpi_ps_server_drop_push_acks): drop the next n push acks
  // AFTER the rule ran and kill the connection — the deterministic
  // in-process stand-in for "server applied, crashed before the ack",
  // which is exactly the ambiguity the epoch fence + copy re-seed resolve.
  void dropPushAcks(int n) {
    dropAcks_.store(n < 0 ? 0 : n, std::memory_order_relaxed);
  }

  // Attach a durability directory: restore the NEWEST snapshot that
  // validates (torn/corrupt files counted and skipped — never loaded),
  // bump + persist the serving epoch past both the epoch marker and the
  // restored snapshot's epoch (so the fence fires even when every
  // snapshot was lost), and start the cadence writer.  Returns the number
  // of shards restored.
  int attachDir(const std::string& dir) {
    ::mkdir(dir.c_str(), 0777);  // fresh deployments get the dir created
    const uint64_t corr = psCorr();
    g_psTrace.emit(kTracePlanePs, kTOpRestore, kPhStart, -1, 0, corr);
    {
      std::lock_guard<std::mutex> io(snapIoMu_);
      snapDir_ = dir;
    }
    uint64_t snapEpoch = 0;
    int restored = 0;
    auto names = listSnapshots(dir);
    for (auto it = names.rbegin(); it != names.rend(); ++it) {
      std::string buf;
      SnapHead head{};
      std::vector<LoadedShard> entries;
      if (readWholeFile(dir + "/" + *it, &buf) &&
          parseSnapshot(buf, &head, &entries)) {
        std::lock_guard<std::mutex> g(shardsMu_);
        shards_.clear();
        for (auto& ls : entries) {
          auto sh = std::make_shared<Shard>();
          sh->dtype = ls.dtype;
          sh->count = ls.count;
          sh->data.assign(buf.data() + ls.off,
                          buf.data() + ls.off + ls.count * dtypeSize(ls.dtype));
          shards_[ls.instance] = std::move(sh);
        }
        restored = static_cast<int>(entries.size());
        snapEpoch = head.epoch;
        g_snapshotRestoreCount.fetch_add(1, std::memory_order_relaxed);
        break;
      }
      g_snapshotTornCount.fetch_add(1, std::memory_order_relaxed);
    }
    uint64_t marker = readEpochMarker(dir);
    uint64_t next = (marker > snapEpoch ? marker : snapEpoch) + 1;
    epoch_.store(next, std::memory_order_relaxed);
    if (!writeEpochMarker(dir, next))
      g_snapshotErrorCount.fetch_add(1, std::memory_order_relaxed);
    // A handed-off owner restarts still FENCED behind its forwarding
    // pointer: without this, the restarted incarnation would serve its
    // stale pre-handoff shards and split ownership with the successor.
    uint64_t drainEpoch = 0;
    std::string drainSucc;
    if (readDrainMarker(dir, &drainEpoch, &drainSucc)) {
      {
        std::lock_guard<std::mutex> g(successorMu_);
        successor_ = drainSucc;
      }
      uint64_t cur = placementEpoch_.load(std::memory_order_relaxed);
      while (drainEpoch > cur &&
             !placementEpoch_.compare_exchange_weak(cur, drainEpoch)) {
      }
      // Kind is derivable from the marker: a handoff fence persisted a
      // successor, a promotion fence persisted none.
      drainKind_.store(drainSucc.empty() ? kDrainPromoted : kDrainHandoff,
                       std::memory_order_relaxed);
      drained_.store(true, std::memory_order_relaxed);
    }
    g_psTrace.emit(kTracePlanePs, kTOpRestore, kPhComplete, -1,
                   static_cast<uint64_t>(restored), corr);
    if (!snapThread_.joinable())
      snapThread_ = std::thread([this] { snapshotLoop(); });
    return restored;
  }

  // One self-validating snapshot file: gather shard refs under shardsMu_,
  // serialize each under its own lock (short holds — the server keeps
  // serving), CRC-trail, write-fsync-rename.  snapIoMu_ serializes the
  // cadence writer against on-demand tmpi_ps_snapshot calls.
  bool writeSnapshot() {
    std::lock_guard<std::mutex> io(snapIoMu_);
    if (snapDir_.empty()) return false;
    const uint64_t corr = psCorr();
    g_psTrace.emit(kTracePlanePs, kTOpSnapshot, kPhStart, -1, 0, corr);
    std::vector<std::pair<uint64_t, std::shared_ptr<Shard>>> shards;
    {
      std::lock_guard<std::mutex> g(shardsMu_);
      shards.assign(shards_.begin(), shards_.end());
    }
    std::string buf;
    SnapHead head{kSnapMagic, kSnapVersion,
                  epoch_.load(std::memory_order_relaxed), ++snapSeq_,
                  shards.size()};
    appendBytes(&buf, &head, sizeof(head));
    for (auto& kv : shards) {
      std::lock_guard<std::mutex> g(kv.second->mu);
      SnapEntry e{kv.first, kv.second->dtype, 0, kv.second->count};
      appendBytes(&buf, &e, sizeof(e));
      buf.append(kv.second->data.data(), kv.second->data.size());
    }
    uint32_t crc = crc32Of(buf.data(), buf.size());
    appendBytes(&buf, &crc, sizeof(crc));
    char name[64];
    std::snprintf(name, sizeof(name), "snap_%020llu_%09llu.tmpips",
                  static_cast<unsigned long long>(head.epoch),
                  static_cast<unsigned long long>(head.seq));
    if (!writeDurable(snapDir_, ".snap.part", name, buf,
                      /*crashSeam=*/true)) {
      g_snapshotErrorCount.fetch_add(1, std::memory_order_relaxed);
      g_psTrace.emit(kTracePlanePs, kTOpSnapshot, kPhError, -1,
                     buf.size(), corr);
      return false;
    }
    auto names = listSnapshots(snapDir_);
    for (size_t i = 0; i + kSnapKeep < names.size(); ++i)
      ::unlink((snapDir_ + "/" + names[i]).c_str());
    g_snapshotCount.fetch_add(1, std::memory_order_relaxed);
    g_psTrace.emit(kTracePlanePs, kTOpSnapshot, kPhComplete, -1,
                   buf.size(), corr);
    return true;
  }

  uint64_t placementEpoch() const {
    return placementEpoch_.load(std::memory_order_relaxed);
  }

  void stop() {
    bool expected = false;
    if (!stopping_.compare_exchange_strong(expected, true)) return;
    if (listenFd_ >= 0) ::shutdown(listenFd_, SHUT_RDWR);
    if (listenFd_ >= 0) ::close(listenFd_);
    if (acceptThread_.joinable()) acceptThread_.join();
    {
      std::lock_guard<std::mutex> g(snapCvMu_);
      snapStop_ = true;
    }
    snapCv_.notify_all();
    if (snapThread_.joinable()) snapThread_.join();
    // Workers are detached; unblock any parked in readFull() on idle client
    // connections, then wait for the active count to drain to zero.
    {
      std::unique_lock<std::mutex> g(workersMu_);
      for (int fd : connFds_) ::shutdown(fd, SHUT_RDWR);
      workersCv_.wait(g, [this] { return activeWorkers_ == 0; });
    }
    // Forwarder joined AFTER the workers drained (they may enqueue until
    // their last push) and BEFORE the final snapshot.  Frames still
    // queued are abandoned and counted — the replication stream is
    // best-effort; the re-seed at promotion repairs any tail.
    {
      std::lock_guard<std::mutex> g(fwdMu_);
      fwdStop_ = true;
      g_forwardErrorCount.fetch_add(fwdQueue_.size(),
                                    std::memory_order_relaxed);
      fwdQueue_.clear();
    }
    fwdCv_.notify_all();
    if (fwdThread_.joinable()) fwdThread_.join();
    for (auto& kv : fwdConns_) ::close(kv.second);
    fwdConns_.clear();
    // Final snapshot AFTER the workers drained, so a clean stop persists
    // every applied rule even with the cadence writer off (no-op when no
    // durability directory is attached).
    writeSnapshot();
  }

 private:
  // Cadence writer: re-reads the interval knob each cycle (config changes
  // take effect on running servers); 0 parks it at a 200 ms heartbeat
  // doing nothing (on-demand tmpi_ps_snapshot only).
  void snapshotLoop() {
    std::unique_lock<std::mutex> lk(snapCvMu_);
    for (;;) {
      int iv = g_snapshotIntervalMs.load(std::memory_order_relaxed);
      snapCv_.wait_for(lk, std::chrono::milliseconds(iv > 0 ? iv : 200),
                       [this] { return snapStop_; });
      if (snapStop_) return;
      if (g_snapshotIntervalMs.load(std::memory_order_relaxed) > 0) {
        lk.unlock();
        writeSnapshot();
        lk.lock();
      }
    }
  }

  // ------------------------------------------------- replication forwarder
  //
  // One background thread per server drains a bounded queue of applied
  // pushes to their registered backup endpoints (kSetBackup).  Strictly
  // best-effort and AFTER the client ack — the primary's latency is
  // untouched by a slow backup, and every provable loss (send failure,
  // overflow drop, stop-time abandon) is counted so the drill can assert
  // the repair path (promotion re-seed) was actually exercised.

  struct ForwardItem {
    std::string endpoint;  // "host:port"
    Header h;              // kPush header (plain magic, epoch 0)
    std::string payload;
  };

  void setBackup(uint64_t instance, const std::string& endpoint) {
    std::lock_guard<std::mutex> g(fwdMu_);
    if (endpoint.empty()) {
      backups_.erase(instance);
      return;
    }
    backups_[instance] = endpoint;
    if (!fwdThread_.joinable())
      fwdThread_ = std::thread([this] { forwardLoop(); });
  }

  void enqueueForward(const Header& h, const char* payload, size_t bytes) {
    std::string endpoint;
    {
      std::lock_guard<std::mutex> g(fwdMu_);
      auto it = backups_.find(h.instance);
      if (it == backups_.end()) return;
      endpoint = it->second;
      Header fh = h;
      fh.magic = kMagic;  // forwards ride plain frames
      fh.epoch = 0;       // the backup's serving epoch is not ours to stamp
      fwdQueue_.push_back({std::move(endpoint), fh,
                           std::string(payload, bytes)});
      int cap = std::max(1, g_forwardQueueMax.load(std::memory_order_relaxed));
      while (fwdQueue_.size() > static_cast<size_t>(cap)) {
        fwdQueue_.pop_front();  // drop-OLDEST: newest state wins a backlog
        g_forwardErrorCount.fetch_add(1, std::memory_order_relaxed);
      }
    }
    fwdCv_.notify_one();
  }

  void forwardLoop() {
    for (;;) {
      ForwardItem item;
      {
        std::unique_lock<std::mutex> g(fwdMu_);
        fwdCv_.wait(g, [this] { return fwdStop_ || !fwdQueue_.empty(); });
        if (fwdStop_) return;
        item = std::move(fwdQueue_.front());
        fwdQueue_.pop_front();
      }
      const uint64_t bytes = item.payload.size();
      bool ok = false;
      // One reconnect attempt on a stale cached connection: the backup
      // may have idled us out between forwards.
      for (int attempt = 0; attempt < 2 && !ok; ++attempt) {
        int fd = -1;
        {
          std::lock_guard<std::mutex> g(fwdMu_);
          auto it = fwdConns_.find(item.endpoint);
          if (it != fwdConns_.end()) fd = it->second;
        }
        if (fd < 0) {
          std::string host;
          int port = 0;
          if (!splitEndpoint(item.endpoint, &host, &port)) break;
          fd = connectTo(host, port, kForwardTimeoutMs);
          if (fd < 0) continue;
          std::lock_guard<std::mutex> g(fwdMu_);
          fwdConns_[item.endpoint] = fd;
        }
        uint8_t ack = 0;
        if (writeFull(fd, &item.h, sizeof(item.h)) &&
            (bytes == 0 || writeFull(fd, item.payload.data(), bytes)) &&
            readFull(fd, &ack, 1) && ack == kAckApplied) {
          ok = true;
        } else {
          std::lock_guard<std::mutex> g(fwdMu_);
          auto it = fwdConns_.find(item.endpoint);
          if (it != fwdConns_.end() && it->second == fd)
            fwdConns_.erase(it);
          ::close(fd);
        }
      }
      if (ok) {
        g_forwardCount.fetch_add(1, std::memory_order_relaxed);
        g_psTrace.emit(kTracePlanePs, kTOpForward, kPhComplete, -1, bytes,
                       psCorr());
      } else {
        g_forwardErrorCount.fetch_add(1, std::memory_order_relaxed);
        g_psTrace.emit(kTracePlanePs, kTOpForward, kPhError, -1, bytes,
                       psCorr());
      }
    }
  }

  // --------------------------------------------------------- live handoff
  //
  // Ship every shard to a successor server (kCreate force=1 + full-shard
  // kPush rule=copy), then fence this server: drained_ NACKs every later
  // push (kAckEpochFenced — the rule never runs) and pulls reply empty,
  // while kPlacementEpoch keeps answering with the successor endpoint so
  // clients cut over without any coordinator.  The fence goes up BEFORE
  // the ship so no write mutates a shard between its copy and the
  // cutover; a failed ship takes the fence back down (torn handoff — the
  // old owner keeps serving, counted in tmpi_ps_handoff_torn_count).
  bool handoffTo(const std::string& endpoint, uint64_t newPlacementEpoch) {
    std::string host;
    int port = 0;
    if (!splitEndpoint(endpoint, &host, &port)) return false;
    bool expected = false;
    if (!drained_.compare_exchange_strong(expected, true))
      return false;  // already drained (or a concurrent handoff won)
    drainKind_.store(kDrainHandoff, std::memory_order_relaxed);
    const uint64_t corr = psCorr();
    g_psTrace.emit(kTracePlanePs, kTOpHandoff, kPhStart, -1, 0, corr);
    std::vector<std::pair<uint64_t, std::shared_ptr<Shard>>> shards;
    {
      std::lock_guard<std::mutex> g(shardsMu_);
      shards.assign(shards_.begin(), shards_.end());
    }
    uint64_t shipped = 0;
    int fd = connectTo(host, port, kForwardTimeoutMs);
    bool ok = fd >= 0;
    for (auto& kv : shards) {
      if (!ok) break;
      std::lock_guard<std::mutex> g(kv.second->mu);
      Header ch{kMagic, kCreate, kv.first, /*force=*/1, kv.second->dtype,
                0, kv.second->count, 0};
      Header ph{kMagic, kPush, kv.first, kRuleCopy, kv.second->dtype,
                0, kv.second->count, 0};
      uint8_t ack = 0;
      ok = writeFull(fd, &ch, sizeof(ch)) && readFull(fd, &ack, 1) &&
           ack == kAckApplied;
      ack = 0;
      ok = ok && writeFull(fd, &ph, sizeof(ph)) &&
           (kv.second->data.empty() ||
            writeFull(fd, kv.second->data.data(), kv.second->data.size())) &&
           readFull(fd, &ack, 1) && ack == kAckApplied;
      if (ok) shipped += kv.second->data.size();
    }
    if (fd >= 0) ::close(fd);
    if (!ok) {
      drainKind_.store(kDrainNone, std::memory_order_relaxed);
      drained_.store(false);  // torn ship: stay the owner
      g_handoffTornCount.fetch_add(1, std::memory_order_relaxed);
      g_psTrace.emit(kTracePlanePs, kTOpHandoff, kPhError, -1, shipped, corr);
      return false;
    }
    {
      std::lock_guard<std::mutex> g(successorMu_);
      successor_ = endpoint;
    }
    uint64_t cur = placementEpoch_.load(std::memory_order_relaxed);
    while (newPlacementEpoch > cur &&
           !placementEpoch_.compare_exchange_weak(cur, newPlacementEpoch)) {
    }
    {
      // Persist the fence (durability attached only): a supervised
      // restart of this owner must come back drained — see attachDir.
      std::lock_guard<std::mutex> io(snapIoMu_);
      if (!snapDir_.empty() &&
          !writeDrainMarker(snapDir_,
                            placementEpoch_.load(std::memory_order_relaxed),
                            endpoint))
        g_snapshotErrorCount.fetch_add(1, std::memory_order_relaxed);
    }
    g_handoffCount.fetch_add(1, std::memory_order_relaxed);
    g_psTrace.emit(kTracePlanePs, kTOpHandoff, kPhComplete, -1, shipped,
                   corr);
    return true;
  }

  void acceptLoop() {
    while (!stopping_.load()) {
      int fd = ::accept(listenFd_, nullptr, nullptr);
      if (fd < 0) break;
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      {
        std::lock_guard<std::mutex> g(workersMu_);
        connFds_.insert(fd);
        ++activeWorkers_;
      }
      // Detached with an active count instead of stored std::thread handles:
      // a long-running server with client reconnect churn would otherwise
      // accumulate finished-but-unjoined thread objects until stop().
      std::thread([this, fd] { serveConnection(fd); }).detach();
    }
  }

  void serveConnection(int fd) {
    // The worker is detached: an escaping exception (e.g. bad_alloc on a
    // corrupt frame) would std::terminate the whole training process, so
    // the loop is guarded — any throw just drops this connection.  NOT
    // silently, though: a genuine server-side bug would otherwise manifest
    // only as clients' connections dropping with no diagnostic anywhere,
    // so the exception type/what() goes to stderr and a process-wide
    // counter (tmpi_ps_server_exception_count) that tests and monitors can
    // poll.
    try {
      serveLoop(fd);
    } catch (const std::exception& e) {
      g_serverExceptions.fetch_add(1, std::memory_order_relaxed);
      std::fprintf(stderr,
                   "torchmpi_tpu ps server: dropping connection fd=%d after "
                   "%s: %s\n", fd, typeid(e).name(), e.what());
    } catch (...) {
      g_serverExceptions.fetch_add(1, std::memory_order_relaxed);
      std::fprintf(stderr,
                   "torchmpi_tpu ps server: dropping connection fd=%d after "
                   "non-std exception\n", fd);
    }
    {
      std::lock_guard<std::mutex> g(workersMu_);
      connFds_.erase(fd);
      if (--activeWorkers_ == 0) workersCv_.notify_all();
    }
    ::close(fd);
  }

  void serveLoop(int fd) {
    std::vector<char> payload;
    Header h{};
    while (!stopping_.load() && readFull(fd, &h, sizeof(h)) &&
           (h.magic == kMagic || h.magic == kMagicCrc)) {
      const bool wantCrc = h.magic == kMagicCrc;
      switch (h.op) {
        case kCreate: {
          if (!frameWithinCap(h.count, dtypeSize(h.dtype))) goto done;
          std::lock_guard<std::mutex> g(shardsMu_);
          auto& sh = shards_[h.instance];
          if (!sh) sh = std::make_shared<Shard>();
          std::lock_guard<std::mutex> g2(sh->mu);
          // h.rule carries a force flag: force=1 (a fresh registration)
          // always reallocates to zero so a restarted client reusing an
          // instance id cannot inherit a previous run's shard; force=0 (a
          // late same-run worker registering the same tensor) keeps a
          // matching shard's contents so it cannot wipe a value another
          // worker already seeded or accumulated into (the reference seeds
          // from rank 0 only, under MPI barriers: parameterserver/init.lua
          // psInitFun).  A geometry change always reallocates to zero, the
          // shard-default-init semantics the tests rely on.
          if (h.rule != 0 || sh->count != h.count || sh->dtype != h.dtype) {
            sh->dtype = h.dtype;
            sh->count = h.count;
            sh->data.assign(h.count * dtypeSize(h.dtype), 0);
          }
          uint8_t ack = 1;
          if (!writeFull(fd, &ack, 1)) goto done;
          break;
        }
        case kPush: {
          // A frame larger than the cap cannot be skipped without reading
          // it, so the stream is unrecoverable — drop the connection.
          if (!frameWithinCap(h.count, dtypeSize(h.dtype))) goto done;
          size_t bytes = h.count * dtypeSize(h.dtype);
          payload.resize(bytes);
          if (!readFull(fd, payload.data(), bytes)) goto done;
          if (wantCrc && bytes) {
            // Verify the payload trailer BEFORE running the rule: a torn
            // push must not corrupt the shard.  The stream stays framed
            // (payload + trailer fully consumed), so NACK-retriable
            // (kAckCrcRetry) instead of dropping the connection — the
            // client re-sends safely, the rule never ran.  An EMPTY push
            // carries no trailer on either side (the client only writes
            // one when payloadBytes > 0 — same rule as the pull reply),
            // so gating on bytes keeps the streams framed instead of
            // deadlocking both ends on a 4-byte read that never comes.
            uint32_t wire = 0;
            if (!readFull(fd, &wire, sizeof(wire))) goto done;
            if (wire != crc32Of(payload.data(), bytes)) {
              uint8_t ack = kAckCrcRetry;
              if (!writeFull(fd, &ack, 1)) goto done;
              break;
            }
          }
          // Drain fence (checked AFTER the payload+trailer were consumed,
          // so the stream stays framed): a drained server — mid- or
          // post-handoff — must not mutate shards it no longer owns.
          // Same NACK as the epoch fence: the client's failover path
          // probes kPlacementEpoch, finds the successor, and cuts over.
          if (drained_.load(std::memory_order_relaxed)) {
            g_epochFenceCount.fetch_add(1, std::memory_order_relaxed);
            uint8_t ack = kAckEpochFenced;
            if (!writeFull(fd, &ack, 1)) goto done;
            break;
          }
          // Epoch fence (same framing discipline): a nonzero push epoch
          // that is not the serving epoch means the server restarted from
          // a snapshot since the client registered.  The rule does NOT
          // run — the client must re-learn the epoch, re-register, and
          // re-seed via idempotent copy instead of risking a
          // double-applied add.
          if (h.epoch != 0 &&
              h.epoch != epoch_.load(std::memory_order_relaxed)) {
            g_epochFenceCount.fetch_add(1, std::memory_order_relaxed);
            uint8_t ack = kAckEpochFenced;
            if (!writeFull(fd, &ack, 1)) goto done;
            break;
          }
          std::shared_ptr<Shard> sh = findShard(h.instance);
          uint8_t ack = 0;
          if (sh) {
            std::lock_guard<std::mutex> g(sh->mu);
            // Drain re-check UNDER the shard lock: handoffTo fences
            // before it takes any shard's lock and ships each shard
            // under it, so an apply that raced past the unlocked drain
            // check above either got the lock first (and its write is in
            // the shipped copy) or observes the fence here and NACKs —
            // an ACKed push can never miss the successor.
            if (drained_.load(std::memory_order_relaxed)) {
              g_epochFenceCount.fetch_add(1, std::memory_order_relaxed);
              uint8_t fenced = kAckEpochFenced;
              if (!writeFull(fd, &fenced, 1)) goto done;
              break;
            }
            size_t esz = dtypeSize(sh->dtype);
            // dtype must match the shard: payload was sized with h.dtype,
            // rules run with the shard's dtype — a mismatch would mis-read.
            // Range check in subtraction form: offset + count can wrap.
            if (h.dtype == sh->dtype && h.offset <= sh->count &&
                h.count <= sh->count - h.offset) {
              applyRule(h.rule, sh->dtype, sh->data.data() + h.offset * esz,
                        payload.data(), h.count);
              ack = 1;
            }
          }
          if (ack == 1) {
            // Replication: the applied rule forwards to this instance's
            // registered backup (if any) AFTER the local apply, off the
            // request path — the ack below does not wait for the backup.
            enqueueForward(h, payload.data(), bytes);
            // Fault seam: consume one drop-acks token and die without
            // acking — "applied, ack lost, server gone" exactly.
            int da = dropAcks_.load(std::memory_order_relaxed);
            while (da > 0 &&
                   !dropAcks_.compare_exchange_weak(da, da - 1)) {
            }
            if (da > 0) goto done;
          }
          // ACK after the rule ran: the Ssend happens-before guarantee
          // (reference: parameterserver.cpp:340-347).
          if (!writeFull(fd, &ack, 1)) goto done;
          break;
        }
        case kEpoch: {
          // Serving-epoch probe (8-byte reply, untrailed like the pull
          // count word): the client stamps this into subsequent pushes.
          uint64_t ep = epoch_.load(std::memory_order_relaxed);
          if (!writeFull(fd, &ep, sizeof(ep))) goto done;
          break;
        }
        case kPull: {
          // A drained server replies empty (the missing-instance wire
          // shape): the client's idempotent pull failover re-resolves
          // placement and re-pulls from the successor — stale reads from
          // a fenced owner never reach a caller.
          std::shared_ptr<Shard> sh =
              drained_.load(std::memory_order_relaxed) ? nullptr
                                                       : findShard(h.instance);
          uint64_t count = 0;
          bool served = false;
          if (sh) {
            // dtype is read under sh->mu: kCreate(force) may be
            // reallocating this shard with a new dtype concurrently, and
            // an unlocked gate could pass against the old dtype then
            // serve bytes sized by the new one.
            std::lock_guard<std::mutex> g(sh->mu);
            if (h.dtype == sh->dtype) {
              size_t esz = dtypeSize(sh->dtype);
              uint64_t avail =
                  (h.offset <= sh->count) ? sh->count - h.offset : 0;
              // count==0 means 0 (NOT "entire shard"): the client contract
              // expects exactly `count` elements back, so an implicit
              // full-shard reply could overflow the caller's buffer.
              count = (h.count < avail) ? h.count : avail;
              if (!writeFull(fd, &count, sizeof(count))) goto done;
              if (count) {
                const char* src = sh->data.data() + h.offset * esz;
                if (!writeFull(fd, src, count * esz)) goto done;
                if (wantCrc) {
                  // Trail the reply so the client can verify the shard
                  // bytes survived the wire (CRC over payload only; an
                  // empty reply carries no trailer on either side).
                  uint32_t crc = crc32Of(src, count * esz);
                  if (!writeFull(fd, &crc, sizeof(crc))) goto done;
                }
              }
              served = true;
            }
          }
          if (!served) {
            count = 0;
            if (!writeFull(fd, &count, sizeof(count))) goto done;
          }
          break;
        }
        case kFree: {
          {
            std::lock_guard<std::mutex> g(shardsMu_);
            shards_.erase(h.instance);
          }
          uint8_t ack = 1;
          if (!writeFull(fd, &ack, 1)) goto done;
          break;
        }
        case kFreeAll: {
          {
            std::lock_guard<std::mutex> g(shardsMu_);
            shards_.clear();
          }
          uint8_t ack = 1;
          if (!writeFull(fd, &ack, 1)) goto done;
          break;
        }
        case kPing: {
          uint8_t ack = 1;
          if (!writeFull(fd, &ack, 1)) goto done;
          break;
        }
        case kPlacementEpoch: {
          // Placement probe: {epoch u64, drained u64, successor-len u64,
          // successor bytes}.  A drained server keeps answering this —
          // it is the forwarding pointer clients cut over through; a
          // MID-handoff server answers drained with an EMPTY successor
          // ("retry shortly": the ship either lands and the successor
          // appears, or fails and the drain comes back down).
          std::string succ;
          {
            std::lock_guard<std::mutex> g(successorMu_);
            succ = successor_;
          }
          uint64_t reply[3] = {
              placementEpoch_.load(std::memory_order_relaxed),
              drained_.load(std::memory_order_relaxed)
                  ? drainKind_.load(std::memory_order_relaxed)
                  : kDrainNone,
              succ.size()};
          if (!writeFull(fd, reply, sizeof(reply))) goto done;
          if (!succ.empty() && !writeFull(fd, succ.data(), succ.size()))
            goto done;
          break;
        }
        case kSetPlacementEpoch: {
          // Monotonic max: placement epochs only move forward, so a
          // laggard client's stale publish can never roll a newer
          // membership view back.
          uint64_t cur = placementEpoch_.load(std::memory_order_relaxed);
          while (h.epoch > cur &&
                 !placementEpoch_.compare_exchange_weak(cur, h.epoch)) {
          }
          uint8_t ack = 1;
          if (!writeFull(fd, &ack, 1)) goto done;
          break;
        }
        case kDrain: {
          // Promotion fence: a client that promoted past this server
          // drains it (no successor — the post-promotion owners are
          // derived from the ring, not a pointer).  If this server was
          // alive all along (the promoting client's connectivity blip,
          // not a death), this is what stops it accepting writes as a
          // second owner: other clients' pushes NACK, their probes see
          // drained-with-no-successor, and their own promotion derives
          // the identical map.  Persisted like the handoff fence.
          uint64_t cur = placementEpoch_.load(std::memory_order_relaxed);
          while (h.epoch > cur &&
                 !placementEpoch_.compare_exchange_weak(cur, h.epoch)) {
          }
          drainKind_.store(kDrainPromoted, std::memory_order_relaxed);
          drained_.store(true, std::memory_order_relaxed);
          {
            std::lock_guard<std::mutex> io(snapIoMu_);
            if (!snapDir_.empty() &&
                !writeDrainMarker(
                    snapDir_,
                    placementEpoch_.load(std::memory_order_relaxed),
                    std::string()))
              g_snapshotErrorCount.fetch_add(1, std::memory_order_relaxed);
          }
          uint8_t ack = 1;
          if (!writeFull(fd, &ack, 1)) goto done;
          break;
        }
        case kHandoff: {
          // Payload: successor "host:port".  Ship-then-ack: the ack only
          // says 1 once every shard landed on the successor and this
          // server is fenced behind the forwarding pointer.  A crc-on
          // client (kMagicCrc) trailed the payload like every other
          // request — the trailer must be consumed to keep the stream
          // framed, and a mismatch NACKs retriable (nothing shipped).
          if (h.dtype != kU8 || !frameWithinCap(h.count, 1) ||
              h.count > 512)
            goto done;
          payload.resize(h.count);
          if (h.count && !readFull(fd, payload.data(), h.count)) goto done;
          if (wantCrc && h.count) {
            uint32_t wire = 0;
            if (!readFull(fd, &wire, sizeof(wire))) goto done;
            if (wire != crc32Of(payload.data(), h.count)) {
              uint8_t ack = kAckCrcRetry;
              if (!writeFull(fd, &ack, 1)) goto done;
              break;
            }
          }
          uint8_t ack =
              (h.count &&
               handoffTo(std::string(payload.data(), h.count), h.epoch))
                  ? 1
                  : 0;
          if (!writeFull(fd, &ack, 1)) goto done;
          break;
        }
        case kSetBackup: {
          // Payload: backup "host:port" for header.instance (empty
          // clears).  Registered by clients from the placement ring —
          // the server itself has no ring; it just forwards where told.
          // Same crc-trailer framing discipline as kHandoff above.
          if (h.dtype != kU8 || !frameWithinCap(h.count, 1) ||
              h.count > 512)
            goto done;
          payload.resize(h.count);
          if (h.count && !readFull(fd, payload.data(), h.count)) goto done;
          if (wantCrc && h.count) {
            uint32_t wire = 0;
            if (!readFull(fd, &wire, sizeof(wire))) goto done;
            if (wire != crc32Of(payload.data(), h.count)) {
              uint8_t ack = kAckCrcRetry;
              if (!writeFull(fd, &ack, 1)) goto done;
              break;
            }
          }
          setBackup(h.instance,
                    h.count ? std::string(payload.data(), h.count)
                            : std::string());
          uint8_t ack = 1;
          if (!writeFull(fd, &ack, 1)) goto done;
          break;
        }
        default:
          goto done;
      }
    }
  done:
    return;  // cleanup (worker count, close) runs in serveConnection
  }

  // shared_ptr so a concurrent kFree cannot destroy a shard another
  // connection thread is still applying a rule to (the erase drops the map
  // reference; the last user frees it).
  std::shared_ptr<Shard> findShard(uint64_t instance) {
    std::lock_guard<std::mutex> g(shardsMu_);
    auto it = shards_.find(instance);
    return it == shards_.end() ? nullptr : it->second;
  }

  int listenFd_ = -1;
  int port_ = -1;
  std::atomic<bool> stopping_{false};
  std::thread acceptThread_;
  std::mutex workersMu_;
  std::condition_variable workersCv_;
  int activeWorkers_ = 0;
  std::set<int> connFds_;
  std::mutex shardsMu_;
  std::map<uint64_t, std::shared_ptr<Shard>> shards_;
  // Durability state.  epoch_ is 0 until attachDir: a server with no
  // durability directory serves epoch 0, which clients stamp as the
  // "unfenced" value — the fence only engages once snapshots exist to
  // restore from.  snapDir_/snapSeq_ are guarded by snapIoMu_ (attachDir
  // and every writer take it); snapStop_ by snapCvMu_.
  std::atomic<uint64_t> epoch_{0};
  std::atomic<int> dropAcks_{0};
  std::string snapDir_;
  uint64_t snapSeq_ = 0;
  std::mutex snapIoMu_;
  std::thread snapThread_;
  std::mutex snapCvMu_;
  std::condition_variable snapCv_;
  bool snapStop_ = false;
  // Replicated-group state.  placementEpoch_ is the membership-change
  // counter clients publish (kSetPlacementEpoch, monotonic); drained_ is
  // the handoff fence; successor_ the forwarding pointer a drained
  // server keeps answering placement probes with.  The forwarder (one
  // lazy thread, bounded queue, cached connections with deadlines) ships
  // applied pushes to per-instance backups registered via kSetBackup.
  static constexpr int kForwardTimeoutMs = 2000;
  // Drain kinds, reported in the kPlacementEpoch reply's second word so
  // clients can tell a transient fence from a permanent one:
  //   0 = serving; 1 = handoff fence (successor present, or imminent —
  //   poll); 2 = promotion fence (no successor ever — re-derive the map).
  static constexpr uint64_t kDrainNone = 0, kDrainHandoff = 1,
                            kDrainPromoted = 2;
  std::atomic<uint64_t> placementEpoch_{0};
  std::atomic<uint64_t> drainKind_{0};
  std::atomic<bool> drained_{false};
  std::mutex successorMu_;
  std::string successor_;
  std::mutex fwdMu_;
  std::condition_variable fwdCv_;
  std::map<uint64_t, std::string> backups_;
  std::deque<ForwardItem> fwdQueue_;
  std::map<std::string, int> fwdConns_;
  std::thread fwdThread_;
  bool fwdStop_ = false;
};

// -------------------------------------------------------------- client pool

// Outcome of one request attempt on a connection.  The distinction matters
// for retry safety: a kSendFail means the server cannot have received the
// full request (it reads header+payload before acting), so re-sending is
// safe even for non-idempotent ops; a kReplyFail means the request may have
// been applied and the reply lost — only idempotent ops may retry then.
// kCrcRetry means the frame integrity check failed with the server
// PROVABLY not having acted (a push NACKed before the rule, or a torn pull
// reply of an idempotent read) — always safe to retry.
enum class IoResult { kOk, kSendFail, kReplyFail, kCrcRetry };

// Persistent connection per (client, server-endpoint), guarded by a mutex;
// requests on one connection are serialized, preserving per-peer FIFO order
// the way MPI tag matching does for the reference.
class Peer {
 public:
  Peer(std::string host, int port)
      : host_(std::move(host)), port_(port),
        rng_(static_cast<uint32_t>(port) * 2654435761u + 1) {}

  ~Peer() {
    if (fd_ >= 0) ::close(fd_);
  }

  // Runs fn(fd) under the connection lock; (re)connects on demand.  Up to
  // g_retryMax attempts with bounded exponential backoff + jitter between
  // them (the seed behaviour was one bare reconnect); connect failures are
  // always retriable, request failures per the idempotency rules above.
  // ``retry_after_reply_loss`` must be false for non-idempotent requests
  // (a PUSH with rule=add applied twice would double-count).  ``corr`` is
  // the dispatching span's correlation id, threaded in by the caller.
  bool withConnection(const std::function<IoResult(int)>& fn,
                      bool retry_after_reply_loss, uint64_t corr) {
    std::lock_guard<std::mutex> g(mu_);
    const int attempts = std::max(1, g_retryMax.load());
    for (int attempt = 0; attempt < attempts; ++attempt) {
      if (attempt > 0) {
        g_retryCount.fetch_add(1, std::memory_order_relaxed);
        // op code 0: the Peer doesn't know which request it carries; the
        // correlation id still joins the retry to its span and op events.
        g_psTrace.emit(kTracePlanePs, 0, kPhRetry, -1, 0, corr);
        backoffLocked(attempt);
      }
      if (fd_ < 0 && !connectLocked()) continue;
      IoResult r = fn(fd_);
      if (r == IoResult::kOk) return true;
      ::close(fd_);
      fd_ = -1;  // fresh connection for any future request
      if (r == IoResult::kReplyFail && !retry_after_reply_loss) return false;
    }
    return false;
  }

 private:
  // min(cap, base * 2^(attempt-1)) plus uniform jitter of up to half the
  // base, so a fleet of clients re-hitting a recovering server staggers
  // instead of stampeding.  Per-peer PRNG under the connection lock.
  void backoffLocked(int attempt) {
    int64_t base = std::max(1, g_backoffMs.load());
    int64_t cap = std::max<int64_t>(base, g_backoffMaxMs.load());
    int64_t delay = base << std::min(attempt - 1, 20);
    if (delay > cap) delay = cap;
    delay += static_cast<int64_t>(rng_() % (base / 2 + 1));
    ::usleep(static_cast<useconds_t>(delay * 1000));
  }

  bool connectLocked() {
    // A port outside uint16 range would otherwise truncate silently in
    // the htons(static_cast<uint16_t>) below and dial the wrong server;
    // failing the attempt surfaces through the normal retry/error path.
    if (port_ <= 0 || port_ > 65535) return false;
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return false;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port_));
    if (::inet_pton(AF_INET, host_.c_str(), &addr.sin_addr) != 1) {
      ::close(fd);
      return false;
    }
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
      ::close(fd);
      return false;
    }
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    int dl = g_deadlineMs.load();
    if (dl > 0) {
      // Per-request deadline: a server that stops answering fails the
      // attempt with EAGAIN (counted in g_timeoutCount) instead of
      // parking the offload-pool thread forever.
      timeval tv{dl / 1000, (dl % 1000) * 1000};
      ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
      ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    }
    fd_ = fd;
    return true;
  }

  std::string host_;
  int port_;
  std::minstd_rand rng_;
  int fd_ = -1;
  std::mutex mu_;
};

// Fixed-size offload pool (reference: PS thread pool, 4 threads,
// lib/constants.cpp:152-155).
class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i)
      threads_.emplace_back([this] { loop(); });
  }

  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stopping_ = true;
    }
    cv_.notify_all();
    for (auto& t : threads_) t.join();
  }

  void enqueue(std::function<void()> fn) {
    {
      std::lock_guard<std::mutex> g(mu_);
      queue_.push_back(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [this] { return stopping_ || !queue_.empty(); });
        if (stopping_ && queue_.empty()) return;
        fn = std::move(queue_.front());
        queue_.pop_front();
      }
      fn();
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<std::function<void()>> queue_;
  bool stopping_ = false;
  std::vector<std::thread> threads_;
};

// ------------------------------------------------------------- global state

struct Global {
  std::mutex mu;
  std::map<int, std::unique_ptr<Server>> servers;
  int nextServer = 1;
  // shared_ptr so a concurrent tmpi_ps_disconnect cannot destroy a Peer an
  // in-flight async push/pull on the thread pool is still using (mirrors the
  // Shard handling in Server::findShard).
  std::map<int, std::shared_ptr<Peer>> peers;
  int nextPeer = 1;
  std::map<int64_t, std::shared_future<int>> futures;  // handle -> ok flag
  // Results of futures a fence (sync_all) drained before their owner's
  // wait(): barrier()/free() must not make a still-held handle's wait()
  // report failure.  Bounded: evicted past kMaxCompleted in COMPLETION
  // FIFO order (completedOrder; ADVICE r5 — smallest-handle-id-first
  // eviction could evict a young result while a stale old one survived).
  // completedOrder may carry stale ids whose result a wait() already
  // consumed; the eviction loop skips them lazily.
  std::map<int64_t, int> completed;
  std::deque<int64_t> completedOrder;
  int64_t nextFuture = 1;
  std::unique_ptr<ThreadPool> pool;
  int poolSize = 4;  // reference: PS pool default, constants.cpp:152-155
};

constexpr size_t kMaxCompleted = 4096;

Global& g() {
  static Global* instance = new Global();
  return *instance;
}

// Register the future AND enqueue its task under ONE hold of g().mu: a
// concurrent sync_all fence then either sees the future (and waits it) or
// the task was already enqueued — it can never slip between the two.  The
// same hold covers lazy pool creation (two first-async races) and excludes
// shutdown's pool swap from the register..enqueue window.  Lock order is
// safe: workers take the pool's queue mutex only while popping, never
// while holding g().mu.
int64_t registerAndEnqueue(std::shared_ptr<std::packaged_task<int()>> task,
                           std::shared_future<int> f) {
  std::lock_guard<std::mutex> lk(g().mu);
  if (!g().pool) g().pool.reset(new ThreadPool(g().poolSize));
  int64_t h = g().nextFuture++;
  g().futures[h] = std::move(f);
  g().pool->enqueue([task] { (*task)(); });
  return h;
}

std::shared_ptr<Peer> findPeer(int peer) {
  std::lock_guard<std::mutex> lk(g().mu);
  auto it = g().peers.find(peer);
  return it == g().peers.end() ? nullptr : it->second;
}

// idempotent: whether the request may be re-sent after a lost reply (true
// for create/free/ping whose double application is harmless; false for PUSH).
// ``ackOut`` (optional) receives the server's last ack byte so a caller can
// tell an epoch-fence NACK (rule provably never ran; the failover path's
// re-seed-then-replay trigger) from a transport failure.
int requestAck(const std::shared_ptr<Peer>& p, const Header& h,
               const void* payload, size_t payloadBytes, bool idempotent,
               uint64_t corr, uint8_t* ackOut = nullptr) {
  if (!p) return 0;
  bool appliedButNacked = false;
  bool ok = p->withConnection(
      [&](int fd) {
        const bool crc = g_frameCrc.load();
        Header hw = h;
        hw.magic = crc ? kMagicCrc : kMagic;
        if (!writeFull(fd, &hw, sizeof(hw))) return IoResult::kSendFail;
        if (payloadBytes) {
          if (!writeFull(fd, payload, payloadBytes))
            return IoResult::kSendFail;
          if (crc) {
            uint32_t c = crc32Of(payload, payloadBytes);
            if (!writeFull(fd, &c, sizeof(c))) return IoResult::kSendFail;
          }
        }
        uint8_t ack = 0;
        if (!readFull(fd, &ack, 1)) return IoResult::kReplyFail;
        if (ack == kAckCrcRetry) {
          // Server saw a torn payload and did NOT run the rule: always
          // retriable, even for a rule=add push.
          g_crcFailCount.fetch_add(1, std::memory_order_relaxed);
          return IoResult::kCrcRetry;
        }
        if (ackOut) *ackOut = ack;
        appliedButNacked = (ack != kAckApplied);
        return IoResult::kOk;  // transport ok; ack carries the outcome
      },
      idempotent, corr);
  return (ok && !appliedButNacked) ? 1 : 0;
}

}  // namespace

// ------------------------------------------------------------------- C ABI

extern "C" {

// Size the client offload pool (effective before the first async op; a
// live pool is not resized).  Mirrors torchmpi_set_num_buffers-style knob
// plumbing for kNumThreadsPerParameterServer (constants.cpp:152-155).
void tmpi_ps_set_pool_size(int n) {
  std::lock_guard<std::mutex> lk(g().mu);
  if (n > 0 && !g().pool) g().poolSize = n;
}

// --- server lifecycle ---

// Start a shard server listening on `port` (0 = ephemeral).  Returns a
// server id > 0, or -1 on failure.
int tmpi_ps_server_start(int port) {
  auto srv = std::make_unique<Server>(port);
  if (!srv->ok()) return -1;
  std::lock_guard<std::mutex> lk(g().mu);
  int id = g().nextServer++;
  g().servers[id] = std::move(srv);
  return id;
}

int tmpi_ps_server_port(int server) {
  std::lock_guard<std::mutex> lk(g().mu);
  auto it = g().servers.find(server);
  return it == g().servers.end() ? -1 : it->second->port();
}

void tmpi_ps_server_stop(int server) {
  std::unique_ptr<Server> srv;
  {
    std::lock_guard<std::mutex> lk(g().mu);
    auto it = g().servers.find(server);
    if (it == g().servers.end()) return;
    srv = std::move(it->second);
    g().servers.erase(it);
  }
  srv->stop();
}

// --- server durability + crash-restart failover (docs/parameterserver.md
//     "Durability & crash-restart failover") ---

// Attach a durability directory to a running server: restore the newest
// snapshot that VALIDATES (torn files counted in
// tmpi_ps_snapshot_torn_count and skipped), bump + persist the serving
// epoch, start the cadence writer.  Returns the number of shards
// restored, -1 for an unknown server or empty dir.  Control-plane call:
// held under the global lock, so issue it before serving traffic.
int tmpi_ps_restore_dir(int server, const char* dir) {
  if (dir == nullptr || *dir == '\0') return -1;
  std::lock_guard<std::mutex> lk(g().mu);
  auto it = g().servers.find(server);
  if (it == g().servers.end()) return -1;
  return it->second->attachDir(dir);
}

// On-demand durable snapshot (the cadence writer's manual trigger).
// Returns 1 on a landed snapshot file, 0 otherwise (no directory
// attached, or the write failed — counted in tmpi_ps_snapshot_error_count).
int tmpi_ps_snapshot(int server) {
  std::lock_guard<std::mutex> lk(g().mu);
  auto it = g().servers.find(server);
  if (it == g().servers.end()) return 0;
  return it->second->writeSnapshot() ? 1 : 0;
}

// The server's serving epoch (0 = no durability attached / unknown id).
uint64_t tmpi_ps_server_epoch(int server) {
  std::lock_guard<std::mutex> lk(g().mu);
  auto it = g().servers.find(server);
  return it == g().servers.end() ? 0 : it->second->epoch();
}

// Fault seam: the server applies the next n pushes but drops each ack and
// kills the connection — the deterministic in-process stand-in for
// "applied, crashed before the ack", the ambiguity the epoch fence +
// copy re-seed exist to resolve.  Drill/test surface only.
void tmpi_ps_server_drop_push_acks(int server, int n) {
  std::lock_guard<std::mutex> lk(g().mu);
  auto it = g().servers.find(server);
  if (it != g().servers.end()) it->second->dropPushAcks(n);
}

// Cadence of the background snapshot writer in ms (runtime/config.py:
// ps_snapshot_interval_ms); 0 = on-demand only.  Process-wide, read by
// every attached server's writer each cycle.
void tmpi_ps_set_snapshot_interval_ms(int ms) {
  g_snapshotIntervalMs.store(ms < 0 ? 0 : ms);
}

// Drill seam: arm the snapshot crash countdown — the nth snapshot write
// from now _exit(137)s between the tmp-file fsync and the atomic rename
// (the torn-file window).  0 disarms.  Drill/test surface only.
void tmpi_ps_set_snapshot_crash_point(int nth) {
  g_snapshotCrashNth.store(nth < 0 ? 0 : nth);
}

// Durability observables (monotonic per process, scraped into the metrics
// registry by obs/metrics.scrape_native like the retry/timeout/CRC set).
uint64_t tmpi_ps_snapshot_count() {
  return g_snapshotCount.load(std::memory_order_relaxed);
}

uint64_t tmpi_ps_snapshot_error_count() {
  return g_snapshotErrorCount.load(std::memory_order_relaxed);
}

uint64_t tmpi_ps_snapshot_restore_count() {
  return g_snapshotRestoreCount.load(std::memory_order_relaxed);
}

// Snapshot files REJECTED by restore validation (magic/version/bounds/CRC)
// — each one was skipped, never loaded; restore fell back to an older
// file.  "Zero torn restores" means this counting never turned into a
// load, not that the counter is zero.
uint64_t tmpi_ps_snapshot_torn_count() {
  return g_snapshotTornCount.load(std::memory_order_relaxed);
}

// Pushes the server NACKed with kAckEpochFenced (stale epoch; the rule
// did not run).
uint64_t tmpi_ps_epoch_fence_count() {
  return g_epochFenceCount.load(std::memory_order_relaxed);
}

// Fenced NACKs this process's CLIENT received.  Distinct from the above
// on purpose: with the server in its own (killable) process the server
// counter dies with it, while this one is the survivor's audit trail —
// the failover drill asserts the fenced path fired through it.
uint64_t tmpi_ps_client_fenced_count() {
  return g_clientFencedCount.load(std::memory_order_relaxed);
}

// --- client peers ---

// Register a server endpoint; returns a peer id used in the calls below.
int tmpi_ps_connect(const char* host, int port) {
  std::lock_guard<std::mutex> lk(g().mu);
  int id = g().nextPeer++;
  g().peers[id] = std::make_shared<Peer>(host ? host : "127.0.0.1", port);
  return id;
}

void tmpi_ps_disconnect(int peer) {
  std::lock_guard<std::mutex> lk(g().mu);
  g().peers.erase(peer);
}

// --- synchronous primitives (building blocks; Python composes per-shard) ---

// force=1: always (re)allocate the shard to zero; force=0: create-if-absent,
// keeping a matching existing shard's contents (late-worker registration).
int tmpi_ps_create(int peer, uint64_t instance, uint64_t count, uint32_t dtype,
                   int force) {
  Header h{kMagic, kCreate, instance, static_cast<uint32_t>(force != 0),
           dtype, 0, count, 0};
  const uint64_t corr = psCorr();
  g_psTrace.emit(kTracePlanePs, kTOpCreate, kPhStart, peer, 0, corr);
  int ok = requestAck(findPeer(peer), h, nullptr, 0, /*idempotent=*/true,
                      corr);
  g_psTrace.emit(kTracePlanePs, kTOpCreate, ok ? kPhComplete : kPhError,
                 peer, 0, corr);
  return ok;
}

// corr-parameterized impls: the sync ABI fns pass the current stamp, the
// async lambdas pass the id they captured at enqueue time.  ``epoch`` is
// the push fence stamp (0 = unfenced); returns 1 applied, 0 failed, -2
// epoch-fenced (the server restarted from a snapshot since the client
// learned its epoch — the rule provably did NOT run, and the Python
// failover path must re-register, re-seed via idempotent copy, and replay).
static int psPush(uint64_t corr, int peer, uint64_t instance, uint32_t rule,
                  uint32_t dtype, uint64_t offset, uint64_t count,
                  const void* data, uint64_t epoch) {
  Header h{kMagic, kPush, instance, rule, dtype, offset, count, epoch};
  const uint64_t bytes = count * dtypeSize(dtype);
  g_psTrace.emit(kTracePlanePs, kTOpPush, kPhStart, peer, bytes, corr);
  // Not idempotent: rule=add applied twice would double-count.
  uint8_t ack = 0;
  int ok = requestAck(findPeer(peer), h, data, bytes,
                      /*idempotent=*/false, corr, &ack);
  g_psTrace.emit(kTracePlanePs, kTOpPush, ok ? kPhComplete : kPhError,
                 peer, bytes, corr);
  if (!ok && ack == kAckEpochFenced) {
    g_clientFencedCount.fetch_add(1, std::memory_order_relaxed);
    return -2;
  }
  return ok;
}

int tmpi_ps_push(int peer, uint64_t instance, uint32_t rule, uint32_t dtype,
                 uint64_t offset, uint64_t count, const void* data) {
  return psPush(psCorr(), peer, instance, rule, dtype, offset, count, data,
                /*epoch=*/0);
}

// Fenced push: like tmpi_ps_push but stamps the serving epoch the client
// learned at registration/failover (tmpi_ps_fetch_epoch).  Returns -2 when
// the server NACKed the stale epoch (rule never ran); 0 degrades to the
// unfenced wire format semantics.
int tmpi_ps_push_fenced(int peer, uint64_t instance, uint32_t rule,
                        uint32_t dtype, uint64_t offset, uint64_t count,
                        const void* data, uint64_t epoch) {
  return psPush(psCorr(), peer, instance, rule, dtype, offset, count, data,
                epoch);
}

static int psPull(uint64_t corr, int peer, uint64_t instance, uint32_t dtype,
                  uint64_t offset, uint64_t count, void* out) {
  std::shared_ptr<Peer> p = findPeer(peer);
  const uint64_t traceBytes = count * dtypeSize(dtype);
  g_psTrace.emit(kTracePlanePs, kTOpPull, kPhStart, peer, traceBytes, corr);
  if (!p) {
    g_psTrace.emit(kTracePlanePs, kTOpPull, kPhError, peer, traceBytes, corr);
    return 0;
  }
  bool shortRead = false;
  bool ok = p->withConnection(
      [&](int fd) {
        const bool crc = g_frameCrc.load();
        Header h{crc ? kMagicCrc : kMagic, kPull, instance, 0, dtype,
                 offset, count, 0};
        shortRead = false;  // reset per attempt (retries re-run the lambda)
        if (!writeFull(fd, &h, sizeof(h))) return IoResult::kSendFail;
        uint64_t got = 0;
        if (!readFull(fd, &got, sizeof(got))) return IoResult::kReplyFail;
        if (got != count) {  // missing/mismatched instance on the server
          shortRead = true;
          // Drain to a scratch buffer to keep the stream framed — NEVER
          // into `out`, whose capacity is exactly `count` elements.  A
          // reply above the frame cap means a corrupt stream: reset.
          if (got) {
            if (!frameWithinCap(got, dtypeSize(dtype)))
              return IoResult::kReplyFail;
            std::vector<char> scratch(got * dtypeSize(dtype));
            if (!readFull(fd, scratch.data(), scratch.size()))
              return IoResult::kReplyFail;
            uint32_t wire = 0;   // drain the trailer too, value irrelevant
            if (crc && !readFull(fd, &wire, sizeof(wire)))
              return IoResult::kReplyFail;
          }
          return IoResult::kOk;
        }
        if (!readFull(fd, out, got * dtypeSize(dtype)))
          return IoResult::kReplyFail;
        if (crc && got) {
          uint32_t wire = 0;
          if (!readFull(fd, &wire, sizeof(wire)))
            return IoResult::kReplyFail;
          if (wire != crc32Of(out, got * dtypeSize(dtype))) {
            // Damaged shard bytes detected BEFORE the caller sees them;
            // pull is idempotent, so retry unconditionally.
            g_crcFailCount.fetch_add(1, std::memory_order_relaxed);
            return IoResult::kCrcRetry;
          }
        }
        return IoResult::kOk;
      },
      /*retry_after_reply_loss=*/true, corr);  // pull is idempotent
  int ret = (ok && !shortRead) ? 1 : 0;
  g_psTrace.emit(kTracePlanePs, kTOpPull, ret ? kPhComplete : kPhError,
                 peer, traceBytes, corr);
  return ret;
}

int tmpi_ps_pull(int peer, uint64_t instance, uint32_t dtype, uint64_t offset,
                 uint64_t count, void* out) {
  return psPull(psCorr(), peer, instance, dtype, offset, count, out);
}

int tmpi_ps_free_instance(int peer, uint64_t instance) {
  Header h{kMagic, kFree, instance, 0, kU8, 0, 0, 0};
  const uint64_t corr = psCorr();
  g_psTrace.emit(kTracePlanePs, kTOpFreeInstance, kPhStart, peer, 0, corr);
  int ok = requestAck(findPeer(peer), h, nullptr, 0, /*idempotent=*/true,
                      corr);
  g_psTrace.emit(kTracePlanePs, kTOpFreeInstance,
                 ok ? kPhComplete : kPhError, peer, 0, corr);
  return ok;
}

int tmpi_ps_free_all(int peer) {
  Header h{kMagic, kFreeAll, 0, 0, kU8, 0, 0, 0};
  const uint64_t corr = psCorr();
  g_psTrace.emit(kTracePlanePs, kTOpFreeAll, kPhStart, peer, 0, corr);
  int ok = requestAck(findPeer(peer), h, nullptr, 0, /*idempotent=*/true,
                      corr);
  g_psTrace.emit(kTracePlanePs, kTOpFreeAll, ok ? kPhComplete : kPhError,
                 peer, 0, corr);
  return ok;
}

int tmpi_ps_ping(int peer) {
  Header h{kMagic, kPing, 0, 0, kU8, 0, 0, 0};
  const uint64_t corr = psCorr();
  g_psTrace.emit(kTracePlanePs, kTOpPing, kPhStart, peer, 0, corr);
  int ok = requestAck(findPeer(peer), h, nullptr, 0, /*idempotent=*/true,
                      corr);
  g_psTrace.emit(kTracePlanePs, kTOpPing, ok ? kPhComplete : kPhError,
                 peer, 0, corr);
  return ok;
}

// Serving-epoch probe (kEpoch): the client stamps this value into fenced
// pushes (tmpi_ps_push_fenced / tmpi_ps_push_async_fenced).  Returns 0 on
// failure OR when the server has no durability directory attached —
// epoch 0 IS the unfenced stamp, so fence-less deployments degrade to the
// pre-durability wire behaviour with no special-casing anywhere.
uint64_t tmpi_ps_fetch_epoch(int peer) {
  std::shared_ptr<Peer> p = findPeer(peer);
  const uint64_t corr = psCorr();
  g_psTrace.emit(kTracePlanePs, kTOpEpoch, kPhStart, peer, 0, corr);
  uint64_t ep = 0;
  bool ok = p && p->withConnection(
      [&](int fd) {
        Header h{kMagic, kEpoch, 0, 0, kU8, 0, 0, 0};
        if (!writeFull(fd, &h, sizeof(h))) return IoResult::kSendFail;
        if (!readFull(fd, &ep, sizeof(ep))) return IoResult::kReplyFail;
        return IoResult::kOk;
      },
      /*retry_after_reply_loss=*/true, corr);  // read-only: idempotent
  g_psTrace.emit(kTracePlanePs, kTOpEpoch, ok ? kPhComplete : kPhError,
                 peer, 0, corr);
  return ok ? ep : 0;
}

// --- replicated-group control plane (docs/parameterserver.md
//     "Replication & shard placement") ---

// Placement probe: fills *epoch_out (placement epoch), *drained_out
// (1 = fenced by a handoff), and successor_out (the forwarding pointer
// "host:port", NUL-terminated, empty when none / mid-handoff) up to
// successor_cap bytes.  Returns 1 ok, 0 on transport failure.
int tmpi_ps_fetch_placement(int peer, uint64_t* epoch_out,
                            uint64_t* drained_out, char* successor_out,
                            int successor_cap) {
  std::shared_ptr<Peer> p = findPeer(peer);
  const uint64_t corr = psCorr();
  g_psTrace.emit(kTracePlanePs, kTOpPlacement, kPhStart, peer, 0, corr);
  uint64_t reply[3] = {0, 0, 0};
  std::string succ;
  bool ok = p && p->withConnection(
      [&](int fd) {
        Header h{kMagic, kPlacementEpoch, 0, 0, kU8, 0, 0, 0};
        succ.clear();
        if (!writeFull(fd, &h, sizeof(h))) return IoResult::kSendFail;
        if (!readFull(fd, reply, sizeof(reply)))
          return IoResult::kReplyFail;
        if (reply[2] > 512) return IoResult::kReplyFail;  // corrupt stream
        if (reply[2]) {
          succ.resize(reply[2]);
          if (!readFull(fd, &succ[0], succ.size()))
            return IoResult::kReplyFail;
        }
        return IoResult::kOk;
      },
      /*retry_after_reply_loss=*/true, corr);  // read-only: idempotent
  if (ok) {
    if (epoch_out) *epoch_out = reply[0];
    if (drained_out) *drained_out = reply[1];
    if (successor_out && successor_cap > 0) {
      size_t n = std::min(succ.size(),
                          static_cast<size_t>(successor_cap - 1));
      std::memcpy(successor_out, succ.data(), n);
      successor_out[n] = '\0';
    }
  }
  g_psTrace.emit(kTracePlanePs, kTOpPlacement, ok ? kPhComplete : kPhError,
                 peer, 0, corr);
  return ok ? 1 : 0;
}

// Publish a placement epoch to a server (monotonic max server-side):
// clients that changed their membership view (promotion, handoff) push
// the new epoch so late joiners fetch a current one.  Idempotent.
int tmpi_ps_set_placement_epoch(int peer, uint64_t epoch) {
  Header h{kMagic, kSetPlacementEpoch, 0, 0, kU8, 0, 0, epoch};
  return requestAck(findPeer(peer), h, nullptr, 0, /*idempotent=*/true,
                    psCorr());
}

// Live shard handoff: tell the server behind `peer` to ship every shard
// to host:port, then fence itself at `placement_epoch` behind a
// forwarding pointer.  Returns 1 once the ship completed and the fence
// is up; 0 on a torn ship (tmpi_ps_handoff_torn_count — the old owner
// keeps serving) or transport failure.  NOT retried on a lost reply: a
// reply lost after a completed ship would re-run a ship on a drained
// server (which refuses, returning 0) — the caller probes
// tmpi_ps_fetch_placement to disambiguate, like a fenced push.
int tmpi_ps_handoff(int peer, const char* host, int port,
                    uint64_t placement_epoch) {
  char ep[560];
  std::snprintf(ep, sizeof(ep), "%s:%d", host ? host : "", port);
  size_t n = std::strlen(ep);
  Header h{kMagic, kHandoff, 0, 0, kU8, 0, n, placement_epoch};
  const uint64_t corr = psCorr();
  g_psTrace.emit(kTracePlanePs, kTOpHandoff, kPhStart, peer, 0, corr);
  int ok = requestAck(findPeer(peer), h, ep, n, /*idempotent=*/false, corr);
  g_psTrace.emit(kTracePlanePs, kTOpHandoff, ok ? kPhComplete : kPhError,
                 peer, 0, corr);
  return ok;
}

// Promotion fence: drain the server behind `peer` at `placement_epoch`
// with NO successor (kind 2 in the placement probe).  Sent best-effort
// by a client that just promoted past the server: if the "dead" primary
// was merely unreachable to that client, this stops it accepting writes
// as a second owner, and every other client converges to the same
// post-promotion map through its own NACK → probe → promote path.
// Idempotent.
int tmpi_ps_drain(int peer, uint64_t placement_epoch) {
  Header h{kMagic, kDrain, 0, 0, kU8, 0, 0, placement_epoch};
  return requestAck(findPeer(peer), h, nullptr, 0, /*idempotent=*/true,
                    psCorr());
}

// Register (port > 0) or clear (port <= 0) the backup endpoint the
// server forwards `instance`'s applied pushes to.  Clients derive the
// backup from the placement ring and tell the primary — the server has
// no ring of its own.  Idempotent.
int tmpi_ps_set_backup(int peer, uint64_t instance, const char* host,
                       int port) {
  char ep[560];
  size_t n = 0;
  if (port > 0) {
    std::snprintf(ep, sizeof(ep), "%s:%d", host ? host : "", port);
    n = std::strlen(ep);
  }
  Header h{kMagic, kSetBackup, instance, 0, kU8, 0, n, 0};
  return requestAck(findPeer(peer), h, n ? ep : nullptr, n,
                    /*idempotent=*/true, psCorr());
}

// Replication/handoff observables (monotonic per process; scraped into
// the metrics registry as tmpi_ps_forward_total / _forward_error_total /
// _handoff_total / _handoff_torn_total).
uint64_t tmpi_ps_forward_count() {
  return g_forwardCount.load(std::memory_order_relaxed);
}

uint64_t tmpi_ps_forward_error_count() {
  return g_forwardErrorCount.load(std::memory_order_relaxed);
}

uint64_t tmpi_ps_handoff_count() {
  return g_handoffCount.load(std::memory_order_relaxed);
}

uint64_t tmpi_ps_handoff_torn_count() {
  return g_handoffTornCount.load(std::memory_order_relaxed);
}

// Bound (items) on each server's pending-forward queue (runtime/config:
// ps_forward_queue_max); overflow drops the OLDEST frame and counts it
// in tmpi_ps_forward_error_count.  Non-positive values leave it unchanged.
void tmpi_ps_set_forward_queue_max(int n) {
  if (n > 0) g_forwardQueueMax.store(n);
}

// The placement epoch a LOCAL (in-process) server currently serves —
// the in-process counterpart of tmpi_ps_fetch_placement, for tests and
// the drill's audit lines.
uint64_t tmpi_ps_server_placement_epoch(int server) {
  std::lock_guard<std::mutex> lk(g().mu);
  auto it = g().servers.find(server);
  return it == g().servers.end() ? 0 : it->second->placementEpoch();
}

// --- async offload (reference: clientSend/clientReceive on the PS pool,
//     parameterserver.cpp:309-400) ---

// Async push: returns a handle; tmpi_ps_wait(handle) -> 1 on success.
// `data` must stay alive until the handle is waited on (Python keeps the
// buffer referenced, the analogue of the reference's retained storages).
int64_t tmpi_ps_push_async(int peer, uint64_t instance, uint32_t rule,
                           uint32_t dtype, uint64_t offset, uint64_t count,
                           const void* data) {
  const uint64_t corr = psCorr();  // captured now, carried onto the pool
  g_psTrace.emit(kTracePlanePs, kTOpPush, kPhEnqueue, peer,
                 count * dtypeSize(dtype), corr);
  auto task = std::make_shared<std::packaged_task<int()>>([=] {
    return psPush(corr, peer, instance, rule, dtype, offset, count, data,
                  /*epoch=*/0);
  });
  auto fut = task->get_future().share();
  return registerAndEnqueue(task, std::move(fut));
}

// Fenced async push: tmpi_ps_wait(handle) returns 1 applied, 0 failed, -2
// epoch-fenced (see tmpi_ps_push_fenced).
int64_t tmpi_ps_push_async_fenced(int peer, uint64_t instance, uint32_t rule,
                                  uint32_t dtype, uint64_t offset,
                                  uint64_t count, const void* data,
                                  uint64_t epoch) {
  const uint64_t corr = psCorr();
  g_psTrace.emit(kTracePlanePs, kTOpPush, kPhEnqueue, peer,
                 count * dtypeSize(dtype), corr);
  auto task = std::make_shared<std::packaged_task<int()>>([=] {
    return psPush(corr, peer, instance, rule, dtype, offset, count, data,
                  epoch);
  });
  auto fut = task->get_future().share();
  return registerAndEnqueue(task, std::move(fut));
}

int64_t tmpi_ps_pull_async(int peer, uint64_t instance, uint32_t dtype,
                           uint64_t offset, uint64_t count, void* out) {
  const uint64_t corr = psCorr();
  g_psTrace.emit(kTracePlanePs, kTOpPull, kPhEnqueue, peer,
                 count * dtypeSize(dtype), corr);
  auto task = std::make_shared<std::packaged_task<int()>>([=] {
    return psPull(corr, peer, instance, dtype, offset, count, out);
  });
  auto fut = task->get_future().share();
  return registerAndEnqueue(task, std::move(fut));
}

// Server-exception counter (see serveConnection): the number of
// connections the server dropped because a worker threw.  Monotonic per
// process; a nonzero delta across a test run means a server-side bug, not
// a hostile client.
uint64_t tmpi_ps_server_exception_count() {
  return g_serverExceptions.load(std::memory_order_relaxed);
}

// --- client-resilience observables & knobs (the chaos-drill surface,
//     alongside tmpi_ps_server_exception_count; monotonic per process) ---

// Re-attempts after a failed request attempt (connect failure, send
// failure, lost reply on an idempotent op, CRC NACK).
uint64_t tmpi_ps_retry_count() {
  return g_retryCount.load(std::memory_order_relaxed);
}

// Expired per-request socket deadlines (SO_RCVTIMEO/SO_SNDTIMEO hits).
uint64_t tmpi_ps_timeout_count() {
  return g_timeoutCount.load(std::memory_order_relaxed);
}

// Client-detected frame-integrity faults: push payloads the server NACKed
// before running the rule, and pull replies whose trailer mismatched.
uint64_t tmpi_ps_crc_failure_count() {
  return g_crcFailCount.load(std::memory_order_relaxed);
}

// Retry budget + backoff shape (runtime/config.py: ps_retry_max,
// ps_retry_backoff_ms, ps_retry_backoff_max_ms).  Effective immediately;
// non-positive arguments leave the corresponding knob unchanged.
void tmpi_ps_set_retry(int max_attempts, int backoff_ms, int backoff_max_ms) {
  if (max_attempts > 0) g_retryMax.store(max_attempts);
  if (backoff_ms > 0) g_backoffMs.store(backoff_ms);
  if (backoff_max_ms > 0) g_backoffMaxMs.store(backoff_max_ms);
}

// Per-request socket deadline in ms; 0 restores wait-forever.  Applies to
// connections opened after the call (existing ones keep their deadline).
void tmpi_ps_set_request_deadline_ms(int ms) {
  g_deadlineMs.store(ms < 0 ? 0 : ms);
}

// CRC32 frame trailers on client requests (and, via the kMagicCrc
// request magic, on the matching pull replies).  Per-request: servers
// accept both magics, so flipping this mid-run is safe.
void tmpi_ps_set_frame_crc(int on) {
  g_frameCrc.store(on != 0);
}

// --- observability plane (_native/trace.h; Python side: torchmpi_tpu/obs) ---

// Enable/disable the process-wide trace ring and (capacity > 0) resize it;
// resizing drops buffered events.  Off by default: every emit site is one
// relaxed atomic load + branch then (runtime/config.py: obs_trace /
// obs_trace_ring_capacity, pushed by obs/native.apply_config).
void tmpi_ps_set_trace(int enabled, int capacity) {
  g_psTrace.configure(enabled != 0, capacity);
}

// Drain up to max_events oldest-first into out (32-byte records, trace.h;
// obs/native.py:EVENT_DTYPE mirrors the layout).  Returns events copied.
int tmpi_ps_trace_drain(void* out, int max_events) {
  return g_psTrace.drain(static_cast<TmpiTraceEvent*>(out), max_events);
}

// Monotonic count of events dropped by the ring (drop-oldest on overflow).
uint64_t tmpi_ps_trace_dropped() {
  return g_psTrace.dropped();
}

// Stamp the correlation id carried by subsequent client-op trace events
// (0 clears).  Process-wide for sync ops; async ops capture it at enqueue
// and replay it on the offload pool, so a span that dispatches a batch of
// pushes owns every resulting native event.
void tmpi_ps_set_correlation(uint64_t correlation) {
  g_psCorrelation.store(correlation, std::memory_order_relaxed);
}

// Cross-rank clock alignment: subsequent trace events are stamped
// `CLOCK_MONOTONIC - offset_ns`, the common reference-rank timeline the
// clocksync exchange estimated (obs/clocksync.py publishes per-rank
// offsets; obs/clocksync.apply pushes them here).  0 restores raw
// monotonic stamps.
void tmpi_ps_set_clock_offset(int64_t offset_ns) {
  g_psTrace.setClockOffset(offset_ns);
}

// Wait for an async handle; returns the operation's status (1 ok, 0 failed),
// -1 for an unknown handle.  Handles are single-use (erased on wait), like
// the reference's synchronize-and-forget futures (resources.cpp:422-428) —
// but a handle a FENCE already drained still reports its recorded result
// (sync_all must not fail another caller's held handle).
//
// ABI BOUND (kMaxCompleted = 4096): results recorded by tmpi_ps_sync_all
// for not-yet-waited handles are retained for at most the 4096 most
// recently drained handles, evicted in completion FIFO order (the result
// drained longest ago goes first).  A caller that lets more than 4096
// drained handles age before waiting sees -1 (unknown) for the evicted
// ones — treat -1 after a fence as "result aged out", not as failure.
// sync_all moves each future's result into the completed map under the
// same lock hold that removes it from the futures map, so a concurrent
// wait() on a drained handle finds it in one map or the other — never a
// transient -1.
int tmpi_ps_wait(int64_t handle) {
  std::shared_future<int> fut;
  {
    std::lock_guard<std::mutex> lk(g().mu);
    auto it = g().futures.find(handle);
    if (it == g().futures.end()) {
      auto done = g().completed.find(handle);
      if (done == g().completed.end()) return -1;
      int r = done->second;
      g().completed.erase(done);
      return r;
    }
    fut = it->second;
    g().futures.erase(it);
  }
  return fut.get();
}

// Drain every outstanding future (reference: syncAll, resources.cpp:463-481).
// Results are retained (bounded) so the owners' later wait() still sees them.
//
// The futures map is COPIED (not swapped) up front, and each future is
// moved futures->completed under ONE lock hold only after its result is
// ready: a concurrent wait() during the drain finds the future still
// registered (and waits the shared_future itself), or finds the recorded
// result — the swap-then-record window that could return -1 is gone.  A
// handle the owner waits mid-drain disappears from the futures map; the
// recording step sees that and skips it (wait already consumed the
// result).  Waiting outside the lock stays mandatory: pool workers take
// g().mu via findPeer, so holding it across .get() would deadlock.
void tmpi_ps_sync_all() {
  std::map<int64_t, std::shared_future<int>> futures;
  {
    std::lock_guard<std::mutex> lk(g().mu);
    futures = g().futures;
  }
  for (auto& kv : futures) {
    int r = kv.second.get();
    std::lock_guard<std::mutex> lk(g().mu);
    auto it = g().futures.find(kv.first);
    if (it == g().futures.end()) continue;  // owner's wait() got there first
    g().futures.erase(it);
    g().completed[kv.first] = r;
    g().completedOrder.push_back(kv.first);
    // Evict in completion FIFO order.  Bounding the ORDER deque (not just
    // the map) keeps both structures at kMaxCompleted: fronts whose
    // result a wait() already consumed erase nothing (stale ids, lazily
    // skipped), and the oldest live result goes first otherwise.
    while (g().completedOrder.size() > kMaxCompleted) {
      g().completed.erase(g().completedOrder.front());
      g().completedOrder.pop_front();
    }
  }
}

// Full teardown: drain, drop peers, stop servers (reference: torchmpi_stop
// joining the PS thread, torch_mpi.cpp:282-306).
void tmpi_ps_shutdown() {
  tmpi_ps_sync_all();
  std::map<int, std::unique_ptr<Server>> servers;
  std::unique_ptr<ThreadPool> pool;
  {
    std::lock_guard<std::mutex> lk(g().mu);
    servers.swap(g().servers);
    pool.swap(g().pool);
  }
  // Pool teardown joins workers which may still be touching peers -- destroy
  // it outside the global lock (workers take g().mu via findPeer).
  pool.reset();
  {
    std::lock_guard<std::mutex> lk(g().mu);
    g().peers.clear();
  }
  for (auto& kv : servers) kv.second->stop();
}

}  // extern "C"
