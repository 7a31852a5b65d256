// Ring collectives for Hopper (sm_90a) between processes, behind a plain C
// interface that torchmpi_tpu_torch/collectives/cuda_ring.py binds with
// ctypes: the fused ring allreduce (B1), the ring reduce-scatter (B2) and the
// ring allgather (B3).
//
// Replaces torchmpi_tpu/collectives/pallas_ring.py:_ar_kernel, _rs_kernel
// and _ag_kernel.  Same schedule: reduce-scatter step s sends chunk
// (me-s-1) mod p and adds the arriving chunk into (me-s-2) mod p; allgather
// step s forwards (me-s) mod p and stores the arriving (me-s-1) mod p; the
// allreduce runs both phases in one collective call.  The running sum stays in the
// wire dtype (f32, bf16 rounded after every add, int32 wrapping), so with
// the same chunks the results are bit-identical to the JAX package's.
//
// Design, chosen by a probe (tools/ring_probe.py with tools/csrc/
// ring_probe.cu; PERF.md).  Every rank of the chip run binds the one card,
// and without MPS the card time-slices the ranks' contexts instead of
// running their kernels at once.  The probe
// ping-ponged one flag between two processes on one H100: a kernel spinning
// on the flag took 4.49 ms a round trip, as did one launch per half trip
// with the wait inside the kernel (a spinning kernel holds the card until
// its time slice ends), while a wait in the stream (cuStreamWaitValue64)
// took 0.287 ms.  So a ring step is not a spin inside one fused kernel but,
// as in the reference's IPC ring (detail/collectives_cuda.cpp:202-388), a
// launch per half step ordered across processes in the streams:
//   1. wait in the stream until credit >= k + 1 - nslots (the right
//      neighbour has consumed the slot about to be reused);
//   2. SEND kernel: my chunk into the right neighbour's slot k % nslots
//      (mapped through cudaIpc), then its last block raises the
//      neighbour's data word to k + 1 (an atomic max with release);
//   3. wait in the stream until my data word >= k + 1;
//   4. ADD (reduce-scatter) or STORE (allgather) kernel: my slot into my
//      chunk, then its last block raises the left neighbour's credit word
//      to k + 1.
// k counts a rank's sends on the ring over every call, so no word is ever
// reset under a racing peer, and the words stand in for the TPU kernel's DMA
// semaphores, capacity credits and barrier.  The orders across processes
// come from the stream waits on those monotone words rather than from
// interprocess events, which would need a host handshake per step to know
// that the peer's record is the current one.
//
// Staging: each rank owns one cudaMalloc'd block per (communicator,
// collective id), a page of flag words then nslots slots of one chunk each,
// mapped into its neighbours once through cudaIpcOpenMemHandle (handles
// swapped over the process group).  Slot reads go through L2 (__ldcg), never
// a stale L1 line.  The JAX sub-chunk count q (max_buffer_size pieces) only
// shapes the padding (rows is a multiple of q); a step here is one grid.
//
// Bounded waits: a stream wait cannot time out by itself, so the host bounds
// each call (cuda_ring.RING_TIMEOUT_S): past the deadline it sets this
// rank's error word and raises the rank's own data and credit words past
// any step (tmpi_ring_abort, from a stream of its own).  The queued waits
// then pass, every queued kernel sees the error word and does nothing (so a
// rank that gave up never signals a neighbour, which times out in turn), and
// the host raises naming the rank, the collective id and the step.  A
// neighbour that arrives after the abort signals with an atomic max, so it
// cannot pull a raised word back under a wait still queued; the host bounds
// the drain after the abort too.
//
// Bound on one card.  Every rank's traffic shares one HBM.  Per call a rank
// copies its input into the working buffer (p chunks read and written),
// then per reduce-scatter step reads a chunk and writes it to the peer's
// slot, reads the slot and its partial and writes the partial (5 chunks),
// and per allgather step moves 4 chunks.  For an allreduce of n elements of
// b bytes over p ranks that is, all ranks together, 2pnb + 9(p-1)nb bytes
// (ResNet-50's 102.2 MB of f32 gradients at p = 2: 1.33 GB, 0.40 ms at
// 3.35 TB/s).  The function itself must read every rank's input once and
// write every rank's output once: 2pnb (0.12 ms), the bound chip_smoke.py
// states.  Neither is an NVLink bound: nothing here crosses a link.  What
// costs most on one card is neither: each step waits for the card to switch
// to the neighbour's context.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Raise *p to at least v, releasing this thread's earlier writes to the
// system.  A max, not a store: a neighbour that signals late, after this
// rank's host gave up and raised its words past any step, cannot lower them
// again under a stream wait still queued.
__device__ __forceinline__ void signal_max(uint64_t* p, uint64_t v) {
  asm volatile("red.release.sys.global.max.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}


// ---- the ring ---------------------------------------------------------------

constexpr int ERR_WORD = 0;        // 0, or set by the host when it gives up
constexpr int DATA_WORD = 1;       // chunks delivered into my slots (by left)
constexpr int CREDIT_WORD = 2;     // my sends consumed by right (by right)
constexpr int COUNT_WORD = 3;      // blocks done with this rank's kernel
constexpr int FLAG_BYTES = 256;    // the flag page in front of the slots
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1056;   // 8 blocks on each of the 132 SMs
constexpr int LANE = 128;

template <typename T> struct Vec;
template <> struct Vec<float> {
  static __device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
    uint4 r;
    r.x = __float_as_uint(__uint_as_float(a.x) + __uint_as_float(b.x));
    r.y = __float_as_uint(__uint_as_float(a.y) + __uint_as_float(b.y));
    r.z = __float_as_uint(__uint_as_float(a.z) + __uint_as_float(b.z));
    r.w = __float_as_uint(__uint_as_float(a.w) + __uint_as_float(b.w));
    return r;
  }
};
template <> struct Vec<int> {
  static __device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
    return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  // Each bf16 sum is formed in f32 and rounded to nearest even, as a bf16
  // add does in PyTorch and in XLA.
  static __device__ __forceinline__ unsigned int add2(unsigned int a,
                                                      unsigned int b) {
    __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
    __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
    float2 fx = __bfloat1622float2(x), fy = __bfloat1622float2(y);
    __nv_bfloat162 r = __floats2bfloat162_rn(fx.x + fy.x, fx.y + fy.y);
    return *reinterpret_cast<unsigned int*>(&r);
  }
  static __device__ __forceinline__ uint4 add(uint4 a, uint4 b) {
    return make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z),
                      add2(a.w, b.w));
  }
};

enum StepOp { SEND = 0, ADD = 1, STORE = 2 };

// One half of a ring step over a whole chunk of nvec 16-byte vectors:
//   SEND:  dst (the right neighbour's slot) = src (my chunk), through L2;
//   ADD:   dst (my chunk) = dst + src (my slot), in the wire dtype;
//   STORE: dst (my chunk) = src (my slot).
// Then the last block to finish raises *signal to value (the neighbour's
// data or credit word), with release semantics.  Nothing runs once the host has set the error word,
// so a rank that gave up never signals a neighbour.
template <typename T>
__global__ void __launch_bounds__(THREADS)
step_kernel(int op, const uint4* src, uint4* dst, long long nvec,
            uint64_t* my_flags, uint64_t* signal, uint64_t value) {
  __shared__ int skip;
  if (threadIdx.x == 0) skip = ld_acquire(my_flags + ERR_WORD) != 0;
  __syncthreads();
  if (skip) return;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < nvec; v += stride) {
    if (op == SEND) {
      __stcg(dst + v, src[v]);
    } else {
      const uint4 got = __ldcg(src + v);
      dst[v] = op == ADD ? Vec<T>::add(dst[v], got) : got;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    unsigned int* count =
        reinterpret_cast<unsigned int*>(my_flags + COUNT_WORD);
    if (atomicAdd(count, 1u) == gridDim.x - 1) {
      *count = 0;                       // the next kernel starts after us
      __threadfence_system();
      signal_max(signal, value);
    }
  }
}

typedef CUresult (*StreamValue64Fn)(CUstream, CUdeviceptr, cuuint64_t,
                                    unsigned int);

int driver_fn(const char* name, void** fn) {
  cudaDriverEntryPointQueryResult q;
  cudaError_t e = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &q);
  if (e != cudaSuccess) return (int)e;
  return q == cudaDriverEntryPointSuccess ? 0 : (int)cudaErrorNotSupported;
}

// cuStreamWaitValue64 / cuStreamWriteValue64, looked up once.
int stream_value_fns(StreamValue64Fn* wait, StreamValue64Fn* write) {
  static StreamValue64Fn w = nullptr, x = nullptr;
  if (!w) {
    void* a = nullptr;
    void* b = nullptr;
    int e = driver_fn("cuStreamWaitValue64", &a);
    if (!e) e = driver_fn("cuStreamWriteValue64", &b);
    if (e) return e;
    w = reinterpret_cast<StreamValue64Fn>(a);
    x = reinterpret_cast<StreamValue64Fn>(b);
  }
  *wait = w;
  *write = x;
  return 0;
}

template <typename T>
int launch_step(int op, const void* src, void* dst, long long nvec,
                uint64_t* my_flags, uint64_t* signal, uint64_t value,
                cudaStream_t s) {
  long long blocks = (nvec + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  step_kernel<T><<<(int)blocks, THREADS, 0, s>>>(
      op, static_cast<const uint4*>(src), static_cast<uint4*>(dst), nvec,
      my_flags, signal, value);
  return (int)cudaGetLastError();
}

template <typename T>
int run_ring(int kind, int p, int me, long long chunk, int nslots,
             const char* src, char* out, char* my_slots, char* right_slots,
             uint64_t* my_flags, uint64_t* right_flags, uint64_t* left_flags,
             uint64_t seq_base, cudaStream_t s) {
  StreamValue64Fn wait, write;
  int e = stream_value_fns(&wait, &write);
  if (e) return e;
  const long long bytes = chunk * (long long)sizeof(T);
  const long long nvec = bytes / 16;
  // The working buffer: (p, chunk) for the allreduce and reduce-scatter, my
  // own chunk in row me for the allgather.
  cudaError_t ce = kind == 2
      ? cudaMemcpyAsync(out + me * bytes, src, bytes,
                        cudaMemcpyDeviceToDevice, s)
      : cudaMemcpyAsync(out, src, p * bytes, cudaMemcpyDeviceToDevice, s);
  if (ce != cudaSuccess) return (int)ce;
  const int rs_steps = kind == 2 ? 0 : p - 1;
  const int ag_steps = kind == 1 ? 0 : p - 1;
  for (int t = 0; t < rs_steps + ag_steps; ++t) {
    const bool reduce = t < rs_steps;
    const int st = reduce ? t : t - rs_steps;
    const int send = reduce ? (me - st - 1 + 2 * p) % p
                            : (me - st + 2 * p) % p;
    const int recv = reduce ? (me - st - 2 + 2 * p) % p
                            : (me - st - 1 + 2 * p) % p;
    const uint64_t k = seq_base + t;
    const long long slot = (long long)(k % nslots) * bytes;
    CUresult r = CUDA_SUCCESS;
    if (k >= (uint64_t)nslots)       // right has consumed the slot I reuse
      r = wait((CUstream)s, (CUdeviceptr)(my_flags + CREDIT_WORD),
               k + 1 - nslots, CU_STREAM_WAIT_VALUE_GEQ);
    if (r != CUDA_SUCCESS) return 10000 + (int)r;
    e = launch_step<T>(SEND, out + send * bytes, right_slots + slot, nvec,
                       my_flags, right_flags + DATA_WORD, k + 1, s);
    if (e) return e;
    r = wait((CUstream)s, (CUdeviceptr)(my_flags + DATA_WORD), k + 1,
             CU_STREAM_WAIT_VALUE_GEQ);  // left's chunk is in my slot
    if (r != CUDA_SUCCESS) return 10000 + (int)r;
    e = launch_step<T>(reduce ? ADD : STORE, my_slots + slot,
                       out + recv * bytes, nvec, my_flags,
                       left_flags + CREDIT_WORD, k + 1, s);
    if (e) return e;
  }
  return 0;
}

}  // namespace

// ---- staging memory and its IPC handles ------------------------------------

// The block is zeroed before this returns, on a stream of its own.  The
// caller swaps its IPC handle right after, and a neighbour may send into it
// at once; a memset queued on the default stream would wait for this
// process's pending work (a backward pass) and could then wipe a chunk and
// a data word that the neighbour had already delivered.
extern "C" int tmpi_ring_alloc(size_t bytes, void** out) {
  cudaError_t e = cudaMalloc(out, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s;
  e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(*out, 0, bytes, s);
  cudaError_t e2 = cudaStreamSynchronize(s);
  cudaStreamDestroy(s);
  return (int)(e != cudaSuccess ? e : e2);
}

extern "C" int tmpi_ring_free(void* p) { return (int)cudaFree(p); }

extern "C" int tmpi_ring_ipc_get(void* p, void* handle) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, p);
  if (e == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)e;
}

extern "C" int tmpi_ring_ipc_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int tmpi_ring_ipc_close(void* p) {
  return (int)cudaIpcCloseMemHandle(p);
}

extern "C" int tmpi_ring_ipc_handle_bytes() {
  return (int)sizeof(cudaIpcMemHandle_t);
}


// ---- ring entry points -----------------------------------------------------

// One collective call, enqueued on `stream`: kind 0 allreduce (src (p,
// chunk)), 1 reduce-scatter (src (p, chunk)), 2 allgather (src (chunk));
// out (p, chunk).  dtype 0 f32, 1 bf16, 2 int32; chunk in elements, a
// multiple of 128.  Returns a CUDA error code (10000 + a driver code for a
// refused stream wait).
extern "C" int tmpi_ring_run(int kind, int dtype, int p, int me,
                             long long chunk, int nslots, const void* src,
                             void* out, void* my_slots, void* right_slots,
                             void* my_flags, void* right_flags,
                             void* left_flags, uint64_t seq_base,
                             void* stream) {
  if (kind < 0 || kind > 2 || p < 2 || me < 0 || me >= p || nslots < 1 ||
      chunk < LANE || chunk % LANE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const char* in = static_cast<const char*>(src);
  char* o = static_cast<char*>(out);
  char* ms = static_cast<char*>(my_slots);
  char* rs = static_cast<char*>(right_slots);
  uint64_t* mf = static_cast<uint64_t*>(my_flags);
  uint64_t* rf = static_cast<uint64_t*>(right_flags);
  uint64_t* lf = static_cast<uint64_t*>(left_flags);
  if (dtype == 0)
    return run_ring<float>(kind, p, me, chunk, nslots, in, o, ms, rs, mf, rf,
                           lf, seq_base, s);
  if (dtype == 1)
    return run_ring<__nv_bfloat16>(kind, p, me, chunk, nslots, in, o, ms, rs,
                                   mf, rf, lf, seq_base, s);
  if (dtype == 2)
    return run_ring<int>(kind, p, me, chunk, nslots, in, o, ms, rs, mf, rf,
                         lf, seq_base, s);
  return (int)cudaErrorInvalidValue;
}

// The host gave up on a call: set the error word (so no queued step kernel
// runs or signals a neighbour) and release every stream wait of this rank
// by raising its data and credit words past any step, from a stream of its
// own.  The ring state is unusable afterwards.
extern "C" int tmpi_ring_abort(void* my_flags) {
  StreamValue64Fn wait, write;
  int e = stream_value_fns(&wait, &write);
  if (e) return e;
  cudaStream_t s;
  cudaError_t ce = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (ce != cudaSuccess) return (int)ce;
  uint64_t* f = static_cast<uint64_t*>(my_flags);
  const cuuint64_t past = 1ull << 62;
  CUresult r = write((CUstream)s, (CUdeviceptr)(f + ERR_WORD), 1, 0);
  if (r == CUDA_SUCCESS)
    r = write((CUstream)s, (CUdeviceptr)(f + DATA_WORD), past, 0);
  if (r == CUDA_SUCCESS)
    r = write((CUstream)s, (CUdeviceptr)(f + CREDIT_WORD), past, 0);
  ce = cudaStreamSynchronize(s);
  cudaStreamDestroy(s);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  return (int)ce;
}

// Bytes of the flag page in front of the slots.
extern "C" int tmpi_ring_flag_bytes() { return FLAG_BYTES; }

// Copies the first n flag words of a ring block to the host, on a stream of
// its own: the caller's stream may be held by a wait that never passes.
extern "C" int tmpi_ring_read_flags(const void* flags, uint64_t* out, int n) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(out, flags, n * sizeof(uint64_t),
                      cudaMemcpyDeviceToHost, s);
  cudaError_t e2 = cudaStreamSynchronize(s);
  cudaStreamDestroy(s);
  return (int)(e != cudaSuccess ? e : e2);
}
