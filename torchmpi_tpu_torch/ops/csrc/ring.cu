// Ring collectives for Hopper (sm_90a) between processes, behind a plain C
// interface that torchmpi_tpu_torch/collectives/cuda_ring.py binds with
// ctypes: the allreduce (B1), the reduce-scatter (B2) and the allgather
// (B3), each one-shot.
//
// Every rank of the chip run binds the one card, and without MPS the card
// time-slices the ranks' contexts instead of running their kernels at once.
// A probe (tools/ring_probe.py with tools/csrc/ring_probe.cu; PERF.md)
// ping-ponged one flag between two processes on one H100: a kernel spinning
// on the flag took 4.49 ms a round trip, as did one launch per half trip
// with the wait inside the kernel (a spinning kernel holds the card until
// its time slice ends), while a wait in the stream (cuStreamWaitValue64)
// took 0.287 ms.  So no kernel here spins on a peer: the orders across
// processes come from stream waits on monotone flag words, which a peer's
// kernel raises with a release at system scope.
//
// ---- one-shot: STAGE, one wait, REDUCE or GATHER ----------------------------
//
// Replace torchmpi_tpu/collectives/pallas_ring.py:194 _ar_kernel (B1),
// pallas_ring.py:165 _rs_kernel (B2) and pallas_ring.py:241 _ag_kernel (B3).
// On one time-sliced card each cross-process wait costs a switch of
// contexts, so the design needs as few of them as it can: a rank's k-th
// call on a (communicator, collective id) state is
//   1. STAGE kernel (shared by all three): this rank's input x (n,) into
//      its own staging slot k % 2, which every peer has mapped through
//      cudaIpc; its last block adds 1 to every peer's READY word
//      (red.release.sys.add after __threadfence_system);
//   2. one cuStreamWaitValue64, until this rank's READY word is at least
//      (p-1)(k+1): every peer has staged call k;
//   3. the consumer kernel, which reads slot k % 2 of every rank through L2
//      (__ldcg) and writes the result straight into the output:
//      REDUCE (B1, B2): (n,) for B1, this rank's (n/p,) part for B2, the
//      mean folded in for f32 and bf16;
//      GATHER (B3): row r of the output (p n,) from rank r's slot, for every
//      r.  This rank's own row comes from its own slot too, not from x:
//      the same bytes either way, and every row then takes one path.
// Two launches and one stream wait a call, against 4(p-1)+4 device
// operations and up to 4(p-1) waits of the ring steps B1 and B2 replaced,
// and for B3 a copy-in, 2(p-1) step kernels, up to 2(p-1) waits, and on
// the host the pad's fill and copy and, unless n is a multiple of 128, a
// slice copy of the whole output.
//
// The sum order is the ring's, so the bits are the ring's, the JAX
// package's and the plain schedule's: element i of B1 lies in chunk
// c = i / chunk of the ring's zero-padded layout (chunk = rows * 128, from
// cuda_ring._geometry), and its sum is acc = x[(c+1)%p][i], then
// acc = x[(c+j)%p][i] + acc for j = 2..p, in the wire dtype (bf16 rounded to
// nearest even after every add, int32 wrapping).  B2's rank r sums its
// chunk r, elements [r n/p, (r+1) n/p), in the same order.  Pad positions
// are never returned, so nothing reads or writes them.  The mean is the
// product with the f32 reciprocal of p, rounded to bf16 for bf16: the JAX
// package divides by the constant p, which XLA folds into that product (an
// IEEE division differs by one ulp in about a third of f32 elements at
// p = 3).  int32 takes its mean on the host, to f32.  B3 copies bits: the
// JAX kernel pads each rank's block to (rows, 128) and slices the padding
// off again, so its result is every rank's x in rank order, which GATHER
// writes without any padding, for any n.
//
// Why two slots need no second wait.  At call k a rank overwrites its slot
// k % 2, which its peers last read in their REDUCE or GATHER of call k-2.
// Its wait at call k-1 passed READY >= (p-1)k.  No rank's count of stages
// runs more than one ahead of another's (a rank starts stage t+1 only after
// its wait saw (p-1)t adds, and with every count within one of the others
// that needs every peer at t), so that wait saw every peer's STAGE of call
// k-1, and in each peer's stream that STAGE comes after its REDUCE or
// GATHER of call k-2.  The kind of the consumer does not enter: any mix of
// B1, B2 and B3 calls on one state keeps the argument.
//
// Bytes.  Per call a rank reads n b and writes n b (STAGE), then reads p
// slots and writes its output: at p = 2, 5nb per rank for B1, against
// 13nb/2 for the ring steps' copy-in, sends, adds and stores; (2p+2)nb for
// B3 (6nb at p = 2), against the ring steps' (4p-2)nb, the pad's 3nb and
// the slice's 2pnb (13nb at p = 2).  The function itself must read every
// rank's input once and write every rank's output once: 2pnb for B1
// (ResNet-50's 102.2 MB of f32 gradients at p = 2: 0.409 GB, 0.122 ms at
// 3.35 TB/s), p(n + n/p)b for B2, p(n + pn)b for B3 (0.183 ms at 25.6M f32
// and p = 2): the bounds chip_smoke.py states.  Each is below the card's
// operations-per-byte line by far (B3 does no arithmetic at all), so fewer
// bytes and fewer waits are the only gains.  Nothing here crosses a link.
// Staging is two slots of n b each per (communicator, id): ResNet-50's 8
// rotating engine ids hold about 2 x 9.4 MB each, about 151 MB a rank, and
// a ring of 25.6M f32 elements 205 MB.
//
// Alignment.  16-byte vectors where the input (STAGE), the output and the
// rank's first element (REDUCE), or the output and the row's start (GATHER:
// row r starts r n elements in) allow them; a scalar path otherwise (an
// offset view, B2's chunk r at an odd offset, B3's rows when n is not a
// multiple of the vector's lanes, n = 5) and for the ragged tail.  Slots
// are always 16-byte aligned.
//
// ---- shared by all three --------------------------------------------------
//
// Staging: each rank owns one cudaMalloc'd block per (communicator,
// collective id), a page of flag words then the two slots, mapped into
// every peer once through cudaIpcOpenMemHandle (handles swapped over the
// process group).  Slot reads go through L2 (__ldcg), never a stale L1
// line.
//
// Bounded waits: a stream wait cannot time out by itself, so the host bounds
// each call (cuda_ring.RING_TIMEOUT_S): past the deadline it sets this
// rank's error word and raises the rank's own READY word past any count
// (1 << 62, far from 2^64, so later adds cannot wrap it; tmpi_ring_abort,
// from a stream of its own).  The queued wait then passes, every queued
// kernel sees the error word and does nothing, and the host raises naming
// the rank and the collective id.  A peer that arrives after the abort
// signals with an add, so it cannot pull the raised word back under a wait
// still queued.  A peer that arrives late may find its own wait already
// satisfied (the rank that gave up had staged), so REDUCE and GATHER also
// read every peer's error word: if any is set they write nothing and set
// the call's status word in mapped host memory, and that host raises in
// turn.

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

// Add v to *p, releasing this thread's earlier writes to the system.  An
// add, not a store: a peer that signals late, after this rank's host gave
// up and raised its READY word past any count, cannot lower it again under
// a stream wait still queued.
__device__ __forceinline__ void signal_add(uint64_t* p, uint64_t v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}


// ---- flag words and launch shape --------------------------------------------

constexpr int ERR_WORD = 0;        // 0, or set by the host when it gives up
constexpr int READY_WORD = 1;      // peers' stages delivered
constexpr int COUNT_WORD = 2;      // blocks done with this rank's STAGE
constexpr int FLAG_BYTES = 256;    // the flag page in front of the slots
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1056;   // 8 blocks on each of the 132 SMs
constexpr int LANE = 128;
constexpr int MAX_P = 4096;        // REDUCE's table of slots in shared;
                                   // GATHER's grid rows

int grid_for(long long work) {
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  return blocks < 1 ? 1 : (int)blocks;
}

// Whether this block is the last of its grid to finish (that one raises the
// kernel's signal): every block's writes are released to the system before
// it counts itself done, and the last resets the count for the next kernel.
__device__ __forceinline__ bool last_block(uint64_t* my_flags) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    unsigned int* count =
        reinterpret_cast<unsigned int*>(my_flags + COUNT_WORD);
    last = atomicAdd(count, 1u) == gridDim.x - 1;
    if (last) {
      *count = 0;                       // the next kernel starts after us
      __threadfence_system();
    }
  }
  __syncthreads();
  return last;
}

// Whether any rank's error word is set, the same answer in every thread of
// the block; if so, *status (mapped host memory) becomes 1 and the caller
// writes nothing.
__device__ __forceinline__ bool any_error(const unsigned long long* bases,
                                          int p, unsigned long long* status) {
  __shared__ int skip;
  if (threadIdx.x == 0) skip = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    if (ld_acquire(reinterpret_cast<const uint64_t*>(bases[j]) + ERR_WORD))
      atomicExch(&skip, 1);
  __syncthreads();
  if (skip && threadIdx.x == 0) {
    *reinterpret_cast<volatile unsigned long long*>(status) = 1;
    __threadfence_system();
  }
  return skip;
}


// ---- one element's bits in the wire dtype -------------------------------------

template <typename T> struct Elem;
template <> struct Elem<float> {
  typedef unsigned int Bits;
  static __device__ __forceinline__ Bits add(Bits a, Bits b) {
    return __float_as_uint(__uint_as_float(a) + __uint_as_float(b));
  }
  static __device__ __forceinline__ Bits mean(Bits a, float recip) {
    return __float_as_uint(__fmul_rn(__uint_as_float(a), recip));
  }
};
template <> struct Elem<int> {
  typedef unsigned int Bits;       // two's complement: the sum wraps
  static __device__ __forceinline__ Bits add(Bits a, Bits b) { return a + b; }
  static __device__ __forceinline__ Bits mean(Bits a, float) { return a; }
};
template <> struct Elem<__nv_bfloat16> {
  typedef unsigned short Bits;
  static __device__ __forceinline__ float f32(Bits a) {
    return __uint_as_float((unsigned int)a << 16);
  }
  static __device__ __forceinline__ Bits bf16(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  // Each bf16 sum is formed in f32 and rounded to nearest even, as a bf16
  // add does in PyTorch and in XLA; the mean likewise, from the f32
  // product.
  static __device__ __forceinline__ Bits add(Bits a, Bits b) {
    return bf16(f32(a) + f32(b));
  }
  static __device__ __forceinline__ Bits mean(Bits a, float recip) {
    return bf16(__fmul_rn(f32(a), recip));
  }
};

// The same over a 16-byte vector, lane by lane.
template <typename T>
__device__ __forceinline__ uint4 vadd(uint4 a, uint4 b) {
  typedef typename Elem<T>::Bits Bits;
  constexpr int L = 16 / sizeof(Bits);
  Bits* x = reinterpret_cast<Bits*>(&a);
  const Bits* y = reinterpret_cast<const Bits*>(&b);
#pragma unroll
  for (int l = 0; l < L; ++l) x[l] = Elem<T>::add(x[l], y[l]);
  return a;
}

template <typename T>
__device__ __forceinline__ uint4 vmean(uint4 a, float recip) {
  typedef typename Elem<T>::Bits Bits;
  constexpr int L = 16 / sizeof(Bits);
  Bits* x = reinterpret_cast<Bits*>(&a);
#pragma unroll
  for (int l = 0; l < L; ++l) x[l] = Elem<T>::mean(x[l], recip);
  return a;
}


// ---- one-shot ---------------------------------------------------------------

// STAGE: my slot (at my_block + slot_off) = x, n elements; then the last
// block adds 1 to every peer's READY word.  VEC: x is 16-byte aligned (the
// slot always is); the ragged tail goes element by element.  Nothing runs
// once the host has set the error word.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
stage_kernel(const T* x, long long n, char* my_block, long long slot_off,
             const unsigned long long* bases, int p, int me) {
  typedef typename Elem<T>::Bits Bits;
  constexpr int L = 16 / sizeof(Bits);
  uint64_t* my_flags = reinterpret_cast<uint64_t*>(my_block);
  __shared__ int skip;
  if (threadIdx.x == 0) skip = ld_acquire(my_flags + ERR_WORD) != 0;
  __syncthreads();
  if (skip) return;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const Bits* src = reinterpret_cast<const Bits*>(x);
  Bits* dst = reinterpret_cast<Bits*>(my_block + slot_off);
  const long long nvec = VEC ? n / L : 0;
  for (long long v = tid; v < nvec; v += stride)
    __stcg(reinterpret_cast<uint4*>(dst) + v,
           reinterpret_cast<const uint4*>(src)[v]);
  for (long long e = nvec * L + tid; e < n; e += stride)
    __stcg(dst + e, src[e]);
  if (last_block(my_flags) && threadIdx.x == 0) {
    for (int j = 0; j < p; ++j)
      if (j != me)
        signal_add(reinterpret_cast<uint64_t*>(bases[j]) + READY_WORD, 1);
  }
}

// REDUCE: out[e] for e < m is element i = off + e of the ranks' inputs,
// summed in the ring's order from rank (c+1) % p, where c is i / chunk for
// B1 (chunk > 0) and `fixed` for B2 (chunk == 0); times recip, the f32
// reciprocal of p, when `mean`.
// VEC: out is 16-byte aligned and off a multiple of the vector's lanes, so
// no vector straddles two chunks (chunk is a multiple of 128).  If any
// rank's error word is set, nothing is written and *status becomes 1.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
reduce_kernel(T* out, long long m, long long off, long long chunk, int fixed,
              const unsigned long long* bases, long long slot_off, int p,
              int mean, float recip, unsigned long long* status) {
  typedef typename Elem<T>::Bits Bits;
  constexpr int L = 16 / sizeof(Bits);
  extern __shared__ unsigned long long slot[];   // every rank's slot k % 2
  for (int j = threadIdx.x; j < p; j += blockDim.x)
    slot[j] = bases[j] + slot_off;
  if (any_error(bases, p, status)) return;      // syncs the block first
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = VEC ? m / L : 0;
  for (long long v = tid; v < nvec; v += stride) {
    const long long i = off + v * L;
    const int c = chunk ? (int)(i / chunk) : fixed;
    int r = c + 1 == p ? 0 : c + 1;
    uint4 acc = __ldcg(reinterpret_cast<const uint4*>(slot[r]) + i / L);
    for (int t = 2; t <= p; ++t) {
      r = r + 1 == p ? 0 : r + 1;
      acc = vadd<T>(__ldcg(reinterpret_cast<const uint4*>(slot[r]) + i / L),
                    acc);
    }
    reinterpret_cast<uint4*>(out)[v] = mean ? vmean<T>(acc, recip) : acc;
  }
  for (long long e = nvec * L + tid; e < m; e += stride) {
    const long long i = off + e;
    const int c = chunk ? (int)(i / chunk) : fixed;
    int r = c + 1 == p ? 0 : c + 1;
    Bits acc = __ldcg(reinterpret_cast<const Bits*>(slot[r]) + i);
    for (int t = 2; t <= p; ++t) {
      r = r + 1 == p ? 0 : r + 1;
      acc = Elem<T>::add(__ldcg(reinterpret_cast<const Bits*>(slot[r]) + i),
                         acc);
    }
    reinterpret_cast<Bits*>(out)[e] = mean ? Elem<T>::mean(acc, recip) : acc;
  }
}

// GATHER: row r = blockIdx.y of out, n elements from r n on, is rank r's
// slot.  VEC: out is 16-byte aligned, so a row whose start r n is a
// multiple of the vector's lanes copies 16-byte vectors; the other rows and
// the ragged tail go element by element.  If any rank's error word is set,
// nothing is written and *status becomes 1.
template <typename Bits, bool VEC>
__global__ void __launch_bounds__(THREADS)
gather_kernel(Bits* out, long long n, const unsigned long long* bases,
              long long slot_off, int p, unsigned long long* status) {
  constexpr int L = 16 / sizeof(Bits);
  if (any_error(bases, p, status)) return;
  const long long r = blockIdx.y;
  const Bits* src = reinterpret_cast<const Bits*>(bases[r] + slot_off);
  Bits* dst = out + r * n;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = VEC && (r * n) % L == 0 ? n / L : 0;
  for (long long v = tid; v < nvec; v += stride)
    reinterpret_cast<uint4*>(dst)[v] =
        __ldcg(reinterpret_cast<const uint4*>(src) + v);
  for (long long e = nvec * L + tid; e < n; e += stride)
    dst[e] = __ldcg(src + e);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int run_oneshot(int kind, int p, int me, long long n, long long chunk,
                int mean, const void* x, void* out,
                const unsigned long long* bases, char* my_block,
                long long slot_bytes, uint64_t k, unsigned long long* status,
                cudaStream_t s) {
  StreamValue64Fn wait, write;
  int e = stream_value_fns(&wait, &write);
  if (e) return e;
  constexpr int L = 16 / (int)sizeof(T);
  const long long slot_off = FLAG_BYTES + (long long)(k % 2) * slot_bytes;
  const T* in = static_cast<const T*>(x);
  if (aligned16(x))
    stage_kernel<T, true><<<grid_for(n / L + n % L), THREADS, 0, s>>>(
        in, n, my_block, slot_off, bases, p, me);
  else
    stage_kernel<T, false><<<grid_for(n), THREADS, 0, s>>>(
        in, n, my_block, slot_off, bases, p, me);
  e = (int)cudaGetLastError();
  if (e) return e;
  CUresult r = wait((CUstream)s,
                    (CUdeviceptr)(reinterpret_cast<uint64_t*>(my_block) +
                                  READY_WORD),
                    (cuuint64_t)(p - 1) * (k + 1), CU_STREAM_WAIT_VALUE_GEQ);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  if (kind == 2) {
    // One grid row per rank, the card's blocks shared out among them.
    typedef typename Elem<T>::Bits Bits;
    Bits* o = static_cast<Bits*>(out);
    const int per_rank = grid_for((long long)p * (n / L + n % L)) / p;
    const dim3 grid(per_rank < 1 ? 1 : per_rank, p);
    if (aligned16(out))
      gather_kernel<Bits, true><<<grid, THREADS, 0, s>>>(o, n, bases,
                                                         slot_off, p, status);
    else
      gather_kernel<Bits, false><<<grid, THREADS, 0, s>>>(o, n, bases,
                                                          slot_off, p, status);
    return (int)cudaGetLastError();
  }
  // B1: all n elements; B2: this rank's chunk of n / p.
  const long long m = kind == 0 ? n : n / p;
  const long long off = kind == 0 ? 0 : me * m;
  const long long ch = kind == 0 ? chunk : 0;
  T* o = static_cast<T*>(out);
  const size_t smem = (size_t)p * sizeof(unsigned long long);
  const float recip = 1.0f / (float)p;   // rounded to f32, as XLA folds it
  if (aligned16(out) && off % L == 0)
    reduce_kernel<T, true><<<grid_for(m / L + m % L), THREADS, smem, s>>>(
        o, m, off, ch, me, bases, slot_off, p, mean, recip, status);
  else
    reduce_kernel<T, false><<<grid_for(m), THREADS, smem, s>>>(
        o, m, off, ch, me, bases, slot_off, p, mean, recip, status);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- staging memory and its IPC handles ------------------------------------

// The block is zeroed before this returns, on a stream of its own.  The
// caller swaps its IPC handle right after, and a peer may signal into it
// at once; a memset queued on the default stream would wait for this
// process's pending work (a backward pass) and could then wipe a chunk or
// a flag word that the peer had already delivered.
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

// Zeroed host memory that kernels write and the host reads (a one-shot
// call's status word): mapped, so its host address is also the device's.
extern "C" int tmpi_ring_host_alloc(size_t bytes, void** out) {
  cudaError_t e = cudaHostAlloc(out, bytes, cudaHostAllocMapped);
  if (e == cudaSuccess) memset(*out, 0, bytes);
  return (int)e;
}

extern "C" int tmpi_ring_host_free(void* p) { return (int)cudaFreeHost(p); }

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


// ---- entry points -------------------------------------------------------------

// One one-shot call, enqueued on `stream`: kind 0 allreduce (out (n,)),
// 1 reduce-scatter (out (n/p,), this rank's part), 2 allgather (out (p n,),
// every rank's x in rank order); dtype 0 f32, 1 bf16, 2 int32; chunk
// (kind 0) the ring's chunk in elements, a multiple of 128; mean for kinds
// 0 and 1 in f32 and bf16 only.  bases is a device table of every rank's
// block (mine at me), my_block this rank's, each a flag page then two slots
// of slot_bytes; k this rank's count of earlier calls on the state; status
// a mapped host word.  The allgather shares this entry with B1 and B2: its
// STAGE, wait and checks are theirs, and only the kernel after the wait
// differs.  Returns a CUDA error code (10000 + a CUresult for
// a refused stream wait).
extern "C" int tmpi_ring_oneshot(int kind, int dtype, int p, int me,
                                 long long n, long long chunk, int mean,
                                 const void* x, void* out, const void* bases,
                                 void* my_block, long long slot_bytes,
                                 uint64_t k, void* status, void* stream) {
  const long long esize = dtype == 1 ? 2 : 4;
  if (kind < 0 || kind > 2 || dtype < 0 || dtype > 2 || p < 2 || p > MAX_P ||
      me < 0 || me >= p || n < 0 || slot_bytes % FLAG_BYTES ||
      slot_bytes < n * esize || (kind == 0 && (chunk < LANE || chunk % LANE)) ||
      (kind == 1 && n % p) || (mean && (dtype == 2 || kind == 2)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned long long* b = static_cast<const unsigned long long*>(bases);
  char* blk = static_cast<char*>(my_block);
  unsigned long long* st = static_cast<unsigned long long*>(status);
  if (dtype == 0)
    return run_oneshot<float>(kind, p, me, n, chunk, mean, x, out, b, blk,
                              slot_bytes, k, st, s);
  if (dtype == 1)
    return run_oneshot<__nv_bfloat16>(kind, p, me, n, chunk, mean, x, out, b,
                                      blk, slot_bytes, k, st, s);
  return run_oneshot<int>(kind, p, me, n, chunk, mean, x, out, b, blk,
                          slot_bytes, k, st, s);
}

// The host gave up on a call: set the error word (so no queued kernel runs
// or signals a peer) and release this rank's stream wait by raising its
// READY word past any count, from a stream of its own.  The ring state is
// unusable afterwards.
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
    r = write((CUstream)s, (CUdeviceptr)(f + READY_WORD), past, 0);
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
