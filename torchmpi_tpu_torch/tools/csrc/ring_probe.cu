// The probe behind the ring kernels' design (ops/csrc/ring.cu): how fast can
// two processes that share one card wait on each other?  Bound with ctypes
// by tools/ring_probe.py, which takes the flag words and their cudaIPC
// mappings from the ring library.
//
// mode 0: one persistent kernel in each process spinning on its flag;
// mode 1: one launch per half round trip, the wait spinning inside the
//         kernel;
// mode 2: stream memory operations (cuStreamWaitValue64 /
//         cuStreamWriteValue64) around a one-thread kernel: the wait is in
//         the stream, not on the SMs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" :: "l"(p), "l"(v)
               : "memory");
}

// Spin until *flag >= want or the deadline passes; true when it arrived.
__device__ __forceinline__ bool wait_geq(const uint64_t* flag, uint64_t want,
                                         uint64_t deadline) {
  while (ld_acquire(flag) < want) {
    if (global_ns() > deadline) return false;
    __nanosleep(64);
  }
  return true;
}

// One kernel for the whole ping-pong: role 0 posts i then waits for the
// echo; role 1 waits for i then echoes it.  done[0] = round trips finished.
__global__ void probe_persistent(uint64_t* mine, uint64_t* peer, int role,
                                 int iters, uint64_t timeout_ns, int* done) {
  const uint64_t deadline = global_ns() + timeout_ns;
  int i = 1;
  for (; i <= iters; ++i) {
    if (role == 0) st_release(peer, (uint64_t)i);
    if (!wait_geq(mine, (uint64_t)i, deadline)) break;
    if (role == 1) st_release(peer, (uint64_t)i);
  }
  done[0] = i - 1;
}

// One launch per half round trip, the wait inside the kernel.
__global__ void probe_step(uint64_t* mine, uint64_t* peer, int role,
                           uint64_t i, uint64_t timeout_ns, int* err) {
  if (err[0]) return;
  const uint64_t deadline = global_ns() + timeout_ns;
  if (role == 0) st_release(peer, i);
  if (!wait_geq(mine, i, deadline)) { err[0] = (int)i; return; }
  if (role == 1) st_release(peer, i);
}

__global__ void probe_touch(int* x) { x[1] += 1; }

typedef CUresult (*StreamValue64Fn)(CUstream, CUdeviceptr, cuuint64_t,
                                    unsigned int);

int driver_fn(const char* name, void** fn) {
  cudaDriverEntryPointQueryResult q;
  cudaError_t e = cudaGetDriverEntryPoint(name, fn, cudaEnableDefault, &q);
  if (e != cudaSuccess) return (int)e;
  return q == cudaDriverEntryPointSuccess ? 0 : (int)cudaErrorNotSupported;
}

}  // namespace

// Enqueues `iters` round trips of `mode` on `stream`; mine and peer are
// this rank's flag word and the peer's, mapped; scratch: two ints of device
// memory.  Returns a CUDA error code (10000 + a driver code for a refused
// stream memory operation).
extern "C" int tmpi_ring_probe(int mode, void* mine, void* peer, int role,
                               int iters, uint64_t base, uint64_t timeout_ns,
                               void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* m = static_cast<uint64_t*>(mine);
  uint64_t* p = static_cast<uint64_t*>(peer);
  int* sc = static_cast<int*>(scratch);
  if (mode == 0) {
    probe_persistent<<<1, 1, 0, s>>>(m, p, role, iters, timeout_ns, sc);
    return (int)cudaGetLastError();
  }
  if (mode == 1) {
    for (int i = 1; i <= iters; ++i) {
      probe_step<<<1, 1, 0, s>>>(m, p, role, base + i, timeout_ns, sc);
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  }
  void* a = nullptr;
  void* b = nullptr;
  int e = driver_fn("cuStreamWaitValue64", &a);
  if (!e) e = driver_fn("cuStreamWriteValue64", &b);
  if (e) return e;
  StreamValue64Fn wait = reinterpret_cast<StreamValue64Fn>(a);
  StreamValue64Fn write = reinterpret_cast<StreamValue64Fn>(b);
  for (int i = 1; i <= iters; ++i) {
    const cuuint64_t v = base + i;
    CUresult r = CUDA_SUCCESS;
    if (role == 0) r = write((CUstream)s, (CUdeviceptr)p, v, 0);
    if (r == CUDA_SUCCESS)
      r = wait((CUstream)s, (CUdeviceptr)m, v, CU_STREAM_WAIT_VALUE_GEQ);
    if (r != CUDA_SUCCESS) return 10000 + (int)r;
    probe_touch<<<1, 1, 0, s>>>(sc);
    if (role == 1) r = write((CUstream)s, (CUdeviceptr)p, v, 0);
    if (r != CUDA_SUCCESS) return 10000 + (int)r;
  }
  return (int)cudaGetLastError();
}
