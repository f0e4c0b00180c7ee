// Stage stamps of the port's tracer (customnerf_torch/engine/spans.py).
//
// cn_span_stamp launches one thread on the caller's stream.  It takes the
// next slot of a ring in device memory (an atomicAdd on the ring's cursor)
// and writes there the stamp's tag (2 · span id, + 1 at the span's end) and
// the %globaltimer nanoseconds at which it ran.  Stream order puts the stamp
// after every kernel queued before it.  Inside a CUDA graph capture the launch
// becomes a kernel node, so every replay of the graph appends its stamps anew.
//
// The ring never wraps: once the cursor passes the capacity, a stamp writes
// nothing, and cursor − capacity is the count of stamps dropped.  The host
// reads the cursor and the slots in one copy (cn_span_read) and rewinds the
// cursor with cn_span_reset, neither inside a dispatch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kCapacity = 1ull << 16;

struct Stamp {
  unsigned long long t_ns;   // %globaltimer when the stamp ran
  unsigned int tag;          // 2 · span id + (1 at an end)
  unsigned int pad;
};

struct Ring {
  unsigned long long cursor;  // stamps taken since the last reset
  unsigned long long pad;
  Stamp slots[kCapacity];
};

__device__ Ring g_ring;

__global__ void cn_span_stamp_kernel(unsigned int tag) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long i = atomicAdd(&g_ring.cursor, 1ull);
  if (i < kCapacity) {
    g_ring.slots[i].t_ns = t;
    g_ring.slots[i].tag = tag;
  }
}

}  // namespace

extern "C" int cn_span_stamp(unsigned int tag, void* stream) {
  cn_span_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(tag);
  return (int)cudaGetLastError();
}

extern "C" unsigned long long cn_span_capacity() { return kCapacity; }

// The ring as it stands (host memory of cn_span_ring_bytes() bytes): the
// cursor, then the slots.
extern "C" unsigned long long cn_span_ring_bytes() { return sizeof(Ring); }

extern "C" int cn_span_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_ring, sizeof(Ring));
}

extern "C" int cn_span_reset() {
  const unsigned long long zero = 0;
  return (int)cudaMemcpyToSymbol(g_ring, &zero, sizeof(zero));
}
