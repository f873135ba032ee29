// The device stamp of sqair_tpu_torch/tracing.py: one thread reads the
// card's nanosecond clock (%globaltimer) and writes it into a ring.
//
// buf is int64 [1 + capacity]: buf[0] counts the stamps written so far,
// stamp j lands in buf[1 + j % capacity].  Launched as the first and the
// last node of a captured graph (training/graph.py), each replay leaves its
// (first, last) pair with no host work and no host sync; the host reads the
// ring with one copy when it already waits for the card.
//
// The kernel lives outside the `sqair` namespace on purpose: profiles that
// charge the program's kernels by the `sqair::` prefix of their names do
// not count it.
#include <cuda_runtime.h>

namespace sqair_trace {

__global__ void stamp_kernel(long long* buf, int capacity) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long n = buf[0];
  buf[1 + n % capacity] = static_cast<long long>(now);
  buf[0] = n + 1;
}

}  // namespace sqair_trace

// One stamp into `buf` (see above) on `stream`.  Returns a cudaError_t.
extern "C" int sqair_trace_stamp(void* buf, int capacity, void* stream) {
  if (buf == nullptr || capacity < 1) return (int)cudaErrorInvalidValue;
  sqair_trace::stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), capacity);
  return (int)cudaGetLastError();
}
