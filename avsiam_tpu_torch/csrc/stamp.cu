// Phase stamps of a CUDA graph, sm_90a.
//
// No counterpart in the JAX package: it marks where the phases of a
// captured step (forward, backward, Adam) begin and end on the device, for
// utils/profiling.py's PhaseMarks. One thread reads the card's nanosecond
// clock (%globaltimer) and writes it to slot `slot` of a uint64 buffer.
// Captured on the step's stream, the kernel is an ordinary node of the
// graph: it starts once the nodes before it have ended, and each replay
// writes the slot again, with no host work. An event-record node does the
// same, but a graph holding timing events was measured slower to launch
// while the card is busy (PERF.md, section 6), and one of these kernels
// is not.
//
// What it costs: one launch of one thread, about 2 us a mark on the card.

#include <cuda_runtime.h>

#include <cstdint>

__global__ void phase_stamp_kernel(uint64_t* out, int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  out[slot] = t;
}

extern "C" int avsiam_phase_stamp(void* out, int slot, void* stream) {
  if (slot < 0) return (int)cudaErrorInvalidValue;
  phase_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint64_t*>(out), slot);
  return (int)cudaGetLastError();
}
