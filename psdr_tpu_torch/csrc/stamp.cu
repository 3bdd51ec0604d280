// A timestamp on the device for Program.profile_layers (program.py): one
// thread writes the device's nanosecond clock (%globaltimer) into a slot.
// It replaces no TPU kernel: the JAX package reads layer times from the
// profiler. Captured on a stream, a launch is one kernel node of the
// graph, which a replay runs in stream order after the node before it,
// as it runs every kernel node; an event record node in its place costs
// several times as long on an H100 (PERF.md, section 7). Nothing bounds it
// but the launch: it reads nothing and writes 8 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(int64_t* __restrict__ slots, int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[slot] = static_cast<int64_t>(t);
}

}  // namespace

extern "C" int psdr_stamp(int64_t* slots, int slot, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(slots, slot);
  return static_cast<int>(cudaGetLastError());
}
