// Device timestamp: one thread writes the card's global nanosecond timer
// (%globaltimer) into one slot of an int64 buffer.
//
// Launched between the stages of the fused tracking step, on the step's
// stream, so it runs once the stage before it has finished and before the
// next begins; captured into the step's CUDA graph, it writes the slot
// again on every replay.  The difference of two slots is the device time
// of the work between them, the stamp's own launch (about a microsecond)
// included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void stamp_kernel(int64_t* out, int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  out[slot] = (int64_t)t;
}

}  // namespace

extern "C" int stamp_launch(void* out, int slot, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((int64_t*)out, slot);
  return (int)cudaGetLastError();
}
