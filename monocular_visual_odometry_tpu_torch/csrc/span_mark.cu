// Span marker for the port's captured programs, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package marks no stage inside its compiled
// step. This one lets a CUDA graph time its own stages. A marker is one
// thread of one block that writes the card's global nanosecond timer
// (%globaltimer) into one slot of the program's slot buffer. Launched on the
// program's stream, it starts only after every kernel before it has finished
// and every kernel after it waits for it, so the difference of two slots is
// the device time of the stage between them, the gaps between its kernels
// included. %globaltimer may tick in steps of about a microsecond, well under
// the 0.5-5 ms of a stage.
//
// What bounds it: the launch alone (a few microseconds inside a graph); it
// reads nothing and writes 8 bytes. It is built and launched only while
// spans are on (monocular_visual_odometry_tpu_torch/utils/logging.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void span_mark_kernel(int64_t* slots, int index) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[index] = static_cast<int64_t>(t);
}

}  // namespace

extern "C" int span_mark_launch(int64_t* slots, int index, void* stream) {
  span_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(slots, index);
  return static_cast<int>(cudaGetLastError());
}
