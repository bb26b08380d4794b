// Device marks: a one-thread kernel that stamps the card's clock into a ring.
//
// A mark is launched on the current stream where the host code of a step
// runs (utils/profiler.py `mark`).  Under CUDA-graph capture it becomes a
// node of the graph, so every replay stamps the time at which the work
// queued before it on that stream has finished, with no host involvement.
//
// The ring is one int64 buffer: [0] the cursor, [1] the marks dropped, then
// `cap` pairs (mark id, %globaltimer in ns).  A mark takes its slot with an
// atomicAdd on the cursor; past `cap` it counts the drop and writes nothing.
//
// Three kernels of one body, so that a trace tells the kinds of mark apart
// by kernel name: mark_enter opens a step, mark_exit closes it, mark ends a
// span inside it.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void stamp(long long* ring, int cap, int id) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long* head = reinterpret_cast<unsigned long long*>(ring);
  unsigned long long slot = atomicAdd(head, 1ull);
  if (slot < static_cast<unsigned long long>(cap)) {
    ring[2 + 2 * slot] = id;
    ring[3 + 2 * slot] = static_cast<long long>(t);
  } else {
    atomicAdd(head + 1, 1ull);
  }
}

}  // namespace

extern "C" __global__ void mark_enter(long long* ring, int cap, int id) {
  stamp(ring, cap, id);
}

extern "C" __global__ void mark_exit(long long* ring, int cap, int id) {
  stamp(ring, cap, id);
}

extern "C" __global__ void mark(long long* ring, int cap, int id) {
  stamp(ring, cap, id);
}

// role: 0 enter, 1 span, 2 exit.  Returns the launch's cudaError_t.
extern "C" int mark_launch(int role, long long* ring, int cap, int id,
                           cudaStream_t stream) {
  if (cap <= 0) return cudaErrorInvalidValue;
  switch (role) {
    case 0: mark_enter<<<1, 1, 0, stream>>>(ring, cap, id); break;
    case 1: mark<<<1, 1, 0, stream>>>(ring, cap, id); break;
    case 2: mark_exit<<<1, 1, 0, stream>>>(ring, cap, id); break;
    default: return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
