// Dependent-load latency of device memory, the measure behind the latency
// bound of the traceback (csrc/ltsp_traceback.cu).  Only chip_smoke.py
// launches it; the solver never does.
//
// The traceback walks R - 1 cells of the argmin plane C, each read's address
// depending on the value the previous read returned, so it is bound by that
// chain of round trips and not by bytes or operations.  This kernel times the
// same kind of chain with nothing else in it: one thread follows `next`
// (int32 indices), each load's address being the previous load's value, so
// no two loads overlap.  chip_smoke.py lays one random cycle over a buffer the
// size of one (256, 8192) C plane (2.1 GB, forty times the 50 MB L2), so
// nearly every step is a miss to device memory; the time per step is the
// latency that R - 1 multiplies into the bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pointer_chase_kernel(const int32_t* __restrict__ next, int steps, int start,
                                     int32_t* __restrict__ out) {
  int32_t i = start;
  for (int k = 0; k < steps; ++k) i = next[i];
  *out = i;  // the end of the chain, so the loads are not dead code
}

}  // namespace

// Plain C entry point, bound with ctypes: one launch of one thread on
// `stream`, no synchronisation; returns cudaGetLastError() (0 = launched).
extern "C" int pointer_chase(const void* next, int steps, int start, void* out, void* stream) {
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(next), steps, start, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
