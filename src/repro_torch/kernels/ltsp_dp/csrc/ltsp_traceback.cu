// LTSP traceback on the card: walk the argmin planes C of a table build into
// each instance's detour list, so that only O(B R) integers, and not the
// R^2 S plane, go to the host.
//
// It replaces the host walk `traceback_detours` of the port's ops.py, which
// mirrors src/repro/kernels/ltsp_dp/ops.py:263 (host code in the JAX package,
// fed by the argmin planes of the TPU kernel at ltsp_dp.py:292).
//
// One thread per instance runs the same pre-order walk from the root cell
// (0, R-1, 0): C = -1 means "skip b" (s += x_b, b -= 1); C = c means detour
// (c, b): emit it, push (a, c-1, s) and go on with (c, b, s).  Every emitted
// c is distinct and in [1, R-1], so at most R-1 detours and R stack entries.
// Detours go to dets[i, n] = (c, b) in emission order and their number to
// counts[i]; a cell outside the plane or holding a choice outside (a, b] (a
// plane that is not a DP's) stops the walk with counts[i] = -1.
//
// Bound: latency, not bytes or operations: a walk is R - 1 dependent reads
// of C (each step narrows its windows by one file), each a round trip to
// device memory.  The whole plane that this walk replaces the copy of is
// R^2 S int32 values, 2.1 GB at (256, 8192); PERF.md has the measured times.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
traceback_kernel(const int32_t* __restrict__ C, const int32_t* __restrict__ x,
                 int32_t* __restrict__ dets, int32_t* __restrict__ counts,
                 int32_t* __restrict__ stack, int B, int R, int S) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int32_t* plane = C + static_cast<int64_t>(i) * R * R * S;
  const int32_t* xs = x + static_cast<int64_t>(i) * R;
  int32_t* out = dets + static_cast<int64_t>(i) * R * 2;
  int32_t* stk = stack + static_cast<int64_t>(i) * R * 3;
  int n = 0;
  int top = 1;
  stk[0] = 0;
  stk[1] = R - 1;
  stk[2] = 0;
  while (top > 0) {
    --top;
    int a = stk[3 * top], b = stk[3 * top + 1], s = stk[3 * top + 2];
    while (a < b) {
      if (s >= S) {
        counts[i] = -1;
        return;
      }
      const int c = plane[(static_cast<int64_t>(a) * R + b) * S + s];
      if (c == -1) {
        s += xs[b];
        --b;
        continue;
      }
      if (c <= a || c > b) {
        counts[i] = -1;
        return;
      }
      out[2 * n] = c;
      out[2 * n + 1] = b;
      ++n;
      stk[3 * top] = a;
      stk[3 * top + 1] = c - 1;
      stk[3 * top + 2] = s;
      ++top;
      a = c;
    }
  }
  counts[i] = n;
}

}  // namespace

// Plain C entry point, bound with ctypes: one launch on `stream`, no
// synchronisation; returns cudaGetLastError() (0 = launched).  `dets`
// [B, R, 2] and `counts` [B] are int32 outputs, `stack` [B, R, 3] int32
// scratch, all allocated by the caller.
extern "C" int ltsp_traceback(const void* C, const void* x, void* dets, void* counts,
                              void* stack, int B, int R, int S, void* stream) {
  if (B < 1 || R < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  traceback_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(C), static_cast<const int32_t*>(x),
      static_cast<int32_t*>(dets), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(stack), B, R, S);
  return static_cast<int>(cudaGetLastError());
}
