// LTSP dynamic-program wavefront for Hopper (sm_90a): one anti-diagonal of
// the batched DP tables per launch.
//
// Replaces the TPU kernel of the JAX package, src/repro/kernels/ltsp_dp/
// ltsp_dp.py: `wavefront_kernel` (:101, one cell row T[i,a,a+d,:] and its
// argmin C[i,a,a+d,:]), launched by `ltsp_dp_wavefront` (:237, the
// pallas_call at :292) from the driver `ltsp_dp_tables` (:307).
//
// What it computes, for instance i, window start a, diagonal d, b = a + d and
// every skip count s in [0, S):
//   skip  = T[a, b-1, clip(s + x_b, 0, S-1)] + 2(r_b - r_{b-1})(s + nl_a)
//           + 2(l_b - r_{b-1}) x_b
//   det_c = T[a, c-1, s] + T[c, b, s] + 2(r_b - r_{c-1})(s + nl_a)
//           + 2U(s + nl_c),           c in [c_lo, b]
//   c_lo  = a + 1, raised to b - span under LOGDP, and the band is empty
//           when a > 0 under SIMPLEDP (disjoint).
//   T[a, b, s] = min(skip, det);  C[a, b, s] = -1 if skip <= det, else the
//   smallest minimising c (the fold ascends in c with a strict <).
//
// Bound on this card: the candidate fold does about 7 operations per
// (cell, c, s); an exact DP at (R, S) = (256, 8192) folds (R^3 - R)/6 * S
// ~ 2.3e10 candidates, ~5 ms at the 34 TFLOP/s FP64 rate, while writing T and
// C once is ~6.4 GB, ~2 ms at 3.35 TB/s.  This first design is simple and
// exact rather than fast: one thread per (i, a, s), the grid
// (ceil(S/256), R-d, B) so late diagonals still spread over the card, and
// both candidate streams (row T[i,a,c-1,:] and column T[i,c,b,:]) read
// coalesced along s.  It re-reads every candidate from device memory (no
// tiling of the row/column slices in shared memory), so it runs far above
// the bound; the measured times are in PERF.md.
//
// Exactness: every table value is an integer below the numeric guard of the
// caller, but the dense table also holds cells that no solve reads (clamped
// gathers at large s), so the arithmetic is pinned anyway.  int32 adds and
// multiplies go through uint32, so they wrap exactly like the reference's
// int32 arrays.  Float adds and multiplies use the _rn intrinsics, which
// nvcc never contracts into FMAs, in the reference's operation order, so
// each result is rounded exactly as the plain version rounds it.
//
// The sentinel of masked candidates (INT32_MAX/2 for int32, +inf for the
// floats) and the scan form of the reference (one static tile over
// c = 1..R-1 when R-1 <= cand_tile, else a banded fold starting from the
// sentinel) only show in cells whose live candidates all reach the
// sentinel; `static_tile` reproduces both forms there, bit for bit.
//
// The kernel writes T[i,a,a+d,:] and C[i,a,a+d,:] in place.  It reads only
// diagonals < d, which no block of this launch writes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
struct Arith;

template <>
struct Arith<int32_t> {
  __device__ static __forceinline__ int32_t big() { return INT32_MAX / 2; }
  __device__ static __forceinline__ int32_t add(int32_t p, int32_t q) {
    return static_cast<int32_t>(static_cast<uint32_t>(p) + static_cast<uint32_t>(q));
  }
  __device__ static __forceinline__ int32_t sub(int32_t p, int32_t q) {
    return static_cast<int32_t>(static_cast<uint32_t>(p) - static_cast<uint32_t>(q));
  }
  __device__ static __forceinline__ int32_t mul(int32_t p, int32_t q) {
    return static_cast<int32_t>(static_cast<uint32_t>(p) * static_cast<uint32_t>(q));
  }
  __device__ static __forceinline__ int32_t from_int(int v) { return v; }
};

template <>
struct Arith<float> {
  __device__ static __forceinline__ float big() { return __int_as_float(0x7f800000); }
  __device__ static __forceinline__ float add(float p, float q) { return __fadd_rn(p, q); }
  __device__ static __forceinline__ float sub(float p, float q) { return __fsub_rn(p, q); }
  __device__ static __forceinline__ float mul(float p, float q) { return __fmul_rn(p, q); }
  __device__ static __forceinline__ float from_int(int v) { return static_cast<float>(v); }
};

template <>
struct Arith<double> {
  __device__ static __forceinline__ double big() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  __device__ static __forceinline__ double add(double p, double q) { return __dadd_rn(p, q); }
  __device__ static __forceinline__ double sub(double p, double q) { return __dsub_rn(p, q); }
  __device__ static __forceinline__ double mul(double p, double q) { return __dmul_rn(p, q); }
  __device__ static __forceinline__ double from_int(int v) { return static_cast<double>(v); }
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
wavefront_kernel(V* __restrict__ T, int32_t* __restrict__ C,
                 const V* __restrict__ left, const V* __restrict__ right,
                 const int32_t* __restrict__ x, const V* __restrict__ nl,
                 const V* __restrict__ u, int R, int S, int d, int span,
                 int disjoint, int static_tile) {
  using A = Arith<V>;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int a = blockIdx.y;
  const int i = blockIdx.z;
  if (s >= S) return;
  const int b = a + d;  // < R: the grid holds only the R - d live windows

  const V* lf = left + static_cast<int64_t>(i) * R;
  const V* rt = right + static_cast<int64_t>(i) * R;
  const int32_t* xs = x + static_cast<int64_t>(i) * R;
  const V* nls = nl + static_cast<int64_t>(i) * R;
  const V two = A::from_int(2);
  const V sv = A::from_int(s);
  const V r_b = rt[b];
  const V nl_a = nls[a];
  const V s_nl_a = A::add(sv, nl_a);

  // T[i, a, c, :] is row (i*R + a)*R + c; T[i, c, b, :] is row (i*R + c)*R + b.
  const int64_t rowS = static_cast<int64_t>(S);
  const int64_t plane = (static_cast<int64_t>(i) * R + a) * R * rowS;
  V* row = T + plane;
  const V* col = T + (static_cast<int64_t>(i) * R * R + b) * rowS;
  const int64_t col_step = static_cast<int64_t>(R) * rowS;

  // ---- skip b ----
  const int x_b = xs[b];
  int si = s + x_b;
  si = si < 0 ? 0 : (si > S - 1 ? S - 1 : si);
  const V r_bm1 = rt[b - 1];
  const V shifted = row[static_cast<int64_t>(b - 1) * rowS + si];
  const V skip = A::add(A::add(shifted, A::mul(A::mul(two, A::sub(r_b, r_bm1)), s_nl_a)),
                        A::mul(A::mul(two, A::sub(lf[b], r_bm1)), A::from_int(x_b)));

  // ---- detour band: strict fold over c ascending ----
  int c_lo = a + 1;
  if (span >= 0 && b - span > c_lo) c_lo = b - span;
  if (disjoint && a > 0) c_lo = b + 1;
  const V two_u = A::mul(two, u[i]);
  V best = A::big();
  int arg = -1;
  for (int c = c_lo; c <= b; ++c) {
    const V t_left = row[static_cast<int64_t>(c - 1) * rowS + s];
    const V t_right = col[static_cast<int64_t>(c) * col_step + s];
    const V move = A::mul(A::mul(two, A::sub(r_b, rt[c - 1])), s_nl_a);
    const V turn = A::mul(two_u, A::add(sv, nls[c]));
    const V cand = A::add(A::add(A::add(t_left, t_right), move), turn);
    if (arg < 0 || cand < best) {
      best = cand;
      arg = c;
    }
  }

  // ---- the reference's sentinel semantics (see the header) ----
  const V big = A::big();
  V det;
  int argc;
  if (static_tile) {
    const bool masked_exist = c_lo > 1 || b < R - 1;
    if (arg < 0) {
      det = big;
      argc = 1;
    } else if (best < big) {
      det = best;
      argc = arg;
    } else if (best == big) {
      det = big;
      argc = c_lo > 1 ? 1 : arg;
    } else if (masked_exist) {
      det = big;
      argc = c_lo > 1 ? 1 : b + 1;
    } else {
      det = best;
      argc = arg;
    }
  } else if (arg >= 0 && best < big) {
    det = best;
    argc = arg;
  } else {
    det = big;
    argc = 0;
  }

  const int64_t out = static_cast<int64_t>(b) * rowS + s;
  const bool take_skip = skip <= det;
  row[out] = take_skip ? skip : det;
  C[plane + out] = take_skip ? -1 : argc;
}

template <typename V>
int launch(void* T, void* C, const void* left, const void* right, const void* x,
           const void* nl, const void* u, int B, int R, int S, int d, int span,
           int disjoint, int static_tile, void* stream) {
  if (B < 1 || R < 2 || S < 1 || d < 1 || d >= R) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kThreads - 1) / kThreads, R - d, B);
  wavefront_kernel<V><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(T), static_cast<int32_t*>(C), static_cast<const V*>(left),
      static_cast<const V*>(right), static_cast<const int32_t*>(x),
      static_cast<const V*>(nl), static_cast<const V*>(u), R, S, d, span, disjoint,
      static_tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, one per table type, bound with ctypes.  Each launches
// one diagonal on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" {

int ltsp_wavefront_i32(void* T, void* C, const void* left, const void* right,
                       const void* x, const void* nl, const void* u, int B, int R,
                       int S, int d, int span, int disjoint, int static_tile,
                       void* stream) {
  return launch<int32_t>(T, C, left, right, x, nl, u, B, R, S, d, span, disjoint,
                         static_tile, stream);
}

int ltsp_wavefront_f32(void* T, void* C, const void* left, const void* right,
                       const void* x, const void* nl, const void* u, int B, int R,
                       int S, int d, int span, int disjoint, int static_tile,
                       void* stream) {
  return launch<float>(T, C, left, right, x, nl, u, B, R, S, d, span, disjoint,
                       static_tile, stream);
}

int ltsp_wavefront_f64(void* T, void* C, const void* left, const void* right,
                       const void* x, const void* nl, const void* u, int B, int R,
                       int S, int d, int span, int disjoint, int static_tile,
                       void* stream) {
  return launch<double>(T, C, left, right, x, nl, u, B, R, S, d, span, disjoint,
                        static_tile, stream);
}

}  // extern "C"
