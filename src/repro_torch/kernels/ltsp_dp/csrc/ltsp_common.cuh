// Shared pieces of the LTSP DP table kernels (ltsp_tiled.cu) and the
// traceback (ltsp_traceback.cu): the two table layouts, exact arithmetic per
// table type, the skip term, one detour candidate, and the reference's
// sentinel rule.
//
// Exactness: every table value is an integer below the numeric guard of the
// caller, but a table also holds cells that no solve reads (clamped
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
// sentinel; `settle` reproduces both forms there, bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ltsp {

// Table layouts.  One instance's plane is a run of rows of S lanes, a row
// per window (a, b), a <= b:
//   dense  [R, R, S]:        (a, b) at row a R + b; rows a > b unused;
//   packed [R (R + 1) / 2, S]: the windows a <= b alone, (a, b) at row
//                            a R - a (a - 1) / 2 + (b - a).
// In both, the windows of one start a are consecutive rows, so (a, b) lies
// at row_base(a) + b, and going down column b from (c, b) to (c + 1, b)
// moves col_step(c) rows.  Rows are counted in int, which holds R R while
// R <= kMaxR (the launchers refuse more); an offset, a row times S, is
// int64: a packed plane at R 714, S 20,864 holds 5.3e9 cells.
constexpr int kMaxR = 46340;

template <bool kPacked>
__host__ __device__ __forceinline__ int plane_rows(int R) {
  return kPacked ? R * (R + 1) / 2 : R * R;
}

template <bool kPacked>
__host__ __device__ __forceinline__ int row_base(int a, int R) {
  return kPacked ? a * R - ((a * (a + 1)) >> 1) : a * R;
}

template <bool kPacked>
__host__ __device__ __forceinline__ int cell_row(int a, int b, int R) {
  return row_base<kPacked>(a, R) + b;
}

template <bool kPacked>
__host__ __device__ __forceinline__ int col_step(int c, int R) {
  return kPacked ? R - c - 1 : R;
}

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

// "skip b" for cell (a, b) at lane s:
//   T[a, b-1, clip(s + x_b, 0, S-1)] + 2(r_b - r_{b-1})(s + nl_a) + 2(l_b - r_{b-1}) x_b.
// `row` is the row_base of window start a (cell (a, b') at row + b' rowS, in
// either layout), `lf`/`rt`/`xs` the instance's left, right and x.
template <typename V>
__device__ __forceinline__ V skip_value(const V* row, int64_t rowS, const V* lf, const V* rt,
                                        const int32_t* xs, int b, int s, int S, V s_nl_a) {
  using A = Arith<V>;
  const V two = A::from_int(2);
  const int x_b = xs[b];
  int si = s + x_b;
  si = si < 0 ? 0 : (si > S - 1 ? S - 1 : si);
  const V r_bm1 = rt[b - 1];
  const V shifted = row[static_cast<int64_t>(b - 1) * rowS + si];
  return A::add(A::add(shifted, A::mul(A::mul(two, A::sub(rt[b], r_bm1)), s_nl_a)),
                A::mul(A::mul(two, A::sub(lf[b], r_bm1)), A::from_int(x_b)));
}

// One detour candidate, in the reference's order:
//   ((T[a, c-1, s] + T[c, b, s]) + fac * (s + nl_a)) + turn
// with fac = 2(r_b - r_{c-1}) and turn = 2U(s + nl_c).
template <typename V>
__device__ __forceinline__ V detour_value(V t_left, V t_right, V fac, V s_nl_a, V turn) {
  using A = Arith<V>;
  return A::add(A::add(A::add(t_left, t_right), A::mul(fac, s_nl_a)), turn);
}

// Settle cell (a, b) at one lane: the reference's sentinel rule turns the
// detour fold (best, arg; arg < 0 when no start was live) into (det, argc),
// then T = min(skip, det) and C = -1 where skip wins ties, else argc.
template <typename V>
__device__ __forceinline__ void settle(V* t_out, int32_t* c_out, V skip, V best, int arg,
                                       int c_lo, int b, int R, int static_tile) {
  const V big = Arith<V>::big();
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
  const bool take_skip = skip <= det;
  *t_out = take_skip ? skip : det;
  *c_out = take_skip ? -1 : argc;
}

// Smallest live detour start of cell (a, b): a + 1, raised to b - span under
// LOGDP (span >= 0), and b + 1 (no detour) for a > 0 under SIMPLEDP.
__device__ __forceinline__ int window_start(int a, int b, int span, int disjoint) {
  int c_lo = a + 1;
  if (span >= 0 && b - span > c_lo) c_lo = b - span;
  if (disjoint && a > 0) c_lo = b + 1;
  return c_lo;
}

}  // namespace ltsp
