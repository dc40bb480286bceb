// LTSP dynamic-program tables for Hopper (sm_90a), built as a tiled interval
// DP: the main path's table build.
//
// Replaces the TPU kernel of the JAX package, src/repro/kernels/ltsp_dp/
// ltsp_dp.py: `wavefront_kernel` (:101), launched by `ltsp_dp_wavefront`
// (:237, the pallas_call at :292) from the driver `ltsp_dp_tables` (:307).
//
// What it computes, for instance i, window (a, b) with a < b and every skip
// count s in [0, S):
//   skip  = T[a, b-1, clip(s + x_b, 0, S-1)] + 2(r_b - r_{b-1})(s + nl_a)
//           + 2(l_b - r_{b-1}) x_b
//   det_c = T[a, c-1, s] + T[c, b, s] + 2(r_b - r_{c-1})(s + nl_a)
//           + 2U(s + nl_c),           c in [c_lo, b]
//   c_lo  = a + 1, raised to b - span under LOGDP, and the band is empty
//           when a > 0 under SIMPLEDP (disjoint).
//   T[a, b, s] = min(skip, det);  C[a, b, s] = -1 if skip <= det, else the
//   smallest minimising c.
// The arithmetic and the reference's sentinel rule live in ltsp_common.cuh.
//
// Layouts.  Every kernel reads and writes windows a <= b only, so each takes
// its layout as a template parameter (ltsp_common.cuh): dense planes
// [B, R, R, S], which the whole-plane paths copy to the host, or packed
// planes [B, R(R+1)/2, S], the windows a <= b alone, which the solver's
// uncaptured builds use: half the bytes, and the room for the paper's widest
// tapes (R 712, S 20,864: 63.6 GB packed, 127 GB dense).  The same cells
// are computed in the same order either way, so the two layouts agree bit
// for bit on every window a <= b.
//
// Why tiles.  Filled one anti-diagonal per launch (the JAX package's
// schedule), the DP reads both candidate operands of every (cell, c, s) from
// device memory: 2 * 8 * S * (R^3 - R) / 6 bytes, ~367 GB per (256, 8192)
// f64 table.  Inside one diagonal each value feeds at most two cells, so
// there is nothing for shared memory to catch; the reuse is across
// diagonals (T[a, c] is an operand of every later window holding it).
//
// Schedule.  The window triangle (a, b) is cut into TB x TB tiles (A, B),
// a in block A, b in block B, processed by tile diagonal D = B - A.  For a
// cell of tile (A, B) with D >= 1, the detour starts c in [(A+1) TB, B TB]
// read T[a, c-1] from a tile (A, K) and T[c, b] from a tile (K', B) that lie
// on tile diagonals < D, so they are final before D starts ("far" starts).
// The rest, c < (A+1) TB and c > B TB ("near" starts), read the tile itself.
// Per tile diagonal D:
//   1. far_fold_kernel, one launch (D >= 1): a block takes one tile and 32
//      s lanes, stages the row tiles T[A-block, c-1] and column tiles
//      T[c, B-block] through shared memory (cp.async, a ring of kStages
//      stages of kStageC starts), and folds every cell's far starts in
//      registers: a thread holds 4 x 4 cells of one lane, so each value
//      loaded from device memory serves TB cells and each value loaded from
//      shared memory 4.  Under LOGDP the stages begin at the block's lowest
//      live start, b0 - span (every cell of the block has b >= b0), so a
//      span below kStageC stages once a block, not D times; the starts
//      skipped are dead for every cell of the block.
//      The partial (value, c) goes to cell (a, b) of T and C in place, the
//      sentinel and -1 where no start is live; nothing reads those cells
//      before their own near launch.
//   2. near_fold_kernel, one launch per cell diagonal k inside the tiles
//      (b - a = D TB + k), over every tile of D: a thread per (cell, s)
//      folds the near starts below the far range, merges the far partial,
//      folds the near starts above it, applies the sentinel rule and takes
//      the skip term.  The skip term reads lane s + x_b of (a, b-1), another
//      block's lane, which is why this part stays one launch per diagonal.
// A cell's starts therefore fold as low near, far, high near: ascending c,
// each part a strict < fold and the parts merged by (value, c), so the
// smallest minimising c wins exactly as in a single ascending fold, and every
// candidate is formed by the same operations in the same order.  TB = 1 is
// the per-diagonal schedule (an empty near range), TB >= R a single tile.
//
// Bound on this card (NVIDIA H100 SXM data sheet): ~7 operations per
// candidate, (R^3 - R)/6 * S candidates, 2.3e10 at (256, 8192), ~4.7 ms at
// 34 TFLOP/s FP64; writing T and C once is ~2 ms at 3.35 TB/s dense, ~1 ms
// packed.  The far fold moves 2 * 8 / TB bytes per f64 candidate (2 bytes at
// TB = 8, ~3.5 operations per byte, below the FP64 ridge of ~10, so bytes
// bound it); the near fold reads its ~3 TB / R share of the candidates (9%
// at TB = 8, R = 256) straight from device memory, 16 bytes each.  Measured
// times are in PERF.md.
//
// The host loop `tables` issues every launch of a table build on one stream.

#include "ltsp_common.cuh"

namespace {

using ltsp::Arith;

// Tile size per table type: a constant of the build, not a knob.  On the
// H100, 8 beat 12 and 16 for float64 tables (tools/tiled_sweep.py, PERF.md):
// a larger tile cuts the far fold's bytes but grows the near fold's, which
// reads device memory with no reuse.  The far fold's two stages of 8 starts
// (65 KB of shared memory for float64) leave room for three blocks per SM;
// a third stage or 16 starts per stage leave two or one, and were slower.
template <typename V>
struct Tile {
  static constexpr int value = 8;
};

constexpr int kNearThreads = 256;  // near fold: s lanes per block
constexpr int kLanes = 32;         // far fold: s lanes per block (one warp)
constexpr int kMicro = 4;          // far fold: cells per thread along a and along b
constexpr int kStageC = 8;         // far fold: detour starts per pipeline stage
constexpr int kStages = 2;         // far fold: stages in flight (a ring of buffers)

template <typename V, int TB>
struct FarStage {
  V row[TB][kStageC][kLanes];  // cell (a, c-1) of instance i, lane s0 + lane; a in block A
  V col[kStageC][TB][kLanes];  // cell (c, b), b in block B
  V fac[kStageC][TB];          // 2 (r_b - r_{c-1})
  V nl[kStageC];               // nl_c
};

template <int TB>
constexpr int kFarThreads = (TB / kMicro) * (TB / kMicro) * kLanes;

// The first far start a block stages, of the far starts [c_first, c_last =
// b0]: c_first, raised under LOGDP (span >= 0) to b0 - span, below which no
// start is live for any window end b >= b0 of the block.
__host__ __device__ constexpr int far_c_start(int c_first, int b0, int span) {
  return span >= 0 && b0 - span > c_first ? b0 - span : c_first;
}

// Stages of kStageC starts that cover the far starts [c_start, c_last].
__host__ __device__ constexpr int far_stages(int c_start, int c_last) {
  return (c_last - c_start + kStageC) / kStageC;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Far fold of tile diagonal D >= 1: block (lane slice, tile A, instance i).
// kMasked: a LOGDP span or SIMPLEDP disjoint clip is set, so a start may be
// dead for some cells; otherwise every far start of every cell is live.
// kPacked: the layout (ltsp_common.cuh).
template <typename V, int TB, bool kMasked, bool kPacked>
__global__ void __launch_bounds__(kFarThreads<TB>, 1)
far_fold_kernel(V* __restrict__ T, int32_t* __restrict__ C, const V* __restrict__ right,
                const V* __restrict__ nl, const V* __restrict__ u, int R, int S, int D,
                int span, int disjoint) {
  static_assert(TB % kMicro == 0, "tile must hold whole micro-tiles");
  using A = Arith<V>;
  using Stage = FarStage<V, TB>;
  constexpr int kThreads = kFarThreads<TB>;
  constexpr int kPer = 16 / static_cast<int>(sizeof(V));  // values per 16-byte copy
  constexpr int kChunks = kLanes / kPer;                   // copies per lane row
  constexpr int kRowCopies = TB * kStageC * kChunks;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* stage = reinterpret_cast<Stage*>(smem_raw);

  const int tid = threadIdx.x;
  const int s0 = blockIdx.x * kLanes;
  const int a0 = blockIdx.y * TB;        // first window start of block A
  const int b0 = (blockIdx.y + D) * TB;  // first window end of block B
  const int i = blockIdx.z;
  const int c_first = a0 + TB;  // far starts: [c_first, c_last]
  const int c_last = b0;
  int c_start = c_first;  // the stages cover [c_start, c_last]
  if constexpr (kMasked) c_start = far_c_start(c_first, b0, span);
  const int n_stages = far_stages(c_start, c_last);

  const int64_t rowS = static_cast<int64_t>(S);
  const int64_t plane = static_cast<int64_t>(i) * ltsp::plane_rows<kPacked>(R) * rowS;
  V* Ti = T + plane;
  int32_t* Ci = C + plane;
  const V* rt = right + static_cast<int64_t>(i) * R;
  const V* nls = nl + static_cast<int64_t>(i) * R;
  const V two = A::from_int(2);

  // Stage `st` (starts c0 .. c0 + kStageC - 1) into buffer `buf`; starts
  // past c_last and window ends past R - 1 load clamped, never-used rows.
  auto load = [&](int st, int buf) {
    Stage& sm = stage[buf];
    const int c0 = c_start + st * kStageC;
    for (int idx = tid; idx < 2 * kRowCopies; idx += kThreads) {
      const int rem = idx % kRowCopies;
      const int chunk = rem % kChunks;
      const int q = rem / kChunks;
      if (idx < kRowCopies) {  // q = ii * kStageC + cc
        const int ii = q / kStageC, cc = q % kStageC;
        const int c = min(c0 + cc, c_last);
        cp_async16(&sm.row[ii][cc][chunk * kPer],
                   Ti + static_cast<int64_t>(ltsp::cell_row<kPacked>(a0 + ii, c - 1, R)) * rowS +
                       s0 + chunk * kPer);
      } else {  // q = cc * TB + jj
        const int cc = q / TB, jj = q % TB;
        const int c = min(c0 + cc, c_last);
        const int b = min(b0 + jj, R - 1);
        cp_async16(&sm.col[cc][jj][chunk * kPer],
                   Ti + static_cast<int64_t>(ltsp::cell_row<kPacked>(c, b, R)) * rowS + s0 +
                       chunk * kPer);
      }
    }
    for (int idx = tid; idx < kStageC * TB; idx += kThreads) {
      const int cc = idx / TB, jj = idx % TB;
      const int c = min(c0 + cc, c_last);
      sm.fac[cc][jj] = A::mul(two, A::sub(rt[min(b0 + jj, R - 1)], rt[c - 1]));
      if (jj == 0) sm.nl[cc] = nls[c];
    }
  };

  // This thread's lane and 4 x 4 cells (a0 + ma0 + ma, b0 + mb0 + mb).
  const int lane = tid % kLanes;
  const int m = tid / kLanes;
  const int ma0 = (m / (TB / kMicro)) * kMicro;
  const int mb0 = (m % (TB / kMicro)) * kMicro;
  const V sv = A::from_int(s0 + lane);
  const V two_u = A::mul(two, u[i]);
  V s_nl_a[kMicro];
  bool row_live[kMicro];  // SIMPLEDP: only the root row a = 0 takes detours
  int lo_b[kMicro];       // LOGDP: starts below b - span are dead
#pragma unroll
  for (int ma = 0; ma < kMicro; ++ma) {
    s_nl_a[ma] = A::add(sv, nls[a0 + ma0 + ma]);
    row_live[ma] = !(disjoint && a0 + ma0 + ma > 0);
  }
#pragma unroll
  for (int mb = 0; mb < kMicro; ++mb) lo_b[mb] = span >= 0 ? b0 + mb0 + mb - span : 0;
  V best[kMicro][kMicro];
  int arg[kMicro][kMicro];
#pragma unroll
  for (int ma = 0; ma < kMicro; ++ma) {
#pragma unroll
    for (int mb = 0; mb < kMicro; ++mb) {
      best[ma][mb] = A::big();
      arg[ma][mb] = -1;
    }
  }

  // A ring of kStages buffers: stage st lives in buffer st % kStages, and
  // one group is committed per stage (empty past the end), so waiting for
  // all but the newest kStages - 1 groups means stage st has landed.
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_stages) load(p, p);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    if (st + kStages - 1 < n_stages) load(st + kStages - 1, (st + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const Stage& sm = stage[st % kStages];
    const int c0 = c_start + st * kStageC;
    const int n_cc = min(kStageC, c_last - c0 + 1);
    for (int cc = 0; cc < n_cc; ++cc) {
      const int c = c0 + cc;
      V rv[kMicro], cv[kMicro], fac[kMicro];
#pragma unroll
      for (int q = 0; q < kMicro; ++q) {
        rv[q] = sm.row[ma0 + q][cc][lane];
        cv[q] = sm.col[cc][mb0 + q][lane];
        fac[q] = sm.fac[cc][mb0 + q];
      }
      const V turn = A::mul(two_u, A::add(sv, sm.nl[cc]));
      const bool first = c == c_first;
#pragma unroll
      for (int ma = 0; ma < kMicro; ++ma) {
#pragma unroll
        for (int mb = 0; mb < kMicro; ++mb) {
          const V cand = ltsp::detour_value(rv[ma], cv[mb], fac[mb], s_nl_a[ma], turn);
          const bool take =
              kMasked ? (row_live[ma] && c >= lo_b[mb] &&
                         (arg[ma][mb] < 0 || cand < best[ma][mb]))
                      : (first || cand < best[ma][mb]);
          if (take) {
            best[ma][mb] = cand;
            arg[ma][mb] = c;
          }
        }
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }

  const int64_t s_off = s0 + lane;
#pragma unroll
  for (int ma = 0; ma < kMicro; ++ma) {
#pragma unroll
    for (int mb = 0; mb < kMicro; ++mb) {
      const int b = b0 + mb0 + mb;
      if (b < R) {
        const int64_t out =
            static_cast<int64_t>(ltsp::cell_row<kPacked>(a0 + ma0 + ma, b, R)) * rowS + s_off;
        Ti[out] = best[ma][mb];
        Ci[out] = arg[ma][mb];
      }
    }
  }
}

// Near fold, merge and skip of the cells of tile diagonal D on cell diagonal
// k inside their tiles: block (lane block, (tile A, row ii), instance i).
template <typename V, int TB, bool kPacked>
__global__ void __launch_bounds__(kNearThreads)
near_fold_kernel(V* __restrict__ T, int32_t* __restrict__ C, const V* __restrict__ left,
                 const V* __restrict__ right, const int32_t* __restrict__ x,
                 const V* __restrict__ nl, const V* __restrict__ u, int R, int S, int D, int k,
                 int span, int disjoint, int static_tile) {
  using A = Arith<V>;
  const int s = blockIdx.x * kNearThreads + threadIdx.x;
  const int abs_k = k < 0 ? -k : k;
  const int n_ii = TB - abs_k;
  const int tile = blockIdx.y / n_ii;
  const int ii = blockIdx.y % n_ii + (k < 0 ? abs_k : 0);
  const int i = blockIdx.z;
  const int a = tile * TB + ii;
  const int b = (tile + D) * TB + ii + k;  // b - a = D TB + k >= 1
  if (s >= S || b >= R) return;

  const V* lf = left + static_cast<int64_t>(i) * R;
  const V* rt = right + static_cast<int64_t>(i) * R;
  const int32_t* xs = x + static_cast<int64_t>(i) * R;
  const V* nls = nl + static_cast<int64_t>(i) * R;
  const V two = A::from_int(2);
  const V sv = A::from_int(s);
  const V r_b = rt[b];
  const V s_nl_a = A::add(sv, nls[a]);
  const V two_u = A::mul(two, u[i]);

  const int64_t rowS = static_cast<int64_t>(S);
  const int64_t plane = static_cast<int64_t>(i) * ltsp::plane_rows<kPacked>(R) * rowS;
  const int64_t a_off = plane + static_cast<int64_t>(ltsp::row_base<kPacked>(a, R)) * rowS;
  V* row = T + a_off;  // cell (a, b') at row[b' rowS]
  int32_t* c_row = C + a_off;
  const V* Ti = T + plane;
  const int64_t out = static_cast<int64_t>(b) * rowS + s;

  const V skip = ltsp::skip_value(row, rowS, lf, rt, xs, b, s, S, s_nl_a);

  const int c_lo = ltsp::window_start(a, b, span, disjoint);
  V best = A::big();
  int arg = -1;
  // Fold the starts c_from .. c_to in ascending order: (a, c-1) walks along
  // row a, (c, b) down column b.
  auto fold = [&](int c_from, int c_to) {
    if (c_from > c_to) return;
    int64_t left_off = static_cast<int64_t>(c_from - 1) * rowS + s;
    int64_t col_off = static_cast<int64_t>(ltsp::cell_row<kPacked>(c_from, b, R)) * rowS + s;
    int64_t col_step = static_cast<int64_t>(ltsp::col_step<kPacked>(c_from, R)) * rowS;
    for (int c = c_from; c <= c_to; ++c) {
      const V cand = ltsp::detour_value(row[left_off], Ti[col_off],
                                        A::mul(two, A::sub(r_b, rt[c - 1])), s_nl_a,
                                        A::mul(two_u, A::add(sv, nls[c])));
      if (arg < 0 || cand < best) {
        best = cand;
        arg = c;
      }
      left_off += rowS;
      col_off += col_step;
      if (kPacked) col_step -= rowS;
    }
  };
  fold(c_lo, min(b, (tile + 1) * TB - 1));
  if (D > 0) {
    const int far_arg = c_row[out];
    const V far_best = row[out];
    if (far_arg >= 0 && (arg < 0 || far_best < best)) {
      best = far_best;
      arg = far_arg;
    }
    fold(max(c_lo, (tile + D) * TB + 1), b);
  }
  ltsp::settle(row + out, c_row + out, skip, best, arg, c_lo, b, R, static_tile);
}

int n_tiles_of(int R, int TB) { return (R + TB - 1) / TB; }

template <typename V, bool kMasked>
auto far_kernel(int packed) {
  return packed ? far_fold_kernel<V, Tile<V>::value, kMasked, true>
                : far_fold_kernel<V, Tile<V>::value, kMasked, false>;
}

template <typename V>
int far_launch(void* T, void* C, const void* right, const void* nl, const void* u, int B,
               int R, int S, int D, int span, int disjoint, int packed, void* stream) {
  constexpr int TB = Tile<V>::value;
  if (B < 1 || R < 2 || R > ltsp::kMaxR || S < 1 || S % kLanes != 0 || D < 1 ||
      D >= n_tiles_of(R, TB)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int smem = static_cast<int>(kStages * sizeof(FarStage<V, TB>));
  auto kernel = (span >= 0 || disjoint) ? far_kernel<V, true>(packed)
                                        : far_kernel<V, false>(packed);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kLanes, n_tiles_of(R, TB) - D, B);
  kernel<<<grid, kFarThreads<TB>, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(T), static_cast<int32_t*>(C), static_cast<const V*>(right),
      static_cast<const V*>(nl), static_cast<const V*>(u), R, S, D, span, disjoint);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int near_launch(void* T, void* C, const void* left, const void* right, const void* x,
                const void* nl, const void* u, int B, int R, int S, int D, int k, int span,
                int disjoint, int static_tile, int packed, void* stream) {
  constexpr int TB = Tile<V>::value;
  const int n_tiles = n_tiles_of(R, TB);
  const int d = D * TB + k;
  if (B < 1 || R < 2 || R > ltsp::kMaxR || S < 1 || D < 0 || D >= n_tiles || k <= -TB ||
      k >= TB ||
      (D == 0 && k < 1) || d < 1 || d > R - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_ii = TB - (k < 0 ? -k : k);
  const dim3 grid((S + kNearThreads - 1) / kNearThreads, (n_tiles - D) * n_ii, B);
  auto kernel = packed ? near_fold_kernel<V, TB, true> : near_fold_kernel<V, TB, false>;
  kernel<<<grid, kNearThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(T), static_cast<int32_t*>(C), static_cast<const V*>(left),
      static_cast<const V*>(right), static_cast<const int32_t*>(x), static_cast<const V*>(nl),
      static_cast<const V*>(u), R, S, D, k, span, disjoint, static_tile);
  return static_cast<int>(cudaGetLastError());
}

// Every launch of one table build, in the order of ref.py's tile_schedule.
// Besides the launches it counts the far fold's block-stages: those staged
// (*n_far_stages) and those that staging every block from its c_first would
// take (*n_far_stages_full).  Every block of tile diagonal D has b0 -
// c_first = (D - 1) TB, so its blocks stage alike.
template <typename V>
int tables(void* T, void* C, const void* left, const void* right, const void* x,
           const void* nl, const void* u, int B, int R, int S, int span, int disjoint,
           int static_tile, int packed, int* n_far, int* n_near, long long* n_far_stages,
           long long* n_far_stages_full, void* stream) {
  constexpr int TB = Tile<V>::value;
  *n_far = 0;
  *n_near = 0;
  *n_far_stages = 0;
  *n_far_stages_full = 0;
  const int n_tiles = n_tiles_of(R, TB);
  for (int D = 0; D < n_tiles; ++D) {
    if (D > 0) {
      const int err =
          far_launch<V>(T, C, right, nl, u, B, R, S, D, span, disjoint, packed, stream);
      if (err != 0) return err;
      ++*n_far;
      const long long blocks = static_cast<long long>(S / kLanes) * (n_tiles - D) * B;
      *n_far_stages += blocks * far_stages(far_c_start(TB, D * TB, span), D * TB);
      *n_far_stages_full += blocks * far_stages(TB, D * TB);
    }
    for (int k = D == 0 ? 1 : 1 - TB; k < TB; ++k) {
      const int d = D * TB + k;
      if (d < 1 || d > R - 1) continue;
      const int err = near_launch<V>(T, C, left, right, x, nl, u, B, R, S, D, k, span,
                                     disjoint, static_tile, packed, stream);
      if (err != 0) return err;
      ++*n_near;
    }
  }
  return 0;
}

}  // namespace

// Plain C entry points, one set per table type, bound with ctypes.  Each
// returns cudaGetLastError() of its launches (0 = launched) and never
// synchronises: ltsp_far_fold_* and ltsp_near_fold_* issue one launch,
// ltsp_tiled_tables_* a whole table build (counting its launches of each
// kernel into *n_far and *n_near, and the far fold's block-stages into
// *n_far_stages and *n_far_stages_full), ltsp_tile_size_* gives the tile
// size.
// `packed` picks the layout of T and C (0 dense, 1 packed).
#define LTSP_TILED_ENTRY_POINTS(SUFFIX, V)                                                   \
  extern "C" int ltsp_tile_size_##SUFFIX() { return Tile<V>::value; }                       \
  extern "C" int ltsp_far_fold_##SUFFIX(void* T, void* C, const void* right, const void* nl, \
                                        const void* u, int B, int R, int S, int D, int span, \
                                        int disjoint, int packed, void* stream) {            \
    return far_launch<V>(T, C, right, nl, u, B, R, S, D, span, disjoint, packed, stream);   \
  }                                                                                          \
  extern "C" int ltsp_near_fold_##SUFFIX(void* T, void* C, const void* left,                \
                                         const void* right, const void* x, const void* nl,  \
                                         const void* u, int B, int R, int S, int D, int k,  \
                                         int span, int disjoint, int static_tile,           \
                                         int packed, void* stream) {                         \
    return near_launch<V>(T, C, left, right, x, nl, u, B, R, S, D, k, span, disjoint,       \
                          static_tile, packed, stream);                                      \
  }                                                                                          \
  extern "C" int ltsp_tiled_tables_##SUFFIX(void* T, void* C, const void* left,             \
                                            const void* right, const void* x,               \
                                            const void* nl, const void* u, int B, int R,    \
                                            int S, int span, int disjoint, int static_tile, \
                                            int packed, int* n_far, int* n_near,            \
                                            long long* n_far_stages,                        \
                                            long long* n_far_stages_full, void* stream) {   \
    return tables<V>(T, C, left, right, x, nl, u, B, R, S, span, disjoint, static_tile,     \
                     packed, n_far, n_near, n_far_stages, n_far_stages_full, stream);        \
  }

LTSP_TILED_ENTRY_POINTS(i32, int32_t)
LTSP_TILED_ENTRY_POINTS(f32, float)
LTSP_TILED_ENTRY_POINTS(f64, double)
