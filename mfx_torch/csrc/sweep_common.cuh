// Building blocks of the sparse sweeps. For the SGD sweeps (sgd_sweep.cu,
// sgd_sweep_tile.cu, sgd_sweep_step_u.cu): one tile's ids, snapshot gather,
// duplicate-row grouping, residuals and run sums, for plain (rows, rank)
// f32 tables, with the biases, where there are any outside the tables, in
// vectors of their own (use_bias: BIAS_NONE, BIAS_TILE, or BIAS_EPOCH for
// biases that are read and never written). Shared memory holds HALF<RANK>
// lanes of a row at once: the whole row at ranks 1 to 64 (ROW4<RANK>
// float4 a row), lanes 0-63 and 64-127 in turn at rank 128, whose two
// 128-lane snapshots at T = 256 (256 KB) would not fit a block's 227 KB;
// the dots are carried across the two halves. The row gather and the key
// sort also serve bpr_sweep.cu's three sides.
// One thread block of THREADS threads works on one tile at a time;
// every function here is called by all of its threads. For sgd_sweep.cu,
// sgd_sweep_tile.cu, sgd_sweep_step_u.cu and bpr_sweep.cu: the wavefront
// scheduler (at the end of this file), with which the blocks of one launch
// share a sweep's tiles; dense_phase.cu uses its release / acquire pair,
// its grid sizing and its in-order sum.
//
// Ranks 16, 8 and 4 (4, 2 and 1 float4 a row) keep every layout and order
// above: a slot keeps its group of 8 dot threads, of which threads 0-3,
// 0-1 or 0 hold a float4 and the rest keep a chain of 0, so the butterfly
// adds exact zeros and the dot is the rank-32 order of the row padded with
// zero lanes (the plain versions' kernel_dot pads so). A slot with fewer
// threads would free no barrier: a tile's phases wait on each other, not
// on the dot's lanes. The gather, the scatters and the pool walk rows of
// RANK / 4 float4 with one thread a float4, as at the larger ranks.
//
// Ranks 2 and 1 (less than a float4 a row). A row in shared memory stays
// one float4 (ROW4), whose lanes past the rank hold 0: every phase inside
// a tile is the rank-4 one, the dot is still the rank-32 order of the row
// padded with zero lanes, and a pad lane's delta is lr (e 0 - reg 0) = 0
// and is never stored. Only the table I/O narrows: ld_quad / st_quad read
// and write a row as a float2 at rank 2 and a float at rank 1 (a float4
// at rank 4 and up), so no access runs past a row of the table or leaves
// its alignment.
//
// bf16 (sgd.mxu='bf16', the reference's mxu_bf16 branch; a runtime flag of
// the SGD sweeps): the values read from the tables enter the residual and
// the deltas rounded to bf16 (round to nearest even): each row's lanes in
// dot_part and run_delta, the per-tile biases in finish_residuals and
// run_bias_delta; each slot's delta is rounded to bf16 before the run's
// sum, which is f32. The rounding happens at these points of use only: the
// snapshot in shared memory stays f32, so a row's new value is its f32
// value plus the sum of its rounded deltas, as the reference's one-hot
// scatter adds them to its f32 table. A bf16 delta is computed with
// __fmul_rn / __fsub_rn, one rounding an operation and no contraction
// into an fma, as the plain version's separate tensor ops round; with
// the flag off every expression is the f32 form's, bit for bit.
//
// Order of every sum inside a tile, so that a run is bitwise repeatable:
//   dot      8 threads a slot, each a fixed-order fma chain over its
//            float4 (k, k + 8, ... of the row, across both halves where
//            the row is held in two), then a fixed butterfly over the 8;
//   pred     ((dot + mu) + bu) + bi per tile, (dot + mu) + (bu + bi)
//            with epoch-frozen biases (the reference's per-slot stream);
//   row sum  the deltas of a row's slots in ascending slot order (a
//            bitonic sort of unique (row << 8 | slot) keys puts them
//            next to each other), added to the row's snapshot last.
// No float atomics anywhere.
//
// Rank 128, in the tile-bias, epoch and step_u sweeps (sgd_sweep.cu's lane
// and time forms do the same with their own injections): gather lanes 0-63
// (and the biases) and take each thread's part of the dots, gather lanes
// 64-127 and carry the same chains on, finish the residuals, scatter lanes
// 64-127, then gather lanes 0-63 again and scatter them. The second gather
// of lanes 0-63 still reads the tile-start values: the first scatter
// writes only lanes 64-127, and under the wavefront no other block writes
// the tile's rows while it runs. The biases are gathered and written once.
//
// Order between tiles. A tile reads and writes only the P rows of its user
// block and the Q rows of its item window, so the result of a sweep is
// fixed by two orders: that of the tiles of each user block, and that of
// the tiles of each window. The plan stream keeps a user block's tiles
// together (a run); the scheduler gives each run to one block, which walks
// it front to back, and makes a stratum's first tile wait until the
// nearest earlier run with tiles in the same window has finished them
// (the plan's dependency table). Every tile therefore gathers exactly the
// rows the one-block, plan-order walk would have shown it, and the tables
// come out bit for bit the same on any number of blocks.
//
// Memory ordering of P, Q, bu and bi. Rows written on one SM are gathered
// on another inside one launch, and an SM's L1 is not coherent with
// another SM's stores. So (1) every load of a table row goes to L2
// (ld_row / __ldcg), never through L1 or the read-only path, and the
// tables are not const __restrict__; (2) a block makes a stratum's rows
// visible before it says so: the barrier that ends the scatter, then one
// thread's __threadfence() and a release store of the run's finished-tile
// count; (3) one thread of a waiting block reads that count with acquire
// loads, and the block's barrier then orders every thread's gather behind
// it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace mfx_sweep {

constexpr int THREADS = 512;
constexpr int MAX_T = 256;       // tile size limit; slot ids fit 8 bits
constexpr int MAX_BLOCK = 1024;  // largest su / si
constexpr int NO_ROW = INT_MAX;  // sort key of a pad slot (sorts last)

// use_bias: no biases; per-tile biases, gathered and scattered like the
// rows; epoch-frozen biases, gathered only
constexpr int BIAS_NONE = 0, BIAS_TILE = 1, BIAS_EPOCH = 2;

// Lanes of a row in shared memory at once: the whole row at ranks 1 to 64,
// 64 lanes (two halves) at rank 128.
template <int RANK>
constexpr int HALF = RANK < 64 ? RANK : 64;

// float4 a row of LANES lanes takes in shared memory (one, zero-padded,
// below rank 4)
template <int LANES>
constexpr int ROW4 = LANES < 4 ? 1 : LANES / 4;

template <int RANK>  // lanes a row in shared memory
struct TileSmem {
  static constexpr int Q4 = ROW4<RANK>;  // float4 per row
  float4* Ps;  // (T, Q4) user-row snapshot
  float4* Qs;  // (T, Q4) item-row snapshot
  int* uid;    // (T,) block-local user id (su = pad)
  int* iid;    // (T,) window-local item id (si = pad)
  float* e;    // (T,) rating, then residual (0 for pad slots)
  float* bus;  // (T,) user-bias snapshot (unused without biases)
  float* bis;  // (T,) item-bias snapshot
  int* keyU;   // (MAX_T,) (user id << 8 | slot), sorted ascending
  int* keyI;   // (MAX_T,) (item id << 8 | slot), sorted ascending; right
               // after keyU (sort_keys<2>(keyU) sorts both)

  __host__ __device__ static size_t bytes(int T) {
    return (size_t)2 * T * Q4 * sizeof(float4) + (size_t)5 * T * 4 +
           (size_t)2 * MAX_T * 4;
  }

  __device__ static TileSmem carve(float4* base, int T) {
    TileSmem s;
    s.Ps = base;
    s.Qs = s.Ps + T * Q4;
    s.uid = reinterpret_cast<int*>(s.Qs + T * Q4);
    s.iid = s.uid + T;
    s.e = reinterpret_cast<float*>(s.iid + T);
    s.bus = s.e + T;
    s.bis = s.bus + T;
    s.keyU = reinterpret_cast<int*>(s.bis + T);
    s.keyI = s.keyU + MAX_T;
    return s;
  }
};

__device__ inline float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ inline float delta(float e, float other, float own, float lr,
                              float reg) {
  return lr * (e * other - reg * own);
}

// x rounded to bf16 (round to nearest even) and widened back to f32
__device__ inline float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ inline float4 bf16r4(float4 v) {
  return make_float4(bf16r(v.x), bf16r(v.y), bf16r(v.z), bf16r(v.w));
}

// The bf16 form's delta of one lane: the operands rounded, lr (e other -
// reg own) with one rounding an operation, the result rounded.
__device__ inline float delta_bf16(float e, float other, float own, float lr,
                                   float reg) {
  return bf16r(__fmul_rn(
      lr, __fsub_rn(__fmul_rn(e, bf16r(other)),
                    __fmul_rn(reg, bf16r(own)))));
}

__device__ inline float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// 1. ids, ratings and the unsorted (row, slot) keys of the tile at tt
template <int RANK>
__device__ inline void load_ids(const TileSmem<RANK>& sm, const int* tt, int T,
                                int su) {
  const int tid = threadIdx.x;
  if (tid < MAX_T) {
    int ku = NO_ROW, ki = NO_ROW;
    if (tid < T) {
      const int u = tt[tid], i = tt[T + tid];
      sm.uid[tid] = u;
      sm.iid[tid] = i;
      sm.e[tid] = __int_as_float(tt[2 * T + tid]);
      if (u < su) {
        ku = u << 8 | tid;
        ki = i << 8 | tid;
      }
    }
    sm.keyU[tid] = ku;
    sm.keyI[tid] = ki;
  }
}

// A load of table data that another SM may have written in this launch:
// from L2, past this SM's L1 (see "Memory ordering" above).
__device__ inline float4 ld_row(const float4* p) { return __ldcg(p); }
__device__ inline float2 ld_row(const float2* p) { return __ldcg(p); }
__device__ inline float ld_row(const float* p) { return __ldcg(p); }

// Float4 q of row `row` of a table of rows of RANK floats: the row's
// float4 q at rank 4 and up; below it the whole row (q is 0), a float2 at
// rank 2 and a float at rank 1, with the lanes past the rank 0. L2: a load
// from L2 (ld_row), else a plain load (memory only this block writes).
template <int RANK, bool L2 = true>
__device__ inline float4 ld_quad(const float* table, long long row, int q) {
  if constexpr (RANK >= 4) {
    const float4* p = reinterpret_cast<const float4*>(table) +
                      row * (RANK / 4) + q;
    return L2 ? ld_row(p) : *p;
  } else if constexpr (RANK == 2) {
    const float2* p = reinterpret_cast<const float2*>(table) + row;
    const float2 v = L2 ? ld_row(p) : *p;
    return make_float4(v.x, v.y, 0.f, 0.f);
  } else {
    const float* p = table + row;
    return make_float4(L2 ? ld_row(p) : *p, 0.f, 0.f, 0.f);
  }
}

// Stores the lanes of v that lie in the row (ld_quad's layout).
template <int RANK>
__device__ inline void st_quad(float* table, long long row, int q,
                               float4 v) {
  if constexpr (RANK >= 4)
    reinterpret_cast<float4*>(table)[row * (RANK / 4) + q] = v;
  else if constexpr (RANK == 2)
    reinterpret_cast<float2*>(table)[row] = make_float2(v.x, v.y);
  else
    table[row] = v.x;
}

// 2. snapshot gather of N tables' rows for the T slots of a tile: for each
// n, float4 [q_off, q_off + HQ4) of row base[n] + id[n][s] of table src[n]
// (rows of RANK floats, ld_quad) into dst[n] (T, HQ4), zeros where slot s
// is a pad (uid[s] >= su). HQ4 threads a row, every load started before any
// store. The tables are read as they stand in L2: earlier tiles of this
// launch, on this SM or another, rewrote them. After a barrier behind the
// ids (and behind await_tile where the scheduler is used).
template <int HQ4, int RANK, int N>
__device__ inline void gather_rows(float4* const* dst, const float* const* src,
                                   const long long* base,
                                   const int* const* id, const int* uid,
                                   int T, int su, int q_off) {
  // float4 a thread a table (rounded up: below rank 32 a tile's rows hold
  // fewer float4 than the block has threads)
  constexpr int GATHER = (MAX_T * HQ4 + THREADS - 1) / THREADS;
  const int tid = threadIdx.x;
  float4 v[N][GATHER];
#pragma unroll
  for (int m = 0; m < GATHER; ++m) {
    const int idx = tid + m * THREADS, s = idx / HQ4, k = idx % HQ4;
#pragma unroll
    for (int n = 0; n < N; ++n) v[n][m] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < T && uid[s] < su) {
#pragma unroll
      for (int n = 0; n < N; ++n)
        v[n][m] = ld_quad<RANK>(src[n], base[n] + id[n][s], q_off + k);
    }
  }
#pragma unroll
  for (int m = 0; m < GATHER; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < T * HQ4) {
#pragma unroll
      for (int n = 0; n < N; ++n) dst[n][idx] = v[n][m];
    }
  }
}

// 2 for the SGD sweeps: the P and Q rows' float4 [q_off, q_off + ROW4<H>)
// of rows of RANK floats, and with use_bias the slots' biases.
template <int H, int RANK = H>
__device__ inline void gather(const TileSmem<H>& sm, const float* P,
                              const float* Q, const float* bu, const float* bi,
                              long long pbase, long long qbase, int T, int su,
                              int use_bias, int q_off = 0) {
  const int tid = threadIdx.x;
  float b_u = 0.f, b_i = 0.f;
  if (use_bias && tid < T) {
    const int u = sm.uid[tid];
    if (u < su) {
      b_u = ld_row(bu + pbase + u);
      b_i = ld_row(bi + qbase + sm.iid[tid]);
    }
  }
  float4* const dst[2] = {sm.Ps, sm.Qs};
  const float* const src[2] = {P, Q};
  const long long base[2] = {pbase, qbase};
  const int* const id[2] = {sm.uid, sm.iid};
  gather_rows<ROW4<H>, RANK, 2>(dst, src, base, id, sm.uid, T, su, q_off);
  if (use_bias && tid < T) {
    sm.bus[tid] = b_u;
    sm.bis[tid] = b_i;
  }
}

// 3. bitonic sort of N key arrays of MAX_T, one after another from key:
// MAX_T / 2 compare-exchange pairs an array and step, one a thread of
// [0, N * MAX_T / 2). Keys are unique, so the order is exact and a row's
// slots end up adjacent in ascending slot order. Begins and ends with a
// barrier.
template <int N>
__device__ inline void sort_keys(int* key) {
  static_assert(N * MAX_T / 2 <= THREADS, "one thread a pair");
  const int tid = threadIdx.x, side = tid / (MAX_T / 2);
  const int pair = tid % (MAX_T / 2);
  int* k_side = key + side * MAX_T;
  for (int k = 2; k <= MAX_T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      if (side < N) {
        const int i = (pair / j) * 2 * j + pair % j, ixj = i + j;
        const int a = k_side[i], b = k_side[ixj];
        if ((a > b) == ((i & k) == 0)) {
          k_side[i] = b;
          k_side[ixj] = a;
        }
      }
    }
  }
  __syncthreads();
}

// 4. residuals into sm.e (0 for pad slots). A thread's group of 8 takes
// slots g, g + 64, ...: DOT_SLOTS of them at most.
constexpr int DOT_SLOTS = MAX_T / (THREADS / 8);

// 4a. this thread's fma chain of each of its slots' dots, over its float4
// of the lanes in shared memory, carried on from v (0 at the tile's start);
// with bf16 of the lanes rounded to bf16
template <int RANK>
__device__ inline void dot_part(const TileSmem<RANK>& sm, int T,
                                float (&v)[DOT_SLOTS], bool bf16 = false) {
  constexpr int Q4 = ROW4<RANK>;
  const int g = threadIdx.x >> 3, k = threadIdx.x & 7;
#pragma unroll
  for (int n = 0; n < DOT_SLOTS; ++n) {
    const int s = n * (THREADS / 8) + g;
    if (s < T) {
      const float4* p = sm.Ps + s * Q4;
      const float4* q = sm.Qs + s * Q4;
      if (bf16) {
#pragma unroll
        for (int kk = k; kk < Q4; kk += 8)
          v[n] = dot4(bf16r4(p[kk]), bf16r4(q[kk]), v[n]);
      } else {
#pragma unroll
        for (int kk = k; kk < Q4; kk += 8) v[n] = dot4(p[kk], q[kk], v[n]);
      }
    }
  }
}

// 4b. the butterfly over each group's 8 chains, then the residual; with
// bf16 per-tile biases enter it rounded (epoch-frozen ones do not: they are
// the reference's f32 stream)
__device__ inline void finish_residuals(float* e, const int* uid,
                                        const float* bus, const float* bis,
                                        int T, int su, float mu, int use_bias,
                                        float (&v)[DOT_SLOTS],
                                        bool bf16 = false) {
  const int g = threadIdx.x >> 3, k = threadIdx.x & 7;
#pragma unroll
  for (int n = 0; n < DOT_SLOTS; ++n) {
    if (n * (THREADS / 8) >= T) break;  // the same for the whole block
    const int s = n * (THREADS / 8) + g;
    float w = v[n];
    w += __shfl_xor_sync(0xffffffffu, w, 4);
    w += __shfl_xor_sync(0xffffffffu, w, 2);
    w += __shfl_xor_sync(0xffffffffu, w, 1);
    if (s < T && k == 0) {
      float pred = w + mu;
      if (use_bias == BIAS_EPOCH)
        pred = pred + (bus[s] + bis[s]);
      else if (use_bias == BIAS_TILE && bf16)
        pred = (pred + bf16r(bus[s])) + bf16r(bis[s]);
      else if (use_bias == BIAS_TILE)
        pred = (pred + bus[s]) + bis[s];
      e[s] = uid[s] < su ? e[s] - pred : 0.f;
    }
  }
}

// 2-4 of the tile-bias, epoch and step_u sweeps for rows of RANK lanes:
// gather lanes 0 .. HALF - 1 and the biases, sort the keys, take each
// thread's part of the dots; at rank 128 gather lanes 64-127 and carry the
// chains on; then the residuals. After the barrier behind load_ids (and
// await_tile); ends with a barrier, the last half gathered in sm.
template <int RANK>
__device__ inline void gather_residuals(const TileSmem<HALF<RANK>>& sm,
                                        const float* P, const float* Q,
                                        const float* bu, const float* bi,
                                        long long pbase, long long qbase,
                                        int T, int su, float mu,
                                        int use_bias, bool bf16) {
  constexpr int H = HALF<RANK>, HQ4 = ROW4<H>;
  gather<H, RANK>(sm, P, Q, bu, bi, pbase, qbase, T, su, use_bias);
  sort_keys<2>(sm.keyU);
  float v[DOT_SLOTS] = {};
  dot_part(sm, T, v, bf16);
#pragma unroll
  for (int h = 1; h < RANK / H; ++h) {
    __syncthreads();
    gather<H, RANK>(sm, P, Q, nullptr, nullptr, pbase, qbase, T, su,
                    BIAS_NONE, h * HQ4);
    __syncthreads();
    dot_part(sm, T, v, bf16);
  }
  finish_residuals(sm.e, sm.uid, sm.bus, sm.bis, T, su, mu, use_bias, v,
                   bf16);
  __syncthreads();
}

// Does sorted position p hold the first slot of a real row's run?
__device__ inline bool starts_run(const int* key, int p) {
  const int k0 = key[p];
  return k0 != NO_ROW && (p == 0 || (key[p - 1] >> 8) != (k0 >> 8));
}

// Column quad q of the summed deltas of the run that starts at sorted
// position p, its slots in ascending order (each rounded to bf16 first
// with bf16).
template <int Q4>
__device__ inline float4 run_delta(const int* key, const float4* own,
                                   const float4* other, const float* e, int p,
                                   int q, float lr, float reg,
                                   bool bf16 = false) {
  const int x = key[p] >> 8;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int pp = p; pp < MAX_T && (key[pp] >> 8) == x; ++pp) {
    const int j = key[pp] & 255;
    const float ej = e[j];
    const float4 o = other[j * Q4 + q], w = own[j * Q4 + q];
    if (bf16) {
      a.x += delta_bf16(ej, o.x, w.x, lr, reg);
      a.y += delta_bf16(ej, o.y, w.y, lr, reg);
      a.z += delta_bf16(ej, o.z, w.z, lr, reg);
      a.w += delta_bf16(ej, o.w, w.w, lr, reg);
    } else {
      a.x += delta(ej, o.x, w.x, lr, reg);
      a.y += delta(ej, o.y, w.y, lr, reg);
      a.z += delta(ej, o.z, w.z, lr, reg);
      a.w += delta(ej, o.w, w.w, lr, reg);
    }
  }
  return a;
}

// The summed bias deltas lr (e - reg b) of the same run (with bf16: b
// rounded, each delta rounded).
__device__ inline float run_bias_delta(const int* key, const float* b,
                                       const float* e, int p, float lr,
                                       float reg, bool bf16 = false) {
  const int x = key[p] >> 8;
  float a = 0.f;
  for (int pp = p; pp < MAX_T && (key[pp] >> 8) == x; ++pp) {
    const int j = key[pp] & 255;
    if (bf16)
      a += bf16r(__fmul_rn(lr, __fsub_rn(e[j], __fmul_rn(reg, bf16r(b[j])))));
    else
      a += lr * (e[j] - reg * b[j]);
  }
  return a;
}

// 5. one side's scatter of the lanes in shared memory (HQ4 float4 a row
// there; float4 [q_off, q_off + HQ4) of the table's rows of RANK floats,
// st_quad):
// for every (sorted position, column quad), the first position of each
// row's run writes snapshot + run sum. `own` is the side's snapshot,
// `other` the other side's.
template <int HQ4, int RANK>
__device__ inline void scatter_side(float* table, long long base,
                                    const int* key, const float4* own,
                                    const float4* other, const float* e,
                                    int q_off, float lr, float reg,
                                    bool bf16) {
  for (int w = threadIdx.x; w < MAX_T * HQ4; w += THREADS) {
    const int q = w % HQ4, p = w / HQ4;
    if (!starts_run(key, p)) continue;
    const int x = key[p] >> 8, j0 = key[p] & 255;
    st_quad<RANK>(table, base + x, q_off + q,
                  add4(own[j0 * HQ4 + q],
                       run_delta<HQ4>(key, own, other, e, p, q, lr, reg,
                                      bf16)));
  }
}

// 5. one side's per-tile biases: thread lo + p, for each sorted position p
// that starts a row's run, writes the bias snapshot + the run's summed
// deltas (the item side's writers are threads [0, MAX_T), the user side's
// [MAX_T, 2 MAX_T), beside the row scatters).
__device__ inline void scatter_bias(float* b, long long base, const int* key,
                                    const float* snap, const float* e,
                                    int lo, float lr, float reg, bool bf16) {
  static_assert(THREADS == 2 * MAX_T, "one bias writer a sorted position");
  const int p = threadIdx.x - lo;
  if (p < 0 || p >= MAX_T || !starts_run(key, p)) return;
  const int x = key[p] >> 8, j0 = key[p] & 255;
  b[base + x] = snap[j0] + run_bias_delta(key, snap, e, p, lr, reg, bf16);
}

// The tile's sum of squared residuals; the value is whole on lane 0 of
// warp 0 and 0 elsewhere.
template <int RANK>
__device__ inline float tile_sse(const TileSmem<RANK>& sm, int T) {
  float part = 0.f;
  if (threadIdx.x < 32) {
    for (int s = threadIdx.x; s < T; s += 32) part += sm.e[s] * sm.e[s];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
  }
  return threadIdx.x == 0 ? part : 0.f;
}

// ---- The wavefront scheduler -------------------------------------------
//
// One launch walks a whole sweep. Its blocks take the sweep's runs (one
// user block's tiles each) in plan order by an integer ticket, walk a run
// front to back, publish how many of its tiles are finished, and before a
// stratum's first tile wait for the count the dependency table names. A
// block only ever waits on a run with a smaller ticket, which a running or
// finished block holds, so any grid size is free of deadlock; a grid of
// one block walks the tiles in plan order. Integers only: the ticket by
// atomicAdd, the counts by release stores and acquire loads.

struct Wavefront {
  const int* runs;  // (nruns, 2) first tile and tile count of each run
  const int* wait;  // (nt, 3) per tile: the (run, finished tiles) to wait
                    // for before its gather, run < 0 for none; and
                    // whether a later run may wait for its end (the last
                    // tile of a stratum). Null: no tile waits
  int* state;       // zeroed per launch: [0] the ticket, [1 + r] the tiles
                    // of run r that are finished and visible
  int nruns;
};

__device__ inline int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ inline void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               : : "l"(p), "r"(v) : "memory");
}

// The block's next run, or a value >= nruns when none is left. `slot` is
// one int of shared memory. Begins and ends with a barrier.
__device__ inline int take_run(const Wavefront& wf, int* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = atomicAdd(wf.state, 1);
  __syncthreads();
  return *slot;
}

// The scheduler's thread waits until tile t may gather; the other threads
// go on to the caller's next barrier, which orders their gather behind
// the wait. It is the block's last thread: its warp loads no ids, so the
// wait runs beside load_ids. Returns, on that thread, whether the tile's
// end is to be published.
__device__ inline bool await_tile(const Wavefront& wf, int t) {
  if (threadIdx.x != THREADS - 1 || wf.wait == nullptr) return false;
  const int run = wf.wait[3 * t], count = wf.wait[3 * t + 1];
  const bool ends_stratum = wf.wait[3 * t + 2] != 0;
  if (run >= 0)
    while (ld_acquire(wf.state + 1 + run) < count) __nanosleep(32);
  return ends_stratum;
}

// After the barrier that ends a tile's scatter, with await_tile's answer
// for the tile: where a later run may wait for it, make the rows of the
// run's first `finished` tiles visible to every SM and say so.
__device__ inline void publish(const Wavefront& wf, bool ends_stratum,
                               int run, int finished) {
  if (!ends_stratum) return;
  __threadfence();
  st_release(wf.state + 1 + run, finished);
}

// The sweeps' compile-time ranks (the four SGD and BPR sweeps): returns
// f(std::integral_constant<int, R>()) for the R equal to `rank`, `other`
// for any other rank.
template <class F>
inline int with_rank(int rank, int other, F&& f) {
  switch (rank) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return other;
  }
}

// Thread blocks of `kernel` (at `threads` threads and `smem` bytes of
// dynamic shared memory) that the current device holds at once: SMs x
// blocks an SM. Minus the CUDA error if a call fails.
template <class Kernel>
inline int resident_blocks(Kernel kernel, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  return err == cudaSuccess ? sms * per_sm : -(int)err;
}

// out[0] = ((sums[0] + sums[1]) + ...) + sums[n - 1]: the per-tile SSE or
// loss added in tile order, as one block carrying the sum through the
// plan-order walk adds them. One thread adds (the chain of dependent adds
// is the sum's order); the other warps stage the next SUM_CHUNK values in
// shared memory meanwhile, so the adder never waits on device memory.
constexpr int SUM_THREADS = 256;
constexpr int SUM_CHUNK = 2048;

static __global__ void __launch_bounds__(SUM_THREADS)
ordered_sum_kernel(const float* __restrict__ sums, int n,
                   float* __restrict__ out) {
  __shared__ float buf[2][SUM_CHUNK];
  const int tid = threadIdx.x;
  float acc = 0.f;
  for (int c = -SUM_CHUNK, b = 0; c < n; c += SUM_CHUNK, b ^= 1) {
    // warps 1.. load chunk c + SUM_CHUNK; thread 0 adds chunk c
    if (tid >= 32) {
      const int c1 = c + SUM_CHUNK;
      for (int i = tid - 32; i < SUM_CHUNK && c1 + i < n;
           i += SUM_THREADS - 32)
        buf[b ^ 1][i] = sums[c1 + i];
    } else if (tid == 0 && c >= 0) {
      const int m = min(SUM_CHUNK, n - c);
      for (int i = 0; i < m; ++i) acc += buf[b][i];
    }
    __syncthreads();
  }
  if (tid == 0) out[0] = acc;
}

}  // namespace mfx_sweep
