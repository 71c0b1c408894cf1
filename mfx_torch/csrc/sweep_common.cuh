// Building blocks of the sparse sweeps. For the SGD sweeps (sgd_sweep.cu,
// sgd_sweep_tile.cu, sgd_sweep_step_u.cu): one tile's ids, snapshot gather,
// duplicate-row grouping, residuals and run sums, for plain (rows, RANK)
// f32 tables, with the biases, where there are any outside the tables, in
// vectors of their own (use_bias). RANK is 32 or 64 (RANK / 4 float4 a
// row). One thread block of THREADS threads works on one tile at a time;
// every function here is called by all of its threads. For sgd_sweep.cu
// and bpr_sweep.cu: the wavefront scheduler (at the end of this file),
// with which the blocks of one launch share a sweep's tiles.
//
// Order of every sum inside a tile, so that a run is bitwise repeatable:
//   dot      8 threads a slot, each a fixed-order fma chain over its
//            float4 (k, k + 8, ...), then a fixed butterfly over the 8;
//   pred     ((dot + mu) + bu) + bi;
//   row sum  the deltas of a row's slots in ascending slot order (a
//            bitonic sort of unique (row << 8 | slot) keys puts them
//            next to each other), added to the row's snapshot last.
// No float atomics anywhere.
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

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace mfx_sweep {

constexpr int THREADS = 512;
constexpr int MAX_T = 256;       // tile size limit; slot ids fit 8 bits
constexpr int MAX_BLOCK = 1024;  // largest su / si
constexpr int NO_ROW = INT_MAX;  // sort key of a pad slot (sorts last)

template <int RANK>
struct TileSmem {
  static constexpr int Q4 = RANK / 4;  // float4 per row
  float4* Ps;  // (T, Q4) user-row snapshot
  float4* Qs;  // (T, Q4) item-row snapshot
  int* uid;    // (T,) block-local user id (su = pad)
  int* iid;    // (T,) window-local item id (si = pad)
  float* e;    // (T,) rating, then residual (0 for pad slots)
  float* bus;  // (T,) user-bias snapshot (unused without biases)
  float* bis;  // (T,) item-bias snapshot
  int* keyU;   // (MAX_T,) (user id << 8 | slot), sorted ascending
  int* keyI;   // (MAX_T,) (item id << 8 | slot), sorted ascending

  __host__ __device__ static size_t bytes(int T) {
    return (size_t)2 * T * RANK * sizeof(float) + (size_t)5 * T * 4 +
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
__device__ inline float ld_row(const float* p) { return __ldcg(p); }

// 2. snapshot gather (after a barrier behind load_ids, and behind
// await_tile where the scheduler is used): RANK / 4 threads a row, every
// load started before any store. P, Q, bu and bi are read as they stand in
// L2: earlier tiles of this launch, on this SM or another, rewrote them.
template <int RANK>
__device__ inline void gather(const TileSmem<RANK>& sm, const float* P,
                              const float* Q, const float* bu, const float* bi,
                              long long pbase, long long qbase, int T, int su,
                              int use_bias) {
  constexpr int Q4 = RANK / 4;
  constexpr int GATHER = MAX_T * Q4 / THREADS;  // float4 a thread a table
  const int tid = threadIdx.x;
  const float4* P4 = reinterpret_cast<const float4*>(P);
  const float4* Qg4 = reinterpret_cast<const float4*>(Q);
  float b_u = 0.f, b_i = 0.f;
  if (use_bias && tid < T) {
    const int u = sm.uid[tid];
    if (u < su) {
      b_u = ld_row(bu + pbase + u);
      b_i = ld_row(bi + qbase + sm.iid[tid]);
    }
  }
  float4 pv[GATHER], qv[GATHER];
#pragma unroll
  for (int m = 0; m < GATHER; ++m) {
    const int idx = tid + m * THREADS, s = idx / Q4, k = idx % Q4;
    pv[m] = qv[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < T) {
      const int u = sm.uid[s];
      if (u < su) {
        pv[m] = ld_row(P4 + (pbase + u) * Q4 + k);
        qv[m] = ld_row(Qg4 + (qbase + sm.iid[s]) * Q4 + k);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < GATHER; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < T * Q4) {
      sm.Ps[idx] = pv[m];
      sm.Qs[idx] = qv[m];
    }
  }
  if (use_bias && tid < T) {
    sm.bus[tid] = b_u;
    sm.bis[tid] = b_i;
  }
}

// 3. bitonic sort of both key arrays (threads [0, 256) sort the user keys,
// [256, 512) the item keys); keys are unique, so the order is exact and a
// row's slots end up adjacent in ascending slot order. Begins and ends
// with a barrier.
__device__ inline void sort_keys(int* keyU, int* keyI) {
  const int tid = threadIdx.x;
  int* key = tid < MAX_T ? keyU : keyI;
  const int i = tid & (MAX_T - 1);
  for (int k = 2; k <= MAX_T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      __syncthreads();
      const int ixj = i ^ j;
      if (ixj > i) {
        const int a = key[i], b = key[ixj];
        if ((a > b) == ((i & k) == 0)) {
          key[i] = b;
          key[ixj] = a;
        }
      }
    }
  }
  __syncthreads();
}

// 4. residuals into sm.e (0 for pad slots)
template <int RANK>
__device__ inline void residuals(const TileSmem<RANK>& sm, int T, int su,
                                 float mu, int use_bias) {
  constexpr int Q4 = RANK / 4;
  const int g = threadIdx.x >> 3, k = threadIdx.x & 7;
  for (int s0 = 0; s0 < T; s0 += THREADS / 8) {
    const int s = s0 + g;
    float v = 0.f;
    if (s < T) {
      const float4* p = sm.Ps + s * Q4;
      const float4* q = sm.Qs + s * Q4;
#pragma unroll
      for (int kk = k; kk < Q4; kk += 8) v = dot4(p[kk], q[kk], v);
    }
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    if (s < T && k == 0) {
      float pred = v + mu;
      if (use_bias) pred = (pred + sm.bus[s]) + sm.bis[s];
      sm.e[s] = sm.uid[s] < su ? sm.e[s] - pred : 0.f;
    }
  }
}

// Does sorted position p hold the first slot of a real row's run?
__device__ inline bool starts_run(const int* key, int p) {
  const int k0 = key[p];
  return k0 != NO_ROW && (p == 0 || (key[p - 1] >> 8) != (k0 >> 8));
}

// Column quad q of the summed deltas of the run that starts at sorted
// position p, its slots in ascending order.
template <int Q4>
__device__ inline float4 run_delta(const int* key, const float4* own,
                                   const float4* other, const float* e, int p,
                                   int q, float lr, float reg) {
  const int x = key[p] >> 8;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int pp = p; pp < MAX_T && (key[pp] >> 8) == x; ++pp) {
    const int j = key[pp] & 255;
    const float ej = e[j];
    const float4 o = other[j * Q4 + q], w = own[j * Q4 + q];
    a.x += delta(ej, o.x, w.x, lr, reg);
    a.y += delta(ej, o.y, w.y, lr, reg);
    a.z += delta(ej, o.z, w.z, lr, reg);
    a.w += delta(ej, o.w, w.w, lr, reg);
  }
  return a;
}

// The summed bias deltas lr (e - reg b) of the same run.
__device__ inline float run_bias_delta(const int* key, const float* b,
                                       const float* e, int p, float lr,
                                       float reg) {
  const int x = key[p] >> 8;
  float a = 0.f;
  for (int pp = p; pp < MAX_T && (key[pp] >> 8) == x; ++pp) {
    const int j = key[pp] & 255;
    a += lr * (e[j] - reg * b[j]);
  }
  return a;
}

// Item side of step 5, for every (sorted position, column quad) and every
// sorted position's bias: the first position of a row's run writes
// snapshot + run sum to Q and bi.
template <int RANK>
__device__ inline void scatter_items(const TileSmem<RANK>& sm, float* Q,
                                     float* bi, long long qbase, int use_bias,
                                     float lr, float reg) {
  constexpr int Q4 = RANK / 4;
  float4* Q4w = reinterpret_cast<float4*>(Q);
  for (int w = threadIdx.x; w < MAX_T * Q4; w += THREADS) {
    const int q = w % Q4, p = w / Q4;
    if (!starts_run(sm.keyI, p)) continue;
    const int x = sm.keyI[p] >> 8, j0 = sm.keyI[p] & 255;
    Q4w[(qbase + x) * Q4 + q] =
        add4(sm.Qs[j0 * Q4 + q],
             run_delta<Q4>(sm.keyI, sm.Qs, sm.Ps, sm.e, p, q, lr, reg));
  }
  if (use_bias) {
    for (int p = threadIdx.x; p < MAX_T; p += THREADS) {
      if (!starts_run(sm.keyI, p)) continue;
      const int x = sm.keyI[p] >> 8, j0 = sm.keyI[p] & 255;
      bi[qbase + x] =
          sm.bis[j0] + run_bias_delta(sm.keyI, sm.bis, sm.e, p, lr, reg);
    }
  }
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
