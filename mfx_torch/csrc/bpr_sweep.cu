// Fused BPR sweep over (user, positive, negative) triples, rank 64.
//
// Replaces: mfx/kernels/bpr_pallas.py::_kernel_body, driven by
// bpr_sweep_pallas / _chunk_call (the DSGD-ring BPR sub-step).
//
// What it computes, per tile of T triples of one stratum (user block sa,
// item window tc), in plan order:
//   snapshot  p_s = P[sa*su + u_s], qi_s = Q[tc*si + i_s],
//             qj_s = Q[tc*si + j_s]                       (gather first)
//   x_s       = sum_k p_s[k] (qi_s[k] - qj_s[k])
//   e_s       = sigmoid(-x_s)
//   dP_s      = lr (e_s (qi_s - qj_s) - reg p_s)
//   dQi_s     = lr (e_s p_s - reg qi_s)
//   dQj_s     = lr (-e_s p_s - reg qj_s)
//   P row     = snapshot + sum of dP over the slots with that row
//   Q rows    = two ordered adds: first + sum of dQi over the slots whose
//               positive is the row, then (reading that result) + sum of
//               dQj over the slots whose negative is the row
//   loss     += -log(sigmoid(x_s) + 1e-12) over real slots
// Pad slots hold u == su, i == j == si and do nothing.
//
// Order: the result is that of applying the tiles strictly in plan order,
// as the TPU's sequential grid does. The launch's blocks share the
// segment by sweep_common.cuh's wavefront scheduler: each takes whole
// user-block runs in plan order and walks a run front to back, and a
// stratum's first tile waits for the nearest earlier run's tiles of the
// same item window. A tile touches only its user block's P rows and its
// window's Q rows (the negatives are drawn inside the positive's window),
// so those two orders fix every value a tile gathers: the tables are bit
// for bit the one-block walk's on any number of blocks, and a grid of one
// block is that walk. Every sum inside a tile is taken in a fixed order
// (deltas of a row in slot order, x by a fixed butterfly, the loss
// lane-strided then by a fixed butterfly), and the per-tile loss goes to
// a buffer that a second small kernel adds up in tile order, so the
// scalar is the one-block walk's too. No float atomics; the scheduler
// uses an integer ticket and integer counts.
//
// Memory ordering: P and Q rows written on one SM are gathered on another
// inside the launch, so every table load (the three gathers and the
// negatives' read-back of the positives' add) bypasses L1, and a run's
// progress is published only after a barrier and a fence
// (sweep_common.cuh).
//
// What bounds it on an H100: a tile's time is one SM's latency, not device
// memory or FLOPs. A tile moves 3*T*rank*4 bytes in (192 KB at T=256) and
// at most as much out, for about 14*rank FLOPs a slot. The design keeps
// the three snapshots in shared memory (192 KB of the 227 KB a block may
// use, so one block an SM; the ids, sort keys and per-slot e / loss take
// 12 KB), runs every phase on all 512 threads with 16-byte accesses
// (16 threads per 256-byte row), and groups duplicate rows with a bitonic
// sort of (row, slot) keys for all three sides at once (384 threads, one
// compare-exchange pair each), so each row's slots sit together in slot
// order. The deltas are recomputed from the snapshots where a row is
// written, so nothing else is stored. A segment's time is then the
// longest dependency chain's tiles (a segment of W windows keeps at most
// W blocks busy) plus the wavefront's ramp.

#include <math.h>

#include "sweep_common.cuh"

namespace {

using mfx_sweep::Wavefront;
using mfx_sweep::await_tile;
using mfx_sweep::ld_row;
using mfx_sweep::publish;
using mfx_sweep::take_run;

constexpr int RANK = 64;
constexpr int Q4 = RANK / 4;     // float4 per row
constexpr int THREADS = 512;
static_assert(THREADS == mfx_sweep::THREADS, "the scheduler's thread");
constexpr int MAX_T = 256;       // tile size limit; slot ids fit 8 bits
constexpr int MAX_BLOCK = 1024;  // largest su / si
constexpr int GATHER = MAX_T * Q4 / THREADS;  // float4 per thread per table
constexpr int NO_ROW = INT_MAX;  // sort key of a pad slot (sorts last)
constexpr int SIDES = 3;         // P (users), Q at positives, Q at negatives

struct SweepSmem {
  // laid out in dynamic shared memory by offset (see smem_bytes)
  float4* Ps;   // (T, Q4) user-row snapshot
  float4* Qi;   // (T, Q4) positive-item snapshot
  float4* Qj;   // (T, Q4) negative-item snapshot
  int* id;      // (3, T) block-local user, window-local positive, negative
  float* e;     // (T,) sigmoid(-x), 0 for pad slots
  float* loss;  // (T,) per-slot loss, 0 for pad slots
  int* key;     // (3, MAX_T) (row << 8 | slot) per side, sorted ascending
};

__host__ __device__ inline size_t smem_bytes(int T) {
  return (size_t)SIDES * T * RANK * sizeof(float) + (size_t)SIDES * T * 4 +
         (size_t)2 * T * 4 + (size_t)SIDES * MAX_T * 4;
}

__device__ inline SweepSmem carve(float4* base, int T) {
  SweepSmem s;
  s.Ps = base;
  s.Qi = s.Ps + T * Q4;
  s.Qj = s.Qi + T * Q4;
  s.id = reinterpret_cast<int*>(s.Qj + T * Q4);
  s.e = reinterpret_cast<float*>(s.id + SIDES * T);
  s.loss = s.e + T;
  s.key = reinterpret_cast<int*>(s.loss + T);
  return s;
}

__device__ inline float4 f4sub(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ inline float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// lr (g - reg w), elementwise, for g the loss-gradient term of a side
__device__ inline float4 delta(float4 g, float4 w, float lr, float reg) {
  return make_float4(lr * (g.x - reg * w.x), lr * (g.y - reg * w.y),
                     lr * (g.z - reg * w.z), lr * (g.w - reg * w.w));
}

// Column quad q of slot j's delta on one side.
__device__ inline float4 slot_delta(const SweepSmem& sm, int side, int j,
                                    int q, float lr, float reg) {
  const float e = sm.e[j];
  const float4 p = sm.Ps[j * Q4 + q];
  if (side == 0) {
    const float4 d = f4sub(sm.Qi[j * Q4 + q], sm.Qj[j * Q4 + q]);
    return delta(make_float4(e * d.x, e * d.y, e * d.z, e * d.w), p, lr, reg);
  }
  const float s = side == 1 ? e : -e;
  const float4 w = side == 1 ? sm.Qi[j * Q4 + q] : sm.Qj[j * Q4 + q];
  return delta(make_float4(s * p.x, s * p.y, s * p.z, s * p.w), w, lr, reg);
}

// Column quad q of the row at sorted position p of one side. If p starts
// its row's run of equal keys, sum the deltas of the run's slots in
// ascending slot order and write base + sum, where base is the row's
// snapshot (sides 0 and 1) or, for the negatives' add, the row as the
// positives' add left it in device memory (side 2).
__device__ inline void scatter_quad(float* table, long long base,
                                    const SweepSmem& sm, int side, int p,
                                    int q, float lr, float reg) {
  const int* key = sm.key + side * MAX_T;
  const int k0 = key[p];
  if (k0 == NO_ROW) return;
  const int x = k0 >> 8;
  if (p > 0 && (key[p - 1] >> 8) == x) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int pp = p; pp < MAX_T && (key[pp] >> 8) == x; ++pp) {
    const float4 d = slot_delta(sm, side, key[pp] & 255, q, lr, reg);
    a.x += d.x;
    a.y += d.y;
    a.z += d.z;
    a.w += d.w;
  }
  float4* row = reinterpret_cast<float4*>(table) + (base + x) * Q4 + q;
  const int j0 = k0 & 255;
  const float4 w = side == 0   ? sm.Ps[j0 * Q4 + q]
                   : side == 1 ? sm.Qi[j0 * Q4 + q]
                               : ld_row(row);
  *row = make_float4(w.x + a.x, w.y + a.y, w.z + a.z, w.w + a.w);
}

// 1. ids and the unsorted (row, slot) keys of the three sides of the tile
// at tt
__device__ inline void load_ids(const SweepSmem& sm, const int* tt, int T,
                                int su) {
  const int tid = threadIdx.x;
  if (tid >= MAX_T) return;
  int k[SIDES] = {NO_ROW, NO_ROW, NO_ROW};
  if (tid < T) {
    const int u = tt[tid], i = tt[T + tid], j = tt[2 * T + tid];
    sm.id[tid] = u;
    sm.id[T + tid] = i;
    sm.id[2 * T + tid] = j;
    if (u < su) {
      k[0] = u << 8 | tid;
      k[1] = i << 8 | tid;
      k[2] = j << 8 | tid;
    }
  }
#pragma unroll
  for (int s = 0; s < SIDES; ++s) sm.key[s * MAX_T + tid] = k[s];
}

// Steps 2 to 6 of one tile, after a barrier behind load_ids: gather, sort,
// e and loss, the ordered scatters. Writes the tile's loss to *tile_loss
// and ends with a barrier behind the last store to P and Q.
__device__ inline void update_tile(const SweepSmem& sm, float* P, float* Q,
                                   long long pbase, long long qbase, int T,
                                   int su, float lr, float reg,
                                   float* tile_loss) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* P4 = reinterpret_cast<const float4*>(P);
  const float4* Q4g = reinterpret_cast<const float4*>(Q);

  // 2. snapshot gather: 16 threads per row, every load started before any
  // store
  {
    float4 pv[GATHER], iv[GATHER], jv[GATHER];
#pragma unroll
    for (int m = 0; m < GATHER; ++m) {
      const int idx = tid + m * THREADS, s = idx / Q4, c = idx % Q4;
      pv[m] = iv[m] = jv[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < T) {
        const int u = sm.id[s];
        if (u < su) {
          pv[m] = ld_row(P4 + (pbase + u) * Q4 + c);
          iv[m] = ld_row(Q4g + (qbase + sm.id[T + s]) * Q4 + c);
          jv[m] = ld_row(Q4g + (qbase + sm.id[2 * T + s]) * Q4 + c);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < GATHER; ++m) {
      const int idx = tid + m * THREADS;
      if (idx < T * Q4) {
        sm.Ps[idx] = pv[m];
        sm.Qi[idx] = iv[m];
        sm.Qj[idx] = jv[m];
      }
    }
  }

  // 3. bitonic sort of the three key arrays: 128 compare-exchange pairs
  // per array and step, one per thread of [0, 384); keys are unique per
  // side, so the order is exact and a row's slots end up adjacent in
  // ascending slot order
  {
    const int side = tid >> 7, pair = tid & 127;
    int* key = sm.key + side * MAX_T;
    for (int k = 2; k <= MAX_T; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        __syncthreads();
        if (side < SIDES) {
          const int i = (pair / j) * 2 * j + pair % j, ixj = i + j;
          const int a = key[i], b = key[ixj];
          if ((a > b) == ((i & k) == 0)) {
            key[i] = b;
            key[ixj] = a;
          }
        }
      }
    }
  }
  __syncthreads();

  // 4. x, e and the loss: 8 threads per slot, a fixed-order sum of their 8
  // products each, then a fixed butterfly over the 8 lanes
  {
    const int g = tid >> 3, c = tid & 7;
    for (int s0 = 0; s0 < T; s0 += THREADS / 8) {
      const int s = s0 + g;
      float v = 0.f;
      if (s < T) {
        const float4* p = sm.Ps + s * Q4;
        const float4* qi = sm.Qi + s * Q4;
        const float4* qj = sm.Qj + s * Q4;
        v = dot4(p[c + 8], f4sub(qi[c + 8], qj[c + 8]),
                 dot4(p[c], f4sub(qi[c], qj[c]), 0.f));
      }
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if (s < T && c == 0) {
        const bool real = sm.id[s] < su;
        sm.e[s] = real ? 1.f / (1.f + expf(v)) : 0.f;
        sm.loss[s] = real ? -logf(1.f / (1.f + expf(-v)) + 1e-12f) : 0.f;
      }
    }
  }
  __syncthreads();

  // 5. scatter the users and the positives: one (side, sorted position,
  // column quad) per thread and step; only a run's first position writes
  for (int w = tid; w < 2 * MAX_T * Q4; w += THREADS) {
    const int q = w % Q4, rest = w / Q4;
    if (rest < MAX_T)
      scatter_quad(P, pbase, sm, 0, rest, q, lr, reg);
    else
      scatter_quad(Q, qbase, sm, 1, rest - MAX_T, q, lr, reg);
  }
  if (warp == 0) {
    float part = 0.f;
    for (int s = lane; s < T; s += 32) part += sm.loss[s];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) *tile_loss = part;
  }
  __syncthreads();  // the positives' rows are in device memory now

  // 6. scatter the negatives on top of what step 5 wrote
  for (int w = tid; w < MAX_T * Q4; w += THREADS)
    scatter_quad(Q, qbase, sm, 2, w / Q4, w % Q4, lr, reg);
  __syncthreads();
}

// P and Q are rewritten by this and other blocks during the launch, so
// they are deliberately not const/__restrict__ and every row is loaded
// from L2 (see sweep_common.cuh).
__global__ void __launch_bounds__(THREADS)
bpr_sweep_kernel(float* P, float* Q, const int* __restrict__ sa,
                 const int* __restrict__ tc, const int* __restrict__ tl,
                 Wavefront wf, float* __restrict__ sums, int tpg, int T,
                 int su, int si, float lr, float reg) {
  extern __shared__ float4 smem_raw[];
  __shared__ int run_slot;
  const SweepSmem sm = carve(smem_raw, T);

  for (int run = take_run(wf, &run_slot); run < wf.nruns;
       run = take_run(wf, &run_slot)) {
    const int t0 = wf.runs[2 * run], n = wf.runs[2 * run + 1];
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      load_ids(sm, tl + (long long)t * 3 * T, T, su);
      const bool ends_stratum = await_tile(wf, t);
      __syncthreads();
      update_tile(sm, P, Q, (long long)sa[t / tpg] * su,
                  (long long)tc[t] * si, T, su, lr, reg, sums + t);
      publish(wf, ends_stratum, run, k + 1);
    }
  }
}

}  // namespace

// Thread blocks of bpr_sweep_kernel the device holds at once at tile size
// T, or minus the CUDA error.
extern "C" int mfx_bpr_sweep_max_blocks(int T) {
  if (T < 1 || T > MAX_T) return -(int)cudaErrorInvalidValue;
  return mfx_sweep::resident_blocks(bpr_sweep_kernel, THREADS, smem_bytes(T));
}

extern "C" int mfx_bpr_sweep(float* P, float* Q, const int* sa, const int* tc,
                             const int* tl, const int* runs, const int* wait,
                             int* state, float* sums, float* loss_out, int nt,
                             int nruns, int blocks, int tpg, int T, int su,
                             int si, int rank, float lr, float reg,
                             void* stream) {
  if (rank != RANK || su > MAX_BLOCK || si > MAX_BLOCK || T < 1 ||
      T > MAX_T || tpg < 1 || nruns < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      bpr_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Wavefront wf{runs, wait, state, nruns};
  bpr_sweep_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      P, Q, sa, tc, tl, wf, sums, tpg, T, su, si, lr, reg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mfx_sweep::ordered_sum_kernel<<<1, mfx_sweep::SUM_THREADS, 0,
                                  (cudaStream_t)stream>>>(
      sums, nt, loss_out);
  return (int)cudaGetLastError();
}
