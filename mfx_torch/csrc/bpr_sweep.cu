// Fused BPR sweep over (user, positive, negative) triples, ranks 1, 2, 4,
// 8, 16, 32, 64 and 128.
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
// memory or FLOPs. A tile moves 3*T*rank*4 bytes in (192 KB at T=256 and
// rank 64) and at most as much out, for about 14*rank FLOPs a slot. The
// design keeps the three snapshots in shared memory (192 KB of the 227 KB
// a block may use at rank 64, so one block an SM; the ids, sort keys and
// per-slot e / loss take 12 KB), runs every phase on all 512 threads with
// 16-byte accesses (16 threads per 256-byte row), and groups duplicate
// rows with a bitonic sort of (row, slot) keys for all three sides at once
// (384 threads, one compare-exchange pair each), so each row's slots sit
// together in slot order. The row gather and the sort are
// sweep_common.cuh's. The deltas are recomputed from the snapshots where a
// row is written, so nothing else is stored. A segment's time is then the
// longest dependency chain's tiles (a segment of W windows keeps at most
// W blocks busy) plus the wavefront's ramp.
//
// Ranks 1 to 32 and 128. At rank 32 a row is 32 lanes (8 threads a row,
// one float4 of each dot a thread): 96 KB of snapshots at T = 256; at ranks
// 16, 8 and 4 threads 0-3, 0-1 or 0 of a row's 8 hold a float4 and the rest
// add zeros (sweep_common.cuh), 48, 24 and 12 KB of snapshots; at ranks 2
// and 1 the row is one float4 whose lanes past the rank hold 0, as at rank
// 4, and the tables are read and written a float2 or a float a row
// (sweep_common.cuh, "Ranks 2 and 1"). At rank 128
// the three snapshots would take 384 KB, so shared memory holds lanes 0-63
// and 64-127 of the rows in turn (HALF, as in the SGD sweeps): gather
// lanes 0-63 of p, qi and qj and take each thread's part of x = p.(qi -
// qj); gather lanes 64-127, carry the same chains on and finish x, e and
// the loss; scatter lanes 64-127 (P and the positives, then the negatives
// reading back the positives' result); then gather lanes 0-63 again, which
// still hold their tile-start values (nothing has written them), and
// scatter them the same way. The tile's loss is summed once.

#include <math.h>

#include "sweep_common.cuh"

namespace {

using namespace mfx_sweep;

constexpr int SIDES = 3;  // P (users), Q at positives, Q at negatives

template <int H>  // lanes a row in shared memory
struct SweepSmem {
  static constexpr int HQ4 = ROW4<H>;  // float4 per row
  // laid out in dynamic shared memory by offset (see bytes)
  float4* Ps;   // (T, HQ4) user-row snapshot
  float4* Qi;   // (T, HQ4) positive-item snapshot
  float4* Qj;   // (T, HQ4) negative-item snapshot
  int* id;      // (3, T) block-local user, window-local positive, negative
  float* e;     // (T,) sigmoid(-x), 0 for pad slots
  float* loss;  // (T,) per-slot loss, 0 for pad slots
  int* key;     // (3, MAX_T) (row << 8 | slot) per side, sorted ascending

  __host__ __device__ static size_t bytes(int T) {
    return (size_t)SIDES * T * HQ4 * sizeof(float4) +
           (size_t)SIDES * T * 4 + (size_t)2 * T * 4 +
           (size_t)SIDES * MAX_T * 4;
  }

  __device__ static SweepSmem carve(float4* base, int T) {
    SweepSmem s;
    s.Ps = base;
    s.Qi = s.Ps + T * HQ4;
    s.Qj = s.Qi + T * HQ4;
    s.id = reinterpret_cast<int*>(s.Qj + T * HQ4);
    s.e = reinterpret_cast<float*>(s.id + SIDES * T);
    s.loss = s.e + T;
    s.key = reinterpret_cast<int*>(s.loss + T);
    return s;
  }
};

__device__ inline float4 f4sub(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// lr (g - reg w), elementwise, for g the loss-gradient term of a side
__device__ inline float4 bpr_delta(float4 g, float4 w, float lr, float reg) {
  return make_float4(lr * (g.x - reg * w.x), lr * (g.y - reg * w.y),
                     lr * (g.z - reg * w.z), lr * (g.w - reg * w.w));
}

// Column quad q of slot j's delta on one side, from the lanes in shared
// memory.
template <int H>
__device__ inline float4 slot_delta(const SweepSmem<H>& sm, int side, int j,
                                    int q, float lr, float reg) {
  constexpr int HQ4 = ROW4<H>;
  const float e = sm.e[j];
  const float4 p = sm.Ps[j * HQ4 + q];
  if (side == 0) {
    const float4 d = f4sub(sm.Qi[j * HQ4 + q], sm.Qj[j * HQ4 + q]);
    return bpr_delta(make_float4(e * d.x, e * d.y, e * d.z, e * d.w), p, lr,
                     reg);
  }
  const float s = side == 1 ? e : -e;
  const float4 w = side == 1 ? sm.Qi[j * HQ4 + q] : sm.Qj[j * HQ4 + q];
  return bpr_delta(make_float4(s * p.x, s * p.y, s * p.z, s * p.w), w, lr,
                   reg);
}

// Column quad q of the shared lanes (the row's float4 q_off + q; rows of
// RANK floats, ld_quad / st_quad) of the row at sorted position p of one
// side. If p starts its row's run of equal keys, sum the deltas of the
// run's slots in ascending slot order and write base + sum, where base is
// the row's snapshot (sides 0 and 1) or, for the negatives' add, the row
// as the positives' add left it in device memory (side 2).
template <int H, int RANK>
__device__ inline void scatter_quad(float* table, long long base,
                                    const SweepSmem<H>& sm, int side, int p,
                                    int q, int q_off, float lr, float reg) {
  constexpr int HQ4 = ROW4<H>;
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
  const int j0 = k0 & 255;
  const float4 w = side == 0   ? sm.Ps[j0 * HQ4 + q]
                   : side == 1 ? sm.Qi[j0 * HQ4 + q]
                               : ld_quad<RANK>(table, base + x, q_off + q);
  st_quad<RANK>(table, base + x, q_off + q,
                make_float4(w.x + a.x, w.y + a.y, w.z + a.z, w.w + a.w));
}

// 1. ids and the unsorted (row, slot) keys of the three sides of the tile
// at tt
template <int H>
__device__ inline void load_ids(const SweepSmem<H>& sm, const int* tt, int T,
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

// 2. the three sides' float4 [q_off, q_off + ROW4<H>) of their rows of
// RANK floats
template <int H, int RANK>
__device__ inline void gather3(const SweepSmem<H>& sm, const float* P,
                               const float* Q, long long pbase,
                               long long qbase, int T, int su, int q_off) {
  float4* const dst[SIDES] = {sm.Ps, sm.Qi, sm.Qj};
  const float* const src[SIDES] = {P, Q, Q};
  const long long base[SIDES] = {pbase, qbase, qbase};
  const int* const id[SIDES] = {sm.id, sm.id + T, sm.id + 2 * T};
  gather_rows<ROW4<H>, RANK, SIDES>(dst, src, base, id, sm.id, T, su, q_off);
}

// 4a. this thread's fma chain of each of its slots' x = p.(qi - qj), over
// its float4 of the lanes in shared memory (k, k + 8, ...), carried on
// from v (0 at the tile's start)
template <int H>
__device__ inline void x_part(const SweepSmem<H>& sm, int T,
                              float (&v)[DOT_SLOTS]) {
  constexpr int HQ4 = ROW4<H>;
  const int g = threadIdx.x >> 3, c = threadIdx.x & 7;
#pragma unroll
  for (int n = 0; n < DOT_SLOTS; ++n) {
    const int s = n * (THREADS / 8) + g;
    if (s < T) {
      const float4* p = sm.Ps + s * HQ4;
      const float4* qi = sm.Qi + s * HQ4;
      const float4* qj = sm.Qj + s * HQ4;
#pragma unroll
      for (int kk = c; kk < HQ4; kk += 8)
        v[n] = dot4(p[kk], f4sub(qi[kk], qj[kk]), v[n]);
    }
  }
}

// 4b. a fixed butterfly over each slot's 8 chains, then e and the loss
template <int H>
__device__ inline void finish_x(const SweepSmem<H>& sm, int T, int su,
                                float (&v)[DOT_SLOTS]) {
  const int g = threadIdx.x >> 3, c = threadIdx.x & 7;
#pragma unroll
  for (int n = 0; n < DOT_SLOTS; ++n) {
    if (n * (THREADS / 8) >= T) break;  // the same for the whole block
    const int s = n * (THREADS / 8) + g;
    float w = v[n];
    w += __shfl_xor_sync(0xffffffffu, w, 4);
    w += __shfl_xor_sync(0xffffffffu, w, 2);
    w += __shfl_xor_sync(0xffffffffu, w, 1);
    if (s < T && c == 0) {
      const bool real = sm.id[s] < su;
      sm.e[s] = real ? 1.f / (1.f + expf(w)) : 0.f;
      sm.loss[s] = real ? -logf(1.f / (1.f + expf(-w)) + 1e-12f) : 0.f;
    }
  }
}

// Steps 2 to 6 of one tile, after a barrier behind load_ids: gather, sort,
// e and loss, the ordered scatters (at rank 128 once a half). Writes the
// tile's loss to *tile_loss and ends with a barrier behind the last store
// to P and Q.
template <int RANK>
__device__ inline void update_tile(const SweepSmem<HALF<RANK>>& sm, float* P,
                                   float* Q, long long pbase, long long qbase,
                                   int T, int su, float lr, float reg,
                                   float* tile_loss) {
  constexpr int H = HALF<RANK>, HQ4 = ROW4<H>, HALVES = RANK / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 2-4. gather, sort, x (across the halves), e and the loss
  gather3<H, RANK>(sm, P, Q, pbase, qbase, T, su, 0);
  sort_keys<SIDES>(sm.key);
  float v[DOT_SLOTS] = {};
  x_part(sm, T, v);
#pragma unroll
  for (int h = 1; h < HALVES; ++h) {
    __syncthreads();
    gather3<H, RANK>(sm, P, Q, pbase, qbase, T, su, h * HQ4);
    __syncthreads();
    x_part(sm, T, v);
  }
  finish_x(sm, T, su, v);
  __syncthreads();

#pragma unroll
  for (int h = HALVES - 1; h >= 0; --h) {
    const int q_off = h * HQ4;
    if (h < HALVES - 1) {  // rank 128: lanes 0-63 again, tile-start values
      gather3<H, RANK>(sm, P, Q, pbase, qbase, T, su, q_off);
      __syncthreads();
    }
    // 5. scatter the users and the positives: one (side, sorted position,
    // column quad) per thread and step; only a run's first position writes
    for (int w = tid; w < 2 * MAX_T * HQ4; w += THREADS) {
      const int q = w % HQ4, rest = w / HQ4;
      if (rest < MAX_T)
        scatter_quad<H, RANK>(P, pbase, sm, 0, rest, q, q_off, lr, reg);
      else
        scatter_quad<H, RANK>(Q, qbase, sm, 1, rest - MAX_T, q, q_off, lr,
                                reg);
    }
    if (h == HALVES - 1 && warp == 0) {
      float part = 0.f;
      for (int s = lane; s < T; s += 32) part += sm.loss[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) *tile_loss = part;
    }
    __syncthreads();  // the positives' rows are in device memory now

    // 6. scatter the negatives on top of what step 5 wrote
    for (int w = tid; w < MAX_T * HQ4; w += THREADS)
      scatter_quad<H, RANK>(Q, qbase, sm, 2, w / HQ4, w % HQ4, q_off, lr,
                              reg);
    __syncthreads();
  }
}

// P and Q are rewritten by this and other blocks during the launch, so
// they are deliberately not const/__restrict__ and every row is loaded
// from L2 (see sweep_common.cuh).
template <int RANK>
__global__ void __launch_bounds__(THREADS)
bpr_sweep_kernel(float* P, float* Q, const int* __restrict__ sa,
                 const int* __restrict__ tc, const int* __restrict__ tl,
                 Wavefront wf, float* __restrict__ sums, int tpg, int T,
                 int su, int si, float lr, float reg) {
  extern __shared__ float4 smem_raw[];
  __shared__ int run_slot;
  const SweepSmem<HALF<RANK>> sm = SweepSmem<HALF<RANK>>::carve(smem_raw, T);

  for (int run = take_run(wf, &run_slot); run < wf.nruns;
       run = take_run(wf, &run_slot)) {
    const int t0 = wf.runs[2 * run], n = wf.runs[2 * run + 1];
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      load_ids(sm, tl + (long long)t * 3 * T, T, su);
      const bool ends_stratum = await_tile(wf, t);
      __syncthreads();
      update_tile<RANK>(sm, P, Q, (long long)sa[t / tpg] * su,
                        (long long)tc[t] * si, T, su, lr, reg, sums + t);
      publish(wf, ends_stratum, run, k + 1);
    }
  }
}

template <int RANK>
int launch(float* P, float* Q, const int* sa, const int* tc, const int* tl,
           const Wavefront& wf, float* sums, float* loss_out, int nt,
           int blocks, int tpg, int T, int su, int si, float lr, float reg,
           cudaStream_t stream) {
  const size_t smem = SweepSmem<HALF<RANK>>::bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      bpr_sweep_kernel<RANK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bpr_sweep_kernel<RANK><<<blocks, THREADS, smem, stream>>>(
      P, Q, sa, tc, tl, wf, sums, tpg, T, su, si, lr, reg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ordered_sum_kernel<<<1, SUM_THREADS, 0, stream>>>(sums, nt, loss_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Thread blocks of the rank's bpr_sweep_kernel the device holds at once at
// tile size T, or minus the CUDA error.
extern "C" int mfx_bpr_sweep_max_blocks(int T, int rank) {
  const int bad = -(int)cudaErrorInvalidValue;
  if (T < 1 || T > MAX_T) return bad;
  return with_rank(rank, bad, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return resident_blocks(bpr_sweep_kernel<R>, THREADS,
                           SweepSmem<HALF<R>>::bytes(T));
  });
}

extern "C" int mfx_bpr_sweep(float* P, float* Q, const int* sa, const int* tc,
                             const int* tl, const int* runs, const int* wait,
                             int* state, float* sums, float* loss_out, int nt,
                             int nruns, int blocks, int tpg, int T, int su,
                             int si, int rank, float lr, float reg,
                             void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (su > MAX_BLOCK || si > MAX_BLOCK || T < 1 || T > MAX_T || tpg < 1 ||
      nruns < 1 || blocks < 1)
    return bad;
  const Wavefront wf{runs, wait, state, nruns};
  return with_rank(rank, bad, [&](auto r) {
    return launch<decltype(r)::value>(P, Q, sa, tc, tl, wf, sums, loss_out,
                                      nt, blocks, tpg, T, su, si, lr, reg,
                                      (cudaStream_t)stream);
  });
}
