// Sparse blocked-SGD sweep (lane-carried biases, ranks 64 and 128).
//
// Replaces: mfx/kernels/sgd_pallas.py::_kernel_body (bias_mode='lane',
// pack_path='roll' at rank 64, pack 1 at rank 128), driven by
// blocked_sgd_sweep_pallas / _sweep_chunk_call.
//
// What it computes, per tile of T ratings of one stratum (user block sa,
// item window tc), in plan order:
//   snapshot  p_s = P[sa*su + u_s], q_s = Q[tc*si + i_s]   (gather first)
//   e_s       = r_s - (sum_k p_s[k] q_s[k] + mu)
//   dP_s      = lr (e_s q_s - reg p_s), lane rank-2 frozen (P's constant 1)
//   dQ_s      = lr (e_s p_s - reg q_s), lane rank-1 frozen (Q's constant 1)
//   row       = snapshot + sum of the deltas of every slot with that row,
//               summed in slot order (the reference's exact segment sum)
//   sse      += sum_s e_s^2 over real slots (pad slots hold u == su)
//
// Order: the result is that of applying the tiles strictly in plan order,
// as the TPU's sequential grid does. The launch's blocks share the sweep
// by sweep_common.cuh's wavefront scheduler: each takes whole user-block
// runs in plan order and walks a run front to back, and a stratum's first
// tile waits for the nearest earlier run's tiles of the same item window.
// A tile touches only its user block's P rows and its window's Q rows, so
// those two orders fix every value a tile gathers: the tables are bit for
// bit the one-block walk's, on any number of blocks, and a grid of one
// block is that walk. Every sum inside a tile is taken in a fixed order
// (sweep_common.cuh states it; the bias terms of that header are 0 here),
// and the per-tile SSE goes to a buffer that a second small kernel adds up
// in tile order, so the scalar is the one-block walk's too. No float
// atomics; the scheduler uses an integer ticket and integer counts.
//
// Memory ordering: P and Q rows written on one SM are gathered on another
// inside the launch, so every table load bypasses L1 and a run's progress
// is published only after a barrier and a fence (sweep_common.cuh).
//
// Rank 128. A tile's two snapshots at T = 256 are 256 KB, more than the
// 227 KB of shared memory a block may have, and T is part of the math (a
// tile is one snapshot minibatch), so it is not cut. A residual needs the
// whole 128-lane dot, but the step of lane k of a slot needs only e_s,
// p_s[k] and q_s[k]. So shared memory holds 64 lanes of each row at a
// time (the rank-64 buffers, 138 KB at T = 256): gather lanes 0-63 and
// take each thread's part of the dots, gather lanes 64-127 and carry the
// same fma chains on (k, k + 8, k + 16, k + 24: the order a 128-lane
// buffer would give), finish the residuals, update and scatter lanes
// 64-127, then gather lanes 0-63 again and update and scatter them. The
// second gather still reads the tile-start values: the upper scatter does
// not touch lanes 0-63, and under the wavefront no other block writes the
// tile's rows while it runs. One sort of the slot ids serves both halves.
// The rank-64 instance takes the one-half path: one gather, one scatter.
//
// What bounds it on an H100: a tile's time is one SM's latency: its phases
// (ids, gather, duplicate search, residuals, scatter) are separated by
// barriers, and the gather of 2*T*rank*4 bytes (128 KB at T=256) waits on
// L2. The design keeps the tile's snapshot in shared memory (the >48 KB
// dynamic opt-in, one block an SM at T=256), runs every phase on all
// 512 threads with 16-byte accesses (16 threads per 256-byte row, all of a
// thread's gather loads in flight at once), and groups duplicate rows
// with a bitonic sort of (row, slot) keys in shared memory, so each row's
// deltas sit next to each other in slot order and no thread scans the
// tile. A sweep's time is then the longest dependency chain's tiles (a
// sweep of W windows keeps at most W blocks busy; the heaviest window's
// tiles all follow one another) plus the wavefront's ramp.

#include "sweep_common.cuh"

namespace {

using namespace mfx_sweep;

constexpr int HALF = 64;        // lanes of a row in shared memory at once
constexpr int HQ4 = HALF / 4;   // float4 of a row in shared memory

// a with column `frozen` of the row zeroed, if it lies in quad q
__device__ inline float4 freeze(float4 a, int frozen, int q) {
  const int c = frozen - 4 * q;
  if (c == 0) a.x = 0.f;
  if (c == 1) a.y = 0.f;
  if (c == 2) a.z = 0.f;
  if (c == 3) a.w = 0.f;
  return a;
}

// Column quad q of the shared half (the row's quad q_off + q) of the row
// at sorted position p on one side (P or Q). If p starts its row's run of
// equal keys, write snapshot + the run's summed deltas, the side's
// constant-1 lane left as it was.
template <int ROW_Q4>
__device__ inline void scatter_quad(
    float* table, long long base, const int* key, const float4* own,
    const float4* other, const float* e, int p, int q, int q_off, int frozen,
    float lr, float reg) {
  if (!starts_run(key, p)) return;
  const int x = key[p] >> 8, j0 = key[p] & 255;
  reinterpret_cast<float4*>(table)[(base + x) * ROW_Q4 + q_off + q] = add4(
      own[j0 * HQ4 + q],
      freeze(run_delta<HQ4>(key, own, other, e, p, q, lr, reg), frozen,
             q_off + q));
}

// 5. scatter of the lanes in shared memory: one (side, sorted position,
// column quad) per thread and step; only the first position of each row's
// run writes
template <int RANK>
__device__ inline void scatter_half(const TileSmem<HALF>& sm, float* P,
                                    float* Q, long long pbase,
                                    long long qbase, int q_off, float lr,
                                    float reg) {
  for (int w = threadIdx.x; w < 2 * MAX_T * HQ4; w += THREADS) {
    const int q = w % HQ4, rest = w / HQ4;
    if (rest < MAX_T)
      scatter_quad<RANK / 4>(P, pbase, sm.keyU, sm.Ps, sm.Qs, sm.e, rest, q,
                             q_off, RANK - 2, lr, reg);
    else
      scatter_quad<RANK / 4>(Q, qbase, sm.keyI, sm.Qs, sm.Ps, sm.e,
                             rest - MAX_T, q, q_off, RANK - 1, lr, reg);
  }
}

// P and Q are rewritten by this and other blocks during the launch, so
// they are deliberately not const/__restrict__ and every row is loaded
// from L2 (see sweep_common.cuh).
template <int RANK>
__global__ void __launch_bounds__(THREADS)
sgd_sweep_kernel(float* P, float* Q, const int* __restrict__ sa,
                 const int* __restrict__ tc, const int* __restrict__ tl,
                 Wavefront wf, float* __restrict__ sums, int tpg, int T,
                 int su, int si, float lr, float reg, float mu) {
  constexpr int ROW_Q4 = RANK / 4, HALVES = RANK / HALF;
  extern __shared__ float4 smem_raw[];
  __shared__ int run_slot;
  const TileSmem<HALF> sm = TileSmem<HALF>::carve(smem_raw, T);

  for (int run = take_run(wf, &run_slot); run < wf.nruns;
       run = take_run(wf, &run_slot)) {
    const int t0 = wf.runs[2 * run], n = wf.runs[2 * run + 1];
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      const long long pbase = (long long)sa[t / tpg] * su;
      const long long qbase = (long long)tc[t] * si;
      load_ids(sm, tl + (long long)t * 3 * T, T, su);
      const bool ends_stratum = await_tile(wf, t);
      __syncthreads();
      gather<HALF, ROW_Q4>(sm, P, Q, nullptr, nullptr, pbase, qbase, T, su,
                           /*use_bias=*/0);
      sort_keys(sm.keyU, sm.keyI);
      float v[DOT_SLOTS] = {};
      dot_part(sm, T, v);
#pragma unroll
      for (int h = 1; h < HALVES; ++h) {  // rank 128: lanes 64-127
        __syncthreads();
        gather<HALF, ROW_Q4>(sm, P, Q, nullptr, nullptr, pbase, qbase, T,
                             su, /*use_bias=*/0, h * HQ4);
        __syncthreads();
        dot_part(sm, T, v);
      }
      finish_residuals(sm.e, sm.uid, sm.bus, sm.bis, T, su, mu,
                       /*use_bias=*/0, v);
      __syncthreads();

      // 5. scatter the half in shared memory; at rank 128 then gather
      // lanes 0-63 again (still the tile-start values) and scatter them
      scatter_half<RANK>(sm, P, Q, pbase, qbase, (HALVES - 1) * HQ4, lr,
                         reg);
      if (HALVES > 1) {
        __syncthreads();
        gather<HALF, ROW_Q4>(sm, P, Q, nullptr, nullptr, pbase, qbase, T,
                             su, /*use_bias=*/0);
        __syncthreads();
        scatter_half<RANK>(sm, P, Q, pbase, qbase, 0, lr, reg);
      }
      const float sse = tile_sse(sm, T);
      if (threadIdx.x == 0) sums[t] = sse;
      __syncthreads();
      publish(wf, ends_stratum, run, k + 1);
    }
  }
}

template <int RANK>
int launch(float* P, float* Q, const int* sa, const int* tc, const int* tl,
           const Wavefront& wf, float* sums, float* sse_out, int nt,
           int blocks, int tpg, int T, int su, int si, float lr, float reg,
           float mu, cudaStream_t stream) {
  const size_t smem = TileSmem<HALF>::bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      sgd_sweep_kernel<RANK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgd_sweep_kernel<RANK><<<blocks, THREADS, smem, stream>>>(
      P, Q, sa, tc, tl, wf, sums, tpg, T, su, si, lr, reg, mu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ordered_sum_kernel<<<1, SUM_THREADS, 0, stream>>>(sums, nt, sse_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Thread blocks of the rank's sgd_sweep_kernel the device holds at once at
// tile size T, or minus the CUDA error.
extern "C" int mfx_sgd_sweep_max_blocks(int T, int rank) {
  if (T < 1 || T > MAX_T) return -(int)cudaErrorInvalidValue;
  const size_t smem = TileSmem<HALF>::bytes(T);
  if (rank == 64) return resident_blocks(sgd_sweep_kernel<64>, THREADS, smem);
  if (rank == 128)
    return resident_blocks(sgd_sweep_kernel<128>, THREADS, smem);
  return -(int)cudaErrorInvalidValue;
}

extern "C" int mfx_sgd_sweep(float* P, float* Q, const int* sa, const int* tc,
                             const int* tl, const int* runs, const int* wait,
                             int* state, float* sums, float* sse_out, int nt,
                             int nruns, int blocks, int tpg, int T, int su,
                             int si, int rank, float lr, float reg, float mu,
                             void* stream) {
  if (su > MAX_BLOCK || si > MAX_BLOCK || T < 1 || T > MAX_T || tpg < 1 ||
      nruns < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Wavefront wf{runs, wait, state, nruns};
  if (rank == 64)
    return launch<64>(P, Q, sa, tc, tl, wf, sums, sse_out, nt, blocks, tpg,
                      T, su, si, lr, reg, mu, (cudaStream_t)stream);
  if (rank == 128)
    return launch<128>(P, Q, sa, tc, tl, wf, sums, sse_out, nt, blocks, tpg,
                       T, su, si, lr, reg, mu, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
