// Sparse blocked-SGD sweep (lane-carried biases, rank 64).
//
// Replaces: mfx/kernels/sgd_pallas.py::_kernel_body (bias_mode='lane',
// pack_path='roll'), driven by blocked_sgd_sweep_pallas / _sweep_chunk_call.
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

constexpr int RANK = 64;
constexpr int Q4 = RANK / 4;  // float4 per row

// a with column `frozen` of the row zeroed, if it lies in quad q
__device__ inline float4 freeze(float4 a, int frozen, int q) {
  const int c = frozen - 4 * q;
  if (c == 0) a.x = 0.f;
  if (c == 1) a.y = 0.f;
  if (c == 2) a.z = 0.f;
  if (c == 3) a.w = 0.f;
  return a;
}

// Column quad q of the row at sorted position p on one side (P or Q). If
// p starts its row's run of equal keys, write snapshot + the run's summed
// deltas, the side's constant-1 lane left as it was.
__device__ inline void scatter_quad(
    float* table, long long base, const int* key, const float4* own,
    const float4* other, const float* e, int p, int q, int frozen, float lr,
    float reg) {
  if (!starts_run(key, p)) return;
  const int x = key[p] >> 8, j0 = key[p] & 255;
  reinterpret_cast<float4*>(table)[(base + x) * Q4 + q] = add4(
      own[j0 * Q4 + q],
      freeze(run_delta<Q4>(key, own, other, e, p, q, lr, reg), frozen, q));
}

// P and Q are rewritten by this and other blocks during the launch, so
// they are deliberately not const/__restrict__ and every row is loaded
// from L2 (see sweep_common.cuh).
__global__ void __launch_bounds__(THREADS)
sgd_sweep_kernel(float* P, float* Q, const int* __restrict__ sa,
                 const int* __restrict__ tc, const int* __restrict__ tl,
                 Wavefront wf, float* __restrict__ sums, int tpg, int T,
                 int su, int si, float lr, float reg, float mu) {
  extern __shared__ float4 smem_raw[];
  __shared__ int run_slot;
  const TileSmem<RANK> sm = TileSmem<RANK>::carve(smem_raw, T);

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
      gather(sm, P, Q, nullptr, nullptr, pbase, qbase, T, su,
             /*use_bias=*/0);
      sort_keys(sm.keyU, sm.keyI);
      residuals(sm, T, su, mu, /*use_bias=*/0);
      __syncthreads();

      // 5. scatter: one (side, sorted position, column quad) per thread
      // and step; only the first position of each row's run writes
      for (int w = threadIdx.x; w < 2 * MAX_T * Q4; w += THREADS) {
        const int q = w % Q4, rest = w / Q4;
        if (rest < MAX_T)
          scatter_quad(P, pbase, sm.keyU, sm.Ps, sm.Qs, sm.e, rest, q,
                       RANK - 2, lr, reg);
        else
          scatter_quad(Q, qbase, sm.keyI, sm.Qs, sm.Ps, sm.e, rest - MAX_T,
                       q, RANK - 1, lr, reg);
      }
      const float sse = tile_sse(sm, T);
      if (threadIdx.x == 0) sums[t] = sse;
      __syncthreads();
      publish(wf, ends_stratum, run, k + 1);
    }
  }
}

}  // namespace

// Thread blocks of sgd_sweep_kernel the device holds at once at tile size
// T, or minus the CUDA error.
extern "C" int mfx_sgd_sweep_max_blocks(int T) {
  if (T < 1 || T > MAX_T) return -(int)cudaErrorInvalidValue;
  return resident_blocks(sgd_sweep_kernel, THREADS, TileSmem<RANK>::bytes(T));
}

extern "C" int mfx_sgd_sweep(float* P, float* Q, const int* sa, const int* tc,
                             const int* tl, const int* runs, const int* wait,
                             int* state, float* sums, float* sse_out, int nt,
                             int nruns, int blocks, int tpg, int T, int su,
                             int si, int rank, float lr, float reg, float mu,
                             void* stream) {
  if (rank != RANK || su > MAX_BLOCK || si > MAX_BLOCK || T < 1 ||
      T > MAX_T || tpg < 1 || nruns < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = TileSmem<RANK>::bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      sgd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Wavefront wf{runs, wait, state, nruns};
  sgd_sweep_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      P, Q, sa, tc, tl, wf, sums, tpg, T, su, si, lr, reg, mu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ordered_sum_kernel<<<1, SUM_THREADS, 0, (cudaStream_t)stream>>>(
      sums, nt, sse_out);
  return (int)cudaGetLastError();
}
