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
// Order: tiles apply strictly in plan order, as the TPU's sequential grid
// does. One thread block walks the whole sweep; that loop takes the place
// of the sequential grid dimension, and every sum is taken in a fixed
// order (sweep_common.cuh states it; the bias terms of that header are 0
// here), so a run is bitwise repeatable. No float atomics.
//
// What bounds it on an H100: one SM does all the work, so the sweep is
// bound by one SM's latency: each tile's phases (ids, gather, duplicate
// search, residuals, scatter) are separated by barriers, and the gather
// of 2*T*rank*4 bytes (128 KB at T=256) waits on L2/HBM. The design keeps
// the tile's snapshot in shared memory (the >48 KB dynamic opt-in),
// issues every phase from all 512 threads with 16-byte accesses (16
// threads per 256-byte row, all of a thread's gather loads in flight at
// once), and groups duplicate rows with a bitonic sort of (row, slot)
// keys in shared memory, so each row's deltas sit next to each other in
// slot order and no thread scans the tile. Running independent strata on
// the other SMs (the DSGD parallel mode) is the next step and changes
// the update order.

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

// P and Q are read and written by this block between barriers, so they
// are deliberately not const/__restrict__ (see sweep_common.cuh).
__global__ void __launch_bounds__(THREADS)
sgd_sweep_kernel(float* P, float* Q, const int* __restrict__ sa,
                 const int* __restrict__ tc, const int* __restrict__ tl,
                 float* __restrict__ sse_out, int nt, int tpg, int T, int su,
                 int si, float lr, float reg, float mu) {
  extern __shared__ float4 smem_raw[];
  const TileSmem<RANK> sm = TileSmem<RANK>::carve(smem_raw, T);
  float sse = 0.f;  // thread 0 carries the sweep's sum

  for (int t = 0; t < nt; ++t) {
    const long long pbase = (long long)sa[t / tpg] * su;
    const long long qbase = (long long)tc[t] * si;
    load_ids(sm, tl + (long long)t * 3 * T, T, su);
    __syncthreads();
    gather(sm, P, Q, nullptr, nullptr, pbase, qbase, T, su, /*use_bias=*/0);
    sort_keys(sm.keyU, sm.keyI);
    residuals(sm, T, su, mu, /*use_bias=*/0);
    __syncthreads();

    // 5. scatter: one (side, sorted position, column quad) per thread and
    // step; only the first position of each row's run writes
    for (int w = threadIdx.x; w < 2 * MAX_T * Q4; w += THREADS) {
      const int q = w % Q4, rest = w / Q4;
      if (rest < MAX_T)
        scatter_quad(P, pbase, sm.keyU, sm.Ps, sm.Qs, sm.e, rest, q,
                     RANK - 2, lr, reg);
      else
        scatter_quad(Q, qbase, sm.keyI, sm.Qs, sm.Ps, sm.e, rest - MAX_T, q,
                     RANK - 1, lr, reg);
    }
    sse += tile_sse(sm, T);
    __syncthreads();
  }
  if (threadIdx.x == 0) sse_out[0] = sse;
}

}  // namespace

extern "C" int mfx_sgd_sweep(float* P, float* Q, const int* sa, const int* tc,
                             const int* tl, float* sse_out, int nt, int tpg,
                             int T, int su, int si, int rank, float lr,
                             float reg, float mu, void* stream) {
  if (rank != RANK || su > MAX_BLOCK || si > MAX_BLOCK || T < 1 ||
      T > MAX_T || tpg < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = TileSmem<RANK>::bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      sgd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgd_sweep_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      P, Q, sa, tc, tl, sse_out, nt, tpg, T, su, si, lr, reg, mu);
  return (int)cudaGetLastError();
}
