// Sparse blocked-SGD sweep with the user side batched over each group of
// tpg tiles (sgd.step_user_batch), per-tile biases or none, ranks 32, 64.
//
// Replaces: mfx/kernels/sgd_pallas.py::_kernel_body_step_u (:363), driven
// by blocked_sgd_sweep_pallas / _sweep_chunk_call with step_u=True.
//
// What it computes. The tiles of a group share one user block sa[g]. For
// each group, on plain (rows, rank) tables P, Q and bias vectors bu, bi:
//   - every tile j of the group, in order, gathers its user rows p_s and
//     user biases bu_s from the state at the group's start, and its item
//     rows q_s and item biases bi_s as tiles 0..j-1 of the group left them;
//   - e_s = r_s - (((sum_k p_s[k] q_s[k] + mu) + bu_s) + bi_s);
//   - the tile's item side is applied at once, as in sgd_sweep_tile.cu:
//     Q row, bi = snapshot + sum of lr (e_s p_s - reg q_s), lr (e_s - reg
//     bi_s) over the tile's slots with that row;
//   - the user side of all tpg*T slots is one minibatch: the deltas
//     lr (e_s q_s - reg p_s) and lr (e_s - reg bu_s) are summed per row
//     over the whole group and added to P and bu once, at the group's end;
//   - sse += sum_s e_s^2 over real slots. Pad slots (u == su) and whole
//     pad tiles touch nothing.
// With use_bias == 0 the bias terms are 0 and bu, bi are left untouched.
// tpg is part of the math here: it sets the user-side batch.
//
// Order of every sum (a run is bitwise repeatable; no float atomics):
// dot and pred as sweep_common.cuh states. A user row's group sum is
// ((s_0 + s_1) + ...) over the group's tiles in order, where s_j is the
// sum of tile j's deltas of that row in ascending slot order; the row
// becomes start + group sum. The reference adds one sum over all tpg*T
// slots: a different association of the same f32 terms.
//
// Order between tiles: the wavefront of sweep_common.cuh, as in
// sgd_sweep_tile.cu. Blocks take whole user-block runs by ticket and walk
// each front to back; a stratum's first tile waits for the (run, count)
// of the plan's dependency table. The item side is written tile by tile,
// as in the per-tile body, so the item-side waits are the same table's;
// the user side of a block is written only by its run. The planner pads
// every run to a multiple of tpg tiles, so a group never straddles two
// runs (it may straddle two strata of one run: P and bu are not read by
// any other run, and the group's end is followed by the next tile's
// barrier). Every tile therefore sees what the one-block, plan-order walk
// shows it, and the tables come out bit for bit the same on any grid. The
// per-tile SSE goes to sums[t]; ordered_sum_kernel adds them in tile
// order, the association of one thread carrying the sum in plan order.
//
// Where a group's pooled user deltas live: one pool of su*rank + su floats
// per block in flight, zero between groups. In shared memory where it
// fits beside the tile's buffers (SMEM_POOL: 67.6 KB at su = 512, rank
// 32); otherwise in device memory, blocks x pool floats that the wrapper
// hands in zeroed (266 KB a block at su = 1024, rank 64, resident in L2).
// smem_pool() below is the one place that decides. Both add the same
// terms in the same order; where both fit, shared memory was the faster
// on an H100 (the ML-1M sweep 31.3 against 32.1 ms on 12 blocks). The
// group-start snapshot needs no copy: P and bu are not written before the
// group ends, so each tile reads them in place. Rows touched in a group
// are listed in shared memory (a flag a row, an integer counter), so the
// group's end visits only those, adds their sums to P and bu, and zeroes
// them again; a pool is thus zero whenever its block takes a run. The list's order varies
// from run to run and changes nothing: each row's update is independent.
//
// What bounds it on an H100: as the other sweeps, a tile's latency on one
// SM (phases separated by barriers, the gather waiting on L2), times the
// tiles on the sweep's longest dependency chain. Beside the per-tile
// body a tile adds the pooled read-modify-write and, at each group's end,
// one pass over the touched rows and one barrier.

#include "sweep_common.cuh"

namespace {

using namespace mfx_sweep;

// flag (MAX_BLOCK), list (MAX_BLOCK), cnt, padded to a float4
constexpr size_t GROUP_SMEM = (size_t)(2 * MAX_BLOCK + 4) * sizeof(int);

__host__ __device__ inline size_t pool_floats(int su, int rank) {
  return (size_t)su * (rank + 1);
}

// Byte offsets in dynamic shared memory: the tile's buffers, the group's
// row list at a 16-byte boundary, then (SMEM_POOL) the pool.
template <int RANK>
__host__ __device__ inline size_t group_offset(int T) {
  return (TileSmem<RANK>::bytes(T) + 15) & ~(size_t)15;
}

template <int RANK>
size_t smem_bytes(int T, int su, bool smem_pool) {
  return group_offset<RANK>(T) + GROUP_SMEM +
         (smem_pool ? pool_floats(su, RANK) * sizeof(float) : 0);
}

// P, Q, bu and bi are rewritten by this and other blocks during the
// launch, so they are deliberately not const/__restrict__.
template <int RANK, bool SMEM_POOL>
__global__ void __launch_bounds__(THREADS)
sgd_sweep_step_u_kernel(float* P, float* Q, float* bu, float* bi,
                        float* pools, const int* __restrict__ sa,
                        const int* __restrict__ tc,
                        const int* __restrict__ tl, Wavefront wf,
                        float* __restrict__ sums, int tpg, int T, int su,
                        int si, int use_bias, float lr, float reg, float mu) {
  constexpr int Q4 = RANK / 4;
  extern __shared__ float4 smem_raw[];
  __shared__ int run_slot;
  const TileSmem<RANK> sm = TileSmem<RANK>::carve(smem_raw, T);
  char* group = reinterpret_cast<char*>(smem_raw) + group_offset<RANK>(T);
  int* flag = reinterpret_cast<int*>(group);  // (MAX_BLOCK,)
  int* list = flag + MAX_BLOCK;  // rows touched in this group, any order
  int* cnt = list + MAX_BLOCK;   // their number
  float* acc = SMEM_POOL ? reinterpret_cast<float*>(group + GROUP_SMEM)
                         : pools + blockIdx.x * pool_floats(su, RANK);
  float4* acc4 = reinterpret_cast<float4*>(acc);  // (su, Q4) pooled row sums
  float* accB = acc + (size_t)su * RANK;          // (su,) pooled bias sums
  float4* P4w = reinterpret_cast<float4*>(P);
  const int tid = threadIdx.x;

  for (int x = tid; x < MAX_BLOCK; x += THREADS) flag[x] = 0;
  if (SMEM_POOL)
    for (int x = tid; x < (int)pool_floats(su, RANK); x += THREADS)
      acc[x] = 0.f;
  if (tid == 0) *cnt = 0;

  // take_run begins with a barrier: the zeroing above is seen by all
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
      // P and bu still hold the group's start: nothing wrote them since
      gather(sm, P, Q, bu, bi, pbase, qbase, T, su, use_bias);
      sort_keys(sm.keyU, sm.keyI);
      residuals(sm, T, su, mu, use_bias);
      __syncthreads();

      // 5a. user side: the tile's row sums go into the group's pool
      for (int w = tid; w < MAX_T * Q4; w += THREADS) {
        const int q = w % Q4, p = w / Q4;
        if (!starts_run(sm.keyU, p)) continue;
        const int x = sm.keyU[p] >> 8;
        acc4[x * Q4 + q] =
            add4(acc4[x * Q4 + q],
                 run_delta<Q4>(sm.keyU, sm.Ps, sm.Qs, sm.e, p, q, lr, reg));
        if (q == 0 && !flag[x]) {  // one thread a row and tile
          flag[x] = 1;
          list[atomicAdd(cnt, 1)] = x;
        }
      }
      static_assert(THREADS == 2 * MAX_T, "one bias writer a sorted position");
      const int pb = tid - MAX_T;
      if (use_bias && pb >= 0 && starts_run(sm.keyU, pb)) {
        const int x = sm.keyU[pb] >> 8;
        accB[x] += run_bias_delta(sm.keyU, sm.bus, sm.e, pb, lr, reg);
      }
      // 5b. item side: applied now, the next tile of the group reads it
      scatter_items(sm, Q, bi, qbase, use_bias, lr, reg);
      const float sse = tile_sse(sm, T);
      if (tid == 0) sums[t] = sse;
      __syncthreads();
      publish(wf, ends_stratum, run, k + 1);
      if ((t + 1) % tpg) continue;

      // the group's end: start + pooled sum for every touched row
      const int nrows = *cnt;
      for (int w = tid; w < nrows * Q4; w += THREADS) {
        const int x = list[w / Q4], q = w % Q4;
        const long long o = (pbase + x) * Q4 + q;
        P4w[o] = add4(ld_row(P4w + o), acc4[x * Q4 + q]);
        acc4[x * Q4 + q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int w = tid; w < nrows; w += THREADS) {
        const int x = list[w];
        if (use_bias) {
          bu[pbase + x] = ld_row(bu + pbase + x) + accB[x];
          accB[x] = 0.f;
        }
        flag[x] = 0;
      }
      __syncthreads();
      if (tid == 0) *cnt = 0;  // next read or bumped several barriers later
    }
  }
}

template <int RANK, bool SMEM_POOL>
int launch(float* P, float* Q, float* bu, float* bi, float* pools,
           const int* sa, const int* tc, const int* tl, const Wavefront& wf,
           float* sums, float* sse_out, int nt, int blocks, int tpg, int T,
           int su, int si, int use_bias, float lr, float reg, float mu,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<RANK>(T, su, SMEM_POOL);
  cudaError_t err = cudaFuncSetAttribute(
      sgd_sweep_step_u_kernel<RANK, SMEM_POOL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgd_sweep_step_u_kernel<RANK, SMEM_POOL>
      <<<blocks, THREADS, smem, stream>>>(P, Q, bu, bi, pools, sa, tc, tl,
                                          wf, sums, tpg, T, su, si,
                                          use_bias, lr, reg, mu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ordered_sum_kernel<<<1, SUM_THREADS, 0, stream>>>(sums, nt, sse_out);
  return (int)cudaGetLastError();
}

// The largest dynamic shared memory a block may take on this device.
size_t smem_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return (size_t)optin;
}

// The placement of the pools, decided here only: in shared memory where a
// pool fits beside the tile's buffers, else in device memory.
template <int RANK>
bool smem_pool(int T, int su) {
  return smem_bytes<RANK>(T, su, true) <= smem_limit();
}

template <int RANK>
int max_blocks(int T, int su) {
  const bool shared = smem_pool<RANK>(T, su);
  return shared ? resident_blocks(sgd_sweep_step_u_kernel<RANK, true>,
                                  THREADS, smem_bytes<RANK>(T, su, true))
                : resident_blocks(sgd_sweep_step_u_kernel<RANK, false>,
                                  THREADS, smem_bytes<RANK>(T, su, false));
}

bool shape_ok(int T, int rank, int su) {
  return T >= 1 && T <= MAX_T && su >= 1 && su <= MAX_BLOCK &&
         (rank == 32 || rank == 64);
}

}  // namespace

// Thread blocks of the kernel the device holds at once at tile size T,
// rank and user block su, for the pools' placement the launch will use;
// minus the CUDA error if a call fails.
extern "C" int mfx_sgd_sweep_step_u_max_blocks(int T, int rank, int su) {
  if (!shape_ok(T, rank, su)) return -(int)cudaErrorInvalidValue;
  return rank == 64 ? max_blocks<64>(T, su) : max_blocks<32>(T, su);
}

// Floats of device memory each block's pool takes at these shapes: 0 where
// the pools live in shared memory, else su * (rank + 1); minus the CUDA
// error for shapes the kernel does not take.
extern "C" int mfx_sgd_sweep_step_u_pool_floats(int T, int rank, int su) {
  if (!shape_ok(T, rank, su)) return -(int)cudaErrorInvalidValue;
  const bool shared =
      rank == 64 ? smem_pool<64>(T, su) : smem_pool<32>(T, su);
  return shared ? 0 : (int)pool_floats(su, rank);
}

// pools: blocks * mfx_sgd_sweep_step_u_pool_floats(T, rank, su) zeroed
// floats, null where that is 0.
extern "C" int mfx_sgd_sweep_step_u(float* P, float* Q, float* bu, float* bi,
                                    float* pools, const int* sa,
                                    const int* tc, const int* tl,
                                    const int* runs, const int* wait,
                                    int* state, float* sums, float* sse_out,
                                    int nt, int nruns, int blocks, int tpg,
                                    int T, int su, int si, int rank,
                                    int use_bias, float lr, float reg,
                                    float mu, void* stream) {
  if (!shape_ok(T, rank, su) || si > MAX_BLOCK || tpg < 1 || tpg > 8 ||
      nt % tpg || nruns < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const bool shared =
      rank == 64 ? smem_pool<64>(T, su) : smem_pool<32>(T, su);
  if ((pools == nullptr) != shared) return (int)cudaErrorInvalidValue;
  const Wavefront wf{runs, wait, state, nruns};
  cudaStream_t st = (cudaStream_t)stream;
#define MFX_STEP_U_CASE(R)                                                  \
  if (rank == R)                                                            \
    return shared                                                           \
               ? launch<R, true>(P, Q, bu, bi, pools, sa, tc, tl, wf, sums, \
                                 sse_out, nt, blocks, tpg, T, su, si,       \
                                 use_bias, lr, reg, mu, st)                 \
               : launch<R, false>(P, Q, bu, bi, pools, sa, tc, tl, wf,      \
                                  sums, sse_out, nt, blocks, tpg, T, su,    \
                                  si, use_bias, lr, reg, mu, st);
  MFX_STEP_U_CASE(64)
  MFX_STEP_U_CASE(32)
#undef MFX_STEP_U_CASE
  return (int)cudaErrorInvalidValue;
}
