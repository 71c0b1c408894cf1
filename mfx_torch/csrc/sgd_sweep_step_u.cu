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
// Where the group's pooled user deltas live: in `acc`, a device-memory
// scratch of su*rank + su floats that the wrapper hands in zeroed (256 KB
// at su = 1024, rank 64: more than a block's shared memory, and resident
// in L2). The group-start snapshot needs no copy: P and bu are not
// written before the group ends, so each tile reads them in place. Rows
// touched in a group are listed in shared memory (a flag a row, an
// integer counter), so the group's end visits only those, adds their sums
// to P and bu, and zeroes them again. The list's order varies from run to
// run and changes nothing: each row's update is independent.
//
// What bounds it on an H100: one SM's latency, as the other sweeps. On
// the TPU the batching saved matmuls; here a tile costs what it costs in
// sgd_sweep_tile.cu, plus a read-modify-write of the pooled rows in L2
// instead of a store to P, plus the group's end (one more pass over the
// touched rows and one more barrier a group).

#include "sweep_common.cuh"

namespace {

using namespace mfx_sweep;

constexpr size_t GROUP_SMEM = (size_t)(2 * MAX_BLOCK + 1) * sizeof(int);

template <int RANK>
__global__ void __launch_bounds__(THREADS)
sgd_sweep_step_u_kernel(float* P, float* Q, float* bu, float* bi, float* acc,
                        const int* __restrict__ sa,
                        const int* __restrict__ tc,
                        const int* __restrict__ tl,
                        float* __restrict__ sse_out, int nt, int tpg, int T,
                        int su, int si, int use_bias, float lr, float reg,
                        float mu) {
  constexpr int Q4 = RANK / 4;
  extern __shared__ float4 smem_raw[];
  const TileSmem<RANK> sm = TileSmem<RANK>::carve(smem_raw, T);
  int* flag = reinterpret_cast<int*>(reinterpret_cast<char*>(smem_raw) +
                                     TileSmem<RANK>::bytes(T));  // (MAX_BLOCK,)
  int* list = flag + MAX_BLOCK;  // rows touched in this group, any order
  int* cnt = list + MAX_BLOCK;   // their number
  float4* P4w = reinterpret_cast<float4*>(P);
  float4* acc4 = reinterpret_cast<float4*>(acc);  // (su, Q4) pooled row sums
  float* accB = acc + (size_t)su * RANK;          // (su,) pooled bias sums
  const int tid = threadIdx.x;
  float sse = 0.f;  // thread 0 carries the sweep's sum

  for (int x = tid; x < MAX_BLOCK; x += THREADS) flag[x] = 0;
  if (tid == 0) *cnt = 0;

  for (int g = 0; g < nt / tpg; ++g) {
    const long long pbase = (long long)sa[g] * su;
    for (int j = 0; j < tpg; ++j) {
      const int t = g * tpg + j;
      const long long qbase = (long long)tc[t] * si;
      load_ids(sm, tl + (long long)t * 3 * T, T, su);
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
      sse += tile_sse(sm, T);
      __syncthreads();
    }

    // the group's end: start + pooled sum for every touched row
    const int n = *cnt;
    for (int w = tid; w < n * Q4; w += THREADS) {
      const int x = list[w / Q4], q = w % Q4;
      P4w[(pbase + x) * Q4 + q] =
          add4(P4w[(pbase + x) * Q4 + q], acc4[x * Q4 + q]);
      acc4[x * Q4 + q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int w = tid; w < n; w += THREADS) {
      const int x = list[w];
      if (use_bias) {
        bu[pbase + x] += accB[x];
        accB[x] = 0.f;
      }
      flag[x] = 0;
    }
    __syncthreads();
    if (tid == 0) *cnt = 0;  // next read or bumped several barriers later
  }
  if (tid == 0) sse_out[0] = sse;
}

template <int RANK>
int launch(float* P, float* Q, float* bu, float* bi, float* acc,
           const int* sa, const int* tc, const int* tl, float* sse_out,
           int nt, int tpg, int T, int su, int si, int use_bias, float lr,
           float reg, float mu, cudaStream_t stream) {
  const size_t smem = TileSmem<RANK>::bytes(T) + GROUP_SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      sgd_sweep_step_u_kernel<RANK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgd_sweep_step_u_kernel<RANK><<<1, THREADS, smem, stream>>>(
      P, Q, bu, bi, acc, sa, tc, tl, sse_out, nt, tpg, T, su, si, use_bias,
      lr, reg, mu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mfx_sgd_sweep_step_u(float* P, float* Q, float* bu, float* bi,
                                    float* acc, const int* sa, const int* tc,
                                    const int* tl, float* sse_out, int nt,
                                    int tpg, int T, int su, int si, int rank,
                                    int use_bias, float lr, float reg,
                                    float mu, void* stream) {
  if (su > MAX_BLOCK || si > MAX_BLOCK || T < 1 || T > MAX_T || tpg < 1 ||
      tpg > 8 || nt % tpg)
    return (int)cudaErrorInvalidValue;
  if (rank == 64)
    return launch<64>(P, Q, bu, bi, acc, sa, tc, tl, sse_out, nt, tpg, T, su,
                      si, use_bias, lr, reg, mu, (cudaStream_t)stream);
  if (rank == 32)
    return launch<32>(P, Q, bu, bi, acc, sa, tc, tl, sse_out, nt, tpg, T, su,
                      si, use_bias, lr, reg, mu, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
