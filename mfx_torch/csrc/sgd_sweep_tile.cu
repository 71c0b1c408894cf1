// Sparse blocked-SGD sweep with per-tile biases (or none), ranks 32 and 64.
//
// Replaces: mfx/kernels/sgd_pallas.py::_kernel_body with bias_mode='tile'
// (its tile_bias branches) or use_bias=False, driven by
// blocked_sgd_sweep_pallas / _sweep_chunk_call.
//
// What it computes, per tile of T ratings of one stratum (user block sa,
// item window tc), in plan order, on plain (rows, rank) tables P, Q and
// the bias vectors bu, bi beside them:
//   snapshot  p_s = P[sa*su + u_s], q_s = Q[tc*si + i_s],
//             bu_s = bu[sa*su + u_s], bi_s = bi[tc*si + i_s]
//   e_s       = r_s - (((sum_k p_s[k] q_s[k] + mu) + bu_s) + bi_s)
//   dP_s      = lr (e_s q_s - reg p_s), dQ_s = lr (e_s p_s - reg q_s),
//             on all rank lanes (no lane is frozen)
//   dbu_s     = lr (e_s - reg bu_s), dbi_s = lr (e_s - reg bi_s)
//   row, bias = snapshot + sum of the deltas of every slot with that row,
//               summed in slot order (the reference's exact segment sum)
//   sse      += sum_s e_s^2 over real slots (pad slots hold u == su and
//               touch nothing)
// With use_bias == 0 the bias terms are 0 and bu, bi are left untouched.
//
// Order: tiles apply strictly in plan order, as the TPU's sequential grid
// does; one thread block walks the whole sweep. Every sum is taken in the
// fixed order sweep_common.cuh states, so a run is bitwise repeatable. No
// float atomics.
//
// What bounds it on an H100: as sgd_sweep.cu, one SM's latency. A tile's
// phases (ids, gather, sort, residuals, scatter) are separated by
// barriers and the gather waits on L2 / device memory; 131 SMs idle. The
// bias vectors add 2 T scalar loads to the gather and 2 T candidate
// writers to the scatter, no phase and no barrier. Independent strata on
// the other SMs (the DSGD parallel mode) are the lever and change the
// update order.

#include "sweep_common.cuh"

namespace {

using namespace mfx_sweep;

template <int RANK>
__global__ void __launch_bounds__(THREADS)
sgd_sweep_tile_kernel(float* P, float* Q, float* bu, float* bi,
                      const int* __restrict__ sa, const int* __restrict__ tc,
                      const int* __restrict__ tl, float* __restrict__ sse_out,
                      int nt, int tpg, int T, int su, int si, int use_bias,
                      float lr, float reg, float mu) {
  constexpr int Q4 = RANK / 4;
  extern __shared__ float4 smem_raw[];
  const TileSmem<RANK> sm = TileSmem<RANK>::carve(smem_raw, T);
  float4* P4w = reinterpret_cast<float4*>(P);
  float sse = 0.f;  // thread 0 carries the sweep's sum

  for (int t = 0; t < nt; ++t) {
    const long long pbase = (long long)sa[t / tpg] * su;
    const long long qbase = (long long)tc[t] * si;
    load_ids(sm, tl + (long long)t * 3 * T, T, su);
    __syncthreads();
    gather(sm, P, Q, bu, bi, pbase, qbase, T, su, use_bias);
    sort_keys(sm.keyU, sm.keyI);
    residuals(sm, T, su, mu, use_bias);
    __syncthreads();

    // 5. scatter: the first position of each row's run writes
    for (int w = threadIdx.x; w < MAX_T * Q4; w += THREADS) {
      const int q = w % Q4, p = w / Q4;
      if (!starts_run(sm.keyU, p)) continue;
      const int x = sm.keyU[p] >> 8, j0 = sm.keyU[p] & 255;
      P4w[(pbase + x) * Q4 + q] =
          add4(sm.Ps[j0 * Q4 + q],
               run_delta<Q4>(sm.keyU, sm.Ps, sm.Qs, sm.e, p, q, lr, reg));
    }
    // the user biases' writers are the upper half of the block
    // (scatter_items' bias writers are the lower half)
    static_assert(THREADS == 2 * MAX_T, "one bias writer a sorted position");
    const int pb = threadIdx.x - MAX_T;
    if (use_bias && pb >= 0 && starts_run(sm.keyU, pb)) {
      const int x = sm.keyU[pb] >> 8, j0 = sm.keyU[pb] & 255;
      bu[pbase + x] =
          sm.bus[j0] + run_bias_delta(sm.keyU, sm.bus, sm.e, pb, lr, reg);
    }
    scatter_items(sm, Q, bi, qbase, use_bias, lr, reg);
    sse += tile_sse(sm, T);
    __syncthreads();
  }
  if (threadIdx.x == 0) sse_out[0] = sse;
}

template <int RANK>
int launch(float* P, float* Q, float* bu, float* bi, const int* sa,
           const int* tc, const int* tl, float* sse_out, int nt, int tpg,
           int T, int su, int si, int use_bias, float lr, float reg, float mu,
           cudaStream_t stream) {
  const size_t smem = TileSmem<RANK>::bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      sgd_sweep_tile_kernel<RANK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgd_sweep_tile_kernel<RANK><<<1, THREADS, smem, stream>>>(
      P, Q, bu, bi, sa, tc, tl, sse_out, nt, tpg, T, su, si, use_bias, lr,
      reg, mu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mfx_sgd_sweep_tile(float* P, float* Q, float* bu, float* bi,
                                  const int* sa, const int* tc, const int* tl,
                                  float* sse_out, int nt, int tpg, int T,
                                  int su, int si, int rank, int use_bias,
                                  float lr, float reg, float mu,
                                  void* stream) {
  if (su > MAX_BLOCK || si > MAX_BLOCK || T < 1 || T > MAX_T || tpg < 1)
    return (int)cudaErrorInvalidValue;
  if (rank == 64)
    return launch<64>(P, Q, bu, bi, sa, tc, tl, sse_out, nt, tpg, T, su, si,
                      use_bias, lr, reg, mu, (cudaStream_t)stream);
  if (rank == 32)
    return launch<32>(P, Q, bu, bi, sa, tc, tl, sse_out, nt, tpg, T, su, si,
                      use_bias, lr, reg, mu, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
