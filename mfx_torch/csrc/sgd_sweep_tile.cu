// Sparse blocked-SGD sweep with per-tile biases, epoch-frozen biases or
// none, ranks 1, 2, 4, 8, 16, 32, 64 and 128.
//
// Replaces: mfx/kernels/sgd_pallas.py::_kernel_body with bias_mode='tile'
// (its tile_bias branches), bias_mode='epoch' (its epoch_bias branches) or
// use_bias=False, driven by blocked_sgd_sweep_pallas / _sweep_chunk_call.
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
// With use_bias == BIAS_NONE the bias terms are 0 and bu, bi are left
// untouched. With use_bias == BIAS_EPOCH (the reference's bias_mode='epoch')
// the biases are frozen for the sweep: the gather reads bu_s and bi_s from
// vectors that nothing writes during the launch, which is exactly the
// reference's per-slot stream bt = bu[u] + bi[i] built before the sweeps,
//   e_s       = r_s - ((sum_k p_s[k] q_s[k] + mu) + (bu_s + bi_s)),
// the row updates are as above, no bias is written, and each slot's
// residual (0 for pad slots) goes to e_out[t * T + s] for the trainer's
// batched bias update at the epoch's end.
// bf16 (the reference's mxu_bf16 branch, sgd.mxu='bf16'; a runtime flag, in
// every bias mode): p_s, q_s and, per tile, bu_s and bi_s enter e_s and the
// deltas rounded to bf16, each delta is rounded to bf16 before the run's
// f32 sum, and a row or bias becomes its f32 snapshot + that sum; the
// epoch form's frozen biases are the reference's f32 stream, not rounded
// (sweep_common.cuh).
//
// Order: the result is that of applying the tiles strictly in plan
// order, as the TPU's sequential grid does. The launch's blocks share the
// sweep by sweep_common.cuh's wavefront scheduler, as sgd_sweep.cu's do:
// each takes whole user-block runs in plan order and walks a run front to
// back, and a stratum's first tile waits for the nearest earlier run's
// tiles of the same item window. A tile touches only its user block's P
// rows and bu entries and its window's Q rows and bi entries, so those two
// orders fix every value a tile gathers: tables and biases are bit for bit
// the one-block walk's on any number of blocks, and a grid of one block is
// that walk. Every sum inside a tile is taken in the fixed order
// sweep_common.cuh states; the per-tile SSE goes to a buffer that a second
// small kernel adds up in tile order. No float atomics.
//
// Memory ordering: P, Q, bu and bi are written on one SM and gathered on
// another inside the launch, so every load of them bypasses L1 (the
// header's gather) and a run's progress is published only after a barrier
// and a fence.
//
// Rank 128: shared memory holds lanes 0-63 and 64-127 of the tile's rows
// in turn (sweep_common.cuh, "Rank 128"; the rank-64 buffers, 138 KB at
// T = 256): the dots are carried across the two gathers, lanes 64-127 are
// scattered first, then lanes 0-63 are gathered again (still the tile-start
// values) and scattered. The biases are gathered with the first half and
// written once, the epoch form's residuals stored once. The table rows are
// RANK floats, the shared rows ROW4<HALF> float4. Ranks 1 to 32 hold the
// whole row (sweep_common.cuh, "Ranks 16, 8 and 4" and "Ranks 2 and 1":
// below rank 4 one zero-padded float4, the table read and written as a
// float2 or a float).
//
// What bounds it on an H100: as sgd_sweep.cu, one SM's latency a tile:
// its phases (ids, gather, sort, residuals, scatter) are separated by
// barriers and the gather waits on L2. The bias vectors add 2 T scalar
// loads to the gather and 2 T candidate writers to the scatter, no phase
// and no barrier; the epoch form drops the writers and adds T stores of
// e_s, off the tile's chain. A sweep's time is the tiles on its longest dependency
// chain (a sweep of W windows keeps at most W blocks busy) times that
// latency.

#include "sweep_common.cuh"

namespace {

using namespace mfx_sweep;

// P, Q, bu and bi are rewritten by this and other blocks during the
// launch, so they are deliberately not const/__restrict__.
template <int RANK>
__global__ void __launch_bounds__(THREADS)
sgd_sweep_tile_kernel(float* P, float* Q, float* bu, float* bi,
                      float* __restrict__ e_out,
                      const int* __restrict__ sa, const int* __restrict__ tc,
                      const int* __restrict__ tl, Wavefront wf,
                      float* __restrict__ sums, int tpg, int T, int su,
                      int si, int use_bias, int bf16, float lr, float reg,
                      float mu) {
  constexpr int H = HALF<RANK>, HQ4 = ROW4<H>, HALVES = RANK / H;
  extern __shared__ float4 smem_raw[];
  __shared__ int run_slot;
  const TileSmem<H> sm = TileSmem<H>::carve(smem_raw, T);

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
      gather_residuals<RANK>(sm, P, Q, bu, bi, pbase, qbase, T, su, mu,
                             use_bias, bf16);
      if (use_bias == BIAS_EPOCH && threadIdx.x < T)
        e_out[(long long)t * T + threadIdx.x] = sm.e[threadIdx.x];

      // 5. scatter the half in shared memory (the biases with it); at
      // rank 128 then gather lanes 0-63 again and scatter them
#pragma unroll
      for (int h = HALVES - 1; h >= 0; --h) {
        if (h < HALVES - 1) {
          __syncthreads();
          gather<H, RANK>(sm, P, Q, nullptr, nullptr, pbase, qbase, T, su,
                          BIAS_NONE, h * HQ4);
          __syncthreads();
        }
        const bool biases = use_bias == BIAS_TILE && h == HALVES - 1;
        scatter_side<HQ4, RANK>(P, pbase, sm.keyU, sm.Ps, sm.Qs, sm.e,
                                h * HQ4, lr, reg, bf16);
        if (biases) scatter_bias(bu, pbase, sm.keyU, sm.bus, sm.e, MAX_T, lr,
                                 reg, bf16);
        scatter_side<HQ4, RANK>(Q, qbase, sm.keyI, sm.Qs, sm.Ps, sm.e,
                                h * HQ4, lr, reg, bf16);
        if (biases)
          scatter_bias(bi, qbase, sm.keyI, sm.bis, sm.e, 0, lr, reg, bf16);
      }
      const float sse = tile_sse(sm, T);
      if (threadIdx.x == 0) sums[t] = sse;
      __syncthreads();
      publish(wf, ends_stratum, run, k + 1);
    }
  }
}

template <int RANK>
int launch(float* P, float* Q, float* bu, float* bi, float* e_out,
           const int* sa, const int* tc, const int* tl, const Wavefront& wf,
           float* sums, float* sse_out, int nt, int blocks, int tpg, int T,
           int su, int si, int use_bias, int bf16, float lr, float reg,
           float mu, cudaStream_t stream) {
  const size_t smem = TileSmem<HALF<RANK>>::bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      sgd_sweep_tile_kernel<RANK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgd_sweep_tile_kernel<RANK><<<blocks, THREADS, smem, stream>>>(
      P, Q, bu, bi, e_out, sa, tc, tl, wf, sums, tpg, T, su, si, use_bias,
      bf16, lr, reg, mu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ordered_sum_kernel<<<1, SUM_THREADS, 0, stream>>>(sums, nt, sse_out);
  return (int)cudaGetLastError();
}

}  // namespace

// Thread blocks of the rank's kernel the device holds at once at tile
// size T, or minus the CUDA error (one kernel for every bias mode).
extern "C" int mfx_sgd_sweep_tile_max_blocks(int T, int rank) {
  const int bad = -(int)cudaErrorInvalidValue;
  if (T < 1 || T > MAX_T) return bad;
  return with_rank(rank, bad, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return resident_blocks(sgd_sweep_tile_kernel<R>, THREADS,
                           TileSmem<HALF<R>>::bytes(T));
  });
}

// use_bias: 0 no biases, 1 per-tile biases, 2 epoch-frozen biases (bu
// and bi then read only). e_out: the (nt, T) f32 residuals, given exactly
// when use_bias is 2. bf16: 1 for the bf16 form, 0 for f32.
extern "C" int mfx_sgd_sweep_tile(float* P, float* Q, float* bu, float* bi,
                                  float* e_out, const int* sa, const int* tc,
                                  const int* tl, const int* runs,
                                  const int* wait, int* state, float* sums,
                                  float* sse_out, int nt, int nruns,
                                  int blocks, int tpg, int T, int su, int si,
                                  int rank, int use_bias, int bf16, float lr,
                                  float reg, float mu, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (su > MAX_BLOCK || si > MAX_BLOCK || T < 1 || T > MAX_T || tpg < 1 ||
      nruns < 1 || blocks < 1 || use_bias < BIAS_NONE ||
      use_bias > BIAS_EPOCH || ((use_bias == BIAS_EPOCH) != (e_out != nullptr)))
    return bad;
  const Wavefront wf{runs, wait, state, nruns};
  return with_rank(rank, bad, [&](auto r) {
    return launch<decltype(r)::value>(
        P, Q, bu, bi, e_out, sa, tc, tl, wf, sums, sse_out, nt, blocks, tpg,
        T, su, si, use_bias, bf16, lr, reg, mu, (cudaStream_t)stream);
  });
}
