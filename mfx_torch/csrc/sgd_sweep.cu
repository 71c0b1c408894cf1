// Sparse blocked-SGD sweep (lane-carried biases, ranks 2, 4, 8, 16, 32, 64
// and 128), and its time form (blocked timeSVD; ranks 8 to 128).
//
// Replaces: mfx/kernels/sgd_pallas.py::_kernel_body (bias_mode='lane',
// pack 64, 32, 16, 8 and 4 at ranks 2 to 32, pack_path='roll' at rank 64,
// pack 1 at rank 128; with time_mode=True the time form), driven by
// blocked_sgd_sweep_pallas / _sweep_chunk_call. Rank 1 has no lane form:
// one lane cannot hold both bias lanes.
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
// bf16 (the reference's mxu_bf16 branch, sgd.mxu='bf16'; the lane form
// only, a runtime flag): p_s and q_s enter e_s and the deltas rounded to
// bf16, each delta is rounded to bf16 before the run's f32 sum, and a row
// becomes its f32 snapshot + that sum (sweep_common.cuh).
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
// So do ranks 32 down to 4, whose whole row is their "half" (the
// sweep_common.cuh buffers at RANK lanes, 71 KB at rank 32 and T = 256;
// below rank 32 a slot's 8 dot threads hold RANK / 4 float4 and the rest
// add zeros, sweep_common.cuh); the time form's frozen and injected lanes
// then all lie in the row (n_bins <= rank - 4: 28, 12 and 4 at ranks 32,
// 16 and 8; none at rank 4, which has no time form). At rank 2 the row is
// [1, bu] in P and [bi, 1] in Q, the baseline predictor mu + bu + bi, both
// lanes frozen on one side: it is held in one float4 of shared memory
// whose lanes 2 and 3 are 0 (sweep_common.cuh, "Ranks 2 and 1"), and the
// frozen lanes are counted against the rank, not the padded 4.
//
// The time form (TIME, timeSVD's temporal terms in the lanes). With
// L = rank - 3 - n_bins, P rows are [p(L), 0 x n_bins, alpha_u, 1, bu] and
// Q rows [q(L), bt_i(n_bins), 0, bi, 1]; the tile stream has two more rows,
// each slot's time bin and (f32 bits) its deviation dev. After each gather
// a real slot's own snapshot rows take 1 more in P lane L + bin and dev
// more in Q lane rank-3, so the dot carries bt_{i,bin} + alpha_u dev and
// the ordinary step is the temporal update: the bin lanes of Q get
// lr (e [b == bin] - reg bt_b), P's lane rank-3 gets lr (e dev - reg
// alpha). Frozen: P's bin lanes and lane rank-2, Q's lanes rank-3 and
// rank-1. The injections must not reach the table, and the write-back is
// the run's first slot's snapshot plus the run's deltas: so each slot keeps
// the table values of its two injected lanes (p_clean, q_clean), and the
// write-back puts them back in those lanes. Two slots of one user in a
// tile carry different bins; their injections live in their own snapshot
// rows. Pads (u == su) inject nothing.
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

// The lanes of one side whose deltas are dropped: [lo, hi) and `one`.
struct Frozen {
  int lo, hi, one;
};

// a with the frozen lanes of the row zeroed, where they lie in quad q
__device__ inline float4 freeze(float4 a, Frozen f, int q) {
  float* v = reinterpret_cast<float*>(&a);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int l = 4 * q + c;
    if ((l >= f.lo && l < f.hi) || l == f.one) v[c] = 0.f;
  }
  return a;
}

// The time form's per-slot operands (after TileSmem in shared memory):
// time bin, deviation, and the table values of the two lanes each real slot
// injects into (P lane L + bin, Q lane rank-3).
struct TimeSmem {
  int* bin;
  float* dev;
  float* p_clean;
  float* q_clean;

  __host__ __device__ static size_t bytes(int T) { return (size_t)4 * T * 4; }

  __device__ static TimeSmem carve(void* base, int T) {
    TimeSmem s;
    s.bin = reinterpret_cast<int*>(base);
    s.dev = reinterpret_cast<float*>(s.bin + T);
    s.p_clean = s.dev + T;
    s.q_clean = s.p_clean + T;
    return s;
  }
};

// 1b. the tile's time bins and deviations (rows 3 and 4 of the stream)
__device__ inline void load_time(const TimeSmem& ts, const int* tt, int T) {
  const int tid = threadIdx.x;
  if (tid < T) {
    ts.bin[tid] = tt[3 * T + tid];
    ts.dev[tid] = __int_as_float(tt[4 * T + tid]);
  }
}

// 2b. after a gather of the lanes [lane0, lane0 + HALF) and a barrier: each
// real slot adds 1 to its P snapshot's lane L + bin and dev to its Q
// snapshot's lane rank-3, where they lie in those lanes, keeping the values
// it found there. Ends before the caller's barrier.
template <int RANK>
__device__ inline void inject(const TileSmem<HALF<RANK>>& sm,
                              const TimeSmem& ts, int T, int su, int L,
                              int n_bins, int lane0) {
  constexpr int H = HALF<RANK>, HQ4 = ROW4<H>;
  const int s = threadIdx.x;
  if (s >= T || sm.uid[s] >= su) return;
  float* ps = reinterpret_cast<float*>(sm.Ps + s * HQ4);
  float* qs = reinterpret_cast<float*>(sm.Qs + s * HQ4);
  const int b = ts.bin[s];
  const int lp = L + b - lane0, lq = RANK - 3 - lane0;
  if (b >= 0 && b < n_bins && lp >= 0 && lp < H) {
    ts.p_clean[s] = ps[lp];
    ps[lp] += 1.f;
  }
  if (lq >= 0 && lq < H) {
    ts.q_clean[s] = qs[lq];
    qs[lq] += ts.dev[s];
  }
}

// One side's injected lane in each slot's snapshot row and the table value
// it held: lane base + bin[j] (base alone where bin is null), none where the
// bin lies outside [0, n) or val is null (the lane form).
struct Injected {
  const int* bin;
  int base, n;
  const float* val;
};

// Column quad q of the shared half (HQ4 float4 a row; the row's quad
// q_off + q of a table of rows of RANK floats, st_quad) of the row at
// sorted position p on one side (P or Q). If p
// starts its row's run of equal keys, write snapshot + the run's summed
// deltas, the side's frozen lanes left as they were: where the first
// slot's snapshot holds an injection, the table's value goes back in its
// place.
template <int RANK, int HQ4>
__device__ inline void scatter_quad(
    float* table, long long base, const int* key, const float4* own,
    const float4* other, const float* e, int p, int q, int q_off, Frozen fz,
    Injected inj, float lr, float reg, bool bf16) {
  if (!starts_run(key, p)) return;
  const int x = key[p] >> 8, j0 = key[p] & 255;
  float4 w = add4(own[j0 * HQ4 + q],
                  freeze(run_delta<HQ4>(key, own, other, e, p, q, lr, reg,
                                        bf16),
                         fz, q_off + q));
  if (inj.val != nullptr) {
    const int b = inj.bin != nullptr ? inj.bin[j0] : 0;
    const int c = inj.base + b - 4 * (q_off + q);
    float* v = reinterpret_cast<float*>(&w);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (b >= 0 && b < inj.n && c == k) v[k] = inj.val[j0];
  }
  st_quad<RANK>(table, base + x, q_off + q, w);
}

// 5. scatter of the lanes in shared memory: one (side, sorted position,
// column quad) per thread and step; only the first position of each row's
// run writes. `fp` / `fq`: each side's frozen lanes, `ip` / `iq` its
// injections.
template <int RANK>
__device__ inline void scatter_half(const TileSmem<HALF<RANK>>& sm, float* P,
                                    float* Q, long long pbase,
                                    long long qbase, int q_off, Frozen fp,
                                    Frozen fq, Injected ip, Injected iq,
                                    float lr, float reg, bool bf16) {
  constexpr int HQ4 = ROW4<HALF<RANK>>;
  for (int w = threadIdx.x; w < 2 * MAX_T * HQ4; w += THREADS) {
    const int q = w % HQ4, rest = w / HQ4;
    if (rest < MAX_T)
      scatter_quad<RANK, HQ4>(P, pbase, sm.keyU, sm.Ps, sm.Qs, sm.e,
                                  rest, q, q_off, fp, ip, lr, reg, bf16);
    else
      scatter_quad<RANK, HQ4>(Q, qbase, sm.keyI, sm.Qs, sm.Ps, sm.e,
                                  rest - MAX_T, q, q_off, fq, iq, lr, reg,
                                  bf16);
  }
}

// P and Q are rewritten by this and other blocks during the launch, so
// they are deliberately not const/__restrict__ and every row is loaded
// from L2 (see sweep_common.cuh). TIME: the time form (n_bins bins; the
// lane form ignores n_bins). bf16: the lane form's bf16 rounding (the time
// form passes 0).
template <int RANK, bool TIME>
__global__ void __launch_bounds__(THREADS)
sgd_sweep_kernel(float* P, float* Q, const int* __restrict__ sa,
                 const int* __restrict__ tc, const int* __restrict__ tl,
                 Wavefront wf, float* __restrict__ sums, int tpg, int T,
                 int su, int si, float lr, float reg, float mu, int n_bins,
                 int bf16) {
  constexpr int H = HALF<RANK>, HQ4 = ROW4<H>, HALVES = RANK / H;
  constexpr int ROWS = TIME ? 5 : 3;  // tile stream rows
  extern __shared__ float4 smem_raw[];
  __shared__ int run_slot;
  const TileSmem<H> sm = TileSmem<H>::carve(smem_raw, T);
  const TimeSmem ts = TimeSmem::carve(
      reinterpret_cast<char*>(smem_raw) + TileSmem<H>::bytes(T), T);
  const int L = RANK - 3 - n_bins;  // the time form's latent lanes
  const Frozen fp = TIME ? Frozen{L, L + n_bins, RANK - 2}
                         : Frozen{0, 0, RANK - 2};
  const Frozen fq = TIME ? Frozen{RANK - 3, RANK - 2, RANK - 1}
                         : Frozen{0, 0, RANK - 1};
  const Injected ip = TIME ? Injected{ts.bin, L, n_bins, ts.p_clean}
                           : Injected{nullptr, 0, 0, nullptr};
  const Injected iq = TIME ? Injected{nullptr, RANK - 3, 1, ts.q_clean}
                           : Injected{nullptr, 0, 0, nullptr};

  for (int run = take_run(wf, &run_slot); run < wf.nruns;
       run = take_run(wf, &run_slot)) {
    const int t0 = wf.runs[2 * run], n = wf.runs[2 * run + 1];
    for (int k = 0; k < n; ++k) {
      const int t = t0 + k;
      const long long pbase = (long long)sa[t / tpg] * su;
      const long long qbase = (long long)tc[t] * si;
      const int* tt = tl + (long long)t * ROWS * T;
      load_ids(sm, tt, T, su);
      if (TIME) load_time(ts, tt, T);
      const bool ends_stratum = await_tile(wf, t);
      __syncthreads();
      gather<H, RANK>(sm, P, Q, nullptr, nullptr, pbase, qbase, T, su,
                      /*use_bias=*/0);
      sort_keys<2>(sm.keyU);
      if (TIME) {
        inject<RANK>(sm, ts, T, su, L, n_bins, 0);
        __syncthreads();
      }
      float v[DOT_SLOTS] = {};
      dot_part(sm, T, v, bf16);
#pragma unroll
      for (int h = 1; h < HALVES; ++h) {  // rank 128: lanes 64-127
        __syncthreads();
        gather<H, RANK>(sm, P, Q, nullptr, nullptr, pbase, qbase, T, su,
                        /*use_bias=*/0, h * HQ4);
        __syncthreads();
        if (TIME) {
          inject<RANK>(sm, ts, T, su, L, n_bins, h * H);
          __syncthreads();
        }
        dot_part(sm, T, v, bf16);
      }
      finish_residuals(sm.e, sm.uid, sm.bus, sm.bis, T, su, mu,
                       /*use_bias=*/0, v);
      __syncthreads();

      // 5. scatter the half in shared memory; at rank 128 then gather
      // lanes 0-63 again (still the tile-start values) and scatter them
      scatter_half<RANK>(sm, P, Q, pbase, qbase, (HALVES - 1) * HQ4, fp, fq,
                         ip, iq, lr, reg, bf16);
      if (HALVES > 1) {
        __syncthreads();
        gather<H, RANK>(sm, P, Q, nullptr, nullptr, pbase, qbase, T, su,
                        /*use_bias=*/0);
        __syncthreads();
        if (TIME) {
          inject<RANK>(sm, ts, T, su, L, n_bins, 0);
          __syncthreads();
        }
        scatter_half<RANK>(sm, P, Q, pbase, qbase, 0, fp, fq, ip, iq, lr,
                           reg, bf16);
      }
      const float sse = tile_sse(sm, T);
      if (threadIdx.x == 0) sums[t] = sse;
      __syncthreads();
      publish(wf, ends_stratum, run, k + 1);
    }
  }
}

template <int RANK, bool TIME>
size_t smem_bytes(int T) {
  return TileSmem<HALF<RANK>>::bytes(T) + (TIME ? TimeSmem::bytes(T) : 0);
}

template <int RANK, bool TIME>
int launch(float* P, float* Q, const int* sa, const int* tc, const int* tl,
           const Wavefront& wf, float* sums, float* sse_out, int nt,
           int blocks, int tpg, int T, int su, int si, float lr, float reg,
           float mu, int n_bins, int bf16, cudaStream_t stream) {
  const size_t smem = smem_bytes<RANK, TIME>(T);
  cudaError_t err = cudaFuncSetAttribute(
      sgd_sweep_kernel<RANK, TIME>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgd_sweep_kernel<RANK, TIME><<<blocks, THREADS, smem, stream>>>(
      P, Q, sa, tc, tl, wf, sums, tpg, T, su, si, lr, reg, mu, n_bins,
      bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ordered_sum_kernel<<<1, SUM_THREADS, 0, stream>>>(sums, nt, sse_out);
  return (int)cudaGetLastError();
}

template <bool TIME>
int max_blocks(int T, int rank) {
  const int bad = -(int)cudaErrorInvalidValue;
  if (T < 1 || T > MAX_T) return bad;
  return with_rank(rank, bad, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if constexpr (TIME ? R < 8 : R < 2)  // no bin fits at rank 4; no
      return bad;                        // lane model at rank 1
    else
      return resident_blocks(sgd_sweep_kernel<R, TIME>, THREADS,
                             smem_bytes<R, TIME>(T));
  });
}

template <bool TIME>
int sweep(float* P, float* Q, const int* sa, const int* tc, const int* tl,
          const int* runs, const int* wait, int* state, float* sums,
          float* sse_out, int nt, int nruns, int blocks, int tpg, int T,
          int su, int si, int rank, float lr, float reg, float mu,
          int n_bins, int bf16, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (su > MAX_BLOCK || si > MAX_BLOCK || T < 1 || T > MAX_T || tpg < 1 ||
      nruns < 1 || blocks < 1 ||
      (TIME && (n_bins < 1 || n_bins > rank - 4 || bf16)))
    return bad;
  const Wavefront wf{runs, wait, state, nruns};
  return with_rank(rank, bad, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if constexpr (TIME ? R < 8 : R < 2)
      return bad;
    else
      return launch<R, TIME>(P, Q, sa, tc, tl, wf, sums, sse_out, nt, blocks,
                             tpg, T, su, si, lr, reg, mu, n_bins, bf16,
                             (cudaStream_t)stream);
  });
}

}  // namespace

// Thread blocks of the rank's sgd_sweep_kernel the device holds at once at
// tile size T, or minus the CUDA error.
extern "C" int mfx_sgd_sweep_max_blocks(int T, int rank) {
  return max_blocks<false>(T, rank);
}

// The same for the time form.
extern "C" int mfx_sgd_sweep_time_max_blocks(int T, int rank) {
  return max_blocks<true>(T, rank);
}

// bf16: 1 for the bf16 form (sgd.mxu='bf16'), 0 for f32.
extern "C" int mfx_sgd_sweep(float* P, float* Q, const int* sa, const int* tc,
                             const int* tl, const int* runs, const int* wait,
                             int* state, float* sums, float* sse_out, int nt,
                             int nruns, int blocks, int tpg, int T, int su,
                             int si, int rank, float lr, float reg, float mu,
                             int bf16, void* stream) {
  return sweep<false>(P, Q, sa, tc, tl, runs, wait, state, sums, sse_out, nt,
                      nruns, blocks, tpg, T, su, si, rank, lr, reg, mu, 0,
                      bf16, stream);
}

// The time form: tl holds 5 rows a tile (u, i, r bits, bin, dev bits).
extern "C" int mfx_sgd_sweep_time(float* P, float* Q, const int* sa,
                                  const int* tc, const int* tl,
                                  const int* runs, const int* wait,
                                  int* state, float* sums, float* sse_out,
                                  int nt, int nruns, int blocks, int tpg,
                                  int T, int su, int si, int rank, float lr,
                                  float reg, float mu, int n_bins,
                                  void* stream) {
  return sweep<true>(P, Q, sa, tc, tl, runs, wait, state, sums, sse_out, nt,
                     nruns, blocks, tpg, T, su, si, rank, lr, reg, mu, n_bins,
                     0, stream);
}
