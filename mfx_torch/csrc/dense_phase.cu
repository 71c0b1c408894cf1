// Dense-stratum SGD phase (lane-carried biases, int4 rating codes, rank 64).
//
// Replaces: mfx/kernels/dense_pallas.py::_kernel_body (lane=True,
// rfmt='int4', echo=1, spg=1), driven by dense_sgd_phase_pallas.
//
// What it computes, per dense stratum (user block a = sa[s], item window
// c = sc[s]), strata in order, each a snapshot minibatch:
//   S = P_blk Q_winᵀ                       (su x si, from the snapshot)
//   E = [code > 0] ∘ ((code / 2 − S) − mu)  (biases ride in S)
//   P_blk += lr s_u ∘ (E Q_win − reg Du ∘ P_blk), lane rank-2 frozen
//   Q_win += lr s_i ∘ (Eᵀ P_blk − reg Di ∘ Q_win), lane rank-1 frozen
//   s = min(1, DSTAR / max(deg, 1)), DSTAR = 16; Du/Di = per-stratum raw
//   rating degrees; sse += Σ E² (first-pass semantics)
// R holds int4 codes round(2 r), 0 = absent, plain (su, si/2) bytes per
// stratum with the even column in the low nibble.
//
// Form: two launches per stratum. (1) over 64 x 64 tiles of the stratum:
// rebuild S in f32, decode R, form E in shared memory, and write this
// tile's partial dP (its 64 rows, summed over its 64 columns), partial dQ
// (its 64 columns, summed over its 64 rows) and partial SSE to scratch.
// (2) over the rows of P_blk and Q_win: sum the partials in a fixed order,
// apply the trust-scaled update, and add the stratum's SSE into the
// phase's accumulator. Both updates read the pre-stratum snapshot, which
// launch (1) alone reads. Every sum runs in a fixed order and there are
// no float atomics, so a run is bitwise repeatable.
//
// What bounds it on an H100: the three 64-deep products per cell are
// 3 * 2 * su * si * 64 FLOP per stratum (about 0.4 GFLOP at 1024²) on the
// f32 FMA units, against su*si/2 bytes of R; the stratum is compute-bound
// and, at 256 blocks of 256 threads, fills the card only about two waves
// deep. The design does all three products from one shared-memory copy
// of each tile (S is never written out) and keeps the partial sums
// (2 x 4 MB at 1024²) in L2. wgmma and several independent strata in
// flight at once are the next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RANK = 64;
constexpr int TB = 64;        // tile edge (rows and columns of a stratum)
constexpr int PITCH = RANK + 1;
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr float DSTAR = 16.f;

constexpr size_t kTileSmem = 3 * TB * PITCH * sizeof(float);

__global__ void __launch_bounds__(THREADS)
dense_tile_kernel(const float* __restrict__ P, const float* __restrict__ Q,
                  const int* __restrict__ sa, const int* __restrict__ sc,
                  const uint8_t* __restrict__ R, float* __restrict__ dP_part,
                  float* __restrict__ dQ_part, float* __restrict__ sse_part,
                  int s, int su, int si, float mu) {
  extern __shared__ float smem[];
  float* Pt = smem;              // (TB, PITCH) rows of P_blk
  float* Qt = Pt + TB * PITCH;   // (TB, PITCH) rows of Q_win
  float* Et = Qt + TB * PITCH;   // (TB, PITCH) E[r][c]
  __shared__ float red[THREADS / 32];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int jt = blockIdx.x, it = blockIdx.y;  // column / row tile
  const int r0 = it * TB, c0 = jt * TB;
  const float* Pb = P + ((long long)sa[s] * su + r0) * RANK;
  const float* Qb = Q + ((long long)sc[s] * si + c0) * RANK;
  for (int idx = tid; idx < TB * RANK; idx += THREADS) {
    const int row = idx / RANK, k = idx - row * RANK;
    Pt[row * PITCH + k] = Pb[idx];
    Qt[row * PITCH + k] = Qb[idx];
  }
  __syncthreads();

  // S and E for rows ty + 16m, columns tx + 16n
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
  for (int k = 0; k < RANK; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = Pt[(ty + 16 * m) * PITCH + k];
#pragma unroll
    for (int n = 0; n < 4; ++n) b[n] = Qt[(tx + 16 * n) * PITCH + k];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
  }
  const uint8_t* Rs = R + (long long)s * su * (si / 2);
  float sq = 0.f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = ty + 16 * m;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = tx + 16 * n, col = c0 + c;
      const uint8_t byte = Rs[(long long)(r0 + r) * (si / 2) + (col >> 1)];
      const int code = (col & 1) ? (byte >> 4) : (byte & 15);
      const float e = code > 0 ? ((float)code * 0.5f - acc[m][n]) - mu : 0.f;
      Et[r * PITCH + c] = e;
      sq = fmaf(e, e, sq);
    }
  }
  // fixed-order block reduction of the tile's SSE
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((tid & 31) == 0) red[tid >> 5] = sq;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
    sse_part[it * gridDim.x + jt] = t;
  }

  // dP partial: rows ty + 16m, lanes tx + 16n, summed over this tile's
  // columns; dQ partial: columns ty + 16m, lanes tx + 16n, over its rows
  float dp[4][4], dq[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) dp[m][n] = dq[m][n] = 0.f;
  for (int j = 0; j < TB; ++j) {
    float eP[4], eQ[4], q[4], p[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      eP[m] = Et[(ty + 16 * m) * PITCH + j];  // E[row][j]
      eQ[m] = Et[j * PITCH + ty + 16 * m];    // E[j][col]
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      q[n] = Qt[j * PITCH + tx + 16 * n];
      p[n] = Pt[j * PITCH + tx + 16 * n];
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        dp[m][n] = fmaf(eP[m], q[n], dp[m][n]);
        dq[m][n] = fmaf(eQ[m], p[n], dq[m][n]);
      }
  }
  float* dPo = dP_part + ((long long)jt * su + r0) * RANK;
  float* dQo = dQ_part + ((long long)it * si + c0) * RANK;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      dPo[(ty + 16 * m) * RANK + tx + 16 * n] = dp[m][n];
      dQo[(ty + 16 * m) * RANK + tx + 16 * n] = dq[m][n];
    }
}

// One thread per (row, lane) of P_blk (rows [0, su)) and Q_win (rows
// [su, su + si)); block 0's first warp also folds the stratum's SSE.
__global__ void __launch_bounds__(THREADS)
dense_apply_kernel(float* __restrict__ P, float* __restrict__ Q,
                   const int* __restrict__ sa, const int* __restrict__ sc,
                   const float* __restrict__ du, const float* __restrict__ di,
                   const float* __restrict__ dP_part,
                   const float* __restrict__ dQ_part,
                   const float* __restrict__ sse_part,
                   float* __restrict__ sse_acc, int s, int su, int si,
                   float lr, float reg) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int nbi = su / TB, nbj = si / TB;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float t = 0.f;
    for (int b = 0; b < nbi * nbj; ++b) t += sse_part[b];
    sse_acc[0] += t;
  }
  const int row = (int)(idx / RANK), k = (int)(idx % RANK);
  if (row < su) {
    float g = 0.f;
    for (int j = 0; j < nbj; ++j)
      g += dP_part[((long long)j * su + row) * RANK + k];
    const float deg = du[(long long)s * su + row];
    const float scale = fminf(1.f, DSTAR / fmaxf(deg, 1.f));
    float* p = P + ((long long)sa[s] * su + row) * RANK + k;
    const float d = k == RANK - 2 ? 0.f : g - reg * deg * *p;
    *p = *p + lr * scale * d;
  } else if (row < su + si) {
    const int c = row - su;
    float g = 0.f;
    for (int i = 0; i < nbi; ++i)
      g += dQ_part[((long long)i * si + c) * RANK + k];
    const float deg = di[(long long)s * si + c];
    const float scale = fminf(1.f, DSTAR / fmaxf(deg, 1.f));
    float* q = Q + ((long long)sc[s] * si + c) * RANK + k;
    const float d = k == RANK - 1 ? 0.f : g - reg * deg * *q;
    *q = *q + lr * scale * d;
  }
}

}  // namespace

extern "C" int mfx_dense_phase(float* P, float* Q, const int* sa,
                               const int* sc, const uint8_t* R,
                               const float* du, const float* di,
                               float* dP_part, float* dQ_part,
                               float* sse_part, float* sse_acc, int nd,
                               int su, int si, int rank, float lr, float reg,
                               float mu, void* stream) {
  if (rank != RANK || su % TB || si % TB || nd < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      dense_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTileSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 tiles(si / TB, su / TB);
  const int apply_blocks =
      (int)(((long long)(su + si) * RANK + THREADS - 1) / THREADS);
  for (int s = 0; s < nd; ++s) {
    dense_tile_kernel<<<tiles, THREADS, kTileSmem, st>>>(
        P, Q, sa, sc, R, dP_part, dQ_part, sse_part, s, su, si, mu);
    dense_apply_kernel<<<apply_blocks, THREADS, 0, st>>>(
        P, Q, sa, sc, du, di, dP_part, dQ_part, sse_part, sse_acc, s, su, si,
        lr, reg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
