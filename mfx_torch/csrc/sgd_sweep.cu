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
// order, so a run is bitwise repeatable. No float atomics.
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

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int RANK = 64;
constexpr int Q4 = RANK / 4;     // float4 per row
constexpr int THREADS = 512;
constexpr int MAX_T = 256;       // tile size limit; slot ids fit 8 bits
constexpr int MAX_BLOCK = 1024;  // largest su / si
constexpr int GATHER = MAX_T * Q4 / THREADS;  // float4 per thread per table
constexpr int NO_ROW = INT_MAX;  // sort key of a pad slot (sorts last)

struct SweepSmem {
  // laid out in dynamic shared memory by offset (see smem_bytes)
  float4* Ps;     // (T, Q4) user-row snapshot
  float4* Qs;     // (T, Q4) item-row snapshot
  int* uid;       // (T,) block-local user id (su = pad)
  int* iid;       // (T,) window-local item id (si = pad)
  float* e;       // (T,) rating, then residual (0 for pad slots)
  int* keyU;      // (MAX_T,) (user id << 8 | slot), sorted ascending
  int* keyI;      // (MAX_T,) (item id << 8 | slot), sorted ascending
};

__host__ __device__ inline size_t smem_bytes(int T) {
  return (size_t)2 * T * RANK * sizeof(float) + (size_t)3 * T * 4 +
         (size_t)2 * MAX_T * 4;
}

__device__ inline SweepSmem carve(float4* base, int T) {
  SweepSmem s;
  s.Ps = base;
  s.Qs = s.Ps + T * Q4;
  s.uid = reinterpret_cast<int*>(s.Qs + T * Q4);
  s.iid = s.uid + T;
  s.e = reinterpret_cast<float*>(s.iid + T);
  s.keyU = reinterpret_cast<int*>(s.e + T);
  s.keyI = s.keyU + MAX_T;
  return s;
}

__device__ inline float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ inline float delta(float e, float other, float own, float lr,
                              float reg) {
  return lr * (e * other - reg * own);
}

// Column quad q of the row at sorted position p on one side (P or Q). If
// p starts its row's run of equal keys, sum the deltas of the run's slots
// (ascending slot order) and write snapshot + sum.
__device__ inline void scatter_quad(
    float* table, long long base, const int* key, const float4* own,
    const float4* other, const float* e, int p, int q, int frozen, float lr,
    float reg) {
  const int k0 = key[p];
  if (k0 == NO_ROW) return;
  const int x = k0 >> 8;
  if (p > 0 && (key[p - 1] >> 8) == x) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int pp = p; pp < MAX_T && (key[pp] >> 8) == x; ++pp) {
    const int j = key[pp] & 255;
    const float ej = e[j];
    const float4 o = other[j * Q4 + q], w = own[j * Q4 + q];
    a.x += delta(ej, o.x, w.x, lr, reg);
    a.y += delta(ej, o.y, w.y, lr, reg);
    a.z += delta(ej, o.z, w.z, lr, reg);
    a.w += delta(ej, o.w, w.w, lr, reg);
  }
  const int c = frozen - 4 * q;  // the frozen column inside this quad
  if (c == 0) a.x = 0.f;
  if (c == 1) a.y = 0.f;
  if (c == 2) a.z = 0.f;
  if (c == 3) a.w = 0.f;
  const float4 w = own[(k0 & 255) * Q4 + q];
  reinterpret_cast<float4*>(table)[(base + x) * Q4 + q] =
      make_float4(w.x + a.x, w.y + a.y, w.z + a.z, w.w + a.w);
}

// P and Q are read and written by this block between barriers, so they
// are deliberately not const/__restrict__: a non-coherent cached load
// could return a row a previous tile of this sweep already rewrote.
__global__ void __launch_bounds__(THREADS)
sgd_sweep_kernel(float* P, float* Q, const int* __restrict__ sa,
                 const int* __restrict__ tc, const int* __restrict__ tl,
                 float* __restrict__ sse_out, int nt, int tpg, int T, int su,
                 int si, float lr, float reg, float mu) {
  extern __shared__ float4 smem_raw[];
  SweepSmem sm = carve(smem_raw, T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* P4 = reinterpret_cast<const float4*>(P);
  const float4* Qg4 = reinterpret_cast<const float4*>(Q);
  float sse = 0.f;  // lane 0 of warp 0 carries the sweep's sum

  for (int t = 0; t < nt; ++t) {
    const int* tt = tl + (long long)t * 3 * T;
    const long long pbase = (long long)sa[t / tpg] * su;
    const long long qbase = (long long)tc[t] * si;

    // 1. ids, ratings and the unsorted (row, slot) keys
    if (tid < MAX_T) {
      int ku = NO_ROW, ki = NO_ROW;
      if (tid < T) {
        const int u = tt[tid], i = tt[T + tid];
        sm.uid[tid] = u;
        sm.iid[tid] = i;
        sm.e[tid] = __int_as_float(tt[2 * T + tid]);
        if (u < su) {
          ku = u << 8 | tid;
          ki = i << 8 | tid;
        }
      }
      sm.keyU[tid] = ku;
      sm.keyI[tid] = ki;
    }
    __syncthreads();

    // 2. snapshot gather: 16 threads per row, every load issued before
    // any store
    {
      float4 pv[GATHER], qv[GATHER];
#pragma unroll
      for (int m = 0; m < GATHER; ++m) {
        const int idx = tid + m * THREADS, s = idx / Q4, k = idx % Q4;
        pv[m] = qv[m] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (s < T) {
          const int u = sm.uid[s];
          if (u < su) {
            pv[m] = P4[(pbase + u) * Q4 + k];
            qv[m] = Qg4[(qbase + sm.iid[s]) * Q4 + k];
          }
        }
      }
#pragma unroll
      for (int m = 0; m < GATHER; ++m) {
        const int idx = tid + m * THREADS;
        if (idx < T * Q4) {
          sm.Ps[idx] = pv[m];
          sm.Qs[idx] = qv[m];
        }
      }
    }

    // 3. bitonic sort of both key arrays (threads [0, 256) sort the user
    // keys, [256, 512) the item keys); keys are unique, so the order is
    // exact and a row's slots end up adjacent in ascending slot order
    {
      int* key = tid < MAX_T ? sm.keyU : sm.keyI;
      const int i = tid & (MAX_T - 1);
      for (int k = 2; k <= MAX_T; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          __syncthreads();
          const int ixj = i ^ j;
          if (ixj > i) {
            const int a = key[i], b = key[ixj];
            if ((a > b) == ((i & k) == 0)) {
              key[i] = b;
              key[ixj] = a;
            }
          }
        }
      }
    }
    __syncthreads();

    // 4. residuals: 8 threads per slot, a fixed-order sum of their 8
    // products each, then a fixed butterfly over the 8 lanes
    {
      const int g = tid >> 3, k = tid & 7;
      for (int s0 = 0; s0 < T; s0 += THREADS / 8) {
        const int s = s0 + g;
        float v = 0.f;
        if (s < T) {
          const float4* p = sm.Ps + s * Q4;
          const float4* q = sm.Qs + s * Q4;
          v = dot4(p[k + 8], q[k + 8], dot4(p[k], q[k], 0.f));
        }
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (s < T && k == 0)
          sm.e[s] = sm.uid[s] < su ? sm.e[s] - (v + mu) : 0.f;
      }
    }
    __syncthreads();

    // 5. scatter: one (side, sorted position, column quad) per thread and
    // step; only the first position of each row's run writes
    for (int w = tid; w < 2 * MAX_T * Q4; w += THREADS) {
      const int q = w % Q4, rest = w / Q4;
      if (rest < MAX_T)
        scatter_quad(P, pbase, sm.keyU, sm.Ps, sm.Qs, sm.e, rest, q,
                     RANK - 2, lr, reg);
      else
        scatter_quad(Q, qbase, sm.keyI, sm.Qs, sm.Ps, sm.e, rest - MAX_T, q,
                     RANK - 1, lr, reg);
    }
    if (warp == 0) {
      float part = 0.f;
      for (int s = lane; s < T; s += 32) part += sm.e[s] * sm.e[s];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) sse += part;
    }
    __syncthreads();
  }
  if (tid == 0) sse_out[0] = sse;
}

}  // namespace

extern "C" int mfx_sgd_sweep(float* P, float* Q, const int* sa, const int* tc,
                             const int* tl, float* sse_out, int nt, int tpg,
                             int T, int su, int si, int rank, float lr,
                             float reg, float mu, void* stream) {
  if (rank != RANK || su > MAX_BLOCK || si > MAX_BLOCK || T < 1 ||
      T > MAX_T || tpg < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(T);
  cudaError_t err = cudaFuncSetAttribute(
      sgd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sgd_sweep_kernel<<<1, THREADS, smem, (cudaStream_t)stream>>>(
      P, Q, sa, tc, tl, sse_out, nt, tpg, T, su, si, lr, reg, mu);
  return (int)cudaGetLastError();
}
