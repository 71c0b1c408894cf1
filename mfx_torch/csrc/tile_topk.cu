// Per-tile top-`depth` serving candidates (score-block-free top-K).
//
// Replaces: mfx/kernels/serve_pallas.py::_kernel, driven by tile_topk and
// tile_topk2 (f32, bf16 and int8 catalogs).
//
// What it computes: for user rows P_aug (B, K) = [p, 1, 0...] and the
// augmented catalog Q_aug (I_pad, K) = [q, b_i, 0...] (pad rows carry
// b_i = -1e30), scores = P_aug Q_augᵀ, and for every catalog tile t of
// `tile` items and every row b the tile's `depth` best (value, lane)
// pairs, value descending and, on equal values, the lowest lane first
// (the order of the reference's iterative max-extract). bf16 catalogs:
// P_aug and Q_aug hold bf16 values, products and sums are f32. int8
// catalogs: Q_aug is int8 (bias lane 0), P_aug f32, and the (n_tiles, 2,
// tile) stream sb holds each item's scale and bias:
// scores = (P_aug q8) * scale + bias.
//
// Form: one block of 256 threads per (catalog tile, 16 users); the 16
// user blocks of one tile are adjacent in launch order. The block copies
// its 16 user rows to shared memory as f32, then streams the tile's rows
// through shared memory in chunks of 128, converted to f32. Each thread
// scores 2 users x 4 items per chunk with a fixed-order f32 FMA loop over
// K (true f32, no TF32: the exact mode's suspect-tile bound needs true f32
// scores), and the scores go to a (16, tile) block in shared memory. Then
// each warp selects for its 2 users: every lane keeps a sorted top-DCAP
// list of its items (lane, lane + 32, ...; DCAP >= depth, a compile-time
// bucket so the list stays in registers), and `depth` rounds of a warp
// argmax on the key (value, -lane) merge the 32 lists. No atomics: a run
// is bitwise repeatable.
//
// What bounds it on an H100: 2 B I_pad K FLOP of f32 FMA (38 GFLOP at
// B = 256, 1M items, K = 72) against I_pad K bytes-per-value of catalog
// (288 MB in f32). A tile's rows come from device memory once; its other
// user blocks, which run next to it, find them in L2. Each FMA pair needs
// shared-memory loads (2 float4 of P and 4 of Q per 32 FMA, conflict-free
// with a row pitch of K + 4), so the kernel is bound by f32 FMA issue and
// shared-memory bandwidth, well under the card's FMA peak. Split-f32
// tensor-core products (wgmma) and TMA loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UB = 16;           // users per block
constexpr int UPW = UB / WARPS;  // users per warp
constexpr int CH = 128;          // catalog rows per shared-memory chunk
constexpr int IPL = CH / 32;     // items per lane per chunk
constexpr int MAX_TILE = 2048;
constexpr int MAX_K = 128;
constexpr int MAX_DEPTH = 32;
constexpr unsigned FULL = 0xffffffffu;

enum { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2 };

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Copy rows [row0, row0 + nrows) of a (rows, K) table into shared memory
// as f32 with row pitch S; rows at or past `limit` are zero.
template <int DT>
__device__ __forceinline__ void load_rows(float* dst, const void* src,
                                          long long row0, int nrows,
                                          long long limit, int K, int S) {
  const int per_row = K / 8;  // 8-value groups per row
  for (int g = threadIdx.x; g < nrows * per_row; g += THREADS) {
    const int r = g / per_row;
    const int c = (g - r * per_row) * 8;
    float v[8];
    if (row0 + r < limit) {
      const long long off = (row0 + r) * K + c;
      if (DT == DT_F32) {
        const float4* s = reinterpret_cast<const float4*>(
            static_cast<const float*>(src) + off);
        const float4 a = s[0], b = s[1];
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      } else if (DT == DT_BF16) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(src) + off);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          v[2 * e] = f.x;
          v[2 * e + 1] = f.y;
        }
      } else {
        const uint2 raw = *reinterpret_cast<const uint2*>(
            static_cast<const int8_t*>(src) + off);
        const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = (float)q[e];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
    store8(dst + r * S + c, v);
  }
}

// Insert (v, i) into a list sorted by value descending. Items arrive in
// increasing lane order, so a strict comparison keeps equal values in
// lane order.
template <int D>
__device__ __forceinline__ void insert(float (&lv)[D], int (&li)[D], float v,
                                       int i) {
  if (!(v > lv[D - 1])) return;  // not better than the list's last entry
#pragma unroll
  for (int s = D - 1; s >= 0; --s) {
    const bool above_prev = s > 0 && v > lv[s > 0 ? s - 1 : 0];
    if (v > lv[s]) {
      lv[s] = above_prev ? lv[s > 0 ? s - 1 : 0] : v;
      li[s] = above_prev ? li[s > 0 ? s - 1 : 0] : i;
    }
  }
}

template <int DT, int DCAP>
__global__ void __launch_bounds__(THREADS)
tile_topk_kernel(const void* __restrict__ P, const void* __restrict__ Q,
                 const float* __restrict__ sb, float* __restrict__ m_out,
                 int* __restrict__ a_out, int B, int K, int tile, int depth,
                 int n_ub, int tn) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int S = K + 4;
  float* p_s = smem;            // (UB, S) user rows
  float* q_s = p_s + UB * S;    // (CH, S) catalog chunk
  float* sc_s = q_s + CH * S;   // (UB, tile) scores
  const int t = blockIdx.x / n_ub;
  const int u0 = (blockIdx.x - t * n_ub) * UB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long item0 = (long long)t * tile;

  // int8 catalogs score against f32 user rows
  load_rows<DT == DT_BF16 ? DT_BF16 : DT_F32>(p_s, P, u0, UB, B, K, S);

  const float* pr0 = p_s + (warp * UPW) * S;
  const float* pr1 = pr0 + S;
  for (int c0 = 0; c0 < tile; c0 += CH) {
    __syncthreads();  // the previous chunk's q_s is no longer read
    load_rows<DT>(q_s, Q, item0 + c0, CH, item0 + tile, K, S);
    __syncthreads();
    float acc0[IPL], acc1[IPL];
#pragma unroll
    for (int j = 0; j < IPL; ++j) acc0[j] = acc1[j] = 0.f;
    for (int k = 0; k < K; k += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(pr0 + k);
      const float4 a1 = *reinterpret_cast<const float4*>(pr1 + k);
#pragma unroll
      for (int j = 0; j < IPL; ++j) {
        const float4 q =
            *reinterpret_cast<const float4*>(q_s + (lane + 32 * j) * S + k);
        acc0[j] = fmaf(a0.x, q.x, acc0[j]);
        acc0[j] = fmaf(a0.y, q.y, acc0[j]);
        acc0[j] = fmaf(a0.z, q.z, acc0[j]);
        acc0[j] = fmaf(a0.w, q.w, acc0[j]);
        acc1[j] = fmaf(a1.x, q.x, acc1[j]);
        acc1[j] = fmaf(a1.y, q.y, acc1[j]);
        acc1[j] = fmaf(a1.z, q.z, acc1[j]);
        acc1[j] = fmaf(a1.w, q.w, acc1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < IPL; ++j) {
      const int col = c0 + lane + 32 * j;
      float s0 = acc0[j], s1 = acc1[j];
      if (DT == DT_INT8) {
        const float* sbt = sb + (long long)t * 2 * tile;
        const float scale = sbt[col], bias = sbt[tile + col];
        s0 = __fadd_rn(__fmul_rn(s0, scale), bias);
        s1 = __fadd_rn(__fmul_rn(s1, scale), bias);
      }
      sc_s[(warp * UPW) * tile + col] = s0;
      sc_s[(warp * UPW + 1) * tile + col] = s1;
    }
  }
  __syncthreads();

  for (int uu = 0; uu < UPW; ++uu) {
    const int ul = warp * UPW + uu;
    const int b = u0 + ul;
    if (b >= B) break;  // uniform across the warp
    float lv[DCAP];
    int li[DCAP];
#pragma unroll
    for (int s = 0; s < DCAP; ++s) {
      lv[s] = -INFINITY;
      li[s] = INT32_MAX;
    }
    const float* row = sc_s + ul * tile;
    for (int i = lane; i < tile; i += 32) insert<DCAP>(lv, li, row[i], i);
    for (int j = 0; j < depth; ++j) {
      float v = lv[0];
      int ix = li[0];
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float v2 = __shfl_xor_sync(FULL, v, off);
        const int i2 = __shfl_xor_sync(FULL, ix, off);
        if (v2 > v || (v2 == v && i2 < ix)) {
          v = v2;
          ix = i2;
        }
      }
      if (li[0] == ix) {  // this lane held the winner: pop its head
#pragma unroll
        for (int s = 0; s + 1 < DCAP; ++s) {
          lv[s] = lv[s + 1];
          li[s] = li[s + 1];
        }
        lv[DCAP - 1] = -INFINITY;
        li[DCAP - 1] = INT32_MAX;
      }
      if (lane == 0) {
        const long long o = ((long long)j * B + b) * tn + t;
        m_out[o] = v;
        a_out[o] = ix;
      }
    }
  }
}

template <int DT, int DCAP>
int launch(const void* P, const void* Q, const float* sb, float* m_out,
           int* a_out, int B, int ipad, int K, int tile, int depth,
           cudaStream_t st) {
  const int tn = ipad / tile;
  const int n_ub = (B + UB - 1) / UB;
  const size_t smem = ((size_t)(UB + CH) * (K + 4) + (size_t)UB * tile) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_topk_kernel<DT, DCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tile_topk_kernel<DT, DCAP><<<tn * n_ub, THREADS, smem, st>>>(
      P, Q, sb, m_out, a_out, B, K, tile, depth, n_ub, tn);
  return (int)cudaGetLastError();
}

template <int DT>
int launch_depth(const void* P, const void* Q, const float* sb, float* m_out,
                 int* a_out, int B, int ipad, int K, int tile, int depth,
                 cudaStream_t st) {
#define MFX_TOPK_CASE(D)                                                  \
  if (depth <= D)                                                         \
    return launch<DT, D>(P, Q, sb, m_out, a_out, B, ipad, K, tile, depth, \
                         st);
  MFX_TOPK_CASE(1)
  MFX_TOPK_CASE(2)
  MFX_TOPK_CASE(4)
  MFX_TOPK_CASE(8)
  MFX_TOPK_CASE(16)
  MFX_TOPK_CASE(32)
#undef MFX_TOPK_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// m_out, a_out: (depth, B, ipad / tile) f32 and int32. dtype: 0 f32
// (P f32), 1 bf16 (P bf16), 2 int8 (P f32, sb (ipad / tile, 2, tile)).
extern "C" int mfx_tile_topk(const void* P, const void* Q, const float* sb,
                             float* m_out, int* a_out, int B, int ipad, int K,
                             int tile, int depth, int dtype, void* stream) {
  if (B < 0 || K <= 0 || K % 8 || K > MAX_K || tile <= 0 || tile % CH ||
      tile > MAX_TILE || ipad < 0 || ipad % tile || depth < 1 ||
      depth > MAX_DEPTH || (dtype == DT_INT8 && sb == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || ipad == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch_depth<DT_F32>(P, Q, sb, m_out, a_out, B, ipad, K, tile,
                                  depth, st);
    case DT_BF16:
      return launch_depth<DT_BF16>(P, Q, sb, m_out, a_out, B, ipad, K, tile,
                                   depth, st);
    case DT_INT8:
      return launch_depth<DT_INT8>(P, Q, sb, m_out, a_out, B, ipad, K, tile,
                                   depth, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
