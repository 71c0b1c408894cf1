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
// scores = (P_aug q8) * scale + bias. Every score is one f32 fmaf chain
// over k ascending from 0 (true f32, no TF32: the exact mode's
// suspect-tile bound needs true f32 scores).
//
// What bounds it on an H100: 2 B I_pad K FLOP of f32 FMA (38 GFLOP at
// B = 256, 1M items, K = 72; 0.55 ms at the card's 67 TFLOP/s) against
// I_pad K bytes-per-value of catalog (288 MB in f32, 0.09 ms): the FMA
// pipes, as long as the shared-memory loads that feed them, the copies
// and the selection stay off their path.
//
// Form. One persistent launch of 256-thread blocks: block (s, ub) takes
// UB user rows (user block ub) and the tiles s, s + S, s + 2S, ... The
// host picks UB (128 or 16) from (B, n_tiles) by a rule measured on the
// card (see launch()) and S so that the blocks fill the card's slots; a
// small catalog or a small batch still fills the card. The block's users sit in shared memory once, as f32, k-major.
// Its tiles' rows stream through shared memory in chunks of 128 rows:
// 16-byte cp.async copies of the raw rows (8-byte for int8 rows of
// K % 16 == 8 bytes), then one pass that converts them to f32 and
// transposes them k-major; the next chunk's copies are issued right
// after that pass, so they land while this chunk is scored. Each thread scores a register tile of UB/16
// users x 8 items (8 x 8 at UB = 128): per k two float4 loads of users
// and two of items, which a warp's lanes share (4 user groups x 8 item
// groups a warp), for 64 FMAs. Selection:
//   depth <= 2: from the registers. Each thread keeps, for each of its
//     users, the sorted top 2 of the items it scores, updated item by
//     item without a branch (a chunk's items and the chunks arrive in
//     increasing lane order; a branch taken by one lane would hold up
//     its warp); at a tile's end the 8 lists of a warp merge by shuffles,
//     and the two warps' by one pass through shared memory.
//   depth 3..32: the chunk's (UB, 128) scores go to shared memory; 256/UB
//     threads a user each merge their share into a sorted top-DCAP list
//     in registers (DCAP 8 or 32), and at a tile's end those lists merge
//     by `depth` rounds of a shuffle argmax on (value, -lane).
// No atomics: a run is bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CH = 128;       // catalog rows per chunk
constexpr int QP = CH + 4;    // pitch of the k-major chunk rows
constexpr int SCP = CH + 16;  // pitch of the score rows (depth > 2)
constexpr int MAX_TILE = 2048;
constexpr int MAX_K = 128;
constexpr int MAX_DEPTH = 32;
constexpr unsigned FULL = 0xffffffffu;

enum { DT_F32 = 0, DT_BF16 = 1, DT_INT8 = 2 };

template <int DT>
__host__ __device__ constexpr int value_bytes() {
  return DT == DT_F32 ? 4 : (DT == DT_BF16 ? 2 : 1);
}

// Shared memory, in 4-byte words: the users (K, UB) k-major; the raw
// chunk (CH rows of W words, row pitch raw_pitch()); the f32 chunk
// (K, QP) k-major; then, for depth > 2, the scores (UB, SCP), or, for
// depth <= 2, the two warps' merged lists (UB, 2, DCAP) of values and of
// lanes. Every part is a multiple of 4 words (16-byte aligned starts).
template <int DT, int UB, int DCAP>
struct Layout {
  int K;
  __host__ __device__ int row_words() const {
    return K * value_bytes<DT>() / 4;
  }
  // 16-byte copies (W % 4 == 0): a pitch of 4 mod 8 words; 8-byte
  // copies: 2 mod 4. Either keeps the conversion's reads spread over the
  // banks.
  __host__ __device__ int raw_pitch() const {
    const int w = row_words();
    return w % 4 == 0 ? (w % 8 == 4 ? w : w + 4) : (w % 4 == 2 ? w : w + 2);
  }
  __host__ __device__ size_t users() const { return (size_t)K * UB; }
  __host__ __device__ size_t raw() const { return (size_t)CH * raw_pitch(); }
  __host__ __device__ size_t chunk() const { return (size_t)K * QP; }
  __host__ __device__ size_t tail() const {
    return DCAP <= 2 ? (size_t)UB * 2 * DCAP * 2 : (size_t)UB * SCP;
  }
  __host__ __device__ size_t bytes() const {
    return 4 * (users() + raw() + chunk() + tail());
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               : : "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               : : "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" : : : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" : : : "memory");
}

// Copy CH catalog rows of W words from src into the raw chunk (row pitch
// RWP words) in pieces of PIECE words: a thread's pieces are tid,
// tid + THREADS, ..., consecutive lanes on consecutive pieces of a row.
template <int PIECE>
__device__ __forceinline__ void copy_rows(uint32_t* raw, const uint32_t* src,
                                          int W, int RWP) {
  const int per_row = W / PIECE;
  const int di = THREADS / per_row, dc = THREADS - di * per_row;
  int i = threadIdx.x / per_row, c = threadIdx.x - i * per_row;
  for (int p = threadIdx.x; p < CH * per_row; p += THREADS) {
    if (PIECE == 4)
      cp_async16(raw + i * RWP + 4 * c, src + (long long)i * W + 4 * c);
    else
      cp_async8(raw + i * RWP + 2 * c, src + (long long)i * W + 2 * c);
    i += di;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++i;
    }
  }
}

// Start copying catalog rows [row0, row0 + CH) into the raw chunk.
__device__ __forceinline__ void issue_chunk(uint32_t* raw, const void* Q,
                                            long long row0, int W, int RWP) {
  const uint32_t* src = static_cast<const uint32_t*>(Q) + row0 * W;
  if (W % 4 == 0)
    copy_rows<4>(raw, src, W, RWP);
  else  // int8 rows of K % 16 == 8 bytes
    copy_rows<2>(raw, src, W, RWP);
  cp_async_commit();
}

// The landed raw chunk to f32, k-major: values k..k+3 of row i at a
// time, rows fastest across lanes.
template <int DT>
__device__ __forceinline__ void convert_chunk(float* qt, const uint32_t* raw,
                                              int K, int RWP) {
  const int KQ = K / 4;
  for (int w = threadIdx.x; w < KQ * CH; w += THREADS) {
    const int kq = w / CH, i = w % CH;
    const uint32_t* src = raw + i * RWP + kq * value_bytes<DT>();
    float v[4];
    if (DT == DT_F32) {
      const uint4 x = *reinterpret_cast<const uint4*>(src);
      v[0] = __uint_as_float(x.x);
      v[1] = __uint_as_float(x.y);
      v[2] = __uint_as_float(x.z);
      v[3] = __uint_as_float(x.w);
    } else if (DT == DT_BF16) {  // the lower half of a word is the lower k
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      v[0] = __uint_as_float(x.x << 16);
      v[1] = __uint_as_float(x.x & 0xffff0000u);
      v[2] = __uint_as_float(x.y << 16);
      v[3] = __uint_as_float(x.y & 0xffff0000u);
    } else {
      const uint32_t x = *src;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (float)(int8_t)(uint8_t)(x >> (8 * e));
    }
    float* dst = qt + (4 * kq) * QP + i;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e * QP] = v[e];
  }
}

// TU consecutive user values of row k of the users' table
template <int TU>
__device__ __forceinline__ void load_users(float (&a)[TU], const float* p) {
  if (TU % 4 == 0) {
#pragma unroll
    for (int u = 0; u < TU; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + u);
      a[u] = v.x;
      a[u + 1] = v.y;
      a[u + 2] = v.z;
      a[u + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < TU; ++u) a[u] = p[u];
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

template <int D>
__device__ __forceinline__ void clear(float (&lv)[D], int (&li)[D]) {
#pragma unroll
  for (int s = 0; s < D; ++s) {
    lv[s] = -INFINITY;
    li[s] = INT32_MAX;
  }
}

// One round of a merge: the best head (value, then the lower lane) of
// the lists of the aligned group of `width` lanes around this one; the
// lane that held it pops its head. Every lane of the warp calls it.
template <int D>
__device__ __forceinline__ void pop_best(float (&lv)[D], int (&li)[D],
                                         int width, float& v, int& ix) {
  v = lv[0];
  ix = li[0];
  for (int off = width / 2; off; off >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, off);
    const int i2 = __shfl_xor_sync(FULL, ix, off);
    if (v2 > v || (v2 == v && i2 < ix)) {
      v = v2;
      ix = i2;
    }
  }
  if (li[0] == ix) {
#pragma unroll
    for (int s = 0; s + 1 < D; ++s) {
      lv[s] = lv[s + 1];
      li[s] = li[s + 1];
    }
    lv[D - 1] = -INFINITY;
    li[D - 1] = INT32_MAX;
  }
}

template <int DT, int UB, int DCAP>
__global__ void __launch_bounds__(THREADS, UB <= 16 ? 2 : 1)
tile_topk_kernel(const void* __restrict__ P, const void* __restrict__ Q,
                 const float* __restrict__ sb, float* __restrict__ m_out,
                 int* __restrict__ a_out, int B, int K, int tile, int depth,
                 int tn, int n_ub, int S) {
  constexpr int TU = UB / 16;           // users a thread scores
  constexpr bool IN_REGS = DCAP <= 2;   // selection from the registers
  constexpr int NU = IN_REGS ? TU : 1;  // lists a thread keeps
  constexpr int G = THREADS / UB;       // threads a user selects with
  const Layout<DT, UB, DCAP> lay{K};
  extern __shared__ float4 smem4[];
  float* pt = reinterpret_cast<float*>(smem4);  // (K, UB) users, k-major
  uint32_t* raw = reinterpret_cast<uint32_t*>(pt + lay.users());
  float* qt = reinterpret_cast<float*>(raw + lay.raw());  // (K, QP)
  float* tail = qt + lay.chunk();  // the scores, or the merged lists

  const int tid = threadIdx.x;
  const int s = blockIdx.x / n_ub, ub = blockIdx.x - s * n_ub;
  const int u0 = ub * UB;
  const int W = lay.row_words(), RWP = lay.raw_pitch();
  const int cpt = tile / CH;                    // chunks a tile
  const int nq = ((tn - 1 - s) / S + 1) * cpt;  // chunks of the block
  // the scoring tile: users ty*TU.., items tx*4.. and 64 + tx*4..
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);

  issue_chunk(raw, Q, (long long)s * tile, W, RWP);
  // users: u fastest, so the transposed stores do not conflict
  for (int e = tid; e < UB * K; e += THREADS) {
    const int u = e % UB, k = e / UB;
    float v = 0.f;
    if (u0 + u < B) {
      const long long o = (long long)(u0 + u) * K + k;
      v = DT == DT_BF16
              ? __bfloat162float(static_cast<const __nv_bfloat16*>(P)[o])
              : static_cast<const float*>(P)[o];
    }
    pt[k * UB + u] = v;
  }

  float lv[NU][DCAP];
  int li[NU][DCAP];
#pragma unroll
  for (int u = 0; u < NU; ++u) clear(lv[u], li[u]);
  for (int q = 0; q < nq; ++q) {
    const int t = s + (q / cpt) * S, c0 = (q % cpt) * CH;
    cp_async_wait_all();
    // chunk q has landed; every thread is done with chunk q - 1
    __syncthreads();
    convert_chunk<DT>(qt, raw, K, RWP);
    __syncthreads();
    if (q + 1 < nq) {  // lands while this chunk is scored
      const int t1 = s + ((q + 1) / cpt) * S, c1 = ((q + 1) % cpt) * CH;
      issue_chunk(raw, Q, (long long)t1 * tile + c1, W, RWP);
    }

    float acc[TU][8];
#pragma unroll
    for (int u = 0; u < TU; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[u][j] = 0.f;
    const float* pa = pt + ty * TU;
    const float* qa = qt + tx * 4;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      float a[TU];
      load_users<TU>(a, pa + k * UB);
      const float4 b0 = *reinterpret_cast<const float4*>(qa + k * QP);
      const float4 b1 = *reinterpret_cast<const float4*>(qa + k * QP + 64);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < TU; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[u][j] = fmaf(a[u], b[j], acc[u][j]);
    }
    if (DT == DT_INT8) {
      const float* sbt = sb + (long long)t * 2 * tile + c0 + tx * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 sc4 =
            __ldg(reinterpret_cast<const float4*>(sbt + 64 * h));
        const float4 bi4 =
            __ldg(reinterpret_cast<const float4*>(sbt + tile + 64 * h));
        const float scl[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
        const float bia[4] = {bi4.x, bi4.y, bi4.z, bi4.w};
#pragma unroll
        for (int u = 0; u < TU; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[u][4 * h + e] =
                __fadd_rn(__fmul_rn(acc[u][4 * h + e], scl[e]), bia[e]);
      }
    }
    const bool tile_end = c0 + CH == tile;

    if constexpr (IN_REGS) {
      static_assert(DCAP == 2, "the branch-free update keeps two");
      // items tx*4 + j, then 64 + tx*4 + j: increasing lanes, so a
      // strict comparison keeps the lower lane on equal values
#pragma unroll
      for (int u = 0; u < TU; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = acc[u][j];
          const int i = c0 + (j >> 2) * 64 + tx * 4 + (j & 3);
          const bool gt0 = v > lv[u][0], gt1 = v > lv[u][1];
          lv[u][1] = gt0 ? lv[u][0] : (gt1 ? v : lv[u][1]);
          li[u][1] = gt0 ? li[u][0] : (gt1 ? i : li[u][1]);
          lv[u][0] = gt0 ? v : lv[u][0];
          li[u][0] = gt0 ? i : li[u][0];
        }
      if (!tile_end) continue;
      // the tile's end: each user's 8 lists in this warp (lanes that
      // differ in bits 0-2), then the two warps (w, w ^ 1) of its users
      // through shared memory
      float* mv = tail;  // (UB, 2, DCAP)
      int* mi = reinterpret_cast<int*>(tail + UB * 2 * DCAP);
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        for (int j = 0; j < depth; ++j) {
          float v;
          int ix;
          pop_best<DCAP>(lv[u], li[u], 8, v, ix);
          if ((lane & 7) == 0) {
            const int o = ((ty * TU + u) * 2 + (warp & 1)) * DCAP + j;
            mv[o] = v;
            mi[o] = ix;
          }
        }
        clear(lv[u], li[u]);
      }
      __syncthreads();
      if (tid < UB && u0 + tid < B) {
        const float* av = mv + tid * 2 * DCAP;  // two sorted lists
        const int* ai = mi + tid * 2 * DCAP;
        int x = 0, y = DCAP;
        for (int j = 0; j < depth; ++j) {
          const bool first =
              av[x] > av[y] || (av[x] == av[y] && ai[x] < ai[y]);
          const long long o = ((long long)j * B + u0 + tid) * tn + t;
          m_out[o] = first ? av[x] : av[y];
          a_out[o] = first ? ai[x] : ai[y];
          x += first;
          y += !first;
        }
      }
      // mv / mi are next written a chunk later, behind its barriers
    } else {
      float* sc = tail;  // (UB, SCP)
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        float* row = sc + (ty * TU + u) * SCP + tx * 4;
        *reinterpret_cast<float4*>(row) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
        *reinterpret_cast<float4*>(row + 64) =
            make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
      }
      __syncthreads();
      // user ul's float4 columns r, r + G, ...: increasing lanes
      const int ul = tid / G, r = tid - ul * G;
      const float* row = sc + ul * SCP;
#pragma unroll
      for (int m = 0; m < CH / 4 / G; ++m) {
        const int f = r + G * m;
        const float4 v = *reinterpret_cast<const float4*>(row + 4 * f);
        if (fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)) > lv[0][DCAP - 1]) {
          const int lane0 = c0 + 4 * f;
          insert<DCAP>(lv[0], li[0], v.x, lane0);
          insert<DCAP>(lv[0], li[0], v.y, lane0 + 1);
          insert<DCAP>(lv[0], li[0], v.z, lane0 + 2);
          insert<DCAP>(lv[0], li[0], v.w, lane0 + 3);
        }
      }
      if (!tile_end) continue;
      // the tile's end: merge the user's G lists (adjacent lanes)
      const int b = u0 + ul;
      for (int j = 0; j < depth; ++j) {
        float v;
        int ix;
        pop_best<DCAP>(lv[0], li[0], G, v, ix);
        if (r == 0 && b < B) {
          const long long o = ((long long)j * B + b) * tn + t;
          m_out[o] = v;
          a_out[o] = ix;
        }
      }
      clear(lv[0], li[0]);
    }
  }
}

// Blocks of one kernel an SM at its shared memory: 0 where it does not
// fit, minus the CUDA error. Set and asked on every launch, with nothing
// cached (asking costs a few µs at most, measure_topk forms). The
// kernel's dynamic shared memory cap is set to the device's largest, the
// same value whatever K, so threads that launch at once on one device
// cannot lower it under each other.
template <int DT, int UB, int DCAP>
int occupancy(size_t smem, int optin) {
  if (smem > (size_t)optin) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      tile_topk_kernel<DT, UB, DCAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tile_topk_kernel<DT, UB, DCAP>, THREADS, smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// The launch for ub users a block at occ blocks an SM: S tile strides for
// each of the n_ub user blocks, as many as fill the card's slots.
template <int DT, int UB, int DCAP>
int launch_form(const void* P, const void* Q, const float* sb, float* m_out,
                int* a_out, int B, int K, int tile, int depth, int tn,
                int slots, cudaStream_t st) {
  const int n_ub = (B + UB - 1) / UB;
  const int S = max(1, min(tn, slots / n_ub));
  tile_topk_kernel<DT, UB, DCAP>
      <<<n_ub * S, THREADS, Layout<DT, UB, DCAP>{K}.bytes(), st>>>(
          P, Q, sb, m_out, a_out, B, K, tile, depth, tn, n_ub, S);
  return (int)cudaGetLastError();
}

// ub: users a block, 16 or 128, or 0 for the launch's choice, measured on
// an H100 (measure_topk forms, B = 1 ... 256 on 58 and 977 tiles): 16
// where one 16-user block covers the batch (the 128-user form only adds
// padded users), or where the 16-user form's blocks, one a tile, fit in
// one wave of the card (one short tile each beats one long one); 128
// otherwise, where it costs a third as much a user.
template <int DT, int DCAP>
int launch(const void* P, const void* Q, const float* sb, float* m_out,
           int* a_out, int B, int ipad, int K, int tile, int depth, int ub,
           cudaStream_t st) {
  const int tn = ipad / tile;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const int occ_small =
      occupancy<DT, 16, DCAP>(Layout<DT, 16, DCAP>{K}.bytes(), optin);
  if (occ_small < 0) return -occ_small;
  const long long small_blocks = (long long)((B + 15) / 16) * tn;
  if (ub == 0 && (B <= 16 || small_blocks <= (long long)sms * occ_small))
    ub = 16;
  if (ub != 16) {
    const int occ_big =
        occupancy<DT, 128, DCAP>(Layout<DT, 128, DCAP>{K}.bytes(), optin);
    if (occ_big < 0) return -occ_big;
    if (occ_big > 0)
      return launch_form<DT, 128, DCAP>(P, Q, sb, m_out, a_out, B, K, tile,
                                        depth, tn, sms * occ_big, st);
    if (ub == 128) return (int)cudaErrorInvalidConfiguration;
  }
  if (occ_small < 1) return (int)cudaErrorInvalidConfiguration;
  return launch_form<DT, 16, DCAP>(P, Q, sb, m_out, a_out, B, K, tile, depth,
                                   tn, sms * occ_small, st);
}

template <int DT>
int launch_depth(const void* P, const void* Q, const float* sb, float* m_out,
                 int* a_out, int B, int ipad, int K, int tile, int depth,
                 int ub, cudaStream_t st) {
  if (depth <= 2)
    return launch<DT, 2>(P, Q, sb, m_out, a_out, B, ipad, K, tile, depth, ub,
                         st);
  if (depth <= 8)
    return launch<DT, 8>(P, Q, sb, m_out, a_out, B, ipad, K, tile, depth, ub,
                         st);
  return launch<DT, 32>(P, Q, sb, m_out, a_out, B, ipad, K, tile, depth, ub,
                        st);
}

}  // namespace

// m_out, a_out: (depth, B, ipad / tile) f32 and int32. dtype: 0 f32
// (P f32), 1 bf16 (P bf16), 2 int8 (P f32, sb (ipad / tile, 2, tile)).
// ub: users a block (16 or 128), or 0 for the launch's own choice.
extern "C" int mfx_tile_topk(const void* P, const void* Q, const float* sb,
                             float* m_out, int* a_out, int B, int ipad, int K,
                             int tile, int depth, int dtype, int ub,
                             void* stream) {
  if (B < 0 || K <= 0 || K % 8 || K > MAX_K || tile <= 0 || tile % CH ||
      tile > MAX_TILE || ipad < 0 || ipad % tile || depth < 1 ||
      depth > MAX_DEPTH || (dtype == DT_INT8 && sb == nullptr) ||
      (ub != 0 && ub != 16 && ub != 128))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || ipad == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch_depth<DT_F32>(P, Q, sb, m_out, a_out, B, ipad, K, tile,
                                  depth, ub, st);
    case DT_BF16:
      return launch_depth<DT_BF16>(P, Q, sb, m_out, a_out, B, ipad, K, tile,
                                   depth, ub, st);
    case DT_INT8:
      return launch_depth<DT_INT8>(P, Q, sb, m_out, a_out, B, ipad, K, tile,
                                   depth, ub, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
