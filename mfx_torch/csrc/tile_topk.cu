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
// Those forms take depth <= 32 and tiles of at most 2048 items.
//
// The deep form (tile_topk_deep_kernel: depth > 32 or tile > 2048, any
// depth up to the tile and any tile that is a multiple of 128) keeps the
// chunk pipeline and the register forms' scoring, and keeps each user's
// best `depth` so far in a pool in memory instead of registers.
// - Scoring: 64 users a block, each thread a 4 x 8 register tile
//   (score_chunk<DT, 64>: 32 FMAs from three 16-byte shared loads a k), so
//   a batch of 256 users streams the catalog 4 times. 64, not 128: a
//   user's pool (below) is depth + 128 slots of 8 bytes, 96 KB for 64 users
//   at depth 64, which fits beside the users and the two chunk buffers (95
//   KB at K = 72 in f32) only at 64 users; deeper, 32 users a block (2 x 8
//   tiles) keep theirs there up to depth ~300 (deep_info's rule). One
//   block an SM.
// - Selection by threshold, pruned late: each user's threshold is the
//   depth-th best (value, lane) of its pool (none while fewer were seen).
//   Right after a chunk is scored, each thread compares its own 8 scores a
//   user with the threshold in registers; the 8 lanes of a warp that score
//   a user reserve slots in the user's pool with one integer atomic on a
//   shared count and write their candidates there, in any order. No score
//   tile is written and no barrier stands between scoring and selection,
//   so a warp that has scored appends while the others still score (this
//   is the overlap: no warp specialisation). Only when a chunk's
//   candidates would overflow a pool (the slots that did not fit are
//   written empty and appended again afterwards, from the registers that
//   still hold the scores) does one warp prune it (prune_user) to its
//   depth best, unsorted, whose last is the new threshold. The cut-off is
//   found in one pass of value-range buckets (monotone in the value, so
//   higher buckets hold higher values; the cut-off's bucket, rarely more
//   than a few slots, is ranked by shuffles), or, where a bucket holds more
//   than 32 slots (the pad items' -1e30 scores, exact ties), by a radix
//   select over the values' bits and then the lanes. At the end of a piece
//   the pool is pruned once more and each slot written at its rank (the
//   count of slots ahead of it; past depth 64 the list is bitonic-sorted
//   first). Every comparison is (value desc, lane asc), a total order, so
//   no step depends on the order candidates arrive in. measure_topk split
//   gives the phases' shares.
// - The pools sit in shared memory where they fit (depth up to about 70 at
//   K = 72 in f32 with 64 users a block, up to about 300 with 32), else in
//   a device scratch, one region a block (the wrapper allocates it).
// - Grid: work items are (tile, piece) pairs; a tile's chunks are cut into
//   `pieces` pieces where the tiles x user blocks would not fill the
//   card's SMs (kernels/serve_topk.py::deep_split plans it, and
//   deep_pieces gives each piece's chunks). Each piece keeps its own
//   top-`depth` list; a second small launch (tile_topk_merge_kernel)
//   merges a tile's piece lists in piece order, one warp a (user, tile).
// Every score is the register forms' FMA chain. No atomics but the
// integer slot reservations and histogram counts (whose order changes
// nothing): a run is bitwise repeatable.

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

// Score one landed chunk: acc[u][j] is user ty*TU + u against item
// tx*4 + j (j < 4) and 64 + tx*4 + j - 4, one fmaf chain over k
// ascending; int8 catalogs then take each item's scale and bias from sb
// (tile t, chunk rows c0...).
template <int DT, int UB>
__device__ __forceinline__ void score_chunk(float (&acc)[UB / 16][8],
                                            const float* pt, const float* qt,
                                            const float* __restrict__ sb,
                                            int K, int ty, int tx,
                                            long long t, int tile, int c0) {
  constexpr int TU = UB / 16;
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
    const float* sbt = sb + t * 2 * tile + c0 + tx * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 sc4 = __ldg(reinterpret_cast<const float4*>(sbt + 64 * h));
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
    score_chunk<DT, UB>(acc, pt, qt, sb, K, ty, tx, t, tile, c0);
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

// ---- the deep form ------------------------------------------------------

// Measurement-only build (nvcc -DMFX_TOPK_STAMPS, kernels/_build.py's
// "topk_stamps" variant): thread 0 of each deep block adds clock64()
// deltas to one sum a phase, each stamp behind a __syncthreads(); the sums
// over the blocks go to g_tk. The default build carries none of it.
enum {
  TK_WAIT,     // a chunk's copy landing and the loop's barrier
  TK_APPEND,   // a chunk's candidates into the pools
  TK_PRUNE,    // pools that overflowed cut back, what did not fit added
  TK_FINISH,   // a piece's last prunes, sorts and lists
  TK_CONVERT,  // a chunk to f32, k-major, and the next one's copy issued
  TK_SCORE,    // a chunk's scores
  TK_N
};
#ifdef MFX_TOPK_STAMPS
__device__ unsigned long long g_tk[TK_N + 1];  // + the chunks
#define TOPK_STAMP(k)                                          \
  do {                                                         \
    __syncthreads();                                           \
    if (threadIdx.x == 0) {                                    \
      const long long t_ = clock64();                          \
      tk_st[k] += t_ - tk_last;                                \
      tk_last = t_;                                            \
    }                                                          \
  } while (0)
#else
#define TOPK_STAMP(k) \
  do {                \
  } while (0)
#endif

constexpr int DWARPS = THREADS / 32;
constexpr int DCAND = CH;          // pool slots past `depth`: one chunk's
constexpr int RADIX = 256;         // bins of a radix-select pass
constexpr int NOLANE = INT32_MAX;  // the lane of an empty slot
constexpr int MAX_PIECES = 32;     // pieces a tile (one lane each, merge)
constexpr int RANK_SLOTS = 2;      // a lane's slots when a list is ranked

// (a, ia) ranks ahead of (b, ib): the higher value, then the lower lane
__device__ __forceinline__ bool ahead(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// A float's bits as an unsigned key in the floats' order.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Add v to a shared-memory counter; the old value.
__device__ __forceinline__ int shared_fetch_add(int* p, int v) {
  int old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(v)
               : "memory");
  return old;
}

// Add v to a shared-memory counter.
__device__ __forceinline__ void shared_add(int* p, int v) {
  asm volatile("red.shared.add.u32 [%0], %1;\n"
               : : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(v)
               : "memory");
}

// The first chunk of piece p when a tile's cpt chunks are cut into
// `pieces` pieces (kernels/serve_topk.py::deep_pieces is the same rule).
__host__ __device__ __forceinline__ int piece_first(int p, int cpt,
                                                    int pieces) {
  return (int)((long long)p * cpt / pieces);
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// A user's pool: `depth` slots for its best so far plus one chunk's worth
// of candidates, at least a power of two past depth (the final sort's).
__host__ __device__ __forceinline__ int pool_slots(int depth) {
  const int n = max(depth + DCAND, pow2_at_least(depth));
  return (n + 3) & ~3;
}

// Shared memory of the deep form at UB users a block, in bytes: the
// register forms' users, raw and f32 chunks, each user's threshold value
// and lane and pool count, a radix histogram a warp, then (`pools_shared`)
// the pools: UB pools of pool_slots(depth) values, then as many lanes.
template <int DT, int UB>
size_t deep_smem(int K, int depth, bool pools_shared) {
  const Layout<DT, UB, 2> lay{K};
  const size_t base = lay.users() + lay.raw() + lay.chunk() + 3 * UB +
                      (size_t)DWARPS * RADIX + 4;
  return 4 * (base + (pools_shared ? (size_t)UB * 2 * pool_slots(depth)
                                   : 0));
}

// A block's selection state (user-indexed); the pools may be in shared or
// device memory.
struct DeepState {
  float* pv;   // (UB, cap) pool values
  int* pl;     // (UB, cap) pool lanes
  float* tv;   // (UB,) threshold: the depth-th best of the pool, or -inf
  int* tl;     // (UB,) and its lane, or NOLANE
  int* cnt;    // (UB,) pool slots taken (may pass cap on an overflow)
  int* hist;   // (DWARPS, RADIX) a warp's radix histogram
  int cap;     // slots a pool
};

// One warp's radix select (8 bits a pass, high to low): the largest key K
// with at least `need` of the n keys at K or above, among the keys that
// key_of(i, &k) marks; `need` becomes the count of those at K that are
// needed. Every lane returns K.
template <class KeyOf>
__device__ __forceinline__ unsigned radix_select(int* hist, int n, int& need,
                                                 KeyOf key_of, int lane) {
  unsigned prefix = 0, mask = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < RADIX; b += 32) hist[b] = 0;
    __syncwarp();
    // the lanes that fall in one bin add once (the high digits of
    // nearby scores are mostly equal: lane by lane they would serialize)
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      unsigned k = 0;
      const bool in = i < n && key_of(i, k) && (k & mask) == prefix;
      const int bin = in ? (int)((k >> shift) & (RADIX - 1)) : RADIX;
      const unsigned same = __match_any_sync(FULL, bin);
      if (in && lane == __ffs(same) - 1)
        shared_add(hist + bin, __popc(same));
    }
    __syncwarp();
    // lane l holds bins 255 - 8l ... 248 - 8l, the highest first
    int c[8], s = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      c[e] = hist[RADIX - 1 - 8 * lane - e];
      s += c[e];
    }
    int incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += x;
    }
    const int excl = incl - s;
    const unsigned hit = __ballot_sync(FULL, excl < need && need <= incl);
    const int src = __ffs(hit) - 1;
    int bin = 0, above = excl;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (bin == 0 && above + c[e] >= need)
        bin = RADIX - 8 * lane - e;  // the bin + 1, so 0 means not found
      else if (bin == 0)
        above += c[e];
    bin = __shfl_sync(FULL, bin - 1, src);
    above = __shfl_sync(FULL, above, src);
    need -= above;
    prefix |= (unsigned)bin << shift;
    mask |= (unsigned)(RADIX - 1) << shift;
    __syncwarp();
  }
  return prefix;
}

// One warp cuts user u's pool (its first min(cnt, cap) slots, empty slots
// (-inf, NOLANE) among them) to its `depth` best in (value desc, lane asc)
// order, in place, and makes the depth-th of them the user's threshold.
// A radix select over the values' keys finds the depth-th value; where
// more slots hold that value than are needed, a second one over their
// lanes (inverted: the lowest first) finds the last lane kept.
// The common case of prune_user, in one histogram pass: RADIX buckets
// over the pool's finite values, (v - lo) * scale, monotone in v, so a
// higher bucket holds only higher values; the bucket that holds the
// depth-th best has few slots, ranked among themselves by shuffles. Finds
// the depth-th best (tv, tl), or returns false (fewer than two distinct
// values, fewer than depth finite ones, or more than 32 slots in that
// bucket: the pad items' -1e30 scores, or exact ties) for the radix select.
__device__ __forceinline__ bool cutoff_by_buckets(const float* pv,
                                                  const int* pl, int n,
                                                  int depth, int* hist,
                                                  int lane, float& tv,
                                                  int& tl) {
  float lo = INFINITY, hi = -INFINITY;
  for (int i = lane; i < n; i += 32) {
    const float v = pv[i];
    if (v > -INFINITY) {
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(FULL, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, off));
  }
  const float scale = (float)RADIX / (hi - lo);
  if (!(hi > lo) || !(scale > 0.f) || !(scale < INFINITY)) return false;
  auto bucket = [&](float v) {
    return v > -INFINITY ? min(RADIX - 1, (int)((v - lo) * scale)) : -1;
  };
  for (int b = lane; b < RADIX; b += 32) hist[b] = 0;
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const int b = bucket(pv[i]);
    if (b >= 0) shared_add(hist + b, 1);
  }
  __syncwarp();
  int c[8], sum = 0;  // lane l holds buckets 255 - 8l ... 248 - 8l
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    c[e] = hist[RADIX - 1 - 8 * lane - e];
    sum += c[e];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += x;
  }
  const int excl = incl - sum;
  const unsigned hit = __ballot_sync(FULL, excl < depth && depth <= incl);
  if (hit == 0) return false;  // fewer than depth finite values
  const int src = __ffs(hit) - 1;
  int bin = 0, above = excl, m = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (bin == 0 && above + c[e] >= depth) {
      bin = RADIX - 8 * lane - e;  // the bucket + 1
      m = c[e];
    } else if (bin == 0) {
      above += c[e];
    }
  bin = __shfl_sync(FULL, bin - 1, src);
  above = __shfl_sync(FULL, above, src);
  m = __shfl_sync(FULL, m, src);
  if (m > 32) return false;
  // the bucket's slots, one a lane, ranked among themselves
  float bv = -INFINITY;
  int bl = NOLANE, have = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    float v = 0.f;
    int id = 0;
    bool in = false;
    if (i < n) {
      v = pv[i];
      id = pl[i];
      in = bucket(v) == bin;
    }
    const unsigned bits = __ballot_sync(FULL, in);
    // the bucket's next slots go to lanes have, have + 1, ...
    for (unsigned b = bits; b; b &= b - 1) {
      const int from = __ffs(b) - 1;
      const int to = have + __popc(bits & ((1u << from) - 1));
      const float vv = __shfl_sync(FULL, v, from);
      const int ii = __shfl_sync(FULL, id, from);
      if (lane == to) {
        bv = vv;
        bl = ii;
      }
    }
    have += __popc(bits);
  }
  int rank = 0;
  for (int j = 0; j < m; ++j) {
    const float vj = __shfl_sync(FULL, bv, j);
    const int lj = __shfl_sync(FULL, bl, j);
    rank += ahead(vj, lj, bv, bl);
  }
  const int need = depth - above;  // 1 <= need <= m
  const unsigned cut = __ballot_sync(FULL, lane < m && rank == need - 1);
  const int at = __ffs(cut) - 1;
  tv = __shfl_sync(FULL, bv, at);
  tl = __shfl_sync(FULL, bl, at);
  __syncwarp();
  return true;
}

__device__ __forceinline__ void prune_user(const DeepState& st, int u,
                                           int depth, int lane) {
  float* pv = st.pv + (size_t)u * st.cap;
  int* pl = st.pl + (size_t)u * st.cap;
  int* hist = st.hist + (threadIdx.x >> 5) * RADIX;
  const int n = min(st.cnt[u], st.cap);
  float tv;
  int tl;
  if (cutoff_by_buckets(pv, pl, n, depth, hist, lane, tv, tl)) {
    // keep the slots at or ahead of (tv, tl): exactly depth, compacted in
    // slot order as below
    int kept = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      float v = 0.f;
      int id = 0;
      bool keep = false;
      if (i < n) {
        v = pv[i];
        id = pl[i];
        keep = ahead(v, id, tv, tl) || (v == tv && id == tl);
      }
      const unsigned bits = __ballot_sync(FULL, keep);
      __syncwarp();
      if (keep) {
        const int at = kept + __popc(bits & ((1u << lane) - 1));
        pv[at] = v;
        pl[at] = id;
      }
      kept += __popc(bits);
      __syncwarp();
    }
    if (lane == 0) {
      st.cnt[u] = depth;
      st.tv[u] = tv;
      st.tl[u] = tl;
    }
    __syncwarp();
    return;
  }
  int need = depth;
  const unsigned K = radix_select(
      hist, n, need,
      [&](int i, unsigned& k) {
        k = order_key(pv[i]);
        return true;
      },
      lane);
  // the slots at K: how many, and the highest lane among them
  int tied = 0, top = -1;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const bool at = i < n && order_key(pv[i]) == K;
    tied += __popc(__ballot_sync(FULL, at));
    if (at) top = max(top, pl[i]);
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    top = max(top, __shfl_xor_sync(FULL, top, off));
  int last = top;  // the last lane kept at K
  if (tied > need) {
    const unsigned L = radix_select(
        hist, n, need,
        [&](int i, unsigned& k) {
          k = ~(unsigned)pl[i];
          return order_key(pv[i]) == K;
        },
        lane);
    last = (int)~L;
  }
  // keep the slots ahead of (K, last) and it: exactly depth, compacted in
  // slot order, 32 at a time, each batch read before it is written (no
  // slot is written past the one it was read from)
  int kept = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    float v = 0.f;
    int id = 0;
    bool keep = false;
    if (i < n) {
      v = pv[i];
      id = pl[i];
      const unsigned k = order_key(v);
      keep = k > K || (k == K && id <= last);
    }
    const unsigned bits = __ballot_sync(FULL, keep);
    __syncwarp();
    if (keep) {
      const int at = kept + __popc(bits & ((1u << lane) - 1));
      pv[at] = v;
      pl[at] = id;
    }
    kept += __popc(bits);
    __syncwarp();
  }
  if (lane == 0) {
    st.cnt[u] = depth;
    st.tv[u] = key_value(K);
    st.tl[u] = last;
  }
  __syncwarp();
}

// One warp sorts the n slots at (v, l) by (value desc, lane asc): a
// bitonic sort over np = pow2(n) slots, those past n empty.
__device__ __forceinline__ void sort_slots(float* v, int* l, int n,
                                           int lane) {
  const int np = pow2_at_least(n);
  for (int x = n + lane; x < np; x += 32) {
    v[x] = -INFINITY;
    l[x] = NOLANE;
  }
  __syncwarp();
  for (int k = 2; k <= np; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int x = lane; x < np / 2; x += 32) {  // pair x of the stage
        const int e = ((x & ~(j - 1)) << 1) | (x & (j - 1));
        const int f = e | j;
        const float ve = v[e], vf = v[f];
        const int ie = l[e], jf = l[f];
        const bool swap =
            (e & k) == 0 ? ahead(vf, jf, ve, ie) : ahead(ve, ie, vf, jf);
        if (swap) {
          v[e] = vf;
          v[f] = ve;
          l[e] = jf;
          l[f] = ie;
        }
      }
      __syncwarp();
    }
}

// Append a scored chunk's candidates (the scores ahead of each user's
// threshold) to the users' pools, for the users in `which` (bit u of a
// thread's UB / 16): the 8 lanes of a warp that score one user reserve
// their slots with one shared-memory integer atomic. A group whose slots
// would pass the pool's end writes nothing but empty slots within it and
// returns its users' bits: they are pruned, then appended again.
template <int UB>
__device__ __forceinline__ unsigned append(const DeepState& st,
                                           const float (&acc)[UB / 16][8],
                                           unsigned which, int c0, int ty,
                                           int tx, int lane) {
  constexpr int TU = UB / 16;
  unsigned redo = 0;
#pragma unroll
  for (int u = 0; u < TU; ++u) {
    const int user = ty * TU + u;
    const float tv = st.tv[user];
    const int tl = st.tl[user];
    unsigned km = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (ahead(acc[u][j], c0 + (j >> 2) * 64 + tx * 4 + (j & 3), tv, tl))
        km |= 1u << j;
    if (!((which >> u) & 1)) km = 0;
    const int c = __popc(km);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const int x = __shfl_up_sync(FULL, incl, off, 8);
      if ((lane & 7) >= off) incl += x;
    }
    const int total = __shfl_sync(FULL, incl, 7, 8);
    int base = 0;
    if ((lane & 7) == 7 && total > 0)
      base = shared_fetch_add(st.cnt + user, total);
    base = __shfl_sync(FULL, base, 7, 8);
    if (total > 0) {
      const bool fits = base + total <= st.cap;
      if (!fits) redo |= 1u << u;
      float* pv = st.pv + (size_t)user * st.cap;
      int* pl = st.pl + (size_t)user * st.cap;
      int at = base + incl - c;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if ((km >> j) & 1) {
          if (fits) {
            pv[at] = acc[u][j];
            pl[at] = c0 + (j >> 2) * 64 + tx * 4 + (j & 3);
          } else if (at < st.cap) {
            pv[at] = -INFINITY;
            pl[at] = NOLANE;
          }
          ++at;
        }
    }
  }
  return redo;
}

// Write user u's list (its pool's best min(cnt, depth)): each slot j of
// the list as (v, l) goes to the tile's outputs, or with one piece of
// several to the piece's list, empty slots past its length n.
__device__ __forceinline__ void put_slot(int j, float v, int l, int b, int B,
                                         int depth, int tn, int t, int p,
                                         int pieces, float* __restrict__ m_out,
                                         int* __restrict__ a_out,
                                         float* __restrict__ piece_out) {
  if (pieces == 1) {
    const long long o = ((long long)j * B + b) * tn + t;
    m_out[o] = v;
    a_out[o] = l;
  } else {
    float* po = piece_out + (((long long)b * tn + t) * pieces + p) * 2 * depth;
    po[j] = v;
    reinterpret_cast<int*>(po)[depth + j] = l;
  }
}

// Output user u's list (its pool's best min(cnt, depth), in order): up to
// depth 64 each of the (at most RANK_SLOTS a lane) slots is written at
// its rank, the count of slots ahead of it (the slots passed round by
// shuffles); deeper lists are bitonic-sorted first (at 8 slots a lane the
// ranks cost more than the sort: measure_topk split). Then the user
// starts its next piece empty.
__device__ __forceinline__ void finish_user(
    const DeepState& st, int u, int b, int B, int depth, int tn, int t,
    int p, int pieces, float* __restrict__ m_out, int* __restrict__ a_out,
    float* __restrict__ piece_out, int lane) {
  if (st.cnt[u] > depth) prune_user(st, u, depth, lane);
  const int n = min(st.cnt[u], depth);
  float* v = st.pv + (size_t)u * st.cap;
  int* l = st.pl + (size_t)u * st.cap;
  if (depth <= 32 * RANK_SLOTS) {
    float x[RANK_SLOTS];
    int ix[RANK_SLOTS], rk[RANK_SLOTS];
#pragma unroll
    for (int h = 0; h < RANK_SLOTS; ++h) {
      const int j = lane + 32 * h;
      x[h] = j < n ? v[j] : -INFINITY;
      ix[h] = j < n ? l[j] : NOLANE;
      rk[h] = 0;
    }
    for (int j = 0; j < n; ++j) {
      float vj = x[0];
      int lj = ix[0];
#pragma unroll
      for (int h = 1; h < RANK_SLOTS; ++h)
        if ((j >> 5) == h) {
          vj = x[h];
          lj = ix[h];
        }
      vj = __shfl_sync(FULL, vj, j & 31);
      lj = __shfl_sync(FULL, lj, j & 31);
#pragma unroll
      for (int h = 0; h < RANK_SLOTS; ++h)
        rk[h] += ahead(vj, lj, x[h], ix[h]);
    }
    if (b < B) {
#pragma unroll
      for (int h = 0; h < RANK_SLOTS; ++h) {
        const int j = lane + 32 * h;
        if (j < n)
          put_slot(rk[h], x[h], ix[h], b, B, depth, tn, t, p, pieces, m_out,
                   a_out, piece_out);
        else if (j < depth)
          put_slot(j, -INFINITY, NOLANE, b, B, depth, tn, t, p, pieces,
                   m_out, a_out, piece_out);
      }
    }
  } else {
    sort_slots(v, l, n, lane);
    if (b < B)
      for (int j = lane; j < depth; j += 32)
        put_slot(j, j < n ? v[j] : -INFINITY, j < n ? l[j] : NOLANE, b, B,
                 depth, tn, t, p, pieces, m_out, a_out, piece_out);
  }
  __syncwarp();
  if (lane == 0) {
    st.tv[u] = -INFINITY;
    st.tl[u] = NOLANE;
    st.cnt[u] = 0;
  }
  __syncwarp();
}

template <int DT, int UB>
__global__ void __launch_bounds__(THREADS, 1)
tile_topk_deep_kernel(const void* __restrict__ P, const void* __restrict__ Q,
                      const float* __restrict__ sb, float* __restrict__ m_out,
                      int* __restrict__ a_out, float* __restrict__ scratch,
                      float* __restrict__ piece_out, int B, int K, int tile,
                      int depth, int tn, int n_ub, int S, int pieces) {
  constexpr int TU = UB / 16;      // users a thread scores
  constexpr int UW = UB / DWARPS;  // users a warp selects for
  const Layout<DT, UB, 2> lay{K};
  extern __shared__ float4 smem4[];
  float* pt = reinterpret_cast<float*>(smem4);  // (K, UB) users, k-major
  uint32_t* raw = reinterpret_cast<uint32_t*>(pt + lay.users());
  float* qt = reinterpret_cast<float*>(raw + lay.raw());  // (K, QP)
  DeepState st;
  st.cap = pool_slots(depth);
  st.tv = qt + lay.chunk();
  st.tl = reinterpret_cast<int*>(st.tv + UB);
  st.cnt = st.tl + UB;
  st.hist = st.cnt + UB;
  // the pools: after the histograms (4 words of padding: 16-byte aligned),
  // or in the scratch
  float* pools =
      scratch != nullptr
          ? scratch + (size_t)blockIdx.x * UB * 2 * st.cap
          : reinterpret_cast<float*>(st.hist + DWARPS * RADIX + 4);
  st.pv = pools;  // (UB, cap) values, then (UB, cap) lanes
  st.pl = reinterpret_cast<int*>(pools + (size_t)UB * st.cap);

  const int tid = threadIdx.x;
  const int s = blockIdx.x / n_ub, ub = blockIdx.x - s * n_ub;
  const int u0 = ub * UB;
  const int W = lay.row_words(), RWP = lay.raw_pitch();
  const int cpt = tile / CH;
  const int items = tn * pieces;  // (tile, piece) work items
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);

  // the block's items are s, s + S, ...; item w is piece w % pieces of
  // tile w / pieces
  int w = s;
  int t = w / pieces, p = w - t * pieces;
  int c = piece_first(p, cpt, pieces), c_end = piece_first(p + 1, cpt, pieces);
  issue_chunk(raw, Q, (long long)t * tile + (long long)c * CH, W, RWP);
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
  if (tid < UB) {
    st.tv[tid] = -INFINITY;
    st.tl[tid] = NOLANE;
    st.cnt[tid] = 0;
  }
#ifdef MFX_TOPK_STAMPS
  __shared__ long long tk_st[TK_N];
  __shared__ long long tk_last;
  if (tid == 0) {
    for (int k = 0; k < TK_N; ++k) tk_st[k] = 0;
    tk_last = clock64();
  }
#endif

  float acc[TU][8];
  unsigned redo = 0;      // users whose last chunk did not all fit
  int last_t = t, last_p = p, last_c0 = 0;  // the last chunk scored
  bool ended = false;     // ... and whether it closed its piece
  bool have = true;       // chunk c of item w is in flight
  for (;;) {
    cp_async_wait_all();
    // the last chunk is appended; chunk c has landed
    const bool over = __syncthreads_or(redo != 0);
    TOPK_STAMP(TK_WAIT);
    if (over) {  // prune the pools that overflowed, then add what did not fit
      for (int i = 0; i < UW; ++i) {
        const int u = warp * UW + i;
        if (st.cnt[u] > st.cap) prune_user(st, u, depth, lane);
      }
      __syncthreads();
      redo = append<UB>(st, acc, redo, last_c0, ty, tx, lane);
      __syncthreads();
      TOPK_STAMP(TK_PRUNE);
    }
    if (ended) {  // the piece's lists
      for (int i = 0; i < UW; ++i) {
        const int u = warp * UW + i;
        finish_user(st, u, u0 + u, B, depth, tn, last_t, last_p, pieces,
                    m_out, a_out, piece_out, lane);
      }
      ended = false;
      TOPK_STAMP(TK_FINISH);
    }
    if (!have) break;
    convert_chunk<DT>(qt, raw, K, RWP);
    __syncthreads();
    // the next chunk: on in this piece, or the block's next item
    int t1 = t, p1 = p, c1 = c + 1, e1 = c_end;
    bool more = true;
    if (c1 == c_end) {
      more = w + S < items;
      if (more) {
        w += S;
        t1 = w / pieces;
        p1 = w - t1 * pieces;
        c1 = piece_first(p1, cpt, pieces);
        e1 = piece_first(p1 + 1, cpt, pieces);
      }
    }
    if (more)  // lands while this chunk is scored and selected
      issue_chunk(raw, Q, (long long)t1 * tile + (long long)c1 * CH, W, RWP);
    TOPK_STAMP(TK_CONVERT);
    const int c0 = c * CH;
    score_chunk<DT, UB>(acc, pt, qt, sb, K, ty, tx, t, tile, c0);
    TOPK_STAMP(TK_SCORE);
    redo = append<UB>(st, acc, 0xffffffffu, c0, ty, tx, lane);
    TOPK_STAMP(TK_APPEND);
#ifdef MFX_TOPK_STAMPS
    if (tid == 0) atomicAdd(g_tk + TK_N, 1ull);
#endif
    ended = c + 1 == c_end;
    last_t = t;
    last_p = p;
    last_c0 = c0;
    t = t1;
    p = p1;
    c = c1;
    c_end = e1;
    have = more;
  }
#ifdef MFX_TOPK_STAMPS
  if (tid == 0)
    for (int k = 0; k < TK_N; ++k)
      atomicAdd(g_tk + k, (unsigned long long)tk_st[k]);
#endif
}

// The pieces' lists of each (user, tile) merged in piece order: one warp a
// pair, lane p holding piece p's head; `depth` rounds of a shuffle argmax
// on (value desc, lane asc), the piece that held the best advancing.
// Lanes differ across pieces, so the order is total and the merge exact.
__global__ void __launch_bounds__(THREADS)
tile_topk_merge_kernel(const float* __restrict__ piece_out,
                       float* __restrict__ m_out, int* __restrict__ a_out,
                       int B, int tn, int pieces, int depth) {
  const long long gw =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= (long long)B * tn) return;
  const int b = (int)(gw / tn), t = (int)(gw - (long long)b * tn);
  const float* lv = piece_out + (gw * pieces + lane) * 2 * depth;
  const int* li = reinterpret_cast<const int*>(lv + depth);
  int h = 0;
  float v = -INFINITY;
  int id = NOLANE;
  if (lane < pieces) {
    v = lv[0];
    id = li[0];
  }
  for (int j = 0; j < depth; ++j) {
    float bv = v;
    int bi = id;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (ahead(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      const long long o = ((long long)j * B + b) * tn + t;
      m_out[o] = bv;
      a_out[o] = bi;
    }
    if (lane < pieces && id == bi && id != NOLANE) {
      ++h;
      v = h < depth ? lv[h] : -INFINITY;
      id = h < depth ? li[h] : NOLANE;
    }
  }
}

// Sets a kernel's dynamic shared memory cap to the most the device allows
// beside its static shared memory: the same value on every launch, so that
// threads launching at once cannot lower it under each other.
template <class Kernel>
cudaError_t set_smem_cap(Kernel kernel, int optin) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)fa.sharedSizeBytes);
}

// The deep form's block forms: 64 users a block, or 32 (where 64 users'
// pools do not fit in shared memory beside the rest but 32 users' do).
enum { FORM_64 = 0, FORM_32 = 1 };

template <int DT>
size_t form_smem(int form, int K, int depth, bool pools_shared) {
  return form == FORM_64 ? deep_smem<DT, 64>(K, depth, pools_shared)
                         : deep_smem<DT, 32>(K, depth, pools_shared);
}

template <int DT, class Fn>
int with_deep_form(int form, Fn&& fn) {
  if (form == FORM_64) return fn(tile_topk_deep_kernel<DT, 64>, 64);
  return fn(tile_topk_deep_kernel<DT, 32>, 32);
}

// The deep form's plan on this device: out[0] SMs, out[1] blocks an SM,
// out[2] 1 where the pools live in shared memory, out[3] users a block,
// out[4] a pool's slots, out[5] the block form. The rule: the
// pools (8 bytes a slot, depth + 128 slots a user: 96 KB for 64 users at
// depth 64) in shared memory beside the users and the two chunk buffers
// (95 KB at K = 72 in f32) with 64 users a block where they fit (depth up
// to about 70), else with 32 (up to about 300), else in a device scratch,
// one region a block, with 64 (pools = 0: this rule; 1 shared memory or
// an error; 2 the scratch). Returns a CUDA error, or 0.
template <int DT>
int deep_info(int K, int depth, int pools, int* out) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int form = FORM_64;
  bool shared = false;
  if (pools != 2) {  // the pools in shared memory, where a form fits them
    const int forms[2] = {FORM_64, FORM_32};
    for (int f : forms)
      if (!shared && form_smem<DT>(f, K, depth, true) <= (size_t)optin) {
        form = f;
        shared = true;
      }
    if (pools == 1 && !shared) return (int)cudaErrorInvalidValue;
    if (!shared) form = FORM_64;
  }
  const size_t smem = form_smem<DT>(form, K, depth, shared);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  err = (cudaError_t)with_deep_form<DT>(form, [&](auto kernel, int) {
    cudaError_t e = set_smem_cap(kernel, optin);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
    return (int)e;
  });
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  out[0] = sms;
  out[1] = per_sm;
  out[2] = shared;
  out[3] = form == FORM_64 ? 64 : 32;
  out[4] = pool_slots(depth);
  out[5] = form;
  return 0;
}

template <int DT>
int launch_deep(const void* P, const void* Q, const float* sb, float* m_out,
                int* a_out, float* scratch, float* piece_out, int B, int ipad,
                int K, int tile, int depth, int form, int shared, int pieces,
                int S, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = form_smem<DT>(form, K, depth, shared != 0);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int tn = ipad / tile;
  err = (cudaError_t)with_deep_form<DT>(form, [&](auto kernel, int ub) {
    cudaError_t e = set_smem_cap(kernel, optin);
    if (e != cudaSuccess) return (int)e;
    const int n_ub = (B + ub - 1) / ub;
    kernel<<<n_ub * S, THREADS, smem, st>>>(
        P, Q, sb, m_out, a_out, shared ? nullptr : scratch, piece_out, B, K,
        tile, depth, tn, n_ub, S, pieces);
    return (int)cudaGetLastError();
  });
  if (err != cudaSuccess || pieces == 1) return (int)err;
  const long long threads = (long long)B * tn * 32;
  tile_topk_merge_kernel<<<(unsigned)((threads + THREADS - 1) / THREADS),
                           THREADS, 0, st>>>(piece_out, m_out, a_out, B, tn,
                                             pieces, depth);
  return (int)cudaGetLastError();
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

// The deep form's plan on this device (deep_info): out[0] SMs, out[1]
// blocks an SM, out[2] 1 where the pools live in shared memory, out[3]
// users a block, out[4] a pool's slots, out[5] the block form.
// pools: 0 as the launch chooses, 1 shared memory (an error where they do
// not fit), 2 the device scratch (measure_topk deep times the two).
// kernels/serve_topk.py plans the launch from these.
extern "C" int mfx_tile_topk_deep_info(int K, int depth, int dtype,
                                       int pools, int* out) {
  if (K <= 0 || K % 8 || K > MAX_K || depth < 1 || pools < 0 || pools > 2 ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case DT_F32:
      return deep_info<DT_F32>(K, depth, pools, out);
    case DT_BF16:
      return deep_info<DT_BF16>(K, depth, pools, out);
    case DT_INT8:
      return deep_info<DT_INT8>(K, depth, pools, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The deep form: any 1 <= depth <= tile and any tile that is a multiple
// of 128, the rest as mfx_tile_topk. form and shared (whether the pools
// live in shared memory) come from mfx_tile_topk_deep_info; pieces (a
// tile's chunks cut into that many pieces, 1-32) and S (work items a user
// block's blocks stride by) from serve_topk.deep_split. scratch:
// scratch_words f32 words, the pools of n_ub * S blocks (users a block *
// 2 * slots words each) where they are not in shared memory; piece_out:
// piece_words words, (B, tiles, pieces, 2 * depth) piece lists where
// pieces > 1 (then a second launch merges them into m_out / a_out).
extern "C" int mfx_tile_topk_deep(const void* P, const void* Q,
                                  const float* sb, float* m_out, int* a_out,
                                  float* scratch, long long scratch_words,
                                  float* piece_out, long long piece_words,
                                  int B, int ipad, int K, int tile, int depth,
                                  int dtype, int form, int shared, int pieces,
                                  int S, void* stream) {
  if (B < 0 || K <= 0 || K % 8 || K > MAX_K || tile <= 0 || tile % CH ||
      ipad < 0 || ipad % tile || depth < 1 || depth > tile ||
      (dtype == DT_INT8 && sb == nullptr) || form < FORM_64 ||
      form > FORM_32 || shared < 0 || shared > 1 ||
      pieces < 1 || pieces > min(tile / CH, MAX_PIECES) || S < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || ipad == 0) return 0;
  const long long ub = form == FORM_64 ? 64 : 32;
  const long long tn = ipad / tile, n_ub = (B + ub - 1) / ub;
  if (S > tn * pieces ||
      (!shared &&
       (scratch == nullptr ||
        scratch_words < n_ub * S * ub * 2 * (long long)pool_slots(depth))) ||
      (pieces > 1 && (piece_out == nullptr ||
                      piece_words < (long long)B * tn * pieces * 2 * depth)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return launch_deep<DT_F32>(P, Q, sb, m_out, a_out, scratch, piece_out,
                                 B, ipad, K, tile, depth, form, shared,
                                 pieces, S, st);
    case DT_BF16:
      return launch_deep<DT_BF16>(P, Q, sb, m_out, a_out, scratch, piece_out,
                                  B, ipad, K, tile, depth, form, shared,
                                  pieces, S, st);
    case DT_INT8:
      return launch_deep<DT_INT8>(P, Q, sb, m_out, a_out, scratch, piece_out,
                                  B, ipad, K, tile, depth, form, shared,
                                  pieces, S, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#ifdef MFX_TOPK_STAMPS
// The measurement build's sums (TK_N phases' cycles over the deep blocks,
// then the chunks) into out; reset: then zero them.
extern "C" int mfx_tile_topk_stamps(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_tk, sizeof(g_tk));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[TK_N + 1] = {};
    err = cudaMemcpyToSymbol(g_tk, zero, sizeof(zero));
  }
  return (int)err;
}
#endif
