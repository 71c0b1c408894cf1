// Dense-stratum SGD phase in three bias forms: lane-carried biases,
// frozen biases and none; int4 rating codes at ranks 32 and 64, int8 codes
// at ranks 32, 64 and 128.
//
// Replaces: mfx/kernels/dense_pallas.py::_kernel_body (rfmt='int4' or
// 'int8') with lane=True (the lane form), with use_bias=True, lane=False
// (frozen) and with use_bias=False (none), its echo passes in the lane and
// bias-free forms, driven by dense_sgd_phase_pallas. Its spg batching has
// no form here: the null strata it pads with are exact no-ops, so the
// prep carves none (solvers/dense_prep.py::prepare_dense_full).
//
// What it computes, per dense stratum (user block a = sa[s], item window
// c = sc[s]), strata in plan order, each a snapshot minibatch:
//   S = P_blk Q_winᵀ                       (su x si, from the snapshot)
//   E = [code > 0] ∘ ((code · c − S) − mu)  lane (biases ride in S) and
//                                            none; c = 1/2 for int4,
//                                            f32(1/25) for int8
//   E = [code > 0] ∘ ((((code · c − S) − bu) − bi) − mu)   frozen, with
//       bu = bu[a su + row] and bi = bi[c si + col] read from vectors that
//       nothing writes during the launch (the group's biases at its start)
//   P_blk += lr s_u ∘ (E Q_win − reg Du ∘ P_blk), lane rank-2 frozen in
//            the lane form only
//   Q_win += lr s_i ∘ (Eᵀ P_blk − reg Di ∘ Q_win), lane rank-1 frozen in
//            the lane form only
//   s = min(1, DSTAR / max(deg, 1)), DSTAR = 16; Du/Di = per-stratum raw
//   rating degrees; sse += Σ E² (first-pass semantics)
//   echo > 1 (lane and none): the whole step is taken echo times on each
//   stratum before the next, each pass from the tables the pass before it
//   wrote; sse counts the first pass only. The launch's work is then
//   nd * echo slots: slot k runs stratum k / echo (its sa, sc, codes and
//   degrees), and the group's dependency table, one "tile" a slot
//   (plan_device.SweepDeps.repeat), chains a stratum's passes as it chains
//   the strata of one user block. A slot that is not a first pass writes 0
//   to its pieces' SSE.
//   frozen only: dbu[s, row] = Σ_col E, dbi[s, col] = Σ_row E, from which
//   the trainer applies one batched bias update after the group
// R holds int4 codes round(2 r), 0 = absent, plain (su, si/2) bytes per
// stratum with the even column in the low nibble; or int8 codes
// round(25 r), plain (su, si) bytes per stratum. The kernel is a template
// over the rank (32, 64, 128) and the code format; rank 128 takes int8
// only, as the reference does. At rank 128 the snapshot rows and a thread's
// dP and dQ outputs double (lanes 4 tx + n and 64 + 4 tx + n), and an apply
// unit owns 128 rows (64 where 128 does not divide si). At rank 32 a row
// is 8 lane quads: a thread owns 2 rows (or columns) of dP and dQ, one
// lane quad each, tx's upper half taking the band's rows 32-63 (Form), and
// an apply unit owns 256 rows as at rank 64.
//
// Form: one persistent launch a dense group. Its blocks take work units
// by an integer ticket; a stratum is 2 pieces of each of its su/64 row
// panels and then si/256 at ranks 32 and 64, si/128 at rank 128 (twice as
// many where that does not divide si) Q-apply units. Strata are handed out in
// an order the wrapper gives (from the group's dependency table), or plan
// order without a table.
// - A piece of a row panel owns 64 rows of P_blk and half of Q_win's
//   64-column chunks. Per chunk it builds S and E for its rows from the
//   snapshot, adds the chunk's E Q to its rows' dP (registers; the second
//   piece writes each chunk's E Q to scratch instead), and writes the
//   chunk's Eᵀ P_band to the stratum's slot of a ring of dQ partials
//   (the unit's design is under "What bounds it"). The
//   last piece of a panel to finish adds the first piece's dP and the
//   other chunks' partials in chunk order, writes the panel's own P rows
//   (no other unit of the stratum reads them) and counts the panel done.
// - A Q-apply unit owns 256 (or 128) rows of Q_win at ranks 32 and 64,
//   half as many at rank 128. It waits until every panel of its stratum is done,
//   adds the partials in panel order, and writes its Q rows. The last
//   apply unit to finish publishes the stratum's end.
// - Two strata conflict only if they share a user block or a window
//   (the group's dependency table, plan_device.sweep_deps with one "tile"
//   a stratum): every panel unit of stratum s waits for its user block's
//   previous stratum, for the stratum the table names, and for the
//   stratum handed out `ring` places before it, whose slot of the ring it
//   reuses. The order puts every stratum after those it waits for, so
//   every wait names a smaller ticket, which a running block holds: any
//   grid is free of deadlock, and strata whose user blocks and windows
//   differ run at once.
// - Frozen form, the bias sums: per chunk, a panel piece sums each of
//   its 64 rows of E over the chunk's 64 columns (column order, from 0)
//   and adds that to the row's running sum (chunk order); the last piece
//   of the panel writes dbu = piece 0's sum + piece 1's. It also sums each
//   of the chunk's 64 columns over its 64 rows (row order, from 0) into a
//   ring beside the dQ partials' (one value a column and panel), and the
//   apply unit that owns the columns adds them in panel order into dbi.
// Every value keeps the order of the one-stratum-at-a-time walk: S is a
// fma chain over k = 0..rank-1 from 0, a dP or dQ partial a chain over the
// 64 columns of a chunk or the 64 rows of a panel, partials are added
// from 0 in chunk or panel order, then p + lr·scale·(g − reg·deg·p), and
// the bias sums are added in the fixed orders above. So the tables (and
// dbu, dbi) are bit for bit the same on any grid (the lane form's also
// those of the earlier two-launches-a-stratum form of this file); the SSE
// is summed per piece and added in unit order by a second small kernel.
// No float atomics.
//
// Memory ordering: P and Q rows are rewritten by other SMs inside the
// launch, so every load of them, and of the partials, goes to L2
// (__ldcg, or cp.async.cg for the band and the chunks), and P and Q are
// not const __restrict__. A panel makes its
// rows and partials visible by barrier, __threadfence() and an atomic
// count; an apply unit reads the count with ld.acquire.gpu; the stratum's
// end is published by barrier, __threadfence() and st.release.gpu, and
// waited for with ld.acquire.gpu (sweep_common.cuh).
//
// What bounds it on an H100: the three rank-deep products per cell are
// 3 * 2 * su * si * rank FLOP a stratum (0.4 GFLOP at 1024² and rank 64,
// 6.0 µs of f32 FMA on the whole card; 0.2 GFLOP, 3.0 µs at 512² and rank
// 128) against su*si/2 (int4) or su*si (int8) bytes of R: compute. A
// group's time is the larger of its work over the card and its longest
// chain of strata, so a unit must be both efficient and short.
// The unit, from its clock64() breakdown (measure_wavefront unit):
// the earlier unit spent 30% of its time in S and E, 21% each in E Q and
// Eᵀ P, at about half of the SM's FMA rate, with three barriers a chunk and
// the next chunk staged through registers. Now:
// - one pass of fused products a chunk (fused_chunk): S of the next chunk
//   beside E Q and Eᵀ P of this one, their steps interleaved, so a warp
//   has three independent sets of fmaf chains to issue while its shared
//   loads land (64 FMAs per eight 16-byte loads in each set, 4 x 4 outputs
//   a thread, each load one wavefront for the warp);
// - the band and the chunks copied by cp.async (no register staging), the
//   chunk two ahead landing in a third buffer while one is worked on and
//   the next one's S is computed; E stored once (Eᵀ P reads its columns,
//   a thread's dQ columns consecutive) in two buffers, this chunk's and
//   the next one's: one barrier a chunk;
// - one block of 256 threads an SM (up to 255 registers a thread, 113 KB
//   of shared memory at rank 64). Two blocks an SM (128 registers)
//   raised the SM's FMA rate but doubled each unit's time, and with it the
//   chain of strata: group 0 of ml25m_rank64 took longer. Products split
//   over three warp groups with 8 x 4 and 8 x 8 tiles (fewer loads a FMA)
//   were slower still: two warps a product cannot hide their loads'
//   latency (PERF.md §6).
// The products stay bound by the shared loads: a warp's 16-byte load
// takes the shared memory four cycles whatever it broadcasts, so at 4 x 4
// outputs a thread (eight loads a 64 FMAs) they run at about half of the
// FMA rate.
// The fixed orders stay: every chain keeps its order, only the chains'
// steps are interleaved. The two pieces a panel stay: the SSE is summed
// per piece, so another cut would change its bits.

#include <type_traits>

#include "sweep_common.cuh"

namespace {

constexpr int BAND = 64;      // P_blk rows of a panel unit
constexpr int CH = 64;        // Q_win columns of a chunk
constexpr int PIECES = 2;     // pieces a row panel is cut into
constexpr int TPITCH = BAND + 4;  // the frozen form's Eᵀ rows: 4 banks
                                 // a row, so row sums read no conflict
constexpr int EPITCH = CH + 8;  // shared row pitch of E in floats: 8
                                // banks a row, so rows ty..ty+3 of a warp's
                                // E stores and float4 loads never collide
constexpr int NT = 256;       // 16 x 16 threads
constexpr float DSTAR = 16.f;

// the bias forms (the wrapper's 'lane', 'frozen', 'none')
constexpr int LANE = 0, FROZEN = 1, NONE = 2;

// Measurement-only build (nvcc -DMFX_DENSE_STAMPS, kernels/_build.py's
// "dense_stamps" variant, driven by measure_wavefront unit): thread 0 of
// each block adds clock64() deltas to one sum a phase, each stamp behind
// a __syncthreads() (so a phase's time is its slowest thread's, and the
// build has barriers the default one lacks); the sums over the blocks and
// the unit counts go to g_stamps. The default build carries none of it.
enum {
  ST_TICKET,      // from a unit's end to the next ticket
  ST_WAIT,        // a panel piece waiting for its stratum's turn
  ST_SNAPSHOT,    // the P band and the first chunks landing
  ST_E,           // S and E of the first chunk; then a chunk's E of the
                  // next one, its copy's wait and the chunk's barrier
  ST_FMA,         // a chunk's fused products (S of the next, E Q, E^T P)
  ST_STORE,       // a chunk's partials written, the frozen form's sums
  ST_PIECE_END,   // the piece's SSE, dP tile and count
  ST_LAST,        // the last piece's sums and P rows
  ST_APPLY_WAIT,  // an apply unit waiting for its stratum's panels
  ST_APPLY,       // an apply unit's sums and Q rows
  ST_N
};
#ifdef MFX_DENSE_STAMPS
// per phase the blocks' cycles, then panel pieces, apply units, chunks
__device__ unsigned long long g_stamps[ST_N + 3];
#define DENSE_STAMP(sm, k)                                 \
  do {                                                     \
    __syncthreads();                                       \
    if (threadIdx.x == 0) {                                \
      const long long t_ = clock64();                      \
      (sm).st[k] += t_ - (sm).st_last;                     \
      (sm).st_last = t_;                                   \
    }                                                      \
  } while (0)
#define DENSE_COUNT(i)                                           \
  do {                                                           \
    if (threadIdx.x == 0) atomicAdd(g_stamps + ST_N + (i), 1ull); \
  } while (0)
#else
#define DENSE_STAMP(sm, k) \
  do {                     \
  } while (0)
#define DENSE_COUNT(i) \
  do {                 \
  } while (0)
#endif

// The kernel's shapes at rank RANK with int8 (INT8) or int4 codes.
// A thread's part of dP and dQ (64 rows, or columns, by RANK lanes): MR
// rows r0 + 16 m and the lanes 64 h + 4 lx + n of each, with
// lx = tx % TXL and r0 = ty + 16 MR (tx / TXL). At ranks 64 and 128 that is
// 4 rows ty + 16 m and 4 LQ lanes; at rank 32 (8 lane quads a row) the
// upper half of tx takes the band's rows 32-63, 2 rows a thread.
template <int RANK, bool INT8>
struct Form {
  static constexpr int R4 = RANK / 4;      // float4 a row
  static constexpr int TXL = RANK < 64 ? R4 : 16;  // tx across a row's lanes
  static constexpr int LQ = RANK < 64 ? 1 : RANK / 64;  // lane quads a
                                                        // thread owns a row
  static constexpr int MR = 4 * TXL / 16;  // rows a thread owns
  static constexpr int PITCH = RANK + 4;   // shared row pitch in floats
                                           // (16-byte rows)
  static constexpr int CODE_ROW = INT8 ? CH : CH / 2;  // code bytes of a
                                                       // chunk row
  static constexpr int CODE_U4 = BAND * CODE_ROW / 16;  // uint4 a chunk
  static constexpr int QROWS = RANK < 64 ? 256 : 256 * 64 / RANK;
                                       // Q_win rows of an apply unit (half
                                       // where it does not divide si)
  static constexpr float SCALE = INT8 ? 0.04f : 0.5f;  // code -> rating

  static __device__ __forceinline__ int row_bytes(int si) {
    return INT8 ? si : si / 2;
  }
  static __host__ __device__ __forceinline__ int apply_rows(int si) {
    return si % QROWS == 0 ? QROWS : QROWS / 2;
  }
};

template <int RANK, bool INT8>
struct Smem {
  using F = Form<RANK, INT8>;
  float Pr[BAND * F::PITCH];   // P_band snapshot, row-major
  float Qr[3][CH * F::PITCH];  // three chunks' Q rows, row-major
  float E[2][BAND * EPITCH];   // two chunks' E[r][c], once each
  float Et[2][CH * TPITCH];    // frozen form: the same E[c][r], for the
                               // row sums
  uint4 Rs[3][F::CODE_U4];     // three chunks' codes
  float red[NT / 32];
  int ticket;
  int flag;
#ifdef MFX_DENSE_STAMPS
  long long st[ST_N];
  long long st_last;
#endif
};

// The frozen form's bias inputs and outputs (all null in the other forms).
struct BiasSums {
  const float* bu;  // (A su,) user biases, read only
  const float* bi;  // (nwin si,) the segment's item biases, read only
  float* dbu;       // (nd, su) row sums of E
  float* dbi;       // (nd, si) column sums of E
  float* rs_buf;    // (ring, nb, PIECES, BAND) a panel piece's row sums
  float* cs_buf;    // (ring, nb, si) a panel's column sums
};

// The schedule's "strata" are slots: nd = strata * echo, slot s running
// stratum s / echo's pass s % echo.
struct DenseSched {
  const int* runs;  // (nruns, 2) first slot and slots of each user block
  const int* wait;  // (nd, 3) the table's (run, finished slots) per
                    // slot, run < 0 for none; null: every slot waits for
                    // the one before it
  const int* order;  // (nd,) the slots in the order they are handed
                     // out; null: plan order
  int* state;       // zeroed per launch: [0] the ticket, then per slot
                    // its panels done, its apply units done, its end,
                    // then per (slot, panel) its pieces done
  int nruns, nd, ring, echo;
};

__device__ __forceinline__ float update(float p, float g, float deg,
                                        float scale, bool frozen, float lr,
                                        float reg) {
  const float d = frozen ? 0.f : g - reg * deg * p;
  return p + lr * scale * d;
}

// The float4 at row `row`, column `col` of a (rows, PITCH) shared array.
template <int PITCH>
__device__ __forceinline__ float4 ld4(const float* a, int row, int col) {
  return *reinterpret_cast<const float4*>(a + row * PITCH + col);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ int stratum_at(const DenseSched& ds, int pos) {
  return ds.order == nullptr ? pos : ds.order[pos];
}

// Thread 0: wait until stratum s, handed out at place pos, may read its
// rows and write its slot of the ring.
__device__ void await_stratum(const DenseSched& ds, int s, int pos) {
  const int* fin = ds.state + 1 + 2 * ds.nd;
  int prev = s - 1, named = -1;
  if (ds.wait != nullptr) {
    int lo = 0, hi = ds.nruns - 1;  // the run of s
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (ds.runs[2 * mid] <= s) lo = mid; else hi = mid - 1;
    }
    if (s == ds.runs[2 * lo]) prev = -1;
    const int w = ds.wait[3 * s];
    if (w >= 0) named = ds.runs[2 * w] + ds.wait[3 * s + 1] - 1;
  }
  const int before[3] = {
      prev, named, pos >= ds.ring ? stratum_at(ds, pos - ds.ring) : -1};
  for (int x : before)
    if (x >= 0)
      while (mfx_sweep::ld_acquire(fin + x) == 0) __nanosleep(64);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               : : "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" : : : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" : : : "memory");
}

// every copy group but the last one issued has landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" : : : "memory");
}

// Start copying chunk ch's Q rows and codes into buffer b (cp.async.cg:
// 16 bytes a copy, through L2 only, so rows other SMs rewrite are read
// from L2 as the __ldcg loads read them). One commit group.
template <int RANK, bool INT8>
__device__ __forceinline__ void issue_chunk(Smem<RANK, INT8>& sm, int b,
                                            const float* Q, long long qrow,
                                            const uint8_t* Rb, int si,
                                            int ch) {
  using F = Form<RANK, INT8>;
  constexpr int R4 = F::R4;
  constexpr int SHIFT = INT8 ? 2 : 1;  // log2 of the uint4 a chunk row
  static_assert(F::CODE_ROW == 16 << SHIFT, "a chunk row is 2 or 4 uint4");
  const int tid = threadIdx.x;
  const float4* Q4 = reinterpret_cast<const float4*>(Q);
#pragma unroll
  for (int t = 0; t < RANK / 16; ++t) {
    const int idx = tid + t * NT, row = idx / R4, q = idx % R4;
    cp_async16(&sm.Qr[b][row * F::PITCH + 4 * q],
               Q4 + (qrow + ch * CH + row) * R4 + q);
  }
  if (tid < F::CODE_U4)
    cp_async16(&sm.Rs[b][tid],
               Rb + (long long)(tid >> SHIFT) * F::row_bytes(si) +
                   ch * F::CODE_ROW + (tid & ((1 << SHIFT) - 1)) * 16);
  cp_async_commit();
}

// The code of row r, column c of the chunk in shared memory.
template <bool INT8>
__device__ __forceinline__ int code_at(const uint8_t* Rs, int r, int c) {
  if (INT8) return Rs[r * CH + c];
  const uint8_t byte = Rs[r * (CH / 2) + (c >> 1)];
  return (c & 1) ? (byte >> 4) : (byte & 15);
}

// A 64 x RANK tile of dP in device memory, [row][lane], from / into the
// registers of the thread whose part is rows r0 + 16m, lanes 64h + 4lx + n
// (Form), held at [m][4h + n].
template <int RANK, int MR, int LQ>
__device__ __forceinline__ void store_tile(float* t,
                                           const float (&v)[MR][4 * LQ],
                                           int r0, int lx) {
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int h = 0; h < LQ; ++h)
      __stcg(reinterpret_cast<float4*>(t + (r0 + 16 * m) * RANK + 64 * h +
                                       4 * lx),
             make_float4(v[m][4 * h], v[m][4 * h + 1], v[m][4 * h + 2],
                         v[m][4 * h + 3]));
}

template <int RANK, int MR, int LQ>
__device__ __forceinline__ void load_tile(float (&v)[MR][4 * LQ],
                                          const float* t, int r0, int lx) {
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int h = 0; h < LQ; ++h) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          t + (r0 + 16 * m) * RANK + 64 * h + 4 * lx));
      v[m][4 * h] = x.x;
      v[m][4 * h + 1] = x.y;
      v[m][4 * h + 2] = x.z;
      v[m][4 * h + 3] = x.w;
    }
}

// S of a chunk for rows ty + 16m and columns tx + 16n: an fmaf chain over
// k = 0..RANK-1 from 0.
template <int RANK, bool INT8>
__device__ __forceinline__ void chunk_s(float (&acc)[4][4], const float* Pr,
                                        const float* Qc, int ty, int tx) {
  constexpr int PITCH = Form<RANK, INT8>::PITCH;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
#pragma unroll
  for (int k = 0; k < RANK; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = ld4<PITCH>(Pr, ty + 16 * m, k);
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = ld4<PITCH>(Qc, tx + 16 * q, k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[m][q] = fmaf(comp(a[m], kk), comp(b[q], kk), acc[m][q]);
  }
}

// E of a chunk from its S (rows ty + 16m, columns tx + 16n) into E, and
// the thread's SSE chain.
template <int RANK, bool INT8, int BIAS>
__device__ __forceinline__ void chunk_e(float* E, float* Et,
                                        const float (&acc)[4][4],
                                        const uint4* Rs4, const float (&bur)[4],
                                        const float (&bic)[4], float mu,
                                        int ty, int tx, float& sq) {
  using F = Form<RANK, INT8>;
  const uint8_t* Rs = reinterpret_cast<const uint8_t*>(Rs4);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = ty + 16 * m;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = tx + 16 * q;
      const int code = code_at<INT8>(Rs, r, c);
      float e = 0.f;
      if (code > 0) {
        if (BIAS == FROZEN)
          e = ((((float)code * F::SCALE - acc[m][q]) - bur[m]) - bic[q]) - mu;
        else
          e = ((float)code * F::SCALE - acc[m][q]) - mu;
      }
      E[r * EPITCH + c] = e;
      if (BIAS == FROZEN) Et[c * TPITCH + r] = e;
      sq = fmaf(e, e, sq);
    }
  }
}

// One pass over a chunk's products, their steps interleaved so that a
// warp has three independent sets of fmaf chains in flight: (WITH_S) S of
// the next chunk (rows ty + 16m, columns tx + 16n, over k from 0: acc),
// the chunk's dP (rows r0 + 16m, lanes 64h + 4lx + n, over its columns j
// from 0: d) and its dQ (columns cf + m, the same lanes, over the panel's
// rows from 0: e). Each chain keeps its own order.
template <int RANK, bool INT8, bool WITH_S>
__device__ __forceinline__ void fused_chunk(
    float (&acc)[4][4], float (&d)[Form<RANK, INT8>::MR][4 * Form<RANK, INT8>::LQ],
    float (&e)[Form<RANK, INT8>::MR][4 * Form<RANK, INT8>::LQ],
    const float* Pr, const float* Qn, const float* Qc, const float* E, int ty,
    int tx, int r0, int lx, int cf) {
  using F = Form<RANK, INT8>;
  constexpr int PITCH = F::PITCH, MR = F::MR, LQ = F::LQ, NO = 4 * LQ;
  constexpr int NS = RANK / 4, NP = CH / 4;  // quads of S; of dP and dQ
  constexpr int NQ = NS > NP ? NS : NP;
  static_assert(BAND == CH, "dP and dQ take as many quads");
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[m][q] = 0.f;
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int q = 0; q < NO; ++q) {
      d[m][q] = 0.f;
      e[m][q] = 0.f;
    }
#pragma unroll
  for (int s4 = 0; s4 < NQ; ++s4) {
    if (WITH_S && s4 < NS) {
      const int k = 4 * s4;
      float4 a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = ld4<PITCH>(Pr, ty + 16 * m, k);
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = ld4<PITCH>(Qn, tx + 16 * q, k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[m][q] = fmaf(comp(a[m], kk), comp(b[q], kk), acc[m][q]);
    }
    if (s4 < NP) {
      const int j = 4 * s4;  // dP: columns j..j+3; dQ: rows j..j+3
      float4 e4[MR], q4[4][LQ], p4[4][LQ];
      float ec[4][MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) e4[m] = ld4<EPITCH>(E, r0 + 16 * m, j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int h = 0; h < LQ; ++h) {
          q4[jj][h] = ld4<PITCH>(Qc, j + jj, 64 * h + 4 * lx);
          p4[jj][h] = ld4<PITCH>(Pr, j + jj, 64 * h + 4 * lx);
        }
        if constexpr (MR == 4) {
          const float4 v = ld4<EPITCH>(E, j + jj, cf);
#pragma unroll
          for (int m = 0; m < MR; ++m) ec[jj][m] = comp(v, m);
        } else {
          const float2 v =
              *reinterpret_cast<const float2*>(E + (j + jj) * EPITCH + cf);
          ec[jj][0] = v.x;
          ec[jj][MR - 1] = v.y;
        }
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int m = 0; m < MR; ++m)
#pragma unroll
          for (int h = 0; h < LQ; ++h)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              d[m][4 * h + q] = fmaf(comp(e4[m], jj), comp(q4[jj][h], q),
                                     d[m][4 * h + q]);
              e[m][4 * h + q] = fmaf(ec[jj][m], comp(p4[jj][h], q),
                                     e[m][4 * h + q]);
            }
    }
  }
}

// The frozen form's sums of a chunk's E: threads 0..63 add row tid over
// the chunk's columns in order into their running row sum (from Et, so a
// warp's reads fall in distinct banks), threads 64..127 column tid - 64
// over the panel's rows in order into the ring's column sums.
__device__ __forceinline__ void chunk_sums(const BiasSums& bs, const float* E,
                                           const float* Et, float& rsum,
                                           int tid, int pos, int ring, int nb,
                                           int band, int si, int ch) {
  if (tid >= 2 * BAND) return;
  const bool row = tid < BAND;
  const int x = row ? tid : tid - BAND;
  const float* a = row ? Et + x : E + x;
  const int step = row ? TPITCH : EPITCH;
  float t = 0.f;
#pragma unroll 8
  for (int y = 0; y < CH; ++y) t += a[y * step];
  if (row)
    rsum += t;
  else
    __stcg(bs.cs_buf + ((long long)(pos % ring) * nb + band) * si + ch * CH +
               x,
           t);
}

template <int RANK, bool INT8, int BIAS>
__device__ void panel_unit(Smem<RANK, INT8>& sm, float* P, const float* Q,
                           const int* sa, const int* sc, const uint8_t* R,
                           const float* du, float* ring_buf, float* dp_buf,
                           float* sums, const BiasSums& bs,
                           const DenseSched& ds, int s, int pos, int band,
                           int piece, int su, int si, float lr, float reg,
                           float mu) {
  using F = Form<RANK, INT8>;
  constexpr int R4 = F::R4, LQ = F::LQ, PITCH = F::PITCH, NO = 4 * LQ;
  constexpr int MR = F::MR;
  // a warp holds 4 values of ty and 8 of tx, so that each of its 16-byte
  // shared loads touches at most 128 distinct bytes (one wavefront)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  // this thread's part of dP and dQ (Form)
  const int lx = tx % F::TXL, r0 = ty + 16 * MR * (tx / F::TXL);
  const int nb = su / BAND, nch = si / CH, per_piece = nch / PIECES;
  const int c0 = piece * per_piece, c1 = c0 + per_piece;
  // the band's dP scratch: [0] piece 0's sum over its chunks, then the
  // partial of each later chunk, in chunk order
  float* dps = dp_buf + ((long long)(pos % ds.ring) * nb + band) *
                            (nch - per_piece + 1) * BAND * RANK;
  if (tid == 0) await_stratum(ds, s, pos);
  __syncthreads();
  DENSE_STAMP(sm, ST_WAIT);
  DENSE_COUNT(0);
  const int d = s / ds.echo;  // the slot's stratum
  const long long prow = (long long)sa[d] * su + band * BAND;
  const long long qrow = (long long)sc[d] * si;
  const uint8_t* Rb =
      R + ((long long)d * su + band * BAND) * F::row_bytes(si);
  float* slot =
      ring_buf + ((long long)(pos % ds.ring) * nb + band) * si * RANK;
  // the band's rows and chunk c0 (one copy group), then chunk c0 + 1
  const int n = c1 - c0;  // the piece's chunks
  const float4* P4 = reinterpret_cast<const float4*>(P);
  for (int idx = tid; idx < BAND * R4; idx += NT) {
    const int row = idx / R4, q = idx % R4;
    cp_async16(&sm.Pr[row * PITCH + 4 * q], P4 + (prow + row) * R4 + q);
  }
  issue_chunk<RANK, INT8>(sm, 0, Q, qrow, Rb, si, c0);
  if (n > 1) issue_chunk<RANK, INT8>(sm, 1, Q, qrow, Rb, si, c0 + 1);
  // frozen form: the biases of rows ty + 16m and of a chunk's columns
  // tx + 16n (the next chunk's loaded a chunk ahead), and the running row
  // sum of E of row tid (threads 0..63)
  float bur[4] = {0.f, 0.f, 0.f, 0.f}, bic[4] = {0.f, 0.f, 0.f, 0.f};
  float rsum = 0.f;
  if (BIAS == FROZEN) {
#pragma unroll
    for (int m = 0; m < 4; ++m) bur[m] = __ldg(bs.bu + prow + ty + 16 * m);
#pragma unroll
    for (int n4 = 0; n4 < 4; ++n4)
      bic[n4] = __ldg(bs.bi + qrow + c0 * CH + tx + 16 * n4);
  }

  float g[MR][NO];  // dP of rows r0 + 16m, lanes 64h + 4lx + n at
                    // [m][4h + n], over the chunks
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int q = 0; q < NO; ++q) g[m][q] = 0.f;
  float sq = 0.f;
  // the columns of this thread's dQ partial: MR consecutive ones
  const int cf = MR * (ty + 16 * (tx / F::TXL));
  if (n > 1)
    cp_async_wait_one();
  else
    cp_async_wait_all();
  __syncthreads();
  DENSE_STAMP(sm, ST_SNAPSHOT);
  float acc[4][4];  // S of rows ty + 16m and columns tx + 16n
  chunk_s<RANK, INT8>(acc, sm.Pr, sm.Qr[0], ty, tx);
  chunk_e<RANK, INT8, BIAS>(sm.E[0], sm.Et[0], acc, sm.Rs[0], bur, bic, mu,
                            ty, tx, sq);
  cp_async_wait_all();
  __syncthreads();
  DENSE_STAMP(sm, ST_E);

  // Chunk ch = c0 + i: its Q rows and codes in buffer i % 3, its E in
  // E[i % 2]. One pass of fused products: S of chunk ch + 1 (from its
  // rows, which have landed), E Q and E^T P of chunk ch; then the partials,
  // then E of chunk ch + 1, while chunk ch + 2 lands in the third buffer.
  // One barrier a chunk.
  for (int i = 0; i < n; ++i) {
    const int ch = c0 + i, qb = i % 3, qn = (i + 1) % 3, eb = i & 1;
    DENSE_COUNT(2);
    if (i + 2 < n)
      issue_chunk<RANK, INT8>(sm, (i + 2) % 3, Q, qrow, Rb, si, ch + 2);
    float bin[4] = {0.f, 0.f, 0.f, 0.f};  // frozen: chunk ch + 1's biases
    if (BIAS == FROZEN && i + 1 < n) {
#pragma unroll
      for (int n4 = 0; n4 < 4; ++n4)
        bin[n4] = __ldg(bs.bi + qrow + (ch + 1) * CH + tx + 16 * n4);
    }
    float d[MR][NO], e[MR][NO];  // the chunk's dP and dQ partials
    if (i + 1 < n)
      fused_chunk<RANK, INT8, true>(acc, d, e, sm.Pr, sm.Qr[qn],
                                    sm.Qr[qb], sm.E[eb], ty, tx, r0, lx,
                                    cf);
    else
      fused_chunk<RANK, INT8, false>(acc, d, e, sm.Pr, sm.Qr[qn],
                                     sm.Qr[qb], sm.E[eb], ty, tx, r0, lx,
                                     cf);
    DENSE_STAMP(sm, ST_FMA);
    if (piece == 0) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int q = 0; q < NO; ++q) g[m][q] += d[m][q];
    } else {
      store_tile<RANK, MR, LQ>(
          dps + (long long)(ch - per_piece + 1) * BAND * RANK, d, r0, lx);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int h = 0; h < LQ; ++h)
        __stcg(reinterpret_cast<float4*>(
                   slot + (long long)(ch * CH + cf + m) * RANK + 64 * h +
                   4 * lx),
               make_float4(e[m][4 * h], e[m][4 * h + 1], e[m][4 * h + 2],
                           e[m][4 * h + 3]));
    if (BIAS == FROZEN)
      chunk_sums(bs, sm.E[eb], sm.Et[eb], rsum, tid, pos, ds.ring, nb, band,
                 si, ch);
    DENSE_STAMP(sm, ST_STORE);
    if (i + 1 < n) {  // E of chunk ch + 1, from its S
      if (BIAS == FROZEN) {
#pragma unroll
        for (int n4 = 0; n4 < 4; ++n4) bic[n4] = bin[n4];
      }
      chunk_e<RANK, INT8, BIAS>(sm.E[eb ^ 1], sm.Et[eb ^ 1], acc, sm.Rs[qn],
                                bur, bic, mu, ty, tx, sq);
    }
    cp_async_wait_all();
    __syncthreads();
    DENSE_STAMP(sm, ST_E);
  }

  // the unit's SSE: warps' butterflies, then the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  if ((tid & 31) == 0) sm.red[tid >> 5] = sq;
  // the last piece of the band to finish adds the band's dP in chunk
  // order: piece 0's sum, then every later chunk's partial
  if (piece == 0) store_tile<RANK, MR, LQ>(dps, g, r0, lx);
  // frozen form: the band's row sums, one row of BAND a piece
  float* rs = BIAS == FROZEN ? bs.rs_buf + ((long long)(pos % ds.ring) * nb +
                                            band) * PIECES * BAND
                             : nullptr;
  if (BIAS == FROZEN && tid < BAND) __stcg(rs + piece * BAND + tid, rsum);
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    sm.flag = atomicAdd(ds.state + 1 + 3 * ds.nd + s * nb + band, 1);
    if (sm.flag == PIECES - 1) __threadfence();
  }
  __syncthreads();
  DENSE_STAMP(sm, ST_PIECE_END);
  const bool last = sm.flag == PIECES - 1;
  if (last) {
    if (BIAS == FROZEN && tid < BAND) {
      float t = __ldcg(rs + tid);
      for (int p = 1; p < PIECES; ++p) t += __ldcg(rs + p * BAND + tid);
      bs.dbu[(long long)d * su + band * BAND + tid] = t;
    }
    load_tile<RANK, MR, LQ>(g, dps, r0, lx);
    for (int e = 1; e <= nch - per_piece; ++e) {
      float d[MR][NO];
      load_tile<RANK, MR, LQ>(d, dps + (long long)e * BAND * RANK, r0, lx);
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int n = 0; n < NO; ++n) g[m][n] += d[m][n];
    }
    // the panel's own P rows, from the snapshot
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const int r = r0 + 16 * m;
      const float deg = du[(long long)d * su + band * BAND + r];
      const float scale = fminf(1.f, DSTAR / fmaxf(deg, 1.f));
#pragma unroll
      for (int h = 0; h < LQ; ++h) {
        const float4 p = ld4<PITCH>(sm.Pr, r, 64 * h + 4 * lx);
        float o[4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          o[n] = update(comp(p, n), g[m][4 * h + n], deg, scale,
                        BIAS == LANE && 64 * h + 4 * lx + n == RANK - 2, lr,
                        reg);
        __stcg(reinterpret_cast<float4*>(P) + (prow + r) * R4 + 16 * h + lx,
               make_float4(o[0], o[1], o[2], o[3]));
      }
    }
  }
  __syncthreads();
  DENSE_STAMP(sm, ST_LAST);
  if (tid == 0) {
    float t = 0.f;
    for (int w = 0; w < NT / 32; ++w) t += sm.red[w];
    // the SSE of first passes only
    sums[((long long)s * nb + band) * PIECES + piece] =
        s % ds.echo == 0 ? t : 0.f;
    if (last) {
      __threadfence();
      atomicAdd(ds.state + 1 + s, 1);
    }
  }
}

template <int RANK, int ROWS, int BIAS, class SM>
__device__ void apply_unit(SM& sm, float* Q, const int* sc, const float* di,
                           const float* ring_buf, const BiasSums& bs,
                           const DenseSched& ds, int s, int pos, int part,
                           int su, int si, float lr, float reg) {
  constexpr int R4 = RANK / 4;
  constexpr int PER = ROWS * R4 / NT;  // float4 a thread
  const int tid = threadIdx.x, nb = su / BAND, nq = si / ROWS;
  if (tid == 0)
    while (mfx_sweep::ld_acquire(ds.state + 1 + s) < nb) __nanosleep(64);
  __syncthreads();
  DENSE_STAMP(sm, ST_APPLY_WAIT);
  DENSE_COUNT(1);
  const float4* slot = reinterpret_cast<const float4*>(
      ring_buf + (long long)(pos % ds.ring) * nb * si * RANK);
  const int d = s / ds.echo;  // the slot's stratum
  if (BIAS == FROZEN && tid < ROWS) {
    // the unit's columns of E summed over the panels, in panel order
    const float* cs =
        bs.cs_buf + (long long)(pos % ds.ring) * nb * si + part * ROWS + tid;
    float t = 0.f;
    for (int b = 0; b < nb; ++b) t += __ldcg(cs + (long long)b * si);
    bs.dbi[(long long)d * si + part * ROWS + tid] = t;
  }
  float4 gv[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) gv[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = 0; b < nb; ++b) {
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int idx = tid + t * NT;
      const float4 v =
          __ldcg(slot + ((long long)b * si + part * ROWS) * R4 + idx);
      gv[t].x += v.x;
      gv[t].y += v.y;
      gv[t].z += v.z;
      gv[t].w += v.w;
    }
  }
  float4* Q4 = reinterpret_cast<float4*>(Q);
  const long long qrow = (long long)sc[d] * si + part * ROWS;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int idx = tid + t * NT, row = idx / R4, q = idx % R4;
    const float deg = di[(long long)d * si + part * ROWS + row];
    const float scale = fminf(1.f, DSTAR / fmaxf(deg, 1.f));
    const float4 v = __ldcg(Q4 + (qrow + row) * R4 + q);
    float o[4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
      o[n] = update(comp(v, n), comp(gv[t], n), deg, scale,
                    BIAS == LANE && 4 * q + n == RANK - 1, lr, reg);
    __stcg(Q4 + (qrow + row) * R4 + q, make_float4(o[0], o[1], o[2], o[3]));
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(ds.state + 1 + ds.nd + s, 1) == nq - 1) {
      __threadfence();
      mfx_sweep::st_release(ds.state + 1 + 2 * ds.nd + s, 1);
    }
  }
  DENSE_STAMP(sm, ST_APPLY);
}

// P and Q are rewritten by this and other blocks during the launch, so
// they are deliberately not const/__restrict__ (see the header).
template <int RANK, bool INT8, int BIAS>
__global__ void __launch_bounds__(NT, 1)
dense_phase_kernel(float* P, float* Q, const int* __restrict__ sa,
                   const int* __restrict__ sc, const uint8_t* __restrict__ R,
                   const float* __restrict__ du, const float* __restrict__ di,
                   float* ring_buf, float* dp_buf, float* __restrict__ sums,
                   BiasSums bs, DenseSched ds, int su, int si, float lr,
                   float reg, float mu) {
  using F = Form<RANK, INT8>;
  extern __shared__ float4 smem_raw[];
  Smem<RANK, INT8>& sm = *reinterpret_cast<Smem<RANK, INT8>*>(smem_raw);
  const int nb = su / BAND, np = nb * PIECES, qrows = F::apply_rows(si);
  const int per = np + si / qrows;
#ifdef MFX_DENSE_STAMPS
  if (threadIdx.x == 0) {
    for (int k = 0; k < ST_N; ++k) sm.st[k] = 0;
    sm.st_last = clock64();
  }
#endif
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) sm.ticket = atomicAdd(ds.state, 1);
    __syncthreads();
    const int u = sm.ticket;
    if (u >= ds.nd * per) break;
    DENSE_STAMP(sm, ST_TICKET);
    const int pos = u / per, j = u - pos * per, s = stratum_at(ds, pos);
    if (j < np)
      panel_unit<RANK, INT8, BIAS>(sm, P, Q, sa, sc, R, du, ring_buf, dp_buf,
                                   sums, bs, ds, s, pos, j / PIECES,
                                   j % PIECES, su, si, lr, reg, mu);
    else if (qrows == F::QROWS)
      apply_unit<RANK, F::QROWS, BIAS>(sm, Q, sc, di, ring_buf, bs, ds, s, pos,
                                       j - np, su, si, lr, reg);
    else
      apply_unit<RANK, F::QROWS / 2, BIAS>(sm, Q, sc, di, ring_buf, bs, ds, s,
                                           pos, j - np, su, si, lr, reg);
  }
#ifdef MFX_DENSE_STAMPS
  if (threadIdx.x == 0)
    for (int k = 0; k < ST_N; ++k)
      atomicAdd(g_stamps + k, (unsigned long long)sm.st[k]);
#endif
}

template <int RANK, bool INT8, int BIAS>
int launch(float* P, float* Q, const int* sa, const int* sc,
           const uint8_t* R, const float* du, const float* di,
           const BiasSums& bs, const DenseSched& ds, float* ring_buf,
           float* dp_buf, float* sums, float* sse_out, int blocks, int su,
           int si, float lr, float reg, float mu, cudaStream_t st) {
  using F = Form<RANK, INT8>;
  if (su < BAND || su % BAND || si < F::QROWS / 2 || si % (F::QROWS / 2) ||
      (si / CH) % PIECES)
    return (int)cudaErrorInvalidValue;
  if ((BIAS == FROZEN) != (bs.bu != nullptr && bs.bi != nullptr &&
                           bs.dbu != nullptr && bs.dbi != nullptr &&
                           bs.rs_buf != nullptr && bs.cs_buf != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dense_phase_kernel<RANK, INT8, BIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem<RANK, INT8>));
  if (err != cudaSuccess) return (int)err;
  dense_phase_kernel<RANK, INT8, BIAS>
      <<<blocks, NT, sizeof(Smem<RANK, INT8>), st>>>(
          P, Q, sa, sc, R, du, di, ring_buf, dp_buf, sums, bs, ds, su, si,
          lr, reg, mu);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mfx_sweep::ordered_sum_kernel<<<1, mfx_sweep::SUM_THREADS, 0, st>>>(
      sums, ds.nd * (su / BAND) * PIECES, sse_out);
  return (int)cudaGetLastError();
}

// The form's instance: f(kernel-of-the-form marker) for (rank, int8,
// bias) in the fifteen built ones, or cudaErrorInvalidValue.
template <class Fn>
int with_form(int rank, int int8, int bias, Fn&& fn) {
  if (bias < LANE || bias > NONE) return -1;
#define MFX_FORM(R, I8)                                                   \
  if (rank == R && (int8 != 0) == I8) {                                   \
    if (bias == LANE) return fn(std::integral_constant<int, R>{},         \
                                std::bool_constant<I8>{},                 \
                                std::integral_constant<int, LANE>{});     \
    if (bias == FROZEN) return fn(std::integral_constant<int, R>{},       \
                                  std::bool_constant<I8>{},               \
                                  std::integral_constant<int, FROZEN>{}); \
    return fn(std::integral_constant<int, R>{}, std::bool_constant<I8>{}, \
              std::integral_constant<int, NONE>{});                       \
  }
  MFX_FORM(32, false)
  MFX_FORM(32, true)
  MFX_FORM(64, false)
  MFX_FORM(64, true)
  MFX_FORM(128, true)
#undef MFX_FORM
  return -1;
}

}  // namespace

// Thread blocks of the form's dense_phase_kernel (ranks 32 and 64 with
// int4 or int8 codes, rank 128 with int8; bias 0 lane, 1 frozen, 2 none)
// the device holds at once, or minus the CUDA error.
extern "C" int mfx_dense_phase_max_blocks(int rank, int int8, int bias) {
  const int r = with_form(rank, int8, bias, [](auto R, auto I8, auto B) {
    return mfx_sweep::resident_blocks(
        dense_phase_kernel<decltype(R)::value, decltype(I8)::value,
                           decltype(B)::value>,
        NT, sizeof(Smem<decltype(R)::value, decltype(I8)::value>));
  });
  return r == -1 ? -(int)cudaErrorInvalidValue : r;
}

// bu, bi, dbu, dbi, rs_buf and cs_buf: the frozen form's (BiasSums), null
// in the other forms. nd counts slots: strata * echo (echo 1 in the frozen
// form); runs, wait and order are the slots' table and order.
extern "C" int mfx_dense_phase(float* P, float* Q, const int* sa,
                               const int* sc, const uint8_t* R,
                               const float* du, const float* di,
                               const float* bu, const float* bi, float* dbu,
                               float* dbi, float* rs_buf, float* cs_buf,
                               const int* runs, const int* wait,
                               const int* order, int* state,
                               float* ring_buf, float* dp_buf, float* sums,
                               float* sse_out, int nd, int nruns, int ring,
                               int blocks, int su, int si, int rank,
                               int int8, int bias, int echo, float lr,
                               float reg, float mu, void* stream) {
  if (nd < 0 || nruns < 1 || ring < 1 || blocks < 1 || echo < 1 ||
      nd % echo || (echo > 1 && bias == FROZEN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const DenseSched ds{runs, wait, order, state, nruns, nd, ring, echo};
  const BiasSums bs{bu, bi, dbu, dbi, rs_buf, cs_buf};
  const int r = with_form(rank, int8, bias, [&](auto R_, auto I8, auto B) {
    return launch<decltype(R_)::value, decltype(I8)::value,
                  decltype(B)::value>(P, Q, sa, sc, R, du, di, bs, ds,
                                      ring_buf, dp_buf, sums, sse_out,
                                      blocks, su, si, lr, reg, mu, st);
  });
  return r == -1 ? (int)cudaErrorInvalidValue : r;
}

#ifdef MFX_DENSE_STAMPS
// The measurement build's sums (ST_N phases' cycles, then panel pieces,
// apply units and chunks) into out; reset: then zero them.
extern "C" int mfx_dense_phase_stamps(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[ST_N + 3] = {};
    err = cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
  }
  return (int)err;
}

extern "C" int mfx_dense_phase_stamp_count() { return ST_N + 3; }
#endif
