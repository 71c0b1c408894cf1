// bf16 scatter-add in slot order: table[row[k]] += delta[k] for k = 0, 1,
// ..., each sum rounded to bf16 before the next add to the same element.
//
// Replaces: no Pallas kernel. The reference's minibatch step is XLA
// (mfx/kernels/jnp_ref.py::sgd_apply_deltas), whose bf16 scatter-add adds
// a batch's duplicate rows one after another in slot order, rounding each
// sum to bf16; so does the plain version, index_add_ on a CPU table's
// flat view (mfx_torch/kernels/packing.py::row_add). On CUDA,
// index_put_(accumulate=True) adds a bf16 table's duplicates otherwise
// (measured: it does not give the CPU's bits), so bf16 tables on the card
// take this kernel.
//
// What bounds it on an H100: bytes (the row ids, 8 B each, the deltas,
// 2 B an element, and the touched elements read and written once): a
// minibatch's few tens of KB, well under a microsecond at 3.35 TB/s; in
// practice the launch and, for a hot row, its run of duplicates, which
// one thread a lane walks in order (the order is the result).
//
// Form: the row ids arrive sorted, stably (equal rows keep their slot
// order), with each one's slot; the wrapper sorts them once a batch for
// a side's tables (P and bu share the user rows). One thread a (sorted
// position, lane), lanes fastest; the threads at the start of a run of
// equal rows add the run's deltas of their lane in order into a register
// holding the element, rounding each sum to bf16 (round to nearest even,
// as the CPU's bf16 add), and write it once. No two threads touch one
// element: a run is bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void row_add_bf16_kernel(__nv_bfloat16* __restrict__ table,
                                    const long long* __restrict__ rows,
                                    const long long* __restrict__ slots,
                                    const __nv_bfloat16* __restrict__ delta,
                                    long long n, int width) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n * width) return;
  const long long i = t / width;
  const int lane = (int)(t - i * width);
  const long long row = rows[i];
  if (i > 0 && rows[i - 1] == row) return;  // not the start of its run
  __nv_bfloat16* el = table + row * width + lane;
  float acc = __bfloat162float(*el);
  for (long long j = i; j < n && rows[j] == row; ++j)
    acc = __bfloat162float(__float2bfloat16_rn(
        acc + __bfloat162float(delta[slots[j] * width + lane])));
  *el = __float2bfloat16_rn(acc);
}

}  // namespace

// table: (rows, width) bf16, row-major; rows: n int64 row ids sorted
// stably; slots: each sorted row's position among the deltas; delta:
// (n, width) bf16, in slot order.
extern "C" int mfx_row_add_bf16(void* table, const void* rows,
                                const void* slots, const void* delta,
                                long long n, int width, void* stream) {
  if (n < 0 || width < 1 ||
      (n > 0 && (!table || !rows || !slots || !delta)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  constexpr int threads = 256;
  const long long total = n * width;
  row_add_bf16_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                        0, (cudaStream_t)stream>>>(
      static_cast<__nv_bfloat16*>(table), static_cast<const long long*>(rows),
      static_cast<const long long*>(slots),
      static_cast<const __nv_bfloat16*>(delta), n, width);
  return (int)cudaGetLastError();
}
