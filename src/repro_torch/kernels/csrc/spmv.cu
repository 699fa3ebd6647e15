// Hand-written Hopper (sm_90a) kernels for the distributed SpMV's local
// matvec and the single-device binned SpMV.  Built by
// repro_torch/kernels/spmv_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Every ELL/SELL launch covers all S = n_node * n_core shards of the
// virtual mesh: the grid is (row blocks, shard).  The node-local input
// vectors x_local (nl_pad per node) and x_ghost (g_pad + 1 per node) are
// shared by the node's cores, so a shard finds its node's slice through a
// node stride (node = shard / n_core) instead of a per-shard copy.  The
// balanced kernel's grid is (row blocks, bin) over one flat x.
//
// Storage is float32 or bfloat16; indices int32; x float32; accumulation
// and output float32.  The kernels allocate nothing, launch on the caller's
// stream, and each C entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ------------------------------------------------------------------------
// ELL: replaces fused_ell_spmv_pallas (src/repro/kernels/spmv_bcsr.py:103,
// body _fused_ell_kernel :84) and, with wo == 0, ell_spmv_pallas (:58,
// body _ell_kernel :48).
//
//   y[s, r] = sum_k dvals[s, r, k] * x_local[node(s), dcols[s, r, k]]
//           + sum_k ovals[s, r, k] * x_ghost[node(s), ocols[s, r, k]]
//
// Bound: device-memory bytes.  Each stored entry costs 8 B in f32 (6 B in
// bf16: value + int32 column) and two flops, far below the card's
// operations-per-byte balance; add the x reads and one 4 B write per row.
// Design: one output row per thread, k in order, the f32 accumulator in a
// register.  The diag partial never leaves the register -- the offd sum
// adds onto it and y is written once, as in the TPU kernel -- so the
// intermediate y of PETSc's two phases costs no device-memory traffic.
// The x gathers mostly hit L2 (x_local of one node is 2.4 MB at the 4x2
// full-size plan, far inside the 50 MB L2).  Known limit: the plan's
// (rows, w) row-major layout makes a warp's loads of vals/cols strided by
// w, so they are not coalesced; a column-major (w, rows) copy or a
// warp-per-row variant is the next step, left to a later change.
// ------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const T* __restrict__ dvals, const int32_t* __restrict__ dcols,
           int wd, const T* __restrict__ ovals,
           const int32_t* __restrict__ ocols, int wo,
           const float* __restrict__ x_local, int64_t xl_stride,
           const float* __restrict__ x_ghost, int64_t xg_stride,
           float* __restrict__ y, int rows, int n_core) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int s = blockIdx.y;
  const int64_t node = s / n_core;
  const int64_t row = static_cast<int64_t>(s) * rows + r;

  const float* xl = x_local + node * xl_stride;
  const T* dv = dvals + row * wd;
  const int32_t* dc = dcols + row * wd;
  float acc = 0.0f;
  for (int k = 0; k < wd; ++k) acc += to_f32(dv[k]) * xl[dc[k]];

  if (wo > 0) {
    const float* xg = x_ghost + node * xg_stride;
    const T* ov = ovals + row * wo;
    const int32_t* oc = ocols + row * wo;
    for (int k = 0; k < wo; ++k) acc += to_f32(ov[k]) * xg[oc[k]];
  }
  y[row] = acc;
}

// ------------------------------------------------------------------------
// SELL: replaces fused_sell_spmv_pallas (spmv_bcsr.py:211, body
// _fused_sell_kernel :171 + _sell_accumulate :140) and, with no offd
// stream, sell_spmv_pallas (:189, body _sell_kernel :163).
//
// The TPU kernel streams each flat SELL stream in chunks and reduces into
// the (rc_pad,) output with a one-hot MXU matmul, only because Mosaic has
// no scatter-add.  That is dropped entirely.  sell_arrays_from_csr stores
// entry k of slot q at start[sl] + (q - sl*C) * width[sl] + k, so a slot's
// entries are contiguous: one thread per slot reads its width[sl] entries
// in order and writes y[q] once.  Deterministic, no atomics; the rows
// stream is never read.  Slots of slices a shard does not have (width 0)
// get 0.
//
// Bound: device-memory bytes, as ELL: 8 B per stored entry (6 B in bf16),
// plus 8 B of slice descriptor per slice, the x reads and one 4 B write
// per slot.  Storage tracks true nnz (slice-local widths), so SELL moves
// fewer padding bytes than ELL on the graded matrices.  Known limit: the
// row-major layout within a slice strides a warp's loads by the slice
// width (uncoalesced), as in ELL.
// ------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ float sell_slot(
    float acc, const T* __restrict__ vals, const int32_t* __restrict__ cols,
    int32_t start, int32_t width, int j, const float* __restrict__ x) {
  const int64_t base = static_cast<int64_t>(start) +
                       static_cast<int64_t>(j) * width;
  for (int k = 0; k < width; ++k)
    acc += to_f32(vals[base + k]) * x[cols[base + k]];
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sell_kernel(const T* __restrict__ dvals, const int32_t* __restrict__ dcols,
            const int32_t* __restrict__ dstart,
            const int32_t* __restrict__ dwidth, int64_t d_len,
            const T* __restrict__ ovals, const int32_t* __restrict__ ocols,
            const int32_t* __restrict__ ostart,
            const int32_t* __restrict__ owidth, int64_t o_len, int has_offd,
            int n_slices, int slice_height,
            const float* __restrict__ x_local, int64_t xl_stride,
            const float* __restrict__ x_ghost, int64_t xg_stride,
            float* __restrict__ y, int rc_pad, int n_core) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= rc_pad) return;
  const int s = blockIdx.y;
  const int64_t node = s / n_core;
  const int sl = q / slice_height;
  const int j = q - sl * slice_height;
  const int64_t d = static_cast<int64_t>(s) * n_slices + sl;

  float acc = sell_slot(0.0f, dvals + s * d_len, dcols + s * d_len,
                        dstart[d], dwidth[d], j, x_local + node * xl_stride);
  if (has_offd)
    acc = sell_slot(acc, ovals + s * o_len, ocols + s * o_len, ostart[d],
                    owidth[d], j, x_ghost + node * xg_stride);
  y[static_cast<int64_t>(s) * rc_pad + q] = acc;
}

// ------------------------------------------------------------------------
// Balanced (nnz-binned COO): replaces balanced_spmv_pallas
// (src/repro/kernels/spmv_bcsr.py:268, body _balanced_kernel :239).
//
//   y[t, r] = sum over k < bin_nnz[t] with lrows[t, k] == r
//             of vals[t, k] * x[cols[t, k]]
//
// The TPU kernel reduces each nnz chunk into the bin's rows with a one-hot
// MXU matmul, only because Mosaic has no scatter-add.  That is dropped.
// Bins are contiguous CSR row ranges, so lrows is nondecreasing over a
// bin's bin_nnz[t] real entries.  A block owns kThreads consecutive rows
// [r0, r0 + kThreads) of one bin, one thread per row:
//   1. two threads binary-search the block's entry range [k0, k1) in the
//      bin's real prefix -- never in the padding, whose lrows of 0 would
//      break the order;
//   2. one coalesced pass over lrows[k0, k1) marks, in shared memory, each
//      row's first and one-past-last entry where lrows changes;
//   3. vals and cols stream in coalesced chunks of kChunk entries; each
//      entry's product is staged in shared memory, and each thread adds
//      its own row's part of the chunk, in entry order.
// Rows with no entries and the rows_pad tail get 0.  Deterministic, no
// atomics; the padding is never read.
//
// Bound: device-memory bytes: 12 B per real entry in f32 (10 B in bf16:
// value, column, bin-local row) and two flops, plus the x reads and one
// 4 B write per row slot; every load of the matrix is coalesced and made
// once.  The x gathers mostly hit L2 (columns sit near their row).  A
// first version, one thread per row that binary-searched its own first
// entry, spent most of its time in those ~log2(bin_nnz) dependent loads
// per row (PERF.md).  Known limits: a block's rows share one bin, so a bin
// with fewer rows than rows_pad launches blocks of tail that only search
// and write zeros; with bf16 storage a warp's value loads are 64 B, half
// a full transaction.
// ------------------------------------------------------------------------
constexpr int kChunk = 2048;     // staged products per pass (8 KB)

template <typename T>
__global__ void __launch_bounds__(kThreads)
balanced_kernel(const T* __restrict__ vals, const int32_t* __restrict__ cols,
                const int32_t* __restrict__ lrows,
                const int32_t* __restrict__ bin_nnz, int64_t nnz_pad,
                const float* __restrict__ x, float* __restrict__ y,
                int rows_pad) {
  __shared__ int s_range[2];
  __shared__ int s_beg[kThreads];
  __shared__ int s_end[kThreads];
  __shared__ float s_prod[kChunk];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kThreads;
  const int64_t t = blockIdx.y;
  const int64_t off = t * nnz_pad;
  const int32_t* lr = lrows + off;
  const int n = bin_nnz[t];

  // 1. [k0, k1) = lower bounds of r0 and r0 + kThreads in lr[0, n); the
  //    two searches run in different warps
  if (tid == 0 || tid == 32) {
    const int target = tid == 0 ? r0 : r0 + kThreads;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (lr[mid] < target) lo = mid + 1; else hi = mid;
    }
    s_range[tid == 0 ? 0 : 1] = lo;
  }
  s_beg[tid] = 0;
  s_end[tid] = 0;
  __syncthreads();
  const int k0 = s_range[0], k1 = s_range[1];

  // 2. each row's entries are [s_beg, s_end): mark where lrows changes
  for (int k = k0 + tid; k < k1; k += kThreads) {
    const int r = lr[k];
    if (k == k0 || lr[k - 1] != r) s_beg[r - r0] = k;
    if (k == k1 - 1 || lr[k + 1] != r) s_end[r - r0] = k + 1;
  }
  __syncthreads();
  const int beg = s_beg[tid], end = s_end[tid];

  // 3. coalesced chunks of products; each thread sums its row's part
  const T* v = vals + off;
  const int32_t* c = cols + off;
  float acc = 0.0f;
  for (int c0 = k0; c0 < k1; c0 += kChunk) {
    const int c1 = min(c0 + kChunk, k1);
    for (int k = c0 + tid; k < c1; k += kThreads)
      s_prod[k - c0] = to_f32(v[k]) * x[c[k]];
    __syncthreads();
    const int hi = min(end, c1);
    for (int k = max(beg, c0); k < hi; ++k) acc += s_prod[k - c0];
    __syncthreads();
  }
  if (r0 + tid < rows_pad) y[t * rows_pad + r0 + tid] = acc;
}

}  // namespace

extern "C" {

// vals_bf16: 0 -> float32 storage, 1 -> bfloat16.  wo == 0 is the
// halo-free kernel (ovals/ocols/x_ghost are then not read).
int repro_ell_spmv(int vals_bf16, const void* dvals, const int32_t* dcols,
                   int wd, const void* ovals, const int32_t* ocols, int wo,
                   const float* x_local, int64_t xl_stride,
                   const float* x_ghost, int64_t xg_stride, float* y,
                   int n_shards, int n_core, int rows, void* stream) {
  if (rows <= 0 || n_shards <= 0) return 0;
  const dim3 grid((rows + kThreads - 1) / kThreads, n_shards);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    ell_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dvals), dcols, wd,
        static_cast<const __nv_bfloat16*>(ovals), ocols, wo, x_local,
        xl_stride, x_ghost, xg_stride, y, rows, n_core);
  } else {
    ell_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dvals), dcols, wd,
        static_cast<const float*>(ovals), ocols, wo, x_local, xl_stride,
        x_ghost, xg_stride, y, rows, n_core);
  }
  return static_cast<int>(cudaGetLastError());
}

// has_offd == 0 is the diag-only kernel (the o* pointers and x_ghost are
// then not read).
int repro_sell_spmv(int vals_bf16, const void* dvals, const int32_t* dcols,
                    const int32_t* dstart, const int32_t* dwidth,
                    int64_t d_len, const void* ovals, const int32_t* ocols,
                    const int32_t* ostart, const int32_t* owidth,
                    int64_t o_len, int has_offd, int n_slices,
                    int slice_height, const float* x_local,
                    int64_t xl_stride, const float* x_ghost,
                    int64_t xg_stride, float* y, int n_shards, int n_core,
                    int rc_pad, void* stream) {
  if (rc_pad <= 0 || n_shards <= 0) return 0;
  const dim3 grid((rc_pad + kThreads - 1) / kThreads, n_shards);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    sell_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dvals), dcols, dstart, dwidth,
        d_len, static_cast<const __nv_bfloat16*>(ovals), ocols, ostart,
        owidth, o_len, has_offd, n_slices, slice_height, x_local, xl_stride,
        x_ghost, xg_stride, y, rc_pad, n_core);
  } else {
    sell_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dvals), dcols, dstart, dwidth, d_len,
        static_cast<const float*>(ovals), ocols, ostart, owidth, o_len,
        has_offd, n_slices, slice_height, x_local, xl_stride, x_ghost,
        xg_stride, y, rc_pad, n_core);
  }
  return static_cast<int>(cudaGetLastError());
}

// Output (nbins, rows_pad); bin_nnz[t] <= nnz_pad real entries per bin.
int repro_balanced_spmv(int vals_bf16, const void* vals, const int32_t* cols,
                        const int32_t* lrows, const int32_t* bin_nnz,
                        int64_t nnz_pad, const float* x, float* y, int nbins,
                        int rows_pad, void* stream) {
  if (rows_pad <= 0 || nbins <= 0) return 0;
  const dim3 grid((rows_pad + kThreads - 1) / kThreads, nbins);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    balanced_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(vals), cols, lrows, bin_nnz,
        nnz_pad, x, y, rows_pad);
  } else {
    balanced_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(vals), cols, lrows, bin_nnz, nnz_pad, x,
        y, rows_pad);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
