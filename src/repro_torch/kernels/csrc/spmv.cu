// Hand-written Hopper (sm_90a) kernels for the distributed SpMV's local
// matvec.  Built by repro_torch/kernels/spmv_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
//
// Every launch covers all S = n_node * n_core shards of the virtual mesh:
// the grid is (row blocks, shard).  The node-local input vectors x_local
// (nl_pad per node) and x_ghost (g_pad + 1 per node) are shared by the
// node's cores, so a shard finds its node's slice through a node stride
// (node = shard / n_core) instead of a per-shard copy.
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

}  // extern "C"
