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
// The warp-segment sum shared by the ELL and SELL kernels.
//
// Each lane of a warp owns one output (an ELL row, a SELL slot) whose
// entries are one contiguous segment [seg, seg + len) of vals/cols.  The
// warp lays its 32 segments end to end (a prefix sum of len) and walks that
// flat range with neighbouring lanes on neighbouring entries, kWarpChunk
// entries at a time: each lane loads kUnroll entries' value and column
// before it gathers their x, and stages the f32 value and x[col] in shared
// memory.  Then each lane adds its own segment's part of the chunk onto acc
// in entry order, one fmaf per entry -- the order of a thread that reads
// its segment itself, so the sum is the same bit for bit.
//
// kBackToBack: the segments of neighbouring lanes are adjacent in memory
// (SELL slots), so entry e of the flat range sits at seg(lane 0) + e.
// Otherwise (ELL rows, whose padding lies between them) each lane finds
// the owner of its entry by a binary search over the lanes' offsets,
// five shuffles, and reads seg(owner) + (e - offset(owner)).
//
// Geometry (PERF.md): 256 staged entries per warp (16 KB of shared memory
// per block of 8 warps) and 4 loads in flight per lane ran fastest of the
// chunks of 128 to 768 entries and 2 to 8 loads tried on the card.  A
// lane-split shuffle-tree sum was not tried: it would change each row's
// summation order, and the golden CG count moves with that order
// (ROADMAP C).
// ------------------------------------------------------------------------
constexpr int kWarpChunk = 256;   // staged entries per warp
constexpr int kUnroll = 4;        // loads in flight per lane
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarpChunk % (32 * kUnroll) == 0, "chunk of whole steps");

template <typename T, bool kBackToBack>
__device__ __forceinline__ float warp_segment_sum(
    float acc, const T* __restrict__ vals, const int32_t* __restrict__ cols,
    const float* __restrict__ x, int64_t seg, int len,
    float* __restrict__ s_v, float* __restrict__ s_x) {
  const int lane = threadIdx.x & 31;
  int end = len;                      // inclusive prefix sum over the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(kFull, end, d);
    if (lane >= d) end += n;
  }
  const int off = end - len;
  const int total = __shfl_sync(kFull, end, 31);
  const int64_t seg0 = __shfl_sync(kFull, seg, 0);

  for (int c0 = 0; c0 < total; c0 += kWarpChunk) {
    const int n = min(kWarpChunk, total - c0);
    for (int b = 0; b < n; b += 32 * kUnroll) {
      int64_t src[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = c0 + b + u * 32 + lane;
        if (kBackToBack) {
          src[u] = seg0 + e;
        } else {
          int j = 0, oj = 0;          // the last lane j with off[j] <= e
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            const int o = __shfl_sync(kFull, off, j + step);
            if (o <= e) { j += step; oj = o; }
          }
          src[u] = __shfl_sync(kFull, seg, j) + (e - oj);
        }
      }
      float v[kUnroll];
      int32_t c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (b + u * 32 + lane < n) {
          v[u] = to_f32(vals[src[u]]);
          c[u] = cols[src[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = b + u * 32 + lane;
        if (k < n) {
          s_v[k] = v[u];
          s_x[k] = x[c[u]];
        }
      }
    }
    __syncwarp();
    const int lo = max(off, c0), hi = min(off + len, c0 + n);
    for (int k = lo; k < hi; ++k)
      acc = fmaf(s_v[k - c0], s_x[k - c0], acc);
    __syncwarp();
  }
  return acc;
}

// ------------------------------------------------------------------------
// ELL: replaces fused_ell_spmv_pallas (src/repro/kernels/spmv_bcsr.py:103,
// body _fused_ell_kernel :84) and, with wo == 0, ell_spmv_pallas (:58,
// body _ell_kernel :48).
//
//   y[s, r] = sum_{k < dlen[s, r]} dvals[s, r, k] * x_local[node(s), dcols[s, r, k]]
//           + sum_{k < olen[s, r]} ovals[s, r, k] * x_ghost[node(s), ocols[s, r, k]]
//
// len[r] is 1 + the row's last slot holding an entry (ELLFormat's
// diag_len/offd_len, ELLMatrix.row_lens); the slots past it are padding
// (value 0, column 0), so for finite x stopping there is exact.  A null
// lens reads all w slots, as the plain version and the TPU kernel do: the
// same result for finite x, but a non-finite x[0] then makes every padded
// row NaN (0 * Inf), which the kernel with lengths does not.
//
// Bound: device-memory bytes.  Each real entry costs 8 B in f32 (6 B in
// bf16: value + int32 column) and two flops, far below the card's
// operations-per-byte balance; add the 4 B length and one 4 B write per
// row, and the x reads.  Row-padded ELL stores 3-10x the entries on the
// graded matrices, so the padding is never read: a warp owns 32 rows and
// walks only their [0, len) entries, coalesced (warp_segment_sum).  The
// diag partial stays in a register -- the offd sum adds onto it and y is
// written once, as in the TPU kernel -- so the intermediate y of PETSc's
// two phases costs no device-memory traffic.  The x gathers mostly hit L2
// (x_local of one node is 2.4 MB at the 4x2 full-size plan, far inside the
// 50 MB L2).
//
// Known limits, at ~3x the bound (PERF.md): a row's real entries rarely
// start on a 32 B sector, so a warp's load of ~1.5 rows touches a sector
// or two more than it needs; the owner search costs five shuffles per
// staged entry.
// ------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const T* __restrict__ dvals, const int32_t* __restrict__ dcols,
           const int32_t* __restrict__ dlens, int wd,
           const T* __restrict__ ovals, const int32_t* __restrict__ ocols,
           const int32_t* __restrict__ olens, int wo,
           const float* __restrict__ x_local, int64_t xl_stride,
           const float* __restrict__ x_ghost, int64_t xg_stride,
           float* __restrict__ y, int rows, int n_core) {
  __shared__ float s_v[kWarps][kWarpChunk];
  __shared__ float s_x[kWarps][kWarpChunk];
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < rows;          // no early return: the warp shuffles
  const int s = blockIdx.y;
  const int64_t node = s / n_core;
  const int64_t row = static_cast<int64_t>(s) * rows + (live ? r : 0);

  int len = 0;
  if (live) len = dlens ? min(max(dlens[row], 0), wd) : wd;
  float acc = warp_segment_sum<T, false>(
      0.0f, dvals, dcols, x_local + node * xl_stride, row * wd, len,
      s_v[warp], s_x[warp]);
  if (wo > 0) {
    len = 0;
    if (live) len = olens ? min(max(olens[row], 0), wo) : wo;
    acc = warp_segment_sum<T, false>(
        acc, ovals, ocols, x_ghost + node * xg_stride, row * wo, len,
        s_v[warp], s_x[warp]);
  }
  if (live) y[row] = acc;
}

// ------------------------------------------------------------------------
// SELL: replaces fused_sell_spmv_pallas (spmv_bcsr.py:211, body
// _fused_sell_kernel :171 + _sell_accumulate :140) and, with no offd
// stream, sell_spmv_pallas (:189, body _sell_kernel :163).
//
// The TPU kernel streams each flat SELL stream in chunks and reduces into
// the (rc_pad,) output with a one-hot MXU matmul, only because Mosaic has
// no scatter-add.  That is dropped entirely.  sell_arrays_from_csr stores
// entry k of slot q at start[sl] + (q - sl*C) * width[sl] + k, and the
// slices of a shard back to back (start[sl + 1] = start[sl] + C *
// width[sl], absent slices of width 0 at the end), so the 32 slots of a
// warp (32 / C slices at C = 8) are one contiguous range of the stream.
// The warp walks it coalesced, no search and no rows stream needed
// (warp_segment_sum), and each lane sums its own slot's width[sl] entries
// in order; y[q] is written once.  Deterministic, no atomics.  Slots of
// slices a shard does not have (width 0) get 0.
//
// Bound: device-memory bytes, as ELL: 8 B per stored entry (6 B in bf16),
// plus 8 B of slice descriptor per slot's slice, the x reads and one 4 B
// write per slot.  SELL stores about nnz (slice-local widths, rows sorted
// by length), so it reads its padding, which is small.  Known limits, at
// ~2.5x the bound (PERF.md): each entry is staged through shared memory
// and read back by one lane, and each x gather waits on its column's
// load, so a lane has only kUnroll gathers in flight.
// ------------------------------------------------------------------------
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
  __shared__ float s_v[kWarps][kWarpChunk];
  __shared__ float s_x[kWarps][kWarpChunk];
  const int warp = threadIdx.x >> 5;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int64_t node = s / n_core;
  const int sl = q / slice_height;
  const int j = q - sl * slice_height;
  const bool present = sl < n_slices;  // slots past the last slice: none
  const int64_t d = static_cast<int64_t>(s) * n_slices + sl;

  int len = 0;
  int64_t seg = 0;
  if (present) {
    len = dwidth[d];
    seg = dstart[d] + static_cast<int64_t>(j) * len;
  }
  float acc = warp_segment_sum<T, true>(
      0.0f, dvals + s * d_len, dcols + s * d_len,
      x_local + node * xl_stride, seg, len, s_v[warp], s_x[warp]);
  if (has_offd) {
    len = 0;
    seg = 0;
    if (present) {
      len = owidth[d];
      seg = ostart[d] + static_cast<int64_t>(j) * len;
    }
    acc = warp_segment_sum<T, true>(
        acc, ovals + s * o_len, ocols + s * o_len,
        x_ghost + node * xg_stride, seg, len, s_v[warp], s_x[warp]);
  }
  if (q < rc_pad) y[static_cast<int64_t>(s) * rc_pad + q] = acc;
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
// halo-free kernel (ovals/ocols/olens/x_ghost are then not read).  dlens/
// olens: per-row entry counts, or null to read every slot.
int repro_ell_spmv(int vals_bf16, const void* dvals, const int32_t* dcols,
                   const int32_t* dlens, int wd, const void* ovals,
                   const int32_t* ocols, const int32_t* olens, int wo,
                   const float* x_local, int64_t xl_stride,
                   const float* x_ghost, int64_t xg_stride, float* y,
                   int n_shards, int n_core, int rows, void* stream) {
  if (rows <= 0 || n_shards <= 0) return 0;
  const dim3 grid((rows + kThreads - 1) / kThreads, n_shards);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    ell_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dvals), dcols, dlens, wd,
        static_cast<const __nv_bfloat16*>(ovals), ocols, olens, wo, x_local,
        xl_stride, x_ghost, xg_stride, y, rows, n_core);
  } else {
    ell_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dvals), dcols, dlens, wd,
        static_cast<const float*>(ovals), ocols, olens, wo, x_local,
        xl_stride, x_ghost, xg_stride, y, rows, n_core);
  }
  return static_cast<int>(cudaGetLastError());
}

// has_offd == 0 is the diag-only kernel (the o* pointers and x_ghost are
// then not read).  Each shard's slices lie back to back in its stream, as
// sell_arrays_from_csr lays them out.
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
