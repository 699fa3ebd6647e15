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
// balanced kernel's grid is one row of blocks over its warp map, on one
// flat x.
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
// The warp-segment sum shared by the ELL, SELL and balanced kernels.
//
// Each lane of a warp owns one output (an ELL row, a SELL slot, a row of a
// bin) whose entries are one contiguous segment [seg, seg + len) of
// vals/cols.  The warp lays its 32 segments end to end (a prefix sum of
// len) and walks that flat range with neighbouring lanes on neighbouring
// entries, kWarpChunk entries at a time: each lane loads kUnroll entries'
// value and column before it gathers their x, and stages the f32 value and
// x[col] in shared memory.  Then each lane adds its own segment's part of
// the chunk onto acc in entry order, one fmaf per entry -- the order of a
// thread that reads its segment itself, so the sum is the same bit for bit.
//
// kBackToBack: the segments of neighbouring lanes are adjacent in memory
// (SELL slots, the rows of a bin), so entry e of the flat range sits at
// seg(lane 0) + e.  Otherwise (ELL rows, whose padding lies between them)
// each lane finds the owner of its entry by a binary search over the
// lanes' offsets, five shuffles, and reads seg(owner) + (e - offset(owner)).
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

// The warp's flat range: each lane's offset ``off`` into it (an exclusive
// prefix sum of len), its length ``total`` and lane 0's segment ``seg0``.
struct WarpRange {
  int off;
  int total;
  int64_t seg0;
};

__device__ __forceinline__ WarpRange warp_range(int64_t seg, int len) {
  const int lane = threadIdx.x & 31;
  int end = len;                      // inclusive prefix sum over the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int n = __shfl_up_sync(kFull, end, d);
    if (lane >= d) end += n;
  }
  return {end - len, __shfl_sync(kFull, end, 31),
          __shfl_sync(kFull, seg, 0)};
}

// Where entry e of the warp's flat range lies in vals/cols (every lane of
// the warp calls it: the owner search shuffles).
template <bool kBackToBack>
__device__ __forceinline__ int64_t entry_source(int e, int64_t seg,
                                                const WarpRange& w) {
  if (kBackToBack) return w.seg0 + e;
  int j = 0, oj = 0;                  // the last lane j with off[j] <= e
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int o = __shfl_sync(kFull, w.off, j + step);
    if (o <= e) { j += step; oj = o; }
  }
  return __shfl_sync(kFull, seg, j) + (e - oj);
}

template <typename T, bool kBackToBack>
__device__ __forceinline__ float warp_segment_sum(
    float acc, const T* __restrict__ vals, const int32_t* __restrict__ cols,
    const float* __restrict__ x, int64_t seg, int len,
    float* __restrict__ s_v, float* __restrict__ s_x) {
  const int lane = threadIdx.x & 31;
  const WarpRange w = warp_range(seg, len);
  const int off = w.off, total = w.total;

  for (int c0 = 0; c0 < total; c0 += kWarpChunk) {
    const int n = min(kWarpChunk, total - c0);
    for (int b = 0; b < n; b += 32 * kUnroll) {
      int64_t src[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        src[u] = entry_source<kBackToBack>(c0 + b + u * 32 + lane, seg, w);
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
// (value 0, column 0), so for finite x stopping there is exact.  A caller
// without lengths passes w for every row (ops.py), which reads all slots,
// as the plain version and the TPU kernel do: the same result for finite
// x, but a non-finite x[0] then makes every padded row NaN (0 * Inf),
// which the real lengths do not.
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
template <typename T, bool kSeeded>
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
  if (live) len = min(max(dlens[row], 0), wd);
  float acc = warp_segment_sum<T, false>(
      (kSeeded && live) ? y[row] : 0.0f, dvals, dcols,
      x_local + node * xl_stride, row * wd, len, s_v[warp], s_x[warp]);
  if (wo > 0) {
    len = 0;
    if (live) len = min(max(olens[row], 0), wo);
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
template <typename T, bool kSeeded>
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
  const int64_t out = static_cast<int64_t>(s) * rc_pad + q;
  float acc = warp_segment_sum<T, true>(
      (kSeeded && q < rc_pad) ? y[out] : 0.0f, dvals + s * d_len,
      dcols + s * d_len, x_local + node * xl_stride, seg, len, s_v[warp],
      s_x[warp]);
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
  if (q < rc_pad) y[out] = acc;
}

// ------------------------------------------------------------------------
// Batched ELL and SELL: the counterparts of B1-B4 under vmap.  The JAX
// package batches right-hand sides by jax.vmap over the shard body
// (src/repro/solvers/base.py:419, solvers/resilient.py:212): under
// backend="pallas" that is fused_ell_spmv_pallas / fused_sell_spmv_pallas
// (spmv_bcsr.py:103 / :211, and the halo-free ell_spmv_pallas :58 /
// sell_spmv_pallas :189) with a batch axis on x and y, one launch, the
// matrix read by the whole batch.
//
//   y[j, s, r] = sum_k dvals[s, r, k] * x_local[j, node(s), dcols[s, r, k]]
//              + sum_k ovals[s, r, k] * x_ghost[j, node(s), ocols[s, r, k]]
//
// for the nrhs <= kMaxRhs columns j, all columns and all shards in one
// launch.  Column j of y is the single-column kernel's y on x_j bit for
// bit: each slot is summed by one lane, per column in entry order with one
// fmaf per entry, diag then offd, as warp_segment_sum sums it.  No atomics.
//
// Bound: device-memory bytes -- the matrix once for the whole batch (8 B
// per entry in f32, 6 B in bf16, and the row lengths or slice
// descriptors) plus nrhs times x_local, x_ghost and y; two flops per entry
// and column, far below the card's operations-per-byte balance.
//
// Design.  x comes column-interleaved, xi[node][col][j] with j padded by
// zeros to the column tile KT (4, 8 or 16, the smallest that holds nrhs),
// built by the wrapper in one copy (ops.interleave_rhs).  One entry's x
// for every column is then KT/4 aligned 16-byte loads from one 32-byte
// sector (two at KT = 16), where a column-major x costs nrhs loads from
// nrhs sectors.  A warp walks its 32 rows' (slots') segments in windows
// (warp_window_sum): each window stages the next 16 entries of every
// lane's segment, coalesced, as 8-byte (value, column) pairs in shared
// memory; then every lane sums its own row of the window in entry order,
// gathering each entry's x row through the read-only path when it sums
// it, 4 entries' rows in flight, nrhs fmaf per entry.  All 32 lanes sum at
// once, and ELL needs no owner search.  Pad columns are loaded with their
// row but neither summed nor written.
//
// Measured on an H100 (PERF.md's sweep of these kernels, each geometry a
// rebuild of this file with the three constants below changed): blocks of 4
// warps, windows of 16 and 4 loads in flight ran fastest at k = 4 of
// 128/256 threads, windows of 4-32 and 2-8 loads.  The first designs
// walked the warp's flat entry range in chunks, as warp_segment_sum does:
// a chunk holds only some lanes' entries, so the others idle in its sum
// loop, and ELL paid a five-shuffle owner search per entry; the best of
// them was 4-6% slower at k = 4 and 8.  Staging x rows beside the
// values (s_x[entry][KT]) tied at KT = 4 and was 1.3x slower at 8 and
// 1.9x at 16 (4 KT + 4 bytes of shared memory and 104-150 registers cap
// the warps an SM holds); staging by cp.async was no faster.
//
// wgmma and TMA do not fit: the work is a gather-bound SpMV with at most
// 16 columns and no dense tile for a tensor core or a bulk copy to take.
//
// Known limits (PERF.md): at k = 4 a call back to back, its interleave
// copy included, runs at 2.4-2.8x the bound, the copy 0.04-0.07 ms of it;
// columns past the first cost x-row gathers at about L2's rate, so KT = 8
// and 16 sit at 2.8-3.9x; 128 registers at KT = 16 hold 16 warps per SM.
// ------------------------------------------------------------------------
constexpr int kMaxRhs = 16;
constexpr int kBThreads = 128;  // threads per block
constexpr int kBWindow = 16;    // entries of each lane's segment per window
constexpr int kBUnroll = 4;     // loads in flight per lane
constexpr int kBRow = kBWindow + 1;     // a lane's staged pairs, padded
// One warp's shared memory: the window's (value, column) pairs [32][kBRow]
// (8 B each), then each lane's segment start (int64) and length (int32).
constexpr int kBWarpBytes = (32 * kBRow * 8 + 32 * 12 + 15) / 16 * 16;
constexpr int kBBlockBytes = kBThreads / 32 * kBWarpBytes;
static_assert(kBWindow % kBUnroll == 0, "a window of whole steps");
static_assert(kBBlockBytes <= 48 * 1024, "static shared memory");

// acc[j] = fmaf(v, x[j], acc[j]) for the real columns j < nrhs of one x row.
template <int KT>
__device__ __forceinline__ void fma_row(float (&acc)[KT], float v,
                                        const float4 (&xr)[KT / 4],
                                        int nrhs) {
#pragma unroll
  for (int q = 0; q < KT / 4; ++q) {
    const float xs[4] = {xr[q].x, xr[q].y, xr[q].z, xr[q].w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * q + c < nrhs) acc[4 * q + c] = fmaf(v, xs[c], acc[4 * q + c]);
  }
}

// Add one stream's entries onto acc: the warp walks its 32 segments
// [seg, seg + len) in windows of kBWindow entries each, all lanes at once.
// Window w0 stages entries [w0, w0 + kBWindow) of every lane's segment,
// coalesced (slot (j, t) at s_vc[j][t], a row padded to kBRow pairs so
// neither the staging nor the sum conflicts on banks); then each lane sums
// its own row of the window in entry order, gathering each entry's x row
// (KT/4 16-byte loads) when it sums it, kBUnroll rows in flight.  A
// lane's segment start and length come from shared memory: no prefix sum
// and no owner search.
template <typename T, int KT>
__device__ __forceinline__ void warp_window_sum(
    float (&acc)[KT], const T* __restrict__ vals,
    const int32_t* __restrict__ cols, const float4* __restrict__ xi,
    int nrhs, int64_t seg, int len, char* __restrict__ smem) {
  constexpr int W = kBWindow, P = kBRow, U = kBUnroll, kQ = KT / 4;
  const int lane = threadIdx.x & 31;
  float2* s_vc = reinterpret_cast<float2*>(smem);
  int64_t* s_seg = reinterpret_cast<int64_t*>(smem + 32 * P * 8);
  int32_t* s_len = reinterpret_cast<int32_t*>(smem + 32 * P * 8 + 32 * 8);
  int longest = len;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    longest = max(longest, __shfl_xor_sync(kFull, longest, d));
  s_seg[lane] = seg;
  s_len[lane] = len;
  __syncwarp();
  for (int w0 = 0; w0 < longest; w0 += W) {
#pragma unroll 1
    for (int u0 = 0; u0 < W; u0 += U) {
      float v[U];
      int32_t c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = (u0 + u) * 32 + lane, j = slot / W, t = slot % W;
        v[u] = 0.0f;
        c[u] = 0;
        if (w0 + t < s_len[j]) {
          const int64_t e = s_seg[j] + w0 + t;
          v[u] = to_f32(vals[e]);
          c[u] = cols[e];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = (u0 + u) * 32 + lane, j = slot / W, t = slot % W;
        if (w0 + t < s_len[j])
          s_vc[j * P + t] = make_float2(v[u], __int_as_float(c[u]));
      }
    }
    __syncwarp();
    const float2* row = s_vc + lane * P;
    const int n = min(W, len - w0);
    for (int t = 0; t < n; t += U) {
      float vt[U];
      float4 xr[U][kQ];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (t + u < n) {
          const float2 vc = row[t + u];
          vt[u] = vc.x;
          const int64_t col = __float_as_int(vc.y);
#pragma unroll
          for (int q = 0; q < kQ; ++q) xr[u][q] = __ldg(xi + col * kQ + q);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t + u < n) fma_row<KT>(acc, vt[u], xr[u], nrhs);
    }
    __syncwarp();
  }
}

// xl / xg: the interleaved x_local / x_ghost (float4 rows of KT / 4), with
// node strides xl_node / xg_node in float4s.
template <typename T, int KT, bool kSeeded>
__global__ void __launch_bounds__(kBThreads)
ell_batched_kernel(const T* __restrict__ dvals,
                   const int32_t* __restrict__ dcols,
                   const int32_t* __restrict__ dlens, int wd,
                   const T* __restrict__ ovals,
                   const int32_t* __restrict__ ocols,
                   const int32_t* __restrict__ olens, int wo,
                   const float4* __restrict__ xl, int64_t xl_node,
                   const float4* __restrict__ xg, int64_t xg_node,
                   float* __restrict__ y, int rows, int n_core, int n_shards,
                   int nrhs) {
  __shared__ float4 b_smem[kBBlockBytes / 16];
  char* smem = reinterpret_cast<char*>(b_smem)
               + (threadIdx.x >> 5) * kBWarpBytes;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < rows;          // no early return: the warp shuffles
  const int s = blockIdx.y;
  const int64_t node = s / n_core;
  const int64_t row = static_cast<int64_t>(s) * rows + (live ? r : 0);

  float acc[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j)
    acc[j] = (kSeeded && live && j < nrhs)
                 ? y[(static_cast<int64_t>(j) * n_shards + s) * rows + r]
                 : 0.0f;
  int len = 0;
  if (live) len = min(max(dlens[row], 0), wd);
  warp_window_sum<T, KT>(acc, dvals, dcols, xl + node * xl_node, nrhs,
                         row * wd, len, smem);
  if (wo > 0) {
    len = 0;
    if (live) len = min(max(olens[row], 0), wo);
    warp_window_sum<T, KT>(acc, ovals, ocols, xg + node * xg_node, nrhs,
                           row * wo, len, smem);
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (j < nrhs)
        y[(static_cast<int64_t>(j) * n_shards + s) * rows + r] = acc[j];
  }
}

template <typename T, int KT, bool kSeeded>
__global__ void __launch_bounds__(kBThreads)
sell_batched_kernel(const T* __restrict__ dvals,
                    const int32_t* __restrict__ dcols,
                    const int32_t* __restrict__ dstart,
                    const int32_t* __restrict__ dwidth, int64_t d_len,
                    const T* __restrict__ ovals,
                    const int32_t* __restrict__ ocols,
                    const int32_t* __restrict__ ostart,
                    const int32_t* __restrict__ owidth, int64_t o_len,
                    int has_offd, int n_slices, int slice_height,
                    const float4* __restrict__ xl, int64_t xl_node,
                    const float4* __restrict__ xg, int64_t xg_node,
                    float* __restrict__ y, int rc_pad, int n_core,
                    int n_shards, int nrhs) {
  __shared__ float4 b_smem[kBBlockBytes / 16];
  char* smem = reinterpret_cast<char*>(b_smem)
               + (threadIdx.x >> 5) * kBWarpBytes;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int64_t node = s / n_core;
  const int sl = q / slice_height;
  const int jq = q - sl * slice_height;
  const bool present = sl < n_slices;  // slots past the last slice: none
  const int64_t d = static_cast<int64_t>(s) * n_slices + sl;

  float acc[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j)
    acc[j] = (kSeeded && q < rc_pad && j < nrhs)
                 ? y[(static_cast<int64_t>(j) * n_shards + s) * rc_pad + q]
                 : 0.0f;
  int len = 0;
  int64_t seg = 0;
  if (present) {
    len = dwidth[d];
    seg = dstart[d] + static_cast<int64_t>(jq) * len;
  }
  warp_window_sum<T, KT>(acc, dvals + s * d_len, dcols + s * d_len,
                         xl + node * xl_node, nrhs, seg, len, smem);
  if (has_offd) {
    len = 0;
    seg = 0;
    if (present) {
      len = owidth[d];
      seg = ostart[d] + static_cast<int64_t>(jq) * len;
    }
    warp_window_sum<T, KT>(acc, ovals + s * o_len, ocols + s * o_len,
                           xg + node * xg_node, nrhs, seg, len, smem);
  }
  if (q < rc_pad) {
#pragma unroll
    for (int j = 0; j < KT; ++j)
      if (j < nrhs)
        y[(static_cast<int64_t>(j) * n_shards + s) * rc_pad + q] = acc[j];
  }
}

// ------------------------------------------------------------------------
// Balanced (nnz-binned COO): replaces balanced_spmv_pallas
// (src/repro/kernels/spmv_bcsr.py:268, body _balanced_kernel :239).
//
//   y[r] = sum over the entries k of row r of vals[k] * x[cols[k]]
//
// over the flat (nbins * nnz_pad) streams, where bin t holds its rows'
// entries in row order at [t * nnz_pad, t * nnz_pad + bin_nnz[t]).  The TPU
// kernel reduces each nnz chunk into the bin's (rows_pad,) output with a
// one-hot MXU matmul over lrows, only because Mosaic has no scatter-add,
// and a gather (out_gather) picks the rows out after it.  Both are
// dropped.  The port's warp map (BalancedCOO.warp_map, built on the host)
// tiles each bin's real rows in runs of 32 that never cross a bin: warp w
// reads (first row, row count, first entry), lane i < count takes row
// first + i and its length row_lens[first + i], and since a bin's rows lie
// back to back the warp's rows are one contiguous entry range, walked
// coalesced by warp_segment_sum with no search.  Each lane writes its row
// straight into the flat (n_rows,) y.  The launch covers the real rows
// only -- no rows_pad tail, no (nbins, rows_pad) intermediate, no lrows
// read -- and a warp waits on nothing but its own __syncwarp.
//
// Each row is summed by one lane in entry order with fmaf and no atomics,
// so y is the same bit for bit from launch to launch.  It can differ in
// the last bits from the block-per-256-rows kernel it replaced, which
// rounded each product before adding it (PERF.md).
//
// Bound: device-memory bytes, as ELL: 8 B per real entry in f32 (6 B in
// bf16: value + int32 column) and two flops, plus the 4 B row length and
// 4 B write per row, 12 B of map per warp and the x reads.  Known limits
// (PERF.md): the staging round trip through shared memory, which the ELL
// and SELL kernels share.
// ------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
balanced_kernel(const T* __restrict__ vals, const int32_t* __restrict__ cols,
                const int32_t* __restrict__ row_lens,
                const int32_t* __restrict__ warp_map, int n_warps,
                const float* __restrict__ x, float* __restrict__ y) {
  __shared__ float s_v[kWarps][kWarpChunk];
  __shared__ float s_x[kWarps][kWarpChunk];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= n_warps) return;            // the whole warp: no shuffle waits
  const int first = warp_map[3 * w];
  const int count = warp_map[3 * w + 1];
  const int64_t entry = warp_map[3 * w + 2];
  const int len = lane < count ? row_lens[first + lane] : 0;
  const float acc = warp_segment_sum<T, true>(
      0.0f, vals, cols, x, entry, len, s_v[warp], s_x[warp]);
  if (lane < count) y[first + lane] = acc;
}

}  // namespace

extern "C" {

// vals_bf16: 0 -> float32 storage, 1 -> bfloat16.  wo == 0 is the
// halo-free kernel (ovals/ocols/olens/x_ghost are then not read).  dlens/
// olens: per-row entry counts, clamped to [0, wd] / [0, wo].
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
    ell_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dvals), dcols, dlens, wd,
        static_cast<const __nv_bfloat16*>(ovals), ocols, olens, wo, x_local,
        xl_stride, x_ghost, xg_stride, y, rows, n_core);
  } else {
    ell_kernel<float, false><<<grid, kThreads, 0, st>>>(
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
    sell_kernel<__nv_bfloat16, false><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dvals), dcols, dstart, dwidth,
        d_len, static_cast<const __nv_bfloat16*>(ovals), ocols, ostart,
        owidth, o_len, has_offd, n_slices, slice_height, x_local, xl_stride,
        x_ghost, xg_stride, y, rc_pad, n_core);
  } else {
    sell_kernel<float, false><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(dvals), dcols, dstart, dwidth, d_len,
        static_cast<const float*>(ovals), ocols, ostart, owidth, o_len,
        has_offd, n_slices, slice_height, x_local, xl_stride, x_ghost,
        xg_stride, y, rc_pad, n_core);
  }
  return static_cast<int>(cudaGetLastError());
}

// The batched entry points: x_local and x_ghost column-interleaved,
// (n_node, xl_width | xg_width, KT) float32 with KT = 4, 8 or 16 the
// smallest that holds nrhs (ops.interleave_rhs), 16-byte aligned; y
// (nrhs, n_shards, rows | rc_pad); the other arguments as the single-column
// entry points take them.  1 <= nrhs <= kMaxRhs, else cudaErrorInvalidValue
// and nothing is launched.
#define REPRO_BY_TILE(NRHS, LAUNCH) \
  if ((NRHS) <= 4) {                \
    LAUNCH(4);                      \
  } else if ((NRHS) <= 8) {         \
    LAUNCH(8);                      \
  } else {                          \
    LAUNCH(16);                     \
  }

int repro_ell_spmv_batched(int vals_bf16, const void* dvals,
                           const int32_t* dcols, const int32_t* dlens,
                           int wd, const void* ovals, const int32_t* ocols,
                           const int32_t* olens, int wo,
                           const float* x_local, int64_t xl_width,
                           const float* x_ghost, int64_t xg_width,
                           float* y, int n_shards, int n_core, int rows,
                           int nrhs, void* stream) {
  if (nrhs < 1 || nrhs > kMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || n_shards <= 0) return 0;
  const dim3 grid((rows + kBThreads - 1) / kBThreads, n_shards);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* xl = reinterpret_cast<const float4*>(x_local);
  const float4* xg = reinterpret_cast<const float4*>(x_ghost);
#define REPRO_LAUNCH_T(T, KT)                                           \
  ell_batched_kernel<T, KT, false><<<grid, kBThreads, 0, st>>>(         \
      static_cast<const T*>(dvals), dcols, dlens, wd,                   \
      static_cast<const T*>(ovals), ocols, olens, wo, xl,               \
      xl_width * (KT / 4), xg, xg_width * (KT / 4), y, rows, n_core,    \
      n_shards, nrhs)
  if (vals_bf16) {
#define REPRO_LAUNCH(KT) REPRO_LAUNCH_T(__nv_bfloat16, KT)
    REPRO_BY_TILE(nrhs, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  } else {
#define REPRO_LAUNCH(KT) REPRO_LAUNCH_T(float, KT)
    REPRO_BY_TILE(nrhs, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
#undef REPRO_LAUNCH_T
  return static_cast<int>(cudaGetLastError());
}

int repro_sell_spmv_batched(int vals_bf16, const void* dvals,
                            const int32_t* dcols, const int32_t* dstart,
                            const int32_t* dwidth, int64_t d_len,
                            const void* ovals, const int32_t* ocols,
                            const int32_t* ostart, const int32_t* owidth,
                            int64_t o_len, int has_offd, int n_slices,
                            int slice_height, const float* x_local,
                            int64_t xl_width, const float* x_ghost,
                            int64_t xg_width, float* y, int n_shards,
                            int n_core, int rc_pad, int nrhs, void* stream) {
  if (nrhs < 1 || nrhs > kMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc_pad <= 0 || n_shards <= 0) return 0;
  const dim3 grid((rc_pad + kBThreads - 1) / kBThreads, n_shards);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* xl = reinterpret_cast<const float4*>(x_local);
  const float4* xg = reinterpret_cast<const float4*>(x_ghost);
#define REPRO_LAUNCH_T(T, KT)                                           \
  sell_batched_kernel<T, KT, false><<<grid, kBThreads, 0, st>>>(        \
      static_cast<const T*>(dvals), dcols, dstart, dwidth, d_len,       \
      static_cast<const T*>(ovals), ocols, ostart, owidth, o_len,       \
      has_offd, n_slices, slice_height, xl, xl_width * (KT / 4), xg,    \
      xg_width * (KT / 4), y, rc_pad, n_core, n_shards, nrhs)
  if (vals_bf16) {
#define REPRO_LAUNCH(KT) REPRO_LAUNCH_T(__nv_bfloat16, KT)
    REPRO_BY_TILE(nrhs, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  } else {
#define REPRO_LAUNCH(KT) REPRO_LAUNCH_T(float, KT)
    REPRO_BY_TILE(nrhs, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
#undef REPRO_LAUNCH_T
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------------
// The offd pass onto a diagonal partial: the second launch of the split
// two-phase SpMV that task/balanced run on a process mesh, where the halo
// exchange is in flight while the diag pass (ell with wo == 0, sell with
// no offd: B3's and B4's launches) runs.  PETSc's MatMult_MPIAIJ does the
// same: A_d * x_local, then y += A_o * x_ghost once the scatter ends.
//
//   y[s, r] += sum_{k < olen[s, r]} ovals[s, r, k] * x_ghost[node(s), ocols[s, r, k]]
//
// It is the same kernel (kSeeded = true) with the offd stream in the
// diag stream's place and no second stream, each lane's accumulator
// seeded with its y (the partial the diag pass wrote) instead of 0.  The
// fused kernel keeps the diag partial in that register and continues the
// fmaf chain over the offd entries; here the chain stops at the f32 store
// of y and resumes from its load, so each row's sum is the fused kernel's
// bit for bit.  In place: each lane reads its own y through the one y
// pointer before it writes it, so y stays __restrict__, and the unseeded
// instantiations compile as before.
//
// Bound: device-memory bytes, the offd stream as the fused kernel reads
// it plus y twice (read, then written).
// ------------------------------------------------------------------------
int repro_ell_spmv_onto(int vals_bf16, const void* ovals,
                        const int32_t* ocols, const int32_t* olens, int wo,
                        const float* x_ghost, int64_t xg_stride, float* y,
                        int n_shards, int n_core, int rows, void* stream) {
  if (rows <= 0 || n_shards <= 0 || wo <= 0) return 0;
  const dim3 grid((rows + kThreads - 1) / kThreads, n_shards);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    ell_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(ovals), ocols, olens, wo, nullptr,
        nullptr, nullptr, 0, x_ghost, xg_stride, nullptr, 0, y, rows,
        n_core);
  } else {
    ell_kernel<float, true><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(ovals), ocols, olens, wo, nullptr, nullptr,
        nullptr, 0, x_ghost, xg_stride, nullptr, 0, y, rows, n_core);
  }
  return static_cast<int>(cudaGetLastError());
}

int repro_sell_spmv_onto(int vals_bf16, const void* ovals,
                         const int32_t* ocols, const int32_t* ostart,
                         const int32_t* owidth, int64_t o_len, int n_slices,
                         int slice_height, const float* x_ghost,
                         int64_t xg_stride, float* y, int n_shards,
                         int n_core, int rc_pad, void* stream) {
  if (rc_pad <= 0 || n_shards <= 0) return 0;
  const dim3 grid((rc_pad + kThreads - 1) / kThreads, n_shards);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    sell_kernel<__nv_bfloat16, true><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(ovals), ocols, ostart, owidth,
        o_len, nullptr, nullptr, nullptr, nullptr, 0, 0, n_slices,
        slice_height, x_ghost, xg_stride, nullptr, 0, y, rc_pad, n_core);
  } else {
    sell_kernel<float, true><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(ovals), ocols, ostart, owidth, o_len,
        nullptr, nullptr, nullptr, nullptr, 0, 0, n_slices, slice_height,
        x_ghost, xg_stride, nullptr, 0, y, rc_pad, n_core);
  }
  return static_cast<int>(cudaGetLastError());
}

// The batched offd passes: x_ghost column-interleaved as the batched entry
// points take it, y (nrhs, n_shards, rows | rc_pad) the batched diag
// pass's output, added onto in place.
int repro_ell_spmv_onto_batched(int vals_bf16, const void* ovals,
                                const int32_t* ocols, const int32_t* olens,
                                int wo, const float* x_ghost,
                                int64_t xg_width, float* y, int n_shards,
                                int n_core, int rows, int nrhs,
                                void* stream) {
  if (nrhs < 1 || nrhs > kMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || n_shards <= 0 || wo <= 0) return 0;
  const dim3 grid((rows + kBThreads - 1) / kBThreads, n_shards);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* xg = reinterpret_cast<const float4*>(x_ghost);
#define REPRO_LAUNCH_T(T, KT)                                           \
  ell_batched_kernel<T, KT, true><<<grid, kBThreads, 0, st>>>(          \
      static_cast<const T*>(ovals), ocols, olens, wo, nullptr, nullptr, \
      nullptr, 0, xg, xg_width * (KT / 4), nullptr, 0, y, rows, n_core, \
      n_shards, nrhs)
  if (vals_bf16) {
#define REPRO_LAUNCH(KT) REPRO_LAUNCH_T(__nv_bfloat16, KT)
    REPRO_BY_TILE(nrhs, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  } else {
#define REPRO_LAUNCH(KT) REPRO_LAUNCH_T(float, KT)
    REPRO_BY_TILE(nrhs, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
#undef REPRO_LAUNCH_T
  return static_cast<int>(cudaGetLastError());
}

int repro_sell_spmv_onto_batched(int vals_bf16, const void* ovals,
                                 const int32_t* ocols, const int32_t* ostart,
                                 const int32_t* owidth, int64_t o_len,
                                 int n_slices, int slice_height,
                                 const float* x_ghost, int64_t xg_width,
                                 float* y, int n_shards, int n_core,
                                 int rc_pad, int nrhs, void* stream) {
  if (nrhs < 1 || nrhs > kMaxRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc_pad <= 0 || n_shards <= 0) return 0;
  const dim3 grid((rc_pad + kBThreads - 1) / kBThreads, n_shards);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* xg = reinterpret_cast<const float4*>(x_ghost);
#define REPRO_LAUNCH_T(T, KT)                                           \
  sell_batched_kernel<T, KT, true><<<grid, kBThreads, 0, st>>>(         \
      static_cast<const T*>(ovals), ocols, ostart, owidth, o_len,       \
      nullptr, nullptr, nullptr, nullptr, 0, 0, n_slices, slice_height, \
      xg, xg_width * (KT / 4), nullptr, 0, y, rc_pad, n_core, n_shards, \
      nrhs)
  if (vals_bf16) {
#define REPRO_LAUNCH(KT) REPRO_LAUNCH_T(__nv_bfloat16, KT)
    REPRO_BY_TILE(nrhs, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  } else {
#define REPRO_LAUNCH(KT) REPRO_LAUNCH_T(float, KT)
    REPRO_BY_TILE(nrhs, REPRO_LAUNCH)
#undef REPRO_LAUNCH
  }
#undef REPRO_LAUNCH_T
  return static_cast<int>(cudaGetLastError());
}

#undef REPRO_BY_TILE

// Output (n_rows,), every row written once: warp_map (n_warps, 3) tiles
// the rows, its entry offsets index the flat vals/cols.
int repro_balanced_spmv(int vals_bf16, const void* vals, const int32_t* cols,
                        const int32_t* row_lens, const int32_t* warp_map,
                        int n_warps, const float* x, float* y, void* stream) {
  if (n_warps <= 0) return 0;
  const int grid = (n_warps + kWarps - 1) / kWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    balanced_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(vals), cols, row_lens, warp_map,
        n_warps, x, y);
  } else {
    balanced_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(vals), cols, row_lens, warp_map, n_warps,
        x, y);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
