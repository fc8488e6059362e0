// Hopper (sm_90a) leaf-scan kernel: the buffered brute-force kNN scan of
// the buffer k-d tree (the paper's ProcessAllBuffers step).
//
// Replaces the Pallas TPU kernel src/repro/kernels/knn_scan.py::
// leaf_scan_pallas (body `_kernel`, helpers `_dist_tile`, `_extract_topk`,
// `_rank_merge`).  It computes the same function: per work unit (a query
// tile of TQ rows and one leaf slab of L_pad rows) the kl smallest squared
// distances ||q||^2 - 2 q.x + ||x||^2 (clamped at 0), ascending, with their
// local slab row indices.  Ties resolve to the lowest slab index, as
// `lax.top_k` does, and the list starts at +inf with a maximal index so
// PAD_COORD rows (distance ~ d * 1e36) fill the tail in index order when a
// leaf holds fewer than kl real rows, exactly like the plain reference.
//
// What bounds it on this card.  Per (query, slab row) pair the function
// needs d FMAs for q.x plus a few operations to form, clamp and compare the
// distance, 2d+3 fp32 operations; every slab row is reused by all TQ
// queries of the unit, so at the main-path shape (TQ=128, d=10,
// L_pad=4096) that is 23 operations against ~0.3 byte of slab per pair: it
// is bound by fp32 operations (67 TFLOP/s on the CUDA cores), not by device
// memory (3.35 TB/s).  Rows arrive at their own width d (the main path does
// not pad them); the kernel pads them with zeros up to its template width
// DPAD (8, 16, 32, 64 or 128), so it issues DPAD FMAs per pair, 16 for
// d=10.  TF32 tensor cores would be faster but keep only ~3 decimal
// digits, which can drop a true neighbour, so the distance stays in full
// fp32 FFMA.
//
// What the design does about it.  One block per plan row, one thread per
// query row: the query vector and the running top-k list live in registers
// (KMAX-wide, fully unrolled insertion with predicated selects, so no local
// memory).  Slab rows are staged through shared memory in tiles of TILE
// rows, with ||x||^2 computed once per row per block, and every thread
// reads the same shared address in the inner loop (a broadcast, no bank
// conflicts).  The block loads its own indices (unit_leaf, unit_query),
// which replaces the TPU's BlockSpec index maps and keeps the query tiles
// and slabs from being gathered into copies in device memory.  Plan rows at
// or beyond *n_units (read from device memory) return at once, so the
// caller launches over every plan row with no host read.  For kl > 32 the
// list moves to shared memory (layout [kl][TQ], one column per thread).
//
// Plain C interface, loaded with ctypes (src/repro_torch/kernels/build.py).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int TILE = 128;       // slab rows staged in shared memory per pass
constexpr int MAX_TQ = 128;     // threads per block = query rows per unit
constexpr int MAX_K_SMEM = 128; // largest kl (shared-memory list)
constexpr int MAX_DPAD = 128;   // largest feature width

// Stage slab rows [r0, r0 + rows) of one leaf into shared memory, padded
// with zeros from d_pad up to DPAD columns, then compute ||x||^2 per row.
template <int DPAD>
__device__ __forceinline__ void stage_tile(const float* __restrict__ xl,
                                           int r0, int rows, int d_pad,
                                           float* xs, float* xn) {
  __syncthreads();  // every thread is done with the previous tile
  for (int e = threadIdx.x; e < rows * DPAD; e += blockDim.x) {
    const int r = e / DPAD;
    const int j = e % DPAD;
    xs[e] = j < d_pad ? xl[(size_t)(r0 + r) * d_pad + j] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < DPAD; ++j) s = fmaf(xs[r * DPAD + j], xs[r * DPAD + j], s);
    xn[r] = s;
  }
  __syncthreads();
}

// The query row this thread owns (zeros for an empty slot, as the plain
// version's masked gather gives), and its squared norm.
template <int DPAD>
__device__ __forceinline__ float load_query(const float* __restrict__ qpad,
                                            int qrow, int d_pad, float* q) {
  float qn = 0.f;
#pragma unroll
  for (int j = 0; j < DPAD; ++j) {
    const float v = (qrow >= 0 && j < d_pad) ? qpad[(size_t)qrow * d_pad + j] : 0.f;
    q[j] = v;
    qn = fmaf(v, v, qn);
  }
  return qn;
}

template <int DPAD>
__device__ __forceinline__ float sq_dist(const float* q, float qn,
                                         const float* xrow, float xn) {
  float cross = 0.f;
#pragma unroll
  for (int j = 0; j < DPAD; ++j) cross = fmaf(q[j], xrow[j], cross);
  return fmaxf(qn - 2.f * cross + xn, 0.f);
}

// Register list: top-KMAX of the slab; the first kl entries are the top-kl.
template <int KMAX, int DPAD>
__global__ void __launch_bounds__(MAX_TQ)
leaf_scan_reg_kernel(const float* __restrict__ qpad,
                     const float* __restrict__ slab,
                     const int* __restrict__ unit_leaf,
                     const int* __restrict__ unit_query,
                     const int* __restrict__ n_units,
                     float* __restrict__ out_d, int* __restrict__ out_i,
                     int tq, int l_pad, int d_pad, int kl) {
  const int w = blockIdx.x;
  if (w >= *n_units) return;  // uniform per block: before any barrier
  extern __shared__ float smem[];
  float* xs = smem;
  float* xn = xs + TILE * DPAD;

  const int t = threadIdx.x;
  const float* xl = slab + (size_t)unit_leaf[w] * l_pad * d_pad;
  float q[DPAD];
  const float qn = load_query<DPAD>(qpad, unit_query[(size_t)w * tq + t], d_pad, q);

  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = INFINITY;
    bi[j] = INT_MAX;
  }

  for (int r0 = 0; r0 < l_pad; r0 += TILE) {
    const int rows = min(TILE, l_pad - r0);
    stage_tile<DPAD>(xl, r0, rows, d_pad, xs, xn);
    for (int r = 0; r < rows; ++r) {
      const float dist = sq_dist<DPAD>(q, qn, xs + r * DPAD, xn[r]);
      if (dist < bd[KMAX - 1]) {
        // insert at the first position p with dist < bd[p] (strict: an
        // equal distance goes after the lower index already held)
        const int idx = r0 + r;
#pragma unroll
        for (int j = KMAX - 1; j > 0; --j) {
          const bool shift = dist < bd[j - 1];
          const bool place = !shift && dist < bd[j];
          bd[j] = shift ? bd[j - 1] : (place ? dist : bd[j]);
          bi[j] = shift ? bi[j - 1] : (place ? idx : bi[j]);
        }
        if (dist < bd[0]) {
          bd[0] = dist;
          bi[0] = idx;
        }
      }
    }
  }
  const size_t o = ((size_t)w * tq + t) * kl;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < kl) {
      out_d[o + j] = bd[j];
      out_i[o + j] = bi[j];
    }
  }
}

// Shared-memory list of exactly kl entries per thread, for 32 < kl <= 128.
template <int DPAD>
__global__ void __launch_bounds__(MAX_TQ)
leaf_scan_smem_kernel(const float* __restrict__ qpad,
                      const float* __restrict__ slab,
                      const int* __restrict__ unit_leaf,
                      const int* __restrict__ unit_query,
                      const int* __restrict__ n_units,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      int tq, int l_pad, int d_pad, int kl) {
  const int w = blockIdx.x;
  if (w >= *n_units) return;
  extern __shared__ float smem[];
  float* xs = smem;
  float* xn = xs + TILE * DPAD;
  float* ld = xn + TILE;                    // [kl][tq]
  int* li = reinterpret_cast<int*>(ld + (size_t)kl * tq);

  const int t = threadIdx.x;
  const float* xl = slab + (size_t)unit_leaf[w] * l_pad * d_pad;
  float q[DPAD];
  const float qn = load_query<DPAD>(qpad, unit_query[(size_t)w * tq + t], d_pad, q);
  for (int j = 0; j < kl; ++j) {
    ld[j * tq + t] = INFINITY;
    li[j * tq + t] = INT_MAX;
  }

  for (int r0 = 0; r0 < l_pad; r0 += TILE) {
    const int rows = min(TILE, l_pad - r0);
    stage_tile<DPAD>(xl, r0, rows, d_pad, xs, xn);
    for (int r = 0; r < rows; ++r) {
      const float dist = sq_dist<DPAD>(q, qn, xs + r * DPAD, xn[r]);
      if (dist < ld[(kl - 1) * tq + t]) {
        int j = kl - 1;
        while (j > 0 && dist < ld[(j - 1) * tq + t]) {
          ld[j * tq + t] = ld[(j - 1) * tq + t];
          li[j * tq + t] = li[(j - 1) * tq + t];
          --j;
        }
        ld[j * tq + t] = dist;
        li[j * tq + t] = r0 + r;
      }
    }
  }
  const size_t o = ((size_t)w * tq + t) * kl;
  for (int j = 0; j < kl; ++j) {
    out_d[o + j] = ld[j * tq + t];
    out_i[o + j] = li[j * tq + t];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int w_rows, int tq,
                   cudaStream_t stream, const float* qpad, const float* slab,
                   const int* unit_leaf, const int* unit_query,
                   const int* n_units, float* out_d, int* out_i, int l_pad,
                   int d_pad, int kl) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<w_rows, tq, smem, stream>>>(qpad, slab, unit_leaf, unit_query,
                                       n_units, out_d, out_i, tq, l_pad,
                                       d_pad, kl);
  return cudaGetLastError();
}

template <int DPAD>
cudaError_t dispatch_k(int w_rows, int tq, cudaStream_t stream,
                       const float* qpad, const float* slab,
                       const int* unit_leaf, const int* unit_query,
                       const int* n_units, float* out_d, int* out_i,
                       int l_pad, int d_pad, int kl) {
  const size_t tile = (size_t)(TILE * DPAD + TILE) * sizeof(float);
#define LEAF_SCAN_REG(KMAX)                                                  \
  return launch(leaf_scan_reg_kernel<KMAX, DPAD>, tile, w_rows, tq, stream,  \
                qpad, slab, unit_leaf, unit_query, n_units, out_d, out_i,    \
                l_pad, d_pad, kl)
  if (kl <= 4) LEAF_SCAN_REG(4);
  if (kl <= 8) LEAF_SCAN_REG(8);
  if (kl <= 16) LEAF_SCAN_REG(16);
  if (kl <= 32) LEAF_SCAN_REG(32);
#undef LEAF_SCAN_REG
  const size_t list = (size_t)kl * tq * (sizeof(float) + sizeof(int));
  return launch(leaf_scan_smem_kernel<DPAD>, tile + list, w_rows, tq, stream,
                qpad, slab, unit_leaf, unit_query, n_units, out_d, out_i,
                l_pad, d_pad, kl);
}

}  // namespace

extern "C" {

// Limits the wrapper checks before it calls leaf_scan_units.
int leaf_scan_max_k() { return MAX_K_SMEM; }
int leaf_scan_max_d_pad() { return MAX_DPAD; }
int leaf_scan_max_tq() { return MAX_TQ; }

// qpad f32[m, d_pad]; slab f32[C, l_pad, d_pad]; unit_leaf i32[w_rows]
// (leaf index into slab); unit_query i32[w_rows, tq] (row of qpad, -1 for
// an empty slot); n_units i32[1] on the device.  Writes out_d f32 and
// out_i i32 [w_rows, tq, kl] for plan rows < *n_units only.  Returns 0 or a
// cudaError_t; -1 for arguments outside the limits above.
int leaf_scan_units(const float* qpad, const float* slab,
                    const int* unit_leaf, const int* unit_query,
                    const int* n_units, float* out_d, int* out_i, int w_rows,
                    int tq, int l_pad, int d_pad, int kl, void* stream) {
  if (w_rows <= 0) return 0;
  if (tq < 1 || tq > MAX_TQ || kl < 1 || kl > MAX_K_SMEM || kl > l_pad ||
      d_pad < 1 || d_pad > MAX_DPAD)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_pad <= 8)
    return dispatch_k<8>(w_rows, tq, s, qpad, slab, unit_leaf, unit_query,
                         n_units, out_d, out_i, l_pad, d_pad, kl);
  if (d_pad <= 16)
    return dispatch_k<16>(w_rows, tq, s, qpad, slab, unit_leaf, unit_query,
                          n_units, out_d, out_i, l_pad, d_pad, kl);
  if (d_pad <= 32)
    return dispatch_k<32>(w_rows, tq, s, qpad, slab, unit_leaf, unit_query,
                          n_units, out_d, out_i, l_pad, d_pad, kl);
  if (d_pad <= 64)
    return dispatch_k<64>(w_rows, tq, s, qpad, slab, unit_leaf, unit_query,
                          n_units, out_d, out_i, l_pad, d_pad, kl);
  return dispatch_k<128>(w_rows, tq, s, qpad, slab, unit_leaf, unit_query,
                         n_units, out_d, out_i, l_pad, d_pad, kl);
}

const char* leaf_scan_error_string(int code) {
  if (code == -1) return "argument outside the kernel's limits";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
