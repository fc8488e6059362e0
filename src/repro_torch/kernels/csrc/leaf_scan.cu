// Hopper (sm_90a) leaf-scan kernels: the buffered brute-force kNN scan of
// the buffer k-d tree (the paper's ProcessAllBuffers step).
//
// Replaces the Pallas TPU kernel src/repro/kernels/knn_scan.py::
// leaf_scan_pallas (body `_kernel`, helpers `_dist_tile`, `_extract_topk`,
// `_rank_merge`).  It computes the same function: per work unit (a query
// tile of TQ rows and one leaf slab of L_pad rows) the kl smallest squared
// distances ||q||^2 - 2 q.x + ||x||^2 (clamped at 0), ascending, with their
// local slab row indices.  Ties resolve to the lowest slab index, as
// `lax.top_k` does, and every list starts at +inf with a maximal index so
// PAD_COORD rows (distance ~ d * 1e36) fill the tail in index order when a
// leaf holds fewer than kl real rows, exactly like the plain reference.
// Any kl <= L_pad and any width d >= 1 are taken.
//
// What bounds it on this card.  Per (query, slab row) pair the function
// needs d FMAs for q.x plus a few operations to form, clamp and compare the
// distance, 2d+3 fp32 operations; every slab row is reused by all TQ
// queries of the unit, so at the main-path shape (TQ=128, d=10,
// L_pad=4096) that is 23 operations against ~0.3 byte of slab per pair: it
// is bound by fp32 issue on the CUDA cores (67 TFLOP/s), not by device
// memory (3.35 TB/s).  Everything below is about issue slots per pair.
//
// What the design does about it (narrow kernel, d <= 16, the main path):
//  * Exact widths.  Instances at d rounded up to an even width DW issue DW
//    FMAs per pair (10 at d=10), with the query in registers.
//  * Norm and -2 folded out of the pair loop.  Each slab row is staged once
//    per block as [x, ||x||^2, 0 pad] (16-byte aligned, read with LDS.128
//    broadcasts) and the query is held as -2q (the same exact products as
//    staging -2x), so a pair is the FMA chain acc = ||x||^2 + sum_j (-2 q_j)
//    x_j and one compare.  The distance max(acc + ||q||^2, 0) is only formed
//    for rows that pass.
//  * With a register list, two queries per thread share every
//    shared-memory load of a row (1.5 LDS.128 per pair at d=10 instead of 3)
//    and give two independent FMA chains per row; 32 rows are unrolled per
//    filter pass.
//  * The compare is against a per-query bound derived from the list's
//    current kl-th distance: acc < (thr - ||q||^2 rounded up) holds for
//    every row whose exact clamped distance is < thr, so it never drops a
//    row.  The list is sized to kl exactly (register lists of KMAX >= kl
//    entries keep -inf sentinels in front, so the threshold is the kl-th).
//  * Deferred inserts.  A 64-row tile is first filtered into two 32-bit
//    masks per query (the mask bit is the sign of acc - bound, one FADD and
//    one funnel shift per pair); then each query inserts its passing rows
//    in ascending row order with a strict `<`, each re-computed and
//    re-checked against the list as it is then (in the first tile, where
//    the bound starts infinite, after each 32-row pass).  A warp pays the largest per-lane insert count
//    per tile, not the union of the rows where any lane inserts, and the
//    tie order stays exact (a later row never displaces an equal distance).
//  * Slab tiles are double-buffered with cp.async: each thread copies its
//    own rows of tile i+2 while the block computes tile i, waits for its
//    own copies, writes the staged rows and meets the block at one
//    __syncthreads per tile (staged rows are double-buffered too).
//  * Registers over occupancy (register lists): 2 queries x (DW
//    coordinates + a KMAX list) per thread take ~106 registers at d=10,
//    k=10 (18 warps per SM).  Variants measured slower on an H100 at the
//    main-path shape: one query per thread (higher occupancy, twice the
//    shared loads), four per thread, one warp per block, lane pairs that
//    split a tile's rows (half the shared loads), short unrolled row loops,
//    and both slots' inserts in one loop.
// What still holds it back (H100, main-path shape): the filter, staging
// included, takes more than half of the kernel's time below the issue
// rate its instruction count allows, and the inserts the rest.  A warp's
// insert loop runs once per passing row of its busiest lane, about twice
// the average lane's count on random data at k=10, and each iteration
// re-computes the row's chain and rewrites the whole register list with
// compares, selects and min/max on the half-rate ALU pipe.
//
// Lists longer than 16 (the quantized path's k + 8 = 18 and the refining
// pass's k + 64 = 74 at k = 10).  The design before this one, a sorted
// list in shared memory taking each row by insertion, pays a chain of
// dependent loads per shift, half the list on average, and a warp waits
// for the lane that shifts most: 112-113 ms at k = 74 on an H100 at 700 W,
// 150x its bound.  Measured against it at the main-path shape: a sorted
// list behind a register buffer of 8 or 16 entries merged by rank (38-47
// ms at k = 74, and slower than insertion at k = 18: the merge's binary
// searches and moves cost more than the shifts they save, and the buffer
// takes 168 registers), register lists of 24 and 32 entries at k = 18
// (4.1 and 4.7 ms), and lists in the output rows (each lane's accesses
// touch a cache line of their own: 1.4-5x slower than in shared memory).
// The fastest is a max-heap of 64-bit keys in shared memory with one query
// per thread (13.2 ms at k = 74, 3.2 ms at k = 18): an insert is at most
// log2(kl) levels of a two-child compare, a key orders (distance, index)
// in one compare, and one query per thread doubles the warps that hide the
// loads where the list's shared memory (8 bytes x kl x 128 slots) leaves
// room for few blocks.
// What still holds the heap back: at k = 74 a block takes 87 KB of shared
// memory, so 2 blocks (8 warps) fit on an SM, and with so few warps the
// filter alone runs at about half its rate (the k = 16 register list
// takes 3.0 ms, and 6.2 ms when launched with 87 KB of shared memory);
// each sift level is a dependent shared-memory load, and the final
// heapsort costs about kl more sifts per query.
//
// Wide kernel (d > 16: the paper's d up to 30, and any wider row).  Bound
// by fp32 issue like the narrow kernel: 2d+3 operations per pair, at
// W=4096, TQ=128, L_pad=4096 8.43 ms for d = 130 and 2.02 ms for d = 30 at
// 67 TFLOP/s, against 2.2 and 0.5 ms of bytes.  The design before this one
// ran 57.5 ms at d = 130, k = 10 and 211 ms at k = 74 on an H100 at 700 W
// (the library's baddbmm + topk: 57.2 and 60.4 ms): a sorted list in
// shared memory taking each row by insertion, sub-tiles of 32 rows staged
// 16 features at a time with no pipeline (two barriers per chunk, a branch
// and a dead-row test per element), row norms walked from device memory by
// one warp while three waited, -2q reloaded from device memory per
// sub-tile, one FMA per shared-memory load, inserts inline in the row loop.
// This design (the kernel's own comment has the details):
//  * the narrow kernel's lists (a register list for k <= 16, the heap of
//    64-bit keys beyond, in shared memory while it fits), one slot per
//    thread, 128 threads;
//  * pieces of 32 whole rows double-buffered through shared memory, fp32
//    copied coalesced with 16/8/4-byte cp.async straight into the staged
//    layout, codes as raw bytes (copy_raw_tile, shared with the narrow
//    kernel) decoded once, four threads to a row; rows padded to an odd
//    number of 16-byte words;
//  * -2q of every slot staged once per unit; a register-tiled product in
//    each warp (4 slots x 8 rows per lane, 4 features a step: 128 FMAs per
//    12 shared-memory loads);
//  * the filter, the masks and the inserts in the warp, by shuffles, each
//    insert taking the accumulator its row group's lane formed: one block
//    barrier per piece, no second chain;
//  * rows too wide for -2q and two pieces in shared memory (fp32 past
//    d = 300) go in chunks of 128 features, -2q and the norms read from
//    device memory (correct, not tuned).
// Earlier versions, timed by scripts/leaf_scan_wide.py (PERF.md), at
// d = 130, k = 10: one slot per thread with 32 accumulators and a
// broadcast LDS.128 per 4 FMAs (31.2 ms: the shared-memory pipe was the
// limit); the same tile across the block's warps with masks in shared
// memory and each insert re-forming its row's chain (29.0 ms); norms
// walked in device memory inside the product (33.4 ms); the next step's
// -2q and first row loaded ahead (23.3 ms, but 9.3 against 7.6 ms at
// d = 30, k = 16: 199 registers, fewer blocks per SM).
// What still holds it back: the product runs at about a third of the
// fp32 rate at d = 130; -2q of 128 slots (67.6 KB at d = 130) and two
// pieces leave room for 2 blocks (8 warps) per SM, 1 with a k = 74 heap,
// too few to hide the shared-memory loads' latency.
// The chain is the narrow kernel's (||x||^2, then -2q_j x_j in feature
// order; zero pad features add exact zeros), so the two agree bit for bit.
//
// Tensor cores are not used.  TF32 alone keeps ~3 decimal digits and can
// drop a true neighbour; a split (3xTF32) product keeps fp32 accuracy but
// runs three MMA passes with K padded to 8/16: at d=10 that is 48 MMA
// depth units per pair against 10 FFMAs, plus a round trip of every
// distance tile through shared memory before selection.  3xTF32 runs at
// 495/3 = 165 TFLOP/s against FFMA's 67, so it pays only once the product
// dominates the per-pair selection work and K pads little: from d of about
// 64 on (ROADMAP Queue 2).
//
// Codes.  A slab may hold fp32 rows, float16 codes or uint8 codes with a
// per-leaf, per-feature scale and offset (the budgeted leaf store,
// core/chunked.py), plus a bit-packed dead-row mask (np.packbits order, row
// r in bit 7 - r%8 of byte r/8).  The code type is a runtime argument read
// where a tile is copied and staged; the pair loop, filter and lists never
// see it.  For codes the block copies the tile's raw byte range with
// 4-byte cp.async in whole words (a leaf's base need not be 4-byte
// aligned: uint8 at odd d) and plain loads for the up to 3 bytes at either
// end, then, after one barrier, stages each row dequantized:
// code * scale + offset rounded twice (__fmul_rn, __fadd_rn, as the plain
// version's torch multiply and add) for uint8, an exact cast for float16.
// A dead row is staged as PAD_COORD in every real column, like an fp32
// pad row, so it loses every contest and fills the tail in index order.
// This is what the reference does in jnp around the Pallas kernel
// (repro/core/chunked_jit.py::_chunk_round), with no fp32 copy of the
// chunk: the scan reads 1 or 2 bytes per coordinate instead of 4.  The
// fp32 path copies and stages exactly as before.
//
// Every instance, narrow or wide, forms the same floating-point values (the
// FMA chain in feature order from ||x||^2, zero columns adding exact
// zeros), so they agree bit for bit with each other.  The Python wrapper
// (src/repro_torch/kernels/knn_scan.py::choose_variant) picks the instance,
// block width, list placement and dynamic shared memory; this file checks
// the choice and launches it.  Plain C interface, loaded with ctypes.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <math.h>
#include <type_traits>

// Each library holds the instances of one part: LEAF_SCAN_PART = a narrow
// width (2, 4, ..., 16), or 0 for the wide kernel.  The parts build side by
// side (build.py::build_all).
#ifndef LEAF_SCAN_PART
#error "compile with -DLEAF_SCAN_PART=<narrow width, or 0 for the wide kernel>"
#endif

namespace {

constexpr int MAX_TQ = 128;       // query rows per unit (one block)
constexpr int TILE = 64;          // narrow: slab rows per pipeline stage
constexpr int PASS = 32;          // narrow: rows per filter mask word
constexpr int WROWS = 32;         // wide: slab rows per piece (one filter pass)
constexpr int WQT = 4;            // wide: queries per thread in the product tile
constexpr int WRT = 8;            // wide: rows per thread in the product tile
constexpr int WTHREADS = 128;     // wide: threads per block (32 query x 4 row groups)
static_assert(WTHREADS == 4 * WROWS, "wide: four threads decode each row of a piece");
constexpr int SMEM_LIMIT = 232448;
constexpr float PAD_COORD = 1.0e18f;  // kernels/ref.py PAD_COORD

enum Kind { NARROW = 0, WIDE = 1 };
enum ListAt { LIST_REG = 0, LIST_SMEM = 1, LIST_OUT = 2 };
enum Code { CODE_F32 = 0, CODE_F16 = 1, CODE_U8 = 2 };

// Floats per staged row: DW coordinates, the norm, zeros to 16 bytes.
__host__ __device__ constexpr int row_stride(int dw) { return (dw + 4) / 4 * 4; }

__host__ __device__ constexpr int code_bytes(int code) {
  return code == CODE_F32 ? 4 : (code == CODE_F16 ? 2 : 1);
}
// Narrow kernel, shared memory before the staged rows: for fp32 two raw
// tiles of TILE rows; for codes the uint8 scale and offset of the leaf
// (2d floats, rounded up to 16 bytes), then two raw byte tiles with 4
// bytes of slack for an unaligned start, each rounded up to 16 bytes.
__host__ __device__ constexpr int raw_tile_bytes(int code, int d) {
  return code == CODE_F32 ? TILE * d * 4 : (TILE * d * code_bytes(code) + 4 + 15) / 16 * 16;
}
__host__ __device__ constexpr int meta_floats(int code, int d) {
  return code == CODE_U8 ? (2 * d + 3) / 4 * 4 : 0;
}
__host__ __device__ constexpr int raw_region_bytes(int code, int d) {
  return 4 * meta_floats(code, d) + 2 * raw_tile_bytes(code, d);
}
// Staged row stride of the wide kernel (floats): fc, or fc + 4 where fc / 4
// is even, so that the 16-byte pieces of 4 consecutive rows at one feature
// lie in distinct banks (a warp's product loads 4 rows at a time).
__host__ __device__ constexpr int wide_row_stride(int fc) { return (fc / 4) % 2 ? fc : fc + 4; }

// Wide kernel: a raw code tile of WROWS rows, 4 bytes of slack, to 16 bytes.
__host__ __device__ constexpr int wide_raw_tile_bytes(int code, int d) {
  return (WROWS * d * code_bytes(code) + 4 + 15) / 16 * 16;
}

// The slab's code type and dequantize metadata, indexed by the slab's leaf.
struct Codes {
  int code;
  const float* scale;          // u8: f32[leaves, d]
  const float* offset;         // u8: f32[leaves, d]
  const unsigned char* dead;   // codes: u8[leaves, dead_stride], packed rows
  int dead_stride;             // ceil(l_pad / 8)
};

__device__ __forceinline__ bool row_dead(const Codes& c, int leaf, int r) {
  return c.code != CODE_F32 &&
         ((c.dead[(size_t)leaf * c.dead_stride + (r >> 3)] >> (7 - (r & 7))) & 1);
}
// Element e of a code array, dequantized with the feature's scale/offset.
__device__ __forceinline__ float decode(int code, const void* base, size_t e, float sc,
                                        float of) {
  if (code == CODE_U8)
    return __fadd_rn(__fmul_rn(static_cast<float>(static_cast<const unsigned char*>(base)[e]), sc),
                     of);
  if (code == CODE_F16) return __half2float(static_cast<const __half*>(base)[e]);
  return static_cast<const float*>(base)[e];
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A raw tile of codes starts `raw_lead` bytes past a 4-byte boundary; its
// copy in shared memory keeps that offset, so whole words copy to whole
// words.
__device__ __forceinline__ int raw_lead(const unsigned char* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
}
// Thread t of nt copies its share of the n bytes at p into dst +
// raw_lead(p): whole words by cp.async, the bytes before the first and
// after the last whole word by plain loads (threads 0-2).  Both kernels
// stage their code tiles through it; the caller commits the group.
__device__ __forceinline__ void copy_raw_tile(unsigned char* dst, const unsigned char* p, int n,
                                              int t, int nt) {
  const int a = raw_lead(p), e = a + n;        // bytes [a, e) of the window
  const unsigned char* g = p - a;              // 4-byte aligned
  const int wb = (a + 3) >> 2, we = e >> 2;    // whole words [wb, we)
  for (int k = wb + t; k < we; k += nt) cp_async4(dst + 4 * k, g + 4 * k);
  if (t < 3) {
    const int h = a + t, h_end = min(4 * wb, e);  // bytes before word wb
    if (h < h_end) dst[h] = g[h];
    const int b = max(4 * we, 4 * wb) + t;        // bytes after word we
    if (b < e) dst[b] = g[b];
  }
}
// Feature j of row r of a raw tile copied by copy_raw_tile (src: the
// tile's first byte), as the scan sees it: PAD_COORD in a dead row, else
// decoded (uint8 with the leaf's scale / offset, in shared memory).
__device__ __forceinline__ float staged_code(int code, const unsigned char* src, int r, int j,
                                             int d, bool dead, const float* sc,
                                             const float* of) {
  return dead ? PAD_COORD
              : decode(code, src, (size_t)r * d + j, code == CODE_U8 ? sc[j] : 1.f,
                       code == CODE_U8 ? of[j] : 0.f);
}

// The filter bound for a list whose kl-th distance is thr: fl(acc + qn) <
// thr implies acc < thr - qn exactly, and rounding that up keeps every such
// row.  thr <= 0 admits nothing (distances are clamped at 0, the test is
// strict).
__device__ __forceinline__ float filter_bound(float thr, float qn) {
  return thr > 0.f ? __fsub_ru(thr, qn) : -INFINITY;
}

// Sorted list of kl <= KMAX entries in registers: entries [KMAX-kl, KMAX)
// hold the list, the front holds -inf sentinels no distance displaces.
template <int KMAX>
struct RegList {
  float d[KMAX > 0 ? KMAX : 1];
  int i[KMAX > 0 ? KMAX : 1];

  __device__ __forceinline__ void init(int kl) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      const bool pad = j < KMAX - kl;
      d[j] = pad ? -INFINITY : INFINITY;
      i[j] = pad ? -1 : INT_MAX;
    }
  }
  __device__ __forceinline__ float worst() const { return d[KMAX - 1]; }
  // dist < worst(): insert after every entry <= dist (an equal distance
  // already held has the lower index).  c[j] = dist < d[j] holds from the
  // insert position on; entry j becomes max(d[j-1], min(d[j], dist)).
  __device__ __forceinline__ void insert(float dist, int idx) {
    bool c[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) c[j] = dist < d[j];
#pragma unroll
    for (int j = KMAX - 1; j > 0; --j) {
      i[j] = c[j - 1] ? i[j - 1] : (c[j] ? idx : i[j]);
      d[j] = fmaxf(d[j - 1], fminf(d[j], dist));
    }
    i[0] = c[0] ? idx : i[0];
    d[0] = fminf(d[0], dist);
  }
  __device__ __forceinline__ void store(float* od, int* oi, int kl) const {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j >= KMAX - kl) {
        od[j - (KMAX - kl)] = d[j];
        oi[j - (KMAX - kl)] = i[j];
      }
    }
  }
};

// A list entry as one 64-bit key: the distance's bits over the index.
// Distances are >= +0 (clamped with fmaxf(., 0) from a sum that is never
// -0) and never NaN, so their bits order as the floats do and the keys
// order as (distance, index) pairs: one integer compare decides a tie.
__device__ __forceinline__ unsigned long long list_key(float dist, int idx) {
  return (static_cast<unsigned long long>(__float_as_uint(dist)) << 32) |
         static_cast<unsigned>(idx);
}
__device__ __forceinline__ float key_dist(unsigned long long k) {
  return __uint_as_float(static_cast<unsigned>(k >> 32));
}
__device__ __forceinline__ int key_index(unsigned long long k) {
  return static_cast<int>(k & 0xffffffffu);
}

// Where a heap keeps its keys: in shared memory, one 64-bit word per entry
// ([kl][slots], so the lanes of a warp touch distinct banks at any
// positions), or in the thread's own output rows, the distance and index
// arrays, where the heap is sorted in place.
struct SmemKeys {
  unsigned long long* k;
  int stride;
  __device__ __forceinline__ unsigned long long load(int j) const { return k[j * stride]; }
  __device__ __forceinline__ void put(int j, unsigned long long v) { k[j * stride] = v; }
};
struct RowKeys {
  float* d;
  int* i;
  __device__ __forceinline__ unsigned long long load(int j) const { return list_key(d[j], i[j]); }
  __device__ __forceinline__ void put(int j, unsigned long long v) {
    d[j] = key_dist(v);
    i[j] = key_index(v);
  }
};

// The narrow kernel's list for kl > the longest register list: a max-heap
// of kl keys whose root is the kl-th entry.  A row that beats the root
// replaces it and sifts down: at most log2(kl) levels of one compare
// between the two children and one with the row, where a sorted list
// shifts half of its entries on average, each shift a dependent load (and
// a warp waits for the lane that shifts most).  A new row's index is above
// every held row's, so `dist < worst()` is the (distance, index) test, and
// the heap holds the kl first entries in that order, the list an insert at
// a time holds.  At the end of the unit a heapsort leaves them ascending.
template <typename Keys>
struct HeapList {
  Keys keys;
  int kl;
  float worst_;

  __device__ __forceinline__ void init(Keys keys_, int kl_) {
    keys = keys_;
    kl = kl_;
    for (int j = 0; j < kl; ++j) keys.put(j, list_key(INFINITY, INT_MAX));
    worst_ = INFINITY;
  }
  __device__ __forceinline__ float worst() const { return worst_; }
  // put v at the root of the heap of the first n entries and sift it down
  __device__ __forceinline__ void sift(unsigned long long v, int n) {
    int at = 0;
    for (int c = 1; c < n; c = 2 * at + 1) {
      unsigned long long ck = keys.load(c);
      if (c + 1 < n) {
        const unsigned long long c2 = keys.load(c + 1);
        if (c2 > ck) {
          ++c;
          ck = c2;
        }
      }
      if (!(ck > v)) break;
      keys.put(at, ck);
      at = c;
    }
    keys.put(at, v);
  }
  __device__ __forceinline__ void insert(float dist, int idx) {
    sift(list_key(dist, idx), kl);
    worst_ = key_dist(keys.load(0));
  }
  __device__ __forceinline__ void store(float* od, int* oi, int) {
    for (int n = kl - 1; n > 0; --n) {  // heapsort: the largest to the back
      const unsigned long long v = keys.load(n);
      keys.put(n, keys.load(0));
      sift(v, n);
    }
    if constexpr (std::is_same<Keys, SmemKeys>::value) {
      for (int j = 0; j < kl; ++j) {
        const unsigned long long v = keys.load(j);
        od[j] = key_dist(v);
        oi[j] = key_index(v);
      }
    }
  }
};

// Narrow kernel, d <= DW <= 16: one block per plan row.  KMAX > 0: a
// register list of KMAX entries and two query slots per thread (slots t and
// t + blockDim.x); KMAX == 0: a heap in shared memory or in the output rows
// (LIST) and one query per thread, twice the warps for the heap's
// dependent loads (the list's shared memory bounds the blocks per SM).
template <int DW, int KMAX, int LIST>
__global__ void __launch_bounds__(MAX_TQ / (KMAX > 0 ? 2 : 1))
leaf_scan_narrow_kernel(const float* __restrict__ qpad, const void* __restrict__ slab,
                        const Codes codes, const int* __restrict__ unit_leaf,
                        const int* __restrict__ unit_query,
                        const int* __restrict__ n_units, float* __restrict__ out_d,
                        int* __restrict__ out_i, int tq, int l_pad, int d, int kl,
                        int list_at) {
  constexpr int S = row_stride(DW);
  constexpr int QPT = KMAX > 0 ? 2 : 1;  // query slots per thread
  using Keys = typename std::conditional<LIST == LIST_SMEM, SmemKeys, RowKeys>::type;
  using List =
      typename std::conditional<(KMAX > 0), RegList<KMAX>, HeapList<Keys>>::type;
  const int w = blockIdx.x;
  if (w >= *n_units) return;  // uniform per block: before any barrier
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, nt = blockDim.x;
  const int code = codes.code;
  const bool coded = code != CODE_F32;
  const int es = code_bytes(code), rtb = raw_tile_bytes(code, d);
  float* sc = smem;                     // [d] uint8 scale of the leaf
  float* of = smem + d;                 // [d] uint8 offset of the leaf
  // [2][rtb] tiles as stored
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem + meta_floats(code, d));
  float* xs = smem + raw_region_bytes(code, d) / 4;  // [2][TILE * S] staged rows
  // [kl][nt] heap keys in shared memory (16-byte aligned)
  unsigned long long* lsk = reinterpret_cast<unsigned long long*>(xs + 2 * TILE * S);

  float q[QPT][DW], qn[QPT], bound[QPT];
  List list[QPT];
#pragma unroll
  for (int s = 0; s < QPT; ++s) {
    const int slot = t + s * nt;
    const bool active = slot < tq;
    // an empty slot (-1) scans a zero query, as the plain version's masked gather
    const int qrow = active ? unit_query[(size_t)w * tq + slot] : -1;
    float n = 0.f;
#pragma unroll
    for (int j = 0; j < DW; ++j) {
      const float v = (qrow >= 0 && j < d) ? qpad[(size_t)qrow * d + j] : 0.f;
      n = fmaf(v, v, n);
      q[s][j] = -2.f * v;
    }
    qn[s] = n;
    if constexpr (KMAX > 0) {
      list[s].init(kl);
    } else if (active) {
      const size_t o = ((size_t)w * tq + slot) * kl;
      if constexpr (LIST == LIST_SMEM)
        list[s].init(SmemKeys{lsk + slot, nt}, kl);
      else
        list[s].init(RowKeys{out_d + o, out_i + o}, kl);
    }
    bound[s] = active ? INFINITY : -INFINITY;  // an unused slot takes no row
  }
  const int leaf = unit_leaf[w];
  const unsigned char* xl =
      static_cast<const unsigned char*>(slab) + (size_t)leaf * l_pad * d * es;
  const int ntiles = (l_pad + TILE - 1) / TILE;
  // fp32: each thread copies (and later stages) rows t, t + nt, ... of a
  // tile.  Codes: the block copies the tile's byte range (copy_raw_tile).
  auto issue = [&](int it) {
    if (it < ntiles) {
      const int r0 = it * TILE, rows = min(TILE, l_pad - r0);
      unsigned char* dst = raw + (it & 1) * rtb;
      if (!coded) {
        const float* xf = reinterpret_cast<const float*>(xl);
        float* df = reinterpret_cast<float*>(dst);
        for (int r = t; r < rows; r += nt)
          for (int j = 0; j < d; ++j)
            cp_async4(df + r * d + j, xf + (size_t)(r0 + r) * d + j);
      } else {
        copy_raw_tile(dst, xl + (size_t)r0 * d * es, rows * d * es, t, nt);
      }
    }
    cp_async_commit();  // one group per tile, empty past the end
  };
  if (coded) {
    // a tile's bytes come from every thread: the block meets between a
    // tile's copy and its staging
    if (code == CODE_U8)
      for (int j = t; j < d; j += nt) {
        sc[j] = codes.scale[(size_t)leaf * d + j];
        of[j] = codes.offset[(size_t)leaf * d + j];
      }
    issue(0);
    cp_async_wait<0>();
    __syncthreads();
    issue(1);
  } else {
    issue(0);
    issue(1);
  }

  for (int it = 0; it < ntiles; ++it) {
    const int r0 = it * TILE, rows = min(TILE, l_pad - r0);
    float* xt = xs + (it & 1) * TILE * S;
    if (!coded) {
      cp_async_wait<1>();  // this thread's copies of tile `it` have landed
      const float* src = reinterpret_cast<const float*>(raw + (it & 1) * rtb);
      for (int r = t; r < TILE; r += nt) {
        float v[S];
        float n = 0.f;
#pragma unroll
        for (int j = 0; j < DW; ++j) {
          v[j] = (r < rows && j < d) ? src[r * d + j] : 0.f;
          n = fmaf(v[j], v[j], n);
        }
        v[DW] = r < rows ? n : INFINITY;  // a row past the leaf never passes
#pragma unroll
        for (int j = DW + 1; j < S; ++j) v[j] = 0.f;
#pragma unroll
        for (int j = 0; j < S; j += 4)
          *reinterpret_cast<float4*>(xt + r * S + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    } else {
      // tile `it` landed before the last barrier; wait for this thread's
      // copies of tile it+1, which the barrier below publishes
      cp_async_wait<0>();
      const unsigned char* src = raw + (it & 1) * rtb + raw_lead(xl + (size_t)r0 * d * es);
      for (int r = t; r < TILE; r += nt) {
        const bool dead = r < rows && row_dead(codes, leaf, r0 + r);
        float v[S];
        float n = 0.f;
#pragma unroll
        for (int j = 0; j < DW; ++j) {
          v[j] = (r < rows && j < d) ? staged_code(code, src, r, j, d, dead, sc, of) : 0.f;
          n = fmaf(v[j], v[j], n);
        }
        v[DW] = r < rows ? n : INFINITY;
#pragma unroll
        for (int j = DW + 1; j < S; ++j) v[j] = 0.f;
#pragma unroll
        for (int j = 0; j < S; j += 4)
          *reinterpret_cast<float4*>(xt + r * S + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
      }
    }
    // tile `it` is staged by every thread, and every thread is done with
    // tile it-1, whose staging buffer the next iteration overwrites (and,
    // for codes, with raw[it & 1], and tile it+1's bytes are in place)
    __syncthreads();
    issue(it + 2);  // fp32: only this thread reads its rows of raw[it & 1]

    // inserts in ascending row order, each re-checked against the list as
    // it is then (the same FMA chain gives the same acc)
    auto flush = [&](int s, int p, unsigned m) {
      while (m) {
        const int r = p * PASS + __ffs(m) - 1;
        m &= m - 1;
        const float* xr = xt + r * S;
        float a = xr[DW];
#pragma unroll
        for (int j = 0; j < DW; ++j) a = fmaf(q[s][j], xr[j], a);
        const float dist = fmaxf(a + qn[s], 0.f);
        if (dist < list[s].worst()) {
          list[s].insert(dist, r0 + r);
          bound[s] = filter_bound(list[s].worst(), qn[s]);
        }
      }
    };
    // filter: which rows of the tile may enter each list.  Bit r of a pass
    // mask is the sign of acc - bound (set iff acc < bound, also for an
    // infinite bound), shifted in with rows taken high to low.  The first
    // tile, where every row passes an infinite bound, is flushed per pass.
    unsigned mask[QPT][TILE / PASS];
#pragma unroll
    for (int p = 0; p < TILE / PASS; ++p) {
      unsigned m[QPT];
#pragma unroll
      for (int s = 0; s < QPT; ++s) m[s] = 0u;
#pragma unroll
      for (int r = PASS - 1; r >= 0; --r) {
        const float4* xr = reinterpret_cast<const float4*>(xt + (p * PASS + r) * S);
        float x[S];
#pragma unroll
        for (int j = 0; j < S / 4; ++j) {
          const float4 f = xr[j];
          x[4 * j] = f.x;
          x[4 * j + 1] = f.y;
          x[4 * j + 2] = f.z;
          x[4 * j + 3] = f.w;
        }
#pragma unroll
        for (int s = 0; s < QPT; ++s) {
          float a = x[DW];
#pragma unroll
          for (int j = 0; j < DW; ++j) a = fmaf(q[s][j], x[j], a);
          m[s] = __funnelshift_l(__float_as_uint(a - bound[s]), m[s], 1);
        }
      }
#pragma unroll
      for (int s = 0; s < QPT; ++s) mask[s][p] = m[s];
      if (it == 0) {
#pragma unroll
        for (int s = 0; s < QPT; ++s) flush(s, p, mask[s][p]);
      }
    }
    if (it > 0) {
#pragma unroll
      for (int s = 0; s < QPT; ++s)
#pragma unroll
        for (int p = 0; p < TILE / PASS; ++p) flush(s, p, mask[s][p]);
    }
  }
  cp_async_wait<0>();  // nothing left in flight (the last groups are empty)

#pragma unroll
  for (int s = 0; s < QPT; ++s) {
    const int slot = t + s * nt;
    if (slot < tq) {
      const size_t o = ((size_t)w * tq + slot) * kl;
      list[s].store(out_d + o, out_i + o, kl);
    }
  }
}

#if LEAF_SCAN_PART == 0
// a[r] for a row r known only at run time, from registers
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int r) {
  float v = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) v = r == i ? a[i] : v;
  return v;
}

constexpr unsigned FULL = 0xffffffffu;

// Wide kernel, d > 16: one block of WTHREADS threads per plan row; thread
// t owns query slot t's list (the narrow kernel's: a register list for
// KMAX > 0, else a heap in shared memory or in the output rows) and bound.
// The slab goes through shared memory in pieces of WROWS rows: whole rows
// (width == 0; -2q of every slot staged once, [dp][slots]) or, where those
// do not fit, chunks of `width` features (-2q read from device memory).  A
// pass over a piece's rows is a register-tiled product inside each warp:
// warp w takes slots 32w..32w+31, lane (qg = lane / 4, rg = lane % 4) forms
// the FMA chains of the 4 slots 32w + 4qg + u against the 8 rows rg + 4rr,
// 4 features a step (per feature one LDS.128 of -2q for 4 slots, per row
// one LDS.128 of 4 features: 128 FMAs per 12 loads).  After a row's last
// feature the pass is filtered against the slots' bounds (shuffled from
// their owners), the 4 lanes of a quad OR their masks, and each owner
// inserts its passing rows in ascending order, each accumulator fetched
// from the lane that formed it: no second chain and no block barrier.
// Each warp forms the norms of a tile's rows itself (lane r: row r's
// chain, from the staged row, or from memory at a chunked tile's first
// chunk) and hands them round by shuffles.  One barrier per piece
// publishes the copies (codes: two, with the decode between, four threads
// to a row).  Double-buffered pieces: fp32 copied with cp.async straight
// into the staged rows, codes as raw bytes.  The chain is the narrow kernel's (||x||^2, then -2q_j x_j in feature order,
// zero pad features adding exact zeros).
template <int KMAX, int LIST>
__global__ void __launch_bounds__(WTHREADS)
leaf_scan_wide_kernel(const float* __restrict__ qpad, const void* __restrict__ slab,
                      const Codes codes, const int* __restrict__ unit_leaf,
                      const int* __restrict__ unit_query,
                      const int* __restrict__ n_units, float* __restrict__ out_d,
                      int* __restrict__ out_i, int tq, int l_pad, int d, int kl, int width) {
  using Keys = typename std::conditional<LIST == LIST_SMEM, SmemKeys, RowKeys>::type;
  using List =
      typename std::conditional<(KMAX > 0), RegList<KMAX>, HeapList<Keys>>::type;
  const int w = blockIdx.x;
  if (w >= *n_units) return;  // uniform per block: before any barrier
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, lane = t & 31, rg = lane & 3;
  const int quad = t & ~3;                    // slots quad..quad+3: this lane's product
  const int code = codes.code, es = code_bytes(code);
  const bool coded = code != CODE_F32;
  const int dp = (d + 3) & ~3;
  const bool whole = width == 0;
  const int fc = whole ? dp : width;          // features per piece
  const int rs = wide_row_stride(fc);         // staged row stride
  const int nch = (d + fc - 1) / fc;          // pieces per row tile
  const bool raw_copy = coded && whole;       // codes copied as raw bytes
  const int rtb = wide_raw_tile_bytes(code, d);
  float* qs = smem;                                       // whole: [dp][WTHREADS] -2q
  float* stg = smem + (whole ? WTHREADS * dp : 0);         // [2 or 1][WROWS][rs] staged
  float* after = stg + (coded ? 1 : 2) * WROWS * rs;
  float* sc = after;                                       // raw copy, u8: scale, offset
  float* of = after + d;
  unsigned char* raw = reinterpret_cast<unsigned char*>(after + meta_floats(code, d));
  unsigned long long* lsk = reinterpret_cast<unsigned long long*>(
      raw_copy ? reinterpret_cast<float*>(raw + 2 * rtb) : after);  // [kl][WTHREADS] keys

  const int leaf = unit_leaf[w];
  const unsigned char* xl =
      static_cast<const unsigned char*>(slab) + (size_t)leaf * l_pad * d * es;
  const float* xf = reinterpret_cast<const float*>(xl);
  const float* gsc = code == CODE_U8 ? codes.scale + (size_t)leaf * d : nullptr;
  const float* gof = code == CODE_U8 ? codes.offset + (size_t)leaf * d : nullptr;
  // the value of feature j of leaf row r as the scan sees it (device memory)
  auto x_at = [&](int r, int j) {
    const size_t e = (size_t)r * d + j;
    if (!coded) return xf[e];
    if (row_dead(codes, leaf, r)) return PAD_COORD;
    return decode(code, xl, e, code == CODE_U8 ? gsc[j] : 1.f, code == CODE_U8 ? gof[j] : 0.f);
  };

  // the slot this thread owns: its query, norm, list and bound
  const bool active = t < tq;
  // an empty slot (-1) scans a zero query, as the plain version's masked gather
  const int qrow = active ? unit_query[(size_t)w * tq + t] : -1;
  const float* qr = qrow >= 0 ? qpad + (size_t)qrow * d : nullptr;
  float qn = 0.f;
  for (int j = 0; j < dp; ++j) {
    const float v = (qr != nullptr && j < d) ? qr[j] : 0.f;
    qn = fmaf(v, v, qn);
    if (whole) qs[j * WTHREADS + t] = -2.f * v;
  }
  List list;
  if constexpr (KMAX > 0) {
    list.init(kl);
  } else if (active) {
    const size_t o = ((size_t)w * tq + t) * kl;
    if constexpr (LIST == LIST_SMEM)
      list.init(SmemKeys{lsk + t, WTHREADS}, kl);
    else
      list.init(RowKeys{out_d + o, out_i + o}, kl);
  }
  float bound = active ? INFINITY : -INFINITY;  // an unused slot takes no row
  // chunks: the query rows of this lane's 4 product slots, in memory
  const float* qq[WQT];
  const unsigned long long qbits = reinterpret_cast<unsigned long long>(qr);
#pragma unroll
  for (int u = 0; u < WQT; ++u)
    qq[u] = reinterpret_cast<const float*>(__shfl_sync(FULL, qbits, quad % 32 + u));
  if (raw_copy && code == CODE_U8)
    for (int j = t; j < d; j += WTHREADS) {
      sc[j] = gsc[j];
      of[j] = gof[j];
    }
  if (!coded && whole)  // the pad features of both buffers' rows stay zero
    for (int i = t; i < 2 * WROWS; i += WTHREADS)
      for (int j = d; j < dp; ++j) stg[i * rs + j] = 0.f;

  const int ntiles = (l_pad + WROWS - 1) / WROWS;
  const int npieces = ntiles * nch;
  // fp32 copies move `vec` floats each (16, 8 or 4 bytes) where d and the
  // slab's base allow
  const uintptr_t base = reinterpret_cast<uintptr_t>(slab);
  const int vec = (d % 4 == 0 && (base & 15) == 0) ? 4 : (d % 2 == 0 && (base & 7) == 0) ? 2 : 1;
  auto issue = [&](int p) {
    if (p < npieces) {
      const int tile = p / nch, c = p - tile * nch;
      const int r0 = tile * WROWS, rows = min(WROWS, l_pad - r0);
      if (!coded) {
        // the block copies the piece's rows [r0, r0 + rows) x features
        // [c0, c0 + fcw) coalesced, element i = (row i / nv, vector i % nv);
        // rows past the leaf and a last chunk's pad features are zeroed
        const int c0 = c * fc, fcw = min(fc, d - c0), nv = fcw / vec, total = rows * nv;
        float* dst = stg + (p & 1) * WROWS * rs;
        int r = t / nv, v = t - r * nv;
        const int dr = WTHREADS / nv, dv = WTHREADS - dr * nv;
        for (int i = t; i < total; i += WTHREADS) {
          const float* src = xf + (size_t)(r0 + r) * d + c0 + v * vec;
          float* to = dst + r * rs + v * vec;
          if (vec == 4)
            cp_async16(to, src);
          else if (vec == 2)
            cp_async8(to, src);
          else
            cp_async4(to, src);
          r += dr;
          v += dv;
          if (v >= nv) {
            v -= nv;
            ++r;
          }
        }
        for (int i = rows * rs + t; i < WROWS * rs; i += WTHREADS) dst[i] = 0.f;
        if (!whole && fcw < fc)
          for (int i = t; i < rows * (fc - fcw); i += WTHREADS)
            dst[(i / (fc - fcw)) * rs + fcw + i % (fc - fcw)] = 0.f;
      } else if (raw_copy) {
        copy_raw_tile(raw + (p & 1) * rtb, xl + (size_t)r0 * d * es, rows * d * es, t,
                      WTHREADS);
      }
    }
    cp_async_commit();  // one group per piece, empty past the end
  };

  float acc[WQT][WRT];
  issue(0);
  for (int p = 0; p < npieces; ++p) {
    const int tile = p / nch, c = p - tile * nch;
    const int r0 = tile * WROWS, rows = min(WROWS, l_pad - r0);
    const int c0 = c * fc, fcw = min(fc, d - c0);
    float* xt = stg + (coded ? 0 : (p & 1) * WROWS * rs);
    cp_async_wait<0>();  // this thread's copies of piece p have landed
    // piece p is in place; every thread is done with piece p-1
    __syncthreads();
    if (coded) {
      // four threads decode each row into the staged buffer, features
      // sub, sub + 4, ... (dead rows PAD_COORD in every feature, pad
      // features and rows past the leaf zero)
      const int r = t >> 2, sub = t & 3;
      float* xr = xt + r * rs;
      const bool live = r < rows;
      const bool dead = live && row_dead(codes, leaf, r0 + r);
      const unsigned char* src = raw + (p & 1) * rtb + raw_lead(xl + (size_t)r0 * d * es);
      for (int j = sub; j < fc; j += 4)
        xr[j] = (!live || j >= fcw) ? 0.f
                : raw_copy          ? staged_code(code, src, r, j, d, dead, sc, of)
                                    : x_at(r0 + r, c0 + j);
      __syncthreads();  // the piece's rows are staged
    }
    issue(p + 1);  // into the buffers piece p-1 used

    if (c == 0) {
      // each warp forms the tile's row norms itself: lane r the chain of
      // row r (whole rows: from the staged row, its loads a step ahead;
      // chunks: from memory)
      float nr = INFINITY;  // a row past the leaf never passes
      if (lane < rows) {
        nr = 0.f;
        if (whole) {
          const float4* v = reinterpret_cast<const float4*>(xt + lane * rs);
          float4 a = v[0];
          for (int i = 0; i < dp / 4; ++i) {
            const float4 b = i + 1 < dp / 4 ? v[i + 1] : make_float4(0.f, 0.f, 0.f, 0.f);
            nr = fmaf(a.x, a.x, nr);
            nr = fmaf(a.y, a.y, nr);
            nr = fmaf(a.z, a.z, nr);
            nr = fmaf(a.w, a.w, nr);
            a = b;
          }
        } else {
          for (int j = 0; j < d; ++j) {
            const float v = x_at(r0 + lane, j);
            nr = fmaf(v, v, nr);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < WRT; ++rr) {
        const float n = __shfl_sync(FULL, nr, rg + 4 * rr);
#pragma unroll
        for (int u = 0; u < WQT; ++u) acc[u][rr] = n;
      }
    }
    for (int j = 0; j < fcw; j += 4) {
      float qv[4][WQT];  // [feature j + f][slot quad + u]
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if (whole) {
          const float4 v = *reinterpret_cast<const float4*>(qs + (j + f) * WTHREADS + quad);
          qv[f][0] = v.x;
          qv[f][1] = v.y;
          qv[f][2] = v.z;
          qv[f][3] = v.w;
        } else {
#pragma unroll
          for (int u = 0; u < WQT; ++u)
            qv[f][u] = (qq[u] != nullptr && c0 + j + f < d) ? -2.f * qq[u][c0 + j + f] : 0.f;
        }
      }
#pragma unroll
      for (int rr = 0; rr < WRT; ++rr) {
        const float4 x = *reinterpret_cast<const float4*>(xt + (rg + 4 * rr) * rs + j);
#pragma unroll
        for (int u = 0; u < WQT; ++u) {
          float a = acc[u][rr];
          a = fmaf(qv[0][u], x.x, a);
          a = fmaf(qv[1][u], x.y, a);
          a = fmaf(qv[2][u], x.z, a);
          a = fmaf(qv[3][u], x.w, a);
          acc[u][rr] = a;
        }
      }
    }
    if (c == nch - 1) {
      // filter: bit r (row r = rg + 4 rr) of a slot's mask is the sign of
      // acc - bound (set iff acc < bound); the quad ORs its lanes' rows
      unsigned part[WQT];
#pragma unroll
      for (int u = 0; u < WQT; ++u) {
        const float b = __shfl_sync(FULL, bound, (quad % 32) + u);
        unsigned m = 0u;
#pragma unroll
        for (int rr = 0; rr < WRT; ++rr)
          m |= (__float_as_uint(acc[u][rr] - b) >> 31) << (rg + 4 * rr);
        m |= __shfl_xor_sync(FULL, m, 1);
        m |= __shfl_xor_sync(FULL, m, 2);
        part[u] = m;
      }
      unsigned m = part[0];
#pragma unroll
      for (int u = 1; u < WQT; ++u) m = rg == u ? part[u] : m;
      // the owner inserts its passing rows in ascending order; each
      // accumulator comes from the lane of its row group (a round per
      // slot of the quad: that slot's owner asks, every lane answers)
      while (__any_sync(FULL, m != 0u)) {
        const bool have = m != 0u;
        const int r = have ? __ffs(m) - 1 : 0;
        m &= m - 1u;
        float a = 0.f;
#pragma unroll
        for (int u = 0; u < WQT; ++u) {
          const int rq = __shfl_sync(FULL, r, (quad % 32) + u);
          const float got = __shfl_sync(FULL, pick(acc[u], rq >> 2), (quad % 32) + (r & 3));
          if (rg == u) a = got;
        }
        if (have) {
          const float dist = fmaxf(a + qn, 0.f);
          if (dist < list.worst()) list.insert(dist, r0 + r);
        }
      }
      if (active) bound = filter_bound(list.worst(), qn);
    }
  }
  cp_async_wait<0>();  // nothing left in flight (the last group is empty)

  if (active) {
    const size_t o = ((size_t)w * tq + t) * kl;
    list.store(out_d + o, out_i + o, kl);
  }
}
#endif

struct Launch {
  const float* qpad;
  const void* slab;
  Codes codes;
  const int* unit_leaf;
  const int* unit_query;
  const int* n_units;
  float* out_d;
  int* out_i;
  int w_rows, tq, l_pad, d, kl, list_at, width, threads, smem;
  cudaStream_t stream;
};

// The last kernel argument: the narrow kernel's list placement, the wide
// kernel's features per piece.
template <typename Kernel>
int launch(Kernel kernel, const Launch& a, int last) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.w_rows, a.threads, a.smem, a.stream>>>(a.qpad, a.slab, a.codes, a.unit_leaf,
                                                     a.unit_query, a.n_units, a.out_d,
                                                     a.out_i, a.tq, a.l_pad, a.d, a.kl, last);
  return static_cast<int>(cudaGetLastError());
}

constexpr int NO_INSTANCE = -2;

// The narrow instances of this library's width.
int narrow(int dw, int kmax, int list_at, const Launch& a) {
#if LEAF_SCAN_PART > 0
  constexpr int DW = LEAF_SCAN_PART;
  if (dw == DW) {
    const int l = a.list_at;
    if (list_at == LIST_SMEM) return launch(leaf_scan_narrow_kernel<DW, 0, LIST_SMEM>, a, l);
    if (list_at == LIST_OUT) return launch(leaf_scan_narrow_kernel<DW, 0, LIST_OUT>, a, l);
    switch (kmax) {
      case 4: return launch(leaf_scan_narrow_kernel<DW, 4, LIST_REG>, a, l);
      case 8: return launch(leaf_scan_narrow_kernel<DW, 8, LIST_REG>, a, l);
      case 10: return launch(leaf_scan_narrow_kernel<DW, 10, LIST_REG>, a, l);
      case 16: return launch(leaf_scan_narrow_kernel<DW, 16, LIST_REG>, a, l);
    }
  }
#endif
  return NO_INSTANCE;
}

// The wide instances: the narrow kernel's lists.
int wide(int kmax, int list_at, const Launch& a) {
#if LEAF_SCAN_PART == 0
  const int fc = a.width;
  if (list_at == LIST_SMEM) return launch(leaf_scan_wide_kernel<0, LIST_SMEM>, a, fc);
  if (list_at == LIST_OUT) return launch(leaf_scan_wide_kernel<0, LIST_OUT>, a, fc);
  switch (kmax) {
    case 4: return launch(leaf_scan_wide_kernel<4, LIST_REG>, a, fc);
    case 8: return launch(leaf_scan_wide_kernel<8, LIST_REG>, a, fc);
    case 10: return launch(leaf_scan_wide_kernel<10, LIST_REG>, a, fc);
    case 16: return launch(leaf_scan_wide_kernel<16, LIST_REG>, a, fc);
  }
#endif
  return NO_INSTANCE;
}

// Dynamic shared memory an instance needs (bytes); mirrors the wrapper.
long smem_needed(int kind, int width, int qpt, int list_at, int threads, int d, int kl,
                 int code) {
  long b;
  if (kind == NARROW) {
    b = raw_region_bytes(code, d) + 4L * 2L * TILE * row_stride(width);
  } else {
    // -2q of every slot (whole rows), the staged pieces (fp32 two, codes
    // one; rows padded to wide_row_stride), and with whole rows of codes
    // the raw code tiles and u8 metadata
    const long dp = (d + 3) / 4 * 4, fc = width == 0 ? dp : width;
    b = (width == 0 ? 4L * threads * dp : 0L) +
        4L * (code == CODE_F32 ? 2 : 1) * WROWS * wide_row_stride(fc);
    if (code != CODE_F32 && width == 0)
      b += 4L * meta_floats(code, d) + 2L * wide_raw_tile_bytes(code, d);
  }
  if (list_at == LIST_SMEM) b += 8L * kl * qpt * threads;
  return b;
}

}  // namespace

extern "C" {

// qpad f32[m, d]; slab [C, l_pad, d] of f32, f16 or u8 (code 0, 1, 2);
// for codes, dead u8[C, ceil(l_pad / 8)] (packed dead rows) and for u8
// scale and offset f32[C, d], all indexed by the slab's leaf; unit_leaf
// i32[w_rows] (leaf index into slab); unit_query i32[w_rows, tq] (row of
// qpad, -1 for an empty slot); n_units i32[1] on the device.  Writes out_d
// f32 and out_i i32 [w_rows, tq, kl] for plan rows < *n_units only.  The
// variant (kind, width, kmax, qpt, list_at, threads, smem_bytes) is the
// wrapper's choice.  Returns 0 or a cudaError_t; -1 for a choice that does
// not fit the arguments, -2 for an instance this library does not hold.
int leaf_scan_units(const float* qpad, const void* slab, const int* unit_leaf,
                    const int* unit_query, const int* n_units, float* out_d, int* out_i,
                    int w_rows, int tq, int l_pad, int d, int kl, int kind, int width,
                    int kmax, int qpt, int list_at, int threads, int smem_bytes, int code,
                    const float* scale, const float* offset, const unsigned char* dead,
                    void* stream) {
  if (w_rows <= 0) return 0;
  const bool reg = list_at == LIST_REG;
  const bool list_ok = reg || list_at == LIST_SMEM || list_at == LIST_OUT;
  const bool code_ok = code == CODE_F32 ? dead == nullptr
                                        : (code == CODE_F16 || code == CODE_U8) &&
                                              dead != nullptr &&
                                              (code == CODE_F16 || (scale && offset));
  if (tq < 1 || tq > MAX_TQ || d < 1 || kl < 1 || kl > l_pad || !list_ok || !code_ok ||
      threads < 32 || threads % 32 != 0 || threads * qpt < tq ||
      reg != (kmax > 0) || (reg && kl > kmax) || smem_bytes > SMEM_LIMIT ||
      smem_bytes < smem_needed(kind, width, qpt, list_at, threads, d, kl, code))
    return -1;
  const Codes codes{code, scale, offset, dead, (l_pad + 7) / 8};
  const Launch a{qpad,   slab,    codes, unit_leaf, unit_query, n_units,
                 out_d,  out_i,   w_rows, tq,       l_pad,      d,
                 kl,     list_at, width, threads,  smem_bytes, static_cast<cudaStream_t>(stream)};
  if (kind == NARROW) {
    // a register list takes two query slots per thread, a heap one
    if (d > width || qpt != (reg ? 2 : 1) || threads > MAX_TQ / qpt) return -1;
    return narrow(width, kmax, list_at, a);
  }
  if (kind == WIDE) {
    // width 0: whole rows; else chunks of `width` features (a multiple of
    // 4, narrower than the row)
    if (qpt != 1 || threads != WTHREADS ||
        (width != 0 && (width < 4 || width % 4 != 0 || width >= (d + 3) / 4 * 4)))
      return -1;
    return wide(kmax, list_at, a);
  }
  return -1;
}

const char* leaf_scan_error_string(int code) {
  if (code == -1) return "variant does not fit the arguments";
  if (code == NO_INSTANCE) return "no such kernel instance in this library";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
