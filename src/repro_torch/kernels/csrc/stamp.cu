// Phase stamps and work tallies of the jit engine's round
// (core/jitsearch.py::JitRounds).
//
// Replaces no TPU kernel: the reference's round runs inside one
// `lax.while_loop`, which has no phases a host could time.  Here the round is
// captured into a CUDA graph and replayed, so no host code runs between its
// kernels, and a host clock cannot say where a round's time goes, nor count
// what a replayed round did.
//
// `stamp_kernel`: one thread reads the card's nanosecond clock
// (`%globaltimer`) and adds the time since the previous stamp into the
// accumulator of the phase that just ended.  Stream order starts a stamp only
// after every kernel of its phase has finished, so a phase's time is from the
// previous stamp to the end of its own last kernel, the gaps between kernels
// included.  One launch; it reads and writes 16 bytes.
//
// `tally_kernel`: adds the round's leaf visits (queries with a leaf >= 0),
// their (query, real row) pairs (the visited leaf's size) and the plan's
// units into row min(rounds, rows - 1) of the round log.  A grid-stride sum
// over the m leaf ids, one integer atomic per block and column, so the
// result does not depend on the order; bound by reading the 4 m bytes of
// `leaf` and the leaf sizes it gathers.
//
// Both are captured with the round, so every replay stamps and counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// clock i64[1 + phases]: clock[0] is the last stamp's time; clock[phase]
// (phase >= 1) accumulates the nanoseconds its phases took.  Phase 0 only
// sets clock[0] (the round's start).
__global__ void stamp_kernel(int64_t* clock, int phase) {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (phase > 0) clock[phase] += static_cast<int64_t>(now) - clock[0];
  clock[0] = static_cast<int64_t>(now);
}

constexpr int kTallyThreads = 256;
constexpr int kTallyMaxBlocks = 264;   // two per SM of an H100 SXM

// log i64[rows, 3]: (visits, pairs, units) per live round.
__global__ void tally_kernel(const int32_t* __restrict__ leaf, int64_t m,
                             const int32_t* __restrict__ leaf_size,
                             const int32_t* __restrict__ n_units,
                             const int32_t* __restrict__ rounds, int64_t* log,
                             int64_t rows) {
  unsigned long long visits = 0, pairs = 0;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < m;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int32_t l = leaf[i];
    if (l >= 0) {
      visits += 1;
      pairs += static_cast<unsigned long long>(leaf_size[l]);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    visits += __shfl_down_sync(0xffffffffu, visits, off);
    pairs += __shfl_down_sync(0xffffffffu, pairs, off);
  }
  __shared__ unsigned long long warp_visits[kTallyThreads / 32];
  __shared__ unsigned long long warp_pairs[kTallyThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    warp_visits[warp] = visits;
    warp_pairs[warp] = pairs;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kTallyThreads / 32; ++w) {
    visits += warp_visits[w];
    pairs += warp_pairs[w];
  }
  const int64_t r = *rounds < rows - 1 ? *rounds : rows - 1;
  auto* row = reinterpret_cast<unsigned long long*>(log + 3 * r);
  if (visits) atomicAdd(row, visits);
  if (pairs) atomicAdd(row + 1, pairs);
  if (blockIdx.x == 0) atomicAdd(row + 2, static_cast<unsigned long long>(*n_units));
}

}  // namespace

extern "C" {

// Launches one stamp on `stream`; returns 0 or a cudaError_t.
int stamp(void* clock, int phase, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<int64_t*>(clock),
                                                               phase);
  return static_cast<int>(cudaGetLastError());
}

// Launches one round's tally on `stream`; returns 0 or a cudaError_t.
int tally(void* log, int64_t rows, const void* leaf, int64_t m, const void* leaf_size,
          const void* n_units, const void* rounds, void* stream) {
  int64_t blocks = (m + kTallyThreads - 1) / kTallyThreads;
  if (blocks > kTallyMaxBlocks) blocks = kTallyMaxBlocks;
  if (blocks < 1) blocks = 1;
  tally_kernel<<<static_cast<int>(blocks), kTallyThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(leaf), m, static_cast<const int32_t*>(leaf_size),
      static_cast<const int32_t*>(n_units), static_cast<const int32_t*>(rounds),
      static_cast<int64_t*>(log), rows);
  return static_cast<int>(cudaGetLastError());
}

const char* stamp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
