// Exact sequential cluster loop over sorted hit slots, one read per
// thread, the block's rows streamed through a shared-memory ring.
//
// Replaces: chromap_tpu/ops/device_seed.py `_cluster_scan_W` (a lax.scan
// port of candidate_processor.cc:283-342, ClusterHits in engine.cpp).
// On the TPU the scan runs all reads in lockstep as vector lanes; here
// each thread walks its own column with the whole state (min_cnt,
// eq_cnt, best_eq, best, prev) in registers, comparing full 64-bit words
// as the scan does.
//
// Layout: words_ext (H + 1, B) int64 carrying u64 hit words
// row << 47 | strand << 46 | rid << 32 | start, slot-major (columns are
// reads), invalid slots all-ones, the last row an all-ones sentinel that
// closes the final cluster. mm_count, num_required (B,) int32. Out: emit
// (H, B) uint8 (torch.bool) and cand (H, B) int64 carrying
// (best & (2^47 - 1)) | (best_eq & 0xFF) << 47 for every slot; emission
// i reports the cluster closed while processing slot i + 1.
//
// Design. The recurrence is sequential along the slots, so each thread
// still owns one read. A block of kThreads threads owns kThreads
// consecutive reads and streams their (H + 1, kThreads) tile of words
// through a ring of kStages stages of kRows rows in shared memory. Every
// lane runs all H steps (the scan has no early stop), so the whole block
// fills the ring with 16-byte `cp.async` copies and one barrier per
// stage publishes a stage and frees the one before; kStages - 1 stages
// (28 KB a block) are in flight ahead of the step. A row whose start is
// not 16-byte aligned (odd B) and the ragged last block take 8-byte
// copies, and no copy reads past column B - 1. The emit flags are staged
// in shared memory (two buffers of kEmitRows rows) and written as 16-byte
// vectors, one per thread, every kEmitRows rows; cand is one coalesced
// 8-byte store per slot. The 64-bit compares stay 32-bit halves, and the
// u32 sums prev_lo + e and best_lo + e wrap as the scan's uint32 lanes.
//
// Bound on an H100 SXM (3.35 TB/s, 700 W) at H = 128, B = 32768: it must
// read 33.8 MB of words and write 33.6 MB of candidates plus 4.2 MB of
// flags -- about 21 us. ~32 integer instructions per slot, ~1.3e8 in
// all, ~8 us at the card's ~16.7 T/s INT32 issue rate: bytes bound it.
// The earlier form (one 8-byte load per slot and lane in the dependent
// loop, 64-thread blocks) kept about one 256-byte row per warp in
// flight, ~2 KB per SM against the ~25 KB that 3.35 TB/s needs at ~1 us
// of latency, and took 0.0745-0.0749 ms (~0.96 TB/s). On an H100 80GB
// HBM3 at 700 W (chip_smoke.py, the two forms in turns) this form takes
// 0.0313-0.0319 ms, ~2.25 TB/s warm and the same with the L2 flushed;
// 68 registers and 36 KB of shared memory allow 6 blocks per SM, and the
// grid gives ~2. Shallower or deeper rings (16 or 32 KB), 8-row stages,
// 64-read blocks and a register-prefetch form (8 rows ahead per thread)
// all took 0.031-0.033 ms: once ~16 KB per SM are in flight the time no
// longer follows the ring's shape.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                  // reads a block
constexpr int kRows = 4;                       // rows a stage, a power of two
constexpr int kStages = 8;                     // stages in the ring
constexpr int kEmitRows = 16;                  // flag rows a flush
constexpr int kChunks = kThreads / 2;          // 16-byte chunks a row
constexpr int kCopies = kRows * kChunks / kThreads;  // a thread's, a stage
static_assert(kRows * kChunks % kThreads == 0, "whole copies a stage");
static_assert(kEmitRows * (kThreads / 16) == kThreads,
              "one 16-byte flag vector a thread");

constexpr uint64_t kUmax = ~0ull;
constexpr uint64_t kLow47 = (1ull << 47) - 1;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Write flag rows [g * kEmitRows, (g + 1) * kEmitRows) of the block's
// columns from buffer `f`: one 16-byte piece a thread, bytes where the
// piece is not 16-byte aligned or crosses column B.
__device__ __forceinline__ void flush_flags(
    uint8_t (&f)[kEmitRows][kThreads], uint8_t* __restrict__ emit,
    int g, int H, int B, int b0, int tid) {
  constexpr int kPieces = kThreads / 16;
  const int rr = tid / kPieces;
  const int c = 16 * (tid % kPieces);
  const int o = g * kEmitRows + rr;
  if (o >= H || b0 + c >= B) return;
  uint8_t* dst = emit + static_cast<size_t>(o) * B + b0 + c;
  const uint8_t* src = &f[rr][c];
  if (b0 + c + 16 <= B && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
    for (int t = 0; t < 16 && b0 + c + t < B; ++t) dst[t] = src[t];
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_scan_kernel(const uint64_t* __restrict__ words,
                    const int32_t* __restrict__ mm_count,
                    const int32_t* __restrict__ num_required,
                    uint8_t* __restrict__ emit,
                    uint64_t* __restrict__ cand, int H, int B,
                    uint32_t ethr) {
  __shared__ __align__(16) uint64_t ring[kStages][kRows][kThreads];
  __shared__ __align__(16) uint8_t flags[2][kEmitRows][kThreads];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kThreads;
  const int b = b0 + tid;
  const bool live = b < B;
  const int rows = H + 1;
  const int nstages = (rows + kRows - 1) / kRows;

  // This thread's copies: chunk q = tid + m * kThreads of a stage is row
  // q / kChunks, columns 2 (q % kChunks) and the next. Their row and
  // source offset run with the stage (kRows rows a stage).
  int crow[kCopies], ccol[kCopies];
  size_t coff[kCopies];
#pragma unroll
  for (int m = 0; m < kCopies; ++m) {
    const int q = tid + m * kThreads;
    crow[m] = q / kChunks;
    ccol[m] = 2 * (q % kChunks);
    coff[m] = static_cast<size_t>(crow[m]) * B + b0 + ccol[m];
  }
  const size_t stage_step = static_cast<size_t>(kRows) * B;
  // the next stage to fetch into its slot, then one commit group (empty
  // past the end), so that group s always holds stage s
  int next = 0;
  auto fetch = [&]() {
    uint64_t(&slot)[kRows][kThreads] = ring[next % kStages];
#pragma unroll
    for (int m = 0; m < kCopies; ++m) {
      const int left = B - b0 - ccol[m];     // columns left from this chunk
      if (crow[m] < rows && left > 0) {
        const uint64_t* src = words + coff[m];
        uint64_t* dst = &slot[crow[m] & (kRows - 1)][ccol[m]];
        if (left >= 2 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          cp_async16(dst, src);
        } else {
          cp_async8(dst, src);
          if (left >= 2) cp_async8(dst + 1, src + 1);
        }
      }
      crow[m] += kRows;
      coff[m] += stage_step;
    }
    cp_async_commit();
    ++next;
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch();

  const int mm = live ? mm_count[b] : 0;
  const int req = live ? num_required[b] : 0;
  uint64_t best = 0, prev = 0;
  int min_cnt = 1, eq_cnt = 1, best_eq = 1;
  uint64_t* out = live ? cand + b : cand;
  int flushed = 0;                             // flag rows written
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();              // group s: this thread's part
    __syncthreads();                           // everyone's; stage s - 1 free
    fetch();                                   // stage s + kStages - 1
    // slots 0 .. s * kRows - 2 are done: flush a full buffer of flags
    if (min(H, s * kRows - 1) - flushed >= kEmitRows) {
      flush_flags(flags[(flushed / kEmitRows) & 1], emit,
                  flushed / kEmitRows, H, B, b0, tid);
      flushed += kEmitRows;
    }
    const uint64_t(&slot)[kRows][kThreads] = ring[s % kStages];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int i = s * kRows + j;
      if (i > H) break;
      const uint64_t cur = slot[j][tid];
      if (i == 0) {
        best = prev = cur;
        continue;
      }
      const uint32_t cur_hi = static_cast<uint32_t>(cur >> 32);
      const uint32_t cur_lo = static_cast<uint32_t>(cur);
      const uint32_t prev_hi = static_cast<uint32_t>(prev >> 32);
      const uint32_t prev_lo = static_cast<uint32_t>(prev);
      const uint32_t best_lo = static_cast<uint32_t>(best);
      // u32 sums wrap like the scan's uint32 lanes
      const bool boundary = cur_hi != prev_hi || cur_lo > prev_lo + ethr ||
                            (min_cnt >= mm && cur_lo > best_lo + ethr);
      const int o = i - 1;
      flags[(o / kEmitRows) & 1][o % kEmitRows][tid] =
          (boundary && min_cnt >= req && best != kUmax) ? 1 : 0;
      if (live)
        *out = (best & kLow47) | (static_cast<uint64_t>(best_eq & 0xFF) << 47);
      out += B;
      if (boundary) {
        min_cnt = 1;
        eq_cnt = 1;
        best_eq = 1;
        best = cur;
      } else {
        // candidate_processor.cc:311-331
        const bool is_best = cur == best;
        const bool is_prev = cur == prev;
        eq_cnt = (is_best || is_prev) ? eq_cnt + 1 : 1;
        const bool promote = !is_best && is_prev && eq_cnt > best_eq;
        best_eq = is_best ? best_eq + 1 : (promote ? eq_cnt : best_eq);
        if (promote) best = prev;
        min_cnt += 1;
      }
      prev = cur;
    }
  }
  __syncthreads();                             // the last flags are staged
  for (; flushed < H; flushed += kEmitRows)
    flush_flags(flags[(flushed / kEmitRows) & 1], emit, flushed / kEmitRows,
                H, B, b0, tid);
}

}  // namespace

extern "C" int cluster_scan(const void* words_ext, const void* mm_count,
                            const void* num_required, void* emit, void* cand,
                            int H, int B, int e, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  if (B > 0 && H > 0) {
    cluster_scan_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint64_t*>(words_ext),
        static_cast<const int32_t*>(mm_count),
        static_cast<const int32_t*>(num_required),
        static_cast<uint8_t*>(emit), static_cast<uint64_t*>(cand), H, B,
        static_cast<uint32_t>(e));
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = resident blocks per SM, threads per block, shared memory per
// block (bytes: the ring and the two flag buffers) and ring stages. `L`
// is unused: the ring does not depend on it.
extern "C" int cluster_scan_occupancy(int L, void* out) {
  (void)L;
  int* o = static_cast<int*>(out);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], cluster_scan_kernel, kThreads, 0);
  o[1] = kThreads;
  o[2] = static_cast<int>(sizeof(uint64_t) * kStages * kRows * kThreads +
                          2 * kEmitRows * kThreads);
  o[3] = kStages;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
