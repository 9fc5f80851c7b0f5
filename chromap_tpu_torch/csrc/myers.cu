// Banded Myers bit-parallel edit distance, one candidate per thread, the
// block's rows streamed through a shared-memory ring.
//
// Replaces: chromap_tpu/ops/pallas_myers.py `_myers_kernel` (launched by
// `myers_device`) and its jnp twin `myers_jnp`, which the seeding step
// runs (device_seed.py `_build_step`, non-split verify). The band of
// 2e + 1 <= 31 diagonals lives in one 32-bit word per candidate; VP and
// VN stay in uint32_t registers, whose wrap equals the JAX int32 wrap bit
// for bit. Results are exact for distance <= e (alignment.cc:141-192
// without the mid-loop early exit, which only changes candidates past e).
//
// Layout (the JAX public layout): patterns_T (L + 2e, N) int32 and
// texts_T (L, N) int32 codes 0..4; out errors, endpos (N,) int32. Step i
// reads pattern row i + 2e and text row i.
//
// Design. The recurrence is sequential along the read, so each thread
// still owns one candidate column. A block of kThreads threads owns
// kThreads consecutive candidates and reads them as a stream of L + 2e
// rows (row r: pattern row r and, from r = 2e on, text row r - 2e; the 2e
// Peq init rows come first) through a ring of kStages stages of kRows
// rows of both planes in shared memory. Every lane runs every row (no
// early stop, unlike the drop-off kernel), so the whole block fills the
// ring with 16-byte `cp.async` copies -- a quarter of the copy
// instructions of one 4-byte copy per lane and row -- and one barrier per
// stage publishes a stage and frees the one before; kStages - 1 stages
// are in flight ahead of the step. A row whose start is not 16-byte
// aligned (N % 4 != 0) and the ragged last block take 4-byte copies, and
// no copy reads past column N - 1. Copy offsets run with the stage
// instead of being products of the row index. The band's pattern codes
// are three bit planes (bit j of P_c is bit c of the code at band cell
// j), so a text code selects its match word with three XORs and an AND
// with the band mask, with no select that diverges across the warp; a
// pattern code outside 0..4 becomes 7, which no text code matches, and
// a text code outside 0..3 reads as N = 4, as in the plain version.
//
// Bound on an H100 SXM (3.35 TB/s, 700 W) at N = 65536, L = 100, e = 8:
// it must read (2L + 2e) * 4 B * N = 56.6 MB and write 0.5 MB -- about
// 17 us. The step is ~25 integer instructions a row, ~1.8e8 in all,
// ~11 us at the card's ~16.7 T/s INT32 issue rate: close to the bytes,
// so the kernel must cut instructions as well as keep rows in flight.
// The earlier form (a five-way Peq select, two dependent 4-byte loads a
// row with addresses from row-index products) took 0.0450-0.0453 ms
// (~1.27 TB/s). On an H100 80GB HBM3 at 700 W (chip_smoke.py, the two
// forms in turns) this form takes 0.0304-0.0306 ms, ~1.87 TB/s warm and
// ~1.65 TB/s with the L2 flushed; 45 registers and 32 KB of shared
// memory allow 6 blocks per SM, and the grid gives ~4. A block whose
// every chunk is whole and aligned skips the edge tests, and a stage of
// Myers steps only skips the row tests (2% faster than testing every
// row and chunk); 16 KB rings, 8-row stages and 256-thread blocks took
// 0.031-0.032 ms.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                  // candidates a block
constexpr int kRows = 4;                       // rows a stage
constexpr int kStages = 8;                     // stages in the ring
constexpr int kChunks = kThreads / 4;          // 16-byte chunks a plane row
constexpr int kCopies = kRows * 2 * kChunks / kThreads;  // a thread's
static_assert(kRows * 2 * kChunks % kThreads == 0, "whole copies a stage");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
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

__global__ void __launch_bounds__(kThreads)
myers_kernel(const int32_t* __restrict__ patterns_T,
             const int32_t* __restrict__ texts_T,
             int32_t* __restrict__ errors, int32_t* __restrict__ endpos,
             int L, int N, int e) {
  __shared__ __align__(16) uint32_t ring[kStages][kRows][2][kThreads];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kThreads;
  const int e2 = 2 * e;
  const int rows = L + e2;
  const int nstages = (rows + kRows - 1) / kRows;

  // This thread's copies: chunk q = tid + m * kThreads of a stage is
  // stream row q / (2 kChunks), plane (q / kChunks) % 2, columns
  // 4 (q % kChunks) .. + 3. The plane's row (r, or r - 2e for the text)
  // and the source offset run with the stage.
  const int32_t* cbase[kCopies];
  int cj[kCopies], crow[kCopies], cend[kCopies], ccol[kCopies],
      cplane[kCopies];
  int64_t coff[kCopies];
#pragma unroll
  for (int m = 0; m < kCopies; ++m) {
    const int q = tid + m * kThreads;
    cplane[m] = (q / kChunks) % 2;
    cbase[m] = cplane[m] ? texts_T : patterns_T;
    cend[m] = cplane[m] ? L : rows;
    cj[m] = q / (2 * kChunks);
    crow[m] = cj[m] - (cplane[m] ? e2 : 0);
    ccol[m] = 4 * (q % kChunks);
    coff[m] = static_cast<int64_t>(crow[m]) * N + b0 + ccol[m];
  }
  const int64_t stage_step = static_cast<int64_t>(kRows) * N;
  // every chunk of this block is 16 whole, 16-byte aligned bytes: a full
  // block of columns, rows of a multiple of 4 words, aligned planes
  const bool whole =
      b0 + kThreads <= N && N % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(patterns_T) |
        reinterpret_cast<uintptr_t>(texts_T)) & 15) == 0;
  // the next stage to fetch into its slot, then one commit group (empty
  // past the end), so that group s always holds stage s
  int next = 0;
  auto fetch = [&]() {
    uint32_t(&slot)[kRows][2][kThreads] = ring[next % kStages];
#pragma unroll
    for (int m = 0; m < kCopies; ++m) {
      if (static_cast<unsigned>(crow[m]) < static_cast<unsigned>(cend[m])) {
        const int32_t* src = cbase[m] + coff[m];
        uint32_t* dst = &slot[cj[m]][cplane[m]][ccol[m]];
        const int left = N - b0 - ccol[m];   // columns left from this chunk
        if (whole || (left >= 4 &&
                      (reinterpret_cast<uintptr_t>(src) & 15) == 0)) {
          cp_async16(dst, src);
        } else {
          for (int t = 0; t < 4 && t < left; ++t) cp_async4(dst + t, src + t);
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

  const uint32_t band = (2u << e2) - 1u;       // cells 0..2e
  uint32_t P0 = 0u, P1 = 0u, P2 = 0u;
  uint32_t vp = 0u, vn = 0u;
  int num_err = 0;
  // one row of the stream: the code of pattern row r enters the band's
  // top cell (2e), one shift per row moves init row r to cell r
  // (alignment.cc direct placement); from r = 2e on, text row r - 2e
  // takes a Myers step
  auto row = [&](const uint32_t(&cell)[2][kThreads], bool step) {
    const uint32_t pr = cell[0][tid];
    const uint32_t pc = pr <= 4u ? pr : 7u;
    P0 |= (pc & 1u) << e2;
    P1 |= ((pc >> 1) & 1u) << e2;
    P2 |= (pc >> 2) << e2;
    if (step) {
      const uint32_t tr = cell[1][tid];
      const uint32_t tc = tr < 4u ? tr : 4u;
      const uint32_t m0 = 0u - (tc & 1u), m1 = 0u - ((tc >> 1) & 1u),
                     m2 = 0u - (tc >> 2);
      const uint32_t x = (~(P0 ^ m0) & ~(P1 ^ m1) & ~(P2 ^ m2) & band) | vn;
      const uint32_t d0 = ((vp + (x & vp)) ^ vp) | x;
      const uint32_t hn = vp & d0;
      const uint32_t hp = vn | ~(vp | d0);
      const uint32_t x2 = d0 >> 1;
      vn = x2 & hp;
      vp = hn | ~(x2 | hp);
      num_err += 1 - static_cast<int>(d0 & 1u);
    }
    P0 >>= 1;
    P1 >>= 1;
    P2 >>= 1;
  };
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kStages - 2>();              // group s: this thread's part
    __syncthreads();                           // everyone's; stage s - 1 free
    fetch();                                   // stage s + kStages - 1
    const uint32_t(&slot)[kRows][2][kThreads] = ring[s % kStages];
    const int r0 = s * kRows;
    if (r0 >= e2 && r0 + kRows <= rows) {      // a whole stage of steps
#pragma unroll
      for (int j = 0; j < kRows; ++j) row(slot[j], true);
    } else {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (r0 + j >= rows) break;
        row(slot[j], r0 + j >= e2);
      }
    }
  }
  const int n = b0 + tid;
  if (n >= N) return;                          // no barrier below
  // scan the band's 2e cells past the band start (L - 1); ties prefer
  // the diagonal (i + 1 == e), as pallas_myers.py does
  int min_err = num_err;
  int end_pos = L - 1;
  for (int i = 0; i < e2; ++i) {
    num_err += static_cast<int>((vp >> i) & 1u) -
               static_cast<int>((vn >> i) & 1u);
    if (num_err < min_err || (num_err == min_err && i + 1 == e)) {
      end_pos = L + i;
    }
    min_err = min(min_err, num_err);
  }
  errors[n] = min_err;
  endpos[n] = end_pos;
}

}  // namespace

extern "C" int myers(const void* patterns_T, const void* texts_T,
                     void* errors, void* endpos, int L, int N, int e,
                     void* stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  if (N > 0) {
    myers_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(patterns_T),
        static_cast<const int32_t*>(texts_T), static_cast<int32_t*>(errors),
        static_cast<int32_t*>(endpos), L, N, e);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = resident blocks per SM, threads per block, shared memory per
// block (bytes) and ring stages. `L` is unused: the ring does not depend
// on it.
extern "C" int myers_occupancy(int L, void* out) {
  (void)L;
  int* o = static_cast<int*>(out);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], myers_kernel, kThreads, 0);
  o[1] = kThreads;
  o[2] = static_cast<int>(sizeof(uint32_t) * kStages * kRows * 2 * kThreads);
  o[3] = kStages;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
