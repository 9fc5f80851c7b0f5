// Drop-off Myers bit-parallel edit distance (split alignment), one
// candidate per thread, its rows prefetched by asynchronous copies.
//
// Replaces: chromap_tpu/ops/pallas_myers.py `myers_dropoff_jnp` (a
// lax.scan over the read, which the seeding step runs twice per split
// candidate: once over the whole read, once over the read past a 5' gap;
// device_seed.py `_build_step`, split branch). It is the scalar kernel of
// alignment.cc:197-283: a candidate stops at the first step whose error
// passes 2e and keeps the state of the step before. The JAX program
// freezes such a lane by masking every later step; here the thread
// breaks out of its loop, which leaves the same VP, VN and error count.
// VP and VN stay in uint32_t registers (the uint32 wrap equals the JAX
// int32 wrap bit for bit).
//
// Layout (the JAX public layout): patterns_T (L + 2e, N) int32 and
// texts_T (L, N) int32 codes 0..4; out errors, endpos, rml (N,) int32.
// Step i reads pattern row i + 2e and text row i. The gap retry passes
// row-offset pointers (rows g.. of the same planes) and L - g.
//
// Design. The recurrence is sequential along the read, so each thread
// still owns one candidate column. It reads the column as a stream of
// L + 2e rows (row r: pattern row r and, from r = 2e on, text row r - 2e;
// the 2e Peq init rows come first) through a ring of kStages rows of both
// planes in shared memory, laid out [stage][plane][thread] so that a
// warp's copies land in consecutive banks. kStages - 1 rows are in flight
// ahead of the step that consumes them, as `cp.async` 4-byte copies (the
// planes' row stride N * 4 need not be 16-byte aligned), one commit group
// per row. A lane reads only its own column, so it waits on its own
// groups (`cp.async.wait_group`) and needs no block barrier. A lane that
// stops issues no further copies and drains its outstanding groups
// before it leaves; it has then fetched at most kStages - 1 rows past its
// stop, which the bound does not count. Each copy's addresses are running
// pointers, not products of the row index. The band's pattern codes are
// three bit planes (bit j of P_c is bit c of the code at band cell j), so
// a text code selects its match word with three XORs instead of a
// five-way select that diverges across the warp.
//
// Bound on an H100 SXM (3.35 TB/s, 700 W) at N = 65536, L = 100, e = 4:
// at most (2L + 2e) * 4 B * N = 54.5 MB read and 0.8 MB written, about
// 16.5 us; a lane that stops early reads fewer rows. The earlier form
// loaded each row behind the step's data-dependent break, so a warp
// whose lanes stop at different steps waited a memory latency per step;
// the ring keeps up to 7 rows (56 bytes) in flight per lane. On an H100
// 80GB HBM3 at 700 W (chip_smoke.py) this form took 0.034 ms on the
// kernel phase's planes, where half the lanes stop early, and 0.033 ms
// when none stops (the earlier form: 0.065 ms): the early stops no longer
// cost time. What remains is instruction issue (the copies take about as
// many instructions as the Myers step) with ~16 warps per SM, and the
// 128-byte row pieces, one per warp and row, that reach device memory
// scattered in time. A deeper ring (16 or 32 rows) was slower on the
// card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 8;                     // a power of two

// 4-byte asynchronous copy to shared-memory address `dst`
__device__ __forceinline__ void cp_async4(unsigned dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
myers_dropoff_kernel(const int32_t* __restrict__ patterns_T,
                     const int32_t* __restrict__ texts_T,
                     int32_t* __restrict__ errors,
                     int32_t* __restrict__ endpos, int32_t* __restrict__ rml,
                     int L, int N, int e) {
  __shared__ uint32_t ring[kStages][2][kThreads];
  const int tid = threadIdx.x;
  const int n = blockIdx.x * kThreads + tid;
  if (n >= N) return;                          // no block barrier below
  const int e2 = 2 * e;
  const int rows = L + e2;
  // the next rows to fetch, and this lane's cell of stage 0
  const int32_t* pat = patterns_T + n;
  const int32_t* txt = texts_T + n;
  const unsigned cell0 =
      static_cast<unsigned>(__cvta_generic_to_shared(&ring[0][0][tid]));
  constexpr unsigned kStageBytes = sizeof(ring[0]);
  constexpr unsigned kPlaneBytes = sizeof(ring[0][0]);

  // row r into stage r % kStages; one commit group per row, empty past
  // the end, so that group r always holds row r
  auto fetch = [&](int r) {
    if (r < rows) {
      const unsigned cell = cell0 + (r & (kStages - 1)) * kStageBytes;
      cp_async4(cell, pat);
      pat += N;
      if (r >= e2) {
        cp_async4(cell + kPlaneBytes, txt);
        txt += N;
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) fetch(r);

  // Peq as three bit planes of the band's pattern codes; a code outside
  // 0..4 becomes 7, which no text code matches, and a text code outside
  // 0..3 reads as N = 4, as in the plain version's select
  const uint32_t band = (2u << e2) - 1u;       // cells 0..2e
  uint32_t P0 = 0u, P1 = 0u, P2 = 0u;
  uint32_t vp = 0u, vn = 0u;
  int num_err = 0;
  int stop_i = L;
  bool fail = false;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    // refill the stage of row r - 1, whose values the step before has
    // used
    fetch(r + kStages - 1);
    cp_async_wait<kStages - 1>();              // group r: row r landed
    const uint32_t(&slot)[2][kThreads] = ring[r & (kStages - 1)];
    // the code of row r enters the band's top cell (2e); one shift per
    // row moves init row r to cell r (alignment.cc direct placement)
    const uint32_t pr = slot[0][tid];
    const uint32_t pc = pr <= 4u ? pr : 7u;
    P0 |= (pc & 1u) << e2;
    P1 |= ((pc >> 1) & 1u) << e2;
    P2 |= (pc >> 2) << e2;
    if (r >= e2) {
      const int i = r - e2;
      const uint32_t tr = slot[1][tid];
      const uint32_t tc = tr < 4u ? tr : 4u;
      const uint32_t m0 = 0u - (tc & 1u), m1 = 0u - ((tc >> 1) & 1u),
                     m2 = 0u - (tc >> 2);
      const uint32_t x = (~(P0 ^ m0) & ~(P1 ^ m1) & ~(P2 ^ m2) & band) | vn;
      const uint32_t d0 = ((vp + (x & vp)) ^ vp) | x;
      const int num_new = num_err + 1 - static_cast<int>(d0 & 1u);
      if (num_new > e2) {
        // keep step i - 1's VP, VN and error count
        stop_i = i;
        fail = i < 2 * e2 && i < L / 2;
        break;
      }
      const uint32_t hn = vp & d0;
      const uint32_t hp = vn | ~(vp | d0);
      const uint32_t x2 = d0 >> 1;
      vn = x2 & hp;
      vp = hn | ~(x2 | hp);
      num_err = num_new;
    }
    P0 >>= 1;
    P1 >>= 1;
    P2 >>= 1;
  }
  cp_async_wait_all();                         // nothing left in flight

  // scan the band's 2e cells past the band start (stop_i - 1, which is
  // -1 for a stop at step 0); ties prefer the diagonal (j + 1 == e)
  const int band_start = stop_i - 1;
  int min_err = num_err;
  int end_pos = band_start;
  for (int j = 0; j < e2; ++j) {
    num_err += static_cast<int>((vp >> j) & 1u) -
               static_cast<int>((vn >> j) & 1u);
    if (num_err < min_err || (num_err == min_err && j + 1 == e)) {
      end_pos = band_start + 1 + j;
    }
    min_err = min(min_err, num_err);
  }
  if (fail || (L > 60 && end_pos + 1 - e - min_err < 30)) end_pos = -end_pos;
  errors[n] = min_err;
  endpos[n] = end_pos;
  rml[n] = stop_i;
}

}  // namespace

extern "C" int myers_dropoff(const void* patterns_T, const void* texts_T,
                             void* errors, void* endpos, void* rml, int L,
                             int N, int e, void* stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  if (N > 0) {
    myers_dropoff_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(patterns_T),
        static_cast<const int32_t*>(texts_T), static_cast<int32_t*>(errors),
        static_cast<int32_t*>(endpos), static_cast<int32_t*>(rml), L, N, e);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = resident blocks per SM, threads per block, shared memory per
// block (bytes) and ring stages. `L` is unused: the ring does not depend
// on it.
extern "C" int myers_dropoff_occupancy(int L, void* out) {
  (void)L;
  int* o = static_cast<int*>(out);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], myers_dropoff_kernel, kThreads, 0);
  o[1] = kThreads;
  o[2] = static_cast<int>(sizeof(uint32_t) * kStages * 2 * kThreads);
  o[3] = kStages;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
