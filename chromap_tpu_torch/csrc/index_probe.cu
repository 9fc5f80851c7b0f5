// Index probe, one thread per query: the lower bound of each minimizer
// hash in the sorted key array, searched inside the hash's bucket, with
// the key's occurrence-list word gathered in the same launch.
//
// Replaces: no Pallas kernel. The JAX program probes with one merged u64
// sort of queries and keys (chromap_tpu/ops/device_seed.py
// `_probe_merge_sort`, chosen over a bucketed search on a v5e at 500k
// keys), and the port ran the same chain of torch library ops on every
// chunk: shift and join NK + Mtot words, radix-sort them, a prefix sum, a
// tiled suffix cummin, a scatter and the gathers of offcnt. At a 141 Mb
// genome's 31.8M keys that chain took 9.7 ms of a chunk's 12.9 ms of
// kernels on an H100, re-sorting keys that are sorted already.
//
// Layout: mz_h (M,) int64 carrying u64 hashes, all-ones (UMAX64) in the
// invalid slots; valid hashes are 2k-bit (k <= 31), so none is all-ones.
// keys (nk,) u64 sorted ascending and distinct, every one below
// nb << shift. offcnt (nk,) u32 or u64 words offset << 12 | min(count,
// 4095). table (nb + 1,) int32, nb a power of two: table[b] = the number
// of keys below b << shift. Out: off (M,) int64 = offcnt[loc] >> 12,
// cnt (M,) int32 = found ? offcnt[loc] & 0xFFF : 0, found (M,) uint8
// (torch.bool), where loc = min(lower_bound(q), nk - 1) and found says
// keys[loc] == q. An invalid query takes loc = nk - 1 and found = 0, as
// the merged sort gives.
//
// Design. The keys of bucket b = q >> shift are keys[table[b] ..
// table[b + 1]), and q's lower bound lies in [table[b], table[b + 1]]:
// every key before the bucket is below b << shift <= q, every key after
// it at or above (b + 1) << shift > q. So a thread makes four dependent
// reads: its query (coalesced), the bucket's two bounds (one sector of a
// table that stays in the 50 MB L2 at 22 bits, 16 MB), the bucket's keys
// in order up to the first at or above q (about 8 keys, 64 B, a bucket
// at 31.8M keys), and the found key's offcnt word; then three coalesced
// stores. The search compares whole u64 keys, so one kernel serves every
// k. Latency bounds each thread, so the grid has one thread per query
// (852k a chunk of 32,768 reads): at 2048 resident threads per SM (18
// registers a thread) the memory system holds ~270k chains in flight,
// ~3 waves a chunk.
//
// Bound on an H100 SXM (3.35 TB/s) at M = 851,968 and 31.8M keys: the
// queries in and the outputs out are 21 B a query, 17.9 MB, and each
// valid query needs at least its two bounds, one key and one offcnt
// word, 24-28 B more: about 38 MB, ~11 us. The random reads move whole
// 32-byte sectors, about four a query, ~110 MB, ~35 us at the peak rate.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py) it takes 0.0976 ms,
// 387 GB/s of the bytes above warm and 357 with the L2 flushed: the
// dependent random reads set the pace. Halving inside the bucket in
// place of the scan took 0.1046 ms in the same call, as it reads more
// sectors before it knows the lower bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kUmax = ~0ull;

template <typename Word>
__global__ void __launch_bounds__(kThreads)
index_probe_kernel(const uint64_t* __restrict__ mz_h,
                   const uint64_t* __restrict__ keys,
                   const Word* __restrict__ offcnt,
                   const int32_t* __restrict__ table,
                   int64_t* __restrict__ off, int32_t* __restrict__ cnt,
                   uint8_t* __restrict__ found, int M, int nk, int nb,
                   int shift) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= M) return;
  const uint64_t q = mz_h[i];
  int loc = nk - 1;
  bool hit = false;
  if (q != kUmax) {
    const uint64_t top_bucket = static_cast<uint64_t>(nb - 1);
    const uint64_t b = (q >> shift) < top_bucket ? (q >> shift) : top_bucket;
    int lo = __ldg(table + b);
    const int hi = __ldg(table + b + 1);
    // the bucket's keys in order, up to the first at or above q
    uint64_t key = kUmax;
    while (lo < hi && (key = __ldg(keys + lo)) < q) ++lo;
    hit = lo < hi && key == q;
    loc = lo < nk ? lo : nk - 1;
  }
  const uint64_t oc = offcnt[loc];
  off[i] = static_cast<int64_t>(oc >> 12);
  cnt[i] = hit ? static_cast<int32_t>(oc & 0xFFF) : 0;
  found[i] = hit ? 1 : 0;
}

template <typename Word>
void launch(const void* mz_h, const void* keys, const void* offcnt,
            const void* table, void* off, void* cnt, void* found, int M,
            int nk, int nb, int shift, cudaStream_t stream) {
  index_probe_kernel<Word>
      <<<(M + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          static_cast<const uint64_t*>(mz_h),
          static_cast<const uint64_t*>(keys),
          static_cast<const Word*>(offcnt),
          static_cast<const int32_t*>(table), static_cast<int64_t*>(off),
          static_cast<int32_t*>(cnt), static_cast<uint8_t*>(found), M, nk,
          nb, shift);
}

}  // namespace

// `wide`: offcnt holds u64 words (else u32).
extern "C" int index_probe(const void* mz_h, const void* keys,
                           const void* offcnt, const void* table, void* off,
                           void* cnt, void* found, int M, int nk, int nb,
                           int shift, int wide, void* stream) {
  if (M > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    (wide ? launch<uint64_t> : launch<uint32_t>)(
        mz_h, keys, offcnt, table, off, cnt, found, M, nk, nb, shift, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = resident blocks per SM, threads per block, shared memory per
// block (none) and 0, for the u64 offcnt tier of the main path's index.
// `L` is unused.
extern "C" int index_probe_occupancy(int L, void* out) {
  (void)L;
  int* o = static_cast<int*>(out);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[0], index_probe_kernel<uint64_t>, kThreads, 0);
  o[1] = kThreads;
  o[2] = 0;
  o[3] = 0;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
