// Fused minimizer front end: run length -> canonical k-mer Hash64 ->
// closed-form window-minimizer emission, one thread block per tile of
// reads with every intermediate in shared memory.
//
// Replaces: chromap_tpu/ops/pallas_dense.py `_dense_kernel` (launched by
// `dense_minimizer_device`), whose outputs equal the jnp stages
// `_kmer_stage` / `_emission_stage` of chromap_tpu/ops/device_seed.py.
// The TPU kernel carries the hash in two int32 words because its vector
// unit is 32-bit; here it is one native uint64_t.
//
// Layout (the JAX public layout): codes_T (L, B) int32 0..4 (4 = N),
// lengths (B,) int32. Out: hlo/hhi/emit (L, B) int32, mm/bad (B,) int32.
//   hlo = hash bits 0..31, hhi = hash bits 32..55 | strand << 31, both -1
//   at invalid positions (run < k or symmetric k-mer). hhi == -1 happens
//   only there, since 2k <= 56 leaves bits 24..30 of hhi clear.
// Position p of read b lives at p * B + b.
//
// Design. A block of 256 threads owns a tile of R consecutive reads
// (R = 32, so a warp spans one position row of the tile and its global
// loads and stores are 128-byte rows) and all L positions of them. Thread
// (j, s) = (tid % R, tid / R) works on read j over the s-th of 256 / R
// strips of consecutive positions. Three phases, two barriers:
//   1. stage: the (L, R) codes tile goes to shared memory as bytes, one
//      coalesced global read of each code (4-byte loads: row p starts at
//      (p * B + b0) * 4, which is 16-byte aligned only when B % 4 == 0).
//   2. per position of the strip: the forward and reverse-complement
//      k-mer registers roll over the staged codes (warmed up over the
//      w + k codes before the strip, which fixes both k-mers and the run
//      length capped at w + k, the largest value any rule compares
//      against), three Hash64 per valid position; hlo/hhi are written
//      once, the 64-bit hash and a 2-valued run class (run >= w + k,
//      run == w + k - 1) stay in shared memory.
//   3. per position of the strip, the window rule of `_emission_stage`
//      from shared memory: first strictly smaller hash to the right
//      within w (r_off) with the run there, to the left within w - 1
//      (l_off), then disp | exit | flush; emit is written once. Both
//      scans run from the far end of the window inwards, so the nearest
//      smaller hash wins without a branch. A hash tie only feeds the
//      per-read `bad` flag, an OR over all positions, so each pair
//      (p, p + d) is tested once, from its left end.
//   mm and bad reduce over a read's strips through shared memory and are
//   written once: no global atomics, no global read of any output.
// Shared memory: L * R * (8 + 1 + 1) bytes + 2 KB; 34.0 KB at L = 100,
// 75.6 KB at L = 230 (dynamic, above 48 KB after cudaFuncSetAttribute).
// R halves while the tile does not fit in the card's per-block limit.
//
// Bound on an H100 SXM (3.35 TB/s, 700 W) at L = 100, B = 32768: it must
// read 13.1 MB (codes) and write 39.3 MB (three planes), ~16 us. The
// arithmetic, three Hash64 of ~55 32-bit instructions per k-mer and ~2w
// 64-bit shared-memory compares per position, runs on the SM's 64 INT32
// lanes (half the FP32 rate), so integer issue, not bytes, sets the time.
// On an H100 80GB HBM3 at 700 W this form took 0.077 ms at that shape
// (chip_smoke.py), ~680 GB/s, the same with the L2 flushed; 40 registers
// and 34 KB of shared memory leave 6 blocks (48 warps) per SM. The earlier
// form (one thread per read column walking all L positions, re-reading
// its hash column from global memory 2w times per position) had 8 warps
// per SM and took 0.32 ms, 20x its bytes bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileShift = 5;               // R = 32 reads a tile

__device__ __forceinline__ uint64_t hash64(uint64_t key, uint64_t mask) {
  // utils.h:76-85, within 2k bits
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = (key + (key << 3) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = (key + (key << 2) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

constexpr uint64_t kUmax = ~0ull;

size_t smem_bytes(int L, int rshift) {
  const size_t cells = static_cast<size_t>(L) << rshift;
  return cells * (sizeof(uint64_t) + 2) + 2 * kThreads * sizeof(int32_t);
}

__global__ void __launch_bounds__(kThreads)
dense_minimizer_kernel(const int32_t* __restrict__ codes_T,
                       const int32_t* __restrict__ lengths,
                       int32_t* __restrict__ hlo, int32_t* __restrict__ hhi,
                       int32_t* __restrict__ emit,
                       int32_t* __restrict__ mm_out,
                       int32_t* __restrict__ bad_out, int L, int B, int k,
                       int w, int rshift) {
  extern __shared__ uint64_t smem[];
  const int cells = L << rshift;
  uint64_t* s_hash = smem;                                   // [L][R]
  int32_t* s_mm = reinterpret_cast<int32_t*>(s_hash + cells);  // [threads]
  int32_t* s_bad = s_mm + kThreads;                          // [threads]
  uint8_t* s_codes = reinterpret_cast<uint8_t*>(s_bad + kThreads);
  uint8_t* s_runc = s_codes + cells;                         // [L][R]

  const int tid = threadIdx.x;
  const int R = 1 << rshift;
  const int j = tid & (R - 1);
  const int s = tid >> rshift;
  const int b0 = blockIdx.x << rshift;
  const int b = b0 + j;
  const bool live = b < B;

  // ---- 1. stage the codes tile ---------------------------------------
#pragma unroll 4
  for (int i = tid; i < cells; i += kThreads) {
    const int bb = b0 + (i & (R - 1));
    const size_t idx = static_cast<size_t>(i >> rshift) * B + bb;
    s_codes[i] = bb < B ? static_cast<uint8_t>(codes_T[idx]) : uint8_t{4};
  }
  __syncthreads();

  // this thread's strip of positions [p0, p1)
  const int nstrip = kThreads >> rshift;
  const int span = (L + nstrip - 1) / nstrip;
  const int p0 = s * span;
  const int p1 = min(L, p0 + span);
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const int rc_shift = 2 * (k - 1);
  const int cap = w + k;
  int bad = 0;

  // ---- 2. k-mers, runs and hashes ------------------------------------
  if (p0 < p1) {
    uint64_t fwd = 0, rc = 0;
    int run = 0;
    for (int q = max(0, p0 - cap); q < p1; ++q) {
      const int c = s_codes[(q << rshift) + j];
      const bool valid = c < 4;
      fwd = ((fwd << 2) | static_cast<uint64_t>(valid ? c : 0)) & mask;
      rc = (rc >> 2) | (static_cast<uint64_t>(valid ? c ^ 3 : 3) << rc_shift);
      run = valid ? min(run + 1, cap) : 0;
      if (q < p0) continue;                    // warm-up
      uint64_t h = kUmax;
      uint32_t lo = 0xFFFFFFFFu, hi = 0xFFFFFFFFu;
      if (run >= k) {
        const uint64_t hf = hash64(fwd, mask);
        const uint64_t hr = hash64(rc, mask);
        const bool strand = hf >= hr;
        if (fwd == rc) {
          bad = 1;                             // symmetric k-mer: invalid
        } else {
          h = hash64(strand ? hr : hf, mask);
          lo = static_cast<uint32_t>(h);
          hi = static_cast<uint32_t>(h >> 32) | (strand ? 0x80000000u : 0u);
        }
      }
      const int cell = (q << rshift) + j;
      s_hash[cell] = h;
      s_runc[cell] = run >= cap ? 2 : (run == cap - 1 ? 1 : 0);
      if (live) {
        const size_t idx = static_cast<size_t>(q) * B + b;
        hlo[idx] = static_cast<int32_t>(lo);
        hhi[idx] = static_cast<int32_t>(hi);
      }
    }
  }
  __syncthreads();

  // ---- 3. closed-form window emission --------------------------------
  const int INF = L + w + 1;
  const int seg_end = live ? lengths[b] - 1 : -1;
  const int dmax = min(w, L - 1);
  int mm = 0;
  for (int p = p0; p < p1; ++p) {
    const uint64_t hp = s_hash[(p << rshift) + j];
    const bool fin_p = hp != kUmax;
    // scanning d downwards, the last smaller hash seen is the first one;
    // both loop bounds are the same for the whole warp (p is)
    int r_off = INF, l_off = INF;
    bool tie = false;
    for (int d = min(dmax, L - 1 - p); d >= 1; --d) {
      const uint64_t hn = s_hash[((p + d) << rshift) + j];
      tie |= hn == hp;
      r_off = hn < hp ? d : r_off;
    }
    if (fin_p && tie) bad = 1;                 // window tie
    for (int d = min(w - 1, p); d >= 1; --d)
      l_off = s_hash[((p - d) << rshift) + j] < hp ? d : l_off;
    const bool has_r = r_off <= w;
    const int a = l_off >= INF ? p : p + w - l_off;
    const bool disp = has_r && a <= p + r_off - 1 &&
                      s_runc[((p + r_off) << rshift) + j] == 2;
    const bool can_exit = !has_r && p + w <= seg_end;
    const bool exit_emit =
        can_exit && p + w < L && s_runc[((p + w) << rshift) + j] >= 1;
    const bool flush = !has_r && p + w > seg_end && a <= seg_end;
    const int e = ((disp || exit_emit || flush) && fin_p) ? 1 : 0;
    if (live) emit[static_cast<size_t>(p) * B + b] = e;
    mm += e;
  }

  // ---- per-read reductions over the strips ---------------------------
  s_mm[tid] = mm;
  s_bad[tid] = bad;
  __syncthreads();
  if (tid < R && b0 + tid < B) {
    int m = 0, bd = 0;
    for (int t = 0; t < nstrip; ++t) {
      m += s_mm[(t << rshift) + tid];
      bd |= s_bad[(t << rshift) + tid];
    }
    mm_out[b0 + tid] = m;
    bad_out[b0 + tid] = bd;
  }
}

// The widest tile whose shared memory fits the device's per-block limit;
// sets the kernel's dynamic shared-memory ceiling when it passes 48 KB.
cudaError_t pick_tile(int L, int* rshift, size_t* smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  for (int r = kMaxTileShift; r >= 0; --r) {
    const size_t bytes = smem_bytes(L, r);
    if (bytes <= static_cast<size_t>(optin)) {
      *rshift = r;
      *smem = bytes;
      if (bytes > 48 * 1024)
        return cudaFuncSetAttribute(
            dense_minimizer_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;                // L too long for one read
}

}  // namespace

extern "C" int dense_minimizer(const void* codes_T, const void* lengths,
                               void* hlo, void* hhi, void* emit, void* mm,
                               void* bad, int L, int B, int k, int w,
                               void* stream) {
  if (B <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  int rshift = 0;
  size_t smem = 0;
  const cudaError_t err = pick_tile(L, &rshift, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + (1 << rshift) - 1) >> rshift;
  dense_minimizer_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(codes_T),
      static_cast<const int32_t*>(lengths), static_cast<int32_t*>(hlo),
      static_cast<int32_t*>(hhi), static_cast<int32_t*>(emit),
      static_cast<int32_t*>(mm), static_cast<int32_t*>(bad), L, B, k, w,
      rshift);
  return static_cast<int>(cudaGetLastError());
}

// out[0..3] = resident blocks per SM, threads per block, dynamic shared
// memory per block (bytes) and reads per tile, for a launch at this L.
extern "C" int dense_minimizer_occupancy(int L, void* out) {
  int* o = static_cast<int*>(out);
  int rshift = 0;
  size_t smem = 0;
  cudaError_t err = pick_tile(L, &rshift, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o[0], dense_minimizer_kernel, kThreads, smem);
  o[1] = kThreads;
  o[2] = static_cast<int>(smem);
  o[3] = 1 << rshift;
  return static_cast<int>(err);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
