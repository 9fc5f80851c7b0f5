// Drop-off Myers bit-parallel edit distance (split alignment), one
// candidate per thread.
//
// Replaces: chromap_tpu/ops/pallas_myers.py `myers_dropoff_jnp` (a
// lax.scan over the read, which the seeding step runs twice per split
// candidate: once over the whole read, once over the read past a 5' gap;
// device_seed.py `_build_step`, split branch). It is the scalar kernel of
// alignment.cc:197-283: a candidate stops at the first step whose error
// passes 2e and keeps the state of the step before. The JAX program
// freezes such a lane by masking every later step; here the thread
// breaks out of its loop, which leaves the same VP, VN and error count.
// VP, VN and the five Peq words stay in uint32_t registers (the uint32
// wrap equals the JAX int32 wrap bit for bit).
//
// Layout (the JAX public layout): patterns_T (L + 2e, N) int32 and
// texts_T (L, N) int32 codes 0..4; out errors, endpos, rml (N,) int32.
// Step i reads pattern row i + 2e and text row i; with one thread per
// column a warp's loads of one row are coalesced. The gap retry passes
// row-offset pointers (rows g.. of the same planes) and L - g.
//
// Bound on an H100 SXM (3.35 TB/s, 700 W) at N = 65536, L = 100, e = 4:
// at most (2L + 2e) * 4 B * N = 54.5 MB read and 0.8 MB written, about
// 16.5 us; a lane that stops early reads fewer rows. Each step is ~30
// integer ops, ~2e8 in all, ~3 us at the 67 T/s 32-bit rate: the kernel
// is bound by bytes. Early stops diverge within a warp; a stopped thread
// idles until its warp's last lane ends, which costs issue slots but no
// bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void set_highest(uint32_t (&peq)[5], int row,
                                            uint32_t highest) {
#pragma unroll
  for (int c = 0; c < 5; ++c) peq[c] = row == c ? (peq[c] | highest) : peq[c];
}

__global__ void myers_dropoff_kernel(const int32_t* __restrict__ patterns_T,
                                     const int32_t* __restrict__ texts_T,
                                     int32_t* __restrict__ errors,
                                     int32_t* __restrict__ endpos,
                                     int32_t* __restrict__ rml, int L, int N,
                                     int e) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const uint32_t highest = 1u << (2 * e);
  uint32_t peq[5] = {0u, 0u, 0u, 0u, 0u};
  // the bit from init row i ends at position i (alignment.cc direct
  // placement): insert at the top bit, shift once per later row
  for (int i = 0; i < 2 * e; ++i) {
    set_highest(peq, patterns_T[static_cast<size_t>(i) * N + n], highest);
#pragma unroll
    for (int c = 0; c < 5; ++c) peq[c] >>= 1;
  }
  uint32_t vp = 0u, vn = 0u;
  int num_err = 0;
  int stop_i = L;
  bool fail = false;
  for (int i = 0; i < L; ++i) {
    set_highest(peq, patterns_T[static_cast<size_t>(i + 2 * e) * N + n],
                highest);
    const int t = texts_T[static_cast<size_t>(i) * N + n];
    uint32_t x = t == 0 ? peq[0]
               : t == 1 ? peq[1]
               : t == 2 ? peq[2]
               : t == 3 ? peq[3]
                        : peq[4];
    x |= vn;
    const uint32_t d0 = ((vp + (x & vp)) ^ vp) | x;
    const int num_new = num_err + 1 - static_cast<int>(d0 & 1u);
    if (num_new > 2 * e) {
      // keep step i - 1's VP, VN and error count
      stop_i = i;
      fail = i < 4 * e && i < L / 2;
      break;
    }
    const uint32_t hn = vp & d0;
    const uint32_t hp = vn | ~(vp | d0);
    const uint32_t x2 = d0 >> 1;
    vn = x2 & hp;
    vp = hn | ~(x2 | hp);
    num_err = num_new;
#pragma unroll
    for (int c = 0; c < 5; ++c) peq[c] >>= 1;
  }
  // scan the band's 2e cells past the band start (stop_i - 1, which is
  // -1 for a stop at step 0); ties prefer the diagonal (j + 1 == e)
  const int band_start = stop_i - 1;
  int min_err = num_err;
  int end_pos = band_start;
  for (int j = 0; j < 2 * e; ++j) {
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
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  if (N > 0) {
    myers_dropoff_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(patterns_T),
        static_cast<const int32_t*>(texts_T), static_cast<int32_t*>(errors),
        static_cast<int32_t*>(endpos), static_cast<int32_t*>(rml), L, N, e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
