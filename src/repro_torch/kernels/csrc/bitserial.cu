// Bit-serial arithmetic over packed bit-planes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/bitserial.py::add_planes
// (K-bit ripple-carry adder over LSB-first planes, (K, R, C) x 2 ->
// (K+1, R, C)) and ::bitcount_planes (bit-sliced per-bit popcount across
// N planes, (N, R, C) -> (max(1, bit_length(N)), R, C)).  As in
// bitwise.cu the planes are flat streams of L = R*C 32-bit words, one
// thread per 16-byte vector (or per word when L is not a multiple of 4),
// neighbouring threads on neighbouring addresses, no padding.
//
// The running state stays in registers across the plane loop: the carry
// of the adder, and the k counter slices of the popcount (k is a template
// argument, 1..16, so the slices are registers, not local memory).
//
// Bound on an H100: bytes.  The adder reads 2K words and writes K+1 per
// word position with 5 logic operations per plane; the counter reads N
// words and writes k with 2k operations per input plane, which for the
// main path's N = 16 (k = 5) is still well under the card's integer rate
// per byte moved.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 operator&(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 operator|(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 operator^(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// a, b: k planes of len vectors; out: k + 1 planes (sum planes, carry last).
template <typename V>
__global__ void add_kernel(const V* __restrict__ a, const V* __restrict__ b,
                           int k, int64_t len, V* __restrict__ out) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < len;
       j += (int64_t)gridDim.x * blockDim.x) {
    V carry = V{};
    for (int i = 0; i < k; ++i) {
      const V ai = a[i * len + j];
      const V bi = b[i * len + j];
      const V axb = ai ^ bi;
      out[i * len + j] = axb ^ carry;
      carry = (ai & bi) | (carry & axb);
    }
    out[(int64_t)k * len + j] = carry;
  }
}

// in: n planes of len vectors; out: K counter slices, LSB first.
template <int K, typename V>
__global__ void count_kernel(const V* __restrict__ in, int n, int64_t len,
                             V* __restrict__ out) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < len;
       j += (int64_t)gridDim.x * blockDim.x) {
    V s[K];
#pragma unroll
    for (int q = 0; q < K; ++q) s[q] = V{};
    for (int i = 0; i < n; ++i) {
      V carry = in[i * len + j];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const V nxt = s[q] ^ carry;
        carry = s[q] & carry;
        s[q] = nxt;
      }
    }
#pragma unroll
    for (int q = 0; q < K; ++q) out[q * len + j] = s[q];
  }
}

constexpr int kThreads = 256;

unsigned grid_for(int64_t len) {
  int64_t blocks = (len + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

bool aligned(const void* p) { return ((uintptr_t)p % 16) == 0; }

template <int K>
void launch_count(const uint32_t* in, int n, int64_t words, uint32_t* out,
                  cudaStream_t s) {
  if (words % 4 == 0 && aligned(in) && aligned(out)) {
    const int64_t len = words / 4;
    count_kernel<K, uint4><<<grid_for(len), kThreads, 0, s>>>(
        (const uint4*)in, n, len, (uint4*)out);
  } else {
    count_kernel<K, uint32_t><<<grid_for(words), kThreads, 0, s>>>(
        in, n, words, out);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  The Python wrapper checks
// shapes, dtype, device and contiguity.  Each returns cudaGetLastError()
// after the launch.
extern "C" int add_planes(const uint32_t* a, const uint32_t* b, int k,
                          int64_t words, uint32_t* out, void* stream) {
  if (words == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (words % 4 == 0 && aligned(a) && aligned(b) && aligned(out)) {
    const int64_t len = words / 4;
    add_kernel<uint4><<<grid_for(len), kThreads, 0, s>>>(
        (const uint4*)a, (const uint4*)b, k, len, (uint4*)out);
  } else {
    add_kernel<uint32_t><<<grid_for(words), kThreads, 0, s>>>(a, b, k, words,
                                                              out);
  }
  return (int)cudaGetLastError();
}

// k must be max(1, bit_length(n)), 1..16 (n < 65536).
extern "C" int bitcount_planes(const uint32_t* in, int n, int k,
                               int64_t words, uint32_t* out, void* stream) {
  if (words == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
#define COUNT_CASE(K) \
  case K: launch_count<K>(in, n, words, out, s); break;
    COUNT_CASE(1) COUNT_CASE(2) COUNT_CASE(3) COUNT_CASE(4)
    COUNT_CASE(5) COUNT_CASE(6) COUNT_CASE(7) COUNT_CASE(8)
    COUNT_CASE(9) COUNT_CASE(10) COUNT_CASE(11) COUNT_CASE(12)
    COUNT_CASE(13) COUNT_CASE(14) COUNT_CASE(15) COUNT_CASE(16)
#undef COUNT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
