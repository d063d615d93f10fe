// N-ary bitwise reduce and complement over packed bit-planes, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels repro/kernels/bitwise.py::nary_bitwise
// (AND / OR / NAND / NOR / XOR across the N planes of an (N, R, C) stack),
// ::bitwise_not and ::maj3 (the bitwise 3-input majority of three planes).  The TPU version cuts the planes into (8, 512) tiles
// and pads R and C up to them; here the planes are flat streams of L = R*C
// 32-bit words and one thread owns one 16-byte vector (4 words) of every
// plane, or one word when L is not a multiple of 4, so neighbouring threads
// read neighbouring addresses and the ragged tail needs no padding.  The
// running value stays in registers across the plane loop; the op is a
// template argument, so the loop body is one logic instruction per word.
//
// Bound on an H100: bytes.  Per output word it reads N words and writes
// one, with N - 1 logic operations (plus one NOT for NAND/NOR; four for
// MAJ3's (a & b) | (c & (a | b)) over three words): far below the card's
// integer rate per byte moved.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { OP_AND = 0, OP_OR = 1, OP_NAND = 2, OP_NOR = 3, OP_XOR = 4 };

__device__ __forceinline__ uint4 operator&(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
__device__ __forceinline__ uint4 operator|(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}
__device__ __forceinline__ uint4 operator^(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint4 operator~(uint4 a) {
  return make_uint4(~a.x, ~a.y, ~a.z, ~a.w);
}

template <int OP, typename V>
__device__ __forceinline__ V combine(V a, V b) {
  if (OP == OP_AND || OP == OP_NAND) return a & b;
  if (OP == OP_OR || OP == OP_NOR) return a | b;
  return a ^ b;
}

// planes: n planes of len vectors each, plane i at planes + i * len.
template <int OP, typename V>
__global__ void nary_kernel(const V* __restrict__ planes, int n, int64_t len,
                            V* __restrict__ out) {
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < len;
       k += (int64_t)gridDim.x * blockDim.x) {
    V acc = planes[k];
#pragma unroll 4
    for (int i = 1; i < n; ++i) acc = combine<OP>(acc, planes[i * len + k]);
    if (OP == OP_NAND || OP == OP_NOR) acc = ~acc;
    out[k] = acc;
  }
}

template <typename V>
__global__ void not_kernel(const V* __restrict__ in, int64_t len,
                           V* __restrict__ out) {
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < len;
       k += (int64_t)gridDim.x * blockDim.x)
    out[k] = ~in[k];
}

template <typename V>
__global__ void maj3_kernel(const V* __restrict__ a, const V* __restrict__ b,
                            const V* __restrict__ c, int64_t len,
                            V* __restrict__ out) {
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < len;
       k += (int64_t)gridDim.x * blockDim.x) {
    const V x = a[k], y = b[k], z = c[k];
    out[k] = (x & y) | (z & (x | y));
  }
}

constexpr int kThreads = 256;

unsigned grid_for(int64_t len) {
  int64_t blocks = (len + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

bool vec_ok(const void* a, const void* b, int64_t words) {
  return words % 4 == 0 && ((uintptr_t)a % 16) == 0 &&
         ((uintptr_t)b % 16) == 0;
}

template <int OP>
void launch_nary(const uint32_t* planes, int n, int64_t words, uint32_t* out,
                 cudaStream_t s) {
  if (vec_ok(planes, out, words)) {
    const int64_t len = words / 4;
    nary_kernel<OP, uint4><<<grid_for(len), kThreads, 0, s>>>(
        (const uint4*)planes, n, len, (uint4*)out);
  } else {
    nary_kernel<OP, uint32_t><<<grid_for(words), kThreads, 0, s>>>(
        planes, n, words, out);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  The Python wrapper checks
// shapes, dtype, device and contiguity, and that op is 0..4 and n >= 1.
// Each returns cudaGetLastError() after the launch.
extern "C" int nary_bitwise(const uint32_t* planes, int n, int64_t words,
                            int op, uint32_t* out, void* stream) {
  if (words == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case OP_AND: launch_nary<OP_AND>(planes, n, words, out, s); break;
    case OP_OR: launch_nary<OP_OR>(planes, n, words, out, s); break;
    case OP_NAND: launch_nary<OP_NAND>(planes, n, words, out, s); break;
    case OP_NOR: launch_nary<OP_NOR>(planes, n, words, out, s); break;
    case OP_XOR: launch_nary<OP_XOR>(planes, n, words, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int bitwise_not(const uint32_t* in, int64_t words, uint32_t* out,
                           void* stream) {
  if (words == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_ok(in, out, words)) {
    const int64_t len = words / 4;
    not_kernel<uint4><<<grid_for(len), kThreads, 0, s>>>(
        (const uint4*)in, len, (uint4*)out);
  } else {
    not_kernel<uint32_t><<<grid_for(words), kThreads, 0, s>>>(in, words,
                                                                out);
  }
  return (int)cudaGetLastError();
}

extern "C" int maj3(const uint32_t* a, const uint32_t* b, const uint32_t* c,
                    int64_t words, uint32_t* out, void* stream) {
  if (words == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_ok(a, out, words) && vec_ok(b, c, words)) {
    const int64_t len = words / 4;
    maj3_kernel<uint4><<<grid_for(len), kThreads, 0, s>>>(
        (const uint4*)a, (const uint4*)b, (const uint4*)c, len, (uint4*)out);
  } else {
    maj3_kernel<uint32_t><<<grid_for(words), kThreads, 0, s>>>(a, b, c,
                                                                words, out);
  }
  return (int)cudaGetLastError();
}
