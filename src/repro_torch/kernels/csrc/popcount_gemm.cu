// 1-bit (packed) GEMM through AND / XOR + popcount, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/popcount_gemm.py::
// popcount_gemm: x (M, KB) and w (N, KB) packed 32-bit words ->
// out (M, N) int32, with
//   kind AND:  out[m][n] = sum_b popc(x[m][b] & w[n][b])
//   kind XNOR: out[m][n] = 32*KB - 2 * sum_b popc(x[m][b] ^ w[n][b])
// (the dot product of {0,1} or {-1,+1} vectors of K = 32*KB bits).
//
// The TPU version pads M and N to 128 and KB to 64 words, runs the K axis
// as the innermost sequential grid dimension with the sum carried in the
// output block, and corrects xnor's zero padding by -32*pk afterwards.
// Here one block owns one 64 x 64 output tile and loops over K itself: K
// is staged through shared memory in chunks of 32 words (both operand
// tiles, stored k-major so a thread's 4 rows and 4 columns are bank-
// conflict-free reads), each of the 256 threads holds a 4 x 4 register
// micro-tile of int32 sums, and the xnor finish 32*KB - 2*acc happens in
// the epilogue.  Ragged M, N and KB are masked while loading (zero words:
// they add nothing to either kind's sum, since x ^ w = 0 for two padded
// words), so no padding copies and no -32*pk correction arise.
//
// Ceiling of this design on an H100: popcount issue rate, not bytes.
// Every (m, n, b) needs one POPC; compute capability 9.0 issues 16 of
// them per clock per SM (CUDA C++ Programming Guide, arithmetic-
// instruction throughput table: "32-bit integer population count"),
// against 64 for the AND/XOR and the add.  At the serve shapes
// (2048 x 9728 x 80 words) that is 1.6e9 POPCs, ~0.38 ms at 132 SMs x
// 1.98 GHz, while the operands are ~3 MB.  The card's bound for the
// product is lower still: the same +-1 product on the int8 tensor cores,
// ~0.05 ms.  A tensor-core design (mma.sync ... b1.and.popc) would lift
// this ceiling; this kernel is the simple, exact first version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { KIND_AND = 0, KIND_XNOR = 1 };

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // K words staged per step
constexpr int TX = 16;        // threads along N
constexpr int TY = 16;        // threads along M
constexpr int RM = BM / TY;   // rows per thread
constexpr int RN = BN / TX;   // columns per thread

// Stage rows [row0, row0 + 64) x words [k0, k0 + 32) of a (rows, kb)
// matrix into tile[k][r] (k-major, padded by one word against bank
// conflicts on the transposing store); out-of-range words are 0.  Thread
// t loads word k0 + t % 32 of rows t / 32 + 8p: each warp reads 128
// contiguous bytes of one row.
__device__ __forceinline__ void stage(const uint32_t* __restrict__ src,
                                      int rows, int kb, int row0, int k0,
                                      uint32_t (*tile)[BM + 1]) {
  const int t = threadIdx.y * TX + threadIdx.x;
  const int k = t % BK;
  const int gk = k0 + k;
#pragma unroll
  for (int p = 0; p < BM / 8; ++p) {
    const int r = t / BK + 8 * p;
    const int gr = row0 + r;
    tile[k][r] = (gr < rows && gk < kb) ? src[(int64_t)gr * kb + gk] : 0u;
  }
}

template <int KIND>
__global__ void __launch_bounds__(TX * TY)
popcount_gemm_kernel(const uint32_t* __restrict__ x,
                     const uint32_t* __restrict__ w, int m, int n, int kb,
                     int32_t* __restrict__ out) {
  __shared__ uint32_t sx[BK][BM + 1];
  __shared__ uint32_t sw[BK][BN + 1];
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int ty = threadIdx.y, tx = threadIdx.x;
  int acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < kb; k0 += BK) {
    stage(x, m, kb, row0, k0, sx);
    stage(w, n, kb, col0, k0, sw);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      uint32_t a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sx[k][ty + TY * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = sw[k][tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j)
          acc[i][j] += __popc(KIND == KIND_AND ? (a[i] & b[j])
                                               : (a[i] ^ b[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + ty + TY * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = col0 + tx + TX * j;
      if (c < n)
        out[(int64_t)r * n + c] =
            KIND == KIND_AND ? acc[i][j] : 32 * kb - 2 * acc[i][j];
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The Python wrapper checks
// shapes, dtype, device and contiguity.  Returns cudaGetLastError() after
// the launch.
extern "C" int popcount_gemm(const uint32_t* x, const uint32_t* w, int m,
                             int n, int kb, int kind, int32_t* out,
                             void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block(TX, TY);
  switch (kind) {
    case KIND_AND:
      popcount_gemm_kernel<KIND_AND><<<grid, block, 0, s>>>(x, w, m, n, kb,
                                                            out);
      break;
    case KIND_XNOR:
      popcount_gemm_kernel<KIND_XNOR><<<grid, block, 0, s>>>(x, w, m, n,
                                                             kb, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
