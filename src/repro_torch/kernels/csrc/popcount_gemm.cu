// 1-bit (packed) GEMM on Hopper's 1-bit tensor-core path (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/popcount_gemm.py::
// popcount_gemm: x (M, KB) and w (N, KB) packed 32-bit words ->
// out (M, N) int32, with
//   kind AND:  out[m][n] = sum_b popc(x[m][b] & w[n][b])
//   kind XNOR: out[m][n] = 32*KB - 2 * sum_b popc(x[m][b] ^ w[n][b])
// (the dot product of {0,1} or {-1,+1} vectors of K = 32*KB bits).
//
// Bound on an H100: 2*M*N*K operations at the 1-bit tensor-core rate, or
// the bytes, whichever is larger.  The data sheet lists no 1-bit rate;
// mma.sync .b1 measured native on the card, at the s8 instruction rate
// with 8x the bits (PERF.md), so the rate is 8 x the dense int8 1,979
// TOP/s.  At the serve shapes (2048 x 9728 x 80 words and 2048 x 2560 x
// 304) the operations take 0.0064 ms and the bytes bind: 0.0249 ms at the
// up shape, mostly the 79.7 MB int32 output, and 0.0079 ms at the down
// shape (3.35 TB/s).  The same product as ±1 int8 (the ported design's
// first plan) is bound at 0.0515 ms.
//
// Design: mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc multiplies
// the packed words as they are -- no expansion, 1 bit per K element
// through L2 and shared memory.  One block owns a 64 x 128 output tile
// (8 warps of 32 x 32, 8 mma per 256 bits of K, int32 sums in
// registers), walks K in stages of 512 bits (16 words a row) through a
// 4-stage cp.async ring, and reads the mma fragments with ldmatrix (a
// fragment of m16n8k256 .b1 is laid out as one of m16n8k32 .s8: 32 bits
// a register), the 16-byte chunks of each 64-byte row XOR-ed with
// (row / 2) % 4 so the 8 rows of one ldmatrix hit 8 bank groups.  Several
// blocks share an SM; on one H100 this tiling measured faster at both
// serve shapes than 128 x 128 tiles of 4 warps of 64 x 64 (the ring's
// latency wants the warps) or of 8 warps, and than 1024-bit stages.
// Ragged edges: cp.async zero-fills words past KB and rows past M or N,
// which adds nothing to an AND count; the epilogue masks its stores.  The tensor cores give AND counts only, so xnor is
//   32*KB - 2 popc(x ^ w),  popc(x ^ w) = (pc(x) - a) + (pc(w) - a),
// a = popc(x & w), with the row popcounts pc of x and w from a first
// kernel (rowpop_kernel, a warp a row).  A call launches 2 kernels for
// xnor, 1 for and.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { KIND_AND = 0, KIND_XNOR = 1 };

constexpr int MI = 2, NJ = 4;          // a warp's m16 x n8 blocks: 32 x 32
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int BM = WARPS_M * MI * 16;  // output tile: 64
constexpr int BN = WARPS_N * NJ * 8;   //            x 128
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int KW = 16;                 // K words a row per stage (512 bits)
constexpr int STAGES = 4;
constexpr int ROW = KW * 4;            // bytes of a row in a stage
constexpr int A_BYTES = BM * ROW, STAGE = (BM + BN) * ROW;
constexpr int SMEM = STAGES * STAGE;   // 48 KB
// dynamic shared memory beyond 48 KB would need an opt-in attribute
static_assert(SMEM <= 48 * 1024, "ring larger than the default limit");

// pc[r] = popcount of row r of x (r < m) or of row r - m of w
__global__ void rowpop_kernel(const uint32_t* __restrict__ x, int m,
                              const uint32_t* __restrict__ w, int n, int kb,
                              int* __restrict__ pc) {
  const int64_t r =
      (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (r >= (int64_t)m + n) return;
  const uint32_t* src = r < m ? x + r * kb : w + (r - m) * kb;
  int s = 0;
  for (int i = threadIdx.x % 32; i < kb; i += 32) s += __popc(__ldg(src + i));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) pc[r] = s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..3) of row r within a stage's A or B
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW + ((c ^ ((r >> 1) & 3)) << 4);
}

// asynchronous copy of 16 (or 4) bytes, zero-filled when !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += popc(A & B) for a 16 x 256 A (rows g, g + 8; words t, 4 + t) and a
// 256 x 8 B (column g; words t, 4 + t), thread (g, t) = (lane / 4, lane % 4)
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage st of the tile: words 16 st .. 16 st + 15 of its BM + BN rows.
// VEC: 16-byte copies (KB % 4 == 0, 16-byte aligned operands), else words.
template <bool VEC>
__device__ __forceinline__ void load_stage(uint8_t* stage,
                                           const uint32_t* __restrict__ x,
                                           const uint32_t* __restrict__ w,
                                           int m, int n, int kb, int r0,
                                           int c0, int st) {
  if (VEC) {
#pragma unroll
    for (int i = 0; i < (BM + BN) * 4 / THREADS; ++i) {
      const int idx = threadIdx.x + THREADS * i, r = idx / 4, c = idx % 4;
      const bool a = r < BM;
      const int row = a ? r0 + r : c0 + r - BM;
      const int kw = st * KW + 4 * c;
      const bool ok = row < (a ? m : n) && kw < kb;
      cp16(stage + (a ? 0 : A_BYTES) + swz(a ? r : r - BM, c),
           (a ? x : w) + (ok ? (int64_t)row * kb + kw : 0), ok);
    }
  } else {
    for (int i = 0; i < (BM + BN) * KW / THREADS; ++i) {
      const int idx = threadIdx.x + THREADS * i, r = idx / KW, k = idx % KW;
      const bool a = r < BM;
      const int row = a ? r0 + r : c0 + r - BM;
      const int kw = st * KW + k;
      const bool ok = row < (a ? m : n) && kw < kb;
      cp4(stage + (a ? 0 : A_BYTES) + swz(a ? r : r - BM, k / 4) +
              4 * (k % 4),
          (a ? x : w) + (ok ? (int64_t)row * kb + kw : 0), ok);
    }
  }
}

template <bool VEC, bool XNOR>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
            int m, int n, int kb, const int* __restrict__ pc,
            int32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tiles_m = (m + BM - 1) / BM;
  const int r0 = (blockIdx.x % tiles_m) * BM;
  const int c0 = (blockIdx.x / tiles_m) * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = MI * 16 * (warp % WARPS_M), wn = NJ * 8 * (warp / WARPS_M);
  const int nst = (kb + KW - 1) / KW;

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage<VEC>(smem + s * STAGE, x, w, m, n, kb, r0, c0, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // ldmatrix: lanes 8q .. 8q + 7 address the 8 rows of matrix q
  const int q = lane / 8, rr = lane % 8;
  for (int st = 0; st < nst; ++st) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();   // stage st landed; stage st - 1 is free again
    if (st + STAGES - 1 < nst)
      load_stage<VEC>(smem + (st + STAGES - 1) % STAGES * STAGE, x, w, m, n,
                      kb, r0, c0, st + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint8_t* sa = smem + st % STAGES * STAGE;
    const uint8_t* sb = sa + A_BYTES;
#pragma unroll
    for (int kc = 0; kc < KW / 8; ++kc) {   // 256 bits: chunks 2kc, 2kc + 1
      uint32_t af[MI][4], bf[NJ / 2][4];
      // A, 16 rows: matrices (rows 0-7 | 8-15) x (chunk 2kc | 2kc + 1)
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(af[i], sa + swz(wm + 16 * i + rr + 8 * (q & 1),
                                    2 * kc + (q >> 1)));
      // B, 16 columns = two n8 blocks: (chunk 2kc | 2kc + 1) x (columns
      // 0-7 | 8-15)
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j)
        ldmatrix_x4(bf[j], sb + swz(wn + 16 * j + rr + 8 * (q >> 1),
                                    2 * kc + (q & 1)));
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_and_popc(acc[i][j], af[i], bf[j / 2][2 * (j % 2)],
                       bf[j / 2][2 * (j % 2) + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const int g = lane / 4, t = lane % 4;
  const bool pairs = n % 2 == 0;           // 8-byte stores stay aligned
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wm + 16 * i + g + 8 * h;
      if (r >= m) continue;
      const int px = XNOR ? pc[r] : 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + wn + 8 * j + 2 * t;
        if (c >= n) continue;
        int v[2] = {acc[i][j][2 * h], acc[i][j][2 * h + 1]};
        if (XNOR) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // popc(x ^ w), then 32 KB - 2 of it; every term stays < 2^31
            const int pw = c + e < n ? pc[m + c + e] : 0;
            const int d = (px - v[e]) + (pw - v[e]);
            v[e] = (32 * kb - d) - d;
          }
        }
        int32_t* o = out + (int64_t)r * n + c;
        if (pairs) {
          *reinterpret_cast<int2*>(o) = make_int2(v[0], v[1]);
        } else {
          o[0] = v[0];
          if (c + 1 < n) o[1] = v[1];
        }
      }
    }
}

template <bool VEC, bool XNOR>
int launch(const uint32_t* x, const uint32_t* w, int m, int n, int kb,
           const int* pc, int32_t* out, cudaStream_t s) {
  const int64_t tiles = (int64_t)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  gemm_kernel<VEC, XNOR><<<(unsigned)tiles, THREADS, SMEM, s>>>(
      x, w, m, n, kb, pc, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The Python wrapper checks
// shapes, dtype, device and contiguity; pc holds M + N int32 for xnor
// (unused for and).  Launches the row popcounts (xnor), then the GEMM, on
// the same stream; returns the first launch error, else cudaGetLastError().
extern "C" int popcount_gemm(const uint32_t* x, const uint32_t* w, int m,
                             int n, int kb, int kind, int* pc, int32_t* out,
                             void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = kb % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  if (kind == KIND_AND)
    return vec ? launch<true, false>(x, w, m, n, kb, pc, out, s)
               : launch<false, false>(x, w, m, n, kb, pc, out, s);
  if (kind != KIND_XNOR) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)m + n;
  rowpop_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(x, m, w, n, kb,
                                                            pc);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return vec ? launch<true, true>(x, w, m, n, kb, pc, out, s)
             : launch<false, true>(x, w, m, n, kb, pc, out, s);
}
