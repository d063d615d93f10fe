// Flash-attention backward with grouped K/V, for Hopper (sm_90a).
//
// Replaces the backward of the reference's layers.fused_attention region
// (repro/models/layers.py:266 _fused_flash_bwd_impl, behind the custom_vjp
// whose forward is flash_attention.cu's function), computing by recompute:
//   q (B, Sq, H, hd), k / v (B, Sk, KV, hd) with H % KV == 0 (query head h
//   reads kv head h / (H/KV), unrepeated), positions q_pos (B, Sq) and
//   kv_pos (B, Sk) int32, the forward's out (B, Sq, H, hd) and lse
//   (B, H, Sq) float32, and dout (B, Sq, H, hd) ->
//   dq (B, Sq, H, hd), dk / dv (B, Sk, KV, hd), every one in q's type:
//     s = q.k * scale (scale = 1/sqrt(hd)), s = c * tanh(s / c) with
//       softcap c > 0,
//     keep = q_pos >= kv_pos (and q_pos - kv_pos < window when window > 0),
//     p = keep ? exp(s - lse) : 0,
//     delta = sum_d round(dout * out) (the product at q's type, the sum in
//       float32: the reference's jnp.sum((dout * out).astype(f32), -1)),
//     dv = p^T . dout, dp = dout . v^T,
//     ds = p * (dp - delta), times (1 - t^2) under softcap,
//     dq = ds . k * scale, dk = ds^T . q * scale.
//   p and ds are rounded to q's type before their products, float32 sums;
//   dk and dv of a kv head sum the H/KV query heads of its group in
//   float32 and round once (the reference rounds each query head's, then
//   sums the group: the transpose of its jnp.repeat of K/V).
// No floating-point atomics anywhere: every sum runs in a fixed order, so
// two runs on the same inputs give bit-identical gradients.  Ragged Sq, Sk
// and hd are masked in the kernels (zero rows and columns in shared
// memory, positions past Sk never visible); a tile pair no query of the
// one can see a key of the other (the causal future, keys behind the
// window, positions past Sk) is skipped.
//
// What bounds it on an H100: the five products over the visible pairs,
// 10 * hd operations a pair and head (1.074e11 for the qwen3-4b training
// shape, B = 2, Sq = Sk = 2048, 32 heads of 80, causal: 0.1086 ms at
// 989 TFLOP/s bf16) — operations.
//
// bf16 at hd 33..128 (D = 64, 80, 128: the repo's training heads), two
// launches a call:
//   bwd_prep  per (b, token, head) row delta and lse * log2(e), padded to
//             whole 64-query tiles; per 64-query tile its position range,
//             how many key tiles see it (a tile no key tile sees gets
//             dq = 0 here) and its zeroed dq counters; per key tile its
//             position range; the work ticket reset;
//   bwd_wg    one pass of the five products.  A work item is (batch, kv
//             head, key tile of BN = 64 * NWG keys), taken from an
//             integer ticket in ascending key-tile order (the longest
//             causal walks first).  Its NWG consumer warpgroups own 64
//             keys each, with their dK and dV in registers, and walk the
//             visible 64-query tiles from the last one down, the group's
//             G query heads inner:
//               S^T = K Q^T and dP^T = V dO^T by wgmma (K, V, Q, dO K-major
//                 in shared memory),
//               P^T and dS^T in registers (exp2 of one FMA per score),
//               dV += P^T dO and dK += dS^T Q by wgmma (P^T / dS^T as
//                 register A fragments, dO / Q the MN-major B operand),
//               dQ_part = dS K by wgmma from dS^T stored to shared memory
//                 (the MN-major A operand) and K (MN-major B), over all BN
//                 keys, by the last warpgroup (the first runs ahead).
//             A fourth warpgroup holds a copy warp and NBUF = 3 dq writer
//             warps.  Writer w adds the dQ_part of steps w (mod 3) (64 x D
//             float32, in shared memory) to a float32 workspace dq_acc (B,
//             H, Sq padded, D) in a fixed order: per (b, head, query tile)
//             an integer counter says how many of the key tiles that see
//             the tile have added; the item of key tile j waits for the
//             count of visible key tiles before j, adds with plain loads
//             and stores, fences and bumps the counter.  Every item a block
//             waits for took its ticket earlier, so no wait can deadlock,
//             and as all items of a (b, kv head) walk the query tiles in
//             one order the waits cost a one-time skew.  The last adder
//             writes dq = bf16(dq_acc * scale).
// What it does about what held the PR 19 design back (PERF.md):
//   synchronous staging at low occupancy -> Q, dO, lse * log2(e), delta
//     and the positions of each (query tile, head) step come through a
//     3-stage ring (2 at hd 128) written by the copy warp with cp.async
//     straight into the swizzled layouts; the warp waits on its own
//     groups, then releases the stage with a named barrier (PR 15 found
//     TMA maps no faster than cp.async), so a step's loads overlap the
//     steps before it; two consumer warpgroups (hd 64 / 80) share an SM,
//     setmaxnreg giving them 208 registers and the copy / writer warps 88;
//   mma.sync and B fragments fetched again per k-step -> wgmma with every
//     B operand (and K, V, dS as A) read by the tensor cores from shared
//     memory in the forward's 128B / 32B swizzled layouts;
//   seven products (dq recomputed S and dP) -> five, dq in the same pass;
//   hd 128 spilled -> one consumer warpgroup at hd 128 (64-key items,
//     255 registers a thread), 0 spill bytes at hd 64, 80 and 128.
//
// hd <= 32 (test and smoke configs): three kernels a call on mma.sync
// m16n8k16 (bwd_delta; bwd_dkdv_mma, one block per (batch, kv head, 64
// keys) walking every query tile of the group; bwd_dq_mma, one block per
// (batch, query head, 64 queries)).  float32 q: the same walk on the CUDA
// cores, 32-row tiles, 256 threads, each owning 4 scores and D/8
// accumulator columns (the parity path).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BT = 64;          // rows per tile, bf16 mma.sync path; and
                                // queries per step of the wgmma path
constexpr int BF = 32;          // rows per tile, float32 path
constexpr int F32_THREADS = 256;
constexpr int PAD_POS = 0x3fffffff;  // int32 max / 2: keys past Sk
constexpr int QPAD_POS = INT_MIN / 2;  // query rows past Sq (wgmma path)
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  const void* out;
  const float* lse;
  const void* dout;
  float* delta;      // (B, H, Sq) scratch, written by bwd_delta
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, KV, hd, window;
  float scale, softcap;
  // the wgmma path's workspace (bwd_prep writes all but dq_acc)
  float* dq_acc;     // (B, H, sq_pad, D) float32 dQ sums
  float* lse2;       // (B, H, sq_pad) lse * log2(e), 0 past Sq
  float* delta2;     // (B, H, sq_pad) delta, 0 past Sq
  int* qpos2;        // (B, sq_pad) q_pos, QPAD_POS past Sq
  int2* qrange;      // (B, n_qt) smallest / largest position of a tile
  int2* krange;      // (B, n_kt) the same per BN-key tile
  int* ntot;         // (B, n_qt) key tiles that see the query tile
  int* counters;     // (B, H, n_qt) key tiles that added to dq_acc
  int* ticket;       // the next work item
  int sq_pad, n_qt, n_kt, bn;
  // scale * log2(e), softcap * log2(e), scale / softcap (0 without)
  float scale2, cap2, to_t;
};

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void warp_minmax(int& lo, int& hi) {
  for (int o = 1; o < 32; o <<= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// dout * out at the activation type: exact in float32 (two 8-bit
// significands), then rounded to bf16 as the reference's bf16 product.
__device__ __forceinline__ float prod(float o, float d) { return o * d; }
__device__ __forceinline__ float prod(__nv_bfloat16 o, __nv_bfloat16 d) {
  return __bfloat162float(
      __float2bfloat16_rn(__bfloat162float(o) * __bfloat162float(d)));
}

__device__ __forceinline__ bool keep(const Args& a, int qp, int kp) {
  return qp >= kp && (a.window <= 0 || qp - kp < a.window);
}

__device__ __forceinline__ int kv_pos_at(const Args& a, int b, int key) {
  return key < a.Sk ? a.kv_pos[(int64_t)b * a.Sk + key] : PAD_POS;
}

// Whether some query with a position in [qmin, qmax] may see some key with
// a position in [kmin, kmax] (an empty range, min > max, sees nothing).
__device__ __forceinline__ bool visible(const Args& a, int kmin, int kmax,
                                        int qmin, int qmax) {
  if (kmin > kmax || qmin > qmax || kmin > qmax) return false;
  if (a.window > 0 && (int64_t)kmax <= (int64_t)qmin - a.window) return false;
  return true;
}

// Whether every query in [qmin, qmax] sees every key in [kmin, kmax] (the
// tile pair needs no mask).
__device__ __forceinline__ bool all_visible(const Args& a, int kmin, int kmax,
                                            int qmin, int qmax) {
  return kmax <= qmin &&
         (a.window <= 0 || (int64_t)qmax - kmin < a.window);
}

// Smallest and largest position of the valid rows [r0, r0 + N) of a
// position row (n valid in all), computed by one warp; every warp that
// calls it gets the same answer.
template <int N>
__device__ __forceinline__ void pos_range(const int* pos, int r0, int n,
                                          int lane, int& lo, int& hi) {
  lo = 0x7fffffff;
  hi = -0x7fffffff - 1;
#pragma unroll
  for (int r = lane; r < N; r += 32)
    if (r0 + r < n) {
      const int p = pos[r0 + r];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  warp_minmax(lo, hi);
}

// The score of one (query, key) pair from its raw product: -> p, and the
// factor of ds (1 - t^2 under softcap, else 1).
__device__ __forceinline__ float prob(const Args& a, float raw, float lse,
                                      bool ok, float& dsm, bool fast) {
  float s = raw * a.scale;
  dsm = 1.f;
  if (a.softcap > 0.f) {
    const float t = tanhf(s / a.softcap);
    s = a.softcap * t;
    dsm = 1.f - t * t;
  }
  if (!ok) return 0.f;
  return fast ? exp2f((s - lse) * LOG2E) : expf(s - lse);
}

// ---------------------------------------------------------------------------
// delta = rowsum(round(dout * out)), one warp per (b, token, head) row
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS) bwd_delta(const Args a) {
  const int64_t rows = (int64_t)a.B * a.Sq * a.H;
  const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = static_cast<const T*>(a.out) + row * a.hd;
  const T* d = static_cast<const T*>(a.dout) + row * a.hd;
  float s = 0.f;
  for (int c = lane; c < a.hd; c += 32) s += prod(o[c], d[c]);
  s = warp_sum(s);
  if (lane == 0) {
    const int64_t per_b = (int64_t)a.Sq * a.H;
    const int64_t b = row / per_b, rem = row % per_b;
    const int tok = (int)(rem / a.H), h = (int)(rem % a.H);
    a.delta[((int64_t)b * a.H + h) * a.Sq + tok] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16 at hd <= 32: mma.sync m16n8k16
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&x)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [r0, r0 + BT) of a (rows, stride) bf16 matrix into shared memory
// with row stride STR, 16-byte units; rows past n_rows and columns past
// hd are zero.
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int n_rows,
                                           int hd) {
  constexpr int STR = D + 8;
  constexpr int UPR = D / 8;
  for (int u = threadIdx.x; u < BT * UPR; u += THREADS) {
    const int r = u / UPR, c = (u % UPR) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows && c < hd)
      x = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * STR + c) = x;
  }
}

// Row / column of element e of an m16n8 accumulator tile, within the tile
// (lane / 4 and +8; 2 (lane % 4) and +1).
__device__ __forceinline__ int acc_row(int lane, int e) {
  return lane / 4 + 8 * (e / 2);
}
__device__ __forceinline__ int acc_col(int lane, int e) {
  return 2 * (lane % 4) + (e % 2);
}

// Shared memory of the bf16 kernels: four (BT, D + 8) bf16 tiles, then
// BT floats twice (lse, delta) and BT ints (positions).
template <int D>
constexpr int mma_smem_bytes() {
  return 4 * BT * (D + 8) * 2 + 3 * BT * 4;
}

// S^T = K Q^T and dP^T = V dO^T of this warp's 16 rows of `ra` / `rb`
// against all BT rows of `ca` / `cb` (both products share the k loop).
template <int D>
__device__ __forceinline__ void two_products(const __nv_bfloat16* ra,
                                             const __nv_bfloat16* ca,
                                             const __nv_bfloat16* rb,
                                             const __nv_bfloat16* cb,
                                             int warp, int lane,
                                             float (&s)[BT / 8][4],
                                             float (&t)[BT / 8][4]) {
  constexpr int STR = D + 8;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
  // A: lanes 8i .. 8i+7 address rows (i % 2) * 8 .., columns (i / 2) * 8;
  // B (rows = n): rows (i / 2) * 8 .., columns (i % 2) * 8
  const int a_off =
      (16 * warp + (lane % 8) + 8 * ((lane / 8) % 2)) * STR + 8 * (lane / 16);
  const int b_off = ((lane % 8) + 8 * (lane / 16)) * STR + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t xa[4], xb[4];
    ldmatrix_x4(xa, ra + a_off + 16 * kk);
    ldmatrix_x4(xb, rb + a_off + 16 * kk);
#pragma unroll
    for (int j = 0; j < BT / 8; j += 2) {
      uint32_t ya[4], yb[4];
      ldmatrix_x4(ya, ca + b_off + 8 * j * STR + 16 * kk);
      ldmatrix_x4(yb, cb + b_off + 8 * j * STR + 16 * kk);
      mma_bf16(s[j], xa, ya[0], ya[1]);
      mma_bf16(s[j + 1], xa, ya[2], ya[3]);
      mma_bf16(t[j], xb, yb[0], yb[1]);
      mma_bf16(t[j + 1], xb, yb[2], yb[3]);
    }
  }
}

// acc += X Y with X (16 x BT) from this warp's accumulator tiles `x`
// (rounded to bf16) and Y the (BT, D) tile `y` in shared memory (B operand
// by ldmatrix.trans).
template <int D>
__device__ __forceinline__ void product_acc(const float (&x)[BT / 8][4],
                                            const __nv_bfloat16* y, int lane,
                                            float (&acc)[D / 8][4]) {
  constexpr int STR = D + 8;
  // .trans: lanes 8i .. 8i+7 address rows (i % 2) * 8 .., columns (i / 2) * 8
  const int off = ((lane % 8) + 8 * ((lane / 8) % 2)) * STR + 8 * (lane / 16);
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t yb[4];
      ldmatrix_x4_trans(yb, y + off + 16 * kk * STR + 8 * n);
      mma_bf16(acc[n], xa, yb[0], yb[1]);
      mma_bf16(acc[n + 1], xa, yb[2], yb[3]);
    }
  }
}

// Write this warp's (16, D) accumulator rows, times `mul`, as bf16 rows of
// a (rows, stride) matrix: row r0 + ... below n_rows, columns below hd.
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4],
                                          __nv_bfloat16* dst, int64_t stride,
                                          int r0, int n_rows, int hd,
                                          float mul, int warp, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 16 * warp + lane / 4 + 8 * half;
    if (r0 + r >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * (lane % 4);
      if (c < hd)
        *reinterpret_cast<uint32_t*>(dst + r * stride + c) = pack_bf16(
            acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dkdv_mma(const Args a) {
  constexpr int STR = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BT * STR;
  __nv_bfloat16* sQ = sV + BT * STR;
  __nv_bfloat16* sO = sQ + BT * STR;
  float* sL = reinterpret_cast<float*>(sO + BT * STR);
  float* sD = sL + BT;
  int* sP = reinterpret_cast<int*>(sD + BT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.z, kvh = blockIdx.y, j0 = blockIdx.x * BT;
  const int G = a.H / a.KV;
  const int64_t krow = (int64_t)a.KV * a.hd;
  const auto* K = static_cast<const __nv_bfloat16*>(a.k);
  const auto* V = static_cast<const __nv_bfloat16*>(a.v);
  const auto* Q = static_cast<const __nv_bfloat16*>(a.q);
  const auto* O = static_cast<const __nv_bfloat16*>(a.dout);
  const int64_t kbase = ((int64_t)b * a.Sk + j0) * krow + (int64_t)kvh * a.hd;
  stage_bf16<D>(sK, K + kbase, krow, a.Sk - j0, a.hd);
  stage_bf16<D>(sV, V + kbase, krow, a.Sk - j0, a.hd);
  int kmin, kmax;
  pos_range<BT>(a.kv_pos + (int64_t)b * a.Sk, j0, a.Sk, lane, kmin, kmax);
  // positions of this thread's two key rows
  int kp[2];
#pragma unroll
  for (int half = 0; half < 2; ++half)
    kp[half] = kv_pos_at(a, b, j0 + 16 * warp + lane / 4 + 8 * half);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int64_t qrow = (int64_t)a.H * a.hd;
  const int* qpos = a.q_pos + (int64_t)b * a.Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse = a.lse + ((int64_t)b * a.H + h) * a.Sq;
    const float* delta = a.delta + ((int64_t)b * a.H + h) * a.Sq;
    for (int i0 = 0; i0 < a.Sq; i0 += BT) {
      int qmin, qmax;
      pos_range<BT>(qpos, i0, a.Sq, lane, qmin, qmax);
      if (!visible(a, kmin, kmax, qmin, qmax)) continue;
      __syncthreads();  // the last tile's reads are done
      const int64_t qbase = ((int64_t)b * a.Sq + i0) * qrow + (int64_t)h * a.hd;
      stage_bf16<D>(sQ, Q + qbase, qrow, a.Sq - i0, a.hd);
      stage_bf16<D>(sO, O + qbase, qrow, a.Sq - i0, a.hd);
      for (int r = threadIdx.x; r < BT; r += THREADS) {
        const bool valid = i0 + r < a.Sq;
        sL[r] = valid ? lse[i0 + r] : 0.f;
        sD[r] = valid ? delta[i0 + r] : 0.f;
        sP[r] = valid ? qpos[i0 + r] : 0;
      }
      __syncthreads();
      float st[BT / 8][4], dpt[BT / 8][4];
      two_products<D>(sK, sQ, sV, sO, warp, lane, st, dpt);
      // P^T and dS^T (keys are rows, queries columns)
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + acc_col(lane, e);
          const bool ok = i0 + qc < a.Sq && keep(a, sP[qc], kp[e / 2]);
          float dsm;
          const float p = prob(a, st[j][e], sL[qc], ok, dsm, true);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - sD[qc]) * dsm;
        }
      product_acc<D>(st, sO, lane, dv);
      product_acc<D>(dpt, sQ, lane, dk);
    }
  }
  auto* dK = static_cast<__nv_bfloat16*>(a.dk) + kbase;
  auto* dV = static_cast<__nv_bfloat16*>(a.dv) + kbase;
  store_acc<D>(dk, dK, krow, j0, a.Sk, a.hd, a.scale, warp, lane);
  store_acc<D>(dv, dV, krow, j0, a.Sk, a.hd, 1.f, warp, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS) bwd_dq_mma(const Args a) {
  constexpr int STR = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sO = sQ + BT * STR;
  __nv_bfloat16* sK = sO + BT * STR;
  __nv_bfloat16* sV = sK + BT * STR;
  int* sP = reinterpret_cast<int*>(sV + BT * STR);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_qt = (a.Sq + BT - 1) / BT;
  // the longest causal walks (the last query tiles) start first
  const int b = blockIdx.z, h = blockIdx.y,
            i0 = (n_qt - 1 - (int)blockIdx.x) * BT;
  const int kvh = h / (a.H / a.KV);
  const int64_t qrow = (int64_t)a.H * a.hd, krow = (int64_t)a.KV * a.hd;
  const int64_t qbase = ((int64_t)b * a.Sq + i0) * qrow + (int64_t)h * a.hd;
  stage_bf16<D>(sQ, static_cast<const __nv_bfloat16*>(a.q) + qbase, qrow,
                a.Sq - i0, a.hd);
  stage_bf16<D>(sO, static_cast<const __nv_bfloat16*>(a.dout) + qbase, qrow,
                a.Sq - i0, a.hd);
  const int* qpos = a.q_pos + (int64_t)b * a.Sq;
  const int* kpos = a.kv_pos + (int64_t)b * a.Sk;
  int qmin, qmax;
  pos_range<BT>(qpos, i0, a.Sq, lane, qmin, qmax);
  // this thread's two query rows
  bool valid[2];
  int qp[2];
  float lse[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = i0 + 16 * warp + lane / 4 + 8 * half;
    valid[half] = r < a.Sq;
    const int64_t at = ((int64_t)b * a.H + h) * a.Sq + r;
    qp[half] = valid[half] ? qpos[r] : 0;
    lse[half] = valid[half] ? a.lse[at] : 0.f;
    delta[half] = valid[half] ? a.delta[at] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const auto* K = static_cast<const __nv_bfloat16*>(a.k);
  const auto* V = static_cast<const __nv_bfloat16*>(a.v);
  for (int j0 = 0; j0 < a.Sk; j0 += BT) {
    int kmin, kmax;
    pos_range<BT>(kpos, j0, a.Sk, lane, kmin, kmax);
    if (!visible(a, kmin, kmax, qmin, qmax)) continue;
    __syncthreads();
    const int64_t kbase = ((int64_t)b * a.Sk + j0) * krow + (int64_t)kvh * a.hd;
    stage_bf16<D>(sK, K + kbase, krow, a.Sk - j0, a.hd);
    stage_bf16<D>(sV, V + kbase, krow, a.Sk - j0, a.hd);
    for (int r = threadIdx.x; r < BT; r += THREADS)
      sP[r] = kv_pos_at(a, b, j0 + r);
    __syncthreads();
    float s[BT / 8][4], dp[BT / 8][4];
    two_products<D>(sQ, sK, sO, sV, warp, lane, s, dp);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + acc_col(lane, e), half = e / 2;
        const bool ok = valid[half] && keep(a, qp[half], sP[kc]);
        float dsm;
        const float p = prob(a, s[j][e], lse[half], ok, dsm, true);
        dp[j][e] = p * (dp[j][e] - delta[half]) * dsm;
      }
    product_acc<D>(dp, sK, lane, dq);
  }
  store_acc<D>(dq, static_cast<__nv_bfloat16*>(a.dq) + qbase, qrow, i0, a.Sq,
               a.hd, a.scale, warp, lane);
}

// ---------------------------------------------------------------------------
// bf16 at D = 64, 80, 128: one pass on wgmma
// ---------------------------------------------------------------------------
// A 64-row tile of D bf16 columns lies in shared memory as the forward's
// swizzled regions (flash_attention.cu, sw_offset): columns 0..63 in
// 128-byte rows (8-row groups of 1024 B, the 16-byte chunks of row r
// XOR-ed with r % 8: wgmma's 128B swizzle); D = 80: columns 64..79 in
// 32-byte rows (8-row groups of 256 B, chunk ^ (r % 8) / 4: the 32B
// swizzle); D = 128: columns 64..127 a second 128B region.  K, V, Q and dO
// are all stored so: K-major operands of S^T = K Q^T and dP^T = V dO^T
// (hd is the reduction), and the MN-major B operands of dV, dK (dO, Q:
// the reduction runs over their rows) and of dQ (K).
template <int D>
__device__ __forceinline__ int sw(int r, int c) {
  if (D == 80 && c >= 64)
    return BT * 128 + (r / 8) * 256 + (r % 8) * 32 +
           (((c - 64) / 8) ^ ((r % 8) >> 2)) * 16 + (c % 8) * 2;
  return (c / 64) * BT * 128 + (r / 8) * 1024 + (r % 8) * 128 +
         (((c % 64) / 8) ^ (r % 8)) * 16 + (c % 8) * 2;
}

constexpr int SW128 = 1, SW32 = 3;   // descriptor layout types

// Shared-memory matrix descriptor: start address, leading- and
// stride-dimension byte offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, int lbo, int sbo,
                                              int mode) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)mode << 62;
}

// The descriptors of a tile's 128B- and 32B-swizzled layouts at its start;
// an operand at byte offset o adds o / 16.  Built in the loop each step
// (the address passes through an empty asm), so the compiler does not
// keep every k-step's descriptor of every tile in registers.
struct TileDesc {
  uint64_t w, n;
};
__device__ __forceinline__ TileDesc tile_desc(const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("" : "+r"(addr));
  return {gmma_desc(addr, 16, 1024, SW128), gmma_desc(addr, 16, 256, SW32)};
}
constexpr int HI = BT * 128 / 16;   // the columns 64.. region, in 16 B

// K-major descriptor of k16 step kk (hd columns 16 kk ..) of a tile.
template <int D>
__device__ __forceinline__ uint64_t kmajor(const TileDesc& t, int kk) {
  if (D == 80 && kk == 4) return t.n + HI;
  return t.w + (kk / 4) * HI + 2 * (kk % 4);
}

// MN-major descriptors of k16 step kk (rows 16 kk ..) of a tile: columns
// 0..63, then 64..79 (D = 80) or 64..127 (D = 128).
__device__ __forceinline__ uint64_t mn_lo(const TileDesc& t, int kk) {
  return t.w + 128 * kk;
}
template <int D>
__device__ __forceinline__ uint64_t mn_hi(const TileDesc& t, int kk) {
  return D == 80 ? t.n + HI + 32 * kk : t.w + HI + 128 * kk;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an in-flight wgmma writes: after its wait, their values are
// redefined here, so the compiler reads them no earlier.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[j][e])::"memory");
}

// generic-proxy writes to shared memory -> visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define ACC64(d)                                                            \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),           \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),           \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),           \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),           \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define ACC16(d)                                                            \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),               \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
#define REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define REGS8 "{%0, %1, %2, %3, %4, %5, %6, %7}"

// d (64 x 64) (+)= A B^T, A and B K-major in shared memory (scale_d = 0
// starts the sum): S^T and dP^T.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N) += A B, A from registers (the mma.sync A-fragment layout), B
// MN-major in shared memory: dV and dK.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&x)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC64(d)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[2][4],
                                         const uint32_t (&x)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " REGS8
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC16(d)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "l"(db), "r"(1));
}

// d (64 x N) (+)= A B, A and B MN-major in shared memory: dQ.
__device__ __forceinline__ void wgmma_tt(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tt(float (&d)[2][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 " REGS8
      ", %8, %9, p, 1, 1, 1, 1;\n}\n"
      : ACC16(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// acc (64 x D) += X Y for k16 step kk of the tile Y (MN-major B), X the
// register A fragment: columns 0..63, then the rest.
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 8][4],
                                           const uint32_t (&x)[4],
                                           const TileDesc& y, int kk) {
  wgmma_rs(reinterpret_cast<float(&)[8][4]>(acc[0]), x, mn_lo(y, kk));
  if constexpr (D == 80)
    wgmma_rs(reinterpret_cast<float(&)[2][4]>(acc[8]), x, mn_hi<D>(y, kk));
  if constexpr (D == 128)
    wgmma_rs(reinterpret_cast<float(&)[8][4]>(acc[8]), x, mn_hi<D>(y, kk));
}

// acc (64 x D) (+)= X Y for k16 step kk of the tiles X (MN-major A, 64
// columns) and Y (MN-major B).
template <int D>
__device__ __forceinline__ void product_tt(float (&acc)[D / 8][4],
                                           const TileDesc& x,
                                           const TileDesc& y, int kk,
                                           int scale_d) {
  const uint64_t da = mn_lo(x, kk);
  wgmma_tt(reinterpret_cast<float(&)[8][4]>(acc[0]), da, mn_lo(y, kk),
           scale_d);
  if constexpr (D == 80)
    wgmma_tt(reinterpret_cast<float(&)[2][4]>(acc[8]), da, mn_hi<D>(y, kk),
             scale_d);
  if constexpr (D == 128)
    wgmma_tt(reinterpret_cast<float(&)[8][4]>(acc[8]), da, mn_hi<D>(y, kk),
             scale_d);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// named barriers: `n` threads (a multiple of 32) arrive; sync also waits
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = 1 - 2 / (e^(2x) + 1) with ex2 and rcp: within ~2e-7 of tanhf
// absolutely (saturating to +-1 at large |x|), a few instructions and
// registers against tanhf's long branchy sequence
__device__ __forceinline__ float tanh_fast(float x) {
  float r;
  const float d = ex2(x * (2.f * LOG2E)) + 1.f;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(-2.f, r, 1.f);
}

// Consumer warpgroups (64 keys each) of a D instance; hd 128 keeps one,
// so its dK, dV, S^T and dP^T fit the registers.
__host__ __device__ constexpr int wg_count(int D) { return D == 128 ? 1 : 2; }

// bwd_wg's warps: NWG consumer warpgroups, then one warpgroup of a copy
// warp and NBUF dq writer warps.  With two consumer warpgroups (12
// warps, 3 a scheduler: 168 registers a thread at launch) setmaxnreg
// moves registers to the consumers: 2 * 208 + 88 = 3 * 168.
// Shared memory, byte offsets (every tile 1024-B aligned): K tiles, V
// tiles (one per consumer warpgroup), the ring (per stage Q, dO, then 64
// floats of lse * log2(e), 64 of delta, 64 positions), dS^T per
// warpgroup and step % 3, NBUF float32 64 x D dQ partials, the item's
// key positions, the work item.
template <int D>
struct WgLayout {
  static constexpr int NWG = wg_count(D);
  static constexpr int NC = 128 * NWG;            // consumer threads
  static constexpr int NBUF = 3;                  // dQ partials, writers
  static constexpr int NT = NC + 128;
  static constexpr int BN = 64 * NWG;             // keys of a work item
  static constexpr int REGS_C = 208, REGS_P = 88; // setmaxnreg (NWG = 2)
  static constexpr int TILE = BT * D * 2;
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int STAGE = 2 * TILE + 1024;
  static constexpr int RING = 2 * NWG * TILE;
  static constexpr int DS = RING + STAGES * STAGE;
  static constexpr int PART = DS + 3 * NWG * BT * BT * 2;
  static constexpr int KPOS = PART + NBUF * BT * D * 4;
  static constexpr int ITEM = KPOS + 4 * BN;
  static constexpr int BYTES = ITEM + 16;
};

// named barrier ids of bwd_wg (0 is __syncthreads): dS^T of step u
// stored (u % 3); dQ partial b full / empty (b < NBUF); ring stage s full
// / empty
constexpr int BAR_DS = 1, BAR_FULL = 4, BAR_EMPTY = 7, BAR_RFULL = 10,
              BAR_REMPTY = 13;

// The largest visible query tile index <= i (or -1), by one warp: every
// warp that asks gets the same answer.
__device__ __forceinline__ int next_tile(const Args& a, const int2* qr,
                                         int2 kr, int i, int lane) {
  for (; i >= 0; i -= 32) {
    bool v = false;
    if (i - lane >= 0) {
      const int2 r = qr[i - lane];
      v = visible(a, kr.x, kr.y, r.x, r.y);
    }
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (m) return i - (__ffs(m) - 1);
  }
  return -1;
}

// The smallest and largest position of key tile t (BN keys; PAD_POS past
// Sk), by one warp.
__device__ __forceinline__ void key_range(const Args& a, int b, int t,
                                          int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int r = lane; r < a.bn; r += 32) {
    const int p = kv_pos_at(a, b, t * a.bn + r);
    lo = min(lo, p);
    hi = max(hi, p);
  }
  warp_minmax(lo, hi);
}

// Warps of 32 (b, token, head) rows of the padded query tiles, then one
// warp per (b, query tile), one per (b, key tile).
__global__ void __launch_bounds__(THREADS) bwd_prep(const Args a) {
  const int lane = threadIdx.x % 32;
  int64_t wid = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.ticket = 0;
  // delta and lse2: one thread per (b, token, head) row, 16-byte loads
  const int64_t rows = (int64_t)a.B * a.sq_pad * a.H;
  const int64_t row_warps = (rows + 31) / 32;
  if (wid < row_warps) {
    const int64_t row = wid * 32 + lane;
    if (row < rows) {
      const int64_t per_b = (int64_t)a.sq_pad * a.H;
      const int b = (int)(row / per_b);
      const int tok = (int)(row % per_b / a.H), h = (int)(row % a.H);
      float s = 0.f, l = 0.f;
      if (tok < a.Sq) {
        const int64_t at = (((int64_t)b * a.Sq + tok) * a.H + h) * a.hd;
        const auto* o = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(a.out) + at);
        const auto* d = reinterpret_cast<const uint4*>(
            static_cast<const __nv_bfloat16*>(a.dout) + at);
#pragma unroll 4
        for (int u = 0; u < a.hd / 8; ++u) {
          const uint4 x = o[u], y = d[u];
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
          const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 xo =
                *reinterpret_cast<const __nv_bfloat162*>(&xs[e]);
            const __nv_bfloat162 yd =
                *reinterpret_cast<const __nv_bfloat162*>(&ys[e]);
            s += prod(xo.x, yd.x);
            s += prod(xo.y, yd.y);
          }
        }
        l = a.lse[((int64_t)b * a.H + h) * a.Sq + tok] * LOG2E;
      }
      const int64_t at = ((int64_t)b * a.H + h) * a.sq_pad + tok;
      a.delta2[at] = s;
      a.lse2[at] = l;
    }
    return;
  }
  wid -= row_warps;
  if (wid < (int64_t)a.B * a.n_qt) {
    const int b = (int)(wid / a.n_qt), i = (int)(wid % a.n_qt);
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < BT; r += 32) {
      const int tok = i * BT + r;
      const int p = tok < a.Sq ? a.q_pos[(int64_t)b * a.Sq + tok] : QPAD_POS;
      a.qpos2[(int64_t)b * a.sq_pad + tok] = p;
      if (tok < a.Sq) {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
    warp_minmax(lo, hi);
    int seen = 0;
    for (int t = 0; t < a.n_kt; ++t) {
      int klo, khi;
      key_range(a, b, t, lane, klo, khi);
      seen += visible(a, klo, khi, lo, hi);
    }
    const int64_t at = (int64_t)b * a.n_qt + i;
    if (lane == 0) {
      a.qrange[at] = make_int2(lo, hi);
      a.ntot[at] = seen;
    }
    for (int h = lane; h < a.H; h += 32)
      a.counters[((int64_t)b * a.H + h) * a.n_qt + i] = 0;
    if (seen == 0) {   // no key tile adds to these rows: dq = 0 here
      const int toks = min(BT, a.Sq - i * BT);
      uint4* dst = reinterpret_cast<uint4*>(
          static_cast<__nv_bfloat16*>(a.dq) +
          ((int64_t)b * a.Sq + i * BT) * a.H * a.hd);
      const int64_t units = (int64_t)toks * a.H * a.hd / 8;
      for (int64_t u = lane; u < units; u += 32)
        dst[u] = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  wid -= (int64_t)a.B * a.n_qt;
  if (wid < (int64_t)a.B * a.n_kt) {
    const int b = (int)(wid / a.n_kt), t = (int)(wid % a.n_kt);
    int lo, hi;
    key_range(a, b, t, lane, lo, hi);
    if (lane == 0) a.krange[wid] = make_int2(lo, hi);
  }
}

template <int D>
__global__ void __launch_bounds__(WgLayout<D>::NT, 1) bwd_wg(const Args a) {
  using L = WgLayout<D>;
  constexpr int NWG = L::NWG, NC = L::NC, BN = L::BN;
  constexpr int STAGES = L::STAGES, NBUF = L::NBUF;
  constexpr int KS = D / 16;                 // k16 steps over hd
  constexpr int UPR = D / 8;                 // 16-byte units of a tile row
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int* s_item = reinterpret_cast<int*>(smem + L::ITEM);
  if (tid == 0) *s_item = atomicAdd(a.ticket, 1);
  __syncthreads();
  // key tiles ascending (the longest causal walks first), (b, kv head)
  // inner
  const int item = *s_item, pairs = a.B * a.KV;
  const int jt = item / pairs, b = item % pairs / a.KV, kvh = item % a.KV;
  const int G = a.H / a.KV;
  const int2 kr = a.krange[(int64_t)b * a.n_kt + jt];
  const int2* qr = a.qrange + (int64_t)b * a.n_qt;
  int n_vis = 0;
  for (int c = 0; c < a.n_qt; c += 32) {
    bool v = false;
    if (c + lane < a.n_qt) {
      const int2 r = qr[c + lane];
      v = visible(a, kr.x, kr.y, r.x, r.y);
    }
    n_vis += __popc(__ballot_sync(0xffffffffu, v));
  }
  // step u: the (u / G)-th visible query tile from the last, head u % G
  const int n_steps = n_vis * G;
  const int j0 = jt * BN;
  const int64_t krow = (int64_t)a.KV * a.hd, qrow = (int64_t)a.H * a.hd;
  float* part = reinterpret_cast<float*>(smem + L::PART);
  auto tileK = [&](int x) { return smem + x * L::TILE; };
  auto tileV = [&](int x) { return smem + (NWG + x) * L::TILE; };
  auto tileDS = [&](int x, int u) {
    return smem + L::DS + (3 * x + u % 3) * BT * BT * 2;
  };
  auto stage = [&](int u) {
    return smem + L::RING + (u % STAGES) * L::STAGE;
  };

  if (warp >= 4 * NWG) {
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::REGS_P));
    const int role = warp - 4 * NWG;
    if (role == 0 && n_steps > 0) {
      // ---- the copy warp: K and V once, then the ring (cp.async, each
      // lane waits on its own groups, then the stage's full barrier).
      // Lane (roff, cu) copies the 16-byte column unit cu of rows roff,
      // roff + RPI, ... ----
      const auto* K = static_cast<const __nv_bfloat16*>(a.k);
      const auto* V = static_cast<const __nv_bfloat16*>(a.v);
      const auto* Q = static_cast<const __nv_bfloat16*>(a.q);
      const auto* O = static_cast<const __nv_bfloat16*>(a.dout);
      constexpr int RPI = 32 / UPR;            // rows a pass
      const int cu = lane % UPR, roff = lane / UPR, c = 8 * cu;
      const bool on = roff < RPI, col_ok = c < a.hd;
      // sw<D>(r, c) of this lane's c: so0 + (r / 8) grp + (r % 8) rowb +
      // 16 (cl ^ ((r % 8) >> sh))
      const bool hi = c >= 64;
      const int so0 = hi ? BT * 128 : 0, cl = hi ? cu - 8 : cu;
      const int grp = D == 80 && hi ? 256 : 1024;
      const int rowb = D == 80 && hi ? 32 : 128, sh = D == 80 && hi ? 2 : 0;
      auto so_of = [&](int r) {
        return so0 + (r >> 3) * grp + (r & 7) * rowb +
               ((cl ^ ((r & 7) >> sh)) << 4);
      };
      const int64_t k0 = ((int64_t)b * a.Sk + j0 + roff) * krow +
                         (int64_t)kvh * a.hd + c;
      const auto* k_at = K + k0;
      const auto* v_at = V + k0;
      for (int r = lane; r < BN; r += 32)
        reinterpret_cast<int*>(smem + L::KPOS)[r] = kv_pos_at(a, b, j0 + r);
      for (int r = roff; on && r < BN;
           r += RPI, k_at += RPI * krow, v_at += RPI * krow) {
        const bool ok = col_ok && j0 + r < a.Sk;
        const int so = (r / 64) * L::TILE + so_of(r % 64);
        cp_async16(tileK(0) + so, ok ? k_at : K, ok ? 16 : 0);
        cp_async16(tileV(0) + so, ok ? v_at : V, ok ? 16 : 0);
      }
      int i_in = next_tile(a, qr, kr, a.n_qt - 1, lane), g_in = 0;
      for (int s = 0; s < n_steps; ++s) {
        if (s >= STAGES) bar_sync(BAR_REMPTY + s % STAGES, NC + 32);
        unsigned char* st = stage(s);
        const int h = kvh * G + g_in, i0 = i_in * BT;
        const int64_t base =
            ((int64_t)b * a.Sq + i0) * qrow + (int64_t)h * a.hd;
        const int64_t q0 = base + roff * qrow + c;
        const auto* q_at = Q + q0;
        const auto* o_at = O + q0;
        const int rows = min(BT, a.Sq - i0);
        for (int r = roff; on && r < BT;
             r += RPI, q_at += RPI * qrow, o_at += RPI * qrow) {
          const bool ok = col_ok && r < rows;
          const int so = so_of(r);
          cp_async16(st + so, ok ? q_at : Q, ok ? 16 : 0);
          cp_async16(st + L::TILE + so, ok ? o_at : O, ok ? 16 : 0);
        }
        for (int x = lane; x < 48; x += 32) {
          const int m = x / 16, e = 4 * (x % 16);
          const int64_t row = ((int64_t)b * a.H + h) * a.sq_pad + i0 + e;
          const void* src =
              m == 0 ? static_cast<const void*>(a.lse2 + row)
              : m == 1 ? static_cast<const void*>(a.delta2 + row)
                       : static_cast<const void*>(
                             a.qpos2 + (int64_t)b * a.sq_pad + i0 + e);
          cp_async16(st + 2 * L::TILE + 256 * m + 4 * e, src, 16);
        }
        cp_async_commit();
        if (s > 0) {   // the stage before this one has landed
          cp_async_wait<1>();
          fence_async_smem();
          bar_arrive(BAR_RFULL + (s - 1) % STAGES, NC + 32);
        }
        if (++g_in == G) {
          g_in = 0;
          i_in = next_tile(a, qr, kr, i_in - 1, lane);
        }
      }
      cp_async_wait<0>();
      fence_async_smem();
      bar_arrive(BAR_RFULL + (n_steps - 1) % STAGES, NC + 32);
    } else if (role > 0) {
      // ---- dq writer wr: the steps u = wr (mod NBUF), ordered adds into
      // dq_acc ----
      const int wr = role - 1;
      constexpr int PL = BT * D / 4 / 32;     // float4 per lane of a partial
      constexpr int CH = 8;                   // float4 per lane in flight
      const float4* src =
          reinterpret_cast<const float4*>(part + wr * BT * D);
      int i = a.n_qt, g = G - 1, at_i = -1, rank = 0;
      bool last = false;
      for (int u = 0; u < n_steps; ++u) {
        if (++g == G) {
          g = 0;
          i = next_tile(a, qr, kr, i - 1, lane);
        }
        if (u % NBUF != wr) continue;
        if (i != at_i) {   // how many key tiles add to tile i first
          at_i = i;
          const int2 r = qr[i];
          rank = 0;
          for (int c = 0; c < jt; c += 32) {
            bool v = false;
            if (c + lane < jt) {
              const int2 k2 = a.krange[(int64_t)b * a.n_kt + c + lane];
              v = visible(a, k2.x, k2.y, r.x, r.y);
            }
            rank += __popc(__ballot_sync(0xffffffffu, v));
          }
          last = rank + 1 == a.ntot[(int64_t)b * a.n_qt + i];
        }
        const int h = kvh * G + g;
        int* ctr = a.counters + ((int64_t)b * a.H + h) * a.n_qt + i;
        // (a count that never comes, seconds of polls, traps: no hang)
        for (int polls = 0; rank > 0 && ld_acquire(ctr) != rank; ++polls) {
          if (polls == 1 << 26) __trap();
          __nanosleep(64);
        }
        bar_sync(BAR_FULL + wr, 128 + 32);
        float4* acc = reinterpret_cast<float4*>(
            a.dq_acc + (((int64_t)b * a.H + h) * a.sq_pad + i * BT) * D);
        if (!last) {   // the partial and the sum are both 64 x D floats
#pragma unroll 1
          for (int c0 = 0; c0 < PL; c0 += CH) {
            float4 x[CH];
#pragma unroll
            for (int k = 0; k < CH; ++k)
              x[k] = rank > 0 ? __ldcg(acc + lane + 32 * (c0 + k))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int k = 0; k < CH; ++k) {
              const int f = lane + 32 * (c0 + k);
              const float4 p = src[f];
              x[k].x += p.x;
              x[k].y += p.y;
              x[k].z += p.z;
              x[k].w += p.w;
              __stcg(acc + f, x[k]);
            }
          }
        } else {   // the last adder: dq = bf16(sum * scale)
          auto* dq = static_cast<__nv_bfloat16*>(a.dq) +
                     (((int64_t)b * a.Sq + i * BT) * a.H + h) * a.hd;
#pragma unroll 1
          for (int f = lane; f < BT * D / 4; f += 32) {
            const int row = f / (D / 4), col = 4 * (f % (D / 4));
            if (i * BT + row >= a.Sq || col >= a.hd) continue;
            float4 x = rank > 0 ? __ldcg(acc + f)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            const float4 p = src[f];
            x.x += p.x;
            x.y += p.y;
            x.z += p.z;
            x.w += p.w;
            *reinterpret_cast<uint2*>(dq + (int64_t)row * qrow + col) =
                make_uint2(pack_bf16(x.x * a.scale, x.y * a.scale),
                           pack_bf16(x.z * a.scale, x.w * a.scale));
          }
        }
        if (u + NBUF < n_steps) bar_arrive(BAR_EMPTY + wr, 128 + 32);
        if (!last) {   // publish: every lane's stores, then the count
          __threadfence();
          __syncwarp();
          if (lane == 0) st_release(ctr, rank + 1);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  if constexpr (NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::REGS_C));
  const int wg = warp / 4, w = warp % 4, g8 = lane / 4, t4 = lane % 4;
  // this thread's key rows 16 w + g8 (+ 8) of its warpgroup's 64, and
  // their positions (written by the copy warp before the first stage)
  const int* sKP = reinterpret_cast<const int*>(smem + L::KPOS) + 64 * wg +
                   16 * w + g8;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  int i_c = next_tile(a, qr, kr, a.n_qt - 1, lane), g_c = 0;
  for (int u = 0; u < n_steps; ++u) {
    bar_sync(BAR_RFULL + u % STAGES, NC + 32);   // step u has landed
    const unsigned char* sQ = stage(u);
    const unsigned char* sO = sQ + L::TILE;
    const float* sL = reinterpret_cast<const float*>(sQ + 2 * L::TILE);
    const int* sP = reinterpret_cast<const int*>(sL + 2 * BT);

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries
    float s[8][4], dp[8][4];
    const TileDesc tq = tile_desc(sQ), to = tile_desc(sO);
    {
      const TileDesc tk = tile_desc(tileK(wg)), tv = tile_desc(tileV(wg));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(s, kmajor<D>(tk, kk), kmajor<D>(tq, kk), kk);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss(dp, kmajor<D>(tv, kk), kmajor<D>(to, kk), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    pin(s);
    pin(dp);

    // P^T and dS^T (keys are rows, queries columns): the scores, then
    // the mask where the tile pair needs one
    if (a.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(sL + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(sL + BT + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float th = tanh_fast(s[j][e] * a.to_t);
          const float p = ex2(fmaf(th, a.cap2, -(e & 1 ? l2.y : l2.x)));
          s[j][e] = p;
          dp[j][e] =
              p * (dp[j][e] - (e & 1 ? d2.y : d2.x)) * (1.f - th * th);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = 8 * j + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(sL + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(sL + BT + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              ex2(fmaf(s[j][e], a.scale2, -(e & 1 ? l2.y : l2.x)));
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - (e & 1 ? d2.y : d2.x));
        }
      }
    }
    const int2 q2 = qr[i_c];
    if (!all_visible(a, kr.x, kr.y, q2.x, q2.y) || (i_c + 1) * BT > a.Sq) {
      const int kp[2] = {sKP[0], sKP[8]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 p2 = *reinterpret_cast<const int2*>(sP + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = e & 1 ? p2.y : p2.x, kq = kp[e / 2];
          const bool ok =
              (qp >= kq) & ((a.window <= 0) | (qp - kq < a.window));
          s[j][e] = ok ? s[j][e] : 0.f;
          dp[j][e] = ok ? dp[j][e] : 0.f;
        }
      }
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dV += P^T dO, dK += dS^T Q
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) product_rs<D>(dv, pa[kk], to, kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) product_rs<D>(dk, da[kk], tq, kk);
    wgmma_commit();
    // dS^T to shared memory, rows = keys, 128B-swizzled: element (16 w +
    // g8 + 8 (x % 2), 16 kk + 8 (x / 2) + 2 t4) of fragment da[kk][x]
    unsigned char* sD = tileDS(wg, u);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = 16 * w + g8 + 8 * (x & 1), j = 2 * kk + x / 2;
        *reinterpret_cast<uint32_t*>(sD + (r / 8) * 1024 + g8 * 128 +
                                     ((j ^ g8) * 16) + 4 * t4) = da[kk][x];
      }
    fence_async_smem();
    // the last warpgroup computes dQ_part; the first runs up to two
    // steps ahead (the ring's bound), so dS^T and its barrier have three
    // copies
    const bool mine = wg == NWG - 1;
    if (mine)
      bar_sync(BAR_DS + u % 3, NC);
    else
      bar_arrive(BAR_DS + u % 3, NC);
    if (mine) {
      // dQ_part (64 queries x D) = dS K over the item's BN keys
      float dq[D / 8][4];
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
      wgmma_wait_all();   // dV, dK done: the A fragments die first
      pin(dv);
      pin(dk);
      TileDesc tds[NWG], tk[NWG];
#pragma unroll
      for (int x = 0; x < NWG; ++x) {
        tds[x] = tile_desc(tileDS(x, u));
        tk[x] = tile_desc(tileK(x));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        product_tt<D>(dq, tds[kk / 4], tk[kk / 4], kk % 4, kk);
      wgmma_commit();
      wgmma_wait_all();
      pin(dv);
      pin(dk);
      pin(dq);
      if (u + STAGES < n_steps)
        bar_arrive(BAR_REMPTY + u % STAGES, NC + 32);
      const int pb = u % NBUF;
      if (u >= NBUF) bar_sync(BAR_EMPTY + pb, 128 + 32);
      float* dst = part + pb * BT * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(
              dst + (16 * w + g8 + 8 * hr) * D + 8 * n + 2 * t4) =
              make_float2(dq[n][2 * hr], dq[n][2 * hr + 1]);
      bar_arrive(BAR_FULL + pb, 128 + 32);
    } else {
      wgmma_wait_all();
      pin(dv);
      pin(dk);
      if (u + STAGES < n_steps)
        bar_arrive(BAR_REMPTY + u % STAGES, NC + 32);
    }
    if (++g_c == G) {
      g_c = 0;
      i_c = next_tile(a, qr, kr, i_c - 1, lane);
    }
  }
  // dK (times scale) and dV of this thread's rows; the item and the rows
  // are read again rather than kept in registers through the walk
  int t2 = threadIdx.x;
  asm volatile("" : "+r"(t2));
  const int item2 = *reinterpret_cast<volatile int*>(smem + L::ITEM);
  const int b2 = item2 % pairs / a.KV, kvh2 = item2 % a.KV;
  const int key0 = (item2 / pairs) * BN + 64 * (t2 / 128) +
                   16 * (t2 / 32 % 4) + t2 % 32 / 4;
  auto* dK = static_cast<__nv_bfloat16*>(a.dk);
  auto* dV = static_cast<__nv_bfloat16*>(a.dv);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key0 + 8 * hr;
    if (key >= a.Sk) continue;
    const int64_t at =
        ((int64_t)b2 * a.Sk + key) * krow + (int64_t)kvh2 * a.hd;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = 8 * n + 2 * t4;
      if (c < a.hd) {
        *reinterpret_cast<uint32_t*>(dK + at + c) =
            pack_bf16(dk[n][2 * hr] * a.scale, dk[n][2 * hr + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dV + at + c) =
            pack_bf16(dv[n][2 * hr], dv[n][2 * hr + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, 32-row tiles, 256 threads
// ---------------------------------------------------------------------------
// Rows [0, BF) of a (rows, stride) float32 matrix into shared memory with
// row stride D + 1 (odd: column reads of 8 rows hit 8 banks); zero past
// n_rows and hd.
template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          int64_t stride, int n_rows, int hd) {
  constexpr int S = D + 1;
  constexpr int UPR = D / 4;
  for (int u = threadIdx.x; u < BF * UPR; u += F32_THREADS) {
    const int r = u / UPR, c = (u % UPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && c < hd)
      x = *reinterpret_cast<const float4*>(src + r * stride + c);
    dst[r * S + c] = x.x;
    dst[r * S + c + 1] = x.y;
    dst[r * S + c + 2] = x.z;
    dst[r * S + c + 3] = x.w;
  }
}

template <int D>
constexpr int f32_smem_bytes() {
  return (4 * BF * (D + 1) + 2 * BF * (BF + 1) + 3 * BF) * 4;
}

template <int D>
__device__ __forceinline__ float dot_row(const float* x, const float* y) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) s += x[d] * y[d];
  return s;
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS) bwd_dkdv_f32(const Args a) {
  constexpr int S = D + 1, PS = BF + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BF * S;
  float* sQ = sV + BF * S;
  float* sO = sQ + BF * S;
  float* sPr = sO + BF * S;     // P^T (key, query)
  float* sDs = sPr + BF * PS;   // dS^T
  float* sL = sDs + BF * PS;
  float* sD = sL + BF;
  int* sP = reinterpret_cast<int*>(sD + BF);
  const int tid = threadIdx.x, lane = tid % 32;
  const int key = tid / 8, sub = tid % 8;
  const int b = blockIdx.z, kvh = blockIdx.y, j0 = blockIdx.x * BF;
  const int G = a.H / a.KV;
  const int64_t krow = (int64_t)a.KV * a.hd, qrow = (int64_t)a.H * a.hd;
  const int64_t kbase = ((int64_t)b * a.Sk + j0) * krow + (int64_t)kvh * a.hd;
  stage_f32<D>(sK, static_cast<const float*>(a.k) + kbase, krow, a.Sk - j0,
               a.hd);
  stage_f32<D>(sV, static_cast<const float*>(a.v) + kbase, krow, a.Sk - j0,
               a.hd);
  int kmin, kmax;
  pos_range<BF>(a.kv_pos + (int64_t)b * a.Sk, j0, a.Sk, lane, kmin, kmax);
  const int kp = kv_pos_at(a, b, j0 + key);
  float dk[D / 8], dv[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) dk[c] = dv[c] = 0.f;
  const int* qpos = a.q_pos + (int64_t)b * a.Sq;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse = a.lse + ((int64_t)b * a.H + h) * a.Sq;
    const float* delta = a.delta + ((int64_t)b * a.H + h) * a.Sq;
    for (int i0 = 0; i0 < a.Sq; i0 += BF) {
      int qmin, qmax;
      pos_range<BF>(qpos, i0, a.Sq, lane, qmin, qmax);
      if (!visible(a, kmin, kmax, qmin, qmax)) continue;
      __syncthreads();
      const int64_t qbase =
          ((int64_t)b * a.Sq + i0) * qrow + (int64_t)h * a.hd;
      stage_f32<D>(sQ, static_cast<const float*>(a.q) + qbase, qrow,
                   a.Sq - i0, a.hd);
      stage_f32<D>(sO, static_cast<const float*>(a.dout) + qbase, qrow,
                   a.Sq - i0, a.hd);
      for (int r = tid; r < BF; r += F32_THREADS) {
        const bool valid = i0 + r < a.Sq;
        sL[r] = valid ? lse[i0 + r] : 0.f;
        sD[r] = valid ? delta[i0 + r] : 0.f;
        sP[r] = valid ? qpos[i0 + r] : 0;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BF / 8; ++i) {
        const int qc = sub + 8 * i;
        const float raw = dot_row<D>(sK + key * S, sQ + qc * S);
        const float dp = dot_row<D>(sV + key * S, sO + qc * S);
        const bool ok = i0 + qc < a.Sq && keep(a, sP[qc], kp);
        float dsm;
        const float p = prob(a, raw, sL[qc], ok, dsm, false);
        sPr[key * PS + qc] = p;
        sDs[key * PS + qc] = p * (dp - sD[qc]) * dsm;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        const int d = sub + 8 * c;
        float av = 0.f, ak = 0.f;
#pragma unroll 8
        for (int qc = 0; qc < BF; ++qc) {
          av += sPr[key * PS + qc] * sO[qc * S + d];
          ak += sDs[key * PS + qc] * sQ[qc * S + d];
        }
        dv[c] += av;
        dk[c] += ak;
      }
    }
  }
  if (j0 + key < a.Sk) {
    float* dK = static_cast<float*>(a.dk) + kbase + key * krow;
    float* dV = static_cast<float*>(a.dv) + kbase + key * krow;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int d = sub + 8 * c;
      if (d < a.hd) {
        dK[d] = dk[c] * a.scale;
        dV[d] = dv[c];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS) bwd_dq_f32(const Args a) {
  constexpr int S = D + 1, PS = BF + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sO = sQ + BF * S;
  float* sK = sO + BF * S;
  float* sV = sK + BF * S;
  float* sDs = sV + BF * S;     // dS (query, key)
  int* sP = reinterpret_cast<int*>(sDs + 2 * BF * PS);
  const int tid = threadIdx.x, lane = tid % 32;
  const int row = tid / 8, sub = tid % 8;
  const int n_qt = (a.Sq + BF - 1) / BF;
  const int b = blockIdx.z, h = blockIdx.y,
            i0 = (n_qt - 1 - (int)blockIdx.x) * BF;
  const int kvh = h / (a.H / a.KV);
  const int64_t qrow = (int64_t)a.H * a.hd, krow = (int64_t)a.KV * a.hd;
  const int64_t qbase = ((int64_t)b * a.Sq + i0) * qrow + (int64_t)h * a.hd;
  stage_f32<D>(sQ, static_cast<const float*>(a.q) + qbase, qrow, a.Sq - i0,
               a.hd);
  stage_f32<D>(sO, static_cast<const float*>(a.dout) + qbase, qrow,
               a.Sq - i0, a.hd);
  const int* qpos = a.q_pos + (int64_t)b * a.Sq;
  const int* kpos = a.kv_pos + (int64_t)b * a.Sk;
  int qmin, qmax;
  pos_range<BF>(qpos, i0, a.Sq, lane, qmin, qmax);
  const bool valid = i0 + row < a.Sq;
  const int64_t at = ((int64_t)b * a.H + h) * a.Sq + i0 + row;
  const int qp = valid ? qpos[i0 + row] : 0;
  const float lse = valid ? a.lse[at] : 0.f;
  const float delta = valid ? a.delta[at] : 0.f;
  float dq[D / 8];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) dq[c] = 0.f;
  for (int j0 = 0; j0 < a.Sk; j0 += BF) {
    int kmin, kmax;
    pos_range<BF>(kpos, j0, a.Sk, lane, kmin, kmax);
    if (!visible(a, kmin, kmax, qmin, qmax)) continue;
    __syncthreads();
    const int64_t kbase =
        ((int64_t)b * a.Sk + j0) * krow + (int64_t)kvh * a.hd;
    stage_f32<D>(sK, static_cast<const float*>(a.k) + kbase, krow, a.Sk - j0,
                 a.hd);
    stage_f32<D>(sV, static_cast<const float*>(a.v) + kbase, krow, a.Sk - j0,
                 a.hd);
    for (int r = tid; r < BF; r += F32_THREADS) sP[r] = kv_pos_at(a, b, j0 + r);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BF / 8; ++i) {
      const int kc = sub + 8 * i;
      const float raw = dot_row<D>(sQ + row * S, sK + kc * S);
      const float dp = dot_row<D>(sO + row * S, sV + kc * S);
      const bool ok = valid && keep(a, qp, sP[kc]);
      float dsm;
      const float p = prob(a, raw, lse, ok, dsm, false);
      sDs[row * PS + kc] = p * (dp - delta) * dsm;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int d = sub + 8 * c;
      float acc = 0.f;
#pragma unroll 8
      for (int kc = 0; kc < BF; ++kc) acc += sDs[row * PS + kc] * sK[kc * S + d];
      dq[c] += acc;
    }
  }
  if (valid) {
    float* dQ = static_cast<float*>(a.dq) + qbase + row * qrow;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int d = sub + 8 * c;
      if (d < a.hd) dQ[d] = dq[c] * a.scale;
    }
  }
}
// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------
template <auto Kernel>
void allow_smem(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  const bool known = dev >= 0 && dev < 64;
  if (known && done[dev]) return;
  cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  if (known) done[dev] = true;
}

// bf16 at hd <= 32: dk/dv blocks, then dq blocks (after bwd_delta)
template <int D>
int launch_mma(const Args& a, cudaStream_t s) {
  constexpr int bytes = mma_smem_bytes<D>();
  allow_smem<bwd_dkdv_mma<D>>(bytes);
  allow_smem<bwd_dq_mma<D>>(bytes);
  bwd_dkdv_mma<D><<<dim3((a.Sk + BT - 1) / BT, a.KV, a.B), THREADS, bytes,
                    s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dq_mma<D><<<dim3((a.Sq + BT - 1) / BT, a.H, a.B), THREADS, bytes,
                  s>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Args& a, cudaStream_t s) {
  constexpr int bytes = f32_smem_bytes<D>();
  allow_smem<bwd_dkdv_f32<D>>(bytes);
  allow_smem<bwd_dq_f32<D>>(bytes);
  bwd_dkdv_f32<D><<<dim3((a.Sk + BF - 1) / BF, a.KV, a.B), F32_THREADS, bytes,
                    s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dq_f32<D><<<dim3((a.Sq + BF - 1) / BF, a.H, a.B), F32_THREADS, bytes,
                  s>>>(a);
  return (int)cudaGetLastError();
}

// bf16 at hd 33..128: bwd_prep, then the one pass
template <int D>
int launch_wg(const Args& a, cudaStream_t s) {
  using L = WgLayout<D>;
  const int64_t warps = ((int64_t)a.B * a.sq_pad * a.H + 31) / 32 +
                        (int64_t)a.B * (a.n_qt + a.n_kt);
  bwd_prep<<<(unsigned)((warps + WARPS - 1) / WARPS), THREADS, 0, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  allow_smem<bwd_wg<D>>(L::BYTES);
  bwd_wg<D><<<(unsigned)((int64_t)a.B * a.KV * a.n_kt), L::NT, L::BYTES,
              s>>>(a);
  return (int)cudaGetLastError();
}

// hd padded to the instance's D
int pad_d(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 80 ? 80 : 128;
}

// The float32 workspace at `base` (null: only sized): (B, H, Sq) delta of
// the three-kernel paths, or the wgmma path's arrays (Args); -> its size
// in 4-byte words.
int64_t layout(Args& a, bool bf16, float* base) {
  const int D = pad_d(a.hd);
  if (!bf16 || D <= 32) {
    a.delta = base;
    return (int64_t)a.B * a.H * a.Sq;
  }
  a.bn = 64 * wg_count(D);
  a.n_qt = (a.Sq + BT - 1) / BT;
  a.n_kt = (a.Sk + a.bn - 1) / a.bn;
  a.sq_pad = a.n_qt * BT;
  const int64_t bh = (int64_t)a.B * a.H;
  int64_t at = 0;
  auto take = [&](int64_t words) {
    float* p = base ? base + at : nullptr;
    at += (words + 3) / 4 * 4;   // 16-byte aligned arrays
    return p;
  };
  a.dq_acc = take(bh * a.sq_pad * D);
  a.lse2 = take(bh * a.sq_pad);
  a.delta2 = take(bh * a.sq_pad);
  a.qpos2 = reinterpret_cast<int*>(take((int64_t)a.B * a.sq_pad));
  a.qrange = reinterpret_cast<int2*>(take(2 * (int64_t)a.B * a.n_qt));
  a.krange = reinterpret_cast<int2*>(take(2 * (int64_t)a.B * a.n_kt));
  a.ntot = reinterpret_cast<int*>(take((int64_t)a.B * a.n_qt));
  a.counters = reinterpret_cast<int*>(take(bh * a.n_qt));
  a.ticket = reinterpret_cast<int*>(take(1));
  return at;
}

struct DeviceGuard {
  int prev = -1, want;
  explicit DeviceGuard(int device) : want(device) {
    cudaGetDevice(&prev);
    if (prev != want) cudaSetDevice(want);
  }
  ~DeviceGuard() {
    if (prev != want && prev >= 0) cudaSetDevice(prev);
  }
};

Args make_args(int B, int Sq, int Sk, int H, int KV, int hd) {
  Args a{};
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.hd = hd;
  return a;
}

}  // namespace

// The float32 workspace flash_attention_bwd takes as `work`, in 4-byte
// words, for these shapes and q's type.
extern "C" long long flash_attention_bwd_workspace(int B, int Sq, int Sk,
                                                   int H, int KV, int hd,
                                                   int bf16) {
  Args a = make_args(B, Sq, Sk, H, KV, hd);
  return (long long)layout(a, bf16 != 0, nullptr);
}

// Plain C entry point (loaded with ctypes).  The Python wrapper checks
// shapes, types (q, k, v, out, dout all bf16 or all float32; lse float32),
// hd % 8 == 0 and hd <= 128, 16-byte alignment, device and contiguity, and
// allocates dq, dk, dv and the float32 workspace `work`
// (flash_attention_bwd_workspace words).  Launches bwd_prep and bwd_wg
// (bf16, hd > 32) or bwd_delta, bwd_dkdv and bwd_dq on `device` (made
// current for the call) and `stream`; returns the first non-zero
// cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const int* q_pos,
                                   const int* kv_pos, const void* out,
                                   const float* lse, const void* dout,
                                   float* work, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int window, float scale,
                                   float softcap, int bf16, int device,
                                   void* stream) {
  if ((int64_t)B * Sq * H == 0 || Sk == 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd % 8 != 0 || hd > 128 || hd <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(B, Sq, Sk, H, KV, hd);
  a.q = q;
  a.k = k;
  a.v = v;
  a.q_pos = q_pos;
  a.kv_pos = kv_pos;
  a.out = out;
  a.lse = lse;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.scale2 = scale * LOG2E;
  a.cap2 = softcap * LOG2E;
  a.to_t = softcap > 0.f ? scale / softcap : 0.f;
  layout(a, bf16 != 0, work);
  cudaStream_t s = (cudaStream_t)stream;
  const DeviceGuard guard(device);
  const int D = pad_d(hd);
  if (bf16 && D > 32) {
    if (D == 64) return launch_wg<64>(a, s);
    if (D == 80) return launch_wg<80>(a, s);
    return launch_wg<128>(a, s);
  }
  const int64_t rows = (int64_t)B * Sq * H;
  const unsigned grid = (unsigned)((rows + WARPS - 1) / WARPS);
  if (bf16)
    bwd_delta<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);
  else
    bwd_delta<float><<<grid, THREADS, 0, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if (bf16) return D == 16 ? launch_mma<16>(a, s) : launch_mma<32>(a, s);
  if (D == 16) return launch_f32<16>(a, s);
  if (D == 32) return launch_f32<32>(a, s);
  if (D == 64) return launch_f32<64>(a, s);
  if (D == 80) return launch_f32<80>(a, s);
  return launch_f32<128>(a, s);
}
