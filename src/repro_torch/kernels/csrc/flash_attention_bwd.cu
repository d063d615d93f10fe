// Flash-attention backward with grouped K/V, for Hopper (sm_90a).
//
// Replaces the backward of the reference's layers.fused_attention region
// (repro/models/layers.py::_fused_flash_bwd_impl, behind the custom_vjp
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
//
// Three kernels, launched from one host call on one stream:
//   bwd_delta  one warp per (b, token, head) row: delta (B, H, Sq) float32;
//   bwd_dkdv   one block per (batch, kv head, tile of keys) walks the query
//              tiles of all H/KV query heads of its group, with the key
//              tile's dK and dV in registers: the group sum needs no
//              atomics and no second pass;
//   bwd_dq     one block per (batch, query head, tile of queries) walks the
//              key tiles, with dQ in registers.
// No floating-point atomics anywhere: every sum runs in a fixed order, so
// two runs on the same inputs give bit-identical gradients.  A tile pair
// no query of the one can see a key of the other (the causal future, keys
// behind the window, positions past Sk) is skipped by every thread of the
// block alike.  Ragged Sq, Sk and hd are masked in the kernels (zero rows
// and columns in shared memory, positions past Sk never visible).
//
// bf16 q (the training path): 64-row tiles, four warps of 16 rows each,
// mma.sync m16n8k16 bf16 with float32 accumulators.  All four operand
// tiles (K, V and the Q, dO tile of the walk; Q, dO and the K, V tile of
// the walk) sit in shared memory, rows padded to D + 8 elements so
// ldmatrix reads are free of bank conflicts; A operands of the score
// products by ldmatrix, B operands by ldmatrix (.trans for the products
// over the walked axis), P^T and dS^T re-packed from the score
// accumulators as A fragments.  hd is padded to D = 16, 32, 64, 80 or 128
// (zero columns).  float32 q: the same walk on the CUDA cores, 32-row
// tiles, 256 threads, each owning 4 scores and D/8 accumulator columns.
//
// What bounds it on an H100: the five products over the visible pairs,
// 10 * hd operations a pair (1.07e11 for the qwen3-4b training shape,
// B = 2, Sq = Sk = 2048, 32 heads of 80, causal: 0.109 ms at 989 TFLOP/s
// bf16) — operations.  This design spends seven (dk/dv and dq each
// recompute S and dP), on mma.sync without a copy pipeline (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BT = 64;          // rows per tile, bf16 path
constexpr int BF = 32;          // rows per tile, float32 path
constexpr int F32_THREADS = 256;
constexpr int PAD_POS = 0x3fffffff;  // int32 max / 2: keys past Sk
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
// bf16: mma.sync m16n8k16
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

template <int D>
int launch_d(const Args& a, bool bf16, cudaStream_t s) {
  if (bf16) {
    constexpr int bytes = mma_smem_bytes<D>();
    allow_smem<bwd_dkdv_mma<D>>(bytes);
    allow_smem<bwd_dq_mma<D>>(bytes);
    bwd_dkdv_mma<D><<<dim3((a.Sk + BT - 1) / BT, a.KV, a.B), THREADS, bytes,
                      s>>>(a);
    int err = (int)cudaGetLastError();
    if (err) return err;
    bwd_dq_mma<D><<<dim3((a.Sq + BT - 1) / BT, a.H, a.B), THREADS, bytes,
                    s>>>(a);
    return (int)cudaGetLastError();
  }
  constexpr int bytes = f32_smem_bytes<D>();
  allow_smem<bwd_dkdv_f32<D>>(bytes);
  allow_smem<bwd_dq_f32<D>>(bytes);
  bwd_dkdv_f32<D><<<dim3((a.Sk + BF - 1) / BF, a.KV, a.B), F32_THREADS, bytes,
                    s>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dq_f32<D><<<dim3((a.Sq + BF - 1) / BF, a.H, a.B), F32_THREADS, bytes,
                  s>>>(a);
  return (int)cudaGetLastError();
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

}  // namespace

// Plain C entry point (loaded with ctypes).  The Python wrapper checks
// shapes, types (q, k, v, out, dout all bf16 or all float32; lse float32),
// hd % 8 == 0 and hd <= 128, 16-byte alignment, device and contiguity, and
// allocates dq, dk, dv and the (B, H, Sq) float32 delta scratch.  Launches
// bwd_delta, bwd_dkdv and bwd_dq on `device` (made current for the call)
// and `stream`; returns the first non-zero cudaGetLastError().
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const int* q_pos,
                                   const int* kv_pos, const void* out,
                                   const float* lse, const void* dout,
                                   float* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int window, float scale,
                                   float softcap, int bf16, int device,
                                   void* stream) {
  if ((int64_t)B * Sq * H == 0 || Sk == 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd % 8 != 0 || hd > 128 || hd <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,     k,     v,  q_pos, kv_pos, out, lse, dout, delta,
               dq,    dk,    dv, B,     Sq,     Sk,  H,   KV,   hd,
               window, scale, softcap};
  cudaStream_t s = (cudaStream_t)stream;
  const DeviceGuard guard(device);
  const int64_t rows = (int64_t)B * Sq * H;
  const unsigned grid = (unsigned)((rows + WARPS - 1) / WARPS);
  if (bf16)
    bwd_delta<__nv_bfloat16><<<grid, THREADS, 0, s>>>(a);
  else
    bwd_delta<float><<<grid, THREADS, 0, s>>>(a);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  if (hd <= 16) return launch_d<16>(a, bf16 != 0, s);
  if (hd <= 32) return launch_d<32>(a, bf16 != 0, s);
  if (hd <= 64) return launch_d<64>(a, bf16 != 0, s);
  if (hd <= 80) return launch_d<80>(a, bf16 != 0, s);
  return launch_d<128>(a, bf16 != 0, s);
}
