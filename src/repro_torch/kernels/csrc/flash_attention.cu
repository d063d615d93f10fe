// Flash-attention forward with grouped K/V, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention and the forward of the layers.fused_attention region
// (repro/models/layers.py::_fused_flash_fwd_impl), whose function it
// computes:
//   q (B, Sq, H, hd), k / v (B, Sk, KV, hd) with H % KV == 0 (query head h
//   reads kv head h / (H/KV), unrepeated), positions q_pos (B, Sq) and
//   kv_pos (B, Sk) int32 ->
//   out (B, Sq, H, hd) in q's type, lse (B, H, Sq) float32, with
//   s = q.k / sqrt(hd), s = softcap * tanh(s / softcap) when softcap > 0,
//   keep = q_pos >= kv_pos (and q_pos - kv_pos < window when window > 0),
//   an online softmax with float32 m, l and acc, out = acc / max(l, 1e-20),
//   lse = m + log(max(l, 1e-20)); a row that sees no key gives 0.
// K and V are read in their stored type (float32 for the serving cache)
// and rounded in registers to the compute type, q's type: the values of
// the reference's k_all.astype(cdt) without a copy of the cache.
//
// The TPU kernel runs one (batch*head, 512-query block) per grid step
// over a repeated K/V, with Sq and Sk multiples of 512 and the whole K/V
// row in VMEM.  Here one block of 4 warps owns 64 query rows of one
// (batch, kv head): the rows are the flat (token, head-in-group) pairs of
// that kv head, so every K/V tile staged in shared memory serves all
// H/KV query heads at once, and a decode step (Sq = 1) puts H/KV rows in
// a block instead of one.  The block walks the keys in tiles and skips a
// tile none of whose keys any of its rows can see (the causal future of a
// prefill, the POS_SENTINEL tail of a cache, keys behind the window):
// skipping adds nothing and changes no m, so the result is the same.
// Ragged Sq, Sk and hd are masked in the kernel (zero rows, positions past
// Sk never visible); nothing is padded in device memory.
//
// Two instances per head width D (hd rounded up to 16, 64, 80 or 128):
//  * bf16 q: mma.sync m16n8k16 bf16 with float32 accumulators for Q.K^T
//    and P.V (hd = 80 is 5 k-steps of 16), Q held in registers as A
//    fragments, the S accumulators re-packed in registers as the A
//    fragments of P.V (P rounded to bf16 before the product, as the
//    region's p.astype(v.dtype)), V read with ldmatrix.trans; 64-key
//    tiles; shared rows padded to D + 8 elements (conflict-free);
//  * float32 q: the same walk on the CUDA cores (4 x 4 register tiles of
//    S, 32-key tiles), for float32 models and the parity runs.
//
// What bounds it on an H100.  A decode step reads the visible K/V once:
// sum over slots of (pos + 1) * KV * hd * 4 B * 2 at 3.35 TB/s (~0.025 ms
// with four full 4096-token slots of qwen3-4b) — bytes.  Its grid is only
// B * KV blocks (32 for qwen3-4b at 4 slots), a quarter of the SMs, each
// walking its keys in order; splitting the keys across blocks (split-KV)
// is the later fix.  A prefill does 4 * H * (visible pairs) * hd operations
// (2.15e10 for a 2048-token qwen3-4b prompt, 0.0217 ms at 989 TFLOP/s
// bf16) — operations.  This design keeps the score tile out of device
// memory and skips invisible tiles; it does not overlap the staging of
// one tile with the products of the last (no cp.async / TMA pipeline, no
// wgmma), which a later version adds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;     // query rows per block
constexpr int BK = 64;               // keys per tile, bf16 path
constexpr int BKF = 32;              // keys per tile, float32 path
constexpr float NEG = -1e30f;        // the reference's masked score
constexpr int PAD_POS = 0x3fffffff;  // int32 max / 2: keys past Sk

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  void* out;
  float* lse;
  int B, Sq, Sk, H, KV, hd, window;
  float scale, softcap;
};

// 8 consecutive elements as float32 (16-byte aligned loads).
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(h);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float warp_max(float x, int width) {
  for (int o = 1; o < width; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x, int width) {
  for (int o = 1; o < width; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Where a flat query row of the block lives.  Row R of (b, kv head) is
// token R / G, query head kvh * G + R % G.
struct Row {
  bool valid;
  int tok, head, pos;
};

__device__ __forceinline__ Row row_of(const Args& a, int b, int kvh, int R) {
  const int G = a.H / a.KV;
  Row r;
  r.valid = R < a.Sq * G;
  r.tok = r.valid ? R / G : 0;
  r.head = kvh * G + (r.valid ? R % G : 0);
  r.pos = r.valid ? a.q_pos[(int64_t)b * a.Sq + r.tok] : 0;
  return r;
}

__device__ __forceinline__ bool keep(const Args& a, const Row& r, int kp) {
  return r.valid && r.pos >= kp && (a.window <= 0 || r.pos - kp < a.window);
}

// Smallest and largest position of the block's valid query rows, computed
// by every warp alike (so every warp takes the same tile decisions).
__device__ __forceinline__ void block_qpos_range(const Args& a, int b,
                                                 int kvh, int R0, int lane,
                                                 int& qmin, int& qmax) {
  qmin = 0x7fffffff;
  qmax = -0x7fffffff - 1;
  for (int r = lane; r < ROWS; r += 32) {
    const Row row = row_of(a, b, kvh, R0 + r);
    if (row.valid) {
      qmin = min(qmin, row.pos);
      qmax = max(qmax, row.pos);
    }
  }
  for (int o = 1; o < 32; o <<= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  }
}

__device__ __forceinline__ int kv_pos_at(const Args& a, int b, int key) {
  return key < a.Sk ? a.kv_pos[(int64_t)b * a.Sk + key] : PAD_POS;
}

// Whether some row of the block may see some key of the tile [j0, j0+n):
// false only when every key lies after every row's position, or (with a
// window) every key lies a full window or more behind every row.
template <int N>
__device__ __forceinline__ bool tile_visible(const Args& a, int b, int j0,
                                             int lane, int qmin, int qmax) {
  int kmin = 0x7fffffff, kmax = -0x7fffffff - 1;
#pragma unroll
  for (int j = lane; j < N; j += 32) {
    const int kp = kv_pos_at(a, b, j0 + j);
    kmin = min(kmin, kp);
    kmax = max(kmax, kp);
  }
  for (int o = 1; o < 32; o <<= 1) {
    kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
  }
  if (kmin > qmax) return false;
  if (a.window > 0 && (int64_t)kmax <= (int64_t)qmin - a.window) return false;
  return true;
}

// Stage keys [j0, j0 + N) of one kv head (N x D, zero past Sk and past hd)
// into shared memory, 8 elements per unit: all loads first, then the
// stores, so a thread keeps its loads in flight together.
template <int N, int D, typename KT, typename Store>
__device__ __forceinline__ void stage(const Args& a, const KT* src, int b,
                                      int kvh, int j0, Store store) {
  constexpr int UNITS = N * (D / 8);
  constexpr int ITERS = (UNITS + THREADS - 1) / THREADS;
  float buf[ITERS][8];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int u = threadIdx.x + it * THREADS;
    const int key = u / (D / 8), c = 8 * (u % (D / 8));
    if (u < UNITS && j0 + key < a.Sk && c < a.hd) {
      load8(src + (((int64_t)b * a.Sk + j0 + key) * a.KV + kvh) * a.hd + c,
            buf[it]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) buf[it][e] = 0.f;
    }
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int u = threadIdx.x + it * THREADS;
    if (u < UNITS) store(u / (D / 8), 8 * (u % (D / 8)), buf[it]);
  }
}

// Stores of one staged unit: rounded to bf16 (rows of STRIDE elements),
// or as float32.
template <int STRIDE>
struct StoreBf16 {
  __nv_bfloat16* dst;
  __device__ __forceinline__ void operator()(int key, int c,
                                             const float (&x)[8]) const {
    *reinterpret_cast<uint4*>(&dst[key * STRIDE + c]) =
        make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                   pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
  }
};

template <int STRIDE>
struct StoreF32 {
  float* dst;
  __device__ __forceinline__ void operator()(int key, int c,
                                             const float (&x)[8]) const {
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[key * STRIDE + c + e] = x[e];
  }
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&x)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores.  Warp w owns rows 16w .. 16w+15; thread (g, t) =
// (lane / 4, lane % 4) holds, per 8-wide column block, rows g and g + 8 at
// columns 2t and 2t + 1 (the m16n8 accumulator layout).
// ---------------------------------------------------------------------------
template <int D, typename KT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma(const Args a) {
  constexpr int STR = D + 8;          // shared row stride in elements
  constexpr int NB = D / 8;           // 8-wide column blocks of the output
  constexpr int KS = D / 16;          // k-steps of Q.K^T
  __shared__ __align__(16) __nv_bfloat16 sK[BK * STR];   // Q, then K tiles
  __shared__ __align__(16) __nv_bfloat16 sV[BK * STR];
  __shared__ int sKP[BK];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.z, kvh = blockIdx.y, R0 = blockIdx.x * ROWS;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);

  // Q rows -> shared -> A fragments in registers
  {
    constexpr int UNITS = ROWS * (D / 8);
    for (int u = threadIdx.x; u < UNITS; u += THREADS) {
      const int r = u / (D / 8), c = 8 * (u % (D / 8));
      const Row row = row_of(a, b, kvh, R0 + r);
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (row.valid && c < a.hd)
        load8(q + (((int64_t)b * a.Sq + row.tok) * a.H + row.head) * a.hd + c,
              x);
      StoreBf16<STR>{sK}(r, c, x);
    }
  }
  __syncthreads();
  uint32_t qa[KS][4];
  {
    const __nv_bfloat16* r0 = &sK[(16 * warp + g) * STR + 2 * t];
    const __nv_bfloat16* r1 = r0 + 8 * STR;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(r0 + 16 * kk);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(r1 + 16 * kk);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 16 * kk + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 16 * kk + 8);
    }
  }
  __syncthreads();

  const Row rows[2] = {row_of(a, b, kvh, R0 + 16 * warp + g),
                       row_of(a, b, kvh, R0 + 16 * warp + g + 8)};
  const bool active = R0 + 16 * warp < a.Sq * (a.H / a.KV);
  int qmin, qmax;
  block_qpos_range(a, b, kvh, R0, lane, qmin, qmax);

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j0 = 0; j0 < a.Sk; j0 += BK) {
    if (!tile_visible<BK>(a, b, j0, lane, qmin, qmax)) continue;
    stage<BK, D>(a, k, b, kvh, j0, StoreBf16<STR>{sK});
    stage<BK, D>(a, v, b, kvh, j0, StoreBf16<STR>{sV});
    if (threadIdx.x < BK) sKP[threadIdx.x] = kv_pos_at(a, b, j0 + threadIdx.x);
    __syncthreads();

    if (active) {
      // S = Q K^T for this warp's 16 rows x 64 keys
      float s[BK / 8][4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        const __nv_bfloat16* kr = &sK[(8 * j + g) * STR + 2 * t];
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          mma_bf16(s[j], qa[kk],
                   *reinterpret_cast<const uint32_t*>(kr + 16 * kk),
                   *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8));
      }
      // scale, softcap, mask; the running max of each row
      uint32_t kept = 0;
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e / 2;
          float x = s[j][e] * a.scale;
          if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
          if (keep(a, rows[hr], sKP[8 * j + 2 * t + (e & 1)])) {
            kept |= 1u << (4 * j + e);
          } else {
            x = NEG;
          }
          s[j][e] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      float corr[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float m_new = fmaxf(m[hr], warp_max(mx[hr], 4));
        corr[hr] = expf(m[hr] - m_new);
        m[hr] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              (kept >> (4 * j + e)) & 1u ? expf(s[j][e] - m[e / 2]) : 0.f;
          s[j][e] = p;
          ps[e / 2] += p;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + ps[hr];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // acc += P V: P (rounded to bf16) from the S registers, V by
      // ldmatrix.trans (lanes 8i .. 8i+7 address matrix i: keys +8 for odd
      // i, columns +8 for i >= 2)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const int mi = lane / 8;
        const __nv_bfloat16* vr =
            &sV[(16 * kk + lane % 8 + 8 * (mi & 1)) * STR + 8 * (mi >> 1)];
#pragma unroll
        for (int n = 0; n < NB; n += 2) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vr + 8 * n);
          mma_bf16(acc[n], pa, bv[0], bv[1]);
          mma_bf16(acc[n + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float lt = warp_sum(l[hr], 4);
    const Row& row = rows[hr];
    if (!row.valid) continue;
    const float inv = 1.f / fmaxf(lt, 1e-20f);
    __nv_bfloat16* o =
        out + (((int64_t)b * a.Sq + row.tok) * a.H + row.head) * a.hd;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < a.hd)
        *reinterpret_cast<uint32_t*>(o + c) =
            pack_bf16(acc[n][2 * hr] * inv, acc[n][2 * hr + 1] * inv);
    }
    if (t == 0)
      a.lse[((int64_t)b * a.H + row.head) * a.Sq + row.tok] =
          m[hr] + logf(fmaxf(lt, 1e-20f));
  }
}

// ---------------------------------------------------------------------------
// float32 q: CUDA cores.  Thread (ty, tx) = (tid / 8, tid % 8) owns rows
// 4ty .. 4ty+3, keys tx + 8jj of each 32-key tile and output columns
// tx + 8c; a row's 8 owners are 8 neighbouring lanes of one warp.
// ---------------------------------------------------------------------------
template <int D>
constexpr int f32_smem_bytes() {
  return 4 * (ROWS * (D + 1) + BKF * (D + 1) + BKF * D + BKF);
}

template <int D, typename KT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const Args a) {
  constexpr int QS = D + 1, KS = D + 1;   // padded row strides
  constexpr int NC = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + ROWS * QS;
  float* sV = sK + BKF * KS;
  int* sKP = reinterpret_cast<int*>(sV + BKF * D);

  const int lane = threadIdx.x % 32;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int b = blockIdx.z, kvh = blockIdx.y, R0 = blockIdx.x * ROWS;
  const float* q = static_cast<const float*>(a.q);
  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);

  for (int u = threadIdx.x; u < ROWS * (D / 8); u += THREADS) {
    const int r = u / (D / 8), c = 8 * (u % (D / 8));
    const Row row = row_of(a, b, kvh, R0 + r);
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row.valid && c < a.hd)
      load8(q + (((int64_t)b * a.Sq + row.tok) * a.H + row.head) * a.hd + c,
            x);
    StoreF32<QS>{sQ}(r, c, x);
  }

  Row rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = row_of(a, b, kvh, R0 + 4 * ty + i);
  int qmin, qmax;
  block_qpos_range(a, b, kvh, R0, lane, qmin, qmax);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < a.Sk; j0 += BKF) {
    if (!tile_visible<BKF>(a, b, j0, lane, qmin, qmax)) continue;
    stage<BKF, D>(a, k, b, kvh, j0, StoreF32<KS>{sK});
    stage<BKF, D>(a, v, b, kvh, j0, StoreF32<D>{sV});
    if (threadIdx.x < BKF) sKP[threadIdx.x] = kv_pos_at(a, b, j0 + threadIdx.x);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * ty + i) * QS + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = sK[(tx + 8 * jj) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] += qv[i] * kv[jj];
    }
    uint32_t kept = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float x = s[i][jj] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        if (keep(a, rows[i], sKP[tx + 8 * jj])) {
          kept |= 1u << (4 * i + jj);
        } else {
          x = NEG;
        }
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], warp_max(mx, 8));
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p =
            (kept >> (4 * i + jj)) & 1u ? expf(s[i][jj] - m_new) : 0.f;
        s[i][jj] = p;
        ps += p;
      }
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    // acc += P V; p of key 8jj + jx is s[i][jj] of the row group's lane jx
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int jx = 0; jx < 8; ++jx) {
        float vv[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = sV[(8 * jj + jx) * D + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pj =
              __shfl_sync(0xffffffffu, s[i][jj], (lane & ~7) | jx);
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] += pj * vv[c];
        }
      }
    __syncthreads();
  }

  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lt = warp_sum(l[i], 8);
    const Row& row = rows[i];
    if (!row.valid) continue;
    const float inv = 1.f / fmaxf(lt, 1e-20f);
    float* o = out + (((int64_t)b * a.Sq + row.tok) * a.H + row.head) * a.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 8 * c < a.hd) o[tx + 8 * c] = acc[i][c] * inv;
    if (tx == 0)
      a.lse[((int64_t)b * a.H + row.head) * a.Sq + row.tok] =
          m[i] + logf(fmaxf(lt, 1e-20f));
  }
}

template <int D, typename KT>
int launch_d(const Args& a, bool q_bf16, cudaStream_t s) {
  const int G = a.H / a.KV;
  const dim3 grid((unsigned)(((int64_t)a.Sq * G + ROWS - 1) / ROWS), a.KV,
                  a.B);
  if (q_bf16) {
    flash_fwd_mma<D, KT><<<grid, THREADS, 0, s>>>(a);
  } else {
    constexpr int bytes = f32_smem_bytes<D>();
    cudaFuncSetAttribute(flash_fwd_f32<D, KT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    flash_fwd_f32<D, KT><<<grid, THREADS, bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename KT>
int launch_kt(const Args& a, bool q_bf16, cudaStream_t s) {
  if (a.hd <= 16) return launch_d<16, KT>(a, q_bf16, s);
  if (a.hd <= 64) return launch_d<64, KT>(a, q_bf16, s);
  if (a.hd <= 80) return launch_d<80, KT>(a, q_bf16, s);
  if (a.hd <= 128) return launch_d<128, KT>(a, q_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  The Python wrapper checks
// shapes, types (q bf16 or float32; k and v float32 or bf16, alike),
// hd % 8 == 0 and hd <= 128, 16-byte alignment, device and contiguity.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* q_pos,
                                   const int* kv_pos, void* out, float* lse,
                                   int B, int Sq, int Sk, int H, int KV,
                                   int hd, int window, float scale,
                                   float softcap, int q_bf16, int kv_bf16,
                                   void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd % 8 != 0 || hd > 128 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, q_pos, kv_pos, out, lse, B, Sq, Sk, H, KV, hd,
               window, scale, softcap};
  cudaStream_t s = (cudaStream_t)stream;
  return kv_bf16 ? launch_kt<__nv_bfloat16>(a, q_bf16 != 0, s)
                 : launch_kt<float>(a, q_bf16 != 0, s);
}
