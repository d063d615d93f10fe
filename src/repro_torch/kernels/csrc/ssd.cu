// Mamba-2's chunked mixer between its projections, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's SSD (repro/models/ssm.py) is plain
// jnp.  The plain version (kernels/ssd.py, ssd_mixer_plain) builds
// (chunks x heads x Q x Q) float32 tensors in device memory (134 MB each at
// 4,096 tokens and Nemotron 3 Nano's widths) in ~130 eager operations a
// layer.  Here one call is five launches on the caller's stream, and the
// (Q x Q) products live only in shared memory:
//
//   prep   dt = softplus(dt_raw + dt_bias), 0 on pads, and the cumulative
//          dt·A within each chunk, one warp a (row, chunk, head); the
//          causal depthwise conv (width 4, with bias) and SiLU of [x, B, C],
//          rounded to the compute type term by term as the plain version
//          does; the conv window of the last three valid inputs into the
//          cache's row.
//   state  each chunk's state B^T (x · dt · exp(cs_last - cs)), one block a
//          (row, chunk, two heads of a group), into float32 scratch
//          (B, NC, NH, N, 64).
//   pass   the recurrence over chunks, in place: each chunk's slot ends
//          holding the state before it; the final state into the cache.
//   scan   one block a (row, chunk, 128-row tile, head tile of one group):
//          S = C B^T for the tile in shared memory, computed once and used
//          by every head of the tile; per head, C · prev scaled by
//          exp(cs_i), plus (S ⊙ exp(cs_i - cs_j), j <= i) · (x · dt); then
//          + D·x, rounded to the compute type.
//   norm   one warp a (token, group) and 512 values of its slice: y ·
//          silu(z), rounded, then the gated RMSNorm over the group's slice,
//          times the norm's scale, rounded.
//
// Arithmetic: plain float32 on the CUDA cores (FMA in the products, no
// TF32: the configuration states the SSD and its state in float32).  The
// products sum in another order than the plain version's, so outputs agree
// to float32 reassociation before their last rounding.  No atomics: a
// launch's results do not depend on the order its blocks run in.
//
// What bounds it: the products, ~14 GFLOP a layer at 4,096 tokens (0.21 ms
// at the card's 67 TFLOP/s of float32 FMA) against ~120 MB in and out.  The
// products run as register-tiled float32 GEMMs from shared memory: 8 x 8
// outputs a thread, k-slices of 16, float4 operand loads.
//
// Shapes taken: head dim 64, state 16 or 128 (template), chunk up to 256
// (a prompt shorter than its chunk runs as one chunk of its own length),
// conv width 4, any number of heads and groups with a group's slice of
// d_inner at most 8,192 wide (Granite 4.0-H's one group of 128 heads); the
// wrapper refuses others.
//
// The recurrent step (decode, one token a row; ssd_step) replaces no TPU
// kernel either: the reference's step is jnp.  The plain step
// (kernels/ssd.py, ssd_step_plain) is ~38 kernels a layer that pass over the
// float32 state (B, NH, N, 64) nine times (a broadcast update, the decay,
// the sum, a batched GEMM at M = 1, the copy into the cache).  Here it is
// three launches, the state read once and written once in place:
//
//   step_prep   dt and its decay exp(dt·A), one thread a (row, head); the
//               conv of the cached window and the new input, + bias, SiLU,
//               into scratch; the window shifted in the cache.
//   step_state  one block a (row, head): s' = s·exp(dt·A) + B (dt·x) in
//               float32, rounded as the plain step's, back into the cache;
//               y = C·s' + D·x, rounded to the compute type.
//   norm        the chunked path's gate and grouped RMSNorm, at S = 1.
//
// What bounds it: the state's bytes, 2 x 4 B x N x 64 a (row, head): 134 MB
// a layer at 16 rows and Granite 4.0-H's 128 heads (40 us at 3.35 TB/s).
// One block owns a (row, head) tile, 2,048 of them at those widths, each
// thread's 16-byte loads all issued before the first is used.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;     // head dim
constexpr int KW = 4;      // conv width
constexpr int KS = 16;     // k-slice of the products
constexpr int TI = 128;    // rows of a scan tile
constexpr int CT = 16;     // time steps of one conv thread (8 at 8 channels)
constexpr int QMAX = 256;  // the longest chunk

struct Args {
  const void* proj;             // (B, S, P): z | x, B, C | dt_raw
  const void* conv_w;           // (KW, CD), compute type
  const void* conv_b;           // (CD,)
  const float* a_log;           // (NH,)
  const float* dt_bias;         // (NH,)
  const float* d_skip;          // (NH,)
  const void* scale;            // (di,): float32, or bf16 if scale_bf16
  const unsigned char* valid;   // (B, S), or null: every step valid
  const long long* rows;        // (B,) cache rows, or null: row b
  float* state_cache;           // (rows, NH, N, HD), or null
  void* conv_cache;             // (rows, KW - 1, CD), or null: kept
  void* xbc;                    // (B, S, CD) conv'd and activated
  float* dtv;                   // (B, NH, S)
  float* cs;                    // (B, NH, S) cumulative dt·A in a chunk
  float* states;                // (B, NC, NH, N, HD)
  void* out;                    // (B, S, di)
  int B, S, NH, G, N, Q, NC, P, CD, di, HT;
  float eps;
  int scale_bf16;
  int vec;                      // channels a thread moves at once: 8 where
                                // the projection's rows are 16-byte aligned
                                // (P % 8 == 0: Nemotron, mamba2), else 1
};

// V consecutive values of the compute type, loaded and stored as one access
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to the compute type, as a float
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ void store8(float* d, const float* v) {
  reinterpret_cast<float4*>(d)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(d)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void ld4(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}

// 8 consecutive values held as loaded (one 16-byte load for bf16, two for
// float32), so that a load can be issued a stage before its values are used
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float* o) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      o[2 * q] = f.x;
      o[2 * q + 1] = f.y;
    }
  }
};
template <>
struct Raw8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* p) {
    lo = reinterpret_cast<const float4*>(p)[0];
    hi = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void zero() {
    lo = hi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __device__ __forceinline__ void get(float* o) const {
    o[0] = lo.x; o[1] = lo.y; o[2] = lo.z; o[3] = lo.w;
    o[4] = hi.x; o[5] = hi.y; o[6] = hi.z; o[7] = hi.w;
  }
};

// SiLU as PyTorch writes it, v / (1 + exp(-v)), by the hardware's exp2 and
// reciprocal: a few float32 ulps from PyTorch's before the same rounding to
// the compute type (on an H100 the bf16 results equaled PyTorch's on all of
// 6.3 M activated conv outputs, and an accurate exp and IEEE division took
// prep from 45 to 71 us at 4,096 tokens); softplus (beta 1, threshold 20)
// as PyTorch's, in float32
__device__ __forceinline__ float silu(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}
__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

// ---------------------------------------------------------------------------
// prep: conv + SiLU | dt and its cumulative sum | the conv window
// ---------------------------------------------------------------------------
__host__ __device__ __forceinline__ int conv_blocks(const Args& a) {
  const int ct = a.vec == 8 ? CT / 2 : CT;
  return a.B * ((a.S + ct - 1) / ct) * ((a.CD / a.vec + 255) / 256);
}

// V channels over CT steps: ((((x0 w0) + x1 w1) + x2 w2) + x3 w3) + bias,
// every product and sum rounded to the compute type, then SiLU, rounded.
// The CT + KW - 1 inputs are loaded before the first store, so that their
// loads are in flight together.
template <typename T, int V>
__device__ void conv_part(const Args& a, int blk) {
  typedef Vec<T, V> VT;
  constexpr int ct = V == 8 ? CT / 2 : CT;
  const int tiles_c = (a.CD / V + 255) / 256, tiles_t = (a.S + ct - 1) / ct;
  const int ch = (blk % tiles_c * 256 + static_cast<int>(threadIdx.x)) * V;
  const int t0 = blk / tiles_c % tiles_t * ct;
  const int b = blk / (tiles_c * tiles_t);
  if (ch >= a.CD) return;
  const T* src = static_cast<const T*>(a.proj) + static_cast<size_t>(b) *
                 a.S * a.P + a.di + ch;
  T* dst = static_cast<T*>(a.xbc) + static_cast<size_t>(b) * a.S * a.CD + ch;
  const T* w = static_cast<const T*>(a.conv_w);
  VT wk[KW], xin[ct + KW - 1];
#pragma unroll
  for (int i = 0; i < KW; ++i)
    wk[i] = *reinterpret_cast<const VT*>(w + i * a.CD + ch);
  const VT bias = *reinterpret_cast<const VT*>(
      static_cast<const T*>(a.conv_b) + ch);
#pragma unroll
  for (int i = 0; i < ct + KW - 1; ++i) {
    const int t = t0 - (KW - 1) + i;
    if (t >= 0 && t < a.S) {
      xin[i] = *reinterpret_cast<const VT*>(src + static_cast<size_t>(t) *
                                            a.P);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) xin[i].v[u] = from_f<T>(0.0f);
    }
  }
#pragma unroll
  for (int k = 0; k < ct; ++k) {
    if (t0 + k >= a.S) break;
    VT o;
    if constexpr (V % 2 == 0 && sizeof(T) == 2) {
      // bf16 pairs: a bf16 product or sum rounded once is PyTorch's float32
      // result rounded to bf16 (the float32 product of two bf16 values is
      // exact, and so is their sum unless the smaller one lies below half
      // a bf16 ulp of the larger, where both give the larger)
      typedef __nv_bfloat162 B2;
#pragma unroll
      for (int u = 0; u < V / 2; ++u) {
        B2 acc = __hmul2(reinterpret_cast<const B2*>(xin[k].v)[u],
                         reinterpret_cast<const B2*>(wk[0].v)[u]);
#pragma unroll
        for (int i = 1; i < KW; ++i)
          acc = __hadd2(acc, __hmul2(reinterpret_cast<const B2*>(xin[k + i].v)[u],
                                     reinterpret_cast<const B2*>(wk[i].v)[u]));
        const float2 f = __bfloat1622float2(
            __hadd2(acc, reinterpret_cast<const B2*>(bias.v)[u]));
        reinterpret_cast<B2*>(o.v)[u] = __floats2bfloat162_rn(silu(f.x),
                                                              silu(f.y));
      }
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        float acc = rnd<T>(__fmul_rn(to_f(xin[k].v[u]), to_f(wk[0].v[u])));
#pragma unroll
        for (int i = 1; i < KW; ++i)
          acc = rnd<T>(__fadd_rn(acc, rnd<T>(__fmul_rn(to_f(xin[k + i].v[u]),
                                                       to_f(wk[i].v[u])))));
        acc = rnd<T>(__fadd_rn(acc, to_f(bias.v[u])));
        o.v[u] = from_f<T>(silu(acc));
      }
    }
    *reinterpret_cast<VT*>(dst + static_cast<size_t>(t0 + k) * a.CD) = o;
  }
}

// One warp a (row, chunk, head): dt over the chunk and its running sum of
// dt·A, A = -exp(a_log).  Lane l holds steps l·R .. l·R + R - 1 (R =
// ceil(Q / 32)): a sum within the lane, then the lanes' totals scanned
// across the warp.
constexpr int DT_WARPS = 8;

__host__ __device__ __forceinline__ int dt_blocks(const Args& a) {
  return (a.B * a.NC * a.NH + DT_WARPS - 1) / DT_WARPS;
}

template <typename T>
__device__ void dt_part(const Args& a, int blk) {
  const int warp = blk * DT_WARPS + static_cast<int>(threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= a.B * a.NC * a.NH) return;
  const int h = warp % a.NH, c = warp / a.NH % a.NC;
  const int b = warp / (a.NH * a.NC), R = (a.Q + 31) / 32;
  const float bias = a.dt_bias[h], A = -expf(a.a_log[h]);
  const size_t t0 = static_cast<size_t>(b) * a.S + static_cast<size_t>(c) *
                    a.Q;
  const T* src = static_cast<const T*>(a.proj) + t0 * a.P + a.di + a.CD + h;
  const size_t o = (static_cast<size_t>(b) * a.NH + h) * a.S +
                   static_cast<size_t>(c) * a.Q;
  float d[QMAX / 32], da[QMAX / 32], run = 0.0f;
#pragma unroll
  for (int r = 0; r < QMAX / 32; ++r) {
    const int j = lane * R + r;
    d[r] = da[r] = 0.0f;
    if (r < R && j < a.Q) {
      d[r] = softplus(__fadd_rn(to_f(src[static_cast<size_t>(j) * a.P]),
                                bias));
      if (a.valid) d[r] = __fmul_rn(d[r], a.valid[t0 + j] ? 1.0f : 0.0f);
      da[r] = __fmul_rn(d[r], A);
      run = __fadd_rn(run, da[r]);
    }
  }
  float tot = run;
#pragma unroll
  for (int k = 1; k < 32; k <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, tot, k);
    if (lane >= k) tot = __fadd_rn(v, tot);
  }
  float cum = __shfl_up_sync(0xffffffffu, tot, 1);
  if (lane == 0) cum = 0.0f;
#pragma unroll
  for (int r = 0; r < QMAX / 32; ++r) {
    const int j = lane * R + r;
    if (r < R && j < a.Q) {
      cum = __fadd_rn(cum, da[r]);
      a.dtv[o + j] = d[r];
      a.cs[o + j] = cum;
    }
  }
}

// One row: the last KW - 1 valid inputs (zeros before the first) into the
// cache's conv window.
template <typename T>
__device__ void window_part(const Args& a, int b) {
  __shared__ int part[32];
  int n = 0;
  if (a.valid) {
    for (int t = threadIdx.x; t < a.S; t += blockDim.x)
      n += a.valid[static_cast<size_t>(b) * a.S + t] != 0;
  } else if (threadIdx.x == 0) {
    n = a.S;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = n;
  __syncthreads();
  int len = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) len += part[w];
  const T* src = static_cast<const T*>(a.proj) + static_cast<size_t>(b) *
                 a.S * a.P + a.di;
  const long long row = a.rows ? a.rows[b] : b;
  T* dst = static_cast<T*>(a.conv_cache) + row * (KW - 1) * a.CD;
  for (int e = threadIdx.x; e < (KW - 1) * a.CD; e += blockDim.x) {
    const int k = e / a.CD, ch = e % a.CD, t = len - (KW - 1) + k;
    dst[e] = t >= 0 ? src[static_cast<size_t>(t) * a.P + ch] : from_f<T>(0.0f);
  }
}

template <typename T>
__device__ void prep(const Args& a) {
  int blk = blockIdx.x;
  const int ndt = dt_blocks(a), nconv = conv_blocks(a);
  if (blk < ndt) return dt_part<T>(a, blk);
  blk -= ndt;
  if (blk < nconv)
    return a.vec == 8 ? conv_part<T, 8>(a, blk) : conv_part<T, 1>(a, blk);
  window_part<T>(a, blk - nconv);
}

// ---------------------------------------------------------------------------
// state: B^T (x · w) of one (row, chunk, pair of heads of a group),
// w_j = dt_j exp(cs_last - cs_j)
// ---------------------------------------------------------------------------
// 256 threads, 16 x 16: thread (ty, tx) holds state rows n (8 for N = 128:
// ty*4 + 0..3 and 64 + ty*4 + 0..3; 1 for N = 16: ty) and columns p = tx*4 +
// 0..3 of both heads (the pair's columns tx*4 + 0..3 and 64 + tx*4 + 0..3).
// The two heads share the B operand.
__host__ __device__ __forceinline__ int state_blocks(const Args& a) {
  return a.B * a.NC * a.G * ((a.NH / a.G + 1) / 2);
}

template <typename T, int NS>
__device__ void state_body(const Args& a) {
  constexpr int MR = NS == 128 ? 8 : 1;
  __shared__ __align__(16) float As[KS][NS];
  __shared__ __align__(16) float Bs[KS][2 * HD];
  __shared__ float wj[2][QMAX];
  const int hg = a.NH / a.G, pairs = (hg + 1) / 2;
  const int pr = blockIdx.x % (a.G * pairs);
  const int c = blockIdx.x / (a.G * pairs) % a.NC;
  const int b = blockIdx.x / (a.G * pairs * a.NC);
  const int g = pr / pairs, h0 = g * hg + pr % pairs * 2;
  const int nh = h0 + 1 < (g + 1) * hg ? 2 : 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  for (int e = tid; e < nh * a.Q; e += blockDim.x) {
    const int hh = e / a.Q, j = e % a.Q;
    const size_t o = (static_cast<size_t>(b) * a.NH + h0 + hh) * a.S +
                     static_cast<size_t>(c) * a.Q;
    wj[hh][j] = __fmul_rn(a.dtv[o + j],
                          expf(__fsub_rn(a.cs[o + a.Q - 1], a.cs[o + j])));
  }
  const T* xb = static_cast<const T*>(a.xbc) +
                (static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * a.Q) *
                    a.CD;
  const int cb = a.di + g * NS;
  // each thread stages 8 of B's row (when NS * KS / 8 threads are enough)
  // and 8 of the pair's x row: row bk, columns bp .. bp + 7 of 128
  const int ak = tid * 8 / NS, an = tid * 8 % NS;
  const bool aon = tid * 8 < KS * NS;
  const int bk = tid >> 4, bp = (tid & 15) * 8, bh = bp / HD;
  Raw8<T> ra, rb;
  auto fetch = [&](int j0) {
    const int ja = j0 + ak, jb = j0 + bk;
    if (aon && ja < a.Q)
      ra.load(xb + static_cast<size_t>(ja) * a.CD + cb + an);
    else
      ra.zero();
    if (bh < nh && jb < a.Q)
      rb.load(xb + static_cast<size_t>(jb) * a.CD + h0 * HD + bp);
    else
      rb.zero();
  };
  float acc[MR][8];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
  fetch(0);
  for (int j0 = 0; j0 < a.Q; j0 += KS) {
    __syncthreads();
    {
      float v[8];
      if (aon) {
        ra.get(v);
        store8(&As[ak][an], v);
      }
      rb.get(v);
      if (bh < nh && j0 + bk < a.Q) {
        const float w = wj[bh][j0 + bk];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = __fmul_rn(v[q], w);
      }
      store8(&Bs[bk][bp], v);
    }
    __syncthreads();
    if (j0 + KS < a.Q) fetch(j0 + KS);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      float av[MR], bv[8];
      if constexpr (MR == 8) {
        ld4(&As[k][ty * 4], av);
        ld4(&As[k][64 + ty * 4], av + 4);
      } else {
        av[0] = As[k][ty];
      }
      ld4(&Bs[k][tx * 4], bv);
      ld4(&Bs[k][HD + tx * 4], bv + 4);
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (hh >= nh) break;
    float* dst = a.states + ((static_cast<size_t>(b) * a.NC + c) * a.NH +
                             h0 + hh) * NS * HD;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int n = MR == 8 ? (r < 4 ? ty * 4 + r : 64 + ty * 4 + r - 4) : ty;
      *reinterpret_cast<float4*>(dst + n * HD + tx * 4) =
          make_float4(acc[r][4 * hh], acc[r][4 * hh + 1], acc[r][4 * hh + 2],
                      acc[r][4 * hh + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass: state before chunk c = sum over c' < c, decayed; in place
// ---------------------------------------------------------------------------
__device__ void pass_body(const Args& a) {
  const int b = blockIdx.x / a.NH, h = blockIdx.x % a.NH;
  const int e = (blockIdx.y * blockDim.x + threadIdx.x) * 4;  // < N * HD
  const size_t step = static_cast<size_t>(a.NH) * a.N * HD;
  float* p = a.states + (static_cast<size_t>(b) * a.NC * a.NH + h) * a.N * HD
             + e;
  const float* last = a.cs + (static_cast<size_t>(b) * a.NH + h) * a.S +
                      a.Q - 1;
  float4 run = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 nxt = *reinterpret_cast<const float4*>(p);
  for (int c = 0; c < a.NC; ++c) {
    const float4 s = nxt;
    if (c + 1 < a.NC) nxt = *reinterpret_cast<const float4*>(p + (c + 1) * step);
    *reinterpret_cast<float4*>(p + c * step) = run;
    const float d = expf(last[static_cast<size_t>(c) * a.Q]);
    run.x = __fadd_rn(__fmul_rn(run.x, d), s.x);
    run.y = __fadd_rn(__fmul_rn(run.y, d), s.y);
    run.z = __fadd_rn(__fmul_rn(run.z, d), s.z);
    run.w = __fadd_rn(__fmul_rn(run.w, d), s.w);
  }
  if (a.state_cache) {
    const long long row = a.rows ? a.rows[b] : b;
    *reinterpret_cast<float4*>(a.state_cache + (row * a.NH + h) * a.N * HD +
                               e) = run;
  }
}

// ---------------------------------------------------------------------------
// scan: one (row, chunk, 128-row tile, head tile)
// ---------------------------------------------------------------------------
// Shared memory (floats): St [qp][TI] = S^T for j < jm, then the stages
// (phase 1: C1, B1 [KS][TI]; phase 2: Cs [KS][TI], Ps [2][KS][HD],
// Ms [2][KS][TI], Xs [2][KS][HD]), then cs and dt of a head pair [2][QMAX]
// each.
constexpr int STAGE = KS * TI + 2 * KS * HD + 2 * KS * TI + 2 * KS * HD;

__host__ __device__ constexpr size_t scan_smem(int qp) {
  return (static_cast<size_t>(qp) * TI + STAGE + 4 * QMAX) * sizeof(float);
}

template <typename T, int NS>
__device__ void scan_body(const Args& a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int qp = (a.Q + KS - 1) / KS * KS;
  const int its = (a.Q + TI - 1) / TI;
  const int it = blockIdx.x % its, c = blockIdx.x / its % a.NC;
  const int b = blockIdx.x / (its * a.NC);
  const int hg = a.NH / a.G, tiles = (hg + a.HT - 1) / a.HT;
  const int g = blockIdx.y / tiles;
  const int h0 = g * hg + static_cast<int>(blockIdx.y % tiles) * a.HT;
  const int h_end = min(h0 + a.HT, (g + 1) * hg);
  const int i0 = it * TI, jm = min(qp, i0 + TI);
  float* St = sm;
  float* stage = St + static_cast<size_t>(qp) * TI;
  float* C1 = stage;
  float* B1 = stage + KS * TI;
  float* Cs = stage;
  float* Ps = Cs + KS * TI;
  float* Ms = Ps + 2 * KS * HD;
  float* Xs = Ms + 2 * KS * TI;
  float* csv = stage + STAGE;
  float* dts = csv + 2 * QMAX;
  const int tid = threadIdx.x;
  const T* xb = static_cast<const T*>(a.xbc) +
                (static_cast<size_t>(b) * a.S + static_cast<size_t>(c) * a.Q) *
                    a.CD;
  const int cb = a.di + g * NS, cc = a.di + a.G * NS + g * NS;
  // each thread stages 8 channels of one row: row tid % 128, channels
  // (tid / 128) * 8 + 0..7 of the slice
  const int lr = tid & 127, lk = (tid >> 7) * 8;

  // Every stage below loads its next stage's operands into registers
  // before its products, so that the loads are in flight while it computes.

  // ---- phase 1: S[i][j] = C_i . B_j for the tile's rows, j < jm ----
  {
    const int ty = tid >> 4, tx = tid & 15;
    for (int js = 0; js < jm; js += TI) {
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
      Raw8<T> rc, rb;
      auto fetch = [&](int n0) {
        if (i0 + lr < a.Q)
          rc.load(xb + static_cast<size_t>(i0 + lr) * a.CD + cc + n0 + lk);
        else
          rc.zero();
        if (js + lr < a.Q)
          rb.load(xb + static_cast<size_t>(js + lr) * a.CD + cb + n0 + lk);
        else
          rb.zero();
      };
      fetch(0);
      for (int n0 = 0; n0 < NS; n0 += KS) {
        __syncthreads();
        {
          float v[8], w[8];
          rc.get(v);
          rb.get(w);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            C1[(lk + q) * TI + lr] = v[q];
            B1[(lk + q) * TI + lr] = w[q];
          }
        }
        __syncthreads();
        if (n0 + KS < NS) fetch(n0 + KS);
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          float av[8], bv[8];
          ld4(C1 + k * TI + ty * 4, av);
          ld4(C1 + k * TI + 64 + ty * 4, av + 4);
          ld4(B1 + k * TI + tx * 4, bv);
          ld4(B1 + k * TI + 64 + tx * 4, bv + 4);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
        }
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = js + (q < 4 ? tx * 4 + q : 64 + tx * 4 + q - 4);
        if (j < qp) {
          float* d = St + static_cast<size_t>(j) * TI;
          *reinterpret_cast<float4*>(d + ty * 4) =
              make_float4(acc[0][q], acc[1][q], acc[2][q], acc[3][q]);
          *reinterpret_cast<float4*>(d + 64 + ty * 4) =
              make_float4(acc[4][q], acc[5][q], acc[6][q], acc[7][q]);
        }
      }
    }
  }

  // ---- phase 2: two heads at a time, one to each half of the block ----
  // thread (ty, tx) of a half holds rows i0 + ty*8 + 0..7 and columns
  // tx*4 + 0..3, 32 + tx*4 + 0..3 of its head.  Stages 0 .. ns - 1 take the
  // previous chunks' part, C (rows x N) . prev (N x HD), then the rows are
  // scaled by exp(cs_i); the stages after take the part within the chunk,
  // (S ⊙ L) (rows x j) . (x · dt) (j x HD), L = exp(cs_i - cs_j).
  const int half = tid >> 7, t = tid & 127, ty = t >> 3, tx = t & 7;
  const int wlast = i0 + (t >> 5) * 32 + 31;  // the warp's last row
  const int pk = t * 8 / HD, pp = t * 8 % HD;  // a thread's 8 of a stage
  const int ns = NS / KS, nst = ns + (jm + KS - 1) / KS;
  float* ps = Ps + half * KS * HD;
  float* ms = Ms + half * KS * TI;
  float* xs = Xs + half * KS * HD;
  float* cv = csv + half * QMAX;
  float* dv = dts + half * QMAX;
  for (int hp = h0; hp < h_end; hp += 2) {
    const int h = hp + half;
    const bool on = h < h_end;
    const float* prev = a.states +
                        ((static_cast<size_t>(b) * a.NC + c) * a.NH + h) * NS *
                            HD;
    Raw8<T> rc, rx;
    Raw8<float> rp;
    auto fetch = [&](int st) {
      if (st < ns) {
        const int n0 = st * KS;
        if (i0 + lr < a.Q)
          rc.load(xb + static_cast<size_t>(i0 + lr) * a.CD + cc + n0 + lk);
        else
          rc.zero();
        if (on) rp.load(prev + static_cast<size_t>(n0 + pk) * HD + pp);
      } else {
        const int j = (st - ns) * KS + pk;
        if (on && j < a.Q)
          rx.load(xb + static_cast<size_t>(j) * a.CD + h * HD + pp);
        else
          rx.zero();
      }
    };
    fetch(0);
    __syncthreads();
    if (on) {
      const size_t o = (static_cast<size_t>(b) * a.NH + h) * a.S +
                       static_cast<size_t>(c) * a.Q;
      for (int j = t; j < a.Q; j += 128) {
        cv[j] = a.cs[o + j];
        dv[j] = a.dtv[o + j];
      }
    }
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.0f;
    for (int st = 0; st < nst; ++st) {
      const int j0 = (st - ns) * KS;
      __syncthreads();
      if (st < ns) {
        float v[8];
        rc.get(v);
#pragma unroll
        for (int q = 0; q < 8; ++q) Cs[(lk + q) * TI + lr] = v[q];
        if (on) {
          rp.get(v);
          store8(ps + pk * HD + pp, v);
        }
      } else if (on) {
        // L by the hardware's exp2 (__expf: its relative error, a few
        // 1e-7 · |cs_i - cs_j|, is below float32 reassociation where L is
        // not negligible), one a (i, j) pair and head
        const int ii = i0 + t;
        const float ci = ii < a.Q ? cv[ii] : 0.0f;
#pragma unroll 4
        for (int k = 0; k < KS; ++k) {
          const int j = j0 + k;
          ms[k * TI + t] =
              j <= ii && ii < a.Q
                  ? __fmul_rn(St[static_cast<size_t>(j) * TI + t],
                              __expf(__fsub_rn(ci, cv[j])))
                  : 0.0f;
        }
        float v[8];
        rx.get(v);
        if (j0 + pk < a.Q) {
          const float d = dv[j0 + pk];
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = __fmul_rn(v[q], d);
        }
        store8(xs + pk * HD + pp, v);
      }
      __syncthreads();
      if (st + 1 < nst) fetch(st + 1);
      if (!on) continue;
      const float* A = st < ns ? Cs : ms;
      const float* B = st < ns ? ps : xs;
      if (st < ns || j0 <= wlast) {
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          float av[8], bv[8];
          ld4(A + k * TI + ty * 8, av);
          ld4(A + k * TI + ty * 8 + 4, av + 4);
          ld4(B + k * HD + tx * 4, bv);
          ld4(B + k * HD + 32 + tx * 4, bv + 4);
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int q = 0; q < 8; ++q)
              acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
        }
      }
      if (st == ns - 1) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + ty * 8 + r;
          const float e = i < a.Q ? expf(cv[i]) : 0.0f;
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[r][q] = __fmul_rn(acc[r][q], e);
        }
      }
    }

    // y + D x, rounded to the compute type (the gate is the norm's)
    if (on) {
      typedef Vec<T, 4> V4;
      const float D = a.d_skip[h];
      T* op = static_cast<T*>(a.out);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = i0 + ty * 8 + r;
        if (i >= a.Q) break;
        const size_t row = static_cast<size_t>(b) * a.S +
                           static_cast<size_t>(c) * a.Q + i;
#pragma unroll
        for (int q0 = 0; q0 < 8; q0 += 4) {
          const int p = h * HD + (q0 ? 32 : 0) + tx * 4;
          const V4 x = *reinterpret_cast<const V4*>(
              xb + static_cast<size_t>(i) * a.CD + p);
          V4 o;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            o.v[u] = from_f<T>(__fadd_rn(acc[r][q0 + u],
                                         __fmul_rn(D, to_f(x.v[u]))));
          *reinterpret_cast<V4*>(op + row * a.di + p) = o;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// norm: in place, y · silu(z), rounded, then the RMSNorm of each (token,
// group) slice times the norm's scale.  A slice takes NW warps, each lane
// up to NE of its values, loaded before any is used; the warps' partial
// sums of squares are added in a fixed order.  A block holds 8 warps, or
// one slice's NW where it takes more (ssd_norm_wide_*: up to 16 warps, a
// slice of 8,192).
// ---------------------------------------------------------------------------
constexpr int NE = 16;

__host__ __device__ __forceinline__ int norm_warps(const Args& a) {
  return (a.di / a.G + 32 * NE - 1) / (32 * NE);
}

template <typename T, int V>
__device__ void norm_part(const Args& a) {
  typedef Vec<T, V> VT;
  constexpr int NV = NE / V;  // accesses a lane
  __shared__ float part[32];
  const int L = a.di / a.G, nw = norm_warps(a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = static_cast<int>(blockDim.x >> 5) / nw;
  const int slot = warp / nw, wl = warp % nw;
  const long long item = static_cast<long long>(blockIdx.x) * per + slot;
  const bool on = slot < per && item < static_cast<long long>(a.B) * a.S * a.G;
  const long long tok = on ? item / a.G : 0;
  const int g = on ? static_cast<int>(item % a.G) : 0;
  T* y = static_cast<T*>(a.out) + tok * a.di + static_cast<long long>(g) * L;
  const T* z = static_cast<const T*>(a.proj) + tok * a.P +
               static_cast<long long>(g) * L;
  VT yv[NV], zv[NV];
  float v[NE], ss = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e = (lane + 32 * (wl + nw * k)) * V;
    if (on && e < L) {
      yv[k] = *reinterpret_cast<const VT*>(y + e);
      zv[k] = *reinterpret_cast<const VT*>(z + e);
    }
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e = (lane + 32 * (wl + nw * k)) * V;
#pragma unroll
    for (int u = 0; u < V; ++u) v[k * V + u] = 0.0f;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (!on || e >= L) continue;
      if constexpr (V % 2 == 0 && sizeof(T) == 2) {
        // bf16 pairs: the product rounded once, as PyTorch's (conv_part)
        if (u % 2) continue;
        typedef __nv_bfloat162 B2;
        const float2 zf = __bfloat1622float2(
            reinterpret_cast<const B2*>(zv[k].v)[u / 2]);
        const float2 yz = __bfloat1622float2(
            __hmul2(reinterpret_cast<const B2*>(yv[k].v)[u / 2],
                    __floats2bfloat162_rn(silu(zf.x), silu(zf.y))));
        v[k * V + u] = yz.x;
        v[k * V + u + 1] = yz.y;
        ss = __fadd_rn(ss, __fmul_rn(yz.x, yz.x));
        ss = __fadd_rn(ss, __fmul_rn(yz.y, yz.y));
      } else {
        const float sz = rnd<T>(silu(to_f(zv[k].v[u])));
        v[k * V + u] = rnd<T>(__fmul_rn(to_f(yv[k].v[u]), sz));
        ss = __fadd_rn(ss, __fmul_rn(v[k * V + u], v[k * V + u]));
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (!on) return;
  float tot = 0.0f;
  for (int w = 0; w < nw; ++w) tot = __fadd_rn(tot, part[slot * nw + w]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(tot, static_cast<float>(L)),
                                   a.eps));
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int e = (lane + 32 * (wl + nw * k)) * V;
    if (e >= L) continue;
    VT o;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int i = g * L + e + u;
      const float sc =
          a.scale_bf16
              ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.scale)[i])
              : static_cast<const float*>(a.scale)[i];
      o.v[u] = from_f<T>(__fmul_rn(__fmul_rn(v[k * V + u], r), sc));
    }
    *reinterpret_cast<VT*>(y + e) = o;
  }
}

template <typename T>
__device__ void norm_body(const Args& a) {
  if (a.vec == 8)
    norm_part<T, 8>(a);
  else
    norm_part<T, 1>(a);
}

// ---------------------------------------------------------------------------
// The recurrent step: one token a row, the state and conv window in the
// cache (S = Q = NC = 1; xbc (B, CD), dtv and cs (B, NH): dt and its decay)
// ---------------------------------------------------------------------------
constexpr int STEP_THREADS = 256;

__host__ __device__ __forceinline__ int step_dt_blocks(const Args& a) {
  return (a.B * a.NH + STEP_THREADS - 1) / STEP_THREADS;
}
__host__ __device__ __forceinline__ int step_conv_blocks(const Args& a) {
  return a.B * ((a.CD / a.vec + STEP_THREADS - 1) / STEP_THREADS);
}

// One thread a (row, head): dt = softplus(dt_raw + dt_bias), 0 on a pad,
// and its decay exp(dt·A), A = -exp(a_log), as the plain step rounds them.
template <typename T>
__device__ void step_dt_part(const Args& a, int blk) {
  const int i = blk * STEP_THREADS + static_cast<int>(threadIdx.x);
  if (i >= a.B * a.NH) return;
  const int h = i % a.NH, b = i / a.NH;
  const T* src = static_cast<const T*>(a.proj) + static_cast<size_t>(b) * a.P +
                 a.di + a.CD + h;
  float d = softplus(__fadd_rn(to_f(*src), a.dt_bias[h]));
  if (a.valid) d = __fmul_rn(d, a.valid[b] ? 1.0f : 0.0f);
  a.dtv[i] = d;
  a.cs[i] = expf(__fmul_rn(d, -expf(a.a_log[h])));
}

// V channels of one row: the plain step's einsum over the cached window and
// the new input (a float32 sum of the four products, rounded once), + bias
// and SiLU, each rounded, into xbc; then the window shifted by one.  A
// channel's window is read and written by this thread alone, and the state
// launch reads B and C from xbc, so no block reads a window another shifts.
template <typename T, int V>
__device__ void step_conv_part(const Args& a, int blk) {
  typedef Vec<T, V> VT;
  const int tiles = (a.CD / V + STEP_THREADS - 1) / STEP_THREADS;
  const int b = blk / tiles;
  const int ch = (blk % tiles * STEP_THREADS + static_cast<int>(threadIdx.x)) *
                 V;
  if (ch >= a.CD) return;
  T* win = static_cast<T*>(a.conv_cache) +
           static_cast<size_t>(b) * (KW - 1) * a.CD + ch;
  const T* w = static_cast<const T*>(a.conv_w) + ch;
  VT xin[KW], wk[KW];
#pragma unroll
  for (int i = 0; i < KW - 1; ++i)
    xin[i] = *reinterpret_cast<const VT*>(win + static_cast<size_t>(i) * a.CD);
  xin[KW - 1] = *reinterpret_cast<const VT*>(
      static_cast<const T*>(a.proj) + static_cast<size_t>(b) * a.P + a.di + ch);
#pragma unroll
  for (int i = 0; i < KW; ++i)
    wk[i] = *reinterpret_cast<const VT*>(w + static_cast<size_t>(i) * a.CD);
  const VT bias = *reinterpret_cast<const VT*>(
      static_cast<const T*>(a.conv_b) + ch);
  VT o;
#pragma unroll
  for (int u = 0; u < V; ++u) {
    float acc = __fmul_rn(to_f(xin[0].v[u]), to_f(wk[0].v[u]));
#pragma unroll
    for (int i = 1; i < KW; ++i)
      acc = fmaf(to_f(xin[i].v[u]), to_f(wk[i].v[u]), acc);
    acc = rnd<T>(__fadd_rn(rnd<T>(acc), to_f(bias.v[u])));
    o.v[u] = from_f<T>(silu(acc));
  }
  *reinterpret_cast<VT*>(static_cast<T*>(a.xbc) + static_cast<size_t>(b) *
                         a.CD + ch) = o;
#pragma unroll
  for (int i = 0; i < KW - 1; ++i)
    *reinterpret_cast<VT*>(win + static_cast<size_t>(i) * a.CD) = xin[i + 1];
}

template <typename T>
__device__ void step_prep(const Args& a) {
  const int blk = blockIdx.x, ndt = step_dt_blocks(a);
  if (blk < ndt) return step_dt_part<T>(a, blk);
  if (a.vec == 8)
    step_conv_part<T, 8>(a, blk - ndt);
  else
    step_conv_part<T, 1>(a, blk - ndt);
}

// s' = s·da + B_n (dt·x_p): the plain step's products and sum, each rounded
__device__ __forceinline__ float step_one(float s, float da, float bn,
                                          float dx) {
  return __fadd_rn(__fmul_rn(s, da), __fmul_rn(bn, dx));
}

// One block a (row, head) and its N x 64 float32 state, read once and
// written once in place.  Thread (r, c) holds rows r + 16k and columns 4c ..
// 4c + 3 as float4s, all loaded before any is used (a warp's loads are two
// whole rows).  y_p = Σ_n C_n s'_np: each thread's rows in order, then a
// warp's two rows, then the 8 warps in order, by one thread a column (no
// atomics: a replay repeats it bit for bit); y + D·x rounded to the compute
// type (the gate is the norm's).
template <typename T, int NS>
__device__ void step_state_body(const Args& a) {
  constexpr int R = NS / 16;
  constexpr int W = STEP_THREADS / 32;
  __shared__ float bn[NS], cn[NS], xs[HD];
  __shared__ __align__(16) float part[W][HD];
  const int h = blockIdx.x % a.NH, b = blockIdx.x / a.NH;
  const int g = h / (a.NH / a.G);
  const int tid = threadIdx.x, c4 = (tid & 15) * 4, r0 = tid >> 4;
  float* st = a.state_cache + (static_cast<size_t>(b) * a.NH + h) * NS * HD;
  float4 s[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    s[k] = *reinterpret_cast<const float4*>(st + (r0 + 16 * k) * HD + c4);
  const T* xb = static_cast<const T*>(a.xbc) + static_cast<size_t>(b) * a.CD;
  if (tid < NS) {
    bn[tid] = to_f(xb[a.di + g * NS + tid]);
    cn[tid] = to_f(xb[a.di + (a.G + g) * NS + tid]);
  }
  if (tid < HD) xs[tid] = to_f(xb[h * HD + tid]);
  const float dt = a.dtv[b * a.NH + h], da = a.cs[b * a.NH + h];
  __syncthreads();
  const float dx0 = __fmul_rn(dt, xs[c4]), dx1 = __fmul_rn(dt, xs[c4 + 1]);
  const float dx2 = __fmul_rn(dt, xs[c4 + 2]), dx3 = __fmul_rn(dt, xs[c4 + 3]);
  float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int n = r0 + 16 * k;
    const float bv = bn[n], cv = cn[n];
    float4 v = s[k];
    v.x = step_one(v.x, da, bv, dx0);
    v.y = step_one(v.y, da, bv, dx1);
    v.z = step_one(v.z, da, bv, dx2);
    v.w = step_one(v.w, da, bv, dx3);
    *reinterpret_cast<float4*>(st + n * HD + c4) = v;
    y0 = fmaf(cv, v.x, y0);
    y1 = fmaf(cv, v.y, y1);
    y2 = fmaf(cv, v.z, y2);
    y3 = fmaf(cv, v.w, y3);
  }
  y0 = __fadd_rn(y0, __shfl_xor_sync(0xffffffffu, y0, 16));
  y1 = __fadd_rn(y1, __shfl_xor_sync(0xffffffffu, y1, 16));
  y2 = __fadd_rn(y2, __shfl_xor_sync(0xffffffffu, y2, 16));
  y3 = __fadd_rn(y3, __shfl_xor_sync(0xffffffffu, y3, 16));
  if ((tid & 31) < 16)
    *reinterpret_cast<float4*>(&part[tid >> 5][c4]) =
        make_float4(y0, y1, y2, y3);
  __syncthreads();
  if (tid < HD) {
    float y = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) y = __fadd_rn(y, part[w][tid]);
    static_cast<T*>(a.out)[static_cast<size_t>(b) * a.di + h * HD + tid] =
        from_f<T>(__fadd_rn(y, __fmul_rn(a.d_skip[h], xs[tid])));
  }
}

}  // namespace

// Unmangled kernel names, one per compute type and state width, so that a
// profile names them.
#define SSD_TYPED(NAME, BODY, BOUNDS, T)                          \
  extern "C" __global__ void __launch_bounds__ BOUNDS NAME(const Args a) { \
    BODY<T>(a);                                                   \
  }
#define SSD_WIDE(NAME, BODY, BOUNDS, T, NS)                       \
  extern "C" __global__ void __launch_bounds__ BOUNDS NAME(const Args a) { \
    BODY<T, NS>(a);                                               \
  }
SSD_TYPED(ssd_prep_bf16, prep, (256), __nv_bfloat16)
SSD_TYPED(ssd_prep_f32, prep, (256), float)
SSD_WIDE(ssd_state_bf16_n128, state_body, (256, 2), __nv_bfloat16, 128)
SSD_WIDE(ssd_state_bf16_n16, state_body, (256, 2), __nv_bfloat16, 16)
SSD_WIDE(ssd_state_f32_n128, state_body, (256, 2), float, 128)
SSD_WIDE(ssd_state_f32_n16, state_body, (256, 2), float, 16)
SSD_WIDE(ssd_scan_bf16_n128, scan_body, (256, 2), __nv_bfloat16, 128)
SSD_WIDE(ssd_scan_bf16_n16, scan_body, (256, 2), __nv_bfloat16, 16)
SSD_WIDE(ssd_scan_f32_n128, scan_body, (256, 2), float, 128)
SSD_WIDE(ssd_scan_f32_n16, scan_body, (256, 2), float, 16)
SSD_TYPED(ssd_norm_bf16, norm_body, (256, 3), __nv_bfloat16)
SSD_TYPED(ssd_norm_f32, norm_body, (256, 3), float)
SSD_TYPED(ssd_norm_wide_bf16, norm_body, (512), __nv_bfloat16)
SSD_TYPED(ssd_norm_wide_f32, norm_body, (512), float)
extern "C" __global__ void __launch_bounds__(256) ssd_pass(const Args a) {
  pass_body(a);
}
SSD_TYPED(ssd_step_prep_bf16, step_prep, (STEP_THREADS), __nv_bfloat16)
SSD_TYPED(ssd_step_prep_f32, step_prep, (STEP_THREADS), float)
SSD_WIDE(ssd_step_state_bf16_n128, step_state_body, (STEP_THREADS),
         __nv_bfloat16, 128)
SSD_WIDE(ssd_step_state_bf16_n16, step_state_body, (STEP_THREADS),
         __nv_bfloat16, 16)
SSD_WIDE(ssd_step_state_f32_n128, step_state_body, (STEP_THREADS), float, 128)
SSD_WIDE(ssd_step_state_f32_n16, step_state_body, (STEP_THREADS), float, 16)

namespace {

typedef void (*Kernel)(const Args);

// The SM count of the current device, read once a device.
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!counts[dev])
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

// Raise a kernel's dynamic shared-memory limit to the most any chunk
// needs, once a kernel and device.
void allow_smem(Kernel k, int slot) {
  static bool done[4][64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  const bool known = dev >= 0 && dev < 64;
  if (known && done[slot][dev]) return;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(scan_smem(QMAX)));
  if (known) done[slot][dev] = true;
}

// Heads a scan block takes (even): a whole group's, halved while the grid
// would leave SMs without a block (each halving computes S again).
int head_tile(int B, int NC, int its, int G, int hg) {
  const long long base = static_cast<long long>(B) * NC * its * G;
  int ht = (hg + 1) & ~1;
  while (ht > 2 && base * ((hg + ht - 1) / ht) < sm_count())
    ht = (ht / 2 + 1) & ~1;
  return ht;
}

// The gate and grouped RMSNorm over a.out, in place: 8 warps a block, or a
// slice's where it takes more.
cudaError_t launch_norm(const Args& a, int bf16, cudaStream_t s) {
  const int nw = norm_warps(a), warps = nw > 8 ? nw : 8;
  const Kernel norm_k =
      nw > 8 ? (bf16 ? ssd_norm_wide_bf16 : ssd_norm_wide_f32)
             : (bf16 ? ssd_norm_bf16 : ssd_norm_f32);
  const long long items = static_cast<long long>(a.B) * a.S * a.G;
  const int per = warps / nw;
  norm_k<<<static_cast<unsigned>((items + per - 1) / per), 32 * warps, 0,
           s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The five launches of one chunked mixer call on `stream`; 0, or the first
// CUDA error.  Shapes are the wrapper's to check (kernels/ssd.py).
extern "C" int ssd_mixer(const void* proj, const void* conv_w,
                         const void* conv_b, const float* a_log,
                         const float* dt_bias, const float* d_skip,
                         const void* scale, const unsigned char* valid,
                         const long long* rows, float* state_cache,
                         void* conv_cache, void* xbc, float* dtv, float* cs,
                         float* states, void* out, int B, int S, int NH,
                         int G, int N, int Q, float eps, int bf16,
                         int scale_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{proj, conv_w, conv_b, a_log, dt_bias, d_skip, scale, valid, rows,
         state_cache, conv_cache, xbc, dtv, cs, states, out};
  a.B = B; a.S = S; a.NH = NH; a.G = G; a.N = N; a.Q = Q; a.NC = S / Q;
  a.di = NH * HD;
  a.CD = a.di + 2 * G * N;
  a.P = a.di + a.CD + NH;
  a.eps = eps;
  a.scale_bf16 = scale_bf16;
  a.vec = a.P % 8 ? 1 : 8;
  const int its = (Q + TI - 1) / TI, hg = NH / G;
  a.HT = head_tile(B, a.NC, its, G, hg);
  const int n128 = N == 128;
  const int slot = 2 * bf16 + n128;
  const Kernel prep_k = bf16 ? ssd_prep_bf16 : ssd_prep_f32;
  const Kernel state_k = bf16 ? (n128 ? ssd_state_bf16_n128 : ssd_state_bf16_n16)
                              : (n128 ? ssd_state_f32_n128 : ssd_state_f32_n16);
  const Kernel scan_k = bf16 ? (n128 ? ssd_scan_bf16_n128 : ssd_scan_bf16_n16)
                             : (n128 ? ssd_scan_f32_n128 : ssd_scan_f32_n16);
  cudaError_t err;
  const int nprep = dt_blocks(a) + conv_blocks(a) + (conv_cache ? B : 0);
  prep_k<<<nprep, 256, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_k<<<state_blocks(a), 256, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_pass<<<dim3(B * NH, N * HD / 1024), 256, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  allow_smem(scan_k, slot);
  const int qp = (Q + KS - 1) / KS * KS;
  scan_k<<<dim3(B * a.NC * its, G * ((hg + a.HT - 1) / a.HT)), 256,
           scan_smem(qp), s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_norm(a, bf16, s);
}

// The three launches of one recurrent step on `stream` (prep, state, norm);
// 0, or the first CUDA error.  The state (B, NH, N, 64) and the conv window
// (B, KW - 1, CD) are the cache's rows 0 .. B - 1, written in place; xbc, dtv
// and da are the wrapper's scratch.  Shapes are the wrapper's to check.
extern "C" int ssd_step(const void* proj, const void* conv_w,
                        const void* conv_b, const float* a_log,
                        const float* dt_bias, const float* d_skip,
                        const void* scale, const unsigned char* valid,
                        float* state, void* conv, void* xbc, float* dtv,
                        float* da, void* out, int B, int NH, int G, int N,
                        float eps, int bf16, int scale_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{proj, conv_w, conv_b, a_log, dt_bias, d_skip, scale, valid, nullptr,
         state, conv, xbc, dtv, da, nullptr, out};
  a.B = B; a.S = 1; a.NH = NH; a.G = G; a.N = N; a.Q = 1; a.NC = 1;
  a.di = NH * HD;
  a.CD = a.di + 2 * G * N;
  a.P = a.di + a.CD + NH;
  a.eps = eps;
  a.scale_bf16 = scale_bf16;
  a.vec = a.P % 8 ? 1 : 8;
  const int n128 = N == 128;
  const Kernel prep_k = bf16 ? ssd_step_prep_bf16 : ssd_step_prep_f32;
  const Kernel state_k =
      bf16 ? (n128 ? ssd_step_state_bf16_n128 : ssd_step_state_bf16_n16)
           : (n128 ? ssd_step_state_f32_n128 : ssd_step_state_f32_n16);
  cudaError_t err;
  prep_k<<<step_dt_blocks(a) + step_conv_blocks(a), STEP_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  state_k<<<B * NH, STEP_THREADS, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_norm(a, bf16, s);
}
