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
// the reference's k_all.astype(cdt) without a copy of the cache.  P is
// rounded to q's type before P.V.
//
// The TPU kernel runs one (batch*head, 512-query block) per grid step
// over a repeated K/V, with Sq and Sk multiples of 512 and the whole K/V
// row in VMEM.  Here a block owns flat (token, head-in-group) query rows
// of one (batch, kv head), so every K/V tile staged in shared memory
// serves all H/KV query heads at once.  The block walks its keys in 64-key
// tiles and skips a tile none of whose keys any of its rows can see (the
// causal future of a prefill, the POS_SENTINEL tail of a cache, keys
// behind the window): skipping adds nothing and changes no m.  Flags per
// tile (skip / masked / every row sees every key, so no mask) are decided
// once per block for up to 64 tiles at a time, so every thread walks the
// same tiles.  Ragged Sq, Sk and hd are masked in the kernel (zero rows,
// positions past Sk never visible); nothing is padded in device memory.
//
// bf16 q (flash_fwd_mma), the serving path:
//  * a ring of float32 (or bf16) K/V tiles in shared memory filled by
//    cp.async (16-byte units, zero-fill past Sk and hd), the tile's kv
//    positions beside it: while tile i is multiplied, the next ones are in
//    flight.  Each thread converts exactly the units it copied (its own
//    cp.async.wait_group makes them visible), so the ring needs no barrier;
//    the pass rounds K and V to bf16 into the layout the products read;
//  * prefill at hd 64 / 80 (WG): blocks of 192 rows, three warpgroups of
//    64 rows on wgmma — S = Q K^T with Q and K K-major in shared memory,
//    O += P V with P re-packed from the S accumulators as register A
//    fragments and V the MN-major B operand, both in 128B- (hd 0..63) and
//    32B-swizzled (hd 64..79) layouts; a 3-stage ring and two bf16 tile
//    buffers, so one tile is rounded while the last one's P V runs;
//  * otherwise mma.sync m16n8k16 bf16 with float32 accumulators (Q in
//    registers, K by ldmatrix, V by ldmatrix.trans, rows padded to D + 8):
//    64-row blocks for decode and the split, 128-row blocks at hd 16 / 128;
//  * softmax in the log2 domain (ex2 of one FMA per score), the
//    accumulator rescaled only when a row's max moved;
//  * split-KV (flash-decoding): a call whose rows fit one 64-row block
//    (Sq * H/KV <= 64) and whose B * KV blocks would leave SMs idle splits
//    the keys into n_split ranges of whole tiles, by slot index (the cache
//    is a ring buffer).  Each block (split, kv head, batch) writes float32
//    partials (m, l, acc) — a split that sees nothing writes m = -1e30,
//    l = 0, acc = 0 — and flash_combine merges them: M = max m_i,
//    L = sum l_i e^(m_i - M), acc = sum acc_i e^(m_i - M).
// float32 q (flash_fwd_f32): the same walk on the CUDA cores (4 x 4
// register tiles of S, 32-key tiles staged synchronously), with the same
// split, for float32 models and the parity runs.
//
// What bounds it on an H100.  A decode step reads the visible K/V once:
// sum over slots of (pos + 1) * KV * hd * 4 B * 2 at 3.35 TB/s (0.0157 ms
// for four slots of qwen3-4b at 4095 / 3071 / 2047 / 1023) — bytes; the
// split puts 16 blocks on each (slot, kv head), 512 for 132 SMs.  A prefill
// does 4 * H * (visible pairs) * hd operations (2.15e10 for a 2048-token
// qwen3-4b prompt, 0.0217 ms at 989 TFLOP/s bf16) — operations; this
// design is held back by what shares the SM with the tensor cores: the
// softmax's exponentials (one MUFU.EX2 per score), the float32 -> bf16
// rounding pass and the per-thread copy instructions (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>


namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 64;               // keys per tile, bf16 path; split unit
constexpr int BKF = 32;              // keys per tile, float32 path
constexpr int ROWS_F32 = 64;         // query rows per block, float32 path
constexpr int TPW = 8;               // tiles per warp of one visibility pass
constexpr float NEG = -1e30f;        // the reference's masked score
constexpr int PAD_POS = 0x3fffffff;  // int32 max / 2: keys past Sk
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* kv_pos;
  void* out;
  float* lse;
  float* part_acc;   // (n_split, B, Sq, H, hd) when splitting, else null
  float2* part_ml;   // (n_split, B, H, Sq) of (m, l)
  int B, Sq, Sk, H, KV, hd, window, n_split, split_tiles;
  float scale, softcap;
  // the bf16 kernel's scores in the log2 domain: s * scale * log2(e), or
  // softcap * log2(e) * tanh(s * scale / softcap)
  float scale2, cap2, inv_cap;
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

// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

__device__ __forceinline__ void warp_minmax(int& lo, int& hi) {
  for (int o = 1; o < 32; o <<= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// cp.async of 16 (4) bytes; src_bytes = 0 fills the destination with zeros
// (and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
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

__device__ __forceinline__ bool keep(const Args& a, bool valid, int pos,
                                     int kp) {
  return valid && pos >= kp && (a.window <= 0 || pos - kp < a.window);
}

// What one block computes: batch b, kv head kvh, rows R0 .. R0+ROWS-1, keys
// [key_lo, key_hi) of split `split`.  Row blocks run last-first, so the
// longest causal walks start first.
struct Work {
  int b, kvh, R0, split, key_lo, key_hi;
};

template <int ROWS>
__device__ __forceinline__ Work work_of(const Args& a) {
  const int row_blocks = (a.Sq * (a.H / a.KV) + ROWS - 1) / ROWS;
  Work w;
  w.b = blockIdx.z;
  w.kvh = blockIdx.y;
  w.split = blockIdx.x % a.n_split;
  w.R0 = (row_blocks - 1 - (int)(blockIdx.x / a.n_split)) * ROWS;
  w.key_lo = w.split * a.split_tiles * BK;
  w.key_hi = min(a.Sk, w.key_lo + a.split_tiles * BK);
  return w;
}

// The end of a row: out and lse, or the split's float32 partials.
__device__ __forceinline__ void write_stats(const Args& a, const Work& w,
                                            const Row& r, float m, float l) {
  if (a.part_ml != nullptr) {
    a.part_ml[(((int64_t)w.split * a.B + w.b) * a.H + r.head) * a.Sq +
              r.tok] = make_float2(m, l);
  } else {
    a.lse[((int64_t)w.b * a.H + r.head) * a.Sq + r.tok] =
        m + logf(fmaxf(l, 1e-20f));
  }
}

__device__ __forceinline__ float* part_row(const Args& a, const Work& w,
                                           const Row& r) {
  return a.part_acc +
         ((((int64_t)w.split * a.B + w.b) * a.Sq + r.tok) * a.H + r.head) *
             a.hd;
}

// Smallest and largest position of the block's valid query rows, computed
// by every warp alike (so every warp takes the same tile decisions).
template <int ROWS>
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

// Whether some row with a position in [qmin, qmax] may see some key with a
// position in [kmin, kmax]: no when every key lies after every row, or
// (with a window) a full window or more behind every row.
__device__ __forceinline__ bool visible(const Args& a, int kmin, int kmax,
                                        int qmin, int qmax) {
  if (kmin > qmax) return false;
  if (a.window > 0 && (int64_t)kmax <= (int64_t)qmin - a.window) return false;
  return true;
}

// Whether every row with a position in [qmin, qmax] sees every key with a
// position in [kmin, kmax] (the tile needs no mask).
__device__ __forceinline__ bool all_visible(const Args& a, int kmin, int kmax,
                                            int qmin, int qmax) {
  return kmax <= qmin &&
         (a.window <= 0 || (int64_t)qmax - kmin < a.window);
}

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
  warp_minmax(kmin, kmax);
  return visible(a, kmin, kmax, qmin, qmax);
}

// Stage keys [j0, j0 + N) of one kv head (N x D, zero past Sk and past hd)
// into shared memory, 8 elements per unit: all loads first, then the
// stores, so a thread keeps its loads in flight together (float32 path).
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

// Stores of one staged unit as float32 (rows of STRIDE elements).
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

// ---------------------------------------------------------------------------
// Hopper warpgroup products (wgmma), for the prefill blocks of hd 64 and 80.
// A tile of R rows (query rows, or keys) and hd columns lies in shared
// memory as two swizzled regions: columns 0..63 in 128-byte rows (8-row
// groups of 1024 B, the 16-byte chunks of row r XOR-ed with r % 8: wgmma's
// 128B swizzle), then columns 64..79 in 32-byte rows (8-row groups of 256 B,
// chunk ^ (r % 8) / 4: the 32B swizzle).  Q and K are K-major A / B
// operands of S = Q K^T (hd is the reduction); V, stored alike with rows =
// keys, is the MN-major B operand of P V, transposed by the instruction —
// so the rounding pass writes K and V the same way.
// ---------------------------------------------------------------------------
__device__ __forceinline__ int sw_offset(int r, int c, int rows) {
  if (c < 64)
    return (r / 8) * 1024 + (r % 8) * 128 + ((c / 8) ^ (r % 8)) * 16 +
           (c % 8) * 2;
  c -= 64;
  return rows * 128 + (r / 8) * 256 + (r % 8) * 32 +
         ((c / 8) ^ ((r % 8) >> 2)) * 16 + (c % 8) * 2;
}

constexpr int SW128 = 1, SW32 = 3;   // descriptor layout types

// Shared-memory matrix descriptor: start address, leading- and
// stride-dimension byte offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo, int sbo,
                                              int mode) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)mode << 62;
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

// generic-proxy stores to shared memory -> visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// S (64 rows x 64 keys, float32) += A . B^T for one k16 step, A and B
// K-major in shared memory (scale_d = 0 starts the sum).
__device__ __forceinline__ void wgmma_s(float (&d)[8][4], uint64_t da,
                                        uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 rows x N, float32) += P . V for one k16 step: P from registers (the
// mma.sync A-fragment layout), V MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_o(float (&d)[N / 8][4],
                                        const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_o<64>(float (&d)[8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_o<16>(float (&d)[2][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// bf16 q: tensor cores.  Warp w owns rows 16·RT·w .. 16·RT·(w+1) - 1 in RT
// tiles of 16; thread (g, t) = (lane / 4, lane % 4) holds, per tile and
// 8-wide column block, rows g and g + 8 at columns 2t and 2t + 1 (the m16n8
// accumulator layout, which is also wgmma's per warp).  WG (warpgroup
// mode, RT = 1): S and P.V by wgmma, warps 4i .. 4i+3 making warpgroup i
// and its 64 rows; else mma.sync with Q in registers, K by ldmatrix, V by
// ldmatrix.trans.
// ---------------------------------------------------------------------------
// Dynamic shared memory of flash_fwd_mma, in bytes: the ring (per stage K
// units, V units, kv positions), the bf16 K and V tiles (mma.sync: one
// pair, rows padded to D + 8, Q staged there before the walk; wgmma: two
// pairs in the swizzled layout, so one tile is rounded while the last is
// multiplied, and Q's rows after them), the positions of the tiles in
// use, the visibility flags, the rows' visible position ranges and the
// warps' position ranges.
template <int D, typename KT, int ROWS, int CH, bool WG>
struct MmaSmem {
  static constexpr int STR = D + 8;             // mma.sync bf16 row stride
  static constexpr int UE = 16 / sizeof(KT);    // elements per 16-byte unit
  static constexpr int UNITS = BK * D / UE;     // units of one K (V) tile
  static constexpr int STAGES = WG ? 3 : 2;     // K/V tiles in flight
  static constexpr int BUFS = WG ? 2 : 1;       // bf16 K/V tiles
  static constexpr int STAGE = 2 * 16 * UNITS + 4 * BK;
  static constexpr int KVB = (STAGES * STAGE + 1023) / 1024 * 1024;
  static constexpr int TILE = WG ? 2 * BK * D : 2 * BK * STR;  // one of K, V
  static constexpr int QB = KVB + BUFS * 2 * TILE;   // wgmma: Q
  static constexpr int KP = QB + (WG ? 2 * ROWS * D : 0);
  static constexpr int VIS = KP + BUFS * 4 * BK;
  static constexpr int ROWB = VIS + 4 * CH;     // int2 (lo, hi) per row
  static constexpr int QW = ROWB + 8 * ROWS;    // int2 per warp
  static constexpr int BYTES = QW + 8 * 8;
};

template <int D, typename KT, int NW, int RT, bool WG>
__global__ void __launch_bounds__(32 * NW)
flash_fwd_mma(const Args a) {
  constexpr int NT = 32 * NW;
  constexpr int ROWS = 16 * RT * NW;
  constexpr int CH = TPW * NW;        // tiles one visibility pass flags
  using L = MmaSmem<D, KT, ROWS, CH, WG>;
  constexpr int STAGES = L::STAGES;
  constexpr int STR = L::STR;
  constexpr int NB = D / 8;           // 8-wide column blocks of the output
  constexpr int KS = D / 16;          // k-steps of Q.K^T
  constexpr int UPR = D / L::UE;      // 16-byte units per key row
  constexpr int RPI = NT / UPR;       // key rows per pass of the block
  constexpr int ITERS = (BK + RPI - 1) / RPI;
  static_assert(WG || ROWS <= 2 * BK, "Q is staged in the K and V tiles");
  static_assert(!WG || (NW % 4 == 0 && RT == 1), "warpgroups of 64 rows");
  extern __shared__ __align__(1024) unsigned char smem[];
  // bf16 tiles of buffer i: K at KVB + 2i·TILE, V one TILE after it
  auto tileK = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L::KVB + 2 * i * L::TILE);
  };
  auto tileV = [&](int i) {
    return reinterpret_cast<__nv_bfloat16*>(smem + L::KVB +
                                            (2 * i + 1) * L::TILE);
  };
  __nv_bfloat16* sK = tileK(0);
  unsigned char* sQ = smem + L::QB;
  int* sKP = reinterpret_cast<int*>(smem + L::KP);
  int* sVis = reinterpret_cast<int*>(smem + L::VIS);
  int2* sRow = reinterpret_cast<int2*>(smem + L::ROWB);
  int2* sQw = reinterpret_cast<int2*>(smem + L::QW);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the block row of this thread's row g (+8 for hr = 1) of row tile rt
  // (wgmma: warpgroup i owns rows 64i .. 64i+63, warp 4i + j rows 16j ..)
  auto brow = [&](int rt, int hr) {
    return 16 * (RT * warp + rt) + g + 8 * hr;
  };
  const Work w = work_of<ROWS>(a);
  const int b = w.b, kvh = w.kvh;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);

  // which of tiles c0 .. c1-1 (at most CH) some row may see (flag 0: skip)
  // and which need no mask (2); the positions of a warp's TPW tiles are
  // loaded together, then reduced per tile
  int qmin = 0, qmax = 0;
  auto tile_bounds = [&](int c0, int c1, int (&lo)[TPW], int (&hi)[TPW]) {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int tt = c0 + warp * TPW + i;
      const int p0 = tt < c1 ? kv_pos_at(a, b, tt * BK + lane) : PAD_POS;
      const int p1 = tt < c1 ? kv_pos_at(a, b, tt * BK + lane + 32) : PAD_POS;
      lo[i] = min(p0, p1);
      hi[i] = max(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < TPW; ++i) warp_minmax(lo[i], hi[i]);
  };
  auto write_flags = [&](int c0, int c1, const int (&lo)[TPW],
                         const int (&hi)[TPW]) {
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < TPW; ++i)
        sVis[warp * TPW + i] =
            c0 + warp * TPW + i >= c1 ? 0
            : !visible(a, lo[i], hi[i], qmin, qmax) ? 0
            : all_visible(a, lo[i], hi[i], qmin, qmax) ? 2 : 1;
  };
  const int t_lo = w.key_lo / BK, t_hi = (w.key_hi + BK - 1) / BK;

  // Before the walk, with all global loads issued together: Q's rows to
  // shared memory (wgmma: where the products read them; mma.sync: then A
  // fragments in registers), each row's visible positions (lo, hi] to
  // sRow, the block's smallest and largest row position, and the flags of
  // the first CH tiles.  The mask of rows past Sq * G does not matter (they
  // are never written).
  {
    constexpr int QIT = (ROWS * (D / 8) + NT - 1) / NT;
    static_assert(ROWS <= NT, "one row per thread");
    const int G = a.H / a.KV;
    uint4 x[QIT];
#pragma unroll
    for (int it = 0; it < QIT; ++it) {
      const int u = tid + NT * it, r = u / (D / 8), c = 8 * (u % (D / 8));
      const int R = w.R0 + r;
      x[it] = make_uint4(0, 0, 0, 0);
      if (u < ROWS * (D / 8) && R < a.Sq * G && c < a.hd)
        x[it] = *reinterpret_cast<const uint4*>(
            q + (((int64_t)b * a.Sq + R / G) * a.H + kvh * G + R % G) * a.hd +
            c);
    }
    const bool valid = tid < ROWS && w.R0 + tid < a.Sq * G;
    const int pos =
        valid ? a.q_pos[(int64_t)b * a.Sq + (w.R0 + tid) / G] : 0;
    int lo[TPW], hi[TPW];
    tile_bounds(t_lo, min(t_lo + CH, t_hi), lo, hi);
#pragma unroll
    for (int it = 0; it < QIT; ++it) {
      const int u = tid + NT * it, r = u / (D / 8), c = 8 * (u % (D / 8));
      if (u < ROWS * (D / 8))
        *reinterpret_cast<uint4*>(
            WG ? sQ + sw_offset(r, c, ROWS)
               : reinterpret_cast<unsigned char*>(sK + r * STR + c)) = x[it];
    }
    if (tid < ROWS)
      sRow[tid] = make_int2(
          a.window > 0 ? max(pos, INT_MIN + a.window) - a.window : INT_MIN,
          pos);
    int pmin = valid ? pos : INT_MAX, pmax = valid ? pos : INT_MIN;
    warp_minmax(pmin, pmax);
    if (lane == 0) sQw[warp] = make_int2(pmin, pmax);
    if constexpr (WG) fence_async_smem();
    __syncthreads();
    qmin = INT_MAX;
    qmax = INT_MIN;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      qmin = min(qmin, sQw[i].x);
      qmax = max(qmax, sQw[i].y);
    }
    write_flags(t_lo, min(t_lo + CH, t_hi), lo, hi);
  }
  uint32_t qa[WG ? 1 : RT][WG ? 1 : KS][4];
  if constexpr (!WG) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      const __nv_bfloat16* r0 = &sK[brow(rt, 0) * STR + 2 * t];
      const __nv_bfloat16* r1 = r0 + 8 * STR;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[rt][kk][0] = *reinterpret_cast<const uint32_t*>(r0 + 16 * kk);
        qa[rt][kk][1] = *reinterpret_cast<const uint32_t*>(r1 + 16 * kk);
        qa[rt][kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 16 * kk + 8);
        qa[rt][kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 16 * kk + 8);
      }
    }
  }
  __syncthreads();   // flags written; mma.sync: Q read before the tiles
  // a warp (wgmma: a warpgroup) with no valid row skips the products
  const bool active =
      w.R0 + (WG ? 64 * (warp / 4) : 16 * RT * warp) < a.Sq * (a.H / a.KV);

  float m[RT][2], l[RT][2];
  float acc[RT][NB][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    m[rt][0] = m[rt][1] = NEG;
    l[rt][0] = l[rt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][n][e] = 0.f;
  }

  // cp.async of tile tt into ring stage st: this thread's units of K and
  // V, and (threads < BK) one kv position each.  Thread tid owns column
  // unit tid % UPR of key rows tid / UPR + RPI·it, so its addresses step by
  // a constant and a warp reads whole rows.
  const int ukey = tid / UPR, ucol = (tid % UPR) * L::UE;
  const bool uown = tid < RPI * UPR && ucol < a.hd;
  const int64_t kv_row = (int64_t)a.KV * a.hd;
  const int64_t kv_at = ((int64_t)b * a.Sk * a.KV + kvh) * a.hd + ucol;
  const int uring = 16 * (ukey * UPR + tid % UPR);
  auto issue = [&](int tt, int st) {
    unsigned char* ring = smem + st * L::STAGE;
    const int j0 = tt * BK;
    const int64_t at = kv_at + (int64_t)(j0 + ukey) * kv_row;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int key = ukey + RPI * it;
      if (tid < RPI * UPR && key < BK) {
        const bool ok = uown && j0 + key < a.Sk;
        const int64_t off = ok ? at + RPI * it * kv_row : 0;
        unsigned char* dst = ring + uring + 16 * UPR * RPI * it;
        cp_async16(dst, k + off, ok ? 16 : 0);
        cp_async16(dst + 16 * L::UNITS, v + off, ok ? 16 : 0);
      }
    }
    if (tid < BK) {
      const bool ok = j0 + tid < a.Sk;
      cp_async4(ring + 32 * L::UNITS + 4 * tid,
                a.kv_pos + (ok ? (int64_t)b * a.Sk + j0 + tid : 0),
                ok ? 4 : 0);
    }
  };
  // the units this thread copied into stage st, rounded to bf16 into the
  // K / V tiles of buffer buf; positions past Sk become PAD_POS
  auto convert = [&](int tt, int st, int buf) {
    const unsigned char* ring = smem + st * L::STAGE;
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int key = ukey + RPI * it;
      if (tid < RPI * UPR && key < BK) {
        const int at = WG ? sw_offset(key, ucol, BK) : 2 * (key * STR + ucol);
        const unsigned char* src = ring + uring + 16 * UPR * RPI * it;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          unsigned char* dst = reinterpret_cast<unsigned char*>(
                                   kv ? tileV(buf) : tileK(buf)) + at;
          if constexpr (sizeof(KT) == 4) {
            const float4 x =
                *reinterpret_cast<const float4*>(src + kv * 16 * L::UNITS);
            *reinterpret_cast<uint2*>(dst) =
                make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
          } else {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src + kv * 16 * L::UNITS);
          }
        }
      }
    }
    if (tid < BK)
      sKP[BK * buf + tid] =
          tt * BK + tid < a.Sk
              ? reinterpret_cast<const int*>(ring + 32 * L::UNITS)[tid]
              : PAD_POS;
    if constexpr (WG) fence_async_smem();
  };

  // scale (softcap), the mask unless every row sees every key (`full`),
  // then the online softmax step of row tile rt (16 rows of this warp) on
  // S in registers; P is left in s.  Scores are in the log2 domain (sc
  // takes a raw score there, folded into the exponent's FMA; softcapped
  // scores are there already); a row that has seen no key yet keeps m =
  // NEG and gets p = 2^(NEG - 0) = 0.
  auto softmax = [&](float (&s)[BK / 8][4], int rt, bool full,
                     const int* kpos) {
    float sc = a.scale2;
    if (a.softcap > 0.f) {
      sc = 1.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = a.cap2 * tanhf(s[j][e] * a.inv_cap);
    }
    if (!full) {
      const int2 rb[2] = {sRow[brow(rt, 0)], sRow[brow(rt, 1)]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int kp[2] = {kpos[8 * j + 2 * t], kpos[8 * j + 2 * t + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kp[e & 1] > rb[e / 2].y || kp[e & 1] <= rb[e / 2].x)
            s[j][e] = NEG;
      }
    }
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    float corr[2], mu[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float tile_max = warp_max(mx[hr], 4);
      const float m_new =
          tile_max == NEG ? m[rt][hr] : fmaxf(m[rt][hr], tile_max * sc);
      mu[hr] = m_new == NEG ? 0.f : m_new;
      corr[hr] = ex2(m[rt][hr] - mu[hr]);
      m[rt][hr] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], sc, -mu[e / 2]));
        ps[e / 2] += s[j][e];
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[rt][hr] = l[rt][hr] * corr[hr] + ps[hr];
    // the running max moves in few tiles: rescale only when it did
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        acc[rt][n][0] *= corr[0];
        acc[rt][n][1] *= corr[0];
        acc[rt][n][2] *= corr[1];
        acc[rt][n][3] *= corr[1];
      }
    }
  };

  for (int c0 = t_lo; c0 < t_hi; c0 += CH) {
    const int c1 = min(c0 + CH, t_hi);
    if (c0 != t_lo) {   // the first chunk's flags came with the prologue
      int lo[TPW], hi[TPW];
      tile_bounds(c0, c1, lo, hi);
      write_flags(c0, c1, lo, hi);
      __syncthreads();
    }
    auto next = [&](int tt) {
      while (tt < c1 && !sVis[tt - c0]) ++tt;
      return tt;
    };

    int t_in = next(c0);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      if (t_in < c1) {
        issue(t_in, st);
        t_in = next(t_in + 1);
      }
      cp_async_commit();
    }
    int st = 0, buf = 0;
    for (int tt = next(c0); tt < c1; tt = next(tt + 1)) {
      cp_async_wait<STAGES - 1>();      // this thread's units of tile tt
      convert(tt, st, buf);
      if (t_in < c1) {                   // refill the stage just read
        issue(t_in, st);
        t_in = next(t_in + 1);
      }
      cp_async_commit();
      st = st + 1 == STAGES ? 0 : st + 1;
      // wgmma: the last tile's P V ran on while this one was rounded; it
      // must end before the barrier frees its buffer
      if constexpr (WG) {
        wgmma_wait_all();
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) pin(acc[rt]);
      }
      // tile tt is complete in buffer buf; with two buffers, every warp is
      // also done with the products that read the other one, which the
      // next pass overwrites
      __syncthreads();
      const bool full = sVis[tt - c0] == 2;
      const __nv_bfloat16* sK = tileK(buf);
      const __nv_bfloat16* sV = tileV(buf);
      const int* kpos = sKP + BK * buf;
      if constexpr (L::BUFS == 2) buf ^= 1;

      if (active) {
        float s[RT][BK / 8][4];
        if constexpr (WG) {
          // S = Q K^T: the 64 rows of this warpgroup x 64 keys.  K-major
          // operands: k16 steps 0..3 in the 128B-swizzled columns (32 B
          // apart), step 4 (hd 80) in the 32B-swizzled ones
          const unsigned char* kt = reinterpret_cast<const unsigned char*>(sK);
          const int r0 = 64 * (warp / 4);
          const uint64_t dk[2] = {gmma_desc(kt, 16, 1024, SW128),
                                  gmma_desc(kt + BK * 128, 16, 256, SW32)};
          const uint64_t dq[2] = {
              gmma_desc(sQ + r0 * 128, 16, 1024, SW128),
              gmma_desc(sQ + ROWS * 128 + r0 * 32, 16, 256, SW32)};
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_s(s[0], dq[kk / 4] + 2 * (kk % 4), dk[kk / 4] + 2 * (kk % 4),
                    kk);
          wgmma_commit();
          wgmma_wait_all();
          pin(s[0]);
          softmax(s[0], 0, full, kpos);
          // O += P V: V MN-major, 8-key groups 1024 B (columns 0..63) / 256
          // B (64..79) apart; a k16 step is two groups
          const unsigned char* vt = reinterpret_cast<const unsigned char*>(sV);
          const uint64_t dv[2] = {gmma_desc(vt, 16, 1024, SW128),
                                  gmma_desc(vt + BK * 128, 16, 256, SW32)};
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint32_t pa[4] = {
                pack_bf16(s[0][2 * kk][0], s[0][2 * kk][1]),
                pack_bf16(s[0][2 * kk][2], s[0][2 * kk][3]),
                pack_bf16(s[0][2 * kk + 1][0], s[0][2 * kk + 1][1]),
                pack_bf16(s[0][2 * kk + 1][2], s[0][2 * kk + 1][3])};
            wgmma_o<64>(reinterpret_cast<float(&)[8][4]>(acc[0][0]), pa,
                        dv[0] + kk * 2 * 1024 / 16);
            if constexpr (D == 80)
              wgmma_o<16>(reinterpret_cast<float(&)[2][4]>(acc[0][8]), pa,
                          dv[1] + kk * 2 * 256 / 16);
          }
          wgmma_commit();
          // P V is waited for after the next tile's rounding
        } else {
          // S = Q K^T for RT x 16 rows x 64 keys; each K fragment
          // (ldmatrix: lanes 8i .. 8i+7 address matrix i, columns +8 for
          // odd i, keys +8 for i >= 2) feeds every row tile
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[rt][j][e] = 0.f;
          const int mi = lane / 8;
          const __nv_bfloat16* kr =
              &sK[(lane % 8 + 8 * (mi >> 1)) * STR + 8 * (mi & 1)];
#pragma unroll
          for (int j = 0; j < BK / 8; j += 2)
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              uint32_t kb[4];
              ldmatrix_x4(kb, kr + 8 * j * STR + 16 * kk);
#pragma unroll
              for (int rt = 0; rt < RT; ++rt) {
                mma_bf16(s[rt][j], qa[rt][kk], kb[0], kb[1]);
                mma_bf16(s[rt][j + 1], qa[rt][kk], kb[2], kb[3]);
              }
            }
#pragma unroll
          for (int rt = 0; rt < RT; ++rt) softmax(s[rt], rt, full, kpos);
          // acc += P V: P (rounded to bf16) from the S registers, each V
          // fragment (ldmatrix.trans: matrix i keys +8 for odd i, columns
          // +8 for i >= 2) feeding every row tile
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t pa[RT][4];
#pragma unroll
            for (int rt = 0; rt < RT; ++rt) {
              pa[rt][0] = pack_bf16(s[rt][2 * kk][0], s[rt][2 * kk][1]);
              pa[rt][1] = pack_bf16(s[rt][2 * kk][2], s[rt][2 * kk][3]);
              pa[rt][2] =
                  pack_bf16(s[rt][2 * kk + 1][0], s[rt][2 * kk + 1][1]);
              pa[rt][3] =
                  pack_bf16(s[rt][2 * kk + 1][2], s[rt][2 * kk + 1][3]);
            }
            const __nv_bfloat16* vr =
                &sV[(16 * kk + lane % 8 + 8 * (mi & 1)) * STR +
                    8 * (mi >> 1)];
#pragma unroll
            for (int n = 0; n < NB; n += 2) {
              uint32_t bv[4];
              ldmatrix_x4_trans(bv, vr + 8 * n);
#pragma unroll
              for (int rt = 0; rt < RT; ++rt) {
                mma_bf16(acc[rt][n], pa[rt], bv[0], bv[1]);
                mma_bf16(acc[rt][n + 1], pa[rt], bv[2], bv[3]);
              }
            }
          }
        }
      }
      if constexpr (L::BUFS == 1) __syncthreads();  // the tiles are refilled
    }
    if constexpr (WG) {
      wgmma_wait_all();
#pragma unroll
      for (int rt = 0; rt < RT; ++rt) pin(acc[rt]);
    }
    cp_async_wait<0>();
    __syncthreads();   // sVis is rewritten by the next pass
  }

  if (!active) return;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float lt = warp_sum(l[rt][hr], 4);
      const Row row = row_of(a, b, kvh, w.R0 + brow(rt, hr));
      if (!row.valid) continue;
      if (a.part_acc != nullptr) {
        float* o = part_row(a, w, row);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const int c = 8 * n + 2 * t;
          if (c < a.hd)
            *reinterpret_cast<float2*>(o + c) =
                make_float2(acc[rt][n][2 * hr], acc[rt][n][2 * hr + 1]);
        }
      } else {
        const float inv = 1.f / fmaxf(lt, 1e-20f);
        __nv_bfloat16* o =
            out + (((int64_t)b * a.Sq + row.tok) * a.H + row.head) * a.hd;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          const int c = 8 * n + 2 * t;
          if (c < a.hd)
            *reinterpret_cast<uint32_t*>(o + c) = pack_bf16(
                acc[rt][n][2 * hr] * inv, acc[rt][n][2 * hr + 1] * inv);
        }
      }
      if (t == 0)
        write_stats(a, w, row, m[rt][hr] == NEG ? NEG : m[rt][hr] * LN2, lt);
    }
}

// ---------------------------------------------------------------------------
// float32 q: CUDA cores.  Thread (ty, tx) = (tid / 8, tid % 8) owns rows
// 4ty .. 4ty+3, keys tx + 8jj of each 32-key tile and output columns
// tx + 8c; a row's 8 owners are 8 neighbouring lanes of one warp.
// ---------------------------------------------------------------------------
template <int D>
constexpr int f32_smem_bytes() {
  return 4 * (ROWS_F32 * (D + 1) + BKF * (D + 1) + BKF * D + BKF);
}

template <int D, typename KT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const Args a) {
  constexpr int QS = D + 1, KS = D + 1;   // padded row strides
  constexpr int NC = D / 8;
  extern __shared__ float smem_f[];
  float* sQ = smem_f;
  float* sK = sQ + ROWS_F32 * QS;
  float* sV = sK + BKF * KS;
  int* sKP = reinterpret_cast<int*>(sV + BKF * D);

  const int lane = threadIdx.x % 32;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const Work w = work_of<ROWS_F32>(a);
  const int b = w.b, kvh = w.kvh;
  const float* q = static_cast<const float*>(a.q);
  const KT* k = static_cast<const KT*>(a.k);
  const KT* v = static_cast<const KT*>(a.v);

  for (int u = threadIdx.x; u < ROWS_F32 * (D / 8); u += THREADS) {
    const int r = u / (D / 8), c = 8 * (u % (D / 8));
    const Row row = row_of(a, b, kvh, w.R0 + r);
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row.valid && c < a.hd)
      load8(q + (((int64_t)b * a.Sq + row.tok) * a.H + row.head) * a.hd + c,
            x);
    StoreF32<QS>{sQ}(r, c, x);
  }

  Row rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = row_of(a, b, kvh, w.R0 + 4 * ty + i);
  int qmin, qmax;
  block_qpos_range<ROWS_F32>(a, b, kvh, w.R0, lane, qmin, qmax);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = w.key_lo; j0 < w.key_hi; j0 += BKF) {
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
        if (keep(a, rows[i].valid, rows[i].pos, sKP[tx + 8 * jj])) {
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
    const float inv = a.part_acc != nullptr ? 1.f : 1.f / fmaxf(lt, 1e-20f);
    float* o = a.part_acc != nullptr
                   ? part_row(a, w, row)
                   : out + (((int64_t)b * a.Sq + row.tok) * a.H + row.head) *
                               a.hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (tx + 8 * c < a.hd) o[tx + 8 * c] = acc[i][c] * inv;
    if (tx == 0) write_stats(a, w, row, m[i], lt);
  }
}

// ---------------------------------------------------------------------------
// Merge of the split partials: one warp per (batch, token, head) row.
// ---------------------------------------------------------------------------
template <typename OT>
__global__ void __launch_bounds__(THREADS)
flash_combine(const float* part_acc, const float2* part_ml, OT* out,
              float* lse, int n_split, int B, int Sq, int H, int hd) {
  const int64_t rows = (int64_t)B * Sq * H;
  const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int head = (int)(row % H);
  const int64_t bt = row / H;
  const int tok = (int)(bt % Sq), b = (int)(bt / Sq);
  // part_ml (n_split, B, H, Sq); part_acc (n_split, B, Sq, H, hd)
  const int64_t ml0 = ((int64_t)b * H + head) * Sq + tok;
  const int64_t ml_step = (int64_t)B * H * Sq;
  // lane i holds split i0 + i: M and the weights by shuffles, the loads
  // of all splits' columns independent of each other
  float M = NEG;
  for (int i = lane; i < n_split; i += 32)
    M = fmaxf(M, part_ml[ml0 + i * ml_step].x);
  M = warp_max(M, 32);
  float L = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i0 = 0; i0 < n_split; i0 += 32) {
    const int n = min(32, n_split - i0);
    const float2 ml = lane < n ? part_ml[ml0 + (i0 + lane) * ml_step]
                               : make_float2(NEG, 0.f);
    const float wt = lane < n ? expf(ml.x - M) : 0.f;
    L += ml.y * wt;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, wt, j);
      const float* p = part_acc + ((int64_t)(i0 + j) * rows + row) * hd;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (lane + 32 * c < hd) acc[c] += p[lane + 32 * c] * wj;
    }
  }
  L = warp_sum(L, 32);
  const float inv = 1.f / fmaxf(L, 1e-20f);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (lane + 32 * j < hd) {
      if constexpr (sizeof(OT) == 2)
        out[row * hd + lane + 32 * j] = __float2bfloat16_rn(acc[j] * inv);
      else
        out[row * hd + lane + 32 * j] = acc[j] * inv;
    }
  if (lane == 0) lse[ml0] = M + logf(fmaxf(L, 1e-20f));
}

// Raise a kernel's dynamic shared-memory limit, once per kernel and device
// (a host-side call that need not repeat on every launch).
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

template <int D, typename KT, int NW, int RT, bool WG>
int launch_mma(const Args& a, cudaStream_t s) {
  constexpr int rows = 16 * RT * NW;
  constexpr int bytes = MmaSmem<D, KT, rows, TPW * NW, WG>::BYTES;
  const int G = a.H / a.KV;
  const dim3 grid(
      (unsigned)(((int64_t)a.Sq * G + rows - 1) / rows * a.n_split), a.KV,
      a.B);
  allow_smem<flash_fwd_mma<D, KT, NW, RT, WG>>(bytes);
  flash_fwd_mma<D, KT, NW, RT, WG><<<grid, 32 * NW, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int D, typename KT>
int launch_d(const Args& a, bool q_bf16, cudaStream_t s) {
  if (!q_bf16) {
    const int G = a.H / a.KV;
    const dim3 grid((unsigned)(((int64_t)a.Sq * G + ROWS_F32 - 1) / ROWS_F32 *
                               a.n_split),
                    a.KV, a.B);
    constexpr int bytes = f32_smem_bytes<D>();
    allow_smem<flash_fwd_f32<D, KT>>(bytes);
    flash_fwd_f32<D, KT><<<grid, THREADS, bytes, s>>>(a);
    return (int)cudaGetLastError();
  }
  // 64-row mma.sync blocks for calls that fit one (decode, the split);
  // otherwise 192 rows on three wgmma warpgroups at hd 64 and 80, and
  // 128-row mma.sync blocks at hd 128 (one row tile per warp: two would not
  // fit the registers) and hd 16 (two)
  if ((int64_t)a.Sq * (a.H / a.KV) <= 16 * WARPS)
    return launch_mma<D, KT, 4, 1, false>(a, s);
  if constexpr (D == 64 || D == 80)
    return launch_mma<D, KT, 12, 1, true>(a, s);
  else if constexpr (D == 128)
    return launch_mma<D, KT, 8, 1, false>(a, s);
  else
    return launch_mma<D, KT, 4, 2, false>(a, s);
}

// flash_combine over n_split partials -> out (bf16 or float32) and lse.
int launch_combine(const float* part_acc, const float2* ml, void* out,
                   float* lse, int n_split, int B, int Sq, int H, int hd,
                   bool out_bf16, cudaStream_t s) {
  const int64_t rows = (int64_t)B * Sq * H;
  const unsigned grid = (unsigned)((rows + WARPS - 1) / WARPS);
  if (out_bf16)
    flash_combine<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        part_acc, ml, static_cast<__nv_bfloat16*>(out), lse, n_split, B, Sq,
        H, hd);
  else
    flash_combine<float><<<grid, THREADS, 0, s>>>(
        part_acc, ml, static_cast<float*>(out), lse, n_split, B, Sq, H, hd);
  return (int)cudaGetLastError();
}

// Makes `device` current for one entry point's launches and restores the
// caller's device after (a no-op when it already is current).
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

template <typename KT>
int launch_kt(const Args& a, bool q_bf16, cudaStream_t s) {
  if (a.hd <= 16) return launch_d<16, KT>(a, q_bf16, s);
  if (a.hd <= 64) return launch_d<64, KT>(a, q_bf16, s);
  if (a.hd <= 80) return launch_d<80, KT>(a, q_bf16, s);
  if (a.hd <= 128) return launch_d<128, KT>(a, q_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  The Python wrapper checks
// shapes, types (q bf16 or float32; k and v float32 or bf16, alike),
// hd % 8 == 0 and hd <= 128, 16-byte alignment, device and contiguity, and
// allocates the partials.  Each launches on `device` (made current for the
// call) and returns cudaGetLastError() after its launches.
//
// flash_attention_fwd: n_split == 1 writes out and lse (part_* null);
// n_split > 1 writes the partials of the key ranges [i * split_tiles * 64,
// (i + 1) * split_tiles * 64) ∩ [0, Sk), every one of them non-empty, and
// needs Sq * H / KV <= 64, then merges them into out and lse with
// flash_combine on the same stream: one host call for both launches.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const int* q_pos,
                                   const int* kv_pos, void* out, float* lse,
                                   float* part_acc, float* part_ml, int B,
                                   int Sq, int Sk, int H, int KV, int hd,
                                   int window, int n_split, int split_tiles,
                                   float scale, float softcap, int q_bf16,
                                   int kv_bf16, int device, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || hd % 8 != 0 || hd > 128 || Sk < 1 ||
      n_split < 1 || split_tiles < 1 ||
      (int64_t)n_split * split_tiles * BK < Sk ||
      (int64_t)(n_split - 1) * split_tiles * BK >= Sk ||
      (n_split > 1) != (part_acc != nullptr && part_ml != nullptr) ||
      (n_split > 1 && (int64_t)Sq * (H / KV) > 16 * WARPS))
    return (int)cudaErrorInvalidValue;
  const Args a{q,
               k,
               v,
               q_pos,
               kv_pos,
               out,
               lse,
               part_acc,
               reinterpret_cast<float2*>(part_ml),
               B,
               Sq,
               Sk,
               H,
               KV,
               hd,
               window,
               n_split,
               split_tiles,
               scale,
               softcap,
               scale * LOG2E,
               softcap * LOG2E,
               softcap > 0.f ? scale / softcap : 0.f};
  cudaStream_t s = (cudaStream_t)stream;
  const DeviceGuard guard(device);
  int err = kv_bf16 ? launch_kt<__nv_bfloat16>(a, q_bf16 != 0, s)
                    : launch_kt<float>(a, q_bf16 != 0, s);
  if (err == 0 && n_split > 1)
    err = launch_combine(part_acc, reinterpret_cast<const float2*>(part_ml),
                         out, lse, n_split, B, Sq, H, hd, q_bf16 != 0, s);
  return err;
}

// flash_attention_combine: partials (n_split, B, Sq, H, hd) and (n_split,
// B, H, Sq, 2) float32 -> out (B, Sq, H, hd) bf16 (out_bf16) or float32,
// lse (B, H, Sq).
extern "C" int flash_attention_combine(const float* part_acc,
                                       const float* part_ml, void* out,
                                       float* lse, int n_split, int B, int Sq,
                                       int H, int hd, int out_bf16,
                                       int device, void* stream) {
  if ((int64_t)B * Sq * H == 0) return 0;
  if (n_split < 1 || hd < 1 || hd > 128) return (int)cudaErrorInvalidValue;
  const DeviceGuard guard(device);
  return launch_combine(part_acc, reinterpret_cast<const float2*>(part_ml),
                        out, lse, n_split, B, Sq, H, hd, out_bf16 != 0,
                        (cudaStream_t)stream);
}

