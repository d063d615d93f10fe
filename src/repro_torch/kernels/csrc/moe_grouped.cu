// Grouped expert product of a dropless MoE, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's MoE multiplies every expert over
// fixed-capacity (E, C, D) buffers.  Here the rows come sorted by expert
// (a (R, K) operand, expert e owning rows offsets[e] .. offsets[e + 1] - 1,
// the (E + 1,) int32 offsets on the device), and each expert multiplies
// exactly its rows: nothing is read on the host, so the product is
// captured in a CUDA graph, and the weights of an expert without rows are
// never read.
//
// One launch computes out[rows] = act(A[rows] . W[e]^T) for every expert:
// W (E, N, K) K-major (a row of W[e] is one output column's K weights:
// the published up_proj / down_proj layout).  The expert MLP
// down(relu(up(h))^2) is two launches: up (K = D, N = F, act = relu^2,
// rounded once to bf16) then down (K = F, N = D, no act).
//
// SwiGLU experts (Granite 4.0-H) are the same two launches of a second
// kernel, moe_grouped_swiglu_*, whose up launch reads W (E, 2F, D), the
// published input_linear: rows 0 .. F - 1 the gate, F .. 2F - 1 the up.
// A block of BN/2 output columns loads both halves' rows for them into
// one BN-row operand tile (gate rows first), so one wgmma sum holds the
// gate and the up of each column side by side, and the epilogue writes
// silu(g) * u, rounded once to bf16.  Its down launch is the plain product
// (act none) of w_down (E, D, F), under the same kernel's name, so that a
// trace reads the SwiGLU product's time by that name.
//
// Tiles.  A block takes BM = 64 * NWG rows of one expert and BN output
// columns (grid (ceil(N / BN), tile bound)).  Expert e has ceil(rows_e /
// BM) tiles, in expert order; each block loads the offsets, scans the
// experts' tile counts across its threads and finds its own tile, so the
// grid is a fixed bound (ceil(R / BM) + min(E, R) tiles) and blocks past
// the last tile return at once.  Rows past the expert's end are zero-filled
// in shared memory and never stored.
//
// bf16: warpgroup i of the block owns rows 64i .. 64i + 63 and all BN
// columns, as float32 wgmma accumulators (m64nBNk16).  A and W tiles of 64
// K columns (128-byte rows) land by cp.async (16 bytes a thread, zero-fill
// past the rows and K) in a STAGES-deep ring, 128B-swizzled (8-row groups
// of 1024 B, chunk ^ row % 8), both K-major wgmma operands; each k-tile is
// four k16 steps, left in flight while the next tile's loads are waited
// for.  float32 rows (the tests' and the CPU comparison's
// precision): a CUDA-core tile of 64 x 64, full float32 products.
//
// Launch record: block (0, 0) of the up launch writes (experts with rows,
// rows) into a device ring of int64 pairs at an atomically taken slot, so
// that a graph replay records its launches too.
//
// What bounds it: at decode (a handful of rows an expert) the bytes of the
// weights of each expert with rows; at a long prefill the products
// (4 R D F operations over the card's bf16 rate).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // K columns a stage (128 bytes of bf16 a row)
constexpr int SW128 = 1;      // descriptor layout type: 128-byte swizzle

struct Args {
  const void* a;              // (R, K) rows, sorted by expert
  const void* w;              // (E, N, K)
  void* out;                  // (R, N)
  const int* offsets;         // (E + 1,)
  long long* ring;            // (ring_size, 2), or null: no record
  unsigned long long* ring_idx;
  int ring_size, R, K, N, E;
  int act;                    // ACT_NONE, ACT_RELU2 or ACT_SWIGLU
};

constexpr int ACT_NONE = 0, ACT_RELU2 = 1, ACT_SWIGLU = 2;

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The accumulators as operands of an empty asm: the compiler keeps its own
// reads and writes of them on their side of each wgmma issue and wait.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(x[j][e])::"memory");
}

// D (64 rows x N, float32) += A . B^T for one k16 step, A (64 x 16) and B
// (N x 16) K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tn<64>(float (&d)[8][4],
                                               uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<128>(float (&d)[16][4],
                                               uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<256>(float (&d)[32][4],
                                               uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(1));
}

// Byte offset of (row r, column c) of a 128B-swizzled tile of 64 bf16
// columns (c a multiple of 8).
__device__ __forceinline__ int sw_offset(int r, int c) {
  return (r / 8) * 1024 + (r % 8) * 128 + ((c / 8) ^ (r % 8)) * 16;
}

struct Tile {
  int e, row0, row_end;       // e = E: past the last tile
};

// Block-wide: this block's tile t of BM rows, found by an inclusive scan of
// the experts' tile counts across the block's threads (E in chunks of
// blockDim.x).  With `record`, thread 0 also writes the launch record.
template <int BM>
__device__ Tile locate(const Args& a, int t, bool record) {
  __shared__ int s_warp[32];
  __shared__ int s_tile[3];
  __shared__ int s_carry, s_with;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  if (tid == 0) {
    s_tile[0] = a.E;
    s_carry = 0;
    s_with = 0;
  }
  int with_rows = 0;
  __syncthreads();
  for (int base = 0; base < a.E; base += blockDim.x) {
    const int e = base + tid;
    int lo = 0, hi = 0;
    if (e < a.E) {
      lo = a.offsets[e];
      hi = a.offsets[e + 1];
    }
    with_rows += hi > lo;
    const int nt = (hi - lo + BM - 1) / BM;
    int v = nt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? s_warp[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      if (lane < nwarps) s_warp[lane] = w;
    }
    __syncthreads();
    const int incl = v + (warp > 0 ? s_warp[warp - 1] : 0) + s_carry;
    if (e < a.E && t >= incl - nt && t < incl) {
      s_tile[0] = e;
      s_tile[1] = lo + (t - (incl - nt)) * BM;
      s_tile[2] = hi;
    }
    __syncthreads();
    if (tid == blockDim.x - 1) s_carry = incl;
    __syncthreads();
  }
  if (record) {
    atomicAdd(&s_with, with_rows);
    __syncthreads();
    if (tid == 0) {
      const unsigned long long slot =
          atomicAdd(a.ring_idx, 1ull) % (unsigned long long)a.ring_size;
      a.ring[2 * slot] = s_with;
      a.ring[2 * slot + 1] = a.offsets[a.E] - a.offsets[0];
    }
  }
  return {s_tile[0], s_tile[1], s_tile[2]};
}

// ---------------------------------------------------------------------------
// bf16 rows: NWG warpgroups, BM = 64 NWG rows, BN columns, on wgmma
// ---------------------------------------------------------------------------
template <int NWG, int BN, int STAGES>
struct Plan {
  static constexpr int BM = 64 * NWG, COLS = BN, THREADS = 128 * NWG;
  static constexpr int A_BYTES = BM * 128, B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the ring, plus room to align its start to 1024 bytes (the swizzle's
  // period)
  static constexpr int SMEM = STAGES * STAGE + 1024;
};

// GLU: the kernel may take act = ACT_SWIGLU (the gate and the up of BN / 2
// columns a block); false compiles the other acts alone.
template <int NWG, int BN, int STAGES, bool GLU>
__device__ __forceinline__ void grouped_bf16(const Args& a) {
  using P = Plan<NWG, BN, STAGES>;
  const Tile tile = locate<P::BM>(
      a, blockIdx.y, a.ring != nullptr && blockIdx.x == 0 && blockIdx.y == 0);
  if (tile.e >= a.E) return;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);

  const bool glu = GLU && a.act == ACT_SWIGLU;
  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = blockIdx.x * (glu ? BN / 2 : BN);
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a.a);
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(a.w) +
                           (size_t)tile.e * (glu ? 2 : 1) * a.N * a.K;
  const int ktiles = (a.K + BK - 1) / BK;

  // cp.async of k-tile kt into stage st: 16-byte chunks, zero past the
  // expert's rows, past N and past K (K and N are multiples of 8)
  auto issue = [&](int kt, int st) {
    unsigned char* sa = smem + st * P::STAGE;
    unsigned char* sb = sa + P::A_BYTES;
    const int k0 = kt * BK;
#pragma unroll
    for (int u = tid; u < P::BM * 8; u += P::THREADS) {
      const int r = u >> 3, c = (u & 7) * 8;
      const int row = tile.row0 + r, k = k0 + c;
      const bool ok = row < tile.row_end && k < a.K;
      cp_async16(sa + sw_offset(r, c), ok ? A + (size_t)row * a.K + k : A,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int u = tid; u < BN * 8; u += P::THREADS) {
      const int r = u >> 3, c = (u & 7) * 8;
      // SwiGLU: operand rows 0 .. BN/2 - 1 the gate's, then the up's
      const int n = glu ? n0 + r % (BN / 2) : n0 + r, k = k0 + c;
      const int wrow = glu && r >= BN / 2 ? a.N + n : n;
      const bool ok = n < a.N && k < a.K;
      cp_async16(sb + sw_offset(r, c), ok ? W + (size_t)wrow * a.K + k : W,
                 ok ? 16 : 0);
    }
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // STAGES - 2 tiles in flight ahead of the one multiplied, whose products
  // run on while the next tile's wait and barrier pass (one wgmma group
  // left in flight): the stage a refill takes was read by the products of
  // two tiles back, which every warpgroup has waited for before the barrier
#pragma unroll
  for (int st = 0; st < STAGES - 2; ++st) {
    if (st < ktiles) issue(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 3>();        // this thread's chunks of tile kt
    fence_async_smem();
    __syncthreads();                    // every thread's chunks of tile kt
    if (kt + STAGES - 2 < ktiles)
      issue(kt + STAGES - 2, (kt + STAGES - 2) % STAGES);
    cp_async_commit();
    const unsigned char* sa = smem + (kt % STAGES) * P::STAGE;
    const uint64_t da = gmma_desc(sa + wg * 64 * 128, 16, 1024, SW128);
    const uint64_t db = gmma_desc(sa + P::A_BYTES, 16, 1024, SW128);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tn<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    wgmma_wait<1>();
    pin(acc);
  }
  wgmma_wait<0>();
  pin(acc);
  cp_async_wait<0>();

  // epilogue: thread (g, q) of warp w holds rows 16w + g (+ 8) at columns
  // 8j + 2q, 8j + 2q + 1 (the m16n8 accumulator layout, per warp)
  const int lane = tid & 31, w = (tid & 127) >> 5, g = lane >> 2, q = lane & 3;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  if (glu) {
    // column block j of the gate (j < BN / 16) beside block j + BN / 16,
    // the up of the same columns
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile.row0 + wg * 64 + 16 * w + g + 8 * h;
        const float x0 = silu(acc[j][2 * h]) * acc[j + BN / 16][2 * h];
        const float x1 =
            silu(acc[j][2 * h + 1]) * acc[j + BN / 16][2 * h + 1];
        if (row < tile.row_end && col < a.N)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * a.N + col) =
              __floats2bfloat162_rn(x0, x1);
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = tile.row0 + wg * 64 + 16 * w + g + 8 * h;
      float x0 = acc[j][2 * h], x1 = acc[j][2 * h + 1];
      if (a.act == ACT_RELU2) {
        x0 = fmaxf(x0, 0.f);
        x1 = fmaxf(x1, 0.f);
        x0 *= x0;
        x1 *= x1;
      }
      if (row < tile.row_end && col < a.N)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * a.N + col) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 rows: 64 x 64 tiles on the CUDA cores, 16 x 16 threads of 4 x 4
// ---------------------------------------------------------------------------
constexpr int F_BM = 64, F_BN = 64, F_BK = 16;

// GLU as in grouped_bf16: a thread also sums the up of its gate's columns.
template <bool GLU>
__device__ __forceinline__ void grouped_f32(const Args& a) {
  const Tile tile = locate<F_BM>(
      a, blockIdx.y, a.ring != nullptr && blockIdx.x == 0 && blockIdx.y == 0);
  if (tile.e >= a.E) return;
  constexpr int NB = GLU ? 2 : 1;
  __shared__ float sa[F_BK][F_BM + 4];
  __shared__ float sb[NB][F_BK][F_BN + 4];
  const bool glu = GLU && a.act == ACT_SWIGLU;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * F_BN;
  const float* A = static_cast<const float*>(a.a);
  const float* W = static_cast<const float*>(a.w) +
                   (size_t)tile.e * (glu ? 2 : 1) * a.N * a.K;
  float acc[NB][4][4] = {};
  for (int k0 = 0; k0 < a.K; k0 += F_BK) {
    for (int u = tid; u < F_BK * F_BM; u += 256) {
      const int r = u / F_BK, k = u % F_BK;
      const int row = tile.row0 + r, n = n0 + r;
      const bool ok = n < a.N && k0 + k < a.K;
      sa[k][r] = row < tile.row_end && k0 + k < a.K
                     ? A[(size_t)row * a.K + k0 + k] : 0.f;
      sb[0][k][r] = ok ? W[(size_t)n * a.K + k0 + k] : 0.f;
      if (glu)
        sb[NB - 1][k][r] = ok ? W[(size_t)(a.N + n) * a.K + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][i][j] = fmaf(sa[k][4 * ty + i], sb[0][k][4 * tx + j],
                              acc[0][i][j]);
          if (glu)
            acc[NB - 1][i][j] = fmaf(sa[k][4 * ty + i],
                                     sb[NB - 1][k][4 * tx + j],
                                     acc[NB - 1][i][j]);
        }
    __syncthreads();
  }
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tile.row0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      float x = acc[0][i][j];
      if (a.act == ACT_RELU2) {
        x = fmaxf(x, 0.f);
        x *= x;
      } else if (glu) {
        x = silu(x) * acc[NB - 1][i][j];
      }
      if (row < tile.row_end && col < a.N) out[(size_t)row * a.N + col] = x;
    }
  }
}

// bf16: 128 rows x 256 columns, 4 stages (192 KB of shared memory).  An
// H100 sweep at Nemotron 3 Nano's widths found it the fastest of 64 x 64
// (6 stages), 128 x 128 (6) and 128 x 256 (4) at every shape measured,
// from a 16-token decode to a 4,096-token prefill.
using BF16 = Plan<2, 256, 4>;

}  // namespace

// The kernels, named without mangling so that a trace reads them by name.
extern "C" __global__ void __launch_bounds__(BF16::THREADS)
    moe_grouped_bf16(const Args a) {
  grouped_bf16<2, 256, 4, false>(a);
}

extern "C" __global__ void __launch_bounds__(256)
    moe_grouped_f32(const Args a) {
  grouped_f32<false>(a);
}

// SwiGLU experts: the same tiles, 128 gate and 128 up columns a block in
// the up launch (the same accumulators as one 256-column tile).
extern "C" __global__ void __launch_bounds__(BF16::THREADS)
    moe_grouped_swiglu_bf16(const Args a) {
  grouped_bf16<2, 256, 4, true>(a);
}

extern "C" __global__ void __launch_bounds__(256)
    moe_grouped_swiglu_f32(const Args a) {
  grouped_f32<true>(a);
}

namespace {

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

int tiles(int rows, int experts, int bm) {
  return (rows + bm - 1) / bm + (experts < rows ? experts : rows);
}

// grid (column blocks, tiles): the blocks of one row tile run side by side
// and share its rows in L2; an expert's row tiles follow one another and
// share its weights there.  glu: the SwiGLU kernels (BF16::COLS / 2
// output columns a bf16 block under ACT_SWIGLU)
int launch(const Args& a, int bf16, bool glu, cudaStream_t s) {
  if (!bf16) {
    const dim3 grid((a.N + F_BN - 1) / F_BN, tiles(a.R, a.E, F_BM));
    if (glu)
      moe_grouped_swiglu_f32<<<grid, 256, 0, s>>>(a);
    else
      moe_grouped_f32<<<grid, 256, 0, s>>>(a);
  } else if (glu) {
    allow_smem<moe_grouped_swiglu_bf16>(BF16::SMEM);
    const int cols = a.act == ACT_SWIGLU ? BF16::COLS / 2 : BF16::COLS;
    const dim3 grid((a.N + cols - 1) / cols, tiles(a.R, a.E, BF16::BM));
    moe_grouped_swiglu_bf16<<<grid, BF16::THREADS, BF16::SMEM, s>>>(a);
  } else {
    allow_smem<moe_grouped_bf16>(BF16::SMEM);
    const dim3 grid((a.N + BF16::COLS - 1) / BF16::COLS,
                    tiles(a.R, a.E, BF16::BM));
    moe_grouped_bf16<<<grid, BF16::THREADS, BF16::SMEM, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The expert MLP down(relu(up(xs))^2) over rows sorted by expert: up (xs
// (R, D) through w_up (E, F, D) into h (R, F), relu^2) then down (h
// through w_down (E, D, F) into out (R, D)), on `stream`; the up launch
// writes its record into ring / ring_idx.  bf16 = 0: float32 tensors.
// -> 0, or the CUDA error of a launch.
extern "C" int moe_grouped(const void* xs, const void* w_up,
                           const void* w_down, void* h, void* out,
                           const int* offsets, long long* ring,
                           unsigned long long* ring_idx, int ring_size,
                           int R, int D, int F, int E, int bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args up{xs, w_up, h, offsets, ring, ring_idx, ring_size, R, D, F, E,
          ACT_RELU2};
  int err = launch(up, bf16, false, s);
  if (err) return err;
  Args down{h, w_down, out, offsets, nullptr, nullptr, 0, R, F, D, E,
            ACT_NONE};
  return launch(down, bf16, false, s);
}

// The SwiGLU expert MLP down(silu(g) * u) over rows sorted by expert, [g,
// u] = xs . w_gate_up[e]^T: up (xs (R, D) through w_gate_up (E, 2F, D),
// gate rows first, into h (R, F)) then down (h through w_down (E, D, F)
// into out (R, D)), as moe_grouped.
extern "C" int moe_grouped_swiglu(const void* xs, const void* w_gate_up,
                                  const void* w_down, void* h, void* out,
                                  const int* offsets, long long* ring,
                                  unsigned long long* ring_idx,
                                  int ring_size, int R, int D, int F, int E,
                                  int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args up{xs, w_gate_up, h, offsets, ring, ring_idx, ring_size, R, D, F, E,
          ACT_SWIGLU};
  int err = launch(up, bf16, true, s);
  if (err) return err;
  Args down{h, w_down, out, offsets, nullptr, nullptr, 0, R, F, D, E,
            ACT_NONE};
  return launch(down, bf16, true, s);
}
