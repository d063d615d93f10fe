// Fused charge-share + sense-amp Monte-Carlo resolve for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/senseamp.py::senseamp_resolve
// (and its trial-folding front end senseamp_resolve_trials).  One thread
// decides one (trial, shared column) sense amplifier:
//
//   v_com = u_com * (sum_i com[t, rows_com[i], off_com + j] - half_com)
//   v_ref = u_ref * (sum_i ref[t, rows_ref[i], off_ref + j] - half_ref)
//   acc   = sigma * normals[t, j]            (when normals are given)
//   acc  += v_com - v_ref
//   acc  += static[j], static[t, j] or static[t / T_b, j]  (when given)
//   out   = acc > thr, or acc > thr_bank[t / T_b]
//   floor: one uniform  u  -> u < pf ? (u < half_pf) : out
//          two uniforms u0, u1 -> u0 < pf ? (u1 < 0.5) : out
//
// The cells are read straight from the simulator's (T, slots, row_bits)
// cell buffers by slot index and column offset, so no (T, n, W) slab is
// materialized per APA.  A fused multi-bank episode stacks N banks of T_b
// trials each on the trial axis (T = N * T_b): its static offsets come as one
// (N, W) plane and its comparator thresholds as one (N,) vector, both read at
// bank t / T_b, so no per-trial plane is built and each bank's threshold is
// compared exactly as its own loop episode compares it.  Sums run in row order and every operation is a
// separately rounded float32 op (__fadd_rn / __fmul_rn, built with
// --fmad=false), which is the order of the numpy reference
// (BankSim._resolve), so the kernel agrees with it bit for bit.
//
// Bound on an H100: memory.  Per (trial, column) it reads 4 B per activated
// cell, 4 B of normal and 4 B (or 8 B) of uniforms and writes 1 B, against
// ~15 float operations per cell; consecutive threads read consecutive
// columns so every load is coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#define SENSEAMP_MAX_ROWS 64

// Slot indices of the activated rows of one side, passed by value.
struct Rows {
  int idx[SENSEAMP_MAX_ROWS];
};

namespace {

__device__ __forceinline__ float gather_sum(const float* __restrict__ base,
                                            const Rows& rows, int n,
                                            int64_t row_stride, int64_t col) {
  float acc = base[(int64_t)rows.idx[0] * row_stride + col];
  for (int i = 1; i < n; ++i)
    acc = __fadd_rn(acc, base[(int64_t)rows.idx[i] * row_stride + col]);
  return acc;
}

__global__ void senseamp_gather_kernel(
    const float* __restrict__ com, const Rows com_rows, int n_com,
    int64_t com_tstride, int64_t com_rstride, int64_t com_off, float u_com,
    float half_com,
    const float* __restrict__ ref, const Rows ref_rows, int n_ref,
    int64_t ref_tstride, int64_t ref_rstride, int64_t ref_off, float u_ref,
    float half_ref,
    const float* __restrict__ stat, int stat_mode,
    const float* __restrict__ normals, float sigma,
    const float* __restrict__ u0, const float* __restrict__ u1, float pf,
    float half_pf, float thr, const float* __restrict__ thr_bank,
    int bank_trials, uint8_t* __restrict__ out, int T, int W) {
  const int64_t total = (int64_t)T * W;
  for (int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; k < total;
       k += (int64_t)gridDim.x * blockDim.x) {
    const int64_t t = k / W;
    const int64_t j = k - t * W;
    const float s_com = gather_sum(com + t * com_tstride, com_rows, n_com,
                                   com_rstride, com_off + j);
    const float s_ref = gather_sum(ref + t * ref_tstride, ref_rows, n_ref,
                                   ref_rstride, ref_off + j);
    const float v_com = __fmul_rn(u_com, __fsub_rn(s_com, half_com));
    const float v_ref = __fmul_rn(u_ref, __fsub_rn(s_ref, half_ref));
    const float margin = __fsub_rn(v_com, v_ref);
    float acc = normals ? __fadd_rn(__fmul_rn(normals[k], sigma), margin)
                        : margin;
    const int64_t bank = t / bank_trials;
    if (stat)
      acc = __fadd_rn(acc, stat[stat_mode == 0   ? j
                                : stat_mode == 1 ? k
                                                 : bank * W + j]);
    bool bit = acc > (thr_bank ? thr_bank[bank] : thr);
    if (u0) {
      const float u = u0[k];
      if (u < pf) bit = u1 ? (u1[k] < 0.5f) : (u < half_pf);
    }
    out[k] = bit ? 1 : 0;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers that may be null:
// stat, normals, u0, u1, thr_bank.  stat_mode: 0 = static[j], 1 =
// static[t, j], 2 = static[t / bank_trials, j].  n_com, n_ref are
// 1..SENSEAMP_MAX_ROWS and bank_trials divides T (checked by the Python
// wrapper).  Returns cudaGetLastError() after the launch.
extern "C" int senseamp_gather(
    const float* com, Rows com_rows, int n_com, int64_t com_tstride,
    int64_t com_rstride, int64_t com_off, float u_com, float half_com,
    const float* ref, Rows ref_rows, int n_ref, int64_t ref_tstride,
    int64_t ref_rstride, int64_t ref_off, float u_ref, float half_ref,
    const float* stat, int stat_mode, const float* normals, float sigma,
    const float* u0, const float* u1, float pf, float half_pf, float thr,
    const float* thr_bank, int bank_trials, uint8_t* out, int T, int W,
    void* stream) {
  const int64_t total = (int64_t)T * W;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  senseamp_gather_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      com, com_rows, n_com, com_tstride, com_rstride, com_off, u_com,
      half_com, ref, ref_rows, n_ref, ref_tstride, ref_rstride, ref_off,
      u_ref, half_ref, stat, stat_mode, normals, sigma, u0, u1, pf, half_pf,
      thr, thr_bank, bank_trials, out, T, W);
  return (int)cudaGetLastError();
}
