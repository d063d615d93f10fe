"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Two paths of the port run here.  The first is the paper's characterization
Monte-Carlo: trial-batched APAs on the torch ``BankSim`` through ``PudIsa``,
resolved by the hand-written sense-amp kernel, giving the success rates of
Fig. 15 (16-input AND/NAND/OR/NOR) and Fig. 7 (NOT) at the paper's scale —
10,000 trials per configuration on the native 8192-bit row.  The second is
the PuD engine's packed-plane path (``PudEngine("kernel")``): attention-mask
composition at S = 16384, MoE routing masks, Bloom-filter dedup over a
2**26-bit plane, the bit-serial adder and popcount over (1024, 1024)
planes and the bit-serial dot product, on the ``nary_bitwise`` /
``bitwise_not`` / ``add_planes`` / ``bitcount_planes`` kernels; and the
``dram`` backend, whose Boolean APAs resolve in the sense-amp kernel.  The
third is the binary dot product, computed two ways: as XNOR-popcount
binary linears at the projection widths of ``configs/qwen3_4b.py`` on the
``popcount_gemm`` kernel (forward, then STE training steps), and as
compiled AND + popcount programs executed on the simulated DRAM banks
(``dot_bitserial_tree``, the ``dram`` engine's ``run_program`` / ``add``,
the program-level Monte-Carlo), held against the kernel; ``maj3`` runs
through its entry point.  The fourth serves the decoder LM: the uncut
``configs/qwen3_4b.py`` (36 layers, d_model 2560, 32 / 8 heads of 80,
vocab 151936; random bf16 weights from a seeded generator) behind
``ServeEngine`` with four slots of 4096 tokens, every layer's attention on
the hand-written ``flash_attention`` kernel.
Phases:

1. the card's name and power limit (``nvidia-smi``);
2. build the kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
   source, all started together);
3. each kernel against its plain PyTorch version on the card, bit for bit,
   at the main path's shapes, with its time beside its bound and, where
   one PyTorch call computes the same function, that call's time —
   queued, in a CUDA graph and with the L2 flushed for ``bitwise_not``
   (``torch.bitwise_not``), ``popcount_gemm`` (bf16 ``torch.mm`` and int8
   ``torch._int_mm`` on the ±1 operands) and the attention kernel (SDPA);
4. the Monte-Carlo path through ``charz.mc_boolean_success`` /
   ``mc_not_success``; the rates are held to the paper and to the
   closed-form model;
5. the engine path, workload by workload, each held to a direct torch
   computation on the card;
6. the engine's ``dram`` backend, ideal (equal to the ``kernel`` backend)
   and noisy (mismatches near the Fig. 15 failure rate);
7. ``draws="numpy"`` on the card against the same run on the CPU (equal),
   for the Monte-Carlo and for the ``dram`` engine;
8. the closed-form sampler on the card;
9. the binary linears (``quant_path``): up (9728 × 2560) and down
   (2560 × 9728) on 2048 tokens, the integer dots equal to the plain
   version bit for bit, then 5 STE SGD steps whose loss must fall;
10. the bank-executed programs (``program_path``): ``dot_bitserial_tree``
    (M = N = 128, K = 32, 4 banks) ideal equal to ``popcount_gemm_bits``
    on the kernel and noisy with its mismatch rate, the ``dram`` engine's
    ``run_program`` / ``add`` ideal equal to the ``kernel`` backend, the
    program Monte-Carlo (xor / maj3 / add4, host-staged and resident), and
    ``draws="numpy"`` card == CPU; then ``maj3`` through ``ops.maj3``;
11. the serving path (``serve_path``): ``flash_attention`` against its
    plain version at the prefill (B = 1, 2048 queries over a 4096-slot
    cache) and decode (B = 4, one query each: the split-KV path and its
    merge kernel) shapes in bf16 q with a float32 cache and all float32,
    plus windowed, softcapped, ragged, split and multi-chunk cases, and
    the merge kernel against its plain version (phase 3 with the other
    kernels); then 9 requests (prompts of
    256–2048 tokens, 32 new tokens each, 8 greedy + 1 at temperature 1)
    through ``ServeEngine`` on qwen3-4b at full width — one kernel launch
    per layer per prefill and per decode step — the engine's prefill
    logits against ``forward``, greedy agreement with a teacher-forced
    ``forward``, one merge per layer per decode step; and the same weights
    cut to 2 layers in float32 (TF32 off), card (kernel) against CPU
    (plain) ``forward`` logits;
12. the rest of the characterization (``characterization_path``, run
    before the serving path): the bloom probe / insert fan-in sweep
    (fan-in 2-16, 2,000 trials, 8192-bit rows) held to the
    independent-op estimate, replica plans, the 4-bank nand16 MC's
    ``stats`` (optimistic and rank-legal makespans), the plan verifier,
    the DDR4 timing lint and the rank scheduler over ``dram`` engine logs
    (0 findings, 0 violations; the 2-bank xor case equal to the
    reference's numbers), Obs. 3's per-cell map, and ``draws="numpy"``
    card == CPU for the sweep, ``stats`` and ``apa_then_write``.

Every path is driven with the launch counts set to 0 just before it and
read just after; a kernel of the path that was not launched fails the run.

Any failed check raises and the script exits non-zero.  The second-to-last
line is the kernel table as JSON; the last line is the device record.  With
no CUDA device, or without the repository's ``src/`` beside it, it exits
non-zero before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
#: 32-bit operations outside the tensor cores (H100 SXM data sheet: the
#: float32 rate; the sheet gives no int32 logic rate, which is lower, so the
#: operation bound of the plane kernels is optimistic — they are bound by
#: bytes many times over either way)
OPS_PER_S = 67e12
#: dense int8 tensor-core rate (H100 SXM data sheet), 2 operations per
#: multiply-add
INT8_OPS_PER_S = 1979e12
#: 1-bit tensor-core rate, the rate of the popcount GEMM's own type (one
#: bit-pair AND + popcount = 2 operations): the sheet lists none, so it is
#: the int8 rate times 8, the bits per instruction of the 1-bit forms
#: (mma.sync m16n8k256 .b1, wgmma m64nNk256 .b1) over the int8 forms (k32),
#: which the card issues at one rate (a register-only mma.sync loop on an
#: H100: .b1 at 7.998x the bit-products of .s8 a second)
ONE_BIT_OPS_PER_S = 8 * INT8_OPS_PER_S
#: dense bf16 tensor-core rate (H100 SXM data sheet): the operation bound
#: of the bf16 attention kernel
BF16_OPS_PER_S = 989e12
KERNEL_SOURCES = ("senseamp", "bitwise", "bitserial", "popcount_gemm",
                  "flash_attention")
#: the served model and engine (src/repro/configs/qwen3_4b.py, uncut)
SERVE_ARCH, SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = "qwen3-4b", 4, 4096, 32
#: prompt lengths are drawn from this range (numpy default_rng(0))
SERVE_PROMPTS = (256, 2048)
#: cache position of an unwritten slot (POS_SENTINEL)
SENTINEL = (2 ** 31 - 1) // 2
#: the projection widths of src/repro/configs/qwen3_4b.py, on 2048 tokens
D_MODEL, D_FF, TOKENS = 2560, 9728, 2048
#: the reference's program-level MC success (BENCH_pr10.json, "Resident vs
#: host-staged program execution": staged_succ / resident_succ); the
#: 2-input NAND / AND / OR these programs compose fail often, so whole
#: programs land near 0.5-0.6
REF_PROGRAM_RATES = {"xor_host": 0.4933, "xor_scheduled": 0.5458,
                     "maj3_host": 0.5959, "maj3_scheduled": 0.5960,
                     "add4_host": 0.5023, "add4_scheduled": 0.5193}
#: the reference's static analysis of the 2-bank loop engine running xor
#: on (4, 4) words (BENCH_pr10.json "static_detail", the "_loop" keys)
REF_STATIC_LOOP = {"timing_violations": 0, "timing_by_design": 28,
                   "makespan_ns": 1554.5, "min_legal_makespan_ns": 1554.5,
                   "legal_makespan_ns": 1554.5, "refresh_stall_ns": 0.0,
                   "rank_stall_ns": 0.0, "sched_violations": 0}
#: the workload fan-in sweep (tests/test_workloads.py's contract: MC
#: success within 0.05 below the independent-op estimate, the bloom probe
#: no worse than 0.02 below its narrow self at fan-in 16)
SWEEP_FANINS, SWEEP_TRIALS = (2, 4, 8, 16), 2000
EST_BAND, MONO_BAND = 0.05, 0.02
PAPER_16 = {"and": 0.9494, "nand": 0.9494, "or": 0.9585, "nor": 0.9587}
PAPER_NOT1 = 0.9837
TRIALS, ROW_BITS = 10_000, 8192


def _phase(name: str, t0: float, times: dict) -> float:
    now = time.perf_counter()
    times[name] = round(now - t0, 3)
    print(f"[phase] {name}: {times[name]} s", flush=True)
    return now


def _time_ms(fn, reps: int = 20) -> float:
    """Device time of one call: CUDA events around ``reps`` back-to-back
    calls after a warm-up, over the count (the queue stays full, so the
    host's launch cost is hidden wherever the device is the slower side)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def check_senseamp(S) -> dict:
    """Gather kernel vs plain twin at the nand16 main-path shape."""
    tg = -(-TRIALS // 9)                 # trials per stratified pair group
    w, n, slots = ROW_BITS // 2, 16, 16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    rows_l = [int(r) for r in np.random.default_rng(0).permutation(slots)[:n]]
    rows_f = list(range(slots))[::-1][:n]
    normals = torch.randn((tg, w), generator=gen, device=dev)
    u0 = torch.rand((tg, w), generator=gen, device=dev)
    static = 0.02 * torch.randn((w,), generator=gen, device=dev)
    scal = dict(width=w, u_com=1 / 22, u_ref=1 / 22, sigma=0.0061, pf=0.0431,
                thr=0.0123)
    worst = 0
    cases = {}
    for kind in ("ternary", "float"):
        if kind == "ternary":
            cells = [torch.randint(0, 3, (tg, slots, ROW_BITS), generator=gen,
                                   device=dev).float() * 0.5
                     for _ in range(2)]
        else:
            cells = [torch.rand((tg, slots, ROW_BITS), generator=gen,
                                device=dev) for _ in range(2)]
        args = (cells[1], rows_l, w, cells[0], rows_f, 0)
        kw = dict(static=static, normals=normals, u0=u0, **scal)
        got = S.senseamp_gather_cuda(*args, **kw)
        want = S.senseamp_gather_plain(*args, **kw)
        torch.cuda.synchronize()
        diff = int((got.int() - want.int()).abs().max())
        worst = max(worst, diff)
        assert diff == 0, f"senseamp kernel != plain ({kind} cells)"
        cases[kind] = (args, kw)
    # scalar mode on the card: float64 draws cast to float32, two uniforms
    # per lane; plus a (T, W) static plane and ideal mode (no noise)
    g64 = torch.Generator(device=dev)
    g64.manual_seed(99)
    args = cases["ternary"][0]
    one = tuple(x[:1] if torch.is_tensor(x) else x for x in args)
    extra = {
        "scalar": (one, dict(static=static.double().float(),
                             normals=torch.randn((1, w), generator=g64,
                                                 device=dev,
                                                 dtype=torch.float64).float(),
                             u0=torch.rand((1, w), generator=g64, device=dev,
                                           dtype=torch.float64).float(),
                             u1=torch.rand((1, w), generator=g64, device=dev,
                                           dtype=torch.float64).float(),
                             **scal)),
        "static_plane": (args, dict(cases["ternary"][1],
                                    static=0.02 * torch.randn(
                                        (tg, w), generator=gen, device=dev))),
        "ideal": (args, dict(width=w, u_com=1 / 22, u_ref=1 / 22)),
    }
    for kind, (a, kw) in extra.items():
        got = S.senseamp_gather_cuda(*a, **kw)
        want = S.senseamp_gather_plain(*a, **kw)
        diff = int((got.int() - want.int()).abs().max())
        worst = max(worst, diff)
        assert diff == 0, f"senseamp kernel != plain ({kind})"
    # the slab front end (identity slots) on the card == on the CPU
    from repro_torch.kernels import ops
    t, nn = 64, 5
    slab = dict(u_com=.09, u_ref=.11, shift=.015, pf=.03, trial_sigma=.01)
    ins = [torch.rand((t, nn, w), generator=gen, device=dev),
           torch.rand((t, nn + 2, w), generator=gen, device=dev),
           0.02 * torch.randn((w,), generator=gen, device=dev),
           torch.randn((t, w), generator=gen, device=dev),
           torch.rand((2, t, w), generator=gen, device=dev)]
    before = S.launches
    got = ops.senseamp_resolve_trials(*ins, **slab)
    assert S.launches == before + 1
    want = ops.senseamp_resolve_trials(*(x.cpu() for x in ins), **slab)
    diff = int((got.cpu().int() - want.int()).abs().max())
    worst = max(worst, diff)
    assert diff == 0, "senseamp_resolve_trials: card != CPU"
    args, kw = cases["ternary"]
    ms = _time_ms(lambda: S.senseamp_gather_cuda(*args, **kw))
    plain_ms = _time_ms(lambda: S.senseamp_gather_plain(*args, **kw), reps=5)
    # bytes the function must move: each activated cell, the normal, the
    # uniform and the static offsets read once, each output bit written once
    nbytes = tg * w * (4 * (len(rows_l) + len(rows_f)) + 4 + 4 + 1) + 4 * w
    return {"name": "senseamp_resolve", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/senseamp.cu",
            "replaces": "src/repro/kernels/senseamp.py:77",
            "launches": None, "max_abs_err": float(worst),
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
            "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 6),
            "bound_by": "bytes", "library_ms": None,
            "shape": {"T": tg, "W": w, "n_com": n, "n_ref": n}}


def _bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time the card could take (ms) and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _words(gen, *shape) -> torch.Tensor:
    """Random packed words (int32 bit patterns) on the card."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int64, device="cuda").to(torch.int32)


def _diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |kernel - plain| over the words, as integers."""
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def check_bitkernels(BW, BS) -> list[dict]:
    """The four plane kernels vs their plain twins, bit for bit: every op,
    N = 1 and 17, ragged and unaligned lengths, then the main path's shapes
    (timed).  -> one JSON row per kernel (launches filled in later)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    worst = {"nary_bitwise": 0, "bitwise_not": 0, "add_planes": 0,
             "bitcount_planes": 0, "maj3": 0}

    def held(name, got, want, what):
        d = _diff(got, want)
        worst[name] = max(worst[name], d)
        assert d == 0, f"{name} kernel != plain ({what})"

    for shape in ((1, 64, 512), (17, 64, 512), (3, 7, 1000), (2, 1, 4097)):
        p = _words(gen, *shape)
        for op in BW.OPS:
            held("nary_bitwise", BW.nary_bitwise_cuda(p, op),
                 BW.nary_bitwise_plain(p, op), (op, shape))
    for shape in ((7, 1000), (1, 3), (1, 4097), (3, 1365), (1000, 1003)):
        p = _words(gen, *shape)
        held("bitwise_not", BW.bitwise_not_cuda(p), BW.bitwise_not_plain(p),
             shape)
    p = _words(gen, 1, 4101)[:, 1:]                         # unaligned
    held("bitwise_not", BW.bitwise_not_cuda(p), BW.bitwise_not_plain(p),
         "unaligned")
    for shape in ((7, 1000), (1, 3), (3, 70)):
        abc = [_words(gen, *shape) for _ in range(3)]
        held("maj3", BW.maj3_cuda(*abc), BW.maj3_plain(*abc), shape)
    abc = [_words(gen, 1, 4101)[:, 1:] for _ in range(3)]   # unaligned
    held("maj3", BW.maj3_cuda(*(x.contiguous() for x in abc)),
         BW.maj3_plain(*abc), "unaligned")
    for k, shape in ((1, (7, 1000)), (5, (3, 70))):
        a, b = _words(gen, k, *shape), _words(gen, k, *shape)
        held("add_planes", BS.add_planes_cuda(a, b),
             BS.add_planes_plain(a, b), (k, shape))
    for n, shape in ((1, (7, 1000)), (17, (3, 70)), (255, (2, 36))):
        p = _words(gen, n, *shape)
        held("bitcount_planes", BS.bitcount_planes_cuda(p),
             BS.bitcount_planes_plain(p), (n, shape))

    def timed(name, cuda_fn, plain_fn, args, nbytes, nops, library=None):
        """Queued times; where a library call exists, also in a CUDA graph
        and with the L2 flushed, kernel and library in turns (kernel,
        library, library, kernel, three times over; the median of each
        six), and their ratios."""
        held(name, cuda_fn(*args), plain_fn(*args), "main-path shape")
        bound, by = _bound(nbytes, nops)
        row = {"ms": round(_time_ms(lambda: cuda_fn(*args)), 6),
               "plain_ms": round(_time_ms(lambda: plain_fn(*args), reps=5),
                                 6),
               "bound_ms": round(bound, 6), "bound_by": by,
               "library_ms": None}
        if library is None:
            return row
        row["library_ms"] = round(_time_ms(lambda: library(*args)), 6)
        kernel, lib = (lambda: cuda_fn(*args)), (lambda: library(*args))
        for how, timer in (("graph_", _time_graph_ms),
                           ("cold_", _time_cold_ms)):
            t = [timer(f) for f in (kernel, lib, lib, kernel) * 3]
            row[f"{how}ms"] = round(float(np.median(t[0::4] + t[3::4])), 6)
            row[f"library_{how}ms"] = round(
                float(np.median(t[1::4] + t[2::4])), 6)
        for how in ("", "graph_", "cold_"):
            row[f"{how}vs_library"] = round(
                row[f"{how}ms"] / row[f"library_{how}ms"], 4)
        row["graph_share_of_bound"] = round(bound / row["graph_ms"], 4)
        print(f"[{name}] kernel / library queued {row['vs_library']}, graph "
              f"{row['graph_vs_library']}, cold {row['cold_vs_library']}; "
              f"graph share of bound {row['graph_share_of_bound']}",
              flush=True)
        return row

    mask = _words(gen, 4, 16384, 512)             # the attention-mask stack
    words = 16384 * 512
    t_mask = timed("nary_bitwise", BW.nary_bitwise_cuda,
                   BW.nary_bitwise_plain, (mask, "and"), 4 * 5 * words,
                   3 * words)
    del mask
    bloom = _words(gen, 5, 1, 2 ** 21)            # the Bloom insert stack
    t_bloom = timed("nary_bitwise", BW.nary_bitwise_cuda,
                    BW.nary_bitwise_plain, (bloom, "or"), 4 * 6 * 2 ** 21,
                    4 * 2 ** 21)
    del bloom
    plane = _words(gen, 16384, 512)
    t_not = timed("bitwise_not", BW.bitwise_not_cuda, BW.bitwise_not_plain,
                  (plane,), 4 * 2 * words, words, library=torch.bitwise_not)
    abc = [plane, _words(gen, 16384, 512), _words(gen, 16384, 512)]
    t_maj = timed("maj3", BW.maj3_cuda, BW.maj3_plain, abc, 4 * 4 * words,
                  4 * words)
    del plane, abc
    words = 1024 * 1024
    a, b = _words(gen, 16, 1024, 1024), _words(gen, 16, 1024, 1024)
    t_add = timed("add_planes", BS.add_planes_cuda, BS.add_planes_plain,
                  (a, b), 4 * (16 + 16 + 17) * words, 5 * 16 * words)
    del b
    k = BS.slices_for(16)
    t_cnt = timed("bitcount_planes", BS.bitcount_planes_cuda,
                  BS.bitcount_planes_plain, (a,), 4 * (16 + k) * words,
                  2 * k * 16 * words)
    del a
    torch.cuda.synchronize()
    src = "src/repro_torch/kernels/csrc/"
    rows = [
        dict(name="nary_bitwise", source=src + "bitwise.cu",
             replaces="src/repro/kernels/bitwise.py:59", **t_mask,
             shape={"N": 4, "R": 16384, "C": 512, "op": "and"},
             bloom_shape={"N": 5, "R": 1, "C": 2 ** 21, "op": "or",
                          **t_bloom}),
        dict(name="bitwise_not", source=src + "bitwise.cu",
             replaces="src/repro/kernels/bitwise.py:84", **t_not,
             shape={"R": 16384, "C": 512}),
        dict(name="maj3", source=src + "bitwise.cu",
             replaces="src/repro/kernels/bitwise.py:110", **t_maj,
             shape={"R": 16384, "C": 512}),
        dict(name="add_planes", source=src + "bitserial.cu",
             replaces="src/repro/kernels/bitserial.py:47", **t_add,
             shape={"K": 16, "R": 1024, "C": 1024}),
        dict(name="bitcount_planes", source=src + "bitserial.cu",
             replaces="src/repro/kernels/bitserial.py:82", **t_cnt,
             shape={"N": 16, "R": 1024, "C": 1024}),
    ]
    return [{"route": "cuda", "launches": None,
             "max_abs_err": float(worst[r["name"]]), **r} for r in rows]


def _pm1(words: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    """Packed words (rows, KB) -> the ±1 values of their first k bits in
    ``dtype`` (rows, k): the operands of the library yardsticks."""
    from repro_torch.kernels.ops import unpack_bits
    return 2 * unpack_bits(words)[:, :k].to(dtype) - 1


def check_popcount_gemm(PG) -> dict:
    """The binary GEMM vs its plain twin, bit for bit: both kinds at
    ragged shapes (130 x 50 x 65 is the reference's padded-and-corrected
    case; the rest cross the kernel's 64 x 128 tiles and 16-word K
    stages, stay below one tile, or take the word copies: KB not a
    multiple of 4, an operand 4 bytes off alignment), at the ±32·KB
    extremes (all-ones and all-zero words) and at the two serve shapes of
    the quant path, xnor timed there on three measures (queued from
    Python, in a CUDA graph, with the L2 flushed).  Bound: the larger of
    the bytes (packed operands read once, the int32 output written once)
    and 2·M·N·32·KB operations at the 1-bit tensor-core rate; the same
    operations at the dense int8 rate stand beside it as
    ``int8_ops_bound_ms``, the bound of the ±1 int8 product the
    yardsticks compute.  Library yardsticks,
    timed the same three ways: ``torch.mm`` on the operands unpacked to ±1
    bfloat16 (a time only: its output is rounded bfloat16) and
    ``torch._int_mm`` on them as ±1 int8 (exact: held equal to the
    kernel).  ``*vs_library*`` is kernel / yardstick on one measure."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1313)
    worst = 0
    shapes = ((8, 8, 2), (130, 50, 65), (1, 1, 1), (300, 257, 80),
              (64, 64, 32), (77, 3, 304), (127, 255, 3), (129, 257, 5),
              (256, 193, 9), (257, 129, 33), (5, 100, 7), (100, 5, 6),
              (131, 129, 20))
    serve = {"up": (TOKENS, D_FF, D_MODEL // 32),
             "down": (TOKENS, D_MODEL, D_FF // 32)}

    def held(x, w, kind, what):
        nonlocal worst
        d = _diff(PG.popcount_gemm_cuda(x, w, kind),
                  PG.popcount_gemm_plain(x, w, kind))
        worst = max(worst, d)
        assert d == 0, f"popcount_gemm kernel != plain {what}"

    for m, n, kb in (*shapes, *serve.values()):
        x, w = _words(gen, m, kb), _words(gen, n, kb)
        for kind in PG.KINDS:
            held(x, w, kind, (m, n, kb, kind))
    x = _words(gen, 70 * 8 + 1)[1:].view(70, 8)            # unaligned
    for kind in PG.KINDS:
        held(x, _words(gen, 90, 8), kind, ("unaligned", kind))
    ones = torch.full((130, 9), -1, dtype=torch.int32, device="cuda")
    zeros = torch.zeros_like(ones)
    for x, w in ((ones, ones), (ones, zeros), (zeros, zeros)):
        for kind in PG.KINDS:
            held(x, w, kind, ("extremes", kind))
    timing = {}
    for name, (m, n, kb) in serve.items():
        x, w = _words(gen, m, kb), _words(gen, n, kb)
        nbytes = 4 * (m * kb + n * kb + m * n)
        t_ops = 2 * m * n * 32 * kb / ONE_BIT_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        xb, wb = _pm1(x, 32 * kb, torch.bfloat16), _pm1(w, 32 * kb,
                                                        torch.bfloat16)
        x8, w8 = _pm1(x, 32 * kb, torch.int8), _pm1(w, 32 * kb, torch.int8)
        kernel = lambda: PG.popcount_gemm_cuda(x, w, "xnor")  # noqa: E731
        bf16 = lambda: torch.mm(xb, wb.T)                      # noqa: E731
        int8 = lambda: torch._int_mm(x8, w8.T)                 # noqa: E731
        row = {"ms": round(_time_ms(kernel), 6),
               "graph_ms": round(_time_graph_ms(kernel), 6),
               "cold_ms": round(_time_cold_ms(kernel), 6),
               "plain_ms": round(_time_ms(
                   lambda: PG.popcount_gemm_plain(x, w, "xnor"), reps=5), 6),
               "bound_ms": round(max(t_ops, t_bytes), 6),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library_ms": round(_time_ms(bf16), 6),
               "library_graph_ms": round(_time_graph_ms(bf16), 6),
               "library_cold_ms": round(_time_cold_ms(bf16), 6),
               "library_int8_ms": round(_time_ms(int8), 6),
               "library_int8_graph_ms": round(_time_graph_ms(int8), 6),
               "library_int8_cold_ms": round(_time_cold_ms(int8), 6),
               "library_int8_max_abs_diff": _diff(int8(), kernel()),
               "int8_ops_bound_ms": round(
                   2 * m * n * 32 * kb / INT8_OPS_PER_S * 1e3, 6),
               "device_kernels_per_call": 2,
               "shape": {"M": m, "N": n, "KB": kb, "kind": "xnor"}}
        for how in ("", "graph_", "cold_"):
            row[f"{how}vs_library"] = round(
                row[f"{how}ms"] / row[f"library_{how}ms"], 4)
            row[f"{how}vs_library_int8"] = round(
                row[f"{how}ms"] / row[f"library_int8_{how}ms"], 4)
        row["graph_share_of_bound"] = round(
            row["bound_ms"] / row["graph_ms"], 4)
        print(f"[popcount_gemm] {name} {row['shape']}: kernel / bf16 mm "
              f"queued {row['vs_library']}, graph {row['graph_vs_library']}, "
              f"cold {row['cold_vs_library']}; kernel / int8 _int_mm queued "
              f"{row['vs_library_int8']}, graph "
              f"{row['graph_vs_library_int8']}, cold "
              f"{row['cold_vs_library_int8']}; graph share of bound "
              f"{row['graph_share_of_bound']}", flush=True)
        assert row["library_int8_max_abs_diff"] == 0, "_int_mm != kernel"
        timing[name] = row
        del xb, wb, x8, w8
    up = timing.pop("up")
    return {"name": "popcount_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/popcount_gemm.cu",
            "replaces": "src/repro/kernels/popcount_gemm.py:73",
            "launches": None, "max_abs_err": float(worst), **up,
            "down_shape": timing["down"],
            "bound_rate": {"one_bit_ops_per_s": ONE_BIT_OPS_PER_S,
                           "bytes_per_s": HBM_BYTES_PER_S}}


class Counts:
    """The launch counters of every kernel, reset and read per path, and
    each path's wall time (host clock from the reset to the synchronize
    of the read)."""

    def __init__(self, S, BW, BS, PG, FA):
        self.S = S
        self.dicts = (BW.launches, BS.launches, PG.launches, FA.launches)
        self.by_path: dict[str, dict[str, int]] = {}
        self.wall_s: dict[str, float] = {}
        self._t0 = 0.0

    def reset(self) -> None:
        self.S.launches = 0
        for d in self.dicts:
            for k in d:
                d[k] = 0
        self._t0 = time.perf_counter()

    def read(self, path: str) -> dict[str, int]:
        torch.cuda.synchronize()
        self.wall_s[path] = time.perf_counter() - self._t0
        c = {"senseamp_resolve": self.S.launches}
        for d in self.dicts:
            c.update(d)
        self.by_path[path] = c
        print(f"[launches] {path}: {json.dumps(c)} in "
              f"{self.wall_s[path]} s", flush=True)
        return c

    def total(self, name: str) -> int:
        return sum(c[name] for c in self.by_path.values())


def _values(planes: torch.Tensor) -> torch.Tensor:
    """(K, R, C) LSB-first planes -> the (R, 32C) integers they slice."""
    from repro_torch.kernels.ops import unpack_bits
    out = None
    for i in range(planes.shape[0]):
        v = unpack_bits(planes[i]).long() << i
        out = v if out is None else out + v
    return out


def engine_path(counts: Counts) -> dict:
    """The PuD engine's plane path on ``PudEngine("kernel")``, workload by
    workload, each held to a direct computation on the card."""
    from repro_torch.kernels.ops import unpack_bits
    from repro_torch.pud import masks as M
    from repro_torch.pud import workloads as W
    from repro_torch.pud.bloom import PudBloomFilter
    from repro_torch.pud.engine import PudEngine
    dev = torch.device("cuda")
    eng = PudEngine("kernel", device="cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2024)
    only = lambda c, **want: all(c[k] == want.get(k, 0) for k in c)
    out: dict = {}

    # attention mask: causal & window 4096 & 8 documents & last 1024 padded
    s, window = 16384, 4096
    i = torch.arange(s, device=dev)
    doc, valid = i // (s // 8), i < s - 1024
    counts.reset()
    got = M.compose_attention_mask(eng, s, window=window, doc_ids=doc,
                                   valid=valid)
    c = counts.read("engine_masks")
    assert only(c, nary_bitwise=1), c
    want = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
    want &= doc[:, None] == doc[None, :]
    want &= valid[None, :]
    assert torch.equal(got, want), "attention mask != direct"
    out["mask_keep_fraction"] = float(got.float().mean())
    del got, want
    # the positions an additive attention bias blocks: NOT of the causal plane
    causal = M.causal_plane(s, dev)
    counts.reset()
    blocked = eng.not_(causal)
    c = counts.read("engine_not")
    assert only(c, bitwise_not=1), c
    assert torch.equal(unpack_bits(blocked).bool(), i[:, None] < i[None, :]), \
        "NOT of the causal plane != the future positions"
    del causal, blocked

    # MoE routing: 32768 tokens, top-4 of 60 experts (qwen2_moe_a2_7b)
    t, e, k = 32768, 60, 4
    gate = torch.randn((t, e), generator=gen, device=dev).topk(k, 1).indices
    counts.reset()
    planes = M.route_mask_planes(eng, gate, e)
    c = counts.read("engine_routing")
    assert only(c, nary_bitwise=1), c
    bits = unpack_bits(planes)[:, :t].bool()
    want = (gate[None] == torch.arange(e, device=dev)[:, None, None]).any(2)
    assert torch.equal(bits, want), "routing planes != (gate == e).any(1)"

    # Bloom dedup: 2**26 bits, 4 hashes, 4M keys in 8 batches, 1M probes
    m_bits, n_hashes, batch = 2 ** 26, 4, 2 ** 19
    keys = np.arange(8 * batch, dtype=np.uint64)
    fresh = np.arange(2 ** 40, 2 ** 40 + 2 ** 20, dtype=np.uint64)
    bf = PudBloomFilter(m_bits, n_hashes, engine=eng)
    counts.reset()
    for lo in range(0, len(keys), batch):
        bf.insert(keys[lo:lo + batch])
    present = bf.probe(keys)
    fp = float(bf.probe(fresh).float().mean())
    c = counts.read("engine_bloom")
    assert only(c, nary_bitwise=8 + 2), c
    assert bool(present.all()), "an inserted key was reported absent"
    theory = (1 - np.exp(-n_hashes * len(keys) / m_bits)) ** n_hashes
    print(f"[bloom] false-positive rate {fp} theory {theory} fill "
          f"{bf.fill_fraction}", flush=True)
    assert 0.5 * theory <= fp <= 2.0 * theory, (fp, theory)
    out["bloom_fp_rate"], out["bloom_fp_theory"] = fp, float(theory)

    # bit-serial add (K = 16) and popcount (16 planes) over (1024, 1024)
    a = _words(gen, 16, 1024, 1024)
    b = _words(gen, 16, 1024, 1024)
    counts.reset()
    total = eng.add(a, b)
    c = counts.read("engine_add")
    assert only(c, add_planes=1), c
    assert torch.equal(_values(total), _values(a) + _values(b)), "add"
    del total, b
    counts.reset()
    cnt = eng.popcount(a)
    c = counts.read("engine_popcount")
    assert only(c, bitcount_planes=1), c
    per_bit = sum(unpack_bits(a[j]).long() for j in range(a.shape[0]))
    assert torch.equal(_values(cnt), per_bit), "popcount"
    del cnt, a, per_bit

    # bit-serial dot product: M = N = 64, K = 256
    x = torch.randint(0, 2, (64, 256), generator=gen, device=dev)
    w = torch.randint(0, 2, (64, 256), generator=gen, device=dev)
    n_instr = sum(v for op, v in W.dot_program(256).stats().items()
                  if op not in ("input", "const"))
    counts.reset()
    y = W.dot_bitserial(x, w, eng)
    c = counts.read("engine_dot")
    assert c["nary_bitwise"] + c["bitwise_not"] == n_instr, (c, n_instr)
    assert only(c, nary_bitwise=c["nary_bitwise"],
                bitwise_not=c["bitwise_not"]), c
    assert torch.equal(y.cpu().long(), x.cpu() @ w.cpu().T), "dot"
    out["dot_instructions"] = n_instr
    out["report"] = eng.report.summary()
    return out


def dram_path(counts: Counts, and16: float) -> dict:
    """The engine's dram backend on the card: 16-plane AND over (128, 1024)
    planes — 1024 row chunks of 4096 bits in 32 blocks, one senseamp launch
    each.  Ideal: equal to the kernel backend, on planes that share half
    their bits (so the AND keeps about half).  Noisy: on uniformly random
    planes, the operand patterns of Fig. 15's Monte-Carlo, the mismatches
    land near its failure rate."""
    from repro_torch.kernels.ops import nary_bitwise, unpack_bits
    from repro_torch.pud.engine import PudEngine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(77)
    shared = _words(gen, 1, 128, 1024) | _words(gen, 16, 128, 1024)
    blocks = 32
    out = {}
    for noisy, planes in ((False, shared),
                          (True, _words(gen, 16, 128, 1024))):
        want = nary_bitwise(planes, "and")
        eng = PudEngine("dram", noisy=noisy, device="cuda")
        path = "dram_noisy" if noisy else "dram_ideal"
        counts.reset()
        got = eng.nary(planes, "and")
        c = counts.read(path)
        assert c["senseamp_resolve"] == blocks, c
        assert sum(c.values()) == blocks, c
        wrong = float(unpack_bits(got ^ want).float().mean())
        if noisy:
            print(f"[dram] noisy and16 mismatch fraction {wrong}; "
                  f"1 - Fig. 15 and16 rate {1 - and16}", flush=True)
            assert 0.0 < wrong < 0.15, wrong
            out["noisy_mismatch"] = wrong
        else:
            assert wrong == 0.0, "dram (ideal) != kernel backend"
            out["ideal_ones_fraction"] = float(
                unpack_bits(got).float().mean())
    return out


def quant_path(counts: Counts) -> dict:
    """Binary linears at qwen3_4b's projection widths on 2048 tokens: up
    (2560 -> 9728) then down (9728 -> 2560), one popcount_gemm each; the
    integer dots held to the plain version bit for bit, the outputs within
    1e-6 relative; then 5 STE SGD steps of the up layer against a
    sign-teacher target (float32 products: TF32 off), the loss falling at
    every step."""
    from repro_torch.kernels import popcount_gemm as PG
    from repro_torch.models import quant as Q
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4096)
    up = Q.BinaryLinear(D_MODEL, D_FF, generator=gen, device="cuda")
    down = Q.BinaryLinear(D_FF, D_MODEL, generator=gen, device="cuda")
    x = torch.randn((TOKENS, D_MODEL), generator=gen, device="cuda")
    only = lambda c, **want: all(c[k] == want.get(k, 0) for k in c)
    with torch.no_grad():
        counts.reset()
        h = up(x)
        y = down(h)
        c = counts.read("quant_path")
    assert only(c, popcount_gemm=2), c
    t1 = time.perf_counter()
    walls["setup_and_forward_s"] = t1 - t0
    assert y.shape == (TOKENS, D_MODEL) and bool(torch.isfinite(y).all())
    worst_rel = 0.0
    for layer, inp, out in ((up, x, h), (down, h, y)):
        xq, sx = Q.binarize_pack(inp)
        wq, sw = Q.binarize_pack(layer.weight.detach())
        dots = PG.popcount_gemm_cuda(xq, wq, "xnor")
        plain = PG.popcount_gemm_plain(xq, wq, "xnor")
        assert torch.equal(dots, plain), "binary linear dots != plain"
        pad = (-inp.shape[1]) % 32
        want = (plain.float() - pad) * sx * sw.T
        rel = float((out - want).abs().max() / want.abs().max())
        worst_rel = max(worst_rel, rel)
        assert rel <= 1e-6, rel
    del h, y
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    walls["check_vs_plain_s"] = t2 - t1
    # STE training: 5 SGD steps against a sign teacher (unit-variance y);
    # the set-up timed piece by piece (host clock, synchronized)
    def lap(name: str) -> None:
        nonlocal t2
        torch.cuda.synchronize()
        now = time.perf_counter()
        walls[name] = now - t2
        t2 = now

    teacher = torch.sign(torch.randn((D_FF, D_MODEL), generator=gen,
                                     device="cuda"))
    target = x @ teacher.T / D_MODEL ** 0.5
    lap("teacher_and_target_s")
    # torch.optim imports torch._dynamo lazily on an optimizer's first
    # construction in a process: that import is this lap
    dynamo_before = "torch._dynamo" in sys.modules
    opt = torch.optim.SGD(up.parameters(), lr=10.0)
    lap("optimizer_init_s")
    walls["optimizer_init_imported_dynamo"] = (
        not dynamo_before and "torch._dynamo" in sys.modules)
    losses = []
    counts.reset()
    for _ in range(5):
        opt.zero_grad()
        loss = ((up(x) - target) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        losses.append(float(((up(x) - target) ** 2).mean()))
    c = counts.read("quant_train")
    assert only(c, popcount_gemm=6), c
    lap("train_s")
    print(f"[quant] STE losses {losses}", flush=True)
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    return {"max_rel_err": worst_rel, "ste_losses": losses, "walls": walls}


def program_path(counts: Counts) -> dict:
    """The binary dot product as compiled programs on the simulated banks
    (native 8192-bit rows), held against the popcount GEMM kernel and the
    ``kernel`` backend; the program Monte-Carlo; numpy-draw parity."""
    from repro_torch.core import charz
    from repro_torch.core.policy import ResidentPolicy
    from repro_torch.kernels import ops
    from repro_torch.pud import workloads as W
    from repro_torch.pud.engine import PudEngine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(808)
    out: dict = {}
    only_sa = lambda c: c["senseamp_resolve"] > 0 and sum(c.values()) == \
        c["senseamp_resolve"]
    # dot_bitserial_tree: M = N = 128, K = 32 over 4 banks
    x = torch.randint(0, 2, (128, 32), generator=gen, device="cuda")
    w = torch.randint(0, 2, (128, 32), generator=gen, device="cuda")
    for noisy in (False, True):
        path = "program_tree_noisy" if noisy else "program_tree"
        counts.reset()
        got, arr = W.dot_bitserial_tree(x, w, banks=4, noisy=noisy,
                                        device="cuda")
        c = counts.read(path)
        assert only_sa(c), c
        counts.reset()
        want = ops.popcount_gemm_bits(x, w)
        c = counts.read(path + "_golden")
        assert c["popcount_gemm"] == 1 and sum(c.values()) == 1, c
        assert torch.equal(want.cpu().long(), x.cpu() @ w.cpu().T)
        if noisy:
            rate = float((got != want).float().mean())
            print(f"[program] dot_bitserial_tree noisy: {rate} of the "
                  f"(128, 128) counts differ from the kernel", flush=True)
            assert 0.0 < rate <= 1.0, rate
            out["tree_noisy_mismatch"] = rate
        else:
            assert torch.equal(got, want), "dot_bitserial_tree != kernel"
            out["tree_makespan_ns"] = arr.makespan_ns()
    # the dram engine, 4 banks: the dot program over (16, 1024) planes
    # (128 row chunks in 4 blocks of 32) and an 8-bit add
    prog = W.dot_program(8)
    planes = {f"{s}{i}": _words(gen, 16, 1024) for s in "ab"
              for i in range(8)}
    a, b = _words(gen, 8, 16, 1024), _words(gen, 8, 16, 1024)
    eng = PudEngine("dram", banks=4, device="cuda")
    counts.reset()
    got = eng.run_program(prog, planes)
    total = eng.add(a, b)
    c = counts.read("program_engine")
    assert only_sa(c), c
    kern = PudEngine("kernel", device="cuda")
    want = kern.run_program(prog, planes)
    assert all(torch.equal(got[k], want[k]) for k in want), "dram != kernel"
    assert torch.equal(total, kern.add(a, b)), "dram add != kernel"
    out["engine_report"] = eng.report.summary()
    # program-level Monte-Carlo, host-staged and scheduled-resident
    rates = {}
    counts.reset()
    for name in charz.PROGRAMS:
        for pol in (ResidentPolicy.HOST, ResidentPolicy.SCHEDULED):
            rates[f"{name}_{pol.value}"] = charz.mc_program_success(
                name, trials=2000, row_bits=8192, resident=pol,
                device="cuda")
    c = counts.read("program_mc")
    assert only_sa(c), c
    print("[program] mc_program_success " + json.dumps(rates) + " reference "
          + json.dumps(REF_PROGRAM_RATES), flush=True)
    for k, r in rates.items():
        assert abs(r - REF_PROGRAM_RATES[k]) < 0.02, (k, r)
    out["mc_rates"] = rates
    # numpy draws: card == CPU (program MC, resident, and the noisy tree)
    par = {dev: (charz.mc_program_success(
        "add4", trials=18, row_bits=512, resident=ResidentPolicy.SCHEDULED,
        draws="numpy", device=dev),
        W.dot_bitserial_tree(x[:4, :9].cpu(), w[:5, :9].cpu(), banks=3,
                             row_bits=2048, noisy=True, draws="numpy",
                             device=dev)[0].cpu())
        for dev in ("cuda", "cpu")}
    assert par["cuda"][0] == par["cpu"][0], par
    assert torch.equal(par["cuda"][1], par["cpu"][1]), "tree: card != CPU"
    print(f"[parity] program MC + noisy tree, draws=numpy: cuda == cpu "
          f"({par['cuda'][0]})", flush=True)
    return out


def characterization_path(counts: Counts) -> dict:
    """The rest of the paper's characterization and the static analysis, on
    the card at native 8192-bit rows: the bloom probe / insert fan-in sweep
    beside the independent-op estimate, replica plans (one from the sweep,
    one with its own add4 MC), the 4-bank nand16 MC's modeled timing
    (``stats=``: optimistic and rank-legal makespans), the plan verifier
    over the program zoo, the timing lint and rank scheduler over ``dram``
    engine logs, Obs. 3's per-cell map; then ``draws="numpy"`` card == CPU
    for the sweep, the ``stats`` dict and ``apa_then_write``.  Every
    launch is a senseamp launch."""
    from repro_torch import analysis
    from repro_torch.core import charz
    from repro_torch.core import compiler as CC
    from repro_torch.core import reliability as R
    from repro_torch.core.isa import PudIsa, inventory_for
    from repro_torch.core.policy import ResidentPolicy
    from repro_torch.core.simulator import BankSim
    from repro_torch.pud import workloads as W
    from repro_torch.pud.engine import PudEngine
    out: dict = {}
    S = counts.S

    def step(name: str, t0: float, before: int) -> float:
        torch.cuda.synchronize()
        now = time.perf_counter()
        out.setdefault("steps", {})[name] = {
            "s": round(now - t0, 3), "senseamp": S.launches - before}
        return now

    counts.reset()
    t0, n0 = time.perf_counter(), S.launches
    # the workload fan-in sweep, device draws
    sweep = charz.workload_fanin_sweep(
        ("bloom_probe", "bloom_insert"), SWEEP_FANINS, trials=SWEEP_TRIALS,
        row_bits=ROW_BITS, draws="device", device="cuda")
    for name, r in sweep.items():
        print(f"[charz] {name}: mc_success {r['mc_success']} estimate "
              f"{r['estimate']}", flush=True)
    for n in SWEEP_FANINS:
        r = sweep[f"bloom_probe{n}"]
        assert r["mc_success"] >= r["estimate"] - EST_BAND, (n, r)
        assert r["mc_success"] < 1.0, (n, r)
    probe = [sweep[f"bloom_probe{n}"]["mc_success"] for n in SWEEP_FANINS]
    assert probe[-1] >= probe[0] - MONO_BAND, probe
    out["sweep"] = sweep
    t0, n0 = step("sweep", t0, n0), S.launches
    # replica plans
    pw = R.plan_workload("bloom_probe", fanin=16, target=0.999999,
                         mc_success=sweep["bloom_probe16"]["mc_success"])
    pa = R.plan(target=0.999999, program="add4", trials=SWEEP_TRIALS,
                row_bits=ROW_BITS, device="cuda")
    assert S.launches > n0, "plan(program=) ran no MC on the card"
    for tag, pl in (("bloom_probe16", pw), ("add4", pa)):
        print(f"[charz] plan {tag}: replicas {pl.replicas} p_raw {pl.p_raw} "
              f"p_final {pl.p_final} ops_total {pl.ops_total}", flush=True)
        assert pl.replicas % 2 == 1 and 0.0 < pl.p_raw < 1.0, pl
    out["plans"] = {"bloom_probe16": dataclasses.asdict(pw),
                    "add4": dataclasses.asdict(pa)}
    t0, n0 = step("plans", t0, n0), S.launches
    # stats: the 4-bank nand16 MC's modeled timing
    stats: dict = {}
    rate = charz.mc_boolean_success("nand", 16, trials=TRIALS,
                                    row_bits=ROW_BITS, banks=4, stats=stats,
                                    device="cuda")
    print(f"[charz] nand16 banks=4 {rate} stats " + json.dumps(stats),
          flush=True)
    assert abs(rate - PAPER_16["nand"]) < 0.04, rate
    assert stats["legal_makespan_ns"] >= stats["makespan_ns"] > 0.0, stats
    assert S.launches - n0 == charz.MC_PAIR_GROUPS
    out["nand16_banks4"], out["stats"] = rate, stats
    t0, n0 = step("stats", t0, n0), S.launches
    # static analysis: the verifier over the zoo's plans on a card bank
    findings, verify_s = 0, 0.0
    for name in charz.PROGRAMS + charz.WORKLOAD_PROGRAMS:
        prog = charz.get_program(name)
        for pol in ("greedy", "scheduled"):
            isa = PudIsa(BankSim(row_bits=ROW_BITS, error_model="ideal",
                                 seed=11, device="cuda"))
            plan = CC.schedule_resident(prog, isa, policy=pol, verify=False)
            tv = time.perf_counter()
            findings += len(analysis.verify_plan(prog, plan))
            verify_s += time.perf_counter() - tv
    # the reference's 2-bank loop engine case, then program + add under
    # verify=True on 4 banks: every plan verified, logs linted, scheduled
    loop = PudEngine("dram", banks=2, resident=ResidentPolicy.SCHEDULED,
                     verify=True, device="cuda")
    rng = np.random.default_rng(7)
    loop.run_program(charz.get_program("xor"), {
        k: rng.integers(0, 2 ** 32, (4, 4), dtype=np.uint32)
        for k in ("a", "b")})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(909)
    eng = PudEngine("dram", banks=4, verify=True, device="cuda")
    twin = PudEngine("torch", device="cuda")
    planes = {f"{c}{i}": _words(gen, 16, 256) for c in "ab"
              for i in range(4)}
    got = eng.run_program(W.dot_program(4), planes)
    want = twin.run_program(W.dot_program(4), planes)
    assert all(torch.equal(got[k], want[k]) for k in want)
    a, b = _words(gen, 8, 16, 256), _words(gen, 8, 16, 256)
    assert torch.equal(eng.add(a, b), twin.add(a, b))
    static = {}
    for tag, e in (("loop", loop), ("program_add", eng)):
        rep = analysis.lint_bank_array(e._array)
        tl = e.schedule_timing()
        static[tag] = {
            "timing_violations": rep.violations,
            "timing_by_design": sum(sum(r.by_design.values())
                                    for r in rep.per_bank),
            "makespan_ns": rep.makespan_ns,
            "min_legal_makespan_ns": rep.min_legal_makespan_ns,
            "legal_makespan_ns": tl.legal_makespan_ns,
            "refresh_stall_ns": tl.refresh_stall_ns,
            "rank_stall_ns": tl.rank_stall_ns,
            "sched_violations": tl.relint_violations}
        assert rep.violations == 0 and tl.relint_violations == 0, static
    print(f"[static] verify findings {findings} over "
          f"{2 * len(charz.PROGRAMS + charz.WORKLOAD_PROGRAMS)} zoo plans "
          f"({round(verify_s * 1e3, 3)} ms); " + json.dumps(static),
          flush=True)
    assert findings == 0
    assert static["loop"] == REF_STATIC_LOOP, static["loop"]
    out["static"] = static | {"verify_findings": findings,
                              "verify_ms_total": verify_s * 1e3}
    t0, n0 = step("static", t0, n0), S.launches
    # Obs. 3: 100 %-reliable cells of the 4-input AND's per-cell map, on
    # the card's draws and on the reference's (numpy) draws, card and CPU
    obs3 = {mode: charz.observation3_perfect_cells(
        trials=300, draws=draws, device=dev)
        for mode, draws, dev in (("device", "device", "cuda"),
                                 ("numpy", "numpy", "cuda"),
                                 ("numpy_cpu", "numpy", "cpu"))}
    print("[charz] observation3 " + json.dumps(obs3), flush=True)
    assert obs3["numpy"]["n_cells"] == obs3["device"]["n_cells"]
    assert {k: v for k, v in obs3["numpy"].items() if k != "mean"} == \
        {k: v for k, v in obs3["numpy_cpu"].items() if k != "mean"}
    assert abs(obs3["numpy"]["mean"] - obs3["numpy_cpu"]["mean"]) < 1e-12
    # the same chip identity: only the per-trial draws differ
    assert abs(obs3["device"]["mean"] - obs3["numpy"]["mean"]) < 0.01, obs3
    out["obs3"] = obs3
    t0, n0 = step("obs3", t0, n0), S.launches
    # numpy draws: card == CPU
    par = {}
    for dev in ("cuda", "cpu"):
        st: dict = {}
        sw = charz.workload_fanin_sweep(
            ("bloom_probe", "bloom_insert"), SWEEP_FANINS, trials=64,
            row_bits=2048, draws="numpy", device=dev)
        r = charz.mc_boolean_success("nand", 16, trials=108, row_bits=2048,
                                     banks=4, stats=st, draws="numpy",
                                     device=dev)
        sim = BankSim(row_bits=ROW_BITS, error_model="analog", trials=64,
                      seed=5, draws="numpy", device=dev)
        rf, rl = inventory_for(sim.module, sim.seed).choose(4, 4, 0)
        pat = np.random.default_rng(5).integers(0, 2, ROW_BITS)
        act = sim.apa_then_write(sim.global_addr(0, rf),
                                 sim.global_addr(1, rl), pat)
        written = sim.snapshot_rows(0, act.rows_f).cpu()
        sim.apa(sim.global_addr(0, rf), sim.global_addr(1, rl))
        par[dev] = (sw, r, st, written, sim.snapshot_rows(1, act.rows_l).cpu())
    assert par["cuda"][:3] == par["cpu"][:3], "sweep / stats: card != CPU"
    assert torch.equal(par["cuda"][3], par["cpu"][3])
    assert torch.equal(par["cuda"][4], par["cpu"][4]), "apa_then_write"
    print("[parity] fan-in sweep, stats, apa_then_write + APA, "
          "draws=numpy: cuda == cpu", flush=True)
    step("parity", t0, n0)
    c = counts.read("characterization")
    assert c["senseamp_resolve"] > 0 and \
        sum(c.values()) == c["senseamp_resolve"], c
    print("[charz] steps " + json.dumps(out["steps"]), flush=True)
    return out


def maj3_path(counts: Counts) -> None:
    """``ops.maj3``, the reference's entry point of its own, once at the
    (16384, 512) shape, held to the direct computation."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(333)
    a, b, c3 = (_words(gen, 16384, 512) for _ in range(3))
    counts.reset()
    got = ops.maj3(a, b, c3)
    c = counts.read("maj3_entry")
    assert c["maj3"] == 1 and sum(c.values()) == 1, c
    assert torch.equal(got, (a & b) | (c3 & (a | b))), "maj3 != direct"


# ---------------------------------------------------------------------------
# The serving path: the attention kernel, then qwen3-4b behind the engine
# ---------------------------------------------------------------------------
def _attention_case(gen, b, sq, sk, h, kv, hd, qdt, kvdt, q_pos, kv_pos):
    """Normal q (B, Sq, H, hd) in ``qdt`` and k / v (B, Sk, KV, hd) in
    ``kvdt`` on the card, with the given int32 positions."""
    q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(qdt)
    k = torch.randn((b, sk, kv, hd), generator=gen, device="cuda").to(kvdt)
    v = torch.randn((b, sk, kv, hd), generator=gen, device="cuda").to(kvdt)
    return q, k, v, q_pos.int().contiguous(), kv_pos.int().contiguous()


def _attention_bound(q, k, q_pos, kv_pos) -> tuple[float, str, dict]:
    """Least time (ms) for these inputs: operations 4·H·(visible pairs)·hd
    at the dense rate of q's type (bf16 tensor cores, else float32), bytes
    = q, out, lse and the positions once plus each K/V row that some query
    sees, in the cache's type."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    keep = q_pos[:, :, None] >= kv_pos[:, None, :]          # (B, Sq, Sk)
    pairs = int(keep.sum()) * h
    rows = int(keep.any(1).sum())
    nops = 4 * pairs * hd
    nbytes = (2 * q.numel() * q.element_size() + 4 * b * h * sq
              + 4 * (q_pos.numel() + kv_pos.numel())
              + 2 * rows * kvh * hd * k.element_size())
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else OPS_PER_S
    t_ops, t_bytes = nops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    count = {"visible_pairs": pairs, "visible_kv_rows": rows,
             "operations": nops, "bytes": nbytes}
    if t_ops >= t_bytes:
        return t_ops, "operations", count
    return t_bytes, "bytes", count


def _time_graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call back to back with no host launch cost
    between calls: ``reps`` calls captured in a CUDA graph (after a
    warm-up on a side stream), one replay timed with CUDA events, over the
    count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _time_cold_ms(fn, reps: int = 10) -> float:
    """Device time of one call that finds the L2 cache cold: CUDA events
    around each call, a 256 MiB buffer (five times the 50 MB L2) written
    between calls — long enough on the device that the host has queued the
    call before it starts — the mean over ``reps``."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    for _ in range(2):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for i, (a, b) in enumerate(evs):
        flush.fill_(float(i))
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


#: bf16 out vs the plain version, per element (``bf16_out_tolerance``):
#: out's own rounding plus P's, rounded to bf16 at another running max
BF16_OUT_TOL = "1e-3 + 2^-6 |want| + 2^-5 sqrt(sum p^2 v^2) / l"


def _excess(got: torch.Tensor, want: torch.Tensor,
            tol: torch.Tensor) -> float:
    """max |got - want| / tol: at most 1 passes."""
    return float(((got.float() - want.float()).abs() / tol).max())


def check_flash_attention(FA) -> tuple[dict, dict]:
    """The attention kernels against their plain versions on the card.

    Shapes: the serving path's prefill (B = 1, 2048 queries at positions
    0..2047 over a 4096-slot cache whose second half holds POS_SENTINEL)
    and decode (B = 4, one query per slot at 4095 / 3071 / 2047 / 1023,
    the slots' unwritten tails holding the sentinel — the split path, 16
    splits of 4 tiles), with qwen3-4b's 32 / 8 heads of 80; then windowed
    + softcapped, ragged, hd 16 / 128 and G = 3 cases, split decodes (an
    all-sentinel slot, a window, G = 3, a 5-token chunk) and prefills long
    enough for many ring stages over a ragged Sk (one over more tiles than
    a visibility pass flags).  Types: bf16 q with a
    float32 cache (the serving types) and all float32.  Tolerances: float32
    1e-5 on out and lse (only the summation order differs); bf16 q
    ``BF16_OUT_TOL`` per element of out and 1e-4 on lse (float32 sums of
    the same exact bf16 products).  Timed (bf16 q, float32 cache) at the
    prefill and decode shapes against the bound, the plain version and
    ``scaled_dot_product_attention`` on bf16 K/V repeated to the 32 heads
    (prefill: ``is_causal`` over the prompt's own keys; decode: a boolean
    mask from the positions) — the same visible pairs — three ways: back
    to back queued from Python (``ms``, ``library_ms``: as every kernel
    row is timed, host launch cost included where it is the slower side),
    back to back in a CUDA graph (``graph_ms``: device time alone) and
    with the L2 cache flushed before each call (``cold_ms``); each
    ``*vs_library`` is kernel / SDPA on one measure.  The merge kernel is held
    to its plain version on the plain split partials of the decode shape.
    -> (the attention row, the merge row)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8080)
    h, kvh, hd, sk = 32, 8, 80, SERVE_MAX_LEN
    ar = torch.arange(sk, device="cuda")
    pre_q = torch.arange(2048, device="cuda")[None]
    pre_kv = torch.where(ar < 2048, ar, SENTINEL)[None]
    slot_pos = torch.tensor([4095, 3071, 2047, 1023], device="cuda")
    dec_kv = torch.where(ar[None] <= slot_pos[:, None], ar[None], SENTINEL)
    shapes = {"prefill": (1, 2048, sk, h, kvh, hd, pre_q, pre_kv, 0, 0.0),
              "decode": (4, 1, sk, h, kvh, hd, slot_pos[:, None], dec_kv,
                         0, 0.0)}
    small = []
    for b, sq, skk, hh, kk, d, q0, w, cap, tail in (
            (2, 100, 300, 8, 2, 64, 200, 37, 30.0, 17),
            (2, 77, 1000, 6, 2, 16, 923, 0, 0.0, 17),
            (1, 130, 200, 4, 4, 128, 70, 0, 5.0, 17),
            (3, 1, 333, 6, 2, 80, 300, 64, 0.0, 17),
            # split decodes: an all-sentinel slot, a window, G = 3, a chunk
            (4, 1, sk, h, kvh, hd, sk - 1, 0, 0.0, sk),
            (4, 1, sk, h, kvh, hd, sk - 1, 700, 0.0, 0),
            (3, 1, 2000, 6, 2, hd, 1999, 0, 0.0, 300),
            (2, 5, 3000, h, kvh, hd, 2995, 0, 30.0, 100),
            # prefills over many ring stages, ragged Sk
            (1, 1000, 1333, h, kvh, hd, 333, 0, 0.0, 0),
            (2, 517, 2100, 16, 4, 64, 1500, 0, 0.0, 90),
            (1, 700, 3001, h, kvh, hd, 2301, 512, 0.0, 5),
            # more tiles than one visibility pass flags
            (1, 100, 7000, h, kvh, hd, 6900, 0, 0.0, 30)):
        qp = (torch.arange(sq, device="cuda") + q0).repeat(b, 1)
        kp = torch.arange(skk, device="cuda").repeat(b, 1)
        if tail:
            kp[-1, skk - tail:] = SENTINEL
        small.append((b, sq, skk, hh, kk, d, qp, kp, w, cap))
    worst = {"bf16_out": 0.0, "bf16_lse": 0.0, "f32_out": 0.0,
             "f32_lse": 0.0}
    tol = {"bf16_out": BF16_OUT_TOL, "bf16_lse": 1e-4, "f32_out": 1e-5,
           "f32_lse": 1e-5}
    # the largest |diff| / tolerance of bf16 out: at most 1
    out_vs_tol = 0.0
    timing = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, case in [*shapes.items(), *enumerate(small)]:
        b, sq, skk, hh, kk, d, qp, kp, w, cap = case
        for qdt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            args = _attention_case(gen, b, sq, skk, hh, kk, d, qdt,
                                   torch.float32, qp, kp)
            got = FA.flash_attention_cuda(*args, window=w, softcap=cap)
            want = FA.flash_attention_plain(*args, window=w, softcap=cap)
            torch.cuda.synchronize()
            for part, x, y in (("out", got[0], want[0]),
                               ("lse", got[1], want[1])):
                err = float((x.float() - y.float()).abs().max())
                key = f"{tag}_{part}"
                worst[key] = max(worst[key], err)
                if key == "bf16_out":
                    excess = _excess(x, y, FA.bf16_out_tolerance(
                        *args, want, window=w, softcap=cap))
                    out_vs_tol = max(out_vs_tol, excess)
                    assert excess <= 1.0, (name, key, err, excess)
                else:
                    assert err <= tol[key], (name, key, err)
            if tag != "bf16" or name not in shapes:
                continue
            bound, by, count = _attention_bound(args[0], args[1], qp, kp)
            q, k, v = args[:3]
            qs = q.transpose(1, 2)
            ks, vs = (t.to(torch.bfloat16).repeat_interleave(hh // kk, 2)
                      .transpose(1, 2) for t in (k, v))
            if name == "prefill":
                ks, vs = ks[:, :, :sq].contiguous(), vs[:, :, :sq].contiguous()
                library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    qs, ks, vs, is_causal=True)
            else:
                ks, vs = ks.contiguous(), vs.contiguous()
                mask = kp[:, None, None, :] <= qp[:, None, :, None]
                library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                    qs, ks, vs, attn_mask=mask)
            lib_err = float((library().transpose(1, 2).float()
                             - got[0].float()).abs().max())
            kernel = lambda: FA.flash_attention_cuda(  # noqa: E731
                *args, window=w, softcap=cap)
            split = FA.split_plan(b, sq, hh, kk, skk, sms)
            row = timing[name] = {
                "ms": round(_time_ms(kernel), 6),
                "graph_ms": round(_time_graph_ms(kernel), 6),
                "cold_ms": round(_time_cold_ms(kernel), 6),
                "plain_ms": round(_time_ms(lambda: FA.flash_attention_plain(
                    *args, window=w, softcap=cap), reps=5), 6),
                "bound_ms": round(bound, 6), "bound_by": by,
                "library_ms": round(_time_ms(library), 6),
                "library_graph_ms": round(_time_graph_ms(library), 6),
                "library_cold_ms": round(_time_cold_ms(library), 6),
                "library_max_abs_diff": lib_err, **count,
                "n_split": split[0], "split_tiles": split[1],
                "shape": {"B": b, "Sq": sq, "Sk": skk, "H": hh, "KV": kk,
                          "hd": d, "q": "bfloat16", "kv": "float32"}}
            for how in ("", "graph_", "cold_"):
                row[f"{how}vs_library"] = round(
                    row[f"{how}ms"] / row[f"library_{how}ms"], 4)
            if name == "decode":
                merge = _check_combine(FA, args, split, timing[name])
            del ks, vs
    print("[flash_attention] kernel vs plain max |diff| " + json.dumps(worst)
          + " tolerances " + json.dumps(tol) + " bf16 out |diff| / tolerance "
          + f"{out_vs_tol:.4f}", flush=True)
    for name, row in timing.items():
        print(f"[flash_attention] {name} kernel / SDPA: queued "
              f"{row['vs_library']}, graph {row['graph_vs_library']}, cold "
              f"{row['cold_vs_library']}", flush=True)
    pre = timing["prefill"]
    return ({"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention.py:81",
             "launches": None, "max_abs_err": max(worst.values()),
             "errors": worst, "bf16_out_vs_tol": out_vs_tol, **pre,
             "decode_shape": timing["decode"]},
            merge)


def _check_combine(FA, args, split, dec) -> dict:
    """The merge kernel on the plain split partials of the decode shape:
    out within its bf16 rounding (1e-3 + 2^-6 |want|), lse within 1e-5; timed
    back to back (queued and in a CUDA graph) and cold beside its bytes
    bound (partials read once, out and lse written once).  No single
    PyTorch call merges partials."""
    acc, ml = FA.split_partials_plain(*args, n_split=split[0],
                                      split_tiles=split[1])
    dtype = args[0].dtype
    got = FA.combine_cuda(acc, ml, dtype)
    want = FA.combine_plain(acc, ml, dtype)
    torch.cuda.synchronize()
    errs = {"out": float((got[0].float() - want[0].float()).abs().max()),
            "lse": float((got[1] - want[1]).abs().max())}
    # the partials are the plain version's: only out's own rounding differs
    tol = 1e-3 + 2.0 ** -6 * want[0].float().abs()
    assert _excess(got[0], want[0], tol) <= 1.0 and errs["lse"] <= 1e-5, \
        errs
    nbytes = 4 * (acc.numel() + ml.numel() + got[1].numel()) \
        + got[0].numel() * got[0].element_size()
    return {"name": "flash_attention_combine", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:81",
            "launches": None, "max_abs_err": max(errs.values()),
            "errors": errs,
            "ms": round(_time_ms(lambda: FA.combine_cuda(acc, ml, dtype)), 6),
            "graph_ms": round(_time_graph_ms(
                lambda: FA.combine_cuda(acc, ml, dtype)), 6),
            "cold_ms": round(_time_cold_ms(
                lambda: FA.combine_cuda(acc, ml, dtype)), 6),
            "plain_ms": round(_time_ms(lambda: FA.combine_plain(
                acc, ml, dtype), reps=5), 6),
            "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 6),
            "bound_by": "bytes", "library_ms": None, "bytes": nbytes,
            "shape": {"n_split": split[0], **dec["shape"]}}


def _ptxas_summary(log: str) -> list[str]:
    """'<kernel>: N registers, S bytes smem, spills' from ``-Xptxas=-v``."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
    return out


def serve_path(counts: Counts, card: str) -> tuple[dict, dict]:
    """qwen3-4b at full width behind ``ServeEngine`` (4 slots x 4096, the
    float32 cache): 9 requests, 32 new tokens each, one kernel launch per
    layer per prefill and per decode step; then the engine's prefill
    logits against ``forward`` and the greedy agreement with a
    teacher-forced ``forward``.  -> (numbers, the served parameters)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine, _prefill_fn
    cfg = get_config(SERVE_ARCH)
    walls = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    torch.cuda.synchronize()
    walls["init_params_s"] = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    eng = ServeEngine(cfg, params, n_slots=SERVE_SLOTS,
                      max_len=SERVE_MAX_LEN)
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1, 9)
    prompts = [rng.integers(2, cfg.vocab, int(n)).tolist() for n in lens]
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=SERVE_NEW)
    eng.submit(prompts[8], max_new_tokens=SERVE_NEW, temperature=1.0)
    done = eng.run()
    c = counts.read("serve_path")
    peak = torch.cuda.max_memory_allocated()
    n_pre, n_dec = len(eng.prefill_s), eng._steps
    assert c["flash_attention"] == cfg.n_layers * (n_pre + n_dec), \
        (c, n_pre, n_dec)
    # decode steps (4 slots, one query each) take the split path, one merge
    # per call; prefills (Sq >= 256) do not split
    assert c["flash_attention_combine"] == cfg.n_layers * n_dec, \
        (c, n_dec)
    assert sum(c.values()) == c["flash_attention"] \
        + c["flash_attention_combine"], c
    assert len(done) == 9 and all(len(r.out_tokens) == SERVE_NEW
                                  for r in done), [len(r.out_tokens)
                                                   for r in done]
    wall = counts.wall_s["serve_path"]
    dec = sorted(eng.decode_s)
    out = {"arch": SERVE_ARCH, "params": n_params,
           "param_count_formula": cfg.param_count(),
           "prompt_lens": [int(n) for n in lens], "prefills": n_pre,
           "decode_steps": n_dec, "flash_attention_launches":
           c["flash_attention"], "flash_attention_combine_launches":
           c["flash_attention_combine"], "wall_s": wall,
           "prefill_ms": [1e3 * x for x in eng.prefill_s],
           "decode_ms_median": 1e3 * dec[len(dec) // 2],
           "decode_ms_mean": 1e3 * sum(dec) / len(dec),
           "tokens": 9 * SERVE_NEW, "tokens_per_s": 9 * SERVE_NEW / wall,
           "decode_tokens_per_s": (sum(len(r.out_tokens) - 1 for r in done)
                                   / sum(dec)),
           "peak_bytes": peak, "card": card}
    # the engine's prefill logits == forward's at the last prompt position:
    # the same bf16 operations (K/V round-trip exactly through the float32
    # cache; the kernel sees the same visible keys in the same tiles), but
    # the float32 unembedding multiplies one row instead of the prompt's,
    # so cuBLAS may sum in another order: 1e-3 of the largest logit
    tok = torch.tensor([prompts[0]], device="cuda")
    fresh = T.init_caches(cfg, 1, SERVE_MAX_LEN, dtype=torch.float32)
    got, _ = _prefill_fn(params, cfg, tok, torch.ones_like(tok, dtype=bool),
                         fresh)
    want = T.forward(params, cfg, {"tokens": tok})[:, -1]
    rel = float((got - want).abs().max() / want.abs().max())
    del fresh
    assert rel <= 1e-3, rel
    out["prefill_vs_forward_rel"] = rel
    # greedy agreement with a teacher-forced forward over prompt + output
    agree = total = 0
    for r in done:
        if r.temperature > 0:
            continue
        seq = torch.tensor([r.prompt + r.out_tokens[:-1]], device="cuda")
        logits = T.forward(params, cfg, {"tokens": seq})[0, len(r.prompt) - 1:]
        agree += int((logits.argmax(-1).cpu()
                      == torch.tensor(r.out_tokens)).sum())
        total += len(r.out_tokens)
        del logits
    out["greedy_agreement"] = agree / total
    walls["checks_s"] = time.perf_counter() - t0 - walls["init_params_s"] \
        - wall
    out["walls"] = walls
    print(f"[serve] {SERVE_ARCH} full width ({n_params} parameters, bf16) on "
          f"{card}: {n_pre} prefills + {n_dec} decode steps, "
          f"{c['flash_attention']} flash_attention launches, wall {wall} s, "
          f"{out['tokens_per_s']} tok/s", flush=True)
    print(f"[serve] prefill ms per request {out['prefill_ms']} (prompt "
          f"lengths {out['prompt_lens']}); decode ms per step median "
          f"{out['decode_ms_median']} mean {out['decode_ms_mean']}; decode "
          f"tok/s {out['decode_tokens_per_s']}; peak memory {peak} B",
          flush=True)
    print(f"[serve] engine prefill vs forward: {rel} of the largest logit; "
          f"greedy agreement with a teacher-forced forward {agree}/{total}",
          flush=True)
    return out, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serve_f32_parity(counts: Counts, params) -> dict:
    """The served weights cut to 2 layers, in float32 with TF32 off, on a
    256-token prompt: the card (the kernel) against the CPU (the plain
    version).  Relative max |Δlogits| ≤ 1e-4: float32 throughout, sums in
    other orders (cuBLAS vs the CPU's GEMMs, 32- / 1024-key softmax
    tiles) through two layers and a 2560-long unembedding."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(SERVE_ARCH).replace(n_layers=2, param_dtype="float32",
                                         compute_dtype="float32")

    def cut(tree, dev):
        if isinstance(tree, dict):
            return {k: cut(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cut(v, dev) for v in tree[:cfg.n_layers]]
        return tree.to(dev, torch.float32)

    card, cpu = cut(params, "cuda"), cut(params, "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab, (1, 256)))
    counts.reset()
    got = T.forward(card, cfg, {"tokens": tok.cuda()})
    c = counts.read("serve_f32_card")
    assert c["flash_attention"] == cfg.n_layers and \
        sum(c.values()) == cfg.n_layers, c
    want = T.forward(cpu, cfg, {"tokens": tok})
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    print(f"[serve] 2-layer float32 forward, card (kernel) vs CPU (plain): "
          f"{rel} of the largest logit", flush=True)
    assert rel <= 1e-4, rel
    return {"rel_max_abs_diff": rel}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import analog as A
    from repro_torch.core import analog_torch as AT
    from repro_torch.core import charz
    from repro_torch.kernels import bitserial as BS
    from repro_torch.kernels import bitwise as BW
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import popcount_gemm as PG
    from repro_torch.kernels import senseamp as S
    from repro_torch.pud.engine import PudEngine

    times: dict[str, float] = {}
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    t0 = _phase("nvidia_smi", t0, times)

    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(build.load, KERNEL_SOURCES))
    for name in ("popcount_gemm", "flash_attention"):
        for line in _ptxas_summary(build.BUILD_LOGS.get(name, "")):
            print(f"[ptxas] {line}", flush=True)
    t0 = _phase("build", t0, times)

    row = check_senseamp(S)
    print(f"[senseamp] kernel == plain bit for bit; kernel {row['ms']} ms, "
          f"plain {row['plain_ms']} ms, bound {row['bound_ms']} ms "
          f"({row['bound_by']}) at {row['shape']}", flush=True)
    bit_rows = check_bitkernels(BW, BS)
    bit_rows.append(check_popcount_gemm(PG))
    for r in bit_rows:
        print(f"[{r['name']}] kernel == plain bit for bit; kernel {r['ms']} "
              f"ms, plain {r['plain_ms']} ms, library {r['library_ms']} ms, "
              f"bound {r['bound_ms']} ms ({r['bound_by']}) at {r['shape']}",
              flush=True)
    print("[popcount_gemm] down shape "
          + json.dumps(bit_rows[-1]["down_shape"]), flush=True)
    fa_row, merge_row = check_flash_attention(FA)
    for tag, r in (("prefill", fa_row), ("decode", fa_row["decode_shape"]),
                   ("merge", merge_row)):
        print(f"[flash_attention] {tag}: kernel {r['ms']} ms (cold "
              f"{r['cold_ms']}), plain {r['plain_ms']} ms, library "
              f"{r['library_ms']} ms (cold {r.get('library_cold_ms')}), "
              f"bound {r['bound_ms']} ms ({r['bound_by']}) at {r['shape']}",
              flush=True)
    t0 = _phase("kernel_vs_plain", t0, times)

    # ---- main path: the launch count covers exactly these calls ----
    counts = Counts(S, BW, BS, PG, FA)
    counts.reset()
    rates, peak = {}, {}
    for op in charz.OPS:
        for n in charz.NS:
            before = S.launches
            torch.cuda.reset_peak_memory_stats()
            r = charz.mc_boolean_success(op, n, trials=TRIALS,
                                         row_bits=ROW_BITS, device="cuda")
            peak[f"{op}{n}"] = torch.cuda.max_memory_allocated()
            rates[f"{op}{n}"] = r
            assert S.launches - before == charz.MC_PAIR_GROUPS, \
                (op, n, S.launches - before)
    for d in charz.NOT_DSTS:
        torch.cuda.reset_peak_memory_stats()
        rates[f"not{d}"] = charz.mc_not_success(d, trials=TRIALS,
                                                row_bits=ROW_BITS,
                                                device="cuda")
        peak[f"not{d}"] = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    mc = counts.read("mc")
    t0 = _phase("main_path", t0, times)
    assert mc["senseamp_resolve"] > 0
    for op, paper in PAPER_16.items():
        got = rates[f"{op}16"]
        closed = float(np.mean(A.boolean_success_avg_grid(
            op, 16, die_rev="M", density_gb=4)))
        print(f"[fig15] {op}16 mc {got} paper {paper} closed {closed}",
              flush=True)
        assert abs(got - paper) < 0.04, (op, got, paper)
        assert abs(got - closed) < 0.015, (op, got, closed)
        assert got > rates[f"{op}2"], (op, got, rates[f"{op}2"])
    print(f"[fig7] not1 mc {rates['not1']} paper {PAPER_NOT1}; not32 mc "
          f"{rates['not32']}", flush=True)
    assert abs(rates["not1"] - PAPER_NOT1) < 0.05
    assert rates["not32"] < 0.35
    print("[rates] " + json.dumps(rates), flush=True)
    print("[peak_bytes] " + json.dumps(peak), flush=True)

    # ---- the engine's plane path, then its dram backend ----
    eng_out = engine_path(counts)
    print("[engine] " + json.dumps(eng_out), flush=True)
    t0 = _phase("engine_path", t0, times)
    dram_out = dram_path(counts, rates["and16"])
    t0 = _phase("dram_path", t0, times)

    # ---- the numpy-draw parity mode: card == CPU ----
    par = {}
    for name, fn in (("nand16", lambda dev: charz.mc_boolean_success(
                         "nand", 16, trials=108, row_bits=2048,
                         draws="numpy", device=dev)),
                     ("not1", lambda dev: charz.mc_not_success(
                         1, trials=108, row_bits=2048, draws="numpy",
                         device=dev))):
        par[name] = (fn("cuda"), fn("cpu"))
        assert par[name][0] == par[name][1], (name, par[name])
    print(f"[parity] draws=numpy cuda == cpu: {par}", flush=True)
    # the dram engine: 8-chunk planes (4 batched blocks), noisy, numpy draws
    words = np.random.default_rng(5).integers(0, 2 ** 32, (3, 4, 256),
                                              dtype=np.uint32)
    got = {}
    for dev in ("cuda", "cpu"):
        eng = PudEngine("dram", noisy=True, seed=3, draws="numpy",
                        device=dev)
        got[dev] = [eng.nary(words, "nand").cpu(), eng.not_(words[0]).cpu(),
                    eng.report.summary()]
    assert all(torch.equal(x, y) for x, y in zip(got["cuda"][:2],
                                                 got["cpu"][:2])), \
        "dram engine: card != CPU"
    assert got["cuda"][2] == got["cpu"][2]
    print("[parity] dram engine nand + not, draws=numpy: cuda == cpu",
          flush=True)
    t0 = _phase("cross_device_parity", t0, times)

    sampled = AT.sample_boolean_success("and", 16, trials=TRIALS, width=4096,
                                        device="cuda")
    closed = A.boolean_success_avg("and", 16)
    assert abs(sampled - closed) < 0.01, (sampled, closed)
    print(f"[sampler] and16 sampled {sampled} closed {closed}", flush=True)
    t0 = _phase("sampler", t0, times)

    # ---- the binary dot product: binary linears, then bank programs ----
    quant_out = quant_path(counts)
    print("[quant] " + json.dumps(quant_out), flush=True)
    t0 = _phase("quant_path", t0, times)
    prog_out = program_path(counts)
    print("[program] " + json.dumps(prog_out), flush=True)
    maj3_path(counts)
    t0 = _phase("program_path", t0, times)
    charz_out = characterization_path(counts)
    t0 = _phase("characterization_path", t0, times)

    # ---- the decoder LM behind the serving engine ----
    serve_out, params = serve_path(counts, card)
    print("[serve] " + json.dumps(serve_out), flush=True)
    print("[serve] " + json.dumps(serve_f32_parity(counts, params)),
          flush=True)
    del params
    t0 = _phase("serve_path", t0, times)
    print("[times] " + json.dumps(times), flush=True)

    rows = [row, *bit_rows, fa_row, merge_row]
    for r in rows:
        r["launches"] = counts.total(r["name"])
        r["launches_by_path"] = {p: c[r["name"]]
                                 for p, c in counts.by_path.items()
                                 if c[r["name"]]}
        assert r["launches"] > 0, r["name"]
    print("[dram] " + json.dumps(dram_out), flush=True)
    print("[characterization] " + json.dumps(
        {k: charz_out[k] for k in ("stats", "static", "obs3", "plans")}),
        flush=True)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
