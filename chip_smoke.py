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
the hand-written ``flash_attention`` kernel, each decode step one replay
of a CUDA graph of ``decode_step`` (``serve/graph.py``); then the MoE,
hybrid, SSM and audio families at full width behind the same engine and
the cross-attention VLM's ``decode_step`` replayed from a graph.
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
    per layer per prefill forward and per decode step, the decode steps replays
    of the engine's CUDA graph (their launches counted from the capture)
    — the engine's prefill logits against ``forward``, greedy agreement
    with a teacher-forced ``forward``, one merge per layer per decode
    step; then four greedy requests decoded ``GRAPH_STEPS`` steps by the
    graph and, from a copy of the same caches, by an eager ``decode_step``
    loop in turns: the same greedy tokens step for step, the largest logit
    difference, ms per step of each and the peak memory; and the same
    weights cut to 2 layers in float32 (TF32 off), card (kernel) against
    CPU (plain) ``forward`` logits;
12. the rest of the characterization (``characterization_path``, run
    before the serving path): the bloom probe / insert fan-in sweep
    (fan-in 2-16, 2,000 trials, 8192-bit rows) held to the
    independent-op estimate, replica plans, the 4-bank nand16 MC's
    ``stats`` (optimistic and rank-legal makespans), the plan verifier,
    the DDR4 timing lint and the rank scheduler over ``dram`` engine logs
    (0 findings, 0 violations; the 2-bank xor case equal to the
    reference's numbers), Obs. 3's per-cell map, and ``draws="numpy"``
    card == CPU for the sweep, ``stats`` and ``apa_then_write``;
13. the fused multi-bank path (``fused_path``, after the
    characterization): BENCH_pr10.json's ``fused_detail`` points (and16 /
    not4 / xor on 4 and 16 banks, 192 trials, 48 groups, numpy draws),
    ``fused=True`` and ``False`` each equal to the committed loop result,
    the 4-bank points on the CPU too; nand16 and not1 at 10,000 trials x
    8192 bits on 16 banks (device draws), fused equal to the loop, their
    walls, senseamp launches and peak memory; a 4-bank noisy ``dram``
    engine, fused equal to the loop (and numpy draws card == CPU); the
    reference's 2-bank host-staged lint case equal to BENCH_pr10's
    ``static_detail`` fused numbers;
14. the attention backward kernel (``check_flash_attention_bwd``, phase 3
    with the other kernels): at the training shape (bf16, B = 2, Sq = Sk =
    2048, 32 / 8 heads of 80, causal) the forward kernel against its plain
    version (out per element, lse), then dq / dk / dv against the plain
    twin, each within twice the bf16 twin's own error against a float64
    evaluation (``grad_excess``); the float32 variant (window + softcap)
    within 1e-5 of plain; two runs bit-identical; times beside the bound
    (the five products over the visible pairs) and SDPA's backward, with
    each kernel's device time within a call; the same at hd 128 (2 x 2048,
    32 / 8 heads: the ``hd128_*`` fields); a call with more work items than
    resident blocks (B = 8) bit-identical on reruns and within the
    tolerance on its first batch row; the one-pass kernel's ``[ptxas]``
    lines at hd 64 / 80 / 128 with no spill bytes;
15. the training path (``train_path``, after serving): qwen3-4b uncut
    (bf16 parameters, AdamW, remat="block", random weights from a seeded
    generator) for 3 steps of 2 x 2048 tokens from ``SyntheticLM`` (dedup
    on the card) through ``build_train_step``, then one eval step: finite
    loss and grad norm, exactly 36 x 2 x 3 attention forwards (the remat
    recompute included) and 36 x 3 backwards;
16. the float32 training parity (``train_f32_card``): the same widths cut
    to 2 layers and a vocabulary of 8,192, float32, TF32 off, 2
    microbatches, int8 error feedback, from one ``train_state_from_numpy``
    state: each step's gradients and loss, 2 AdamW steps and 1 Adafactor
    step card (the kernels) against CPU (the plain twins) — the
    parameters on the CPU's gradients, the free-running card's losses —
    and a resume through ``CheckpointManager`` bit-equal to the
    uninterrupted run;
17. the other families (``arch_serve_path``, after ``serve_path``):
    qwen2-moe-a2.7b (MoE, 14.3·10⁹ parameters), hymba-1.5b (hybrid
    attention + SSM, a 2048-key window), mamba2-780m (SSM) and
    musicgen-medium (the audio decoder, vocabulary 2048) uncut in bf16
    behind ``ServeEngine`` (4 slots x 4096, the float32 cache; hymba's
    ring 2048 slots; decode graphed): 6 requests of 16 new tokens (one at
    temperature 1), ``n_layers`` attention launches per prefill forward
    and decode step (none for mamba2), the prefill logits against
    ``forward``, the greedy agreement with a teacher-forced ``forward``,
    walls, tok/s, decode ms per step (qwen2-moe's beside its bytes floor)
    and peak bytes, the graph against the eager loop as for qwen3-4b;
    each family cut to 2 layers in float32, card against CPU (≤ 1e-4);
    Nemotron 3 Nano's batched prefill of one admission wave against one
    request a forward (``[batched]``: prefill logits, the first 16
    tokens; at bf16 printed, cut to 6 layers in float32 held); Granite
    4.0-H Small the same, its float32 cuts its first Mamba-2 and its first
    attention layer, each with its MoE;
    llama-3.2-vision-90b cut to 10 layers (every width kept): ``forward``
    with 1024 image embeddings over a 512-token prompt, then
    ``decode_step`` with them — the prompt eagerly, then the steps as
    replays of a ``DecodeGraph`` with the image embeddings as a static
    input — teacher-forced against ``forward``, the cross blocks launching
    the kernel, and its float32 2-layer (one self, one cross block)
    card-vs-CPU check; musicgen-medium: one ``forward`` from frame
    embeddings on the served weights.
    Phase 3 holds the attention kernel to its plain version at these
    families' shapes too (hymba's prefill and decode, qwen2-moe's hd 128
    MHA, the VLM's non-causal cross-attention over 1024 keys).
18. the mesh (``mesh_train_path``, after the training parity): a
    one-process NCCL group and the launcher's (1, 1) ``("data",
    "model")`` host mesh; ``launch.train.main`` trains hymba-1.5b and then
    mamba2-780m uncut (bf16 parameters, AdamW, remat="block") on DTensors
    placed by the sharding rules, 3 steps of 2 x 2048 tokens from
    ``SyntheticLM`` with a checkpoint after step 2 and the final one after
    step 3; the step-3 checkpoint removed, a restart resumes from step 2
    and its step 3 equals the uninterrupted one bit for bit (every leaf);
    hymba launches 32 x 2 attention forwards and 32 backwards a step,
    mamba2 none; step walls, tokens/s, losses and peak bytes printed.
    ``mesh_parity``: qwen3-4b's widths cut to 2 layers, float32, TF32 off,
    one train step (2 microbatches) on the (1, 1) mesh equal bit for bit
    to the same step without a mesh;
19. ``roofline``: ``dispatch_cost`` of one ``train_path`` step (fake
    tensors, on the host), its H100 roofline terms (the data sheet's
    rates), and, from ``train_path``'s median step wall, ``mfu`` =
    ``model_flops`` / wall / 989e12, printed with the card's name and
    power limit.

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
import os
import re
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
                  "flash_attention", "flash_attention_bwd", "moe_grouped",
                  "ssd")
#: the grouped expert kernel's shapes at Nemotron 3 Nano's widths (D 2688,
#: F 1856, 128 experts, top 6): tokens routed at random (a decode step at
#: 16 slots, a 4,096-token prefill, a 256-token prefill) and 64 tokens
#: skewed onto 3 experts: (tokens, skew)
MOE_SHAPES = {"decode": (16, 0.0), "prefill": (4096, 0.0),
              "short": (256, 0.0), "skewed": (64, 10.0)}
#: the SwiGLU grouped kernel's shapes at Granite 4.0-H Small's widths (D
#: 4096, F 768, 72 experts, top 10): a decode step at 16 slots (160 rows),
#: a 4,096-token prefill (40,960 rows) and 64 tokens skewed onto 3 experts
MOE_SWIGLU_SHAPES = {"decode": (16, 0.0), "prefill": (4096, 0.0),
                     "skewed": (64, 10.0)}
#: the grouped kernel against its twin, of the largest output: both round
#: the same float32 sums, summed in another order, to bf16 twice (readings
#: 0.0026-0.0051 on an H100)
MOE_TOL = 1e-2
#: the Mamba-2 mixer kernels' shapes at Nemotron 3 Nano's widths (64 heads
#: of 64 in 8 groups, state 128, chunk 128): (rows, tokens)
SSD_SHAPES = {"s4096": (1, 4096), "s1024": (1, 1024), "b4_s256": (4, 256)}
#: Granite 4.0-H Small's one group of 128 heads (state 128, chunk 256)
SSD_ONE_GROUP = {"granite_s4096": (1, 4096)}
#: the kernels against the plain version, of the largest output (bf16):
#: three roundings to bf16 after float32 sums taken in another order
SSD_TOL = 2e-2
#: the recurrent step's kernels alone: the decode graph's rows, at the
#: widths of both served Mamba-2 models
SSD_STEP_ROWS = 16
SSD_STEP_ARCHS = ("nemotron-3-nano-30b-a3b", "granite-4.0-h-small")
#: the served model and engine (src/repro/configs/qwen3_4b.py, uncut)
SERVE_ARCH, SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = "qwen3-4b", 4, 4096, 32
#: prompt lengths are drawn from this range (numpy default_rng(0))
SERVE_PROMPTS = (256, 2048)
#: the other families served at full width after qwen3-4b (their configs
#: in src/repro/configs, uncut, bf16), behind the same engine: requests
#: (the last at temperature 1) and new tokens each
ARCH_SERVE, ARCH_REQUESTS, ARCH_NEW = (
    "qwen2-moe-a2.7b", "hymba-1.5b", "mamba2-780m", "musicgen-medium",
    "nemotron-3-nano-30b-a3b", "granite-4.0-h-small"), 6, 16
#: decode steps of the graph-against-eager check of each served model
GRAPH_STEPS = 16
#: float32 prefill logits of a batched forward against one request a
#: forward, relative to the largest logit (products of other row counts
#: sum in other orders)
BATCHED_F32_REL = 1e-4
#: hymba-1.5b's sliding window: its KV ring's slots
HYMBA_WINDOW = 2048
#: the attention kernel's shapes of those families (check_flash_attention)
ARCH_SHAPES = ("hymba_prefill", "hymba_decode", "moe_prefill", "moe_decode",
               "vlm_cross")
#: the VLM (src/repro/configs/llama_3_2_vision_90b.py) cut to 10 layers —
#: 2 super-blocks of 4 self blocks and 1 cross block, every width kept —
#: its prompt and teacher-forced decode steps
VLM_ARCH, VLM_LAYERS, VLM_PROMPT, VLM_STEPS = "llama-3.2-vision-90b", 10, \
    512, 8
#: the audio decoder at full width, fed frame embeddings of this length
AUDIO_ARCH, AUDIO_FRAMES = "musicgen-medium", 1024
#: the float32 card-vs-CPU check of each family: layers, prompt
ARCH_F32_LAYERS, ARCH_F32_SEQ = 2, 256
#: the trained model (src/repro/configs/qwen3_4b.py, uncut: AdamW,
#: remat="block", bf16 parameters) and its batch and steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "qwen3-4b", 2, 2048, 3
#: the float32 card-vs-CPU training check: the same widths cut to these
#: (so the CPU side stays small), its sequence length
TRAIN_F32_LAYERS, TRAIN_F32_VOCAB, TRAIN_F32_SEQ = 2, 8192, 256
#: the families trained through the mesh launcher (src/repro/configs,
#: uncut), at TRAIN_BATCH x TRAIN_SEQ for TRAIN_STEPS steps, a checkpoint
#: every MESH_CKPT_EVERY steps
MESH_TRAIN_ARCHS, MESH_CKPT_EVERY = ("hymba-1.5b", "mamba2-780m"), 2
#: the reference's default TrainConfig learning rate (the launcher's own
#: default is 1e-3)
MESH_TRAIN_LR = 3e-4
#: mesh_parity: qwen3-4b's widths cut to these layers, float32
MESH_PARITY_LAYERS = 2
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
#: the same for the 2-bank host-staged engine run with fused=True
#: (BENCH_pr10.json "static_detail", the "_fused" keys)
REF_STATIC_FUSED = {"timing_violations": 0, "timing_by_design": 16,
                    "makespan_ns": 980.0, "min_legal_makespan_ns": 980.0,
                    "legal_makespan_ns": 980.0, "refresh_stall_ns": 0.0,
                    "rank_stall_ns": 0.0, "sched_violations": 0}
#: the fused multi-bank cells: 16 banks, 48 stratified groups (divisible by
#: 4 and 16, as in the reference's fused benchmark)
FUSED_BANKS, FUSED_GROUPS = 16, 48
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
    del cases, args, kw, cells
    fused = _check_senseamp_fused(S, rows_l, rows_f, scal, gen)
    worst = max(worst, fused.pop("max_abs_err"))
    return {"name": "senseamp_resolve", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/senseamp.cu",
            "replaces": "src/repro/kernels/senseamp.py:77",
            "launches": None, "max_abs_err": float(worst),
            "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
            "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 6),
            "bound_by": "bytes", "library_ms": None,
            "shape": {"T": tg, "W": w, "n_com": n, "n_ref": n},
            "fused_shape": fused}


def _check_senseamp_fused(S, rows_l, rows_f, scal, gen) -> dict:
    """The fused episode's shape: 16 banks x 209 trials stacked on the
    trial axis, per-bank (N, W) static plane and (N,) thresholds; kernel ==
    plain bit for bit, an (N, W) plane == its (T, W) expansion, then times
    beside the bound (the per-bank planes counted once)."""
    dev = torch.device("cuda")
    nb, tb = FUSED_BANKS, -(-TRIALS // FUSED_GROUPS)
    t, w, slots = nb * tb, ROW_BITS // 2, 16
    cells = [torch.randint(0, 3, (t, slots, ROW_BITS), generator=gen,
                           device=dev).float() * 0.5 for _ in range(2)]
    args = (cells[1], rows_l, w, cells[0], rows_f, 0)
    static = 0.02 * torch.randn((nb, w), generator=gen, device=dev)
    thr = 0.0123 + 0.005 * torch.randn((nb,), generator=gen, device=dev)
    kw = dict(scal, static=static, thr=thr, bank_trials=tb,
              normals=torch.randn((t, w), generator=gen, device=dev),
              u0=torch.rand((t, w), generator=gen, device=dev))
    worst = 0
    got = S.senseamp_gather_cuda(*args, **kw)
    want = S.senseamp_gather_plain(*args, **kw)
    worst = max(worst, int((got.int() - want.int()).abs().max()))
    assert worst == 0, "senseamp kernel != plain (per-bank planes)"
    expanded = dict(kw, static=static.repeat_interleave(tb, dim=0),
                    thr=scal["thr"], bank_trials=None)
    assert torch.equal(S.senseamp_gather_cuda(*args, **dict(kw, thr=scal[
        "thr"])), S.senseamp_gather_cuda(*args, **expanded)), \
        "senseamp: (N, W) static plane != its (T, W) expansion"
    del expanded
    ms = _time_ms(lambda: S.senseamp_gather_cuda(*args, **kw))
    plain_ms = _time_ms(lambda: S.senseamp_gather_plain(*args, **kw), reps=5)
    nbytes = t * w * (4 * (len(rows_l) + len(rows_f)) + 4 + 4 + 1) \
        + 4 * nb * w + 4 * nb
    return {"T": t, "W": w, "banks": nb, "n_com": len(rows_l),
            "n_ref": len(rows_f), "ms": round(ms, 6),
            "plain_ms": round(plain_ms, 6),
            "bound_ms": round(nbytes / HBM_BYTES_PER_S * 1e3, 6),
            "bound_by": "bytes", "max_abs_err": float(worst)}


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

    def __init__(self, S, BW, BS, PG, FA, MG, SD):
        self.S = S
        self.dicts = (BW.launches, BS.launches, PG.launches, FA.launches,
                      MG.launches, SD.launches)
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
    # 9 groups on 4 banks auto-fuse: two full rounds and a 1-bank tail
    assert S.launches - n0 == -(-charz.MC_PAIR_GROUPS // 4), S.launches - n0
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


def fused_path(counts: Counts) -> dict:
    """The fused multi-bank path on the card (see the module doc, 13)."""
    import statistics
    from repro_torch import analysis
    from repro_torch.core import charz
    from repro_torch.core.policy import ResidentPolicy
    from repro_torch.kernels.ops import unpack_bits
    from repro_torch.pud.engine import PudEngine
    S = counts.S
    out: dict = {}
    detail = json.loads((ROOT / "BENCH_pr10.json").read_text())[
        "fused_detail"]
    points = {
        "and16": lambda **kw: charz.mc_boolean_success("and", 16, **kw),
        "not4": lambda **kw: charz.mc_not_success(4, **kw),
        "xor": lambda **kw: charz.mc_program_success("xor", **kw)}
    counts.reset()
    # (a) numpy draws: the reference's committed fused_detail points
    bench = {}
    for banks in (4, 16):
        for name, fn in points.items():
            want = detail[f"{name}_b{banks}"]
            kw = dict(trials=want["trials"], groups=want["groups"],
                      banks=banks, draws="numpy")
            got = {f"{dev}_{'fused' if f else 'loop'}": fn(
                fused=f, device=dev, **kw) for f in (True, False)
                for dev in (("cuda", "cpu") if banks == 4 else ("cuda",))}
            assert all(v == want["loop_success"] for v in got.values()), \
                (name, banks, got, want["loop_success"])
            bench[f"{name}_b{banks}"] = got
    print("[fused] BENCH_pr10 fused_detail points, draws=numpy, fused and "
          "loop (card; 4 banks also CPU) == loop_success: " + json.dumps(
              {k: v["cuda_fused"] for k, v in bench.items()}), flush=True)
    out["bench_points"] = bench
    # (b) device draws at full width on 16 banks: fused == loop
    mc = {
        "nand16": lambda f: charz.mc_boolean_success(
            "nand", 16, trials=TRIALS, row_bits=ROW_BITS, banks=FUSED_BANKS,
            groups=FUSED_GROUPS, fused=f, device="cuda"),
        "not1": lambda f: charz.mc_not_success(
            1, trials=TRIALS, row_bits=ROW_BITS, banks=FUSED_BANKS,
            groups=FUSED_GROUPS, fused=f, device="cuda")}
    cells: dict = {}
    for name, fn in mc.items():
        walls = {False: [], True: []}
        for order in ((False, True), (True, False), (False, True)):
            for f in order:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                n0, t0 = S.launches, time.perf_counter()
                r = fn(f)
                torch.cuda.synchronize()
                walls[f].append((time.perf_counter() - t0) * 1e3)
                tag = f"{name}_{'fused' if f else 'loop'}"
                c = cells.setdefault(tag, {"rate": r})
                assert c["rate"] == r, (tag, c["rate"], r)
                c["launches"] = S.launches - n0
                c["peak_bytes"] = torch.cuda.max_memory_allocated()
        for f in (False, True):
            c = cells[f"{name}_{'fused' if f else 'loop'}"]
            c["wall_ms"] = walls[f]
            c["wall_ms_median"] = statistics.median(walls[f])
        assert cells[f"{name}_fused"]["rate"] == cells[f"{name}_loop"]["rate"]
    assert abs(cells["nand16_fused"]["rate"] - PAPER_16["nand"]) < 0.04
    assert cells["nand16_loop"]["launches"] == FUSED_GROUPS
    assert cells["nand16_fused"]["launches"] == FUSED_GROUPS // FUSED_BANKS
    assert cells["not1_fused"]["launches"] == 0
    for tag, c in cells.items():
        print(f"[fused] {tag}: rate {c['rate']} wall median "
              f"{c['wall_ms_median']} ms of {c['wall_ms']}, senseamp "
              f"launches {c['launches']}, peak {c['peak_bytes']} B",
              flush=True)
    out["mc"] = cells
    # (c) a 4-bank noisy dram engine over 300 row chunks: 9 full blocks of
    # 32 (fused rounds of 4, 4 and a 1-bank tail) and a ragged 12-chunk
    # block on the loop; nand then NOT, twice (cursors across the tail)
    words = np.random.default_rng(11).integers(0, 2 ** 32, (2, 150, 256),
                                               dtype=np.uint32)
    eng_out = {}
    for draws, runs in (("device", (("cuda", False), ("cuda", True))),
                        ("numpy", (("cuda", True), ("cpu", True),
                                   ("cpu", False)))):
        res = []
        for dev, f in runs:
            eng = PudEngine("dram", banks=4, noisy=True, seed=3, fused=f,
                            draws=draws, device=dev)
            n0 = S.launches
            got = [eng.nary(words, "nand"), eng.not_(words[0]),
                   eng.nary(words, "nand"), eng.not_(words[1])]
            if dev == "cuda":
                assert S.launches - n0 == (8 if f else 20), S.launches - n0
            res.append((f, [g.cpu() for g in got], eng.report.summary()))
        for f, g, rep in res[1:]:
            assert all(torch.equal(a, b) for a, b in zip(g, res[0][1])), \
                f"dram engine fused != loop / card != CPU ({draws})"
            # the same path books the same floats; fused and loop sum the
            # same per-block costs in another order
            for k, v in rep.items():
                assert (v == res[0][2][k] if f == res[0][0] else
                        abs(v - res[0][2][k]) <= 1e-9 * abs(v)), (draws, k)
        want = ~(words[0] & words[1])
        eng_out[draws] = float(unpack_bits(torch.from_numpy(
            want.view(np.int32)) ^ res[0][1][0]).float().mean())
    print(f"[fused] dram engine 4 banks, nand + not twice: fused == loop "
          f"(device draws), card == CPU == loop (numpy draws); nand "
          f"mismatch fraction {eng_out}", flush=True)
    out["engine_mismatch"] = eng_out
    # (d) the reference's 2-bank fused lint case: xor, host-staged, (4, 4)
    # words drawn after the loop case's from default_rng(7)
    rng = np.random.default_rng(7)
    for _ in ("a", "b"):
        rng.integers(0, 2 ** 32, (4, 4), dtype=np.uint32)
    eng = PudEngine("dram", banks=2, fused=True, resident=ResidentPolicy.HOST,
                    verify=False, device="cuda")
    eng.run_program(charz.get_program("xor"), {
        k: rng.integers(0, 2 ** 32, (4, 4), dtype=np.uint32)
        for k in ("a", "b")})
    rep = analysis.lint_bank_array(eng._array)
    tl = eng.schedule_timing()
    static = {"timing_violations": rep.violations,
              "timing_by_design": sum(sum(r.by_design.values())
                                      for r in rep.per_bank),
              "makespan_ns": rep.makespan_ns,
              "min_legal_makespan_ns": rep.min_legal_makespan_ns,
              "legal_makespan_ns": tl.legal_makespan_ns,
              "refresh_stall_ns": tl.refresh_stall_ns,
              "rank_stall_ns": tl.rank_stall_ns,
              "sched_violations": tl.relint_violations}
    print("[fused] static (2-bank host-staged xor) " + json.dumps(static),
          flush=True)
    assert static == REF_STATIC_FUSED, static
    out["static"] = static
    c = counts.read("fused")
    assert c["senseamp_resolve"] > 0 and \
        sum(c.values()) == c["senseamp_resolve"], c
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


def _attention_bound(q, k, q_pos, kv_pos, window: int = 0
                     ) -> tuple[float, str, dict]:
    """Least time (ms) for these inputs: operations 4·H·(visible pairs)·hd
    at the dense rate of q's type (bf16 tensor cores, else float32), bytes
    = q, out, lse and the positions once plus each K/V row that some query
    sees, in the cache's type."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    keep = q_pos[:, :, None] >= kv_pos[:, None, :]          # (B, Sq, Sk)
    if window:
        keep &= q_pos[:, :, None] - kv_pos[:, None, :] < window
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


def _time_graph_ms(fn, reps: int = 20, stream=None) -> float:
    """Device time of one call back to back with no host launch cost
    between calls: ``reps`` calls captured in a CUDA graph (after a
    warm-up on a side stream), one replay timed with CUDA events, over the
    count.  ``stream``: warm up and capture on it (an autograd backward
    runs on the stream of its forward, so that stream must capture)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def _time_graph_cold_ms(fn, reps: int = 20) -> float:
    """Device time of one call in a CUDA graph that finds the L2 cache
    cold: a graph of ``reps`` times a 256 MiB write (five times the 50 MB
    L2) then the call, less a graph of the writes alone, over the count."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    both = _time_graph_ms(lambda: (flush.fill_(1.0), fn()), reps)
    return both - _time_graph_ms(lambda: flush.fill_(1.0), reps)


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
    # the other served families' shapes: hymba-1.5b (hd 64, 25 / 5 heads,
    # a 2048-key window over its 2048-slot ring; one decode slot past the
    # wrap), qwen2-moe-a2.7b (hd 128, 16 / 16 heads: its prefill, and its
    # decode over the engine's 4 x 4096 slots on the split path) and the
    # VLM's
    # non-causal cross-attention (1024 image keys, hd 128, 64 / 8 heads)
    win = HYMBA_WINDOW
    ring = torch.arange(win, device="cuda")
    hy_q = torch.tensor([win + 15, 1800, 1200, 600], device="cuda")[:, None]
    hy_kv = torch.where(ring + win <= hy_q, ring + win,
                        torch.where(ring <= hy_q, ring, SENTINEL))
    shapes.update({
        "hymba_prefill": (1, win, win, 25, 5, 64, ring[None], ring[None],
                          win, 0.0),
        "hymba_decode": (4, 1, win, 25, 5, 64, hy_q, hy_kv, win, 0.0),
        "moe_prefill": (1, 2048, sk, 16, 16, 128, pre_q, pre_kv, 0, 0.0),
        "moe_decode": (4, 1, sk, 16, 16, 128, slot_pos[:, None], dec_kv, 0,
                       0.0),
        "vlm_cross": (1, 512, 1024, 64, 8, 128,
                      torch.ones((1, 512), device="cuda"),
                      torch.zeros((1, 1024), device="cuda"), 0, 0.0)})
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
            bound, by, count = _attention_bound(args[0], args[1], qp, kp, w)
            q, k, v = args[:3]
            qs = q.transpose(1, 2)
            ks, vs = (t.to(torch.bfloat16).repeat_interleave(hh // kk, 2)
                      .transpose(1, 2) for t in (k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            if name.endswith("prefill"):
                # the prompt's own keys, causal (within hymba's window)
                ks, vs = ks[:, :, :sq].contiguous(), vs[:, :, :sq].contiguous()
                library = lambda: sdpa(qs, ks, vs, is_causal=True)  # noqa: E731
            elif name == "vlm_cross":
                ks, vs = ks.contiguous(), vs.contiguous()
                library = lambda: sdpa(qs, ks, vs)  # noqa: E731
            else:
                ks, vs = ks.contiguous(), vs.contiguous()
                mask = kp[:, None, None, :] <= qp[:, None, :, None]
                if w:
                    mask &= qp[:, None, :, None] - kp[:, None, None, :] < w
                library = lambda: sdpa(qs, ks, vs, attn_mask=mask)  # noqa: E731
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
                          "hd": d, "window": w, "q": "bfloat16",
                          "kv": "float32"}}
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
             "decode_shape": timing["decode"],
             "arch_shapes": {n: timing[n] for n in ARCH_SHAPES}},
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


def check_moe_grouped(MG) -> list[dict]:
    """The grouped expert kernels (``kernels/moe_grouped.py``): relu² at
    each :data:`MOE_SHAPES` shape of Nemotron 3 Nano, SwiGLU at each
    :data:`MOE_SWIGLU_SHAPES` shape of Granite 4.0-H Small (:func:`_moe_rows`).
    Each shape is printed."""
    from bench import roofline_moe, roofline_moe_swiglu
    return _moe_rows(MG, "relu2", (128, 2688, 1856, 6), MOE_SHAPES,
                     roofline_moe, 21) \
        + _moe_rows(MG, "swiglu", (72, 4096, 768, 10), MOE_SWIGLU_SHAPES,
                    roofline_moe_swiglu, 22)


def _moe_rows(MG, kind: str, widths, shapes: dict, roofline,
              seed: int) -> list[dict]:
    """One grouped kernel at ``widths`` (E, D, F, top k) and each of
    ``shapes``: the wrapper against its twin within :data:`MOE_TOL` of the
    largest output; its time, the twin's, the least time from its bytes
    and operations (``roofline``: ``bench/roofline_moe.py`` or
    ``bench/roofline_moe_swiglu.py``: the weights of each expert with rows
    once, rows in and out, ``4`` or ``6 · rows · D · F`` operations) and
    ``torch._grouped_mm``'s (up, the activation, down; where the card's
    torch has it, held to the twin too), CUDA events."""
    e, d, f, k = widths
    g = torch.Generator(device="cuda").manual_seed(seed)
    glu = kind == "swiglu"
    w_up = (torch.randn(e, 2 * f if glu else f, d, device="cuda",
                        generator=g) / d ** 0.5).bfloat16()
    w_down = (torch.randn(e, d, f, device="cuda", generator=g)
              / f ** 0.5).bfloat16()
    kernel, plain = (MG.grouped_experts_swiglu,
                     MG.grouped_experts_swiglu_plain) if glu else \
        (MG.grouped_experts, MG.grouped_experts_plain)
    name = "moe_grouped_swiglu" if glu else "moe_grouped"
    library = getattr(torch, "_grouped_mm", None)
    rows = []
    for tag, (n, skew) in shapes.items():
        logits = torch.randn(n, e, device="cuda", generator=g)
        logits[:, :3] += skew
        idx = torch.topk(logits, k, -1).indices.reshape(-1)
        cnt = torch.zeros(e + 1, dtype=torch.int32, device="cuda") \
            .scatter_add_(0, idx + 1, torch.ones_like(idx, dtype=torch.int32))
        off = torch.cumsum(cnt, 0, dtype=torch.int32)
        xs = torch.randn(n * k, d, device="cuda", generator=g).bfloat16()
        want = plain(xs, off, w_up, w_down).float()
        scale = float(want.abs().max())
        err = float((kernel(xs, off, w_up, w_down).float()
                     - want).abs().max()) / scale
        assert err <= MOE_TOL, (kind, tag, err)
        used = int((cnt[1:] > 0).sum())
        nbytes, nops = roofline.grouped_launch(used, n * k, d, f)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"name": name, "tag": tag,
               "shape": {"tokens": n, "rows": n * k, "experts_with_rows":
                         used, "D": d, "F": f, "E": e, "skew": skew},
               "ms": round(_time_ms(lambda: kernel(
                   xs, off, w_up, w_down)), 6),
               "plain_ms": round(_time_ms(lambda: plain(
                   xs, off, w_up, w_down), reps=5), 6),
               "bound_ms": round(roofline.bound_s(nbytes, nops) * 1e3, 6),
               "bound_by": "bytes" if t_bytes >= nops / BF16_OPS_PER_S * 1e3
               else "operations",
               "rel_err": err, "library_ms": None}
        row["share_of_bound"] = round(row["bound_ms"] / row["ms"], 4)
        if library is not None:
            def lib():
                h = library(xs, w_up.transpose(1, 2), offs=off[1:])
                if glu:
                    gate, up = h.chunk(2, -1)
                    h = torch.nn.functional.silu(gate) * up
                else:
                    h = torch.relu(h).square()
                return library(h, w_down.transpose(1, 2), offs=off[1:])
            try:
                row["library_rel_err"] = float(
                    (lib().float() - want).abs().max()) / scale
                row["library_ms"] = round(_time_ms(lib), 6)
            except RuntimeError as exc:
                row["library_error"] = str(exc).splitlines()[0][:200]
        print(f"[{name}] {tag}: kernel {row['ms']} ms ({row['share_of_bound']}"
              f" of its bound), plain {row['plain_ms']} ms, library "
              f"{row['library_ms']} ms, bound {row['bound_ms']} ms "
              f"({row['bound_by']}) at {row['shape']}; kernel vs plain "
              f"{err}, library vs plain "
              f"{row.get('library_rel_err', row.get('library_error'))}",
              flush=True)
        rows.append(row)
    return rows


def _ssd_cost(cfg, b: int, s: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one chunked mixer call: the
    projection read once, the output, the final state and the conv window
    written once, the parameters read once; the operations are the plain
    version's four products (``C Bᵀ``, ``(C Bᵀ ⊙ L)(x·dt)``, ``Bᵀ (x·w)``,
    ``C · prev``), two a multiply-add."""
    nh, g, n, hd = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, \
        cfg.ssm_head_dim
    di, q = cfg.d_inner, min(cfg.ssm_chunk, s)
    cd, nc = di + 2 * g * n, s // q
    width = 2 * di + 2 * g * n + nh
    nbytes = 2 * b * s * (width + di) + 4 * b * nh * n * hd \
        + 2 * b * (cfg.ssm_conv - 1) * cd + 2 * (cfg.ssm_conv + 1) * cd \
        + 2 * di + 12 * nh
    flops = 2 * b * nc * (g * q * q * n + nh * q * q * hd
                          + 2 * nh * q * n * hd)
    return float(nbytes), float(flops)


def check_ssd(SD) -> list[dict]:
    """The Mamba-2 mixer's chunked kernels (``kernels/ssd.py``) at each
    :data:`SSD_SHAPES` shape of Nemotron 3 Nano and the
    :data:`SSD_ONE_GROUP` shape of Granite 4.0-H Small, bf16: against the plain
    version within :data:`SSD_TOL` of the largest output (the state within
    1e-4, the conv window exact); the kernels' time (CUDA events), their
    launches a call (the wrapper's count and the profiler's device
    kernels), their bound (:func:`_ssd_cost`: bytes at 3.35 TB/s, float32
    operations at 67 TFLOP/s) and the plain version's time.  Then the
    served model's greedy tokens with the kernels against the plain
    version (:func:`_ssd_tokens`).  Each shape is printed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM
    gen = torch.Generator(device="cuda").manual_seed(33)
    rows = []
    cases = [("nemotron-3-nano-30b-a3b", tag, shape)
             for tag, shape in SSD_SHAPES.items()]
    cases += [("granite-4.0-h-small", tag, shape)
              for tag, shape in SSD_ONE_GROUP.items()]
    cfg = p = None
    for arch, tag, (b, s) in cases:
        if cfg is None or cfg.name != arch:
            cfg = get_config(arch)
            p = SSM.init_ssm(gen, cfg)
        u = torch.randn((b, s, cfg.d_model), generator=gen,
                        device="cuda").bfloat16()
        proj = u @ p["w_in"]
        lens = torch.randint(s // 2, s + 1, (b,), generator=gen,
                             device="cuda") if b > 1 else None
        valid = None if lens is None else \
            torch.arange(s, device="cuda")[None] < lens[:, None]
        caches = []
        for _ in range(2):
            c = SSM.init_ssm_cache(cfg, b + 2, "cuda")
            c["rows"] = torch.arange(b, device="cuda") + 2
            caches.append(c)
        want = SD.ssd_mixer_plain(p, cfg, proj, caches[0], valid)
        before = SD.launches["ssd"]
        got = SD.ssd_mixer_cuda(p, cfg, proj, caches[1], valid)
        torch.cuda.synchronize()
        per_call = SD.launches["ssd"] - before
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        st = float((caches[1]["state"] - caches[0]["state"]).abs().max()
                   / caches[0]["state"].abs().max())
        assert err <= SSD_TOL and st <= 1e-4, (tag, err, st)
        assert torch.equal(caches[1]["conv"], caches[0]["conv"]), tag
        assert per_call == SD.KERNELS <= 6, per_call
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            SD.ssd_mixer_cuda(p, cfg, proj, caches[1], valid)
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()}
        assert sum(c for k, c in kernels.items()
                   if k.startswith("ssd_")) == per_call, kernels
        nbytes, flops = _ssd_cost(cfg, b, s)
        bound_ms, bound_by = _bound(nbytes, flops)
        ms = _time_ms(lambda: SD.ssd_mixer_cuda(p, cfg, proj, caches[1],
                                                valid))
        plain_ms = _time_ms(lambda: SD.ssd_mixer_plain(p, cfg, proj,
                                                       caches[0], valid),
                            reps=3)
        row = {"name": "ssd", "tag": tag,
               "shape": {"rows": b, "tokens": s, "heads": cfg.ssm_heads,
                         "head_dim": cfg.ssm_head_dim,
                         "groups": cfg.ssm_groups, "state": cfg.ssm_state,
                         "chunk": cfg.ssm_chunk,
                         "valid": None if lens is None else lens.tolist()},
               "ms": round(ms, 6), "plain_ms": round(plain_ms, 6),
               "bound_ms": round(bound_ms, 6), "bound_by": bound_by,
               "share_of_bound": round(bound_ms / ms, 4),
               "vs_plain": round(plain_ms / ms, 2), "bytes": nbytes,
               "flops": flops, "rel_err": err, "state_rel_err": st,
               "launches_per_call": per_call, "device_kernels": kernels,
               "library_ms": None}
        print(f"[ssd] {tag}: kernel {row['ms']} ms ({row['share_of_bound']}"
              f" of its bound {row['bound_ms']} ms, {bound_by}), plain "
              f"{row['plain_ms']} ms ({row['vs_plain']}x), {per_call} "
              f"launches a call (device kernels {kernels}) at "
              f"{row['shape']}; kernel vs plain {err}, state {st}",
              flush=True)
        rows.append(row)
        del u, proj, want, got, caches
    rows[0]["tokens"] = _ssd_tokens(SD)
    return rows


def _ssd_step_bytes(cfg, b: int) -> float:
    """Bytes of one recurrent step at bf16: the float32 state read once and
    written once, the projection row read, the conv window read and
    written, the output written, the parameters read once."""
    nh, g, n, hd = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state, \
        cfg.ssm_head_dim
    di = cfg.d_inner
    cd, kw = di + 2 * g * n, cfg.ssm_conv
    width = 2 * di + 2 * g * n + nh
    return float(2 * 4 * b * nh * n * hd + 2 * b * width
                 + 2 * 2 * b * (kw - 1) * cd + 2 * b * di
                 + 2 * (kw + 1) * cd + 2 * di + 12 * nh)


def check_ssd_step(SD) -> list[dict]:
    """The recurrent step's kernels (``kernels/ssd.py`` ``ssd_step_cuda``)
    alone at :data:`SSD_STEP_ROWS` rows, bf16, at the widths of
    :data:`SSD_STEP_ARCHS`, from a random state: against the plain step
    (output, state, window), the launches a call (each a ``ssd_`` kernel
    in the profile), then CUDA events over 20 calls queued and in a CUDA
    graph, beside the plain step's, and the bound by bytes.  Nemotron's
    state at 16 rows (33.6 MB) fits the 50 MB L2, where a served step
    finds it cold: :func:`_time_graph_cold_ms` is printed too."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as SSM
    gen = torch.Generator(device="cuda").manual_seed(36)
    rows, b = [], SSD_STEP_ROWS
    for arch in SSD_STEP_ARCHS:
        cfg = get_config(arch)
        p = SSM.init_ssm(gen, cfg)
        u = torch.randn((b, 1, cfg.d_model), generator=gen,
                        device="cuda").bfloat16()
        proj = u @ p["w_in"]
        plain_c = SSM.init_ssm_cache(cfg, b, "cuda")
        plain_c["state"].normal_(generator=gen)
        plain_c["conv"].normal_(generator=gen)
        got_c = {k: t.clone() for k, t in plain_c.items()}
        want = SD.ssd_step_plain(p, cfg, proj, plain_c, None)
        before = SD.launches["ssd_step"]
        got = SD.ssd_step_cuda(p, cfg, proj, got_c, None)
        torch.cuda.synchronize()
        per_call = SD.launches["ssd_step"] - before
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        st = float((got_c["state"] - plain_c["state"]).abs().max()
                   / plain_c["state"].abs().max())
        assert err <= SSD_TOL and st <= 1e-4, (arch, err, st)
        assert torch.equal(got_c["conv"], plain_c["conv"]), arch
        assert per_call == SD.STEP_KERNELS <= 3, per_call
        call = lambda: SD.ssd_step_cuda(p, cfg, proj, got_c, None)
        plain = lambda: SD.ssd_step_plain(p, cfg, proj, plain_c, None)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or getattr(
                e, "cuda_time_total", 0)
            if e.key.startswith("ssd_") and t > 0:
                kernels[e.key] = {"calls": e.count // 5,
                                  "device_ms": round(t / 5 / 1e3, 6)}
        assert sum(k["calls"] for k in kernels.values()) == per_call, \
            kernels
        nbytes = _ssd_step_bytes(cfg, b)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ms, graph_ms = _time_ms(call), _time_graph_ms(call)
        cold_ms = _time_graph_cold_ms(call)
        plain_ms, plain_graph_ms = _time_ms(plain), _time_graph_ms(plain)
        row = {"name": "ssd_step", "tag": f"{arch}_b{b}",
               "shape": {"rows": b, "heads": cfg.ssm_heads,
                         "head_dim": cfg.ssm_head_dim,
                         "groups": cfg.ssm_groups, "state": cfg.ssm_state},
               "ms": round(ms, 6), "graph_ms": round(graph_ms, 6),
               "cold_ms": round(cold_ms, 6),
               "plain_ms": round(plain_ms, 6),
               "plain_graph_ms": round(plain_graph_ms, 6),
               "bound_ms": round(bound_ms, 6), "bound_by": "bytes",
               "share_of_bound": round(bound_ms / ms, 4),
               "graph_share_of_bound": round(bound_ms / graph_ms, 4),
               "cold_share_of_bound": round(bound_ms / cold_ms, 4),
               "vs_plain_graph": round(plain_graph_ms / graph_ms, 2),
               "bytes": nbytes, "rel_err": err, "state_rel_err": st,
               "launches_per_call": per_call, "device_kernels": kernels,
               "library_ms": None}
        print(f"[ssd_step] {arch} B={b}: kernels queued {row['ms']} ms, "
              f"graph {row['graph_ms']} ms ({row['graph_share_of_bound']} of "
              f"the bound {row['bound_ms']} ms by bytes; queued "
              f"{row['share_of_bound']}), in a graph after an L2 flush "
              f"{row['cold_ms']} ms ({row['cold_share_of_bound']}); plain "
              f"queued "
              f"{row['plain_ms']} ms, "
              f"graph {row['plain_graph_ms']} ms ({row['vs_plain_graph']}x); "
              f"{per_call} launches a call, device {kernels}; kernel vs "
              f"plain {err}, state {st}", flush=True)
        rows.append(row)
        del p, proj, want, got, plain_c, got_c
    return rows


def _ssd_tokens(SD) -> dict:
    """Nemotron 3 Nano cut to its first 6 layers (up to the first attention
    layer), float32 with TF32 off, random weights at full width, behind a
    ``ServeEngine`` of ``SERVE_SLOTS`` x ``SERVE_MAX_LEN``: ``SERVE_SLOTS``
    greedy requests of ``GRAPH_STEPS`` tokens served with the kernels, then
    again by a fresh engine with the chunked mixer's CUDA call pointed at
    the plain version.  The tokens are held equal, the prefill logits
    within ``BATCHED_F32_REL`` of the largest."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("nemotron-3-nano-30b-a3b")
    n = cfg.layer_pattern.index("*") + 1
    cut = cfg.replace(n_layers=n, layer_pattern=cfg.layer_pattern[:n],
                      param_dtype="float32", compute_dtype="float32")
    params = T.init_params(torch.Generator(device="cuda").manual_seed(34),
                           cut)
    rng = np.random.default_rng(35)
    prompts = [rng.integers(2, cut.vocab, int(k)).tolist() for k in
               rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1,
                            SERVE_SLOTS)]
    runs, kernel_call = [], SD.ssd_mixer_cuda
    try:
        for fn in (kernel_call, SD.ssd_mixer_plain):
            SD.ssd_mixer_cuda = fn
            eng = ServeEngine(cut, params, n_slots=SERVE_SLOTS,
                              max_len=SERVE_MAX_LEN)
            before = SD.launches["ssd"]
            rids = [eng.submit(q, max_new_tokens=GRAPH_STEPS)
                    for q in prompts]
            eng.keep_logits = set(rids)
            done = {r.rid: r for r in eng.run()}
            runs.append(([done[r].out_tokens for r in rids],
                         [eng.logits[r][0] for r in rids],
                         SD.launches["ssd"] - before))
            del eng
    finally:
        SD.ssd_mixer_cuda = kernel_call
    (tk, lk, nk), (tp, lp, npl) = runs
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(lk, lp, strict=True))
    same = sum(a == b for a, b in zip(tk, tp, strict=True))
    print(f"[ssd] served tokens, {n}-layer float32 cut: kernels ({nk} "
          f"launches) against the plain version ({npl}): tokens equal on "
          f"{same} of {len(tk)} requests, prefill logits {rel} of the "
          f"largest", flush=True)
    assert nk > 0 == npl, (nk, npl)
    assert same == len(tk) and rel <= BATCHED_F32_REL, (same, rel)
    del params
    torch.cuda.empty_cache()
    return {"layers": n, "requests": len(tk), "tokens_equal_requests": same,
            "rel_logit_diff": rel, "launches": [nk, npl]}


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
    layer per prefill forward and per decode step (each step one replay of the
    engine's graph); then the engine's prefill logits against ``forward``,
    the greedy agreement with a teacher-forced ``forward`` and the graph
    against the eager loop (:func:`_graph_vs_eager`).  -> (numbers, the
    served parameters)."""
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
    t1 = time.perf_counter()
    eng = ServeEngine(cfg, params, n_slots=SERVE_SLOTS,
                      max_len=SERVE_MAX_LEN)
    torch.cuda.synchronize()
    walls["engine_with_graph_s"] = time.perf_counter() - t1
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
    n_pre, n_dec = len(eng.prefill_groups), eng._steps
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
           "prefill_groups": eng.prefill_groups,
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
    out["graph_vs_eager"] = _graph_vs_eager(eng, prompts)
    walls["checks_s"] = time.perf_counter() - t0 - walls["init_params_s"] \
        - walls["engine_with_graph_s"] - wall
    out["walls"] = walls
    print(f"[serve] {SERVE_ARCH} full width ({n_params} parameters, bf16) on "
          f"{card}: {n_pre} prefill forwards + {n_dec} decode steps, "
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
    _print_graph(SERVE_ARCH, out["graph_vs_eager"], walls)
    return out, params


def _graph_vs_eager(eng, prompts) -> dict:
    """The engine's graphed decode against an eager ``decode_step`` loop
    from the same state: four greedy requests admitted into the engine's
    slots (its prefills), a copy of its caches taken, then ``GRAPH_STEPS``
    steps of each in turns — the engine's step (one replay, one host read
    of the greedy tokens) and ``decode_step`` on the copy with a host read
    per slot (what the engine ran before the graph).  The greedy tokens
    must be equal step for step; the largest logit difference is printed
    (0 expected: the same kernels see the same inputs).  ms per step of
    each (host clock, ending at the last host read); then the device time
    of one replay alone (``serve_profile.replay_ms``) and the card's SM
    clock, temperature and power draw; the peak memory of the engine with
    its graph and the copy."""
    from repro_torch.models import transformer as T
    from repro_torch.serve_profile import clocks, replay_ms
    torch.cuda.reset_peak_memory_stats()
    for p in prompts[:SERVE_SLOTS]:
        eng.submit(p, max_new_tokens=GRAPH_STEPS + 1)
    eng._admit()
    caches = [{k: {n: t.clone() for n, t in part.items()}
               for k, part in c.items()} for c in eng.caches]
    toks, pos = eng.slot_next.copy(), eng.slot_pos.copy()
    graph_ms, eager_ms, worst, same = [], [], 0.0, 0
    for _ in range(GRAPH_STEPS):
        eng.step()
        graph_ms.append(1e3 * eng.decode_s[-1])
        t1 = time.perf_counter()
        with torch.no_grad():
            logits, caches = T.decode_step(
                eng.params, eng.cfg,
                torch.from_numpy(toks[:, None].astype(np.int64)).cuda(),
                caches, torch.from_numpy(pos[:, None]).cuda())
        nxt = np.array([int(torch.argmax(logits[i, 0]))
                        for i in range(SERVE_SLOTS)], dtype=np.int32)
        eager_ms.append(1e3 * (time.perf_counter() - t1))
        worst = max(worst, float((logits - eng.graph.logits).abs().max()))
        same += int(np.array_equal(nxt, eng.slot_next))
        toks, pos = nxt, pos + 1
    assert not eng.queue and all(r is None for r in eng.slot_req)
    assert same == GRAPH_STEPS, (same, GRAPH_STEPS)
    g, e = sorted(graph_ms), sorted(eager_ms)
    return {"steps": GRAPH_STEPS, "tokens_equal_steps": same,
            "max_abs_logit_diff": worst, "per_replay": eng.graph.per_replay,
            "graph_ms_median": g[len(g) // 2], "graph_ms_range": [g[0], g[-1]],
            "eager_ms_median": e[len(e) // 2], "eager_ms_range": [e[0], e[-1]],
            "replay_ms": replay_ms(eng.graph.graph), "clocks": clocks(),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def _batched_vs_single(eng, prompts, tag: str) -> dict:
    """The engine's batched prefill against one request a forward on the
    card: the first ``SERVE_SLOTS`` prompts (one admission wave) served
    twice by the same engine, greedy, ``GRAPH_STEPS`` tokens each, every
    request's logits kept — first in batched forwards (the engine's
    ``prefill_tokens``), then one request a forward (0).  Printed: the
    forwards of each, the prefill logits' largest difference (absolute,
    and relative to the one-a-forward run's largest logit), and the
    requests whose tokens are equal."""
    runs, cap = [], eng.prefill_tokens
    for tokens in (cap, 0):
        eng.prefill_tokens = tokens
        eng.finished, eng.logits, eng.routes = [], {}, {}
        first = len(eng.prefill_groups)
        rids = [eng.submit(p, max_new_tokens=GRAPH_STEPS)
                for p in prompts[:SERVE_SLOTS]]
        eng.keep_logits = set(rids)
        done = {r.rid: r for r in eng.run()}
        eng.keep_logits = None
        runs.append(([done[r].out_tokens for r in rids],
                     [eng.logits[r][0] for r in rids],
                     len(eng.prefill_groups) - first))
    eng.prefill_tokens = cap
    eng.finished, eng.logits, eng.routes = [], {}, {}
    (tb, lb, nb), (ts, ls, ns) = runs
    diff = max(float((b - s).abs().max()) for b, s in zip(lb, ls, strict=True))
    rel = max(float((b - s).abs().max() / s.abs().max())
              for b, s in zip(lb, ls, strict=True))
    same = sum(b == s for b, s in zip(tb, ts, strict=True))
    print(f"[batched] {tag}: {len(tb)} prompts "
          f"{[len(p) for p in prompts[:SERVE_SLOTS]]} in {nb} prefill "
          f"forwards against {ns}; prefill logits' largest difference {diff}"
          f" ({rel} of the largest logit); first {GRAPH_STEPS} tokens equal "
          f"on {same} of {len(tb)} requests", flush=True)
    assert nb < ns == len(tb), (nb, ns)
    return {"forwards": [nb, ns], "max_abs_logit_diff": diff,
            "rel_logit_diff": rel, "tokens_equal_requests": same,
            "requests": len(tb)}


def _batched_f32(cfg, params, prompts, arch: str) -> dict:
    """:func:`_batched_vs_single` on the served weights cut as
    :func:`_f32_parity` cuts them (up to the first attention layer),
    float32 with TF32 off, behind an engine of ``SERVE_SLOTS`` x
    ``SERVE_MAX_LEN``: there rounding alone tells the two apart, so the
    tokens are held equal and the prefill logits within
    ``BATCHED_F32_REL`` of the largest.  (At bf16 the whole model's random
    weights turn the rounding of other row counts into routing flips that
    compound with depth: printed, not held.)"""
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cut, keep = _f32_cut(cfg)
    eng = ServeEngine(cut, _cut(params, cut, "cuda", keep),
                      n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    r = _batched_vs_single(eng, prompts,
                           f"{arch} float32, {cut.n_layers} layers")
    del eng
    torch.cuda.empty_cache()
    assert r["tokens_equal_requests"] == r["requests"], r
    assert r["rel_logit_diff"] <= BATCHED_F32_REL, r
    return r


def _print_graph(arch: str, r: dict, walls: dict) -> None:
    print(f"[graph] {arch}: decode through one CUDA graph replay a step "
          f"(engine with its graph built in {walls['engine_with_graph_s']} "
          f"s; per replay {r['per_replay']}): {r['steps']} steps, greedy "
          f"tokens equal to the eager decode_step loop on "
          f"{r['tokens_equal_steps']}, largest logit difference "
          f"{r['max_abs_logit_diff']}; graphed ms per step median "
          f"{r['graph_ms_median']} ({r['graph_ms_range'][0]}-"
          f"{r['graph_ms_range'][1]}), eager {r['eager_ms_median']} "
          f"({r['eager_ms_range'][0]}-{r['eager_ms_range'][1]}); one replay "
          f"{r['replay_ms']} ms on the device (SM clock, temperature, power "
          f"{r['clocks']}); peak {r['peak_bytes']} B", flush=True)


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
    card, cpu = _cut(params, cfg, "cuda"), _cut(params, cfg, "cpu")
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


# ---------------------------------------------------------------------------
# The other families: MoE, hybrid and SSM served, the VLM and the audio
# decoder driven through forward / decode_step
# ---------------------------------------------------------------------------
def _padded(seq: list[int], chunk: int) -> torch.Tensor:
    """(1, S) tokens right-padded with 0 to a multiple of ``chunk`` (the
    SSD's chunk): every model here is causal, so the pads change no logit
    at a real position."""
    n = -(-len(seq) // chunk) * chunk
    return torch.tensor([seq + [0] * (n - len(seq))], device="cuda")


def _split_calls(FA, b: int, h: int, kvh: int, sk: int) -> int:
    """1 if a one-query-per-row call of this shape takes the split path
    (one merge launch beside it), else 0."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return int(FA.split_plan(b, 1, h, kvh, sk, sms)[0] > 1)


def _serve_arch(counts: Counts, card: str, arch: str) -> tuple[dict, dict]:
    """One family at full width behind ``ServeEngine`` (4 slots x 4096,
    the float32 cache; hymba's window caps its ring at 2048 slots):
    ``ARCH_REQUESTS`` requests of ``ARCH_NEW`` tokens, the last at
    temperature 1; ``n_layers`` attention launches per prefill forward
    and per decode step where the model has attention (none for mamba2), a
    merge per layer per split decode step; the engine's prefill logits against
    ``forward``'s; the greedy agreement with a teacher-forced ``forward``
    (held for hymba and mamba2; printed only for the MoE, whose capacity
    depends on the token count); the graph against the eager loop
    (:func:`_graph_vs_eager`).  qwen2-moe's decode step is printed
    beside its bytes floor: the reference's dispatch multiplies all 60
    experts every step.  -> (numbers, parameters)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine, _prefill_fn
    cfg = get_config(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    t1 = time.perf_counter()
    eng = ServeEngine(cfg, params, n_slots=SERVE_SLOTS,
                      max_len=SERVE_MAX_LEN)
    torch.cuda.synchronize()
    walls = {"engine_with_graph_s": time.perf_counter() - t1}
    rng = np.random.default_rng(0)
    lens = rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1,
                        ARCH_REQUESTS)
    prompts = [rng.integers(2, cfg.vocab, int(n)).tolist() for n in lens]
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=ARCH_NEW,
                   temperature=1.0 if i == len(prompts) - 1 else 0.0)
    done = eng.run()
    c = counts.read(f"serve_{arch}")
    peak = torch.cuda.max_memory_allocated()
    n_pre, n_dec = len(eng.prefill_groups), eng._steps
    attn = cfg.n_attention_layers
    merges = attn * n_dec * (_split_calls(
        FA, SERVE_SLOTS, cfg.n_heads, cfg.n_kv_heads,
        next(c["kv"] for c in eng.caches if "kv" in c)["k"].shape[1])
        if attn else 0)
    assert c["flash_attention"] == attn * (n_pre + n_dec), (c, n_pre, n_dec)
    assert c["flash_attention_combine"] == merges, (c, merges)
    # a dropless MoE layer: one grouped product a prefill and a step
    per_call = _grouped_products(cfg)
    for name, n in per_call.items():
        assert c[name] == n * (n_pre + n_dec), (c, name, n, n_pre, n_dec)
    grouped = sum(per_call.values()) * (n_pre + n_dec)
    # a Mamba-2 mixer: the chunked kernels once a prefill forward, the
    # step's (at most 3) once a decode step
    ssd = _ssd_launches(cfg, n_pre)
    step = _ssd_step_launches(cfg, n_dec)
    assert c["ssd"] == ssd and c["ssd_step"] == step, (c, ssd, step)
    assert sum(c.values()) == c["flash_attention"] \
        + c["flash_attention_combine"] + grouped + ssd + step, c
    assert len(done) == ARCH_REQUESTS and all(
        len(r.out_tokens) == ARCH_NEW for r in done), \
        [len(r.out_tokens) for r in done]
    wall = counts.wall_s[f"serve_{arch}"]
    dec = sorted(eng.decode_s)
    out = {"arch": arch, "params": n_params, "init_params_s": init_s,
           "prompt_lens": [int(n) for n in lens], "prefills": n_pre,
           "prefill_groups": eng.prefill_groups,
           "decode_steps": n_dec, "flash_attention_launches":
           c["flash_attention"], "flash_attention_combine_launches":
           c["flash_attention_combine"], "wall_s": wall,
           "prefill_ms": [1e3 * x for x in eng.prefill_s],
           "decode_ms_median": 1e3 * dec[len(dec) // 2],
           "decode_ms_quartiles": [1e3 * dec[len(dec) // 4],
                                   1e3 * dec[len(dec) // 2],
                                   1e3 * dec[3 * len(dec) // 4]],
           "decode_ms_range": [1e3 * dec[0], 1e3 * dec[-1]],
           "decode_ms_mean": 1e3 * sum(dec) / len(dec),
           "tokens": ARCH_REQUESTS * ARCH_NEW,
           # over the whole wall: the prefills take most of it
           "tokens_per_s": ARCH_REQUESTS * ARCH_NEW / wall,
           "decode_tokens_per_s": (sum(len(r.out_tokens) - 1 for r in done)
                                   / sum(dec)),
           "peak_bytes": peak, "card": card}
    if cfg.moe and cfg.capacity_factor > 0:
        # every step reads every expert (the dispatch multiplies all E)
        # and every other weight but the token embedding's
        expert = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model \
            * cfg.d_expert * 2
        other = 2 * (n_params - cfg.vocab * cfg.d_model) - expert
        out["decode_floor_ms"] = (expert + other) / HBM_BYTES_PER_S * 1e3
        out["decode_floor_bytes"] = {"experts": expert, "other": other}
    # the engine's prefill logits == forward's at the last prompt position
    # (a prompt cut to a multiple of the SSD chunk: forward takes no pads)
    n = len(prompts[0]) // eng.chunk * eng.chunk
    tok = torch.tensor([prompts[0][:n]], device="cuda")
    fresh = T.init_caches(cfg, 1, SERVE_MAX_LEN, dtype=torch.float32)
    got, _ = _prefill_fn(params, cfg, tok, torch.ones_like(tok, dtype=bool),
                         fresh)
    want = T.forward(params, cfg, {"tokens": tok})[:, -1]
    rel = float((got - want).abs().max() / want.abs().max())
    del fresh
    assert rel <= 1e-3, rel
    out["prefill_vs_forward_rel"] = rel
    agree = total = 0
    for r in done:
        if r.temperature > 0:
            continue
        seq = r.prompt + r.out_tokens[:-1]
        logits = T.forward(params, cfg, {"tokens": _padded(seq, eng.chunk)}
                           )[0, len(r.prompt) - 1:len(seq)]
        agree += int((logits.argmax(-1).cpu()
                      == torch.tensor(r.out_tokens)).sum())
        total += len(r.out_tokens)
        del logits
    out["greedy_agreement"] = agree / total
    if cfg.layer_pattern:
        out["batched_vs_single"] = _batched_vs_single(eng, prompts, arch)
    out["graph_vs_eager"] = _graph_vs_eager(eng, prompts)
    out["engine_with_graph_s"] = walls["engine_with_graph_s"]
    if cfg.moe and cfg.capacity_factor > 0:
        del eng
        torch.cuda.empty_cache()
        out["no_drop"] = _moe_no_drop(cfg, params, prompts)
    elif cfg.moe:
        del eng                 # dropless: printed, as the other MoE's
        torch.cuda.empty_cache()
        if cfg.layer_pattern:
            out["batched_vs_single_f32"] = _batched_f32(cfg, params, prompts,
                                                        arch)
    else:
        assert agree / total >= 0.5, (agree, total)
    print(f"[serve] {arch} full width ({n_params} parameters, bf16) on "
          f"{card}: {n_pre} prefill forwards + {n_dec} decode steps, "
          f"{c['flash_attention']} flash_attention launches "
          f"({c['flash_attention_combine']} merges), wall {wall} s, "
          f"{out['tokens_per_s']} tok/s over the wall (prefills included); "
          f"prefill ms {out['prefill_ms']} (prompts {out['prompt_lens']}); "
          f"decode ms per step quartiles {out['decode_ms_quartiles']} over "
          f"{n_dec} steps, range {out['decode_ms_range']}"
          + (f" (bytes floor {out['decode_floor_ms']})"
             if "decode_floor_ms" in out else "")
          + f"; peak {peak} B; prefill vs forward {rel}; greedy agreement "
          f"{agree}/{total}", flush=True)
    _print_graph(arch, out["graph_vs_eager"], walls)
    return out, params


def _ssd_launches(cfg, forwards: int) -> int:
    """The Mamba-2 mixer kernels' launches in ``forwards`` forwards: one
    chunked call a forward in each layer with a Mamba-2 mixer."""
    from repro_torch.kernels.ssd import KERNELS
    return KERNELS * forwards * sum(k in ("ssm", "hybrid")
                                    for k in cfg.layer_kinds)


def _ssd_step_launches(cfg, steps: int) -> int:
    """The recurrent step's launches in ``steps`` decode steps: at most 3
    a step in each layer with a Mamba-2 mixer."""
    from repro_torch.kernels.ssd import STEP_KERNELS
    assert STEP_KERNELS <= 3
    return STEP_KERNELS * steps * sum(k in ("ssm", "hybrid")
                                      for k in cfg.layer_kinds)


def _grouped_products(cfg) -> dict[str, int]:
    """The grouped expert products of one forward, by kernel: one a layer
    whose MoE takes the dropless dispatch, ``moe_grouped_swiglu`` for
    SwiGLU experts, ``moe_grouped`` for relu²."""
    n = 0 if not cfg.moe or cfg.capacity_factor > 0 else cfg.n_moe_layers
    swiglu = cfg.mlp_act != "relu2"
    return {"moe_grouped": 0 if swiglu else n,
            "moe_grouped_swiglu": n if swiglu else 0}


def _f32_cut(cfg):
    """A pattern model cut for a float32 check: up to its first attention
    layer (every kind of layer once at least) or, where every layer also
    holds a MoE (too large in float32 for six of them beside the bf16
    model), its first Mamba-2 and its first attention layer.  -> (the cut
    config, the blocks it keeps)."""
    from repro_torch.models.config import option
    a = cfg.layer_pattern.index("*")
    keep = [cfg.layer_pattern.index("M"), a] \
        if option(cfg, "layer_ffn") else list(range(a + 1))
    return cfg.replace(n_layers=len(keep), layer_pattern="".join(
        cfg.layer_pattern[i] for i in keep), param_dtype="float32",
        compute_dtype="float32"), keep


def _moe_no_drop(cfg, params, prompts) -> dict:
    """The MoE's decode held as the other families' are, at a capacity
    that drops no token (``capacity_factor = E / K``: every expert can take
    every token), where the routing no longer depends on the token count:
    the greedy requests served again behind a fresh ``ServeEngine`` (its
    decode steps run the same program as before — at 4 tokens a step the
    capacity is the floor of 4 either way — only the prefills drop
    nothing now), their tokens against a teacher-forced ``forward`` at
    the same capacity factor, held ≥ 0.5 as hymba's and mamba2's are."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    nd = cfg.replace(capacity_factor=cfg.n_experts / cfg.moe_top_k)
    eng = ServeEngine(nd, params, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    for p in prompts[:-1]:
        eng.submit(p, max_new_tokens=ARCH_NEW, temperature=0.0)
    done = eng.run()
    agree = total = 0
    for r in done:
        seq = r.prompt + r.out_tokens[:-1]
        logits = T.forward(params, nd, {"tokens": torch.tensor(
            [seq], device="cuda")})[0, len(r.prompt) - 1:]
        agree += int((logits.argmax(-1).cpu()
                      == torch.tensor(r.out_tokens)).sum())
        total += len(r.out_tokens)
        del logits
    del eng
    torch.cuda.empty_cache()
    print(f"[serve] {cfg.name} at capacity factor {nd.capacity_factor} (no "
          f"token dropped): greedy agreement with a teacher-forced forward "
          f"{agree}/{total}", flush=True)
    assert agree / total >= 0.5, (agree, total)
    return {"capacity_factor": nd.capacity_factor, "greedy_agreement":
            agree / total, "tokens": total}


def _cut(tree, cfg, dev, blocks=None):
    """The first layers of a parameter tree, as float32 on ``dev``: the
    self blocks and cross blocks that ``cfg`` (the cut config) has, or the
    self blocks at the indices ``blocks``."""
    from repro_torch.models.transformer import n_cross_blocks
    n_cross = n_cross_blocks(cfg)
    keep = {"blocks": range(cfg.n_layers - n_cross) if blocks is None
            else blocks, "cross_blocks": range(n_cross)}

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(node[i]) for i in keep[key]]
        return node.to(dev, torch.float32)

    return walk(tree)


def _f32_parity(counts: Counts, arch: str, cfg, params) -> dict:
    """The family's weights cut to ``ARCH_F32_LAYERS`` layers (the VLM:
    one self and one cross block), float32 with TF32 off, one
    ``ARCH_F32_SEQ``-token forward (the VLM with 1024 image embeddings):
    the card (the kernel) against the CPU (the plain version), relative
    max |Δlogits| ≤ 1e-4, as ``serve_f32_parity``."""
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = {"cross_attn_every": 2} if cfg.cross_attn_every else {}
    keep = None
    if cfg.layer_pattern:
        cut, keep = _f32_cut(cfg)
    else:
        cut = cfg.replace(n_layers=ARCH_F32_LAYERS, param_dtype="float32",
                          compute_dtype="float32", **kw)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(
        2, cut.vocab, (1, ARCH_F32_SEQ)))}
    if cut.cross_attn_every:
        batch["image_embeds"] = torch.from_numpy(rng.normal(
            0, 1, (1, cut.n_image_tokens, cut.d_model)).astype(np.float32))
    card = _cut(params, cut, "cuda", keep)
    counts.reset()
    got = T.forward(card, cut, {k: v.cuda() for k, v in batch.items()})
    c = counts.read(f"f32_{arch}")
    attn, grouped = cut.n_attention_layers, _grouped_products(cut)
    ssd = _ssd_launches(cut, 1)
    assert c["flash_attention"] == attn and c["ssd"] == ssd and all(
        c[k] == n for k, n in grouped.items()) and sum(c.values()) \
        == attn + sum(grouped.values()) + ssd, c
    got = got.cpu()
    del card
    want = T.forward(_cut(params, cut, "cpu", keep), cut, batch)
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"[serve] {arch}: 2-layer float32 forward, card (kernel) vs CPU "
          f"(plain): {rel} of the largest logit", flush=True)
    assert rel <= 1e-4, rel
    return {"rel_max_abs_diff": rel, "flash_attention_launches": attn}


def _vlm(counts: Counts, card: str) -> dict:
    """llama-3.2-vision-90b cut to ``VLM_LAYERS`` layers (2 super-blocks),
    every width kept: ``forward`` over a 512-token prompt and its 8 next
    tokens with 1024 image embeddings (10 launches: the 8 self blocks and
    the 2 cross blocks), then ``decode_step`` with the image embeddings —
    the prompt into the caches (one S = 512 call, which writes the block
    at 0, as the reference's), then 8 teacher-forced steps, each one
    replay of a ``DecodeGraph`` captured before the prompt went in, the
    image embeddings a static input — each step's logits against
    ``forward``'s at its position (bf16: within 5e-2 of the largest logit;
    a wrong cache or a skipped cross block moves them by the logits' own
    size).  Then the float32 card-vs-CPU check."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as T
    from repro_torch.serve.graph import DecodeGraph
    cfg = get_config(VLM_ARCH).replace(n_layers=VLM_LAYERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    img = torch.randn((1, cfg.n_image_tokens, cfg.d_model), generator=gen,
                      device="cuda")
    s = VLM_PROMPT + VLM_STEPS
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        2, cfg.vocab, (1, s))).cuda()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    full = T.forward(params, cfg, {"tokens": toks, "image_embeds": img})
    c = counts.read("vlm_forward")
    assert c["flash_attention"] == cfg.n_layers and \
        sum(c.values()) == cfg.n_layers, c
    fwd_s = counts.wall_s["vlm_forward"]
    caches = T.init_caches(cfg, 1, 2 * VLM_PROMPT, dtype=torch.float32)
    # captured before the prompt goes in (its warm-up undone)
    graph = DecodeGraph(params, cfg, caches, 1, device="cuda",
                        image_embeds=img)
    pos = torch.arange(s, dtype=torch.int32, device="cuda")[None]
    counts.reset()
    _lg, caches = T.decode_step(params, cfg, toks[:, :VLM_PROMPT], caches,
                                pos[:, :VLM_PROMPT], image_embeds=img)
    steps, worst, agree = [], 0.0, 0
    for t in range(VLM_PROMPT, s):
        t1 = time.perf_counter()
        # one replay; the tokens and the (unaligned) position slices are
        # copied into the graph's static inputs
        got, _greedy = graph.run(toks[:, t:t + 1], pos[:, t:t + 1])
        want = full[:, t]
        rel = float((got[:, 0] - want).abs().max() / want.abs().max())
        steps.append(1e3 * (time.perf_counter() - t1))
        worst = max(worst, rel)
        agree += int(got[0, 0].argmax() == want[0].argmax())
    c = counts.read("vlm_decode")
    graph_ms = sorted(steps[1:])[len(steps[1:]) // 2]
    merges = cfg.n_layers * VLM_STEPS * _split_calls(
        FA, 1, cfg.n_heads, cfg.n_kv_heads, 2 * VLM_PROMPT)
    assert c["flash_attention"] == cfg.n_layers * (1 + VLM_STEPS), c
    assert c["flash_attention_combine"] == merges, (c, merges)
    assert worst <= 5e-2, worst
    out = {"arch": VLM_ARCH, "layers": cfg.n_layers, "params": n_params,
           "image_tokens": cfg.n_image_tokens, "prompt": VLM_PROMPT,
           "forward_s": fwd_s, "decode_ms": steps,
           "per_replay": graph.per_replay,
           "decode_vs_forward_rel": worst,
           "decode_argmax_agreement": agree / VLM_STEPS,
           "peak_bytes": torch.cuda.max_memory_allocated(), "card": card}
    del caches, full, graph
    out["f32"] = _f32_parity(counts, VLM_ARCH, cfg, params)
    print(f"[vlm] {VLM_ARCH} cut to {cfg.n_layers} layers ({n_params} "
          f"parameters, bf16) on {card}: forward over {s} tokens and "
          f"{cfg.n_image_tokens} image embeddings {fwd_s} s; decode ms "
          f"{steps} (graph replays, {graph_ms} ms a step after the first); "
          f"decode vs forward {worst} of the largest logit, argmax "
          f"{agree}/{VLM_STEPS}", flush=True)
    return out


def _audio(counts: Counts, card: str, params) -> dict:
    """musicgen-medium at full width, on the weights ``_serve_arch``
    served: one ``forward`` from ``AUDIO_FRAMES`` frame embeddings (48
    launches), finite logits of the expected shape; fed the token
    embeddings of some tokens as ``input_embeds`` it gives the token
    path's logits bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = get_config(AUDIO_ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    n_params = sum(t.numel() for t in _leaves(params))
    emb = torch.randn((1, AUDIO_FRAMES, cfg.d_model), generator=gen,
                      device="cuda") * 0.02
    toks = torch.zeros((1, AUDIO_FRAMES), dtype=torch.int64, device="cuda")
    counts.reset()
    logits = T.forward(params, cfg, {"tokens": toks, "input_embeds": emb})
    c = counts.read("audio_forward")
    assert c["flash_attention"] == cfg.n_layers and \
        sum(c.values()) == cfg.n_layers, c
    assert logits.shape == (1, AUDIO_FRAMES, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 256))).cuda()
    same = torch.equal(
        T.forward(params, cfg, {"tokens": toks}),
        T.forward(params, cfg, {"tokens": toks, "input_embeds": L.embed(
            params["embed"], cfg, toks)}))
    assert same
    wall = counts.wall_s["audio_forward"]
    print(f"[audio] {AUDIO_ARCH} full width ({n_params} parameters, bf16) "
          f"on {card}: forward from {AUDIO_FRAMES} frame embeddings {wall} "
          f"s, {c['flash_attention']} launches", flush=True)
    return {"arch": AUDIO_ARCH, "params": n_params, "frames": AUDIO_FRAMES,
            "forward_s": wall, "input_embeds_equal_token_path": same}


def arch_serve_path(counts: Counts, card: str) -> dict:
    """qwen2-moe-a2.7b, hymba-1.5b, mamba2-780m and musicgen-medium served
    at full width (:func:`_serve_arch`), each with its float32
    card-vs-CPU check, musicgen-medium also with its forward from frame
    embeddings (:func:`_audio`); the VLM cut to 10 layers (:func:`_vlm`).
    Each model is freed before the next is made."""
    from repro_torch.configs import get_config
    out = {}
    for arch in ARCH_SERVE:
        row, params = _serve_arch(counts, card, arch)
        row["f32"] = _f32_parity(counts, arch, get_config(arch), params)
        if arch == AUDIO_ARCH:
            row["frames"] = _audio(counts, card, params)
        out[arch] = row
        del params
        torch.cuda.empty_cache()
    out[VLM_ARCH] = _vlm(counts, card)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The training path: the attention backward kernel, then qwen3-4b steps
# ---------------------------------------------------------------------------
def _bwd_bound(q, k, q_pos, kv_pos) -> tuple[float, str, dict]:
    """Least time (ms) of the backward on these inputs: operations = the
    five products over the visible pairs (S, dP, dV, dQ, dK: 2·hd each a
    pair and head, 10·hd in all) at the dense rate of q's type; bytes = q,
    k, v, out, dout and the positions read once, lse read once, dq, dk, dv
    written once."""
    b, sq, h, hd = q.shape
    keep = q_pos[:, :, None] >= kv_pos[:, None, :]
    pairs = int(keep.sum()) * h
    nops = 10 * pairs * hd
    es = q.element_size()
    nbytes = (es * (4 * q.numel() + 4 * k.numel()) + 4 * b * h * sq
              + 4 * (q_pos.numel() + kv_pos.numel()))
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else OPS_PER_S
    t_ops, t_bytes = nops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    count = {"visible_pairs": pairs, "operations": nops, "bytes": nbytes}
    if t_ops >= t_bytes:
        return t_ops, "operations", count
    return t_bytes, "bytes", count


#: the bf16 backward's tolerance (``grad_excess``): each gradient's largest
#: error against a float64 evaluation at most twice the bf16 plain twin's
BWD_BF16_TOL = "max|kernel - f64| <= 2 max|plain_bf16 - f64|, per gradient"


def _bwd_library(q, k, v, do) -> dict:
    """SDPA's backward as the yardstick (time only): ``torch.autograd.grad``
    through ``scaled_dot_product_attention(is_causal=True)`` on K/V
    repeated to q's heads, queued, with the L2 flushed and in a CUDA graph.
    Its forward runs on a stream of its own: the backward runs there, and a
    graph can capture it there."""
    h, kvh = q.shape[2], k.shape[2]
    row = {}
    lib_stream = torch.cuda.Stream()
    lib_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(lib_stream):
        qs = q.transpose(1, 2).detach().requires_grad_()
        ks, vs = (t.repeat_interleave(h // kvh, 2).transpose(1, 2)
                  .contiguous().requires_grad_() for t in (k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True)
        dos = do.transpose(1, 2)
        library = lambda: torch.autograd.grad(  # noqa: E731
            o, (qs, ks, vs), dos, retain_graph=True)
        row["library_ms"] = round(_time_ms(library), 6)
        row["library_cold_ms"] = round(_time_cold_ms(library), 6)
        try:
            row["library_graph_ms"] = round(_time_graph_ms(
                library, stream=lib_stream), 6)
        except RuntimeError as e:        # the backward would not capture
            row["library_graph_ms"] = None
            row["library_graph_error"] = str(e).splitlines()[0][:200]
    torch.cuda.synchronize()
    return row


def _bwd_errors(FA, got, args) -> dict:
    """Each gradient's error against a float64 evaluation beside the bf16
    plain twin's; asserts ``grad_excess`` <= 1."""
    plain = FA.flash_attention_bwd_plain(*args)
    exact = FA.flash_attention_bwd_plain(
        *(x.double() if x.is_floating_point() else x for x in args))
    errors = {}
    for name, g, w, e in zip(("dq", "dk", "dv"), got, plain, exact):
        errors[name] = {
            "kernel_vs_f64": float((g.double() - e).abs().max()),
            "plain_vs_f64": float((w.double() - e).abs().max()),
            "kernel_vs_plain": float((g.float() - w.float()).abs().max()),
            "excess": FA.grad_excess(g, w, e)}
        assert errors[name]["excess"] <= 1.0, (name, errors[name])
    return errors


def _bwd_device_split(fn, reps: int = 5) -> dict:
    """Device ms per call of each kernel a backward call launches (the
    prologue and the main pass), from ``torch.profiler`` over ``reps``
    calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        name = re.search(r"bwd_\w+(<\d+>)?", e.key)
        if t > 0 and name:
            split[name.group(0)] = round(t / reps / 1e3, 6)
    return split


def _bwd_build_check(build) -> list[str]:
    """The ``[ptxas]`` lines of the backward's instances; asserts 0 spill
    bytes for the one-pass kernel at hd 64 / 80 / 128 (bwd_wg<D>).  A
    library built by an earlier process left no log: nothing to check."""
    log = build.BUILD_LOGS.get("flash_attention_bwd", "")
    lines = _ptxas_summary(log)
    if not log:
        return ["(library built earlier: no ptxas log in this process)"]
    wg = [x for x in lines if "bwd_wg" in x]
    assert len(wg) == 3, wg
    for x in wg:
        assert " 0 bytes spill stores, 0 bytes spill loads" in x, x
    return lines


def check_flash_attention_bwd(FA, build) -> dict:
    """The attention backward kernel against its plain twin on the card.

    The training shape (bf16 q / k / v, B = 2, Sq = Sk = 2048, qwen3-4b's
    32 / 8 heads of 80, positions 0..2047, causal): first the forward
    kernel there against its plain version (out per element within
    ``bf16_out_tolerance``, lse within 1e-4: the backward reads it), then
    dq, dk, dv from the kernel against the plain twin on the kernel's out
    and lse, each within ``BWD_BF16_TOL`` of a float64 evaluation of the
    same function on the same inputs; two runs bit-identical.  hd 128 at
    the training length (granite-3-8b's and minitron-8b's 32 / 8 heads of
    128) alike.  A call with more work items than resident blocks (B = 8,
    the training heads): two runs bit-identical, the first batch row within
    ``BWD_BF16_TOL``.  The float32 variant on a small shape (B = 2, 300
    queries at 200.. over 333 keys, a sentinel tail, G = 4, hd 80, window
    97, softcap 30): each gradient within 1e-5 of the plain twin's largest
    entry.  The one-pass kernel's ptxas lines show no spills.  Timed at the
    training shape and at hd 128 queued, in a CUDA graph and with the L2
    flushed, beside the bound, the plain twin and SDPA's backward on the
    same three measures, with the device time of each kernel of a call.
    -> the kernel row."""
    ptxas = _bwd_build_check(build)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9090)
    b, sq, h, kvh, hd = TRAIN_BATCH, TRAIN_SEQ, 32, 8, 80
    pos = torch.arange(sq, dtype=torch.int32, device="cuda").repeat(b, 1)
    q, k, v, qp, kp = _attention_case(gen, b, sq, sq, h, kvh, hd,
                                      torch.bfloat16, torch.bfloat16, pos,
                                      pos)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = FA.flash_attention_cuda(q, k, v, qp, kp)
    want = FA.flash_attention_plain(q, k, v, qp, kp)
    torch.cuda.synchronize()
    fwd = {"out_vs_tol": _excess(out, want[0], FA.bf16_out_tolerance(
        q, k, v, qp, kp, want)),
        "lse_max_abs_diff": float((lse - want[1]).abs().max())}
    assert fwd["out_vs_tol"] <= 1.0 and fwd["lse_max_abs_diff"] <= 1e-4, fwd
    del want
    args = (q, k, v, qp, kp, out, lse, do)
    got = FA.flash_attention_bwd_cuda(*args)
    again = FA.flash_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    identical = all(torch.equal(x, y) for x, y in zip(got, again))
    assert identical, "two runs of the backward differ"
    del again
    errors = _bwd_errors(FA, got, args)
    names = ("dq", "dk", "dv")
    # the float32 variant: window, softcap, a sentinel tail, G = 4
    qp32 = (torch.arange(300, dtype=torch.int32, device="cuda") + 200
            ).repeat(2, 1)
    kp32 = torch.arange(333, dtype=torch.int32, device="cuda").repeat(2, 1)
    kp32[-1, 300:] = SENTINEL
    f = _attention_case(gen, 2, 300, 333, 16, 4, hd, torch.float32,
                        torch.float32, qp32, kp32)
    kw = {"window": 97, "softcap": 30.0}
    fo, fl = FA.flash_attention_cuda(*f, **kw)
    fdo = torch.randn(fo.shape, generator=gen, device="cuda")
    f_args = (*f, fo, fl, fdo)
    f_got = FA.flash_attention_bwd_cuda(*f_args, **kw)
    f_want = FA.flash_attention_bwd_plain(*f_args, **kw)
    torch.cuda.synchronize()
    f32 = {n: float((g - w).abs().max() / w.abs().max())
           for n, g, w in zip(names, f_got, f_want)}
    assert max(f32.values()) <= 1e-5, f32
    # times at the training shape
    bound, by, count = _bwd_bound(q, k, qp, kp)
    kernel = lambda: FA.flash_attention_bwd_cuda(*args)  # noqa: E731
    row = {"ms": round(_time_ms(kernel), 6),
           "graph_ms": round(_time_graph_ms(kernel), 6),
           "cold_ms": round(_time_cold_ms(kernel), 6),
           "plain_ms": round(_time_ms(lambda: FA.flash_attention_bwd_plain(
               *args), reps=3), 6),
           "bound_ms": round(bound, 6), "bound_by": by,
           "device_split_ms": _bwd_device_split(kernel)}
    row.update(_bwd_library(q, k, v, do))
    for how in ("", "graph_", "cold_"):
        lib = row[f"library_{how}ms"]
        row[f"{how}vs_library"] = (round(row[f"{how}ms"] / lib, 4)
                                   if lib else None)
    del got, args, out, lse, q, k, v, do
    torch.cuda.empty_cache()
    # hd 128 at the training length
    q, k, v, qp, kp = _attention_case(gen, b, sq, sq, h, kvh, 128,
                                      torch.bfloat16, torch.bfloat16, pos,
                                      pos)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = FA.flash_attention_cuda(q, k, v, qp, kp)
    args = (q, k, v, qp, kp, out, lse, do)
    got = FA.flash_attention_bwd_cuda(*args)
    again = FA.flash_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        "two runs of the hd-128 backward differ"
    del again
    hd128 = {"errors": _bwd_errors(FA, got, args)}
    bound128, by128, count128 = _bwd_bound(q, k, qp, kp)
    kernel = lambda: FA.flash_attention_bwd_cuda(*args)  # noqa: E731
    hd128.update({"ms": round(_time_ms(kernel), 6),
                  "graph_ms": round(_time_graph_ms(kernel), 6),
                  "cold_ms": round(_time_cold_ms(kernel), 6),
                  "bound_ms": round(bound128, 6), "bound_by": by128,
                  "operations": count128["operations"],
                  "device_split_ms": _bwd_device_split(kernel)})
    hd128.update(_bwd_library(q, k, v, do))
    for how in ("", "graph_", "cold_"):
        lib = hd128[f"library_{how}ms"]
        hd128[f"{how}vs_library"] = (round(hd128[f"{how}ms"] / lib, 4)
                                     if lib else None)
    del got, args, out, lse, q, k, v, do
    torch.cuda.empty_cache()
    # more work items than resident blocks: B = 8, the training heads
    pos8 = torch.arange(sq, dtype=torch.int32, device="cuda").repeat(8, 1)
    q, k, v, qp, kp = _attention_case(gen, 8, sq, sq, h, kvh, hd,
                                      torch.bfloat16, torch.bfloat16, pos8,
                                      pos8)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = FA.flash_attention_cuda(q, k, v, qp, kp)
    args = (q, k, v, qp, kp, out, lse, do)
    got = FA.flash_attention_bwd_cuda(*args)
    again = FA.flash_attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again)), \
        "two runs of the many-item backward differ"
    del again
    many = {"shape": {"B": 8, "Sq": sq, "H": h, "KV": kvh, "hd": hd},
            "work_items": 8 * kvh * (sq // 128),
            "first_row_errors": _bwd_errors(
                FA, [g[:1] for g in got], tuple(x[:1] for x in args))}
    del got, args, out, lse, q, k, v, do
    torch.cuda.empty_cache()
    print(f"[flash_attention_bwd] training shape: forward out / tolerance "
          f"{fwd['out_vs_tol']:.4f}, lse |diff| {fwd['lse_max_abs_diff']}; "
          f"backward vs float64 {json.dumps(errors)}; float32 variant "
          f"rel {json.dumps(f32)}; two runs bit-identical", flush=True)
    print(f"[flash_attention_bwd] kernel / SDPA backward: queued "
          f"{row['vs_library']}, graph {row['graph_vs_library']}, cold "
          f"{row['cold_vs_library']}; device ms per kernel of a call "
          f"{json.dumps(row['device_split_ms'])}", flush=True)
    print(f"[flash_attention_bwd] hd 128 (2 x 2048, 32 / 8): "
          f"{json.dumps(hd128)}", flush=True)
    print(f"[flash_attention_bwd] many items: {json.dumps(many)}; two runs "
          f"bit-identical", flush=True)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:266",
            "launches": None,
            "max_abs_err": max(e["kernel_vs_plain"] for e in errors.values()),
            "errors": errors, "tolerance": BWD_BF16_TOL,
            "f32_rel_err": f32, "forward_at_training_shape": fwd,
            "bit_identical": identical, **row, **count,
            **{f"hd128_{k}": v for k, v in hd128.items()},
            "many_items": many, "ptxas": ptxas,
            "shape": {"B": b, "Sq": sq, "Sk": sq, "H": h, "KV": kvh,
                      "hd": hd, "dtype": "bfloat16", "causal": True}}


def train_path(counts: Counts, card: str) -> dict:
    """qwen3-4b uncut, trained: 3 steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    tokens through ``build_train_step`` (AdamW, remat="block", the
    reference's default ``TrainConfig``), batches from ``SyntheticLM``
    with dedup on the card, then one eval step.  Every layer's attention
    runs the forward kernel twice a step (the block's forward and its
    recompute) and the backward kernel once."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.config import TrainConfig
    from repro_torch.train import step as TS
    cfg = get_config(TRAIN_ARCH)
    tc = TrainConfig()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = TS.init_state(gen, cfg, tc)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, dedup=True))
    step = TS.build_train_step(cfg, tc)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    walls, recs = [], []
    for i in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, m = step(state, data.batch(i))
        recs.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    c = counts.read("train_path")
    peak = torch.cuda.max_memory_allocated()
    assert c["flash_attention"] == cfg.n_layers * 2 * TRAIN_STEPS, c
    assert c["flash_attention_bwd"] == cfg.n_layers * TRAIN_STEPS, c
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in recs), recs
    counts.reset()
    ev = {k: float(v) for k, v in TS.build_eval_step(cfg)(
        state["params"], data.batch(TRAIN_STEPS)).items()}
    e = counts.read("train_eval")
    assert e["flash_attention"] == cfg.n_layers and \
        e["flash_attention_bwd"] == 0, e
    assert np.isfinite(ev["loss"]), ev
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"arch": TRAIN_ARCH, "params": n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "step_wall_s": walls,
           "tokens_per_s": [tokens / w for w in walls],
           "loss": [r["loss"] for r in recs],
           "grad_norm": [r["grad_norm"] for r in recs],
           "lr": [r["lr"] for r in recs], "eval": ev,
           "flash_attention_launches": c["flash_attention"],
           "flash_attention_bwd_launches": c["flash_attention_bwd"],
           "dedup_dropped": data.dropped, "peak_bytes": peak,
           "init_s": init_s, "card": card}
    print(f"[train] {TRAIN_ARCH} full width ({n_params} parameters, bf16, "
          f"AdamW, remat=block) on {card}: step walls {walls} s, tokens/s "
          f"{out['tokens_per_s']}, loss {out['loss']}, grad norm "
          f"{out['grad_norm']}, lr {out['lr']}; eval loss {ev['loss']}; "
          f"peak memory {peak} B", flush=True)
    del state
    torch.cuda.empty_cache()
    return out


def _reference_layout(tree):
    """A port state as numpy in the reference's layout: the ``blocks``
    list stacked on a leading layer axis (what
    ``convert.train_state_from_numpy`` takes)."""
    if isinstance(tree, dict):
        return {k: (_stack_layers(v) if k == "blocks" and isinstance(v, list)
                    else _reference_layout(v)) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _stack_layers(layers):
    if isinstance(layers[0], dict):
        return {k: _stack_layers([lay[k] for lay in layers])
                for k in layers[0]}
    return np.stack([t.detach().cpu().numpy() for t in layers])


def train_f32_card(counts: Counts) -> dict:
    """qwen3-4b's widths cut to ``TRAIN_F32_LAYERS`` layers and a
    ``TRAIN_F32_VOCAB`` vocabulary (cuts, so the CPU side stays small), in
    float32 with TF32 off, 2 microbatches and int8 error feedback, from
    one ``train_state_from_numpy`` state on the card (the kernels) and on
    the CPU (the plain twins); float32 throughout, sums in other orders.

    * AdamW, 2 steps: at each step the card's accumulated gradients within
      1e-4 of each leaf's largest entry of the CPU's, its loss within 1e-5
      relative; each device applies the CPU's gradients (compression,
      clipping, the learning rate, the optimizer: ``apply_update``), and
      the parameters after 2 steps agree within 2e-5.  A free-running
      card trajectory cannot be held to 2e-5: AdamW divides each gradient
      by its own root mean square, and int8 rounds it to levels of
      max/127, so an element whose gradient sits at 0 or on a rounding
      boundary moves by a whole ``lr`` on one device and not on the other
      (measured in PERF.md §6).
    * The same 2 steps free-running on the card (``build_train_step``,
      its own gradients): losses within 1e-5 relative of the CPU's, the
      parameters' largest difference and the count over 2e-5 printed; the
      launch counts held.
    * Adafactor, 1 step, as the AdamW steps.
    * Resume on the card: save the free-running state after step 1,
      restore into a fresh state, run step 2: bit-equal to the
      uninterrupted run (the kernels have no atomics)."""
    import tempfile

    from repro_torch import convert
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.config import TrainConfig
    from repro_torch.train import optim as TO
    from repro_torch.train import step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH).replace(
        n_layers=TRAIN_F32_LAYERS, vocab=TRAIN_F32_VOCAB,
        param_dtype="float32", compute_dtype="float32")
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                     n_microbatches=2, grad_compression="int8_ef")
    init = _reference_layout(TS.init_state(torch.Generator().manual_seed(1),
                                           cfg, tc, "cpu"))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_F32_SEQ,
                                  global_batch=2), device="cpu")
    batches = [data.batch(i) for i in range(2)]
    out: dict = {"cuts": {"n_layers": TRAIN_F32_LAYERS,
                          "vocab": TRAIN_F32_VOCAB, "seq": TRAIN_F32_SEQ}}

    def grad_rel(card, cpu):
        return max(float((x.cpu() - y).abs().max())
                   / max(float(y.abs().max()), 1e-30)
                   for x, y in zip(card, cpu))

    def param_diff(card, cpu):
        a, b = TO.tree_leaves(card), TO.leaves_like(cpu, card)
        return (max(float((x.cpu() - y).abs().max()) for x, y in zip(a, b)),
                sum(int(((x.cpu() - y).abs() > 2e-5).sum())
                    for x, y in zip(a, b)))

    def forced(cfg_o, init_o, steps):
        """Both devices step on the CPU's gradients; -> (per step: card
        gradient rel, loss rel), parameter max |diff|, states."""
        st = {d: convert.train_state_from_numpy(init_o, cfg_o, tc, d)
              for d in ("cuda", "cpu")}
        per = []
        for b in batches[:steps]:
            g_cpu, m_cpu = TS.accumulate_grads(st["cpu"]["params"], cfg_o,
                                               tc, b)
            g_card, m_card = TS.accumulate_grads(st["cuda"]["params"],
                                                 cfg_o, tc, b)
            per.append({"grad_rel": grad_rel(g_card, g_cpu),
                        "loss_rel": abs(float(m_card["loss"])
                                        - float(m_cpu["loss"]))
                        / abs(float(m_cpu["loss"])),
                        "loss": float(m_cpu["loss"])})
            del g_card
            TS.apply_update(st["cuda"], [g.cuda() for g in g_cpu], cfg_o, tc)
            TS.apply_update(st["cpu"], g_cpu, cfg_o, tc)
        return per, param_diff(st["cuda"]["params"], st["cpu"]["params"]), st

    out["adamw"], (out["adamw_param_abs"], _n), st = forced(cfg, init, 2)
    cpu_losses = [r["loss"] for r in out["adamw"]]
    # free-running on the card: its own gradients
    free = convert.train_state_from_numpy(init, cfg, tc, "cuda")
    step = TS.build_train_step(cfg, tc)
    counts.reset()
    free_losses = [float(step(free, b)[1]["loss"]) for b in batches]
    c = counts.read("train_f32_card")
    per = tc.n_microbatches * cfg.n_layers * len(batches)
    assert c["flash_attention"] == 2 * per and \
        c["flash_attention_bwd"] == per, c
    out["free_loss_rel"] = max(abs(a - b) / abs(b)
                               for a, b in zip(free_losses, cpu_losses))
    out["free_param_abs"], out["free_params_over_2e-5"] = param_diff(
        free["params"], st["cpu"]["params"])
    del st
    # Adafactor: the same parameters, its own fresh slots
    cfg_af = cfg.replace(optimizer="adafactor")
    init_af = dict(init, opt=_reference_layout(TO.adafactor_init(
        TS.init_state(torch.Generator().manual_seed(1), cfg_af, tc,
                      "cpu")["params"])))
    out["adafactor"], (out["adafactor_param_abs"], _n), _st = forced(
        cfg_af, init_af, 1)
    del _st
    # resume on the card: step 1, save, restore into a fresh state, step 2
    with tempfile.TemporaryDirectory() as tmp:
        s1 = convert.train_state_from_numpy(init, cfg, tc, "cuda")
        s1, _m = step(s1, batches[0])
        cm = CheckpointManager(tmp)
        cm.save(1, s1)
        del s1
        fresh = convert.train_state_from_numpy(init, cfg, tc, "cuda")
        at, resumed = cm.restore(fresh)
        del fresh
        resumed, _m = step(resumed, batches[1])
    got, want = TO.tree_leaves(resumed), TO.leaves_like(free, resumed)
    out["resume_bit_equal"] = at == 1 and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(got, want))
    print(f"[train] {TRAIN_F32_LAYERS}-layer float32 training, card (kernels)"
          f" vs CPU (plain): AdamW per step {out['adamw']}, params on the "
          f"CPU's gradients |diff| {out['adamw_param_abs']}; free-running "
          f"card losses {free_losses} vs {cpu_losses} (rel "
          f"{out['free_loss_rel']}), params |diff| {out['free_param_abs']} "
          f"({out['free_params_over_2e-5']} over 2e-5); Adafactor "
          f"{out['adafactor']}, params |diff| {out['adafactor_param_abs']}; "
          f"resume bit-equal {out['resume_bit_equal']}", flush=True)
    for r in out["adamw"] + out["adafactor"]:
        assert r["grad_rel"] <= 1e-4 and r["loss_rel"] <= 1e-5, out
    assert out["free_loss_rel"] <= 1e-5, out
    assert out["adamw_param_abs"] <= 2e-5 and \
        out["adafactor_param_abs"] <= 2e-5, out
    assert out["resume_bit_equal"], out
    return out

def _local(t):
    """A DTensor's local shard (on a (1, 1) mesh: all of it)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_train_path(counts: Counts, card: str) -> dict:
    """hymba-1.5b and mamba2-780m uncut, trained by ``launch.train.main``
    on the (1, 1) host mesh of the open one-process group: 3 steps with a
    checkpoint after step 2 (and the launcher's final one after step 3);
    then the step-3 checkpoint is removed and a restart resumes from step
    2: its step 3 must equal the uninterrupted one bit for bit."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train as LT
    from repro_torch.train import optim as TO
    out = {}
    for arch in MESH_TRAIN_ARCHS:
        cfg = get_config(arch)
        attn = cfg.n_layers if cfg.block_type in ("attention", "hybrid") \
            else 0
        with tempfile.TemporaryDirectory() as tmp:
            args = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
                    str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr",
                    str(MESH_TRAIN_LR), "--ckpt-every",
                    str(MESH_CKPT_EVERY), "--out", tmp]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            counts.reset()
            a = LT.main(args)
            c = counts.read(f"mesh_train_{arch}")
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            shutil.rmtree(os.path.join(tmp, f"step_{TRAIN_STEPS:010d}"))
            counts.reset()
            b = LT.main(args)
            r = counts.read(f"mesh_resume_{arch}")
            with open(os.path.join(tmp, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
        got = TO.tree_leaves(b["state"])
        want = TO.leaves_like(a["state"], b["state"])
        equal = all(torch.equal(_local(x), _local(y))
                    and _local(x).dtype == _local(y).dtype
                    for x, y in zip(got, want, strict=True))
        walls = [rec["dt_s"] for rec in recs[:TRAIN_STEPS]]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        row = {"arch": arch, "params": cfg.param_count(), "dp": a["dp"],
               "step_wall_s": walls,
               "tokens_per_s": [tokens / w for w in walls],
               "loss": [rec["loss"] for rec in recs],
               "resumed_at": b["start"], "resume_bit_equal": equal,
               "peak_bytes": peak, "wall_s": wall,
               "flash_attention_launches": c["flash_attention"],
               "flash_attention_bwd_launches": c["flash_attention_bwd"],
               "resume_launches": [r["flash_attention"],
                                   r["flash_attention_bwd"]]}
        print(f"[mesh_train] {arch} full width ({row['params']} parameters,"
              f" bf16, AdamW, remat=block) on the (1, 1) mesh on {card}: "
              f"step walls {walls} s, tokens/s {row['tokens_per_s']}, loss "
              f"{row['loss']}, peak memory {peak} B; resumed at "
              f"{b['start']}, step {TRAIN_STEPS} bit-equal {equal}",
              flush=True)
        assert a["dp"] == 1 and b["start"] == MESH_CKPT_EVERY, row
        assert c["flash_attention"] == attn * 2 * TRAIN_STEPS, row
        assert c["flash_attention_bwd"] == attn * TRAIN_STEPS, row
        assert r["flash_attention"] == attn * 2 * (
            TRAIN_STEPS - MESH_CKPT_EVERY), row
        assert all(np.isfinite(x) for x in row["loss"]), row
        assert row["loss"][-1] == row["loss"][TRAIN_STEPS - 1], row
        assert equal, row
        out[arch] = row
        del a, b, got, want
        torch.cuda.empty_cache()
    return out


def mesh_parity(counts: Counts) -> dict:
    """qwen3-4b's widths cut to ``MESH_PARITY_LAYERS`` layers, float32 with
    TF32 off: one train step (2 microbatches) on the (1, 1) mesh of the
    open group equals the same step without a mesh, every leaf bit for bit
    (on one rank every DTensor op is the local op)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (batch_specs, distribute_tree,
                                             state_specs)
    from repro_torch.models.config import TrainConfig
    from repro_torch.train import optim as TO
    from repro_torch.train import step as TS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH).replace(
        n_layers=MESH_PARITY_LAYERS, param_dtype="float32",
        compute_dtype="float32")
    tc = TrainConfig(learning_rate=1e-3, n_microbatches=2)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH),
                        device="cpu").batch(0)
    step = TS.build_train_step(cfg, tc)

    def fresh():
        return TS.init_state(torch.Generator(device="cuda").manual_seed(5),
                             cfg, tc, "cuda")

    counts.reset()
    plain, pm = step(fresh(), batch)
    cp = counts.read("mesh_parity_plain")
    mesh = make_host_mesh(device="cuda")
    state = fresh()
    state = distribute_tree(state, state_specs(cfg, state, mesh), mesh)
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    tb = distribute_tree(tb, batch_specs(tb, mesh), mesh)
    counts.reset()
    sharded, sm = step(state, tb)
    cm = counts.read("mesh_parity")
    got = TO.tree_leaves(sharded)
    want = TO.leaves_like(plain, sharded)
    pairs = list(zip(got, want, strict=True))
    diff = [float((_local(x) - y).abs().max()) for x, y in pairs]
    equal = all(torch.equal(_local(x), y) for x, y in pairs)
    out = {"layers": MESH_PARITY_LAYERS, "bit_equal": equal,
           "max_abs_diff": max(diff),
           "loss": [float(pm["loss"]), float(sm["loss"])],
           "launches": [cm["flash_attention"], cm["flash_attention_bwd"]]}
    print(f"[mesh_parity] {MESH_PARITY_LAYERS}-layer float32 step on the "
          f"(1, 1) mesh vs no mesh: bit-equal {equal}, largest |diff| "
          f"{max(diff)}, losses {out['loss']}", flush=True)
    per = MESH_PARITY_LAYERS * tc.n_microbatches
    assert cm["flash_attention"] == cp["flash_attention"] == 2 * per, out
    assert cm["flash_attention_bwd"] == cp["flash_attention_bwd"] == per
    assert equal and out["loss"][0] == out["loss"][1], out
    return out


def roofline_phase(train_out: dict, card: str) -> dict:
    """``dispatch_cost`` of one ``train_path`` step (qwen3-4b uncut, 2 x
    2048 tokens, the default ``TrainConfig``) on fake tensors on the host,
    its H100 roofline terms on one device, and ``mfu`` from
    ``train_path``'s median step wall."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch import dispatch_cost as DC
    from repro_torch.launch import roofline as RL
    from repro_torch.models.config import ShapeConfig, TrainConfig
    from repro_torch.train import step as TS
    cfg, tc = get_config(TRAIN_ARCH), TrainConfig()
    shape = ShapeConfig("train_path", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    with FakeTensorMode():
        state = TS.init_state(torch.Generator().manual_seed(0), cfg, tc,
                              "cpu")
        batch = {"tokens": torch.zeros((TRAIN_BATCH, TRAIN_SEQ),
                                       dtype=torch.int32),
                 "labels": torch.zeros((TRAIN_BATCH, TRAIN_SEQ),
                                       dtype=torch.int32),
                 "loss_mask": torch.ones((TRAIN_BATCH, TRAIN_SEQ))}
        cost = DC.dispatch_cost(TS.build_train_step(cfg, tc), state, batch,
                                fake=False)
    cost_s = time.perf_counter() - t0
    terms = RL.roofline_terms({"dispatch_cost": cost,
                               "collectives": {"total_bytes": 0}},
                              cfg, shape, 1)
    wall = float(np.median(train_out["step_wall_s"]))
    out = {"arch": TRAIN_ARCH, "card": card, "step_wall_s": wall,
           "mfu": RL.mfu(cfg, shape, wall),
           "bound_over_wall": terms["bound_s"] / wall,
           "peak_flops": RL.PEAK_FLOPS, "hbm_bytes_per_s": RL.HBM_BW,
           "flops": cost["flops"], "dot_flops": cost["dot_flops"],
           "bytes_major": cost["bytes_major"],
           "dispatch_cost_s": cost_s, **terms}
    print("[roofline] " + json.dumps(out), flush=True)
    assert 0 < out["mfu"] < 1 and cost["dot_flops"] > terms["model_flops"]
    return out


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
    from repro_torch.kernels import moe_grouped as MG
    from repro_torch.kernels import popcount_gemm as PG
    from repro_torch.kernels import senseamp as S
    from repro_torch.kernels import ssd as SD
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
    for name in ("popcount_gemm", "flash_attention", "flash_attention_bwd",
                 "moe_grouped", "ssd"):
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
                   *fa_row["arch_shapes"].items(), ("merge", merge_row)):
        print(f"[flash_attention] {tag}: kernel {r['ms']} ms (cold "
              f"{r['cold_ms']}), plain {r['plain_ms']} ms, library "
              f"{r['library_ms']} ms (cold {r.get('library_cold_ms')}), "
              f"bound {r['bound_ms']} ms ({r['bound_by']}) at {r['shape']}",
              flush=True)
    bwd_row = check_flash_attention_bwd(FA, build)
    print(f"[flash_attention_bwd] kernel {bwd_row['ms']} ms (graph "
          f"{bwd_row['graph_ms']}, cold {bwd_row['cold_ms']}), plain "
          f"{bwd_row['plain_ms']} ms, SDPA backward {bwd_row['library_ms']} "
          f"ms (graph {bwd_row['library_graph_ms']}, cold "
          f"{bwd_row['library_cold_ms']}), bound {bwd_row['bound_ms']} ms "
          f"({bwd_row['bound_by']}) at {bwd_row['shape']}", flush=True)
    moe_rows = check_moe_grouped(MG)
    ssd_rows = check_ssd(SD) + check_ssd_step(SD)
    t0 = _phase("kernel_vs_plain", t0, times)

    # ---- main path: the launch count covers exactly these calls ----
    counts = Counts(S, BW, BS, PG, FA, MG, SD)
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
    fused_out = fused_path(counts)
    t0 = _phase("fused_path", t0, times)

    # ---- the decoder LM behind the serving engine ----
    serve_out, params = serve_path(counts, card)
    print("[serve] " + json.dumps(serve_out), flush=True)
    print("[serve] " + json.dumps(serve_f32_parity(counts, params)),
          flush=True)
    del params
    torch.cuda.empty_cache()
    t0 = _phase("serve_path", t0, times)
    print("[arch_serve] " + json.dumps(arch_serve_path(counts, card)),
          flush=True)
    t0 = _phase("arch_serve_path", t0, times)

    # ---- the decoder LM trained: full width, then float32 card vs CPU ----
    train_out = train_path(counts, card)
    print("[train] " + json.dumps(train_out), flush=True)
    t0 = _phase("train_path", t0, times)
    print("[train] " + json.dumps(train_f32_card(counts)), flush=True)
    t0 = _phase("train_f32_card", t0, times)

    # ---- the mesh: a one-process NCCL group, the (1, 1) host mesh ----
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        print("[mesh_train] " + json.dumps(mesh_train_path(counts, card)),
              flush=True)
        t0 = _phase("mesh_train_path", t0, times)
        print("[mesh_parity] " + json.dumps(mesh_parity(counts)),
              flush=True)
        t0 = _phase("mesh_parity", t0, times)
    finally:
        dist.destroy_process_group()
    roofline_phase(train_out, card)
    t0 = _phase("roofline", t0, times)
    print("[times] " + json.dumps(times), flush=True)

    rows = [row, *bit_rows, fa_row, merge_row, bwd_row, *moe_rows,
            *ssd_rows]
    for r in rows:
        r["launches"] = counts.total(r["name"])
        r["launches_by_path"] = {p: c[r["name"]]
                                 for p, c in counts.by_path.items()
                                 if c[r["name"]]}
        assert r["launches"] > 0, r["name"]
    print("[dram] " + json.dumps(dram_out), flush=True)
    print("[fused_path] " + json.dumps(fused_out["mc"]), flush=True)
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
