"""Where the attention backward's time goes, on one CUDA device.

    python -m repro_torch.bwd_ablation [--out build/bwd_ablation.json]

Builds ``csrc/flash_attention_bwd.cu`` as it is and in copies with one
part of the one-pass kernel (``bwd_wg``) taken out, then times each on
the same bf16 inputs (causal, positions 0..S-1) at the training shape
(2 x 2048, 32 / 8 heads of 80) and at hd 128, CUDA events around 10
back-to-back calls after a warm-up, the median of 3 such runs:

  full       the kernel as it is;
  no_dq      no dQ: no dS^T hand-off, no dQ product, the writers idle;
  no_order   the writers add without waiting for the key tiles before
             them (a race: its dq is wrong; time only);
  no_copy    the copy warp issues no ring copies (the products run on
             stale shared memory; time only);
  skeleton   no_dq without the four other products either: the
             exponentials, the barriers and the copies alone.

A part whose removal saves little is hidden behind the others.  The copies
are text patches of the source; a pattern that no longer matches stops the
tool.  Prints one JSON object (the card, the ptxas lines of ``bwd_wg``,
ms per variant and shape) and writes it to ``--out``.  Needs a CUDA device
and nvcc; without a device it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SHAPES = ((2, 2048, 32, 8, 80), (2, 2048, 32, 8, 128))

#: variant -> (pattern, replacement) edits of the source
_NO_DQ = (("    } else if (role > 0) {", "    } else if (false) {"),
          ("    const bool mine = wg == NWG - 1;",
           "    const bool mine = false;"))
VARIANTS = {
    "full": (),
    "no_dq": _NO_DQ,
    "no_order": (("for (int polls = 0; rank > 0 && ld_acquire(ctr) != rank;",
                  "for (int polls = 0; false;"),),
    "no_copy": (("        for (int r = roff; on && r < BT;",
                 "        for (int r = roff; false;"),
                ("        for (int x = lane; x < 48; x += 32) {",
                 "        for (int x = lane; false; x += 32) {")),
    "skeleton": _NO_DQ + (
        ("      for (int kk = 0; kk < KS; ++kk)\n        wgmma_ss(s,",
         "      for (int kk = 0; kk < 0; ++kk)\n        wgmma_ss(s,"),
        ("      for (int kk = 0; kk < KS; ++kk)\n        wgmma_ss(dp,",
         "      for (int kk = 0; kk < 0; ++kk)\n        wgmma_ss(dp,"),
        ("    float s[8][4], dp[8][4];\n",
         "    float s[8][4] = {}, dp[8][4] = {};\n"),
        ("    for (int kk = 0; kk < 4; ++kk) product_rs<D>(dv, pa[kk], to, kk);",
         ""),
        ("    for (int kk = 0; kk < 4; ++kk) product_rs<D>(dk, da[kk], tq, kk);",
         "")),
}


def _build(name: str, edits, out_dir: Path) -> tuple[str, Path, str]:
    from .kernels import build
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    cu = out_dir / f"{name}.cu"
    lib = out_dir / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([build._nvcc(), *build.flags("flash_attention_bwd"),
                           "-o", str(lib), str(cu)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    return name, lib, proc.stdout


def _ptxas_wg(log: str) -> list[str]:
    """'bwd_wg<D>: registers; spills' of each instance from -Xptxas=-v."""
    out, name, spill = [], "", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and "bwd_wg" in name:
            d = name.split("bwd_wgILi")[1].split("E")[0]
            out.append(f"bwd_wg<{d}>: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
    return out


def _ms(fn, reps: int = 10) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/bwd_ablation.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    from .kernels import build
    from .kernels import flash_attention as FA
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    out_dir = build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(lambda kv: _build(*kv, out_dir),
                              VARIANTS.items()))
    report = {"card": smi.stdout.strip(), "ptxas": {}, "ms": {}}
    libs = {}
    for name, lib, log in built:
        libs[name] = FA.bind_bwd(ctypes.CDLL(str(lib)))
        report["ptxas"][name] = _ptxas_wg(log)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for b, s, h, kv, hd in SHAPES:
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16)
        q, k, v, do = rnd(b, s, h, hd), rnd(b, s, kv, hd), rnd(b, s, kv, hd), \
            rnd(b, s, h, hd)
        pos = torch.arange(s, dtype=torch.int32, device="cuda").repeat(b, 1)
        out, lse = FA.flash_attention_cuda(q, k, v, pos, pos)
        key = f"{b}x{s}, {h}/{kv} heads of {hd}"
        report["ms"][key] = {}
        saved = FA._BWD_LIB
        try:
            for name, lib in libs.items():
                FA._BWD_LIB = lib
                runs = sorted(_ms(lambda: FA.flash_attention_bwd_cuda(
                    q, k, v, pos, pos, out, lse, do)) for _ in range(3))
                report["ms"][key][name] = runs[1]
        finally:
            FA._BWD_LIB = saved
    print(json.dumps(report, indent=1))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
