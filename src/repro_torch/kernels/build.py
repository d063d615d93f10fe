"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Each ``csrc/<name>.cu`` exposes plain C entry points and compiles on its own,
on first use (:func:`load`; nothing is compiled when a module is imported),
into ``lib<name>-<hash>.so``, keyed by the content hash of the source, of
every ``csrc/*.cuh`` header and of its flags, so an edited source or header
is never served a stale library.  The library lands in
``build/kernels/`` at the root of the checkout the package runs from, or, for
an installed package, in ``_build/`` beside this module — never in a
directory shared with other checkouts.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3`` and
``-Xptxas=-v`` (each kernel's registers, shared memory and spills, kept in
:data:`BUILD_LOGS`), then the source's own (:func:`flags`): ``--fmad=false``
by default — those kernels reproduce the float32 operation order of the
numpy reference, so nvcc must not contract a multiply and an add into an
FMA — and ``--fmad=true`` for ``flash_attention``, ``flash_attention_bwd``
and ``moe_grouped``, whose float32 arithmetic is held to a tolerance, not
bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
#: <checkout>/src/repro_torch/kernels -> <checkout>
_ROOT = _HERE.parents[2]
BUILD_DIR = (_ROOT / "build" / "kernels"
             if _HERE.parents[1].name == "src"
             and (_ROOT / "pyproject.toml").exists() else _HERE / "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
#: flags of one source beyond NVCC_FLAGS (default: no FMA contraction)
SOURCE_FLAGS = {"flash_attention": ("--fmad=true",),
                "flash_attention_bwd": ("--fmad=true",),
                "moe_grouped": ("--fmad=true",)}

_LIBS: dict[str, ctypes.CDLL] = {}
#: nvcc's output (ptxas resource usage) of each source built in this process
BUILD_LOGS: dict[str, str] = {}


def flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ("--fmad=false",))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        out = lib_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *flags(name), "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}")
            BUILD_LOGS[name] = proc.stdout
            os.replace(tmp, out)
        lib = _LIBS[name] = ctypes.CDLL(str(out))
    return lib
