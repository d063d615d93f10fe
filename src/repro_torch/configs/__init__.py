"""Architecture registry: the 10 assigned configs + the FCDRAM substrate.

``get_config("<id>")`` accepts both dashed ids (CLI) and module names.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig, SHAPES, ShapeConfig

ARCHS: tuple[str, ...] = (
    "minitron-8b",
    "granite-3-8b",
    "qwen3-4b",
    "llama3-405b",
    "qwen2-moe-a2.7b",
    "grok-1-314b",
    "hymba-1.5b",
    "mamba2-780m",
    "musicgen-medium",
    "llama-3.2-vision-90b",
)


def _module_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str) -> ModelConfig:
    name = _module_name(arch)
    try:
        mod = importlib.import_module(f".{name}", __package__)
    except ModuleNotFoundError as e:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCHS)}") from e
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)


#: shapes skipped per arch, with the recorded reason (DESIGN.md).
SKIPS: dict[tuple[str, str], str] = {}
for _a in ARCHS:
    _cfg = get_config(_a)
    if not _cfg.supports_long_decode:
        SKIPS[(_a, "long_500k")] = (
            "pure full-attention arch: 524288-token KV decode is "
            "O(S) memory/step with no sub-quadratic path; run on "
            "SSM/hybrid/sliding-window archs only (spec)")


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells honoring the skip table."""
    for a in ARCHS:
        for s in SHAPES:
            if not include_skipped and (a, s) in SKIPS:
                continue
            yield a, s
