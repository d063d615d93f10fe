"""Traffic kind ``mc_not``: one call is one success rate of the NOT with
``n_dst`` destination rows at the mix's trials, through
``repro_torch.core.charz.mc_not_success``; judged against
``bench.reference.mc.not_`` (``bench/mcjudge.py``).  Mix keys: ``n_dst``,
``trials``, ``groups``.  The NOT resolves no comparator: no sense-amp
kernel runs.  The entry point takes no temperature: it runs at 50 C,
so a configuration at another temperature is refused."""
from __future__ import annotations

from bench.mcjudge import McDriver
from bench.reference import mc as reference

LIMITS = {"rate_gap": 0.0, "row_mismatch": 0}


def call(cfg: dict, mix: dict, seed: int, device: str) -> float:
    from repro_torch.core import charz
    mod = cfg["module"]
    if cfg["temp_c"] != 50.0:
        raise ValueError("mc_not_success runs at 50 C only")
    return charz.mc_not_success(
        mix["n_dst"], trials=mix["trials"], row_bits=mod["row_bits"],
        seed=seed, module=mod["name"], banks=cfg["banks"],
        groups=mix["groups"], fused=cfg["fused"], draws=cfg["draws"],
        device=device)


def apas(cfg: dict, mix: dict) -> list[dict]:
    return []


DRIVER = McDriver(call, reference.not_, LIMITS, apas)
