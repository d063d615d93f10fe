"""Traffic kind ``mc_boolean``: one call is one success rate of an n-input
AND / NAND / OR / NOR at the mix's trials, through
``repro_torch.core.charz.mc_boolean_success`` on the configuration's module,
row width, temperature, banks and draws; judged against
``bench.reference.mc.boolean`` (``bench/mcjudge.py``).  Mix keys: ``op``,
``n``, ``trials``, ``groups``."""
from __future__ import annotations

from bench.mcjudge import McDriver, rounds
from bench.reference import mc as reference

#: the numbers compared, with their limits: exact (a simulator sped up
#: must leave every simulated statistic identical)
LIMITS = {"rate_gap": 0.0, "row_mismatch": 0}


def call(cfg: dict, mix: dict, seed: int, device: str) -> float:
    from repro_torch.core import charz
    mod = cfg["module"]
    return charz.mc_boolean_success(
        mix["op"], mix["n"], trials=mix["trials"], row_bits=mod["row_bits"],
        seed=seed, module=mod["name"], temp_c=cfg["temp_c"],
        banks=cfg["banks"], groups=mix["groups"], fused=cfg["fused"],
        draws=cfg["draws"], device=device)


def apas(cfg: dict, mix: dict) -> list[dict]:
    """The sense-amp resolves of one call, from the mix alone: one per
    group on one bank, or, where the banks fuse (the default for more than
    one bank), one per round of up to ``banks`` groups stacked on the trial
    axis with a per-bank static plane and threshold."""
    tg = -(-mix["trials"] // mix["groups"])
    w, n = cfg["module"]["row_bits"] // 2, mix["n"]
    return [{"T": tg * nb, "W": w, "n_com": n, "n_ref": n, "banks": nb}
            for nb in rounds(cfg, mix)]


DRIVER = McDriver(call, reference.boolean, LIMITS, apas)
