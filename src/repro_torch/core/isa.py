"""PuD instruction set over the torch bank: pair inventory, ISA, cost model.

The port of ``repro.core.isa``.  The pair inventory (a uint64 hash over the
address cross product — PyTorch has no full uint64 arithmetic), the pair
walk and the cost model stay host-side numpy/Python, copied from the
reference; :class:`PudIsa` stages operand words into and reads results out
of the device-resident :class:`~repro_torch.core.simulator.BankSim`.
Words may come in as numpy arrays or tensors and come back as uint8 tensors
on the bank's device.

* :class:`PairInventory` — per (module, seed) table of which ``(R_F, R_L)``
  address pairs realize each ``N_RF:N_RL`` activation type (the software
  equivalent of the paper's reverse-engineering sweep, §4.2).
* :class:`PudIsa` — executes logical PuD instructions (NOT / many-input
  AND / OR / NAND / NOR, RowClone staging, Frac) on a :class:`BankSim`
  subarray pair, handling operand staging, reference-row initialization,
  half-row (open-bitline) data layout and result extraction.
* :class:`CostModel` — DDR4 command-level latency/energy of each logical op
  (the paper's motivation quantified: in-DRAM ops move no data over the bus).

Data layout: a logical PuD *word* is ``shared_w = row_bits/2`` bits wide
(footnote 6: inter-subarray ops compute on half a row).  Words on the
compute (R_L) side occupy even columns; on the reference (R_F) side, odd
columns.  ``PudIsa`` packs/unpacks transparently.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from . import decoder as DEC
from .analog import ALL_OPS, _base_op
from .device import (ENERGY_PJ, ModuleConfig, get_module, timings_for,
                     VIOLATED_TRAS_NS, VIOLATED_TRP_NS)
from .simulator import BankSim


# ---------------------------------------------------------------------------
# Pair inventory
# ---------------------------------------------------------------------------
class PairInventory:
    """All (R_F row, R_L row) pairs per activation type for a subarray pair.

    Built once per (module, seed) by evaluating the decoder hash over the
    full address cross product — the software twin of the paper's 409,600-
    combination reverse-engineering sweep.
    """

    def __init__(self, module: ModuleConfig, *, seed: int = 0):
        self.module = module
        self.seed = seed
        n = module.geometry.rows_per_subarray
        pairs: dict[tuple[int, int], list[tuple[int, int]]] = {}
        # vectorized category per pair (mirrors decoder.coverage)
        M = np.uint64(0xFFFFFFFFFFFFFFFF)
        rf = np.arange(n, dtype=np.uint64)[:, None]
        rl = np.arange(n, dtype=np.uint64)[None, :]
        with np.errstate(over="ignore"):
            x = (np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15) + rf)
            for sh, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
                x = ((x ^ (x >> np.uint64(sh))) * np.uint64(mul)) & M
            x ^= x >> np.uint64(31)
            y = (rl * np.uint64(0xD6E8FEB86659FD93)) & M
            h = x ^ y
            for sh, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
                h = ((h ^ (h >> np.uint64(sh))) * np.uint64(mul)) & M
            h ^= h >> np.uint64(31)
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        cum, cats = DEC._category_table(module.max_simultaneous_rows,
                                        module.supports_n2n)
        idx = np.searchsorted(cum, u)
        for i, cat in enumerate(cats):
            fs, ls = np.nonzero(idx == i)
            pairs.setdefault(cat, []).extend(
                zip(fs.tolist(), ls.tolist(), strict=True))
        self._pairs = {k: np.asarray(v, dtype=np.int64)
                       for k, v in pairs.items()}

    def pairs(self, n_rf: int, n_rl: int) -> np.ndarray:
        """(P, 2) array of (R_F, R_L) rows realizing n_rf:n_rl activation."""
        return self._pairs.get((n_rf, n_rl), np.zeros((0, 2), dtype=np.int64))

    def choose(self, n_rf: int, n_rl: int, k: int = 0) -> tuple[int, int]:
        ps = self.pairs(n_rf, n_rl)
        if len(ps) == 0:
            raise CapabilityError(
                f"module {self.module.name} has no {n_rf}:{n_rl} pairs")
        rf, rl = ps[k % len(ps)]
        return int(rf), int(rl)


class CapabilityError(RuntimeError):
    """The module cannot express the requested activation/op."""


@lru_cache(maxsize=16)
def _inventory(module_name: str, seed: int) -> PairInventory:
    return PairInventory(get_module(module_name), seed=seed)


def inventory_for(module: ModuleConfig, seed: int = 0) -> PairInventory:
    return _inventory(module.name, seed)


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------
@dataclass
class OpCost:
    time_ns: float = 0.0
    energy_pj: float = 0.0
    commands: int = 0
    bus_bytes: int = 0           # data moved over the DDR bus (PuD avoids it)

    def __add__(self, o: "OpCost") -> "OpCost":
        return OpCost(self.time_ns + o.time_ns, self.energy_pj + o.energy_pj,
                      self.commands + o.commands, self.bus_bytes + o.bus_bytes)

    def scaled(self, k: float) -> "OpCost":
        return OpCost(self.time_ns * k, self.energy_pj * k,
                      int(self.commands * k), int(self.bus_bytes * k))


class CostModel:
    """DDR4 command-sequence costs of logical PuD ops (per bank).

    All in-DRAM ops are row-granular: one op processes ``shared_w`` bits
    (half a row per chip; x8 chips in lock-step process 8x that per rank).
    The command-log twins (``log_*``) of the reference come with the
    compiler's execution half.
    """

    def __init__(self, module: ModuleConfig | None = None, *,
                 row_bits: int | None = None):
        self.module = module or get_module()
        self.t = timings_for(self.module)
        #: geometry override for sims built with a non-default row width
        #: (``BankSim(row_bits=...)``); None = the module's native row
        self.row_bits = row_bits or self.module.geometry.row_bits

    def _apa(self, n_rows: int, first_restored: bool) -> OpCost:
        t = self.t
        t_first = t.tRAS if first_restored else VIOLATED_TRAS_NS
        return OpCost(t_first + VIOLATED_TRP_NS + t.tRAS + t.tRP,
                      n_rows * ENERGY_PJ["act"] + 2 * ENERGY_PJ["pre"], 3, 0)

    def rowclone(self) -> OpCost:
        t = self.t
        return OpCost(t.tRAS + VIOLATED_TRP_NS + t.tRAS + t.tRP,
                      2 * ENERGY_PJ["act"] + 2 * ENERGY_PJ["pre"], 3, 0)

    def frac(self) -> OpCost:
        t = self.t
        return OpCost(2 * (VIOLATED_TRAS_NS + t.tRP),
                      2 * (ENERGY_PJ["act"] + ENERGY_PJ["pre"]), 4, 0)

    def write_row(self) -> OpCost:
        t = self.t
        bts = self.row_bits // 8
        n_bursts = max(bts // 64, 1)
        return OpCost(t.tRCD + t.tWR + t.tRP + n_bursts * 4 * t.tCK,
                      ENERGY_PJ["act"] + ENERGY_PJ["pre"]
                      + n_bursts * (ENERGY_PJ["wr_per_64B"] + ENERGY_PJ["io_per_64B"]),
                      2 + n_bursts, bts)

    def read_row(self) -> OpCost:
        t = self.t
        bts = self.row_bits // 8
        n_bursts = max(bts // 64, 1)
        return OpCost(t.tRCD + t.tCL + t.tRP + n_bursts * 4 * t.tCK,
                      ENERGY_PJ["act"] + ENERGY_PJ["pre"]
                      + n_bursts * (ENERGY_PJ["rd_per_64B"] + ENERGY_PJ["io_per_64B"]),
                      2 + n_bursts, bts)

    def boolean(self, n: int, *, staged: bool = True,
                ref_cached: bool = True) -> OpCost:
        """N-input AND/OR/NAND/NOR.

        staged: operands already reside in the compute block (the compiler
        RowClones them in; counted separately).  ref_cached: the N-1 constant
        reference rows persist across ops; only the Frac row is refreshed.
        """
        c = self._apa(2 * n, first_restored=False)
        c = c + self.frac()                      # Frac re-store each op
        if not ref_cached:
            c = c + self.write_row().scaled(n - 1)
        if not staged:
            c = c + self.rowclone().scaled(n)
        return c

    def op_not(self, n_dst: int = 1) -> OpCost:
        return self._apa(1 + n_dst, first_restored=True)

    def cpu_baseline(self, n: int, rows: int = 1) -> OpCost:
        """Processor-centric baseline: read N operand rows over the bus,
        compute on CPU, write one result row back."""
        c = self.read_row().scaled(n * rows) + self.write_row().scaled(rows)
        bts = self.row_bits // 8
        c.energy_pj += n * rows * (bts / 64.0) * ENERGY_PJ["cpu_op_per_64B"]
        return c


# ---------------------------------------------------------------------------
# The ISA executor
# ---------------------------------------------------------------------------
@dataclass
class IsaStats:
    ops: int = 0
    apas: int = 0
    rowclones: int = 0
    fracs: int = 0
    writes: int = 0
    reads: int = 0
    cost: OpCost = field(default_factory=OpCost)


class PudIsa:
    """Executes logical PuD instructions on one subarray pair of a BankSim.

    Convention: R_F side = ``f_sub`` (reference rows for Boolean ops, source
    row for NOT); R_L side = ``l_sub = f_sub + 1`` (compute rows / NOT
    destinations).  Logical words are ``shared_w`` bits.
    """

    def __init__(self, sim: BankSim, *, f_sub: int = 0,
                 l_sub: int | None = None, bank: int = 0):
        self.sim = sim
        #: which bank of a multi-bank array this ISA's subarray pair is in
        self.bank = bank
        self.f_sub = f_sub
        self.l_sub = f_sub + 1 if l_sub is None else l_sub
        if abs(self.f_sub - self.l_sub) != 1:
            raise ValueError("PudIsa needs neighboring subarrays")
        self.inv = inventory_for(sim.module, sim.seed)
        self.cost_model = CostModel(sim.module, row_bits=sim.geom.row_bits)
        self.stats = IsaStats()
        lo = min(self.f_sub, self.l_sub)
        j = np.arange(sim.shared_w)
        f_cols = 2 * j + 1 if self.f_sub == lo else 2 * j
        l_cols = 2 * j + 1 if self.l_sub == lo else 2 * j
        self._f_cols = torch.from_numpy(f_cols).to(sim.device)
        self._l_cols = torch.from_numpy(l_cols).to(sim.device)
        # the same column sets as contiguous storage-layout slices
        _lo, self._f_sl, self._l_sl = sim._col_slices(self.f_sub, self.l_sub)
        self._pair_cursor: dict[tuple[int, int], int] = {}

    # ---------------- word packing ----------------
    @property
    def width(self) -> int:
        return self.sim.shared_w

    @property
    def trials(self) -> int | None:
        """Trial-batch size of the underlying sim (None = scalar API)."""
        return self.sim.trials

    def _pack(self, bits, side: str) -> torch.Tensor:
        """Word -> full row; ``bits`` is (w,) or (T, w) and the packed row
        keeps any leading trial axis."""
        cols = self._f_cols if side == "f" else self._l_cols
        bits = self.sim.as_tensor(bits)
        row = torch.zeros((*bits.shape[:-1], self.sim.geom.row_bits),
                          dtype=torch.float32, device=self.sim.device)
        row[..., cols] = bits
        return row

    def _stack_words(self, words) -> torch.Tensor:
        """Stack operand words along a row axis: (n, w), or (T, n, w) when
        any word carries a trial axis (others broadcast).  An array of shape
        (n, w) or (n, T, w) is taken as a whole (a view, no copy)."""
        if isinstance(words, (np.ndarray, torch.Tensor)):
            words = self.sim.as_tensor(words, torch.uint8)
            return words.movedim(0, -2) if words.dim() == 3 else words
        words = [self.sim.as_tensor(w, torch.uint8) for w in words]
        if any(w.dim() == 2 for w in words):
            t = max(w.shape[0] for w in words if w.dim() == 2)
            words = [w.expand(t, w.shape[-1]) for w in words]
        return torch.stack(words, dim=-2)

    def _unpack(self, sub: int, row: int, side: str) -> torch.Tensor:
        cols = self._f_cols if side == "f" else self._l_cols
        full = self.sim.read_row(sub, row)
        self.stats.reads += 1
        self.stats.cost = self.stats.cost + self.cost_model.read_row()
        return full[..., cols]

    def _result_word(self, sub: int, row: int, side: str) -> torch.Tensor:
        """Digital result word of one physical row: (w,), or (T, w) batched
        (a host readout, an RD over the bus)."""
        sl = self._f_sl if side == "f" else self._l_sl
        self.stats.reads += 1
        self.stats.cost = self.stats.cost + self.cost_model.read_row()
        return self.sim.read_shared_word(sub, row, sl)

    def read_result_word(self, sub: int, row: int) -> torch.Tensor:
        """Public result readout for row handles."""
        side = "f" if sub == self.f_sub else "l"
        return self._result_word(sub, row, side)

    def clone_word(self, sub: int, src: int, dst: int) -> None:
        """In-bank RowClone of one row (no bus traffic, 2 ACTs); a no-op
        when src == dst."""
        if src == dst:
            return
        self.sim.rowclone(sub, src, dst)
        self.stats.rowclones += 1
        self.stats.cost = self.stats.cost + self.cost_model.rowclone()

    def fill_const_row(self, sub: int, row: int, value: int) -> None:
        """Host-write one all-``value`` row."""
        cols = self._f_sl if sub == self.f_sub else self._l_sl
        self.sim.fill_rows(sub, [row], float(value), cols=cols)
        self.stats.writes += 1
        self.stats.cost = self.stats.cost + self.cost_model.write_row()

    def stage_word(self, sub: int, row: int, bits) -> None:
        """Host-write one word into one row."""
        cols = self._f_sl if sub == self.f_sub else self._l_sl
        self.sim.write_cols_multi(sub, [row], cols,
                                  self.sim.as_tensor(bits)[..., None, :])
        self.stats.writes += 1
        self.stats.cost = self.stats.cost + self.cost_model.write_row()

    def write_word(self, sub: int, row: int, bits) -> None:
        side = "f" if sub == self.f_sub else "l"
        self.sim.write_row(sub, row, self._pack(bits, side))
        self.stats.writes += 1
        self.stats.cost = self.stats.cost + self.cost_model.write_row()

    def read_word(self, sub: int, row: int) -> torch.Tensor:
        side = "f" if sub == self.f_sub else "l"
        return self._unpack(sub, row, side)

    # ---------------- pair selection ----------------
    def _next_pair(self, n_rf: int, n_rl: int) -> tuple[int, int]:
        """Deterministic but scrambled pair iteration over the subarray
        (the paper's row-sweeping protocol)."""
        key = (n_rf, n_rl)
        k = self._pair_cursor.get(key, 0)
        self._pair_cursor[key] = k + 1
        n_pairs = max(len(self.inv.pairs(n_rf, n_rl)), 1)
        scrambled = DEC._mix64(k * 0x9E3779B97F4A7C15 + self.sim.seed)
        return self.inv.choose(n_rf, n_rl, scrambled % n_pairs)

    # ---------------- logical ops ----------------
    def not_activation(self, n_dst: int) -> int:
        """R_F-side row count for a NOT with ``n_dst`` destinations: the
        smallest available (least drive load, Obs. 5)."""
        for n_rf in (max(n_dst // 2, 1), n_dst):
            if len(self.inv.pairs(n_rf, n_dst)):
                return n_rf
        raise CapabilityError(f"no activation with {n_dst} dst rows")

    def plan_not(self, n_dst: int = 1, *, pair_index: int | None = None,
                 pair: tuple[int, int] | None = None):
        """Pair selection for a NOT: -> (rf, rl, activation)."""
        n_rf = self.not_activation(n_dst)
        if pair is not None:
            rf, rl = pair
        elif pair_index is not None:
            rf, rl = self.inv.choose(n_rf, n_dst, pair_index)
        else:
            rf, rl = self._next_pair(n_rf, n_dst)
        act = DEC.activation_pattern(self.sim.module, rf, rl,
                                     seed=self.sim.seed)
        if act.n_rf == 0 and pair is None and pair_index is None:
            # sequential-activation modules (Samsung) miss on ~2/3 of the
            # address pairs the inventory lists: sweep on, like the paper
            for _ in range(63):
                rf, rl = self._next_pair(n_rf, n_dst)
                act = DEC.activation_pattern(self.sim.module, rf, rl,
                                             seed=self.sim.seed)
                if act.n_rf:
                    break
        if act.n_rf == 0:
            raise CapabilityError(
                f"address pair ({rf}, {rl}) yields no simultaneous "
                f"activation on {self.sim.module.name}")
        return rf, rl, act

    def exec_not(self, rf: int, rl: int, act: DEC.Activation,
                 source) -> tuple[int, int]:
        """NOT with an explicit source: ``("write", bits)`` host-stages the
        word into every activated R_F row; ``("clone", f_row)`` RowClones a
        resident R_F-side row.  Returns the (result l-row, restored-source
        f-row) handles."""
        kind, payload = source
        if kind == "clone":
            for r in act.rows_f:
                self.clone_word(self.f_sub, int(payload), int(r))
        else:
            self.sim.write_cols_multi(
                self.f_sub, act.rows_f, self._f_sl,
                self.sim.as_tensor(payload)[..., None, :])
            self.stats.writes += act.n_rf
            self.stats.cost = self.stats.cost \
                + self.cost_model.write_row().scaled(act.n_rf)
        self.sim.apa(self.sim.global_addr(self.f_sub, rf),
                     self.sim.global_addr(self.l_sub, rl),
                     first_act_restored=True)
        self.stats.apas += 1
        self.stats.ops += 1
        self.stats.cost = self.stats.cost + self.cost_model.op_not(act.n_rl)
        return int(act.rows_l[0]), int(act.rows_f[0])

    def op_not(self, bits, *, n_dst: int = 1,
               pair_index: int | None = None,
               pair: tuple[int, int] | None = None) -> torch.Tensor:
        """In-DRAM NOT: the (noisy) complement of ``bits`` ((w,) or, on a
        batched sim, (T, w)).  ``pair`` pins the (R_F, R_L) rows,
        ``pair_index`` picks from the inventory, default walks scrambled."""
        rf, rl, act = self.plan_not(n_dst, pair_index=pair_index, pair=pair)
        res_row, _src_row = self.exec_not(rf, rl, act, ("write", bits))
        return self._result_word(self.l_sub, res_row, "l")

    def plan_nary(self, op: str, n: int, *, pair_index: int | None = None,
                  pair: tuple[int, int] | None = None):
        """Capability checks + pair selection for an n-ary Boolean op ->
        (n_hw, rf, rl, activation); ``n_hw >= n`` is the power-of-two
        hardware fan-in the caller pads up to."""
        op = op.lower()
        if op not in ALL_OPS:
            raise ValueError(f"unknown op {op}")
        if n < 2:
            raise ValueError("n-ary op needs >= 2 operands")
        if n > self.sim.module.max_inputs:
            raise CapabilityError(
                f"{n}-input ops exceed module capability "
                f"({self.sim.module.max_inputs})")
        n_hw = n
        while n_hw <= 16 and len(self.inv.pairs(n_hw, n_hw)) == 0:
            n_hw += n_hw % 2 or 1   # next even, then doubles via pairs check
        if len(self.inv.pairs(n_hw, n_hw)) == 0:
            raise CapabilityError(f"no >= {n}:{n} pairs on this module")
        if pair is not None:
            rf, rl = pair
        elif pair_index is not None:
            rf, rl = self.inv.choose(n_hw, n_hw, pair_index)
        else:
            rf, rl = self._next_pair(n_hw, n_hw)
        act = DEC.activation_pattern(self.sim.module, rf, rl,
                                     seed=self.sim.seed)
        if act.n_rf != n_hw or act.n_rl != n_hw:
            raise CapabilityError(f"pair ({rf}, {rl}) activates "
                                  f"{act.n_rf}:{act.n_rl}, not {n_hw}:{n_hw}")
        return n_hw, rf, rl, act

    def exec_nary(self, op: str, rf: int, rl: int, act: DEC.Activation,
                  sources, *, ref_row: int | None = None,
                  random_pattern: bool = True) -> tuple[int, int]:
        """N-ary Boolean APA with per-operand staging sources.

        ``sources`` is one ``("write", bits)`` / ``("clone", l_row)`` entry
        per activated compute row, or ``("write_stack", operands)`` to stage
        the whole compute block in one strided scatter.  The reference block
        is host-filled when ``ref_row`` is None, else RowCloned from that
        resident constant row.  Returns (compute l-row, reference f-row):
        the l row holds the AND/OR result, the f row its complement."""
        n = act.n_rf
        base, _is_ref = _base_op(op.lower())
        # reference block: N-1 constants + one Frac row (§6.1.2)
        if ref_row is None:
            const = 1.0 if base == "and" else 0.0
            self.sim.fill_rows(self.f_sub, act.rows_f[:-1], const,
                               cols=self._f_sl)
            self.stats.writes += n - 1
            self.stats.cost = self.stats.cost \
                + self.cost_model.write_row().scaled(n - 1)
        else:
            for r in act.rows_f[:-1]:
                self.clone_word(self.f_sub, int(ref_row), int(r))
        self.sim.frac_row(self.f_sub, act.rows_f[-1])
        self.stats.fracs += 1
        # compute block: clones in place, host words in one strided scatter
        if isinstance(sources, tuple) and sources[0] == "write_stack":
            stack = self._stack_words(sources[1])
            n_wr = stack.shape[-2]
            self.sim.write_cols_multi(self.l_sub, act.rows_l[:n_wr],
                                      self._l_sl, stack)
            self.stats.writes += n_wr
        else:
            wr_rows, wr_bits = [], []
            for i, (kind, payload) in enumerate(sources):
                if kind == "clone":
                    self.clone_word(self.l_sub, int(payload),
                                    int(act.rows_l[i]))
                else:
                    wr_rows.append(int(act.rows_l[i]))
                    wr_bits.append(payload)
            if wr_rows:
                self.sim.write_cols_multi(self.l_sub, wr_rows, self._l_sl,
                                          self._stack_words(wr_bits))
                self.stats.writes += len(wr_rows)
            n_wr = len(wr_rows)
        self.sim.op_boolean(op, self.sim.global_addr(self.f_sub, rf),
                            self.sim.global_addr(self.l_sub, rl),
                            random_pattern=random_pattern)
        self.stats.apas += 1
        self.stats.ops += 1
        self.stats.cost = self.stats.cost + self.cost_model.boolean(n) \
            + self.cost_model.write_row().scaled(n_wr)
        return int(act.rows_l[0]), int(act.rows_f[0])

    def nary_op(self, op: str, operands, *,
                pair_index: int | None = None,
                pair: tuple[int, int] | None = None,
                random_pattern: bool = True) -> torch.Tensor:
        """Many-input AND/OR/NAND/NOR over equal-width operand words.

        ``operands`` is a list of (w,) / (T, w) words, or one (n, w) /
        (n, T, w) array or tensor; the result carries the trial axis of the
        operands.  Fan-ins the decoder cannot express are padded with
        identity operands (all-1 rows for AND, all-0 for OR) up to the next
        supported N."""
        n = len(operands)
        n_hw, rf, rl, act = self.plan_nary(op, n, pair_index=pair_index,
                                           pair=pair)
        base, is_ref = _base_op(op.lower())
        if n_hw != n:
            ident = torch.full((self.width,), 1 if base == "and" else 0,
                               dtype=torch.uint8, device=self.sim.device)
            operands = list(operands) + [ident] * (n_hw - n)
        res_l, res_f = self.exec_nary(op, rf, rl, act,
                                      ("write_stack", operands),
                                      random_pattern=random_pattern)
        if is_ref:   # NAND/NOR lands in the reference subarray rows
            return self._result_word(self.f_sub, res_f, "f")
        return self._result_word(self.l_sub, res_l, "l")

    # composite ops (functional completeness in action) ------------------
    def op_xor(self, a, b) -> torch.Tensor:
        """XOR from 4 NANDs: the classic functionally-complete construction."""
        n1 = self.nary_op("nand", [a, b])
        n2 = self.nary_op("nand", [a, n1])
        n3 = self.nary_op("nand", [b, n1])
        return self.nary_op("nand", [n2, n3])

    def op_maj3(self, a, b, c) -> torch.Tensor:
        ab = self.nary_op("and", [a, b])
        a_or_b = self.nary_op("or", [a, b])
        c_ab = self.nary_op("and", [c, a_or_b])
        return self.nary_op("or", [ab, c_ab])
