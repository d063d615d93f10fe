"""Trial-batched DRAM bank simulator with its cell state on the device.

The port of ``repro.core.simulator``: the same command sequences (WR/RD,
RowClone, Frac, the NOT and Boolean APA protocols), the same command log,
the same analog error model.  What moved is where the cells live: each
subarray's slot buffer is a ``(T, slots, row_bits)`` float32 tensor on the
simulator's device, and every Boolean APA resolves through
``repro_torch.kernels.ops.senseamp_gather``, which reads the activated rows
straight out of those buffers (the Hopper kernel on a CUDA device, its plain
twin on the CPU).  The slot map, the decoder, the pair inventory and the
analog scalars stay host-side numpy, as in the reference.

Draws
-----
Every command that needs randomness gets its own generator, keyed
``SeedSequence([noise_seed, 0x7A1A1, k])`` for the k-th such command:

* ``draws="numpy"`` consumes that numpy generator draw for draw exactly as
  the reference does and copies the draws to the device — the parity mode:
  results and command logs equal the reference's;
* ``draws="device"`` (default) seeds a ``torch.Generator`` on the device
  from the same key and draws there — the main path on the card; results
  follow the same distribution, not the same bits.

Scalar mode (``trials=None``) draws float64 noise like the reference; on a
CUDA device the draws are cast to float32 before the kernel, as the
reference's own Pallas path does.  The op context of a Boolean APA (whether
the reference level sits above or below VDD/2) needs one device-to-host
read per APA.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import trace
from ..kernels import ops as kops
from ..kernels.senseamp import round_to
from . import analog as A
from . import decoder as DEC
from .analog import AnalogParams
from .device import (ActivationSupport, DRAMTimings, ModuleConfig,
                     SubarrayGeometry, get_module, timings_for, ENERGY_PJ,
                     VIOLATED_TRAS_NS, VIOLATED_TRP_NS)

# fraction of the Gaussian sigma that is static (per-cell) vs per-trial
STATIC_SPLIT = 0.8

#: spread of the static per-cell variation of the NOT success rate (probit)
NOT_SPREAD = 0.75

#: per-cell flip probability of one same-subarray RowClone (analog model)
ROWCLONE_FAIL_P = 2e-6

#: draw modes (see the module doc)
DRAWS = ("device", "numpy")

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}

#: bytes of one cell of a slot buffer (float32)
CELL_BYTES = 4


def resolve_device(device) -> torch.device:
    """The torch device of an entry point's ``device=``; a CUDA device that
    is not there raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _norm_ppf(q):
    """Acklam's inverse normal CDF approximation (max abs err ~1.15e-9)."""
    q = np.asarray(q, dtype=np.float64)
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    q = np.clip(q, 1e-12, 1 - 1e-12)
    out = np.empty_like(q)
    lo = q < 0.02425
    hi = q > 1 - 0.02425
    mid = ~(lo | hi)
    if np.any(mid):
        x = q[mid] - 0.5
        r = x * x
        out[mid] = ((((((a[0]*r+a[1])*r+a[2])*r+a[3])*r+a[4])*r+a[5])*x /
                    (((((b[0]*r+b[1])*r+b[2])*r+b[3])*r+b[4])*r+1))
    if np.any(lo):
        r = np.sqrt(-2*np.log(q[lo]))
        out[lo] = (((((c[0]*r+c[1])*r+c[2])*r+c[3])*r+c[4])*r+c[5]) / \
                  ((((d[0]*r+d[1])*r+d[2])*r+d[3])*r+1)
    if np.any(hi):
        r = np.sqrt(-2*np.log(1-q[hi]))
        out[hi] = -((((((c[0]*r+c[1])*r+c[2])*r+c[3])*r+c[4])*r+c[5]) /
                    ((((d[0]*r+d[1])*r+d[2])*r+d[3])*r+1))
    return out


class _NumpyDraws:
    """One command's numpy generator (the reference's stream), draws copied
    to the device."""

    def __init__(self, rng: np.random.Generator, device: torch.device):
        self.rng, self.device = rng, device

    def normal(self, shape, dtype: torch.dtype) -> torch.Tensor:
        x = self.rng.standard_normal(shape, dtype=_NP_DTYPE[dtype])
        return trace.to_device(x, self.device)

    def uniform(self, shape, dtype: torch.dtype) -> torch.Tensor:
        x = self.rng.random(shape, dtype=_NP_DTYPE[dtype])
        return trace.to_device(x, self.device)


class _TorchDraws:
    """One command's ``torch.Generator`` on the device."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def normal(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=dtype)

    def uniform(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device,
                          dtype=dtype)


def torch_seed(seq: np.random.SeedSequence) -> int:
    """A 63-bit ``torch.Generator`` seed from a numpy seed sequence."""
    lo, hi = seq.generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & ((1 << 63) - 1)


@dataclass(frozen=True)
class LogEvent:
    """One logical command as recorded by :class:`CommandLog`.

    ``seq`` is a per-log monotonic issue index; ``bank``/``sub`` identify
    the issuing bank and subarray (``sub = -1`` when the command has no
    single home subarray).  ``count`` repeats the command back-to-back."""

    seq: int
    cmd: str
    t_ns: float
    e_pj: float
    count: int
    bank: int
    sub: int


@dataclass
class CommandLog:
    """Per-command time/energy accounting plus the ordered event stream."""

    time_ns: float = 0.0
    energy_pj: float = 0.0
    counts: dict = field(default_factory=dict)
    events: list = field(default_factory=list)

    def add(self, cmd: str, t_ns: float, e_pj: float,
            count: int = 1, *, bank: int = 0, sub: int = -1) -> None:
        self.time_ns += t_ns * count
        self.energy_pj += e_pj * count
        self.counts[cmd] = self.counts.get(cmd, 0) + count
        self.events.append(LogEvent(len(self.events), cmd, t_ns, e_pj,
                                    count, bank, sub))

    def reset(self) -> None:
        self.time_ns = 0.0
        self.energy_pj = 0.0
        self.counts.clear()
        self.events.clear()


class FusedExecutionError(RuntimeError):
    """Per-bank execution diverged where fusion requires lockstep (row-slot
    allocation, draw shape or noise-context sign) — a bug guard, not a
    capability limit: callers gate fusion, they do not catch this."""


class BankSim:
    """One DRAM bank: lazily-allocated subarrays of float32 cell voltages,
    held as ``(T, slots, row_bits)`` tensors on ``device``."""

    #: banks stacked on the trial axis (``FusedBankSim`` holds N)
    n_banks = 1

    def __init__(self, module: ModuleConfig | str | None = None, *,
                 row_bits: int | None = None, seed: int = 0,
                 params: AnalogParams | None = None, temp_c: float = 50.0,
                 error_model: str = "analog", trials: int | None = None,
                 track_unshared: bool = True, noise_seed: int | None = None,
                 rowclone_fail_p: float = ROWCLONE_FAIL_P,
                 bank: int = 0, draws: str = "device",
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if draws not in DRAWS:
            raise ValueError(f"draws must be one of {DRAWS}, got {draws!r}")
        self.draws = draws
        self.module = (get_module(module) if isinstance(module, str)
                       else module or get_module())
        geom = self.module.geometry
        if row_bits is not None:
            geom = SubarrayGeometry(geom.subarrays_per_bank,
                                    geom.rows_per_subarray, row_bits)
        self.geom = geom
        self.timings: DRAMTimings = timings_for(self.module)
        self.params = params or A.DEFAULT_PARAMS
        self.temp_c = temp_c
        if error_model not in ("analog", "mean", "ideal", "none"):
            raise ValueError(f"unknown error model {error_model!r}")
        self.error_model = error_model
        self.seed = seed
        #: bank index stamped on every CommandLog event
        self.bank = int(bank)
        #: independent per-trial noise stream (chip identity stays ``seed``)
        self.noise_seed = seed if noise_seed is None else int(noise_seed)
        self.rowclone_fail_p = float(rowclone_fail_p)
        if trials is not None and trials < 1:
            raise ValueError(f"trials must be >= 1, got {trials}")
        #: None = scalar API (rows are 1-D); int T = batched trials
        self.trials = trials
        self._T = 1 if trials is None else int(trials)
        # float32 noise batched, float64 in scalar mode (as the reference)
        self._noise_dtype = torch.float64 if trials is None \
            else torch.float32
        #: False skips the MAJ restore of non-shared columns after an APA
        #: (word-level results follow the same distribution; the batched MC
        #: runs this way)
        self.track_unshared = track_unshared
        self._subarrays: dict[int, torch.Tensor] = {}
        self._rowmap: dict[int, np.ndarray] = {}
        self._nrows: dict[int, int] = {}
        self._static: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        #: analog inputs of the comparator and NOT planes, by op context
        self._param_memo: dict = {}
        self._not_memo: dict = {}
        self._trial = 0
        # stripe-major column layout: storage position j < w holds physical
        # column 2j+1, position w+j holds column 2j
        rb = self.geom.row_bits
        self._perm = np.concatenate([np.arange(rb)[1::2],
                                     np.arange(rb)[0::2]])
        self._invperm = np.empty(rb, dtype=np.int64)
        self._invperm[self._perm] = np.arange(rb)
        self._perm_t = trace.to_device(self._perm, self.device)
        self._invperm_t = trace.to_device(self._invperm, self.device)
        self.log = CommandLog()

    # ---------------- geometry helpers ----------------
    @property
    def shared_w(self) -> int:
        return self.geom.row_bits // 2

    @property
    def batched(self) -> bool:
        return self.trials is not None

    def as_tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        """Host or device data as a ``dtype`` tensor on this bank's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return trace.to_device(x, self.device).to(dtype)

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return trace.to_device(np.asarray(idx, dtype=np.int64), self.device)

    def _scattered(self, n_rows: int, n_cols: int) -> None:
        """Count ``n_rows`` rows of ``n_cols`` cells written into a slot
        buffer by row index, in every trial (``scatter_bytes``)."""
        trace.count("scatter_bytes", CELL_BYTES * self._T * n_rows * n_cols)

    # ---------------- compact row-remapped cell storage ----------------
    def _map_rows(self, sub: int, rows) -> np.ndarray:
        """Slot indices of physical rows, allocating slots on first touch."""
        if not 0 <= sub < self.geom.subarrays_per_bank:
            raise IndexError(f"subarray {sub} out of range")
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        if rows.size and (rows.min() < 0
                          or rows.max() >= self.geom.rows_per_subarray):
            raise IndexError(f"row out of range in {rows}")
        rmap = self._rowmap.get(sub)
        if rmap is None:
            rmap = self._rowmap[sub] = np.full(
                self.geom.rows_per_subarray, -1, dtype=np.int64)
            self._nrows[sub] = 0
        idx = rmap[rows]
        fresh = idx < 0
        if np.any(fresh):
            new_rows = rows[fresh]
            start = self._nrows[sub]
            rmap[new_rows] = np.arange(start, start + new_rows.size)
            self._nrows[sub] = start + new_rows.size
            buf = self._subarrays.get(sub)
            cap = 0 if buf is None else buf.shape[1]
            if self._nrows[sub] > cap:
                new_cap = min(max(16, 2 * cap, self._nrows[sub]),
                              self.geom.rows_per_subarray)
                new_buf = torch.zeros((self._T, new_cap, self.geom.row_bits),
                                      dtype=torch.float32, device=self.device)
                if buf is not None:
                    new_buf[:, :cap] = buf
                self._subarrays[sub] = new_buf
            idx = rmap[rows]
        return idx

    def _row(self, sub: int, row: int) -> int:
        return int(self._map_rows(sub, row)[0])

    def recycle_rows(self) -> None:
        """Forget all row-slot assignments; slot buffers are kept and reused
        (contents become don't-care)."""
        for sub, rmap in self._rowmap.items():
            rmap.fill(-1)
            self._nrows[sub] = 0

    def _cells(self, sub: int) -> torch.Tensor:
        """(T, slots, row_bits) backing buffer (slot order = first touch)."""
        if sub not in self._subarrays:
            self._map_rows(sub, [0])    # force allocation
        return self._subarrays[sub]

    def _arr(self, sub: int) -> torch.Tensor:
        """Cell voltages in physical row order: (rows, row_bits) in scalar
        mode, (T, rows, row_bits) batched (a materialized snapshot)."""
        out = torch.zeros((self._T, self.geom.rows_per_subarray,
                           self.geom.row_bits), dtype=torch.float32,
                          device=self.device)
        rmap = self._rowmap.get(sub)
        if rmap is not None:
            live = np.nonzero(rmap >= 0)[0]
            out[:, self._index(live)] = \
                self._subarrays[sub][:, self._index(rmap[live])][
                    ..., self._invperm_t]
        return out if self.batched else out[0]

    def _out(self, rows: torch.Tensor) -> torch.Tensor:
        """Strip the trial axis in scalar mode."""
        return rows if self.batched else rows[0]

    def _static_latents(self, stripe: int) -> tuple[np.ndarray, np.ndarray]:
        """Two per-SA uniforms for the static offset mixture of a stripe."""
        if stripe not in self._static:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 0xC0FFEE, stripe]))
            self._static[stripe] = (rng.random(self.shared_w),
                                    rng.random(self.shared_w))
        return self._static[stripe]

    def _rng(self):
        """The next command's draws (numpy stream or device generator)."""
        self._trial += 1
        seq = np.random.SeedSequence([self.noise_seed, 0x7A1A1, self._trial])
        if self.draws == "numpy":
            return _NumpyDraws(np.random.default_rng(seq), self.device)
        return _TorchDraws(torch_seed(seq), self.device)

    def reseed_noise(self, noise_seed: int) -> None:
        """Point subsequent per-command draws at an independent stream (chip
        identity stays tied to ``seed``; the command counter restarts)."""
        self.noise_seed = int(noise_seed)
        self._trial = 0

    def static_offsets(self, stripe: int, op: str, n: int, *,
                       random_pattern: bool = True,
                       speed_mts: int | None = None) -> np.ndarray:
        """Per-SA static offset [V] under an op context (host numpy)."""
        xi1, xi2 = self._static_latents(stripe)
        s, b, wp, wm = A.op_noise(
            op, n, self.params, temp_c=self.temp_c,
            random_pattern=random_pattern,
            speed_mts=speed_mts or self.module.speed_mts,
            mfr=self.module.manufacturer.value,
            density_gb=self.module.density_gb, die_rev=self.module.die_rev)
        comp = np.where(xi1 < wm, -1.0, np.where(xi1 > 1.0 - wp, 1.0, 0.0))
        return comp * b + STATIC_SPLIT * s * _norm_ppf(xi2)

    # ---------------- standard commands ----------------
    def _log_wr(self, n_rows: int = 1, sub: int = -1) -> None:
        t = self.timings
        n_bursts = self.geom.row_bits // 512  # 64B bursts per chip-row
        self.log.add("WR", t.tRCD + t.tWR + t.tRP,
                     ENERGY_PJ["act"] + ENERGY_PJ["pre"]
                     + n_bursts * ENERGY_PJ["wr_per_64B"], count=n_rows,
                     bank=self.bank, sub=sub)

    def _log_rd(self, sub: int) -> None:
        t = self.timings
        n_bursts = self.geom.row_bits // 512
        self.log.add("RD", t.tRCD + t.tCL + t.tRP,
                     ENERGY_PJ["act"] + ENERGY_PJ["pre"]
                     + n_bursts * ENERGY_PJ["rd_per_64B"],
                     bank=self.bank, sub=sub)

    def write_row(self, sub: int, row: int, bits) -> None:
        """Write a row; ``bits`` is (row_bits,) — broadcast to all trials —
        or (T, row_bits) for per-trial contents in batched mode."""
        bits = self.as_tensor(bits)
        w = self.geom.row_bits
        if tuple(bits.shape) not in ((w,), (self._T, w)):
            raise ValueError(
                f"row is {w} bits (optionally with a leading {self._T}-trial "
                f"axis), got {tuple(bits.shape)}")
        i = self._row(sub, row)
        self._cells(sub)[:, i] = bits[..., self._perm_t]
        self._scattered(1, w)
        self._log_wr(sub=sub)

    def write_cols_multi(self, sub: int, rows, cols: slice, bits) -> None:
        """WR of one word per row in one strided scatter: ``bits`` is
        (n_rows, w) or (T, n_rows, w); slice k lands on ``cols`` of row k."""
        idx = self._index(self._map_rows(sub, rows))
        arr = self._cells(sub)
        if self.track_unshared:
            arr[:, idx] = 0.0
            self._scattered(len(idx), self.geom.row_bits)
        arr[:, idx, cols] = self.as_tensor(bits)
        self._scattered(len(idx), cols.stop - cols.start)
        self._log_wr(len(idx), sub=sub)

    def fill_rows(self, sub: int, rows, value: float, cols=None) -> None:
        """WR of constant rows (reference-block staging).  With
        ``track_unshared=False`` callers may restrict to the observed
        columns (``cols=None`` fills the whole row)."""
        idx = self._index(self._map_rows(sub, rows))
        if not self.track_unshared and cols is not None:
            self._cells(sub)[:, idx, cols] = value
            self._scattered(len(idx), cols.stop - cols.start)
        else:
            self._cells(sub)[:, idx] = value
            self._scattered(len(idx), self.geom.row_bits)
        self._log_wr(len(idx), sub=sub)

    def read_row(self, sub: int, row: int) -> torch.Tensor:
        i = self._row(sub, row)
        arr = self._cells(sub)
        self._log_rd(sub)
        return self._out((arr[:, i][..., self._invperm_t] > 0.5)
                         .to(torch.uint8))

    def frac_row(self, sub: int, row: int) -> None:
        """FracDRAM: store VDD/2 in every cell of the row."""
        # map first: a first touch can grow (reallocate) the slot buffer
        i = self._row(sub, row)
        self._cells(sub)[:, i] = 0.5
        self._scattered(1, self.geom.row_bits)
        t = self.timings
        self.log.add("FRAC", 2 * (VIOLATED_TRAS_NS + t.tRP),
                     2 * (ENERGY_PJ["act"] + ENERGY_PJ["pre"]),
                     bank=self.bank, sub=sub)

    def rowclone(self, sub: int, src: int, dst: int) -> None:
        """Same-subarray RowClone (sequential ACT -> PRE -> ACT); under the
        analog model each destination cell flips with ``rowclone_fail_p``."""
        isrc, idst = (int(i) for i in self._map_rows(sub, [src, dst]))
        self._clone_slots(sub, isrc, idst)

    def _clone_slots(self, sub: int, isrc: int, idst: int) -> None:
        """RowClone between two slots (the body of :meth:`rowclone`)."""
        arr = self._cells(sub)
        restored = (arr[:, isrc] > 0.5).to(torch.float32)
        copied = restored
        if self.error_model == "analog" and self.rowclone_fail_p > 0.0:
            dt = self._noise_dtype
            u = self._rng().uniform(tuple(restored.shape), dt)
            flip = u < round_to(self.rowclone_fail_p, dt)
            copied = torch.where(flip, 1.0 - restored, restored)
        arr[:, idst] = copied
        arr[:, isrc] = restored  # source restored
        self._scattered(2, self.geom.row_bits)
        t = self.timings
        self.log.add("RC", t.tRAS + VIOLATED_TRP_NS + t.tRAS + t.tRP,
                     2 * ENERGY_PJ["act"] + 2 * ENERGY_PJ["pre"],
                     bank=self.bank, sub=sub)

    # ---------------- APA: simultaneous multi-row activation ----------------
    def _col_slices(self, f_sub: int, l_sub: int):
        """-> (stripe id, f-side slice, l-side slice): the shared columns as
        contiguous storage-layout slices, in j order."""
        if abs(f_sub - l_sub) != 1:
            raise ValueError("APA requires *neighboring* subarrays")
        lo = min(f_sub, l_sub)
        w = self.shared_w
        lo_sl, hi_sl = slice(0, w), slice(w, 2 * w)
        return (lo, lo_sl if f_sub == lo else hi_sl,
                lo_sl if l_sub == lo else hi_sl)

    def _other_slice(self, sl: slice) -> slice:
        """The complementary column half (non-shared, storage layout)."""
        w = self.shared_w
        return slice(w, 2 * w) if sl.start == 0 else slice(0, w)

    @staticmethod
    def _row_sum(arr: torch.Tensor, rows, cols: slice) -> torch.Tensor:
        """Σ over activated rows in row order (the numpy reference's order)
        -> (T, w) float32."""
        acc = arr[:, int(rows[0]), cols]
        for r in rows[1:]:
            acc = acc + arr[:, int(r), cols]
        return acc

    def _activation(self, rf_global, rl_global):
        """Decode one APA's addresses -> (f_sub, l_sub, R_F rows, R_L rows,
        activation): the rows are ``(N,)`` in-subarray addresses, one per
        bank, and the activation is this bank's decoder pattern."""
        rps = self.geom.rows_per_subarray
        f_sub, f_row = divmod(rf_global, rps)
        l_sub, l_row = divmod(rl_global, rps)
        act = DEC.activation_pattern(self.module, f_row, l_row, seed=self.seed)
        return f_sub, l_sub, np.array([f_row]), np.array([l_row]), act

    def _resolve_params(self, stripe: int, op: str, n: int, *,
                        regions: tuple, random_pattern: bool):
        """Analog inputs of one comparator resolve -> (trial sigma, static
        offsets on the device, floor pf, threshold).  The threshold
        ``-(dv - shift - delta_v)`` is a float on one bank; on N banks it is
        an ``(N,)`` tensor, each bank's rounded as its own episode rounds
        it, beside an ``(N, w)`` static plane.  Memoised per sim, so per
        bank seed: every input is a pure function of the chip's identity
        (seeds, module, params, temperature, fixed at construction) and the
        op context (stripe, op, n, pattern, ``(N,)`` regions)."""
        reg_c, reg_r = (tuple(int(r) for r in rs) for rs in regions)
        key = (stripe, op, n, random_pattern, reg_c, reg_r)
        hit = self._param_memo.get(key)
        if hit is not None:
            return hit
        p, m = self.params, self.module
        s, _b, _wp, _wm = A.op_noise(
            op, n, p, temp_c=self.temp_c, random_pattern=random_pattern,
            speed_mts=m.speed_mts, mfr=m.manufacturer.value,
            density_gb=m.density_gb, die_rev=m.die_rev)
        shift = A.op_shift(op, n, p)
        thr = [-(A.margin_offset(op, p, compute_region=c, ref_region=r,
                                 mfr=m.manufacturer.value,
                                 density_gb=m.density_gb, die_rev=m.die_rev)
                 - shift - p.delta_v) for c, r in zip(reg_c, reg_r)]
        # the kernel is float32 on CUDA (the reference's Pallas path casts
        # scalar mode's float64 too)
        kdt = torch.float32 if self.device.type == "cuda" \
            else self._noise_dtype
        static = trace.to_device(
            self.static_offsets(stripe, op, n, random_pattern=random_pattern),
            self.device, kdt)
        if len(thr) == 1:
            thr = thr[0]
        else:
            thr = torch.tensor([round_to(x, kdt) for x in thr], dtype=kdt,
                               device=self.device)
            trace.count("h2d_copies")
        pf = A.op_pfloor(op, n, p, temp_c=self.temp_c,
                         random_pattern=random_pattern,
                         speed_mts=m.speed_mts)
        sigma = math.sqrt(max(1.0 - STATIC_SPLIT ** 2, 0.0)) * s
        hit = self._param_memo[key] = (sigma, static, pf, thr)
        return hit

    def _resolve(self, l_sub: int, rows_l, l_sl: slice, f_sub: int, rows_f,
                 f_sl: slice, stripe: int, op: str, *, regions: tuple,
                 random_pattern: bool, rng) -> torch.Tensor:
        """Sense-amp comparator of the Boolean protocol, every bank in one
        kernel launch -> (N*T, w) uint8.

        Compute side = the R_L rows, reference side = the R_F rows.  Static
        offsets broadcast across a bank's trials (one chip); noise and floor
        draws are per trial: one normal and, batched, one uniform per lane
        (the floor coin is ``u < pf/2`` given ``u < pf``), or in scalar mode
        a flip and a coin uniform — the reference's draws in its order."""
        kw = dict(width=self.shared_w, u_com=A.u_n(len(rows_l), self.params),
                  u_ref=A.u_n(len(rows_f), self.params))
        arr_l, arr_f = self._cells(l_sub), self._cells(f_sub)
        if self.error_model in ("ideal", "none", "mean"):
            return kops.senseamp_gather(arr_l, rows_l, l_sl.start, arr_f,
                                        rows_f, f_sl.start, **kw)
        sigma, static, pf, thr = self._resolve_params(
            stripe, op, len(rows_l), regions=regions,
            random_pattern=random_pattern)
        dt = self._noise_dtype
        shape = (self._T, self.shared_w)
        nz = rng.normal(shape, dt)
        u0 = rng.uniform(shape, dt)
        u1 = None if self.batched else rng.uniform(shape, dt)
        if static.dtype != dt:      # scalar mode on CUDA: float32 kernel
            nz, u0, u1 = (x.to(torch.float32) for x in (nz, u0, u1))
        return kops.senseamp_gather(
            arr_l, rows_l, l_sl.start, arr_f, rows_f, f_sl.start,
            static=static, normals=nz, sigma=sigma, u0=u0, u1=u1, pf=pf,
            thr=thr, bank_trials=self._T // self.n_banks, **kw)

    def _not_plane(self, stripe: int, act, reg_f, reg_l) -> torch.Tensor:
        """(N, w) per-cell NOT success probabilities on the device.

        Static per-cell variation around the mean success rate:
        E[phi(a + s Z)] = phi(a / sqrt(1+s^2)) keeps the cell mean exactly
        equal to the closed-form ``not_success``.  Memoised on the op
        context, as :meth:`_resolve_params` is."""
        key = (stripe, act.n_rl, act.kind, tuple(int(r) for r in reg_f),
               tuple(int(r) for r in reg_l))
        z = self._not_memo.get(key)
        if z is None:
            m = self.module
            p_ok = np.array([A.not_success(
                act.n_rl, pattern=("N2N" if act.kind == "N:2N" else "NN"),
                p=self.params, temp_c=self.temp_c, src_region=src,
                dst_region=dst, speed_mts=m.speed_mts,
                mfr=m.manufacturer.value, density_gb=m.density_gb,
                die_rev=m.die_rev) for src, dst in zip(key[3], key[4])])
            a = _norm_ppf(np.clip(p_ok, 1e-9, 1 - 1e-9)) \
                * math.sqrt(1.0 + NOT_SPREAD ** 2)
            xi1 = np.reshape(self._static_latents(stripe)[0],
                             (self.n_banks, -1))
            z = self._not_memo[key] = trace.to_device(
                A.phi(a[:, None] + NOT_SPREAD * _norm_ppf(xi1)),
                self.device, self._noise_dtype)
        return z

    def _maj_restore(self, sub: int, rows, cols: slice, rng) -> None:
        """Same-subarray multi-row activation on non-shared columns: cells
        charge-share against VDD/2 and the (other-stripe) SA restores the
        majority value into all activated cells."""
        arr = self._cells(sub)
        n = len(rows)
        u = A.u_n(n, self.params)
        v = (self._row_sum(arr, rows, cols) - round_to(0.5 * n, torch.float32)) \
            * round_to(u, torch.float32)
        if self.error_model == "analog":
            dt = self._noise_dtype
            noise = rng.normal(tuple(v.shape), dt) \
                * round_to(self.params.sigma_sa, dt)
            v = v.to(dt) + noise
        out = (v > 0.0).to(torch.float32)
        arr[:, self._index(rows), cols] = out[:, None, :]
        self._scattered(len(rows), cols.stop - cols.start)

    def apa(self, rf_global, rl_global, *, first_act_restored: bool = False,
            random_pattern: bool = True):
        """``ACT R_F -> PRE -> ACT R_L`` with violated timings.

        Global row address = subarray * rows_per_subarray + row.
        ``first_act_restored=True`` models the NOT protocol (§5): R_F is
        fully restored and drives the R_L rows through the shared SAs.
        Otherwise both sides charge-share and the SA compares (§6).

        One body for one bank and for N banks in lockstep: the trial axis
        holds N banks of ``T / N`` trials, bank-major, and the per-bank
        parts (decoder activations, draws, static latents, slot maps) come
        from the hooks a multi-bank subclass overrides.  Returns the
        activation (:class:`repro_torch.core.decoder.Activation` here)."""
        with trace.span("pud.apa.plan"):
            f_sub, l_sub, f_rows, l_rows, act = self._activation(rf_global,
                                                                 rl_global)
            t = self.timings
            t_first = t.tRAS if first_act_restored else VIOLATED_TRAS_NS
            self.log.add("APA", t_first + VIOLATED_TRP_NS + t.tRAS + t.tRP,
                         (act.n_rf + act.n_rl) * ENERGY_PJ["act"]
                         + 2 * ENERGY_PJ["pre"],
                         bank=self.bank, sub=f_sub)
            if act.n_rf == 0:
                return act
            if self.module.activation is ActivationSupport.SEQUENTIAL \
                    and not first_act_restored:
                return act  # sequential activation cannot charge-share
            stripe, f_cols, l_cols = self._col_slices(f_sub, l_sub)
            rows_f = self._map_rows(f_sub, act.rows_f)
            rows_l = self._map_rows(l_sub, act.rows_l)
            arr_f, arr_l = self._cells(f_sub), self._cells(l_sub)
            idx_f, idx_l = self._index(rows_f), self._index(rows_l)
            rng = self._rng()
            geom = self.geom
            reg_f = geom.distance_regions(f_rows, toward_upper=f_sub > l_sub)
            reg_l = geom.distance_regions(l_rows, toward_upper=l_sub > f_sub)
            nb, w = self.n_banks, self.shared_w
            tb = self._T // nb

        if first_act_restored:
            # ---- NOT protocol: R_F drives, R_L receives the complement ----
            with trace.span("pud.apa.resolve"):
                n_src = act.n_rf
                u = A.u_n(n_src, self.params)
                v_src = 0.5 + (self._row_sum(arr_f, rows_f, f_cols)
                               - round_to(0.5 * n_src, torch.float32)) \
                    * round_to(u, torch.float32)
                src_bit = v_src > 0.5                       # (N*T, w)
                if self.error_model == "analog":
                    z = self._not_plane(stripe, act, reg_f, reg_l)  # (N, w)
                    # the draw is a temporary: bound to a name it would
                    # outlive the write-back and raise the memory peak
                    ok = (rng.uniform(tuple(src_bit.shape), self._noise_dtype)
                          .view(nb, tb, w) < z[:, None]).view(src_bit.shape)
                else:
                    ok = torch.ones_like(src_bit)
                dst_bit = torch.where(ok, ~src_bit, src_bit).to(torch.float32)
            with trace.span("pud.apa.writeback"):
                arr_l[:, idx_l, l_cols] = dst_bit[:, None, :]
                arr_f[:, idx_f, f_cols] = src_bit.to(torch.float32)[:, None, :]
                self._scattered(len(idx_l) + len(idx_f), w)
        else:
            # ---- Boolean-op protocol: comparator across the stripe ----
            # noise context: the reference level sets the common mode
            # (V_REF > VDD/2 -> AND-family, < VDD/2 -> OR-family); the sign
            # of mean(v_f) is that of Σcells − n_f/2·T·w, summed per bank in
            # float64 (the reference's float32 mean can differ only where
            # the level is exactly VDD/2) — one reduction over the slot span
            # holding the activated rows (no copy; the ISA allocates them
            # adjacent) and one device-to-host read per APA: a scalar on one
            # bank, an (N,) copy on N.  The sign must agree across banks.
            with trace.span("pud.apa.opctx"):
                lo = int(rows_f.min())
                span = arr_f[:, lo:int(rows_f.max()) + 1, f_cols]
                per_slot = span.reshape(nb, tb, span.shape[1], w).sum(
                    dim=(1, 3), dtype=torch.float64)           # (N, slots)
                total = per_slot[:, self._index(rows_f - lo)].sum(dim=1)
                total = np.array([float(total)]) if nb == 1 \
                    else total.cpu().numpy()
                trace.count("reads.opctx")
                ctx = total - 0.5 * act.n_rf * tb * w >= 0.0
                if not (ctx == ctx[0]).all():
                    raise FusedExecutionError(
                        "reference common-mode sign differs across banks")
                op_ctx = "and" if bool(ctx[0]) else "or"
            with trace.span("pud.apa.resolve"):
                out = self._resolve(l_sub, rows_l, l_cols, f_sub, rows_f,
                                    f_cols, stripe, op_ctx,
                                    regions=(reg_l, reg_f),
                                    random_pattern=random_pattern, rng=rng)
            with trace.span("pud.apa.writeback"):
                outf = out.to(torch.float32)
                arr_l[:, idx_l, l_cols] = outf[:, None, :]
                arr_f[:, idx_f, f_cols] = (1.0 - outf)[:, None, :]
                self._scattered(len(idx_l) + len(idx_f), w)
        # non-shared columns: same-subarray restore (MAJ against VDD/2)
        if self.track_unshared:
            with trace.span("pud.apa.writeback"):
                self._maj_restore(f_sub, rows_f, self._other_slice(f_cols),
                                  rng)
                self._maj_restore(l_sub, rows_l, self._other_slice(l_cols),
                                  rng)
        return act

    def apa_then_write(self, rf_global: int, rl_global: int,
                       pattern) -> DEC.Activation:
        """§4.2 reverse-engineering methodology: APA followed by a WR that
        overdrives the sense amps (Obs. 1 semantics): the exact pattern
        lands in every R_F row and its complement in the shared half of
        every R_L row.  ``pattern`` is a (row_bits,) numpy array or
        tensor."""
        f_sub, l_sub, _f_rows, _l_rows, act = self._activation(rf_global,
                                                               rl_global)
        self.log.add("APA+WR", 30.0, ENERGY_PJ["act"] * (act.n_rf + act.n_rl),
                     bank=self.bank, sub=f_sub)
        if act.n_rf == 0:
            return act
        pattern = self.as_tensor(pattern)[self._perm_t]     # storage order
        # map first: a first touch can grow (reallocate) the slot buffers
        rows_f = self._map_rows(f_sub, act.rows_f)
        rows_l = self._map_rows(l_sub, act.rows_l)
        arr_f, arr_l = self._cells(f_sub), self._cells(l_sub)
        _lo, _f_sl, l_sl = self._col_slices(f_sub, l_sub)
        arr_f[:, self._index(rows_f)] = pattern      # exact pattern (Obs. 1)
        arr_l[:, self._index(rows_l), l_sl] = 1.0 - pattern[l_sl]
        self._scattered(len(rows_f), self.geom.row_bits)
        self._scattered(len(rows_l), self.shared_w)
        return act

    # ---------------- high-level op helpers (ISA entry points) ----------------
    def op_not(self, src_global: int, dst_global: int, *,
               n_dst: int | None = None) -> DEC.Activation:
        """NOT: source row fully restored, then APA into dst's subarray."""
        return self.apa(src_global, dst_global, first_act_restored=True)

    def op_boolean(self, op: str, ref_global: int, com_global: int, *,
                   random_pattern: bool = True) -> DEC.Activation:
        """Many-input AND/OR (+ NAND/NOR on the reference side); the caller
        stages the reference rows (N-1 constants + Frac) and the operands
        (see :mod:`repro_torch.core.isa`)."""
        A._base_op(op)      # validates the op name
        return self.apa(ref_global, com_global, first_act_restored=False,
                        random_pattern=random_pattern)

    # ---------------- convenience ----------------
    def global_addr(self, sub: int, row: int) -> int:
        return sub * self.geom.rows_per_subarray + row

    def read_shared_word(self, sub: int, row: int,
                         sl: slice) -> torch.Tensor:
        """Digital value of one shared-column half of a row, in j order
        ((w,), or (T, w) batched); logged as a full RD."""
        i = self._row(sub, row)
        self._log_rd(sub)
        return self._out((self._cells(sub)[:, i, sl] > 0.5).to(torch.uint8))

    def snapshot_rows(self, sub: int, rows) -> torch.Tensor:
        """(n_rows, row_bits) digital snapshot; (T, n_rows, row_bits)
        batched."""
        idx = self._index(self._map_rows(sub, rows))
        arr = self._cells(sub)
        return self._out((arr[:, idx][..., self._invperm_t] > 0.5)
                         .to(torch.uint8))
