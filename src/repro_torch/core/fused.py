"""Fused bank axis: N independent banks executed as one batched episode.

The port of ``repro.core.fused``.  A :class:`FusedBankSim` over N banks at
T trials per bank runs every command once on one ``(N*T, slots, row_bits)``
float32 cell tensor per subarray on the simulator's device, with per-bank
chip identity and per-bank noise streams carried along the leading axis.
Every fused Boolean APA resolves in one launch of the ``senseamp`` kernel
(:func:`repro_torch.kernels.ops.senseamp_gather`), which takes the per-bank
static offsets as one ``(N, W)`` plane and the per-bank comparator
thresholds as one ``(N,)`` vector; no per-trial plane is built.

Bit-exact parity with the loop path
-----------------------------------
Per bank, results and the command log equal the per-bank loop path
(``fused=False``), and under ``draws="numpy"`` they equal the reference's
fused path:

* *Draws*: each command draws through one generator per bank, keyed
  ``SeedSequence([noise_seed_b, 0x7A1A1, k_b])`` exactly as bank b's own
  ``BankSim._rng``.  Under ``draws="numpy"`` bank b's numpy generator makes
  its ``(T, ...)`` block and the blocks are concatenated bank-major and
  copied to the device once; under ``draws="device"`` bank b's
  ``torch.Generator`` fills rows ``b*T .. (b+1)*T`` of one device buffer.
  Either way slice b is bank b's loop draw bit for bit.
* *Chip identity*: static latents are evaluated per bank seed and stacked
  ``(N, w)``; decoder activations are evaluated per bank seed per APA.
* *Analog scalars*: the margin offset ``dv`` differs per bank (regions and
  die), so each bank's threshold ``-(dv_b - shift - delta_v)`` is rounded to
  float32 as the loop path rounds its own and compared per bank in the
  kernel — the same float arithmetic as the loop, not a folded plane.
* *Row slots*: every fused ISA op recycles row slots on entry, which pins
  all banks to one shared first-touch slot order; divergent per-bank slot
  maps raise :class:`FusedExecutionError`.

Fusion requires every bank to run the same command sequence with the same
activation geometry; callers (``charz.mc_*``, ``PudEngine``) gate it
(sequential-activation modules, the occupancy dealer and resident
execution stay on the loop) and ``fused=True`` where it cannot apply raises
:class:`FusedGeometryError`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.senseamp import round_to
from . import analog as A
from . import decoder as DEC
from .analog import ALL_OPS, _base_op
from .device import ActivationSupport, ENERGY_PJ, VIOLATED_TRAS_NS, \
    VIOLATED_TRP_NS
from .isa import CapabilityError, PudIsa, inventory_for
from .simulator import (_NP_DTYPE, STATIC_SPLIT, BankSim, _norm_ppf,
                        torch_seed)


class FusedExecutionError(RuntimeError):
    """Per-bank execution diverged where fusion requires lockstep (row-slot
    allocation, draw shape or noise-context sign) — a bug guard, not a
    capability limit: callers gate fusion, they do not catch this."""


class FusedGeometryError(CapabilityError):
    """Banks disagree on activation geometry (row counts / fan-in), or a
    caller forced fusion where it cannot apply."""


class PerBank:
    """Marker wrapper for per-bank values on :class:`FusedBankSim` APIs: an
    ``(N, ...)`` integer array (leading axis = banks).  A plain row / int
    broadcasts to all banks; fused ISA row handles are ``PerBank``."""

    __slots__ = ("vals",)

    def __init__(self, vals):
        self.vals = np.asarray(vals, dtype=np.int64)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"PerBank({self.vals.tolist()})"


class _FusedDraws:
    """One command's draws over N banks: bank b's generator (the loop's
    numpy stream or ``torch.Generator``) makes rows ``b*T .. (b+1)*T``."""

    def __init__(self, seqs: list, t: int, draws: str,
                 device: torch.device):
        self.t, self.device = t, device
        self.numpy = draws == "numpy"
        if self.numpy:
            self.gens = [np.random.default_rng(s) for s in seqs]
        else:
            self.gens = []
            for s in seqs:
                g = torch.Generator(device=device)
                g.manual_seed(torch_seed(s))
                self.gens.append(g)

    def _per_bank(self, shape: tuple) -> tuple:
        if shape[0] != self.t * len(self.gens):
            raise FusedExecutionError(
                f"fused draw of shape {shape} does not stack "
                f"{len(self.gens)} banks x {self.t} trials")
        return (self.t,) + tuple(shape[1:])

    def _draw(self, shape, dtype, np_name: str, fill: str) -> torch.Tensor:
        shape = tuple(shape)
        bs = self._per_bank(shape)
        if self.numpy:
            x = np.concatenate([getattr(g, np_name)(bs, dtype=_NP_DTYPE[dtype])
                                for g in self.gens])
            return torch.from_numpy(x).to(self.device)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        for b, g in enumerate(self.gens):
            getattr(out[b * self.t:(b + 1) * self.t], fill)(generator=g)
        return out

    def normal(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return self._draw(shape, dtype, "standard_normal", "normal_")

    def uniform(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return self._draw(shape, dtype, "random", "uniform_")


class FusedActivation:
    """Per-bank activation sets of one fused APA (uniform geometry)."""

    __slots__ = ("n_rf", "n_rl", "kind", "rows_f", "rows_l")

    def __init__(self, n_rf: int, n_rl: int, kind: str,
                 rows_f: np.ndarray, rows_l: np.ndarray):
        self.n_rf = n_rf
        self.n_rl = n_rl
        self.kind = kind
        self.rows_f = rows_f     # (N, n_rf)
        self.rows_l = rows_l     # (N, n_rl)


def _uniform_fact(acts: list) -> FusedActivation:
    a0 = acts[0]
    if any(a.n_rf != a0.n_rf or a.n_rl != a0.n_rl for a in acts[1:]):
        raise FusedGeometryError(
            "activation geometry differs across banks: "
            f"{[(a.n_rf, a.n_rl) for a in acts]}")
    return FusedActivation(
        a0.n_rf, a0.n_rl, a0.kind,
        np.asarray([a.rows_f for a in acts], dtype=np.int64),
        np.asarray([a.rows_l for a in acts], dtype=np.int64))


class FusedBankSim(BankSim):
    """N independent banks as one ``(N*T, slots, row_bits)`` episode.

    ``bank_seeds`` fixes each bank's chip identity (decoder map + static SA
    offsets); ``trials`` is the per-bank trial count T.  The base class runs
    unchanged at ``N*T`` trials; this class overrides only where banks
    differ: noise streams, static latents, analog scalars, decoder
    activations and the row -> slot map.  ``track_unshared`` is forced off;
    other keywords (``draws``, ``device``, ...) are ``BankSim``'s."""

    def __init__(self, module=None, *, bank_seeds, trials: int,
                 noise_seeds=None, **kw):
        bank_seeds = [int(s) for s in bank_seeds]
        if not bank_seeds:
            raise ValueError("bank_seeds must name at least one bank")
        if trials is None or int(trials) < 1:
            raise ValueError(f"trials must be >= 1 per bank, got {trials}")
        if kw.pop("track_unshared", False):
            raise ValueError("FusedBankSim requires track_unshared=False "
                             "(non-shared column state is per-bank "
                             "divergent and never read back)")
        if "noise_seed" in kw:
            raise TypeError("use noise_seeds (one per bank), not noise_seed")
        if "seed" in kw:
            raise TypeError("use bank_seeds, not seed")
        self.n_banks = len(bank_seeds)
        self.trials_per_bank = int(trials)
        super().__init__(module, seed=bank_seeds[0],
                         trials=self.n_banks * self.trials_per_bank,
                         track_unshared=False, **kw)
        self.bank_seeds = bank_seeds
        if noise_seeds is None:
            noise_seeds = bank_seeds
        self.bank_noise_seeds = [int(s) for s in noise_seeds]
        if len(self.bank_noise_seeds) != self.n_banks:
            raise ValueError(
                f"need one noise seed per bank ({self.n_banks}), got "
                f"{len(self.bank_noise_seeds)}")
        #: per-bank command counters (the loop path's ``_trial`` per bank)
        self._bank_trial = [0] * self.n_banks
        self._param_cache: dict = {}
        self._not_z_cache: dict = {}

    # ---------------- per-bank noise streams ----------------
    def _rng(self) -> _FusedDraws:
        seqs = []
        for b in range(self.n_banks):
            self._bank_trial[b] += 1
            seqs.append(np.random.SeedSequence(
                [self.bank_noise_seeds[b], 0x7A1A1, self._bank_trial[b]]))
        return _FusedDraws(seqs, self.trials_per_bank, self.draws,
                           self.device)

    def reseed_noise(self, noise_seed) -> None:
        """Per-bank noise reseed: one seed per bank (an int only for a
        single-bank sim).  Counters restart, as ``BankSim.reseed_noise``
        does per bank."""
        if isinstance(noise_seed, (int, np.integer)):
            if self.n_banks != 1:
                raise ValueError(
                    f"fused sim over {self.n_banks} banks needs one noise "
                    "seed per bank (a shared seed would collide streams)")
            noise_seed = [noise_seed]
        seeds = [int(s) for s in noise_seed]
        if len(seeds) != self.n_banks:
            raise ValueError(f"need {self.n_banks} noise seeds, got "
                             f"{len(seeds)}")
        self.bank_noise_seeds = seeds
        self.noise_seed = seeds[0]
        self._bank_trial = [0] * self.n_banks

    def set_bank_trials(self, counters) -> None:
        """Pre-position the per-bank command counters (a tail round's
        bank-subset sim continues the first banks' streams)."""
        counters = [int(c) for c in counters]
        if len(counters) != self.n_banks:
            raise ValueError(f"need {self.n_banks} counters, got "
                             f"{len(counters)}")
        self._bank_trial = counters

    # ---------------- per-bank chip identity ----------------
    def _static_latents(self, stripe: int):
        """(N, w) stacked per-bank latents (loop path: (w,) per bank)."""
        if stripe not in self._static:
            xs = []
            for s in self.bank_seeds:
                rng = np.random.default_rng(
                    np.random.SeedSequence([s, 0xC0FFEE, stripe]))
                xs.append((rng.random(self.shared_w),
                           rng.random(self.shared_w)))
            self._static[stripe] = (np.stack([x[0] for x in xs]),
                                    np.stack([x[1] for x in xs]))
        return self._static[stripe]

    # ---------------- per-bank row maps, shared slots ----------------
    def _pb_vals(self, rows) -> np.ndarray:
        """(N, k) per-bank row matrix from a PerBank or a shared spec."""
        if isinstance(rows, PerBank):
            r = rows.vals
            if r.ndim == 1:
                r = r[:, None]
            if r.ndim != 2 or r.shape[0] != self.n_banks:
                raise ValueError(
                    f"PerBank rows must be ({self.n_banks}, k), got shape "
                    f"{rows.vals.shape}")
            return r
        base = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        return np.broadcast_to(base, (self.n_banks, base.size))

    def _map_rows(self, sub: int, rows) -> np.ndarray:
        """Slot indices shared by every bank's rows (allocated in lockstep
        on first touch)."""
        if not 0 <= sub < self.geom.subarrays_per_bank:
            raise IndexError(f"subarray {sub} out of range")
        r = self._pb_vals(rows)
        if r.size and (r.min() < 0
                       or r.max() >= self.geom.rows_per_subarray):
            raise IndexError(f"row out of range in {r}")
        rmap = self._rowmap.get(sub)
        if rmap is None:
            rmap = self._rowmap[sub] = np.full(
                (self.n_banks, self.geom.rows_per_subarray), -1,
                dtype=np.int64)
            self._nrows[sub] = 0
        bidx = np.arange(self.n_banks)[:, None]
        idx = rmap[bidx, r]
        fresh = idx < 0
        if np.any(fresh):
            if not (fresh == fresh[0]).all():
                raise FusedExecutionError(
                    "per-bank first-touch order diverged (some banks have "
                    "already allocated a row others have not) — fused ops "
                    "must recycle rows so all banks allocate in lockstep")
            cols = np.nonzero(fresh[0])[0]
            start = self._nrows[sub]
            rmap[bidx, r[:, cols]] = np.arange(start, start + cols.size)
            self._nrows[sub] = start + cols.size
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
            idx = rmap[bidx, r]
        if idx.size and not (idx == idx[0]).all():
            raise FusedExecutionError(
                "per-bank slot maps diverged — banks disagree on which "
                "storage slot a row occupies")
        return idx[0]

    def global_addr(self, sub: int, row):
        if isinstance(row, PerBank):
            return PerBank(sub * self.geom.rows_per_subarray + row.vals)
        return super().global_addr(sub, row)

    def rowclone(self, sub: int, src, dst) -> None:
        pair = PerBank(np.stack([self._pb_vals(src)[:, 0],
                                 self._pb_vals(dst)[:, 0]], axis=1))
        isrc, idst = (int(i) for i in self._map_rows(sub, pair))
        self._clone_slots(sub, isrc, idst)

    # ---------------- per-bank analog parameters ----------------
    def _resolve_params(self, stripe: int, op: str, n: int, *,
                        regions, random_pattern: bool):
        """Fused analog scalars -> (s, static (N, w) float32 on the device,
        pf, thr (N,) float32 on the device): ``dv`` and so the threshold
        differ per bank; ``s`` / ``shift`` / ``pf`` are shared.  Memoized:
        the inputs are pure functions of chip identity and the op context."""
        reg_c = tuple(int(x) for x in np.atleast_1d(regions[0]))
        reg_r = tuple(int(x) for x in np.atleast_1d(regions[1]))
        key = (stripe, op, n, random_pattern, reg_c, reg_r)
        cached = self._param_cache.get(key)
        if cached is None:
            p = self.params
            dv = [A.margin_offset(op, p, compute_region=reg_c[b % len(reg_c)],
                                  ref_region=reg_r[b % len(reg_r)],
                                  mfr=self.module.manufacturer.value,
                                  density_gb=self.module.density_gb,
                                  die_rev=self.module.die_rev)
                  for b in range(self.n_banks)]
            s, _b, _wp, _wm = A.op_noise(
                op, n, p, temp_c=self.temp_c, random_pattern=random_pattern,
                speed_mts=self.module.speed_mts,
                mfr=self.module.manufacturer.value,
                density_gb=self.module.density_gb,
                die_rev=self.module.die_rev)
            shift = A.op_shift(op, n, p)
            static = torch.from_numpy(self.static_offsets(
                stripe, op, n, random_pattern=random_pattern)).to(
                    device=self.device, dtype=self._noise_dtype)   # (N, w)
            pf = A.op_pfloor(op, n, p, temp_c=self.temp_c,
                             random_pattern=random_pattern,
                             speed_mts=self.module.speed_mts)
            # each bank's threshold rounded as its loop episode rounds it
            thr = torch.tensor([round_to(-(dv_b - shift - p.delta_v),
                                         self._noise_dtype) for dv_b in dv],
                               dtype=self._noise_dtype, device=self.device)
            cached = self._param_cache[key] = (s, static, pf, thr)
        return cached

    def _resolve(self, l_sub: int, rows_l, l_sl: slice, f_sub: int, rows_f,
                 f_sl: slice, stripe: int, op: str, *, regions,
                 random_pattern: bool, rng) -> torch.Tensor:
        """The Boolean comparator of all banks in one kernel launch, with
        the per-bank static plane and thresholds -> (N*T, w) uint8."""
        kw = dict(width=self.shared_w, u_com=A.u_n(len(rows_l), self.params),
                  u_ref=A.u_n(len(rows_f), self.params))
        arr_l, arr_f = self._cells(l_sub), self._cells(f_sub)
        if self.error_model in ("ideal", "none", "mean"):
            return kops.senseamp_gather(arr_l, rows_l, l_sl.start, arr_f,
                                        rows_f, f_sl.start, **kw)
        s, static, pf, thr = self._resolve_params(
            stripe, op, len(rows_l), regions=regions,
            random_pattern=random_pattern)
        shape = (self._T, self.shared_w)
        nz = rng.normal(shape, self._noise_dtype)
        u0 = rng.uniform(shape, self._noise_dtype)
        return kops.senseamp_gather(
            arr_l, rows_l, l_sl.start, arr_f, rows_f, f_sl.start,
            static=static, normals=nz,
            sigma=math.sqrt(max(1.0 - STATIC_SPLIT ** 2, 0.0)) * s,
            u0=u0, pf=pf, thr=thr, bank_trials=self.trials_per_bank, **kw)

    def _not_z(self, stripe: int, fact: "FusedActivation", reg_f,
               reg_l) -> torch.Tensor:
        """(N, w) per-cell NOT success latents, one cached row per bank."""
        spread = 0.75
        xi1, _xi2 = self._static_latents(stripe)               # (N, w)
        zs = []
        for b in range(self.n_banks):
            key = (b, stripe, fact.n_rl, fact.kind, int(reg_f[b]),
                   int(reg_l[b]))
            z_b = self._not_z_cache.get(key)
            if z_b is None:
                p_ok = A.not_success(
                    fact.n_rl,
                    pattern=("N2N" if fact.kind == "N:2N" else "NN"),
                    p=self.params, temp_c=self.temp_c,
                    src_region=int(reg_f[b]), dst_region=int(reg_l[b]),
                    speed_mts=self.module.speed_mts,
                    mfr=self.module.manufacturer.value,
                    density_gb=self.module.density_gb,
                    die_rev=self.module.die_rev)
                a = _norm_ppf(np.clip(p_ok, 1e-9, 1 - 1e-9)) \
                    * math.sqrt(1.0 + spread ** 2)
                z_b = torch.from_numpy(A.phi(a + spread * _norm_ppf(xi1[b]))) \
                    .to(device=self.device, dtype=self._noise_dtype)
                self._not_z_cache[key] = z_b
            zs.append(z_b)
        return torch.stack(zs)

    # ---------------- fused APA ----------------
    def apa(self, rf_global, rl_global, *, first_act_restored: bool = False,
            random_pattern: bool = True) -> FusedActivation:
        rps = self.geom.rows_per_subarray
        rfv = self._pb_vals(rf_global)[:, 0]
        rlv = self._pb_vals(rl_global)[:, 0]
        f_subs, f_rows = np.divmod(rfv, rps)
        l_subs, l_rows = np.divmod(rlv, rps)
        if not ((f_subs == f_subs[0]).all() and (l_subs == l_subs[0]).all()):
            raise FusedGeometryError(
                "fused APA needs one subarray pair shared by all banks")
        f_sub, l_sub = int(f_subs[0]), int(l_subs[0])
        fact = _uniform_fact([
            DEC.activation_pattern(self.module, int(f_rows[b]),
                                   int(l_rows[b]), seed=self.bank_seeds[b])
            for b in range(self.n_banks)])
        t = self.timings
        t_first = t.tRAS if first_act_restored else VIOLATED_TRAS_NS
        self.log.add("APA", t_first + VIOLATED_TRP_NS + t.tRAS + t.tRP,
                     (fact.n_rf + fact.n_rl) * ENERGY_PJ["act"]
                     + 2 * ENERGY_PJ["pre"],
                     bank=self.bank, sub=f_sub)
        if fact.n_rf == 0:
            return fact
        if self.module.activation is ActivationSupport.SEQUENTIAL \
                and not first_act_restored:
            return fact
        stripe, f_cols, l_cols = self._col_slices(f_sub, l_sub)
        rows_f = self._map_rows(f_sub, PerBank(fact.rows_f))
        rows_l = self._map_rows(l_sub, PerBank(fact.rows_l))
        arr_f, arr_l = self._cells(f_sub), self._cells(l_sub)
        idx_f, idx_l = self._index(rows_f), self._index(rows_l)
        rng = self._rng()
        geom = self.geom
        reg_f = np.atleast_1d(geom.distance_regions(
            f_rows, toward_upper=f_sub > l_sub))
        reg_l = np.atleast_1d(geom.distance_regions(
            l_rows, toward_upper=l_sub > f_sub))
        nb, tb, w = self.n_banks, self.trials_per_bank, self.shared_w

        if first_act_restored:
            # ---- NOT protocol: per-bank success latents ----
            n_src = fact.n_rf
            u = A.u_n(n_src, self.params)
            v_src = 0.5 + (self._row_sum(arr_f, rows_f, f_cols)
                           - round_to(0.5 * n_src, torch.float32)) \
                * round_to(u, torch.float32)
            src_bit = v_src > 0.5                       # (N*T, w)
            if self.error_model == "analog":
                z = self._not_z(stripe, fact, reg_f, reg_l)        # (N, w)
                draw = rng.uniform(tuple(src_bit.shape), self._noise_dtype)
                ok = (draw.view(nb, tb, w) < z[:, None]).view(src_bit.shape)
            else:
                ok = torch.ones_like(src_bit)
            dst_bit = torch.where(ok, ~src_bit, src_bit).to(torch.float32)
            arr_l[:, idx_l, l_cols] = dst_bit[:, None, :]
            arr_f[:, idx_f, f_cols] = src_bit.to(torch.float32)[:, None, :]
        else:
            # ---- Boolean-op protocol ----
            # the noise context (AND- vs OR-family common mode) must agree
            # across banks: per-bank float64 sums, one (N,) read per APA
            n_f = fact.n_rf
            lo = int(rows_f.min())
            span = arr_f[:, lo:int(rows_f.max()) + 1, f_cols]
            per_slot = span.reshape(nb, tb, span.shape[1], w).sum(
                dim=(1, 3), dtype=torch.float64)               # (N, slots)
            total = per_slot[:, self._index(rows_f - lo)].sum(dim=1)
            level = total.cpu().numpy() - 0.5 * n_f * tb * w
            ctx = level >= 0.0
            if not (ctx == ctx[0]).all():
                raise FusedExecutionError(
                    "reference common-mode sign differs across banks")
            op_ctx = "and" if bool(ctx[0]) else "or"
            out = self._resolve(l_sub, rows_l, l_cols, f_sub, rows_f, f_cols,
                                stripe, op_ctx, regions=(reg_l, reg_f),
                                random_pattern=random_pattern, rng=rng)
            outf = out.to(torch.float32)
            arr_l[:, idx_l, l_cols] = outf[:, None, :]
            arr_f[:, idx_f, f_cols] = (1.0 - outf)[:, None, :]
        # track_unshared is forced off: no non-shared-column restore (and,
        # as in the loop path, its draws are skipped too)
        return fact


class FusedPudIsa(PudIsa):
    """PudIsa over a :class:`FusedBankSim`: per-bank pair inventories and
    cursors, ``PerBank`` row handles, uniform-geometry planning.

    Bank b's cursor / scramble stream is exactly the one its loop-path
    ``PudIsa`` runs, so default pair selection matches the loop path per
    bank.  Every ``exec_*`` recycles row slots on entry."""

    def __init__(self, sim: FusedBankSim, *, f_sub: int = 0,
                 l_sub: int | None = None, bank: int = 0):
        if not isinstance(sim, FusedBankSim):
            raise TypeError("FusedPudIsa requires a FusedBankSim")
        super().__init__(sim, f_sub=f_sub, l_sub=l_sub, bank=bank)
        self.invs = [inventory_for(sim.module, s) for s in sim.bank_seeds]
        self._bank_cursors: list[dict] = [{} for _ in sim.bank_seeds]

    @property
    def n_banks(self) -> int:
        return self.sim.n_banks

    def adopt_state(self, other: "FusedPudIsa") -> None:
        """Continue the first ``self.n_banks`` banks' pair cursors and noise
        counters from a wider fused ISA (tail rounds when groups % banks !=
        0)."""
        k = self.n_banks
        self._bank_cursors = [dict(c) for c in other._bank_cursors[:k]]
        self.sim.set_bank_trials(other.sim._bank_trial[:k])

    def absorb_state(self, other: "FusedPudIsa") -> None:
        """Inverse of :meth:`adopt_state`: fold a narrower ISA's cursor /
        counter advances back into this ISA's first banks after a tail
        round, so a later call continues every bank's streams where the
        loop path's per-bank ISAs would."""
        k = other.n_banks
        if k > self.n_banks:
            raise ValueError("absorb_state wants a narrower fused ISA")
        for b in range(k):
            self._bank_cursors[b] = dict(other._bank_cursors[b])
            self.sim._bank_trial[b] = other.sim._bank_trial[b]

    # ---------------- per-bank pair selection ----------------
    def _next_pair_bank(self, b: int, n_rf: int, n_rl: int):
        key = (n_rf, n_rl)
        cur = self._bank_cursors[b]
        k = cur.get(key, 0)
        cur[key] = k + 1
        inv = self.invs[b]
        n_pairs = max(len(inv.pairs(n_rf, n_rl)), 1)
        scrambled = DEC._mix64(k * 0x9E3779B97F4A7C15
                               + self.sim.bank_seeds[b])
        return inv.choose(n_rf, n_rl, scrambled % n_pairs)

    def _per_bank_pairs(self, pair) -> list:
        if isinstance(pair, PerBank):
            pair = pair.vals
        pair = list(pair)
        if len(pair) == 2 and all(
                isinstance(x, (int, np.integer)) for x in pair):
            return [(int(pair[0]), int(pair[1]))] * self.n_banks
        if len(pair) != self.n_banks:
            raise ValueError(f"need one (rf, rl) pair per bank "
                             f"({self.n_banks}), got {len(pair)}")
        return [(int(rf), int(rl)) for rf, rl in pair]

    def _acts_for(self, pairs: list) -> list:
        return [DEC.activation_pattern(self.sim.module, rf, rl,
                                       seed=self.sim.bank_seeds[b])
                for b, (rf, rl) in enumerate(pairs)]

    # ---------------- logical ops ----------------
    def not_activation(self, n_dst: int) -> int:
        n_rfs = []
        for b in range(self.n_banks):
            for n_rf in (max(n_dst // 2, 1), n_dst):
                if len(self.invs[b].pairs(n_rf, n_dst)):
                    n_rfs.append(n_rf)
                    break
            else:
                raise CapabilityError(
                    f"no activation with {n_dst} dst rows")
        if len(set(n_rfs)) != 1:
            raise FusedGeometryError(
                f"NOT source-row count differs across banks: {n_rfs}")
        return n_rfs[0]

    def plan_not(self, n_dst: int = 1, *, pair_index: int | None = None,
                 pair=None):
        n_rf = self.not_activation(n_dst)
        if pair is not None:
            pairs = self._per_bank_pairs(pair)
        elif pair_index is not None:
            pairs = [self.invs[b].choose(n_rf, n_dst, pair_index)
                     for b in range(self.n_banks)]
        else:
            pairs = [self._next_pair_bank(b, n_rf, n_dst)
                     for b in range(self.n_banks)]
        acts = self._acts_for(pairs)
        if pair is None and pair_index is None:
            # per-bank decoder-miss retries (sequential modules), exactly
            # the loop path's per-bank 63-step sweep
            for b in range(self.n_banks):
                if acts[b].n_rf == 0:
                    for _ in range(63):
                        pairs[b] = self._next_pair_bank(b, n_rf, n_dst)
                        acts[b] = DEC.activation_pattern(
                            self.sim.module, *pairs[b],
                            seed=self.sim.bank_seeds[b])
                        if acts[b].n_rf:
                            break
        for b, a in enumerate(acts):
            if a.n_rf == 0:
                raise CapabilityError(
                    f"address pair {pairs[b]} yields no simultaneous "
                    f"activation on {self.sim.module.name} (bank {b})")
        fact = _uniform_fact(acts)
        rf = PerBank([p[0] for p in pairs])
        rl = PerBank([p[1] for p in pairs])
        return rf, rl, fact

    def exec_not(self, rf, rl, act: FusedActivation, source):
        kind, payload = source
        if kind != "write":
            raise NotImplementedError(
                "fused execution stages operands from the host "
                "(resident row chaining is loop-path only)")
        self.sim.recycle_rows()     # lockstep slot allocation (module doc)
        self.sim.write_cols_multi(
            self.f_sub, PerBank(act.rows_f), self._f_sl,
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
        return PerBank(act.rows_l[:, 0]), PerBank(act.rows_f[:, 0])

    def plan_nary(self, op: str, n: int, *, pair_index: int | None = None,
                  pair=None):
        op = op.lower()
        if op not in ALL_OPS:
            raise ValueError(f"unknown op {op}")
        if n < 2:
            raise ValueError("n-ary op needs >= 2 operands")
        if n > self.sim.module.max_inputs:
            raise CapabilityError(
                f"{n}-input ops exceed module capability "
                f"({self.sim.module.max_inputs})")
        n_hws = []
        for b in range(self.n_banks):
            n_hw = n
            while n_hw <= 16 and len(self.invs[b].pairs(n_hw, n_hw)) == 0:
                n_hw += n_hw % 2 or 1
            if len(self.invs[b].pairs(n_hw, n_hw)) == 0:
                raise CapabilityError(f"no >= {n}:{n} pairs on this module")
            n_hws.append(n_hw)
        if len(set(n_hws)) != 1:
            raise FusedGeometryError(
                f"hardware fan-in differs across banks: {n_hws}")
        n_hw = n_hws[0]
        if pair is not None:
            pairs = self._per_bank_pairs(pair)
        elif pair_index is not None:
            pairs = [self.invs[b].choose(n_hw, n_hw, pair_index)
                     for b in range(self.n_banks)]
        else:
            pairs = [self._next_pair_bank(b, n_hw, n_hw)
                     for b in range(self.n_banks)]
        acts = self._acts_for(pairs)
        for b, a in enumerate(acts):
            if a.n_rf != n_hw or a.n_rl != n_hw:
                raise FusedGeometryError(
                    f"pair {pairs[b]} activates {a.n_rf}:{a.n_rl} on bank "
                    f"{b}, wanted {n_hw}:{n_hw}")
        fact = _uniform_fact(acts)
        rf = PerBank([p[0] for p in pairs])
        rl = PerBank([p[1] for p in pairs])
        return n_hw, rf, rl, fact

    def exec_nary(self, op: str, rf, rl, act: FusedActivation, sources, *,
                  ref_row=None, random_pattern: bool = True):
        if ref_row is not None:
            raise NotImplementedError(
                "fused execution host-fills reference rows "
                "(resident constant rows are loop-path only)")
        if not (isinstance(sources, tuple) and sources[0] == "write_stack"):
            raise NotImplementedError(
                "fused execution stages operands with ('write_stack', ops)")
        self.sim.recycle_rows()     # lockstep slot allocation (module doc)
        n = act.n_rf
        base, _is_ref = _base_op(op.lower())
        const = 1.0 if base == "and" else 0.0
        self.sim.fill_rows(self.f_sub, PerBank(act.rows_f[:, :-1]), const,
                           cols=self._f_sl)
        self.stats.writes += n - 1
        self.stats.cost = self.stats.cost \
            + self.cost_model.write_row().scaled(n - 1)
        self.sim.frac_row(self.f_sub, PerBank(act.rows_f[:, -1]))
        self.stats.fracs += 1
        stack = self._stack_words(sources[1])
        n_wr = stack.shape[-2]
        self.sim.write_cols_multi(self.l_sub, PerBank(act.rows_l[:, :n_wr]),
                                  self._l_sl, stack)
        self.stats.writes += n_wr
        self.sim.op_boolean(op, self.sim.global_addr(self.f_sub, rf),
                            self.sim.global_addr(self.l_sub, rl),
                            random_pattern=random_pattern)
        self.stats.apas += 1
        self.stats.ops += 1
        self.stats.cost = self.stats.cost + self.cost_model.boolean(n) \
            + self.cost_model.write_row().scaled(n_wr)
        return PerBank(act.rows_l[:, 0]), PerBank(act.rows_f[:, 0])

    # ---------------- result splitting ----------------
    def split_banks(self, word: torch.Tensor) -> list[torch.Tensor]:
        """(N*T, w) fused result -> one (T, w) view per bank."""
        t = self.sim.trials_per_bank
        return [word[b * t:(b + 1) * t] for b in range(self.n_banks)]
