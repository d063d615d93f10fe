"""PuD engine: backend dispatch + offload accounting.

The port of ``repro.pud.engine``: the framework-facing entry point for bulk
Boolean work on packed bit-planes.  Three backends share one semantics:

  * ``torch``  — plain PyTorch ops on the engine's device (the counterpart
                 of the reference's ``jnp``),
  * ``kernel`` — the hand-written Hopper kernels through
                 :mod:`repro_torch.kernels.ops` (the counterpart of
                 ``pallas``; on a CPU engine the kernels' plain twins),
  * ``dram``   — the FCDRAM simulator through the ISA: the port's
                 :class:`~repro_torch.core.bankarray.BankArray` /
                 :class:`~repro_torch.core.isa.PudIsa`, whose Boolean APAs
                 resolve in the ``senseamp`` kernel on the card.

Planes are ``(R, C)`` ``int32`` tensors of packed bit patterns (R × 32C
logical bits) on the engine's device; a numpy ``uint32`` plane crosses over
as ``torch.from_numpy(np.asarray(p).view(np.int32))`` (:func:`as_planes`).

Every call is metered exactly as in the reference (``OffloadReport``): the
DDR4 command cost the same work would incur in-DRAM versus the
processor-centric baseline.  On the ``dram`` backend the dram side is
measured from the simulator's command log.

The ``dram`` backend is chunk-batched: a plane is unpacked on the device,
split into row-sized chunks, and each block of chunks runs as the trial axis
of one ``BankSim(trials=C)`` episode on bank ``j % banks`` (blocks dealt
round-robin), with a fresh noise stream per block — the reference's
per-bank loop.  The reference's fused multi-bank rounds are bit-identical
to that loop, so ``fused=None`` runs the loop and ``fused=True`` raises.

Compiled programs (``run_program``, and ``add`` through the synthesized
adder) run on the ``dram`` backend chunk-blocked through the trial-batched
program executor (``compiler.run_sim``), by default the scheduled
resident-register executor: intermediates chain in-bank via RowClone, and
chunk blocks of one (bank, size) chain through a ``ResidentSession``
(constant rows and pinned input words stay in the bank between blocks).
Under the scheduled policy bank 0 runs the planner search and sibling
banks replay its frozen decisions.  ``verify`` checks every resident plan
with the static verifier (:mod:`repro_torch.analysis`), and
:meth:`PudEngine.schedule_timing` gives the rank-legal schedule of the
backend's command logs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from ..core import compiler as CC
from ..core.bankarray import BankArray
from ..core.device import ENERGY_PJ, get_module
from ..core.isa import CostModel, OpCost, PudIsa
from ..core.policy import EngineConfig, ResidentPolicy, coerce_resident
from ..core.simulator import BankSim, resolve_device
from ..kernels import ops as kops

BACKENDS = ("torch", "kernel", "dram")

@lru_cache(maxsize=16)
def _adder_program(k: int) -> CC.Program:
    """K-bit ripple-carry adder lowered to the native PuD op set."""
    return CC.compile_expr(CC.adder_exprs(k))


def as_planes(x, device: torch.device) -> torch.Tensor:
    """Packed planes as contiguous ``int32`` bit patterns on ``device``:
    an int32 / uint32 tensor, or a numpy uint32 / int32 array (viewed, not
    converted)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        if x.dtype != torch.int32:
            raise ValueError(f"packed planes are int32 bit patterns, got "
                             f"{x.dtype}")
        return x.to(device).contiguous()
    a = np.ascontiguousarray(x)
    if a.dtype not in (np.uint32, np.int32):
        raise ValueError(f"packed planes are uint32 words, got {a.dtype}")
    return torch.from_numpy(a.view(np.int32)).to(device)


@dataclass
class OffloadReport:
    """Accumulated in-DRAM vs CPU-baseline cost of engine traffic.

    ``ops``/``bits`` count logical PuD instructions and the logical bits
    each processed — backend-invariant (every backend meters the
    synthesized native instruction stream).  ``dram``/``cpu`` aggregate the
    modeled DDR4 command costs; on the dram backend the dram side is
    measured from the simulator's command log.  ``rowclones`` counts
    in-bank RowClone copies and ``staged_bytes`` the bytes the host pushed
    over the bus to stage operand/reference rows.

    On a multi-bank engine every simulator-executed call also books its
    measured quantities into the sub-report of the bank it ran on
    (``report.bank(b)``; only ``dram``/``rowclones``/``staged_bytes``);
    :meth:`merged` folds them back into one array-level view.  The
    rank-level timing fields are stamped by
    :meth:`PudEngine.schedule_timing`.
    """

    ops: int = 0
    bits: int = 0
    dram: OpCost = field(default_factory=OpCost)
    cpu: OpCost = field(default_factory=OpCost)
    rowclones: int = 0
    staged_bytes: int = 0
    #: per-bank measured sub-reports (dram backend): bank index -> report
    banks: dict = field(default_factory=dict)
    makespan_ns: float = 0.0
    legal_makespan_ns: float = 0.0
    rank_stall_ns: float = 0.0
    refresh_stall_ns: float = 0.0

    def bank(self, b: int) -> "OffloadReport":
        """The (auto-created) measured sub-report of one bank."""
        sub = self.banks.get(b)
        if sub is None:
            sub = self.banks[b] = OffloadReport()
        return sub

    def merged(self) -> "OffloadReport":
        """One array-level view folding the per-bank ledgers together:
        logical fields copied from this report, measured fields summed
        over ``banks`` (or copied verbatim when no bank ever booked)."""
        m = OffloadReport(ops=self.ops, bits=self.bits, cpu=self.cpu)
        if not self.banks:
            m.dram, m.rowclones = self.dram, self.rowclones
            m.staged_bytes = self.staged_bytes
            return m
        for b in sorted(self.banks):
            sub = self.banks[b]
            m.dram = m.dram + sub.dram
            m.rowclones += sub.rowclones
            m.staged_bytes += sub.staged_bytes
        return m

    @property
    def energy_saving(self) -> float:
        if self.cpu.energy_pj == 0:
            return 0.0
        return 1.0 - self.dram.energy_pj / self.cpu.energy_pj

    @property
    def bus_bytes_avoided(self) -> int:
        return self.cpu.bus_bytes - self.dram.bus_bytes

    @property
    def host_bytes_moved(self) -> int:
        """Bytes that crossed the host DDR bus on the in-DRAM side."""
        return self.dram.bus_bytes

    def summary(self) -> dict:
        return {
            "ops": self.ops,
            "bits": self.bits,
            "dram_time_us": self.dram.time_ns / 1e3,
            "cpu_time_us": self.cpu.time_ns / 1e3,
            "dram_energy_uj": self.dram.energy_pj / 1e6,
            "cpu_energy_uj": self.cpu.energy_pj / 1e6,
            "energy_saving": self.energy_saving,
            "bus_bytes_avoided": self.bus_bytes_avoided,
            "host_bytes_moved": self.host_bytes_moved,
            "rowclones": self.rowclones,
            "staged_bytes": self.staged_bytes,
            "makespan_ns": self.makespan_ns,
            "legal_makespan_ns": self.legal_makespan_ns,
            "rank_stall_ns": self.rank_stall_ns,
            "refresh_stall_ns": self.refresh_stall_ns,
        }


class PudEngine:
    """Bulk-Boolean execution engine with cost metering.

    ``PudEngine("kernel")`` runs on the card; ``device="cpu"`` runs the
    same backends on the CPU (the kernels' plain twins).  ``draws`` is the
    dram backend's noise source (``"device"`` generators, or ``"numpy"``:
    the reference's streams, draw for draw)."""

    #: max chunks executed as one batched trial axis (bounds sim memory)
    DRAM_CHUNK_BATCH = 32
    #: min activation pairs swept per plane (region mixing in noisy mode)
    DRAM_MIN_PAIR_SWEEP = 4

    def __init__(self, backend: "str | EngineConfig" = "kernel", *,
                 config: EngineConfig | None = None,
                 module: str | None = None,
                 noisy: bool = False, seed: int = 0,
                 resident: "ResidentPolicy | bool | str | None" = None,
                 chain_blocks: bool = True, banks: int = 1,
                 fused: bool | None = None,
                 verify: bool | None = None,
                 draws: str = "device",
                 device: str | torch.device = "cuda"):
        if isinstance(backend, EngineConfig):
            if config is not None:
                raise ValueError("pass the EngineConfig positionally or "
                                 "as config=, not both")
            config = backend
        if config is not None:
            backend = config.backend
            module = config.module
            noisy = config.noisy
            seed = config.seed
            resident = config.resident
            chain_blocks = config.chain_blocks
            banks = config.banks
            fused = config.fused
            verify = config.verify
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        self.backend = backend
        self.device = resolve_device(device)
        self.module = get_module(module) if module else get_module()
        self.cost_model = CostModel(self.module)
        self.report = OffloadReport()
        self.noisy = noisy
        self.seed = seed
        #: how compiled programs execute on the dram backend
        self.policy = coerce_resident(
            resident, where="PudEngine",
            default=(ResidentPolicy.SCHEDULED if backend == "dram"
                     else ResidentPolicy.HOST))
        #: the full (frozen) configuration this engine runs under
        self.config = EngineConfig(
            backend=backend, module=module if isinstance(module, str)
            else None, noisy=noisy, seed=seed, resident=self.policy,
            chain_blocks=chain_blocks, banks=banks, fused=fused,
            verify=verify)
        #: dram backend: chain residency across same-size chunk blocks
        #: (ResidentSession); False re-stages every block
        self.chain_blocks = chain_blocks
        #: dram backend: number of independent banks chunk blocks are
        #: dealt across (round-robin); other backends have no banks
        self.banks = banks
        #: static plan-verification tri-state for the resident plans the
        #: dram backend schedules: ``True`` verifies every plan
        #: (:func:`repro_torch.analysis.verify_plan`), ``False`` never does,
        #: ``None`` defers to :func:`repro_torch.analysis.default_verify`
        self.verify = verify
        self._isa: PudIsa | None = None
        self._array: BankArray | None = None
        if backend == "dram":
            if fused:
                raise NotImplementedError(
                    "fused=True: the fused multi-bank path (core/fused.py) "
                    "is not ported yet, ROADMAP A-3 (the default per-bank "
                    "loop gives the same result)")
            #: N per-bank chips; bank 0 IS the single-bank engine's chip
            self._array = BankArray(
                self.module, banks=banks, seed=seed,
                error_model="analog" if noisy else "ideal", draws=draws,
                device=self.device)
            self._isa = self._array.isa(0)
        elif banks != 1:
            raise ValueError(
                f"banks={banks}: only the dram backend has banks")
        elif fused:
            raise ValueError(
                "fused=True: only the dram backend has banks to fuse")

    def _planes(self, x) -> torch.Tensor:
        return as_planes(x, self.device)

    def _isa_for(self, n_chunks: int, *, recycle: bool = True,
                 bank: int = 0) -> PudIsa:
        """ISA for one chunk block on one bank: a trial-batched BankSim
        with ``n_chunks`` trials (cached per (bank, batch size);
        single-chunk work uses the bank's scalar sim), reseeded onto an
        independent noise stream and, unless ``recycle=False`` (a chained
        block reusing rows an earlier block of its session left), with its
        row slots recycled."""
        if n_chunks <= 1:
            isa = self._array.isa(bank)
        else:
            isa = self._array.isa(bank, n_chunks, track_unshared=False)
        isa.sim.reseed_noise(self._array.next_noise_seed(bank))
        if recycle:
            isa.sim.recycle_rows()
        return isa

    # ------------- accounting -------------
    def _meter(self, op: str, n_inputs: int, n_bits: int, *,
               modeled: bool | None = None) -> None:
        """Book one logical instruction: ops/bits + the CPU baseline on
        every backend; the *modeled* in-DRAM command cost unless the call
        executes on the simulator (dram backend), whose cost is measured
        from the sim log instead (:meth:`_account_sim_log`)."""
        w = self.module.geometry.shared_bits
        rows = max(1, -(-n_bits // w))      # DRAM rows touched per operand
        self.report.ops += 1
        self.report.bits += n_bits
        n = 1 if op == "not" else max(n_inputs, 2)
        self.report.cpu = self.report.cpu + self.cost_model.cpu_baseline(
            n, rows)
        if modeled is None:
            modeled = self.backend != "dram"
        if not modeled:
            return
        if op == "not":
            dram = self.cost_model.op_not(1)
        else:
            dram = self.cost_model.boolean(n)
        self.report.dram = self.report.dram + dram.scaled(rows)

    def _account_sim_log(self, sim: BankSim, before: tuple,
                         bank: int | None = None) -> None:
        """Fold the sim's command-log delta since ``before`` into the
        report's dram side (and, with ``bank``, into that bank's
        sub-report): measured time/energy plus the off-chip IO energy and
        burst time per transferred row, host WR/RD bus bytes, RowClone and
        staging counters."""
        t0, e0, c0 = before
        log = sim.log
        counts = {k: v - c0.get(k, 0) for k, v in log.counts.items()}
        row_bytes = sim.geom.row_bits // 8
        wr = counts.get("WR", 0)
        rd = counts.get("RD", 0)
        n_bursts = max(row_bytes // 64, 1)
        io_rows = wr + rd
        cost = OpCost(
            (log.time_ns - t0)
            + io_rows * n_bursts * 4 * self.cost_model.t.tCK,
            (log.energy_pj - e0)
            + io_rows * n_bursts * ENERGY_PJ["io_per_64B"],
            commands=sum(counts.values()),
            bus_bytes=io_rows * row_bytes)
        targets = [self.report]
        if bank is not None:
            targets.append(self.report.bank(bank))
        for rep in targets:
            rep.dram = rep.dram + cost
            rep.rowclones += counts.get("RC", 0)
            rep.staged_bytes += wr * row_bytes

    @staticmethod
    def _log_snapshot(sim: BankSim) -> tuple:
        return (sim.log.time_ns, sim.log.energy_pj, dict(sim.log.counts))

    def _meter_program(self, prog: CC.Program, n_bits: int) -> None:
        """Meter a compiled program's native compute instructions (shared
        by ``run_program`` and ``add``: ops/bits stay backend-invariant)."""
        for i in prog.instrs:
            if i.op == "not":
                self._meter("not", 1, n_bits)
            elif i.op in ("and", "or", "nand", "nor"):
                self._meter(i.op, len(i.srcs), n_bits)

    # ------------- ops on packed planes -------------
    def nary(self, planes, op: str) -> torch.Tensor:
        """planes: (N, R, C) packed -> (R, C)."""
        planes = self._planes(planes)
        n, r, c = planes.shape
        self._meter(op, n, r * c * 32)
        if self.backend == "kernel":
            return kops.nary_bitwise(planes, op)
        if self.backend == "dram":
            return self._dram_nary(planes, op)
        return kops.ref.nary_bitwise(op, planes)

    def not_(self, plane) -> torch.Tensor:
        plane = self._planes(plane)
        r, c = plane.shape
        self._meter("not", 1, r * c * 32)
        if self.backend == "kernel":
            return kops.bitwise_not(plane)
        if self.backend == "dram":
            return self._dram_not(plane)
        return ~plane

    def add(self, a, b) -> torch.Tensor:
        """Bit-serial adder: (K, R, C) + (K, R, C) -> (K+1, R, C).

        torch/kernel run the fused ripple-carry (oracle or kernel); the
        dram backend runs the adder synthesized from the native op set
        (``compiler.adder_exprs``) through :meth:`run_program`.  Every
        backend meters that synthesized instruction stream.
        """
        a, b = self._planes(a), self._planes(b)
        k, r, c = a.shape
        prog = _adder_program(k)
        if self.backend == "dram":
            planes = {f"a{i}": a[i] for i in range(k)} \
                | {f"b{i}": b[i] for i in range(k)}
            out = self.run_program(prog, planes)
            return torch.stack([*(out[f"s{i}"] for i in range(k)),
                                out["cout"]])
        self._meter_program(prog, r * c * 32)
        if self.backend == "kernel":
            return kops.add_planes(a, b)
        return kops.ref.add_planes(a, b)

    def popcount(self, planes) -> torch.Tensor:
        """(N, R, C) -> bit-sliced per-bit counts.  No simulator path (as
        in the reference): the dram backend runs the oracle and books the
        modeled in-DRAM cost."""
        planes = self._planes(planes)
        n = planes.shape[0]
        self._meter("and", n, planes.numel() * 32, modeled=True)
        if self.backend == "kernel":
            return kops.bitcount_planes(planes)
        return kops.ref.bitcount_planes(planes)

    def schedule_timing(self):
        """Rank-legal schedule of everything this engine has executed.

        Runs the :mod:`repro_torch.analysis.schedule` event-driven scheduler
        over the dram backend's accumulated BankArray command logs and
        stamps the resulting makespans/stalls onto :attr:`report`.  Returns
        the :class:`~repro_torch.analysis.ScheduledTimeline`; raises on the
        other backends (no command logs to schedule)."""
        if self._array is None:
            raise RuntimeError("schedule_timing() needs the dram backend"
                               " (no command logs on torch/kernel)")
        from .. import analysis
        tl = analysis.schedule_bank_array(self._array)
        self.report.makespan_ns = float(self._array.makespan_ns())
        self.report.legal_makespan_ns = tl.legal_makespan_ns
        self.report.rank_stall_ns = tl.rank_stall_ns
        self.report.refresh_stall_ns = tl.refresh_stall_ns
        return tl

    # ------------- compiled Boolean programs -------------
    def run_program(self, prog: CC.Program,
                    planes: dict) -> dict[str, torch.Tensor]:
        """Execute a compiled :class:`~repro_torch.core.compiler.Program`
        over packed ``(R, C)`` planes: each instruction on whole planes
        (torch ops, or one kernel launch per compute instruction on the
        ``kernel`` backend), or, on ``dram``, chunk-blocked through the
        program executor on the simulated bank (see
        :meth:`_dram_run_program`).  ``planes`` maps the program's input
        names to equal-shape planes; returns one plane per program output.
        Every compute instruction is metered into the
        :class:`OffloadReport`.

        >>> from repro_torch.core import compiler as CC
        >>> prog = CC.compile_expr(CC.Xor(CC.Var("a"), CC.Var("b")))
        >>> eng = PudEngine("torch", device="cpu")
        >>> a = torch.tensor([[5]], dtype=torch.int32)
        >>> b = torch.tensor([[3]], dtype=torch.int32)
        >>> int(eng.run_program(prog, {"a": a, "b": b})["out"][0, 0])
        6
        >>> eng.report.ops                      # 4 NANDs were metered
        4
        """
        if not planes:
            raise ValueError("run_program needs at least one input plane")
        named = {k: self._planes(v) for k, v in planes.items()}
        shapes = {tuple(v.shape) for v in named.values()}
        if len(shapes) != 1:
            raise ValueError(f"input planes disagree on shape: {shapes}")
        (shape,) = shapes
        missing = {i.name for i in prog.instrs if i.op == "input"} \
            - named.keys()
        if missing:       # validate before metering: a failed run must not
            raise ValueError(   # inflate the offload report
                f"program inputs missing from planes: {sorted(missing)}")
        r, c = shape
        self._meter_program(prog, r * c * 32)
        if self.backend == "dram":
            return self._dram_run_program(prog, named, shape)
        kernel = self.backend == "kernel"
        regs: dict[int, torch.Tensor] = {}
        for i in prog.instrs:
            if i.op == "input":
                regs[i.dst] = named[i.name]
            elif i.op == "const":
                regs[i.dst] = torch.full(shape, -1 if i.value else 0,
                                         dtype=torch.int32,
                                         device=self.device)
            elif i.op == "not":
                src = regs[i.srcs[0]]
                regs[i.dst] = kops.bitwise_not(src) if kernel else ~src
            elif i.op in ("and", "or", "nand", "nor"):
                stack = torch.stack([regs[s] for s in i.srcs])
                regs[i.dst] = (kops.nary_bitwise(stack, i.op) if kernel
                               else kops.ref.nary_bitwise(i.op, stack))
            else:
                raise ValueError(i.op)
        return {k: regs[v] for k, v in prog.outputs.items()}

    def _dram_run_program(self, prog: CC.Program, planes: dict,
                          shape: tuple) -> dict[str, torch.Tensor]:
        """Chunk-blocked program execution on the simulated bank: each
        block of row chunks runs the whole program as one trial-batched
        ``compiler.run_sim`` episode, through the engine's resident policy
        (host-staged under ``HOST``).

        Resident mode chains residency across blocks (``chain_blocks``):
        blocks of one (bank, size) share a ``compiler.ResidentSession``,
        so the constant rows block k staged stay in the bank for block
        k+1, and under the scheduled policy a block whose input word equals
        the previous block's RowClones the pinned row.  Every block still
        gets its own noise stream.  An input plane whose row chunks are all
        identical (a broadcast operand) is handed to each block as one
        ``(w,)`` word.  Blocks are dealt round-robin across the banks;
        under the scheduled policy bank 0 runs the planner search and
        sibling banks replay its frozen decisions."""
        r, c = shape
        n_bits = r * c * 32
        w = self._isa.width
        chunks = {name: self._to_chunks(
            kops.unpack_bits(p).reshape(n_bits), w)
            for name, p in planes.items()}           # each (C, w)
        n_chunks = -(-n_bits // w)
        # chunk-constant planes broadcast as one word per block (zero
        # padding makes a ragged last chunk differ, disabling the
        # collapse)
        const = {name: n_chunks > 1 and bool((ch == ch[0]).all())
                 for name, ch in chunks.items()}
        blk_sz = self._block_size(n_chunks)
        pieces: dict[str, list[torch.Tensor]] = {k: [] for k in prog.outputs}
        chain = self.policy.is_resident and self.chain_blocks
        sessions: dict[tuple[int, int], CC.ResidentSession] = {}
        shared = None       # bank-0 adjudicated decisions, non-chained

        def bank0_fixed():
            """Frozen scheduler decisions for sibling-bank replay: taken
            from a bank-0 session that already planned, else computed
            once on bank 0's scalar isa (memoized in _SCHED_CACHE)."""
            for (b, _t), s in sessions.items():
                if b == 0 and s._fixed is not None:
                    return s._fixed
            return CC.shared_schedule_decisions(prog, self._array.isa(0),
                                                pin_inputs=chain)

        for j, lo in enumerate(range(0, n_chunks, blk_sz)):
            t = min(blk_sz, n_chunks - lo)
            bank = j % self.banks
            ins = {name: (ch[0] if const[name]
                          else ch[lo] if t == 1 else ch[lo:lo + t])
                   for name, ch in chunks.items()}
            isa = self._isa_for(t, bank=bank,
                                recycle=not (chain and (bank, t) in
                                             sessions))
            before = self._log_snapshot(isa.sim)
            if chain:
                sess = sessions.get((bank, t))
                if sess is None:
                    fixed = None
                    if (bank != 0
                            and self.policy is ResidentPolicy.SCHEDULED):
                        fixed = bank0_fixed()
                    sess = sessions[(bank, t)] = CC.ResidentSession(
                        prog, isa, policy=self.policy.value, fixed=fixed,
                        verify=self.verify)
                res = sess.run(ins)
            else:
                plan = None
                if (bank != 0
                        and self.policy is ResidentPolicy.SCHEDULED):
                    if shared is None:
                        shared = bank0_fixed()
                    plan = CC.schedule_resident(prog, isa,
                                                policy="scheduled",
                                                verify=self.verify,
                                                _fixed=shared)
                res = CC.run_sim(prog, ins, isa, resident=self.policy,
                                 plan=plan)
            if t == 1:
                res = {k: v[None] for k, v in res.items()}
            else:       # (w,) pass-through of a broadcast input -> (t, w)
                res = {k: (v.expand(t, w) if v.dim() == 1 else v)
                       for k, v in res.items()}
            self._account_sim_log(isa.sim, before, bank=bank)
            for name in pieces:
                pieces[name].append(res[name])
        return {name: self._pack_result(ps, r, c)
                for name, ps in pieces.items()}

    # ------------- DRAM backend plumbing -------------
    def _block_size(self, n_chunks: int) -> int:
        """Chunks per batched episode: capped by DRAM_CHUNK_BATCH, and
        small enough that a plane sweeps >= DRAM_MIN_PAIR_SWEEP activation
        pairs (one per block) when it has that many chunks."""
        target = max(1, -(-n_chunks // self.DRAM_MIN_PAIR_SWEEP))
        return min(self.DRAM_CHUNK_BATCH, target)

    @staticmethod
    def _to_chunks(bits: torch.Tensor, w: int) -> torch.Tensor:
        """(..., B) bit vector -> (..., C, w) zero-padded row chunks."""
        n_bits = bits.shape[-1]
        n_chunks = -(-n_bits // w)
        pad = n_chunks * w - n_bits
        if pad:
            bits = torch.nn.functional.pad(bits, (0, pad))
        return bits.reshape((*bits.shape[:-1], n_chunks, w))

    def _dram_blocks(self, chunks: torch.Tensor, run) -> list:
        """Run ``run(isa, block)`` over the chunk blocks of ``chunks`` (the
        chunk axis second to last), block j on bank ``j % banks``, each
        command-log delta booked into the report; -> result pieces, each
        ``(C', w)``."""
        n_chunks = chunks.shape[-2]
        blk_sz = self._block_size(n_chunks)
        pieces = []
        for j, lo in enumerate(range(0, n_chunks, blk_sz)):
            blk = chunks[..., lo:lo + blk_sz, :]
            bank = j % self.banks
            isa = self._isa_for(blk.shape[-2], bank=bank)
            before = self._log_snapshot(isa.sim)
            pieces.append(run(isa, blk))
            self._account_sim_log(isa.sim, before, bank=bank)
        return pieces

    def _dram_nary(self, planes: torch.Tensor, op: str) -> torch.Tensor:
        n, r, c = planes.shape
        bits = kops.unpack_bits(planes).reshape(n, r * c * 32)
        chunks = self._to_chunks(bits, self._isa.width)     # (n, C, w)

        def run(isa, blk):                                  # (n, C', w)
            if blk.shape[1] == 1:
                return isa.nary_op(op, list(blk[:, 0]))[None]
            return isa.nary_op(op, blk)
        return self._pack_result(self._dram_blocks(chunks, run), r, c)

    def _dram_not(self, plane: torch.Tensor) -> torch.Tensor:
        r, c = plane.shape
        bits = kops.unpack_bits(plane).reshape(r * c * 32)
        chunks = self._to_chunks(bits, self._isa.width)     # (C, w)

        def run(isa, blk):                                  # (C', w)
            if blk.shape[0] == 1:
                return isa.op_not(blk[0])[None]
            return isa.op_not(blk)
        return self._pack_result(self._dram_blocks(chunks, run), r, c)

    @staticmethod
    def _pack_result(pieces: list, r: int, c: int) -> torch.Tensor:
        out = torch.cat(pieces, dim=0).reshape(-1)[:r * c * 32]
        return kops.pack_bits(out.reshape(r, c * 32))
