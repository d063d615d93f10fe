"""Boolean-expression compiler for the PuD substrate: the front half.

The port of ``repro.core.compiler``'s host-side front end.  Arbitrary
Boolean expressions (and bit-serial integer arithmetic) are lowered to SSA
sequences of the paper's native PuD instructions {NOT, many-input
AND/OR/NAND/NOR} and costed at DDR4 command granularity.

Lowering rules (op counts per output word):
  NOT          -> native (1 APA)
  AND/OR, n<=16 -> native (1 APA); n>16 -> balanced tree of 16-ary ops
  NAND/NOR     -> native (free complement on the reference side)
  XOR(a,b)     -> 4 NANDs (the classic construction)
  MAJ3         -> AND, OR, AND, OR (4 ops)
  full adder   -> sum: 2 XOR = 8 ops; carry: MAJ3 = 4 ops
  K-bit adder  -> ripple-carry over bit-planes, 12K ops

Here: the ``Expr`` DSL, ``Instr`` / ``Program`` (``stats``, the modeled
``cost``), :func:`compile_expr`, the exact numpy oracle :func:`run_ideal`,
and the arithmetic and workload expression builders.  Programs run on
packed planes through ``repro_torch.pud.engine.PudEngine.run_program``.
The execution half (``run_sim``, the resident planner and
``ResidentSession``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .isa import CostModel, OpCost

MAX_FANIN = 16


# ---------------------------------------------------------------------------
# Expression DSL
# ---------------------------------------------------------------------------
class Expr:
    def __and__(self, o): return And([self, o])
    def __or__(self, o): return Or([self, o])
    def __xor__(self, o): return Xor(self, o)
    def __invert__(self): return Not(self)


@dataclass(frozen=True, eq=False)
class Var(Expr):
    name: str


@dataclass(frozen=True, eq=False)
class Const(Expr):
    value: bool


def _as_list(xs):
    return list(xs)


@dataclass(frozen=True, eq=False)
class Not(Expr):
    x: Expr


@dataclass(frozen=True, eq=False)
class And(Expr):
    xs: list


@dataclass(frozen=True, eq=False)
class Or(Expr):
    xs: list


@dataclass(frozen=True, eq=False)
class Nand(Expr):
    xs: list


@dataclass(frozen=True, eq=False)
class Nor(Expr):
    xs: list


@dataclass(frozen=True, eq=False)
class Xor(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True, eq=False)
class Maj(Expr):
    a: Expr
    b: Expr
    c: Expr


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Instr:
    """dst = op(srcs).  op in {input, const, not, and, or, nand, nor}."""

    op: str
    dst: int
    srcs: tuple[int, ...] = ()
    name: str | None = None      # for input
    value: bool | None = None    # for const


@dataclass
class Program:
    instrs: list[Instr] = field(default_factory=list)
    outputs: dict[str, int] = field(default_factory=dict)
    n_regs: int = 0

    def stats(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for i in self.instrs:
            out[i.op] = out.get(i.op, 0) + 1
        return out

    def cost(self, cm: CostModel | None = None) -> OpCost:
        """Static DDR4-command cost estimate: the per-instruction *modeled*
        cost under host-staged semantics (the reference's ``plan=`` form
        comes with the resident planner).

        >>> from repro_torch.core import compiler as CC
        >>> c = CC.compile_expr(CC.Xor(CC.Var("a"), CC.Var("b"))).cost()
        >>> c.commands > 0 and c.energy_pj > 0
        True
        """
        cm = cm or CostModel()
        total = OpCost()
        for i in self.instrs:
            if i.op in ("input", "const"):
                total = total + cm.rowclone()    # stage operand into the pair
            elif i.op == "not":
                total = total + cm.op_not(1)
            else:
                total = total + cm.boolean(len(i.srcs))
        return total


class _Builder:
    def __init__(self):
        self.prog = Program()
        self._var_reg: dict[str, int] = {}
        self._cse: dict[tuple, int] = {}

    def reg(self) -> int:
        r = self.prog.n_regs
        self.prog.n_regs += 1
        return r

    def emit(self, op: str, srcs: tuple[int, ...] = (), *, name=None,
             value=None) -> int:
        key = (op, srcs, name, value)
        if key in self._cse:
            return self._cse[key]
        r = self.reg()
        self.prog.instrs.append(Instr(op, r, srcs, name=name, value=value))
        self._cse[key] = r
        return r

    # ---- lowering ----
    def lower(self, e: Expr) -> int:
        if isinstance(e, Var):
            if e.name not in self._var_reg:
                self._var_reg[e.name] = self.emit("input", name=e.name)
            return self._var_reg[e.name]
        if isinstance(e, Const):
            return self.emit("const", value=bool(e.value))
        if isinstance(e, Not):
            return self.emit("not", (self.lower(e.x),))
        if isinstance(e, (And, Or)):
            op = "and" if isinstance(e, And) else "or"
            return self._nary(op, [self.lower(x) for x in e.xs])
        if isinstance(e, (Nand, Nor)):
            op = "nand" if isinstance(e, Nand) else "nor"
            regs = [self.lower(x) for x in e.xs]
            if len(regs) <= MAX_FANIN:
                return self.emit(op, tuple(regs))
            base = "and" if op == "nand" else "or"
            return self.emit("not", (self._nary(base, regs),))
        if isinstance(e, Xor):
            a, b = self.lower(e.a), self.lower(e.b)
            n1 = self.emit("nand", (a, b))
            n2 = self.emit("nand", (a, n1))
            n3 = self.emit("nand", (b, n1))
            return self.emit("nand", (n2, n3))
        if isinstance(e, Maj):
            a, b, c = self.lower(e.a), self.lower(e.b), self.lower(e.c)
            ab = self.emit("and", (a, b))
            a_or_b = self.emit("or", (a, b))
            c_ab = self.emit("and", (c, a_or_b))
            return self.emit("or", (ab, c_ab))
        raise TypeError(f"unknown expr {type(e)}")

    def _nary(self, op: str, regs: list[int]) -> int:
        """Balanced fan-in tree honoring the 16-input hardware limit."""
        if len(regs) == 1:
            return regs[0]
        while len(regs) > 1:
            nxt = []
            for i in range(0, len(regs), MAX_FANIN):
                chunk = regs[i:i + MAX_FANIN]
                nxt.append(self.emit(op, tuple(chunk))
                           if len(chunk) > 1 else chunk[0])
            regs = nxt
        return regs[0]


def compile_expr(outputs: dict[str, Expr] | Expr) -> Program:
    if isinstance(outputs, Expr):
        outputs = {"out": outputs}
    b = _Builder()
    for name, e in outputs.items():
        b.prog.outputs[name] = b.lower(e)
    return b.prog


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------
def run_ideal(prog: Program, inputs: dict[str, np.ndarray],
              width: int | None = None) -> dict[str, np.ndarray]:
    """Exact numpy reference semantics.

    Inputs may carry a leading trial axis ``(T, width)`` — pass ``width``
    explicitly then; consts broadcast and outputs keep the trial axis
    (*including* const-only outputs: const registers materialize at the
    full ``(T, width)`` trial shape, so every output has the same shape).
    """
    arrs = {k: np.asarray(v) for k, v in inputs.items()}
    if width is None:
        width = next(iter(arrs.values())).shape[-1]
    lead: tuple[int, ...] = ()
    for v in arrs.values():
        if v.ndim > 1:
            lead = np.broadcast_shapes(lead, v.shape[:-1])
    regs: dict[int, np.ndarray] = {}
    for i in prog.instrs:
        if i.op == "input":
            regs[i.dst] = np.asarray(arrs[i.name], dtype=np.uint8)
        elif i.op == "const":
            regs[i.dst] = np.full((*lead, width), int(i.value),
                                  dtype=np.uint8)
        elif i.op == "not":
            regs[i.dst] = 1 - regs[i.srcs[0]]
        elif i.op in ("and", "nand"):
            v = regs[i.srcs[0]].copy()
            for s in i.srcs[1:]:
                v &= regs[s]
            regs[i.dst] = (1 - v) if i.op == "nand" else v
        elif i.op in ("or", "nor"):
            v = regs[i.srcs[0]].copy()
            for s in i.srcs[1:]:
                v |= regs[s]
            regs[i.dst] = (1 - v) if i.op == "nor" else v
        else:
            raise ValueError(i.op)
    return {k: regs[r] for k, r in prog.outputs.items()}


# ---------------------------------------------------------------------------
# Arithmetic synthesis (bit-serial, LSB first)
# ---------------------------------------------------------------------------
def adder_exprs(k: int, a: str = "a", b: str = "b") -> dict[str, Expr]:
    """K-bit ripple-carry adder over bit-planes ``a0..a{k-1}``, ``b0..b{k-1}``.

    Returns sum planes ``s0..s{k-1}`` and carry-out ``cout`` — every gate
    synthesized from the paper's native op set.
    """
    outs: dict[str, Expr] = {}
    carry: Expr | None = None
    for i in range(k):
        ai, bi = Var(f"{a}{i}"), Var(f"{b}{i}")
        if carry is None:
            outs[f"s{i}"] = Xor(ai, bi)
            carry = And([ai, bi])
        else:
            t = Xor(ai, bi)
            outs[f"s{i}"] = Xor(t, carry)
            carry = Maj(ai, bi, carry)
    outs["cout"] = carry
    return outs


def popcount_exprs(n: int, var: str = "x",
                   inputs: "list[Expr] | None" = None) -> dict[str, Expr]:
    """Population count of n single-bit inputs via an adder tree
    (returns ceil(log2(n+1)) output planes).

    ``inputs`` substitutes arbitrary expressions for the default
    ``Var(f"{var}{i}")`` leaves — e.g. :func:`dot_exprs` counts pairwise
    ANDs instead of raw variables."""
    if inputs is None:
        inputs = [Var(f"{var}{i}") for i in range(n)]
    if len(inputs) != n:
        raise ValueError(f"popcount_exprs: want {n} inputs, "
                         f"got {len(inputs)}")
    # represent each input as a 1-bit number; reduce pairwise with adders
    nums: list[list[Expr]] = [[e] for e in inputs]
    tmp = 0
    while len(nums) > 1:
        nxt = []
        for i in range(0, len(nums) - 1, 2):
            x, y = nums[i], nums[i + 1]
            w = max(len(x), len(y))
            x = x + [Const(False)] * (w - len(x))
            y = y + [Const(False)] * (w - len(y))
            s: list[Expr] = []
            carry: Expr | None = None
            for j in range(w):
                if carry is None:
                    s.append(Xor(x[j], y[j]))
                    carry = And([x[j], y[j]])
                else:
                    t = Xor(x[j], y[j])
                    s.append(Xor(t, carry))
                    carry = Maj(x[j], y[j], carry)
            s.append(carry)
            nxt.append(s)
            tmp += 1
        if len(nums) % 2:
            nxt.append(nums[-1])
        nums = nxt
    return {f"c{i}": e for i, e in enumerate(nums[0])}


def dot_exprs(k: int, a: str = "a", b: str = "b") -> dict[str, Expr]:
    """Bit-serial binarized dot product: popcount of the pairwise ANDs
    ``a_i & b_i`` over k bit positions — the in-DRAM twin of the
    AND+popcount GEMM kernel (``kernels.popcount_gemm(kind="and")``).

    Inputs ``a0..a{k-1}`` / ``b0..b{k-1}``; outputs the count planes
    ``c0..c{ceil(log2(k+1))-1}`` LSB first.  Every gate (the AND layer
    and the adder tree it feeds) lowers to the paper's native op set.
    """
    return popcount_exprs(
        k, inputs=[And([Var(f"{a}{i}"), Var(f"{b}{i}")])
                   for i in range(k)])


# ---------------------------------------------------------------------------
# Workload expression builders (bloom dedup: paper SS5 many-input AND/OR)
# ---------------------------------------------------------------------------
def bloom_insert_exprs(n_hashes: int, *, acc: str = "plane",
                       var: str = "h") -> Expr:
    """Bulk bloom insert: many-input OR-accumulate of the per-hash key
    planes ``h0..h{n-1}`` onto the membership plane ``plane`` — one
    native (n+1)-ary OR up to MAX_FANIN, a balanced tree beyond."""
    return Or([Var(acc)] + [Var(f"{var}{i}") for i in range(n_hashes)])


def bloom_probe_exprs(n_hashes: int, *, var: str = "h") -> Expr:
    """Bloom membership probe: many-input AND-reduce of the gathered
    per-hash membership bits ``h0..h{n-1}`` (one bit lane per key)."""
    if n_hashes < 2:
        raise ValueError("bloom probe needs n_hashes >= 2 (a 1-hash "
                         "probe is the gathered bit itself)")
    return And([Var(f"{var}{i}") for i in range(n_hashes)])


def add_bitplanes_ideal(a_planes: np.ndarray, b_planes: np.ndarray) -> np.ndarray:
    """Oracle for the K-bit adder: planes (K, W) uint8, LSB first."""
    k, w = a_planes.shape
    av = sum((a_planes[i].astype(np.int64) << i) for i in range(k))
    bv = sum((b_planes[i].astype(np.int64) << i) for i in range(k))
    s = av + bv
    out = np.zeros((k + 1, w), dtype=np.uint8)
    for i in range(k + 1):
        out[i] = (s >> i) & 1
    return out
