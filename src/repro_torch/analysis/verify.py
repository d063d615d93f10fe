"""Static verification of Programs and ResidentPlans.

:func:`verify_program` checks SSA well-formedness of a compiled
:class:`~repro_torch.core.compiler.Program`; :func:`verify_plan` replays a
:class:`~repro_torch.core.compiler.ResidentPlan`'s micro-ops *symbolically* —
a physical twin of ``compiler._ResidentExec`` that tracks what word each
(subarray-side, row) holds instead of executing commands — and reports
structured :class:`~repro_torch.analysis.Finding` records for every liveness,
aliasing, or polarity defect, plus an exact reconciliation of the plan's
command-stream tally and ``expected_log`` against the replay.

Rule IDs (stable; tests and gates match on these, never on messages):

=====================  ====================================================
``PROG-SSA-MULTI``     a register is assigned by more than one instruction
``PROG-SSA-UNDEF``     an operand register is used before it is defined
``PROG-ARITY``         op arity outside the legal range (n-ary ops are
                       2..16 inputs per the paper's N:N activation cap)
``PROG-OP-UNKNOWN``    an op mnemonic outside the compiler's ISA
``PROG-OUT-UNDEF``     a program output names an undefined register
``PLAN-ROW-ALIAS``     a read finds another register's word (two live
                       values mapped onto one physical row), or a write
                       source stages the wrong register
``PLAN-USE-AFTER-EVICT``  a read of a row nothing ever wrote (or a host
                       word the host does not know)
``PLAN-CLONE-CLOBBER`` a RowClone source was already overwritten by this
                       step's own staging (pending activation pattern)
``PLAN-POLARITY``      right value, wrong De Morgan polarity — producer
                       form vs consumer expectation, or a flipped const
``PLAN-PIN-CONFLICT``  pinned input-word rows collide or do not hold the
                       pinned word at end of plan
``PLAN-OUTPUT-MISSING`` a program output has no (or a mismatched) output
                       step / assignment
``PLAN-LOG-MISMATCH``  the plan's command tally or expected_log does not
                       reconcile with the symbolic replay
=====================  ====================================================
"""
from __future__ import annotations

from ..core.isa import CostModel
from . import ERROR, Finding

__all__ = ["verify_program", "verify_plan", "PlanVerificationError"]

#: ops a Program may contain (the compiler's full ISA)
_KNOWN_OPS = ("input", "const", "not", "and", "or", "nand", "nor")
#: paper cap: simultaneous N:N activation expresses up to 16 inputs
_MAX_FANIN = 16


class PlanVerificationError(RuntimeError):
    """Raised by ``schedule_resident(verify=True)`` on ERROR findings."""

    def __init__(self, findings):
        self.findings = list(findings)
        lines = "\n".join(f"  {f}" for f in self.findings[:20])
        super().__init__(
            f"plan verification failed with {len(self.findings)} "
            f"finding(s):\n{lines}")


# ---------------------------------------------------------------------------
# Program SSA verification
# ---------------------------------------------------------------------------
def verify_program(prog) -> list[Finding]:
    """SSA well-formedness of a compiled Program.

    Checks single assignment, defined-before-use, op arity (n-ary
    Boolean ops take 2..16 operands, NOT exactly one, leaves none), op
    mnemonics, and that every output names a defined register.
    """
    findings: list[Finding] = []
    defined: set[int] = set()
    for k, i in enumerate(prog.instrs):
        site = (k, i.op, i.dst)
        if i.op not in _KNOWN_OPS:
            findings.append(Finding("PROG-OP-UNKNOWN", ERROR, site,
                                    f"unknown op {i.op!r}"))
            continue
        for s in i.srcs:
            if s not in defined:
                findings.append(Finding(
                    "PROG-SSA-UNDEF", ERROR, site,
                    f"operand r{s} used before definition"))
        if i.dst in defined:
            findings.append(Finding(
                "PROG-SSA-MULTI", ERROR, site,
                f"register r{i.dst} assigned more than once"))
        defined.add(i.dst)
        n = len(i.srcs)
        if i.op in ("input", "const"):
            ok = n == 0
        elif i.op == "not":
            ok = n == 1
        else:
            ok = 2 <= n <= _MAX_FANIN
        if not ok:
            findings.append(Finding(
                "PROG-ARITY", ERROR, site,
                f"{i.op} with {n} operand(s) (paper cap: "
                f"{_MAX_FANIN}-input N:N activation)"))
    for name, r in prog.outputs.items():
        if r not in defined:
            findings.append(Finding(
                "PROG-OUT-UNDEF", ERROR, ("output", name, r),
                f"output {name!r} names undefined register r{r}"))
    return findings


# ---------------------------------------------------------------------------
# ResidentPlan symbolic replay
# ---------------------------------------------------------------------------
def _canon(prog):
    """Canonical word identity per register: ``reg -> (root, parity)``.

    A NOT's destination is its source's root with the parity flipped
    (the planner freely re-tags a NOT's restored f-side rows as either
    ``("val", src)`` or ``("neg", dst)`` — the same physical word), so
    word equality must be judged on the canonical form.  ``const``
    registers additionally resolve to their literal value, unifying
    register words with planner-filled constant rows.
    """
    canon: dict[int, tuple[int, int]] = {}
    const_val: dict[int, int] = {}
    for i in prog.instrs:
        if i.op == "not" and i.srcs and i.srcs[0] in canon:
            root, par = canon[i.srcs[0]]
            canon[i.dst] = (root, par ^ 1)
        else:
            canon[i.dst] = (i.dst, 0)
        if i.op == "const":
            const_val[i.dst] = int(bool(i.value))

    def word_of(reg: int, neg: bool):
        root, par = canon.get(reg, (reg, 0))
        p = par ^ int(neg)
        if root in const_val:
            return ("const", const_val[root] ^ p)
        return ("w", root, p)

    return word_of


class _Replay:
    """Symbolic physical state: what word each (side, row) holds."""

    def __init__(self, prog, plan, word_of):
        self.plan = plan
        self.word_of = word_of
        self.findings: list[Finding] = []
        #: (side, row) -> ("w", root, parity) | ("const", v) | ("frac",)
        self.rows: dict[tuple[str, int], tuple] = {}
        self.host: set[int] = set()
        # independent recount, mirroring the executor's command stream
        # (clone_word's src == dst no-op included)
        self.wr = self.rd = self.rc = self.frac = self.apa = self.acts = 0
        self.apa_events: list[tuple[int, bool]] = []   # (n_acts, not?)

    def emit(self, rule, site, msg):
        self.findings.append(Finding(rule, ERROR, site, msg))

    def read(self, side, row, expected, site, *, staged=None):
        """Check that (side, row) holds ``expected``; return the actual
        content (symbolic execution continues on the real state).
        ``staged`` is the set of rows this step already overwrote — a
        source inside it is a clone-clobber, not a liveness bug."""
        key = (side, int(row))
        actual = self.rows.get(key)
        if staged is not None and key in staged:
            self.emit("PLAN-CLONE-CLOBBER", site,
                      f"clone source {key} already overwritten by this "
                      f"step's staging")
            return actual
        if actual == expected:
            return actual
        if actual is None:
            self.emit("PLAN-USE-AFTER-EVICT", site,
                      f"read of {key}, which holds no live word")
        elif (actual[0] == "w" and expected[0] == "w"
                and actual[1] == expected[1]) \
                or (actual[0] == "const" and expected[0] == "const"):
            self.emit("PLAN-POLARITY", site,
                      f"{key} holds {actual}, expected {expected} "
                      f"(wrong polarity)")
        else:
            self.emit("PLAN-ROW-ALIAS", site,
                      f"{key} holds {actual}, expected {expected}")
        return actual

    def host_word(self, reg, neg, site):
        if reg not in self.host:
            self.emit("PLAN-USE-AFTER-EVICT", site,
                      f"host word r{reg} staged but never host-known")
        return self.word_of(reg, neg)


def _replay_pre(rp: _Replay, st, si):
    """Replay one step's ordered pre micro-ops."""
    for mi, m in enumerate(st.pre):
        site = (si, "pre", mi, m[0])
        if m[0] == "reloc":
            _, side, src, dst = m
            content = rp.rows.get((side, int(src)))
            if content is None:
                rp.emit("PLAN-USE-AFTER-EVICT", site,
                        f"relocation of dead row ({side}, {src})")
            else:
                rp.rows[(side, int(dst))] = content
            if int(src) != int(dst):    # clone_word no-op otherwise
                rp.rc += 1
            # the RowClone restores its source; the activation overwrites
            # it later, so the content stays live until then
        elif m[0] == "fill":
            _, side, row, v = m
            rp.rows[(side, int(row))] = ("const", int(v))
            rp.wr += 1
        elif m[0] == "spill":
            _, reg, side, row, negf = m
            rp.read(side, row, rp.word_of(reg, negf), site)
            rp.host.add(reg)
            rp.rd += 1
        elif m[0] == "park":
            _, reg, row, negf = m
            rp.rows[("l", int(row))] = rp.host_word(reg, negf, site)
            rp.wr += 1
        else:
            rp.emit("PLAN-LOG-MISMATCH", site, f"unknown micro-op {m!r}")


def _replay_bool(rp: _Replay, st, si):
    i = st.instr
    base = "and" if i.op in ("and", "nand") else "or"
    want_exec = ("or" if base == "and" else "and") if st.demorgan else base
    if st.exec_op != want_exec:
        rp.emit("PLAN-POLARITY", (si, "exec_op"),
                f"{i.op} with demorgan={st.demorgan} must execute "
                f"{want_exec!r}, plan says {st.exec_op!r}")
    rows_f = [int(r) for r in st.act.rows_f]
    rows_l = [int(r) for r in st.act.rows_l]
    cval = 1 if st.exec_op == "and" else 0
    staged: set[tuple[str, int]] = set()
    # reference block: ref_row clones into rows_f[:-1] (host fill when the
    # plan carries no resident constant row), then Frac
    if st.ref_row is None:
        rp.wr += len(rows_f) - 1
        for r in rows_f[:-1]:
            rp.rows[("f", r)] = ("const", cval)
            staged.add(("f", r))
    else:
        rp.read("f", st.ref_row, ("const", cval),
                (si, "ref", int(st.ref_row)))
        for r in rows_f[:-1]:
            if r != int(st.ref_row):
                rp.rc += 1
            rp.rows[("f", r)] = ("const", cval)
            staged.add(("f", r))
    rp.rows[("f", rows_f[-1])] = ("frac",)
    staged.add(("f", rows_f[-1]))
    rp.frac += 1
    # compute block: clones issue in order, host writes batch afterwards
    srcs = list(i.srcs)
    if len(st.sources) != len(rows_l):
        rp.emit("PLAN-LOG-MISMATCH", (si, "sources"),
                f"{len(st.sources)} sources for {len(rows_l)} compute rows")
    writes: list[tuple[int, tuple]] = []
    for k, src in enumerate(st.sources):
        expected = (rp.word_of(srcs[k], st.demorgan) if k < len(srcs)
                    else ("const", 1 if st.exec_op == "and" else 0))
        site = (si, "source", k)
        if src[0] == "clone":
            actual = rp.read("l", src[1], expected, site, staged=staged)
            if src[1] != rows_l[k]:
                rp.rc += 1
            rp.rows[("l", rows_l[k])] = (actual if actual is not None
                                         else expected)
            staged.add(("l", rows_l[k]))
        else:
            _, reg, negf = src
            word = rp.host_word(reg, negf, site)
            if word != expected:
                rule = ("PLAN-POLARITY"
                        if word[0] == expected[0] == "w"
                        and word[1] == expected[1] else "PLAN-ROW-ALIAS")
                rp.emit(rule, site,
                        f"write source stages {word}, expected {expected}")
            writes.append((rows_l[k], word))
            rp.wr += 1
    for row, word in writes:
        rp.rows[("l", row)] = word
    # the APA: all l rows take the result word, all f rows its complement
    val_on_l = (i.op in ("nand", "nor")) == st.demorgan
    for r in rows_l:
        rp.rows[("l", r)] = rp.word_of(i.dst, not val_on_l)
    for r in rows_f:
        rp.rows[("f", r)] = rp.word_of(i.dst, val_on_l)
    rp.apa += 1
    rp.acts += st.act.n_rf + st.act.n_rl
    rp.apa_events.append((st.act.n_rf + st.act.n_rl, False))


def _replay_not(rp: _Replay, st, si):
    i = st.instr
    x = i.srcs[0]
    rows_f = [int(r) for r in st.act.rows_f]
    rows_l = [int(r) for r in st.act.rows_l]
    if len(st.sources) != 1:
        rp.emit("PLAN-LOG-MISMATCH", (si, "sources"),
                f"NOT step with {len(st.sources)} sources")
    src = st.sources[0]
    site = (si, "source", 0)
    if src[0] == "clone":
        # the plan does not record whether the clone staged the value or
        # its f-resident complement (the flipped case): infer from the
        # replayed content, defaulting to the straight form on a miss
        actual = rp.rows.get(("f", int(src[1])))
        if actual == rp.word_of(x, True):
            staged_word = actual
        else:
            staged_word = rp.read("f", src[1], rp.word_of(x, False), site)
            if staged_word is None:
                staged_word = rp.word_of(x, False)
        for r in rows_f:
            if r != int(src[1]):
                rp.rc += 1
            rp.rows[("f", r)] = staged_word
    else:
        _, reg, negf = src
        staged_word = rp.host_word(reg, negf, site)
        if reg != x and staged_word != rp.word_of(x, negf):
            rp.emit("PLAN-ROW-ALIAS", site,
                    f"NOT stages r{reg}, instruction reads r{x}")
        for r in rows_f:
            rp.rows[("f", r)] = staged_word
        rp.wr += st.act.n_rf
    # NOT protocol: f rows keep the restored source word, l rows take its
    # complement (the flipped-source case lands the polarities swapped,
    # which the staged_word bookkeeping above already encodes)
    neg_word = _negate(staged_word)
    for r in rows_l:
        rp.rows[("l", r)] = neg_word
    rp.apa += 1
    rp.acts += st.act.n_rf + st.act.n_rl
    rp.apa_events.append((st.act.n_rf + st.act.n_rl, True))


def _negate(word):
    if word is None:
        return None
    if word[0] == "w":
        return ("w", word[1], word[2] ^ 1)
    if word[0] == "const":
        return ("const", word[1] ^ 1)
    return word      # frac complements to frac


def _check_pins(rp: _Replay, prog, plan):
    name_reg = {i.name: i.dst for i in prog.instrs if i.op == "input"}
    seen: dict[int, str] = {}
    for name, locs in dict(plan.pins or {}).items():
        reg = name_reg.get(name)
        if reg is None:
            rp.emit("PLAN-PIN-CONFLICT", ("pin", name),
                    f"pin for unknown input {name!r}")
            continue
        for row, negf in locs:
            row = int(row)
            if row in seen:
                rp.emit("PLAN-PIN-CONFLICT", ("pin", name, row),
                        f"pinned row {row} already pinned by "
                        f"{seen[row]!r}")
            seen[row] = name
            actual = rp.rows.get(("l", row))
            if actual != rp.word_of(reg, negf):
                rp.emit("PLAN-PIN-CONFLICT", ("pin", name, row),
                        f"pinned row l/{row} holds {actual}, pin "
                        f"promises {rp.word_of(reg, negf)}")


def _check_log(rp: _Replay, plan):
    got = {"WR": rp.wr, "RD": rp.rd, "RC": rp.rc, "FRAC": rp.frac,
           "APA": rp.apa}
    want = plan.command_counts()
    if got != want or rp.acts != plan.acts:
        rp.emit("PLAN-LOG-MISMATCH", ("tally",),
                f"plan tallies {want} (acts={plan.acts}), symbolic "
                f"replay issues {got} (acts={rp.acts})")
        return
    # exact expected_log reconciliation: same arithmetic, independent
    # event stream (per-step APA activation counts from the replay)
    cm = CostModel(plan.module, row_bits=plan.row_bits)
    t = e = 0.0
    for n, (ct, ce) in ((rp.wr, cm.log_write()), (rp.rd, cm.log_read()),
                        (rp.rc, cm.log_rowclone()),
                        (rp.frac, cm.log_frac())):
        t += n * ct
        e += n * ce
    for n_acts, is_not in rp.apa_events:
        ct, ce = cm.log_apa(n_acts, first_restored=is_not)
        t += ct
        e += ce
    if (t, e) != plan.expected_log(cm):
        rp.emit("PLAN-LOG-MISMATCH", ("expected_log",),
                f"plan.expected_log() = {plan.expected_log(cm)}, "
                f"replay predicts {(t, e)}")


def verify_plan(prog, plan, *, carry: dict | None = None,
                pins: dict | None = None) -> list[Finding]:
    """Row-liveness race detection + log reconciliation of one plan.

    ``carry``/``pins`` are the *pre-state* the plan was scheduled
    against (the same arguments the planner received): carried constant
    rows ``{(side, v): row}`` and pinned input words
    ``{reg: ((l_row, is_complement), ...)}``.  Session replans must pass
    them or carried-row reads report as use-after-evict.

    Returns the (possibly empty) finding list; see the module docstring
    for the rule table.  Program-level SSA findings are included first —
    a malformed program makes the replay's expectations meaningless.
    """
    findings = verify_program(prog)
    if findings:
        return findings
    word_of = _canon(prog)
    rp = _Replay(prog, plan, word_of)
    for (side, v), row in dict(carry or {}).items():
        rp.rows[(side, int(row))] = ("const", int(v))
    for reg, locs in dict(pins or {}).items():
        for row, negf in locs:
            rp.rows[("l", int(row))] = word_of(reg, negf)
    outputs_seen: set[str] = set()
    for si, st in enumerate(plan.steps):
        if st.kind == "host":
            rp.host.add(st.instr.dst)
            continue
        if st.kind == "output":
            outputs_seen.add(st.name)
            if st.name not in prog.outputs \
                    or prog.outputs[st.name] != st.reg:
                rp.emit("PLAN-OUTPUT-MISSING", (si, "output", st.name),
                        f"output step {st.name!r} does not match the "
                        f"program's outputs")
                continue
            if plan.assignments.get(st.name) != st.where:
                rp.emit("PLAN-OUTPUT-MISSING", (si, "output", st.name),
                        f"assignment {plan.assignments.get(st.name)} "
                        f"!= step where {st.where}")
            if st.where[0] == "host":
                if st.reg not in rp.host:
                    rp.emit("PLAN-USE-AFTER-EVICT",
                            (si, "output", st.name),
                            f"host output r{st.reg} never host-known")
            else:
                side, row, negf = st.where
                rp.read(side, row, word_of(st.reg, negf),
                        (si, "output", st.name))
                rp.rd += 1
            continue
        _replay_pre(rp, st, si)
        if st.kind == "bool":
            _replay_bool(rp, st, si)
        elif st.kind == "not":
            _replay_not(rp, st, si)
        else:
            rp.emit("PLAN-LOG-MISMATCH", (si,),
                    f"unknown step kind {st.kind!r}")
    for name in prog.outputs:
        if name not in outputs_seen:
            rp.emit("PLAN-OUTPUT-MISSING", ("output", name),
                    f"no output step for {name!r}")
    _check_pins(rp, prog, plan)
    _check_log(rp, plan)
    return rp.findings
