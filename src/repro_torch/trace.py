"""Spans and counters of the Monte-Carlo host path and of the serving
engine.

Tracing is on exactly while a ``torch.profiler`` profile records
(``torch.autograd.profiler._is_profiler_enabled``); nothing else turns it
on.  While it is on:

* :func:`span` records a host range in the profile that traces the device,
  on the same clock.  It is a function-scope range
  (``RecordFunctionFast``), which the profiler keeps on the host timeline;
  ``torch.profiler.record_function`` would also add an annotation to the
  device's timeline.
* :func:`root` (or the :func:`rooted` decorator) opens one record per
  entry-point call; :func:`count` and :func:`to_device` add into the open
  root's record, and each finished root appends ``{"name", "counts"}`` to
  a bounded list that :func:`calls` returns.

While it is off, a span is one flag check that returns a shared no-op
context manager, a counter call does nothing, and no record is kept.

The spans of one MC call (``charz.mc_boolean_success`` /
``mc_not_success``), and how often each opens::

    pud.mc.boolean | pud.mc.not   the root, once
      pud.chip                    BankArray, BankSim / PudIsa and fused
                                  ISA construction (once each)
        pud.inventory             one PairInventory build (a cache hit
                                  opens none)
      pud.pairs                   _stratified_pairs, once per bank
      pud.operands                one group's (fused round's) operands,
                                  and the loop's slot recycling
      pud.apa                     PudIsa.nary_op / op_not, once per group
        pud.apa.plan              twice: the ISA's pair choice and
                                  decoder activation, then the bank's
                                  activation, slot maps and indices
        pud.apa.stage             reference fill, Frac, operand scatter
        pud.apa.opctx             the float64 op-context sum and its read
                                  (Boolean APAs only)
        pud.apa.resolve           the sense-amp launch or the NOT drive
        pud.apa.writeback         the result written back to both sides
        pud.apa.readout           the result word's read and unpack
      pud.score                   _want_nary and _hits, once per group

Counters: ``reads.opctx`` and ``reads.score`` (host reads of device data,
at their sites), ``scatter_bytes`` (bytes written into the slot buffers by
row index) and ``h2d_copies`` (copies of host arrays to the bank's
device, counted at the call site on a CPU device too, where they copy
nothing).

The spans of one ``ServeEngine.run`` (``serve/engine.py``)::

    serve.run                     the root, once
      serve.prefill               one prefill forward of one or more
                                  admitted requests and their first
                                  samples (ends at that host read)
        moe.route, moe.dispatch,  each MoE layer of an eager call
        moe.experts, moe.combine  (models/moe.py)
        ssm.scan                  each chunked Mamba-2 mixer call
                                  (kernels/ssd.py), kernels or plain
      serve.decode                one decode step, to its host read of the
                                  greedy tokens

A decode step replayed as a CUDA graph opens no span inside it (on the
CPU the step runs eagerly and opens the layers' spans too).  Counters:
``serve.prompt_tokens``, ``serve.prefill_forwards`` (one a prefill
forward), ``serve.decode_tokens`` (tokens the decode steps emitted),
``serve.steps``, ``ssm.scan_kernel`` / ``ssm.scan_plain`` (one a chunked
mixer call, by the path it took), ``ssm.step_kernel`` / ``ssm.step_plain``
(one a recurrent Mamba-2 step, by path: a decode step's counts are taken
once, under :func:`tally`, where the decode graph is captured, and
``ServeEngine.step`` adds them each step), and, read once per run from the
grouped expert product's device ring (``kernels/moe_grouped.py``, which graph
replays write too), ``moe.launches``, ``moe.experts`` and ``moe.rows``
summed, with each launch's ``(experts with rows, rows)`` under the
record's ``lists["moe.launch"]`` (:func:`note`).
"""
from __future__ import annotations

import contextlib
import functools
from collections import Counter, deque

import numpy as np
import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

#: finished roots kept at most; the oldest drop first
MAX_CALLS = 4096

_OFF = contextlib.nullcontext()
#: the open root's counts, or None
_open: Counter | None = None
#: the open root's lists (:func:`note`)
_lists: dict = {}
#: the counts :func:`tally` is collecting, or None
_tally: Counter | None = None
_calls: deque = deque(maxlen=MAX_CALLS)


def span(name: str):
    """A context manager recording ``name`` as a host range while tracing
    is on; a shared no-op otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


class _Root:
    """One entry-point call's span and the record its counters add into."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = _RecordFunctionFast(name)

    def __enter__(self):
        global _open
        _open = Counter()
        _lists.clear()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        global _open
        self._range.__exit__(*exc)
        rec = {"name": self.name, "counts": dict(_open)}
        if _lists:
            rec["lists"] = dict(_lists)
            _lists.clear()
        _calls.append(rec)
        _open = None
        return False


def on() -> bool:
    """Tracing is on: a profile records."""
    return bool(_profiler._is_profiler_enabled)


def root(name: str):
    """The span of one entry-point call, with its record of counts while
    tracing is on; inside another root, a plain span counting into that
    root's record."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if _open is not None:
        return _RecordFunctionFast(name)
    return _Root(name)


def _wrapped(opener, name: str):
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with opener(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def rooted(name: str):
    """Decorate an entry point: each call runs inside ``root(name)``."""
    return _wrapped(root, name)


def spanned(name: str):
    """Decorate a function: each call runs inside ``span(name)``."""
    return _wrapped(span, name)


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to counter ``key`` of the open :func:`tally`, else of the
    open root, if any."""
    if _tally is not None:
        _tally[key] += n
    elif _open is not None:
        _open[key] += n


@contextlib.contextmanager
def tally():
    """Collect the counts made inside into a Counter of their own (yielded),
    tracing on or off, and keep them out of the open root's record: what a
    CUDA graph's capture counts, each replay would count again without
    running any Python."""
    global _tally
    outer, _tally = _tally, Counter()
    try:
        yield _tally
    finally:
        _tally = outer


def note(key: str, values: list) -> None:
    """Keep ``values`` under ``lists[key]`` of the open root's record, if
    any."""
    if _open is not None:
        _lists[key] = list(values)


def to_device(a, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A host array copied to ``device`` (and cast to ``dtype``), counted
    as one ``h2d_copies``."""
    if _open is not None:
        _open["h2d_copies"] += 1
    t = torch.from_numpy(np.asarray(a))
    return t.to(device) if dtype is None else t.to(device, dtype)


def calls() -> list[dict]:
    """The records of the roots finished while tracing was on, oldest
    first: ``{"name": root span, "counts": {counter: value}}``, and
    ``"lists"`` where :func:`note` kept some."""
    return list(_calls)


def clear() -> None:
    """Forget every finished root's record."""
    _calls.clear()
