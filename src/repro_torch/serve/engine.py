"""Batched serving engine of the port: prefill + decode with slot-based
continuous batching (``repro.serve.engine`` on torch).

* fixed decode **slots** (the serving batch); requests are admitted into
  free slots, each slot carrying its own position counter;
* **prefill** runs the prompt through every layer and writes the slot's
  caches, eagerly; **decode** advances all slots one token per step with
  one :func:`~repro_torch.models.transformer.decode_step`, captured once
  as a CUDA graph at construction and replayed every step
  (:class:`~repro_torch.serve.graph.DecodeGraph`: the reference's jitted
  ``decode_step``; on the CPU the same call runs eagerly);
* sampling: greedy (the reference's tokens), read from the step's greedy
  tokens with one device-to-host copy a step, or temperature from a
  ``torch.Generator`` seeded per (seed, request, step) with the
  reference's formula — deterministic, but not jax's bits — on the step's
  logits before the next step overwrites them.

The caches live on the engine's device and are written in place: a
prefill gets the engine's caches with the batch rows of its slots
(:meth:`ServeEngine._slot_caches`: K/V and positions, SSM state and conv
window, each part carrying a ``"rows"`` index) and writes those rows
directly, which is what the reference's ``_write_slot`` does after its
functional prefill.  SSM and hybrid architectures prefill right-padded to
a multiple of ``ssm_chunk``: the pads get the sentinel position and a
``valid`` mask keeps them out of the SSM state (the reference's exact
padded prefill).

The requests admitted at one step (a wave) prefill in batched forwards:
sorted by padded length and cut into groups whose rows times longest
padded length stay within ``prefill_tokens`` (``max_prompt``, the
engine's bound on one prefill), one ``(rows, S)`` forward a group, each
row right-padded to the group's length with its own ``valid`` row and
positions, one host read of the rows' greedy tokens.  Which requests are
admitted, when, and into which slots stays as with one request a forward.
A config whose prefill couples the rows of a batch (a capacity-bounded MoE
dispatch drops pairs by the batch's token count) has ``prefill_tokens``
0: one request a forward.

A cross-attention (VLM) config raises ``NotImplementedError``: the
reference engine cannot serve one (its prefill scans only
``params["blocks"]`` and its decode passes no ``image_embeds``; ROADMAP
C-9), and the port does not invent a VLM serving path it lacks.

The engine keeps host-clock walls: ``prefill_s`` (one per admitted
request, the wall of the forward that prefilled it and of its first
samples) and ``decode_s`` (one per step, decode + samples); each ends at
the host read of sampled tokens, which waits for the device;
``prefill_groups`` holds the request ids of each prefill forward.  While
a profile records, :meth:`ServeEngine.run` is a ``serve.run`` root with a
``serve.prefill`` span per prefill forward and a ``serve.decode`` span per
step, and its counters (:mod:`repro_torch.trace`).  ``keep_logits``:
request ids whose logits (the prefill's last row and every decode step's)
are copied to the host as float32, in ``logits[rid]``, and the expert
choice of every MoE layer at each position they fed (the prompt's, then
each decode step's), in ``routes[rid]`` as ``(MoE layers, positions, K)``
pieces — a check's rerun, not the served path.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import trace
from ..core.simulator import resolve_device
from ..kernels import moe_grouped
from ..models import layers as L
from ..models import moe as MOE
from ..models import transformer as T
from ..models.config import ModelConfig
from .graph import DecodeGraph


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False


def _prefill_fn(params, cfg: ModelConfig, tokens: torch.Tensor,
                valid: torch.Tensor, caches: list[dict]):
    """tokens, valid: (B, S) -> (logits at each row's last valid position
    (B, V), caches written in place).  Pads get the sentinel position, so
    their keys are never attended, and ``valid`` keeps them out of the SSM
    state.  Only the last valid position is unembedded (the reference
    unembeds every position and keeps that one: the same row-wise
    values)."""
    real_pos = torch.clamp(torch.cumsum(valid.int(), dim=1) - 1, min=0)
    positions = torch.where(valid, real_pos, L.POS_SENTINEL).int()
    x = L.embed(params["embed"], cfg, tokens)
    x, _aux = T.run_blocks(params, cfg, x, positions, caches, valid=valid)
    last = valid.int().sum(1) - 1                                # (1,)
    x_last = x[torch.arange(x.shape[0], device=x.device), last]
    return L.unembed(T.unembed_table(params, cfg), cfg, x_last), caches


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 max_len: int = 512, seed: int = 0,
                 cache_dtype: torch.dtype = torch.float32,
                 device="cuda"):
        if cfg.cross_attn_every:
            raise NotImplementedError(
                f"{cfg.name}: the reference engine cannot serve a "
                f"cross-attention config (its prefill scans only the self "
                f"blocks and its decode passes no image_embeds; ROADMAP "
                f"C-9)")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.seed = seed
        self.device = resolve_device(device)
        self.caches = T.init_caches(cfg, n_slots, max_len, dtype=cache_dtype,
                                    device=self.device)
        # built before any prefill: its warm-up is undone, so the caches
        # keep init_caches's values
        self.graph = DecodeGraph(params, cfg, self.caches, n_slots,
                                 device=self.device)
        self.chunk = cfg.ssm_chunk if cfg.has_ssm else 1
        #: the longest prompt a prefill can write (None: no KV cache, no
        #: limit): the KV cache's slots (a sliding window's ring) rounded
        #: down to the SSM chunk — the reference's prefill writes its whole
        #: padded block at slot 0 and fails past that too (ROADMAP C-10)
        self.max_prompt = None
        if cfg.n_attention_layers:
            slots = min(max_len, cfg.sliding_window or max_len)
            self.max_prompt = slots // self.chunk * self.chunk
        #: the most padded tokens (rows × the longest padded prompt) one
        #: prefill forward of several requests holds — ``max_prompt``, or
        #: without a KV cache ``max_len`` rounded down to the SSM chunk; a
        #: request alone may take more.  0 (one request a forward) where a
        #: layer couples the rows of a batch: a capacity-bounded MoE
        #: dispatch drops pairs by the batch's token count
        self.prefill_tokens = self.max_prompt or max_len // self.chunk \
            * self.chunk
        if (cfg.moe or "moe" in cfg.layer_kinds) and cfg.capacity_factor > 0:
            self.prefill_tokens = 0
        self.slot_req: list[Request | None] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, dtype=np.int32)
        self.slot_next = np.zeros(n_slots, dtype=np.int32)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._rid = 0
        self._steps = 0
        self.prefill_s: list[float] = []
        self.decode_s: list[float] = []
        #: the request ids of each prefill forward, in order
        self.prefill_groups: list[list[int]] = []
        #: request ids whose logits are kept (None: none), and those kept
        self.keep_logits: set[int] | None = None
        self.logits: dict[int, list[torch.Tensor]] = {}
        self.routes: dict[int, list[torch.Tensor]] = {}

    # ------------- request management -------------
    def submit(self, prompt: list[int], *, max_new_tokens: int = 32,
               temperature: float = 0.0) -> int:
        if self.max_prompt is not None and len(prompt) > self.max_prompt:
            raise ValueError(f"a {len(prompt)}-token prompt does not fit "
                             f"the cache (at most {self.max_prompt}; ROADMAP "
                             f"C-10)")
        self._rid += 1
        self.queue.append(Request(self._rid, list(prompt), max_new_tokens,
                                  temperature))
        return self._rid

    def _slot_caches(self, slots: list[int]) -> list[dict]:
        """The engine's caches for a prefill of ``slots``: each part with
        its batch rows (``"rows"``), which the layers write in place."""
        rows = torch.tensor(slots, device=self.device)
        return [{kind: {**part, "rows": rows} for kind, part in c.items()}
                for c in self.caches]

    def _pad(self, n: int) -> int:
        return -(-n // self.chunk) * self.chunk

    def _groups(self, wave: list[tuple[int, Request]]
                ) -> list[list[tuple[int, Request]]]:
        """A wave's (slot, request) pairs cut into prefill forwards: sorted
        by padded length (stably), each group as long as its rows times
        its longest padded length stay within ``prefill_tokens``."""
        groups: list[list[tuple[int, Request]]] = []
        for item in sorted(wave, key=lambda it: self._pad(len(it[1].prompt))):
            s_pad = self._pad(len(item[1].prompt))
            if groups and (len(groups[-1]) + 1) * s_pad \
                    <= self.prefill_tokens:
                groups[-1].append(item)
            else:
                groups.append([item])
        return groups

    def _admit(self) -> None:
        wave = []
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                wave.append((slot, self.queue.pop(0)))
        for group in self._groups(wave):
            self._prefill(group)

    def _prefill(self, group: list[tuple[int, Request]]) -> None:
        """One forward over the group's prompts, each row right-padded to
        the longest; its slots' caches written, each request's first token
        sampled (the greedy ones read in one host read)."""
        t0 = time.perf_counter()
        slots = [slot for slot, _req in group]
        reqs = [req for _slot, req in group]
        lens = [len(req.prompt) for req in reqs]
        s_pad = self._pad(max(lens))
        with trace.span("serve.prefill"):
            tok = torch.zeros((len(reqs), s_pad), dtype=torch.int64)
            for i, req in enumerate(reqs):
                tok[i, :lens[i]] = torch.tensor(req.prompt)
            tok = tok.to(self.device)
            valid = (torch.arange(s_pad)[None]
                     < torch.tensor(lens)[:, None]).to(self.device)
            kept = [self._kept(req) for req in reqs]
            with MOE.recording() if any(kept) else \
                    contextlib.nullcontext() as routes:
                logits, _ = _prefill_fn(self.params, self.cfg, tok, valid,
                                        self._slot_caches(slots))
            for i, req in enumerate(reqs):
                if kept[i]:
                    self._keep(req, logits[i], [
                        r.reshape(len(reqs), s_pad, -1)[i, :lens[i]]
                        for r in routes])
            greedy = logits.argmax(-1).tolist()     # the group's host read
            nxt = [greedy[i] if req.temperature <= 0.0
                   else self._sample(logits[i], req)
                   for i, req in enumerate(reqs)]
        trace.count("serve.prefill_forwards")
        trace.count("serve.prompt_tokens", sum(lens))
        self.prefill_groups.append([req.rid for req in reqs])
        wall = time.perf_counter() - t0
        for slot, req, s, tok_next in zip(slots, reqs, lens, nxt,
                                          strict=True):
            req.out_tokens.append(tok_next)
            self.slot_req[slot] = req
            self.slot_pos[slot] = s
            self.slot_next[slot] = tok_next
            self.prefill_s.append(wall)

    def _kept(self, req: Request) -> bool:
        return self.keep_logits is not None and req.rid in self.keep_logits

    def _keep(self, req: Request, logits: torch.Tensor,
              routes: list[torch.Tensor]) -> None:
        """Copy a kept request's logits row and its (positions, K) expert
        choices of each MoE layer to the host."""
        self.logits.setdefault(req.rid, []).append(logits.float().cpu())
        if routes:
            self.routes.setdefault(req.rid, []).append(
                torch.stack(routes).cpu())

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        if req.temperature <= 0.0:
            return int(torch.argmax(logits))
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(self.seed * 1_000_003 + req.rid * 7919
                        + len(req.out_tokens))
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return int(torch.argmax(logits.float() / req.temperature + gumbel))

    # ------------- decode loop -------------
    def step(self) -> None:
        """Admit queued requests, then advance every active slot one token."""
        self._admit()
        active = [i for i in range(self.n_slots)
                  if self.slot_req[i] is not None]
        if not active:
            return
        t0 = time.perf_counter()
        with trace.span("serve.decode"):
            logits, greedy = self.graph.run(
                torch.from_numpy(self.slot_next[:, None]),
                torch.from_numpy(self.slot_pos[:, None]))
            greedy = greedy.tolist()            # the step's one host read
        self._steps += 1
        trace.count("serve.steps")
        trace.count("serve.decode_tokens", len(active))
        for k, n in self.graph.counts.items():     # what the step counted
            trace.count(k, n)
        for slot in active:
            req = self.slot_req[slot]
            if self._kept(req):
                self._keep(req, logits[slot, 0],
                           [r[slot:slot + 1] for r in self.graph.routes])
            nxt = greedy[slot] if req.temperature <= 0.0 \
                else self._sample(logits[slot, 0], req)
            req.out_tokens.append(nxt)
            self.slot_pos[slot] += 1
            self.slot_next[slot] = nxt
            if (len(req.out_tokens) >= req.max_new_tokens
                    or self.slot_pos[slot] >= self.max_len - 1):
                req.done = True
                self.finished.append(req)
                self.slot_req[slot] = None
        self.decode_s.append(time.perf_counter() - t0)

    def run(self, max_steps: int = 1000) -> list[Request]:
        """Step until every request has finished (or ``max_steps``):
        -> every request finished so far.  While tracing, a ``serve.run``
        root whose record also takes the grouped expert product's launch
        records of the run (one host read of the device ring)."""
        with trace.root("serve.run"):
            tracing = trace.on()
            if tracing:
                moe_grouped.reset_records(self.device)
            while (self.queue or any(r is not None for r in self.slot_req)) \
                    and max_steps > 0:
                self.step()
                max_steps -= 1
            if tracing:
                recs = moe_grouped.take_records(self.device)
                trace.count("moe.launches", len(recs))
                trace.count("moe.experts", sum(r[0] for r in recs))
                trace.count("moe.rows", sum(r[1] for r in recs))
                trace.note("moe.launch", recs)
        return self.finished
