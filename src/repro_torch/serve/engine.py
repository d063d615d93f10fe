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
prefill gets views of its slot's caches (:meth:`ServeEngine._slot_caches`:
K/V and positions, SSM state and conv window) and writes them directly,
which is what the reference's ``_write_slot`` does after its functional
prefill.  SSM and hybrid architectures prefill right-padded to a multiple
of ``ssm_chunk``: the pads get the sentinel position and a ``valid`` mask
keeps them out of the SSM state (the reference's exact padded prefill).

A cross-attention (VLM) config raises ``NotImplementedError``: the
reference engine cannot serve one (its prefill scans only
``params["blocks"]`` and its decode passes no ``image_embeds``; ROADMAP
C-9), and the port does not invent a VLM serving path it lacks.

The engine keeps host-clock walls: ``prefill_s`` (one per admitted
request, prefill + first sample) and ``decode_s`` (one per step, decode +
samples); each ends at the host read of a sampled token, which waits for
the device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.simulator import resolve_device
from ..models import layers as L
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
    """tokens, valid: (1, S) -> (logits at the last valid position (1, V),
    caches written in place).  Pads get the sentinel position, so their
    keys are never attended, and ``valid`` keeps them out of the SSM
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
        self.chunk = cfg.ssm_chunk \
            if cfg.block_type in ("ssm", "hybrid") else 1
        #: the longest prompt a prefill can write (None: no KV cache, no
        #: limit): the KV cache's slots (a sliding window's ring) rounded
        #: down to the SSM chunk — the reference's prefill writes its whole
        #: padded block at slot 0 and fails past that too (ROADMAP C-10)
        self.max_prompt = None
        if cfg.block_type != "ssm":
            slots = min(max_len, cfg.sliding_window or max_len)
            self.max_prompt = slots // self.chunk * self.chunk
        self.slot_req: list[Request | None] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, dtype=np.int32)
        self.slot_next = np.zeros(n_slots, dtype=np.int32)
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self._rid = 0
        self._steps = 0
        self.prefill_s: list[float] = []
        self.decode_s: list[float] = []

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

    def _slot_caches(self, slot: int) -> list[dict]:
        """Views of one slot's caches (batch axis sliced, storage shared)."""
        return [{kind: {n: t[slot:slot + 1] for n, t in part.items()}
                 for kind, part in c.items()} for c in self.caches]

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            t0 = time.perf_counter()
            req = self.queue.pop(0)
            s = len(req.prompt)
            s_pad = -(-s // self.chunk) * self.chunk
            tok = torch.zeros((1, s_pad), dtype=torch.int64)
            tok[0, :s] = torch.tensor(req.prompt)
            tok = tok.to(self.device)
            valid = (torch.arange(s_pad) < s)[None].to(self.device)
            logits, _ = _prefill_fn(self.params, self.cfg, tok, valid,
                                    self._slot_caches(slot))
            nxt = self._sample(logits[0], req)
            req.out_tokens.append(nxt)
            self.slot_req[slot] = req
            self.slot_pos[slot] = s
            self.slot_next[slot] = nxt
            self.prefill_s.append(time.perf_counter() - t0)

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
        logits, greedy = self.graph.run(
            torch.from_numpy(self.slot_next[:, None]),
            torch.from_numpy(self.slot_pos[:, None]))
        self._steps += 1
        greedy = greedy.tolist()            # the step's one host read
        for slot in active:
            req = self.slot_req[slot]
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
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and max_steps > 0:
            self.step()
            max_steps -= 1
        return self.finished
