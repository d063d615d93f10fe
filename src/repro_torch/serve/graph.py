"""The decode step as one CUDA graph: the port's counterpart of the
reference engine's ``self._decode = jax.jit(... T.decode_step ...)``.

:class:`DecodeGraph` runs :func:`~repro_torch.models.transformer.decode_step`
on buffers of its own — ``tokens`` (B, 1) int64, ``positions`` (B, 1)
int32 and, for a VLM, ``image_embeds`` — and on the caller's caches, which
it holds by reference and which every call writes in place.  It returns
fixed outputs: the logits (B, 1, V) float32 and the greedy tokens (B,)
int64, one ``argmax`` over the vocabulary in the same call.

On a CUDA device it is built in three steps:

1. one eager call on a side stream (the warm-up), which does the
   first-use work that must not happen under capture: the kernels' nvcc
   build and ``ctypes`` load, the kernel's shared-memory attribute, the
   SM count and the call plan of :mod:`repro_torch.kernels.flash_attention`,
   cuBLAS's workspace;
2. the capture of one call (``torch.cuda.graph``), which launches
   nothing;
3. the restore: the warm-up wrote K/V and positions at each slot's ring
   slot and advanced the SSM state and conv window, so every cache tensor
   gets back the values it held before (a snapshot taken first) — what
   ``init_caches`` made, where the engine builds the graph.  Left in
   the caches, the warm-up would be state that no request wrote (a
   prefill of fewer than ``ssm_conv − 1`` tokens keeps the old conv
   window).

Then :meth:`DecodeGraph.run` copies its inputs into the static buffers and
replays the graph: one launch from the host for the whole step.  A replay
runs no Python, so the host-side launch counts of
:mod:`repro_torch.kernels.flash_attention` are recorded at capture and
added per replay.  A failed capture or replay raises; nothing runs the
eager step in its place.

On the CPU (``device="cpu"``, the tests) the same object does the warm-up
and the restore, then runs the same call on the same buffers eagerly.
Serving on a mesh (DTensor caches) is not graphed.
"""
from __future__ import annotations

import torch

from ..kernels import flash_attention as FA
from ..models import transformer as T
from ..models.config import ModelConfig


def _tensors(caches: list[dict]):
    """Every cache tensor, in a fixed order."""
    for c in caches:
        for part in c.values():
            yield from part.values()


class DecodeGraph:
    """``decode_step`` of ``batch`` rows over fixed buffers and ``caches``,
    captured once on a CUDA device and replayed by :meth:`run`.
    ``image_embeds``: a VLM's (B, T_img, D) image embeddings, copied into a
    static input of the graph."""

    def __init__(self, params, cfg: ModelConfig, caches: list[dict],
                 batch: int, *, device, image_embeds=None):
        self.params, self.cfg, self.caches = params, cfg, caches
        device = torch.device(device)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64,
                                  device=device)
        # the attention kernel reads 16-byte aligned position rows; a fresh
        # allocation is one (the allocators align to 64 bytes or more), so
        # ``layers._aligned`` never copies it, under capture or after
        self.positions = torch.zeros((batch, 1), dtype=torch.int32,
                                     device=device)
        self.image_embeds = None if image_embeds is None else \
            image_embeds.to(device, copy=True)
        self.graph: torch.cuda.CUDAGraph | None = None
        #: kernel launches of one replay (host counts taken at capture)
        self.per_replay: dict[str, int] = {}
        before = [t.clone() for t in _tensors(caches)]
        if device.type == "cuda":
            with torch.cuda.device(device):
                self._capture()
        else:
            self.logits, self.next_tokens = self._step()      # warm-up
        for t, old in zip(_tensors(caches), before, strict=True):
            t.copy_(old)

    def _step(self) -> tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            logits, _ = T.decode_step(self.params, self.cfg, self.tokens,
                                      self.caches, self.positions,
                                      image_embeds=self.image_embeds)
            return logits, torch.argmax(logits[:, 0], -1)

    def _capture(self) -> None:
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._step()
        main.wait_stream(side)
        counted = dict(FA.launches)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, self.next_tokens = self._step()
        self.per_replay = {k: FA.launches[k] - n for k, n in counted.items()}
        FA.launches.update(counted)         # the capture launched nothing

    def run(self, tokens, positions) -> tuple[torch.Tensor, torch.Tensor]:
        """Copy ``tokens`` (B, 1) and ``positions`` (B, 1) (tensors on any
        device) into the static inputs and run one step: -> (logits (B, 1,
        V) float32, greedy tokens (B,)), the graph's own buffers on a CUDA
        device, overwritten by the next call."""
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        if self.graph is None:
            self.logits, self.next_tokens = self._step()
        else:
            self.graph.replay()
            for k, n in self.per_replay.items():
                FA.launches[k] += n
        return self.logits, self.next_tokens
