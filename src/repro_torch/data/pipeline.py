"""Deterministic, sharded, checkpointable synthetic data pipeline (the port
of ``repro.data.pipeline``).

Batch ``i`` is a pure function of (seed, i, row): a restart at any step
reproduces the exact stream, so the pipeline's checkpointable state is the
step (and the dedup drop count).  Each data-parallel rank draws only its
rows.  The text is synthetic: Zipfian unigrams overlaid with repeated
n-gram motifs, so losses fall measurably.  Tokens are drawn with numpy
exactly as the reference draws them, and batches are numpy arrays; the
train step moves them to the device.

Dedup: each sequence's fingerprint (Python's ``hash`` of its first 64
tokens — per process, as in the reference) goes through the port's
:class:`~repro_torch.pud.bloom.PudBloomFilter`, whose bit-plane lives on
``device`` (bulk OR / AND programs on the PuD engine); a sequence seen
before is redrawn from a second stream and counted in ``dropped``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.simulator import resolve_device
from ..pud.bloom import PudBloomFilter
from ..pud.engine import PudEngine


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    motif_len: int = 16
    n_motifs: int = 64
    dedup: bool = False


class SyntheticLM:
    """Seekable synthetic token stream; the dedup filter (``cfg.dedup``)
    runs on ``device`` (default the card; raises without one)."""

    def __init__(self, cfg: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        v_eff = max(cfg.vocab - 2, 2)
        # fixed motif bank (shared structure => learnable)
        self.motifs = rng.integers(
            2, cfg.vocab, (cfg.n_motifs, cfg.motif_len)).astype(np.int32)
        # zipf unigram table over the vocab
        ranks = np.arange(1, v_eff + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self.unigram = probs / probs.sum()
        self.bloom = (PudBloomFilter(engine=PudEngine(device=self.device))
                      if cfg.dedup else None)
        self.dropped = 0

    def _sequence(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        seq = rng.choice(len(self.unigram), size=cfg.seq_len,
                         p=self.unigram).astype(np.int32) + 2
        # overlay motifs at random offsets (~30% of tokens)
        n_spans = max(1, int(0.3 * cfg.seq_len / cfg.motif_len))
        for _ in range(n_spans):
            m = self.motifs[rng.integers(0, cfg.n_motifs)]
            off = rng.integers(0, max(cfg.seq_len - cfg.motif_len, 1))
            seq[off:off + cfg.motif_len] = m
        return seq

    def batch(self, step: int, *, dp_rank: int = 0, dp_size: int = 1) -> dict:
        """-> {"tokens", "labels", "loss_mask"} numpy arrays for this rank's
        slice of batch ``step``."""
        cfg = self.cfg
        if cfg.global_batch % dp_size:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {dp_size} ranks")
        per = cfg.global_batch // dp_size
        toks = np.empty((per, cfg.seq_len + 1), dtype=np.int32)
        for i in range(per):
            row = dp_rank * per + i
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, row]))
            seq = self._sequence(rng)
            if self.bloom is not None:
                fp = np.asarray([hash(seq[:64].tobytes()) & ((1 << 63) - 1)],
                                dtype=np.uint64)
                if not bool(self.bloom.filter_new(fp)[0]):
                    self.dropped += 1
                    rng2 = np.random.default_rng(
                        np.random.SeedSequence([cfg.seed, step, row, 1]))
                    seq = self._sequence(rng2)
            extra = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, row, 2])
            ).integers(2, cfg.vocab, 1).astype(np.int32)
            toks[i] = np.concatenate([seq, extra])
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "loss_mask": np.ones((per, cfg.seq_len), dtype=np.float32),
        }

    # ---- checkpointable state ----
    def state_dict(self) -> dict:
        return {"dropped": self.dropped}

    def load_state_dict(self, s: dict) -> None:
        self.dropped = int(s.get("dropped", 0))
