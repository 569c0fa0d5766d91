"""Deterministic synthetic LM data pipeline (a copy of
`repro.data.pipeline`, numpy throughout: batches are moved to the device
by the train step, not here).

Generates Zipf-distributed token streams with Markov bigram structure so a
model actually has something learnable (loss decreases measurably within a
few hundred steps), plus modality stubs (frames / image embeddings) for the
enc-dec and VLM families.

Production shape: each host generates only its shard of the global batch
(`host_slice`), batches are double-buffered through a background thread,
and every batch is addressable by (seed, step) — restart-safe by
construction, which is what the fault-tolerant loop (runtime/ft.py) relies
on: no data-state checkpointing is needed beyond the step counter.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    n_states: int = 64          # Markov states for learnable structure
    family: str = "dense"
    d_model: int = 0            # for frames/image stubs
    n_image_tokens: int = 0


class SyntheticLM:
    """Stateless (seed, step) -> batch generator."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # fixed Markov structure: per state, a Zipf-ish distribution over a
        # random slice of the vocabulary
        self._state_offsets = root.integers(0, v, cfg.n_states)
        ranks = np.arange(1, min(v, 1024) + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._zipf_p = p / p.sum()
        self._trans = root.integers(0, cfg.n_states,
                                    (cfg.n_states, 8))

    def batch(self, step: int, host_slice: slice | None = None) -> dict:
        cfg = self.cfg
        sl = host_slice or slice(0, cfg.global_batch)
        rows = range(sl.start, sl.stop)
        n = len(rows)
        toks = np.empty((n, cfg.seq_len + 1), np.int32)
        for j, r in enumerate(rows):
            # per-(seed, step, sequence) RNG: any host slice of the global
            # batch is bit-identical to the same rows of the full batch
            rng = np.random.default_rng((cfg.seed, step, r))
            state = int(rng.integers(0, cfg.n_states))
            draws = rng.choice(len(self._zipf_p), size=cfg.seq_len + 1,
                               p=self._zipf_p)
            for t in range(cfg.seq_len + 1):
                toks[j, t] = (self._state_offsets[state] + draws[t]) \
                    % cfg.vocab
                state = self._trans[state, draws[t] % 8]
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "encdec":
            out["frames"] = np.stack([
                np.random.default_rng((cfg.seed, step, r, 1))
                .standard_normal((cfg.seq_len, cfg.d_model))
                for r in rows]).astype(np.float32)
        if cfg.family == "vlm":
            out["image_embeds"] = np.stack([
                np.random.default_rng((cfg.seed, step, r, 2))
                .standard_normal((cfg.n_image_tokens, cfg.d_model))
                for r in rows]).astype(np.float32)
        return out


def make_batch_iterator(cfg: DataConfig, start_step: int = 0,
                        host_slice: slice | None = None,
                        prefetch: int = 2):
    """Background-thread double-buffered iterator, resumable at any step."""
    gen = SyntheticLM(cfg)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put((step, gen.batch(step, host_slice)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
