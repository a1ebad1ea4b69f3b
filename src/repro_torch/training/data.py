"""Deterministic data pipeline: synthetic corpus, packing, prefetch,
straggler mitigation.

The port's own copy of ``src/repro/training/data.py`` (NumPy only, no
torch): the same (seed, step) gives the same batches, bitwise, in both
packages. The batches are NumPy arrays; the train loop moves them to the
device.

The pipeline is fully checkpointable — its state is (seed, step) — so a
restore resumes the exact token stream (bitwise-deterministic training).
``PrefetchLoader`` runs the host-side batch construction in a background
thread with a bounded queue and a straggler policy: if a batch misses its
deadline the loader substitutes the next ready batch and counts the skip
(the 1000-node analogue: a slow data host must never stall the step
barrier — skipped shards are re-queued).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # skewed synthetic token distribution
    doc_len_mean: int = 512      # documents are packed into sequences
    eos_id: int = 0


class SyntheticPackedDataset:
    """Zipf-token documents packed into fixed-length training sequences."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0

    def state(self) -> Dict[str, int]:
        return {"seed": self.cfg.seed, "step": self.step}

    def restore(self, state: Dict[str, int]) -> None:
        assert state["seed"] == self.cfg.seed, "seed mismatch on restore"
        self.step = int(state["step"])

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step]))

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step) — the determinism contract."""
        cfg = self.cfg
        rng = self._rng(step)
        B, S = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        for b in range(B):
            fill = 0
            while fill < S + 1:
                dl = int(rng.exponential(cfg.doc_len_mean)) + 1
                dl = min(dl, S + 1 - fill)
                doc = rng.zipf(cfg.zipf_a, size=dl).astype(np.int32)
                doc = np.clip(doc, 1, cfg.vocab_size - 1)
                toks[b, fill : fill + dl] = doc
                fill += dl
                if fill < S + 1:
                    toks[b, fill] = cfg.eos_id
                    fill += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            b = self.batch_at(self.step)
            self.step += 1
            yield b


class PrefetchLoader:
    """Bounded-queue prefetch with straggler skip accounting."""

    def __init__(self, dataset: SyntheticPackedDataset, depth: int = 2,
                 deadline_s: Optional[float] = None):
        self.dataset = dataset
        self.depth = depth
        self.deadline_s = deadline_s
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.stragglers_skipped = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        it = iter(self.dataset)
        while not self._stop.is_set():
            try:
                batch = next(it)
            except StopIteration:
                break
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> Dict[str, np.ndarray]:
        if self.deadline_s is None:
            return self._q.get()
        try:
            return self._q.get(timeout=self.deadline_s)
        except queue.Empty:
            # straggler: synthesize the batch inline (never stall the step)
            self.stragglers_skipped += 1
            b = self.dataset.batch_at(self.dataset.step)
            self.dataset.step += 1
            return b

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1)
