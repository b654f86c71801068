"""LM data pipeline: deterministic synthetic token stream with
checkpointable iterator state (resume-exact after restart) and host-side
prefetch so a straggling host never stalls the device step.

The port of ``repro.data.loader``, a copy: numpy only, batch for batch
equal to the reference's.  A batch's generator is seeded by
``hash((seed, step))``, a hash of ints, the same in every process."""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class LMDataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    # Markov-ish structure so the LM has something learnable
    n_states: int = 64


class SyntheticLMStream:
    """Deterministic, seekable token stream. state = (step,) — a restart
    resumes from any step with identical batches."""

    def __init__(self, cfg: LMDataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step
        rng = np.random.Generator(np.random.PCG64(cfg.seed))
        # fixed random transition table: state -> token distribution peak
        self._peaks = rng.integers(0, cfg.vocab, cfg.n_states)

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.step = int(state["step"])

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.Generator(
            np.random.PCG64(hash((cfg.seed, self.step)) & 0x7FFFFFFF)
        )
        states = rng.integers(0, cfg.n_states, (cfg.batch, cfg.seq_len + 1))
        noise = rng.integers(0, cfg.vocab, (cfg.batch, cfg.seq_len + 1))
        use_peak = rng.random((cfg.batch, cfg.seq_len + 1)) < 0.8
        toks = np.where(use_peak, self._peaks[states], noise).astype(np.int32)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


class PrefetchLoader:
    """Background-thread prefetch (pull-based): the training loop never
    blocks on data generation unless the queue is fully drained."""

    def __init__(self, stream: SyntheticLMStream, depth: int = 2):
        self.stream = stream
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while not self._stop.is_set():
            batch = self.stream.next_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)
