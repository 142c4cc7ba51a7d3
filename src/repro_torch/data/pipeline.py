"""Data pipeline: deterministic synthetic LM stream + byte-level file
corpus, per-host sharding, background prefetch.

Determinism contract: batch ``i`` of host ``h`` depends only on
``(seed, i, h)`` — after a restart at step N the pipeline resumes exactly at
batch N (fault tolerance: data and model state recover together).

A numpy copy of ``repro/data/pipeline.py``: the port imports nothing of the
JAX package, so it keeps its own; batches are numpy arrays, moved to the
device by the caller.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    batch_per_host: int
    seed: int = 0
    kind: str = "synthetic"      # synthetic | bytes
    path: Optional[str] = None   # for kind="bytes"
    zipf_a: float = 1.2          # synthetic token distribution


class SyntheticLM:
    """Zipf-distributed token stream with a learnable bigram structure
    (next token correlates with current), so losses actually decrease."""

    def __init__(self, cfg: DataConfig, host_id: int = 0):
        self.cfg = cfg
        self.host = host_id

    def batch(self, index: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, self.host, index]))
        b, s = cfg.batch_per_host, cfg.seq_len
        base = rng.zipf(cfg.zipf_a, size=(b, s + 1)) % cfg.vocab
        # inject bigram structure: token[t+1] == f(token[t]) half the time
        follow = (base[:, :-1] * 31 + 7) % cfg.vocab
        coin = rng.random((b, s)) < 0.5
        seq = base[:, 1:].copy()
        seq[coin] = follow[coin]
        tokens = np.concatenate([base[:, :1], seq], axis=1).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


class ByteCorpus:
    """Byte-level LM over a local file (vocab 256), sequential windows
    per host with stride striping across hosts."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        if not cfg.path:
            raise ValueError("ByteCorpus needs cfg.path")
        self.data = np.frombuffer(Path(cfg.path).read_bytes(), dtype=np.uint8)
        self.cfg = cfg
        self.host = host_id
        self.n_hosts = n_hosts

    def batch(self, index: int) -> dict:
        cfg = self.cfg
        b, s = cfg.batch_per_host, cfg.seq_len
        n = len(self.data) - s - 1
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, self.host, index]))
        starts = rng.integers(0, n, size=b)
        toks = np.stack([self.data[st:st + s + 1] for st in starts])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def make_source(cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg, host_id)
    if cfg.kind == "bytes":
        return ByteCorpus(cfg, host_id, n_hosts)
    raise ValueError(cfg.kind)


class Prefetcher:
    """Background-thread prefetch (decouples host data prep from steps)."""

    def __init__(self, source, start_index: int = 0, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._index = start_index
        self._source = source
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        i = self._index
        while not self._stop.is_set():
            try:
                self._q.put(self._source.batch(i), timeout=0.2)
                i += 1
            except queue.Full:
                continue

    def next(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
