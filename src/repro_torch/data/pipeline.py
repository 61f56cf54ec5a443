"""Deterministic synthetic LM data pipeline, sharded per host.

The port's own copy of the JAX package's numpy module, unchanged apart
from this docstring: the same seed gives the same batches in both, so
the two train paths can be held to each other step for step.  Batches
are numpy arrays; the caller moves them to its device.

Production framing: every host independently and deterministically
generates the *same* global batch schedule and slices out its own rows
(``host_batch_iterator``), so there is no data server to fail and restart
is exact — ``skip_to(step)`` fast-forwards without generating intermediate
batches (counter-based generation, not a stateful RNG stream), which is
what makes checkpoint-restart O(1) in data terms.

The token stream is a reproducible Zipf-ish mixture with enough structure
for the loss to actually drop during the example training runs:
each sequence is a Markov chain whose transition row is seeded by
(seed, step, row) — the model can learn bigram statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # synthetic-structure knobs
    n_states: int = 64           # markov states driving the stream
    pad_fraction: float = 0.0    # tail padding (tests loss masking)


class SyntheticLMDataset:
    """Counter-based deterministic batch generator."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)
        # one shared transition structure per run (small, regenerated
        # identically on every host)
        self._state_tokens = root.integers(
            0, cfg.vocab_size, size=(cfg.n_states, 8), dtype=np.int64)
        self._transition = root.integers(
            0, cfg.n_states, size=(cfg.n_states, 4), dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The full global batch for ``step`` (same on every host)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, 1, step))
        b, s = cfg.global_batch, cfg.seq_len
        state = rng.integers(0, cfg.n_states, size=(b,))
        toks = np.empty((b, s + 1), dtype=np.int32)
        choices = rng.integers(0, 4, size=(b, s + 1))
        emit = rng.integers(0, 8, size=(b, s + 1))
        for t in range(s + 1):
            toks[:, t] = self._state_tokens[state, emit[:, t]]
            state = self._transition[state, choices[:, t]]
        tokens = toks[:, :-1]
        targets = toks[:, 1:].astype(np.int32)
        if cfg.pad_fraction > 0:
            pad = int(s * cfg.pad_fraction)
            if pad:
                targets[:, -pad:] = -1
        return {"tokens": tokens, "targets": targets}


def make_global_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    return SyntheticLMDataset(cfg).batch(step)


def host_batch_iterator(cfg: DataConfig, host_id: int, num_hosts: int,
                        start_step: int = 0,
                        extra_specs: Optional[Dict[str, tuple]] = None
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield this host's slice of each global batch, forever.

    ``extra_specs``: {name: (per-batch shape tail, dtype)} for frontend
    stubs (patch/frame embeddings), generated deterministically too.
    """
    if cfg.global_batch % num_hosts:
        raise ValueError("global batch must divide evenly across hosts")
    rows = cfg.global_batch // num_hosts
    lo, hi = host_id * rows, (host_id + 1) * rows
    ds = SyntheticLMDataset(cfg)
    step = start_step
    while True:
        gb = ds.batch(step)
        out = {k: v[lo:hi] for k, v in gb.items()}
        if extra_specs:
            rng = np.random.default_rng((cfg.seed, 2, step, host_id))
            for name, (tail, dtype) in extra_specs.items():
                out[name] = rng.standard_normal(
                    (rows, *tail)).astype(dtype) * 0.02
        yield out
        step += 1
