"""The port's copy of the paged-KV bookkeeping against the JAX package's.

``repro_torch.serve.paging`` is a copy of ``repro.serve.paging`` (pure
Python, kept so that the port imports nothing of the JAX package).  The
same sequences of alloc / ref / release / match / insert / evict, one
scripted and one drawn from a seeded generator, run on both; after every
step the free lists, refcounts, match results, eviction counts and order
and the gauges must be identical.
"""
import inspect
import re

import numpy as np
import pytest

from repro.serve import paging as jax_paging
from repro_torch.serve import paging as port_paging


def _state(mod, pool, radix):
    """Everything observable of a pool and its radix tree."""
    leaves = sorted((n.last_used, n.page, n.key) for n in radix._leaves())
    return dict(
        free=list(pool._free), refs=list(pool._refs),
        gauges=(pool.free_pages, pool.used_pages, pool.total_pages),
        radix=(radix.lookups, radix.hits, radix.evictions, radix.node_count,
               radix.hit_rate),
        leaves=leaves, scratch=mod.SCRATCH_PAGE)


class Twin:
    """One pool and radix tree per package, driven in lockstep."""

    def __init__(self, num_pages, page_size):
        self.sides = []
        for mod in (jax_paging, port_paging):
            pool = mod.PagePool(num_pages, page_size)
            self.sides.append((mod, pool, mod.RadixPrefixCache(pool)))

    def do(self, op, *args):
        out = []
        for mod, pool, radix in self.sides:
            target = radix if op in ("match", "insert", "evict_lru",
                                     "evict_for") else pool
            try:
                out.append(("ok", getattr(target, op)(*args)))
            except ValueError as exc:
                out.append(("raise", str(exc)))
        assert out[0] == out[1], f"{op}{args}: {out}"
        states = [_state(*side) for side in self.sides]
        assert states[0] == states[1], f"after {op}{args}"
        return out[0]


def test_scripted_sequence_gives_identical_state():
    ps = 4
    tw = Twin(12, ps)
    a = tw.do("alloc", 3)[1]
    b = tw.do("alloc", 2)[1]
    tw.do("alloc", 100)                       # short: None, all or nothing
    tw.do("ref", a[:2])
    prompt = list(range(100, 112))            # three full pages
    tw.do("insert", prompt, a)
    tw.do("release", a)
    tw.do("release", a[:2])
    tw.do("match", prompt + [7, 7])           # hits all three pages
    tw.do("match", prompt[:6])                # one full page
    tw.do("match", [1, 2, 3, 4, 5])           # miss
    tw.do("insert", [9] * 8, b)               # a second branch
    tw.do("release", b)
    tw.do("match", [9] * 8)                   # touches it: now the MRU
    tw.do("evict_lru", 1)                     # evicts from the first
    tw.do("evict_for", 10)
    tw.do("release", [0])                     # the scratch page: raises
    tw.do("ref", [11])                        # a free page: raises
    tw.do("alloc", -1)                        # raises


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequences_give_identical_state(seed):
    """Seeded random mixes; requests own pages as the engine's slots do
    (matched prefix + fresh pages, adopted into the tree at retirement,
    then released)."""
    rng = np.random.default_rng(seed)
    ps = int(rng.integers(2, 6))
    tw = Twin(int(rng.integers(10, 40)), ps)
    vocab = [list(rng.integers(0, 3, size=ps)) for _ in range(4)]
    live = []                                 # (tokens, pages) per request
    for _ in range(300):
        kind = rng.choice(["admit", "retire", "evict", "evict_for"],
                          p=[0.45, 0.35, 0.1, 0.1])
        if kind == "admit":
            n_pages = int(rng.integers(1, 5))
            toks = [int(t) for i in rng.integers(0, len(vocab), n_pages)
                    for t in vocab[i]]
            _, (_, matched) = tw.do("match", toks)
            fresh = tw.do("alloc", n_pages - len(matched))[1]
            if fresh is None:
                tw.do("evict_for", n_pages - len(matched))
                fresh = tw.do("alloc", n_pages - len(matched))[1]
            if fresh is None:
                if matched:
                    tw.do("release", matched)
                continue
            live.append((toks, matched + fresh))
        elif kind == "retire" and live:
            toks, pages = live.pop(int(rng.integers(0, len(live))))
            tw.do("insert", toks, pages)
            tw.do("release", pages)
        elif kind == "evict":
            tw.do("evict_lru", int(rng.integers(1, 4)))
        elif kind == "evict_for":
            tw.do("evict_for", int(rng.integers(1, 8)))
    for toks, pages in live:
        tw.do("release", pages)
    tw.do("evict_for", 10 ** 6)               # empty the tree
    (_, pool, radix), = tw.sides[1:]
    assert radix.node_count == 0 and pool.used_pages == 0


def test_copy_differs_only_in_docstrings():
    """The code of both modules is the same once docstrings are gone."""
    def code(mod):
        src = inspect.getsource(mod)
        src = re.sub(r'"""(.|\n)*?"""', '""', src)
        return [line.rstrip() for line in src.splitlines()
                if line.strip()]
    assert code(port_paging) == code(jax_paging)
