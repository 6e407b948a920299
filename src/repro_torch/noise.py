"""Noise sources for the Gibbs chain.

A chain takes every random draw from a source object, addressed by
(sweep, factor) and never consumed sequentially:

  ``init(N, D, K)``           standard normals for the initial factors
                              (scaled by ``bmf.init_factors``);
  ``hyper(sweep, f, nu, K)``  the Normal-Wishart draw of factor ``f``
                              ('U' or 'V') at ``sweep``: the Bartlett
                              χ²(ν − i) diagonal, the strictly-lower
                              normals and the mean's normal;
  ``factor(sweep, f, n, K)``  the (n, K) standard normal ``z`` of the
                              factor step;
  ``factor(sweep, f, n, K, shard=s)``
                              shard ``s``'s own draw of a data-sharded
                              factor step: the scatter mode samples each
                              shard's item rows from the reference's
                              ``fold_in(kv, s)`` (``core.distributed``).
                              The gather and psum modes slice the
                              single-device draw and need no such address.

Sources are batched: every draw has a leading block axis of size
``batch``, one slice per block of a stacked chain. Block b's draws depend
only on its own seed (or tape) and the address, so a block draws the same
numbers whichever executor runs it and whatever else shares its batch.

``GeneratorNoise`` wraps one ``torch.Generator`` per block on the run's
device and re-seeds it from (block seed, address) before each draw. On
the ``meta`` device (a dry run's plan) there is no generator and no
value: the draws are the same ops with their shapes only.
``TapeNoise`` replays recorded draws — the tests fill it from the JAX
reference's key schedule so a port chain can be compared numerically.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import posterior as POST

_FACTORS = {"U": 0, "V": 1}
_INIT, _HYPER, _FACTOR, _SHARD = 0, 1, 2, 3


def derive_seed(*words: int) -> int:
    """A 63-bit generator seed from integer words (numpy SeedSequence)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def block_seed(run_seed: int, i: int, j: int, attempt: int = 0) -> int:
    """Seed of block (i, j) of a PP run; retry ``attempt`` > 0 gets a fresh
    independent chain, still a pure function of (run seed, coord,
    attempt)."""
    return derive_seed(run_seed, i, j, attempt)


class GeneratorNoise:
    """One ``torch.Generator`` per block, re-seeded per addressed draw."""

    def __init__(self, seeds: Sequence[int], device):
        self.device = torch.device(device)
        self.seeds = [int(s) for s in seeds]
        self.gens = [None if self.device.type == "meta"
                     else torch.Generator(device=self.device)
                     for _ in self.seeds]

    @property
    def batch(self) -> int:
        return len(self.seeds)

    def _gen(self, b: int, *addr: int) -> Optional[torch.Generator]:
        g = self.gens[b]
        if g is not None:
            g.manual_seed(derive_seed(self.seeds[b], *addr))
        return g

    def _normals(self, kind: int, sweep: int, f: int, shape, *extra: int):
        out = torch.empty((self.batch,) + tuple(shape), device=self.device)
        for b in range(self.batch):
            torch.randn(shape, generator=self._gen(b, kind, sweep, f, *extra),
                        out=out[b])
        return out

    def init(self, N: int, D: int, K: int):
        return (self._normals(_INIT, 0, 0, (N, K)),
                self._normals(_INIT, 0, 1, (D, K)))

    def hyper(self, sweep: int, f: str, nu: float, K: int):
        # a fill on the device, not a copy from the host (which waits)
        df = POST.wishart_df(torch.full((), float(nu), device=self.device),
                             K)
        chi2, lower, z = [], [], []
        for b in range(self.batch):
            g = self._gen(b, _HYPER, sweep, _FACTORS[f])
            chi2.append(POST.chi2(g, df))
            lower.append(torch.randn((K, K), generator=g, device=self.device))
            z.append(torch.randn((K,), generator=g, device=self.device))
        return torch.stack(chi2), torch.stack(lower), torch.stack(z)

    def factor(self, sweep: int, f: str, n: int, K: int,
               shard: Optional[int] = None):
        if shard is None:
            return self._normals(_FACTOR, sweep, _FACTORS[f], (n, K))
        return self._normals(_SHARD, sweep, _FACTORS[f], (n, K), int(shard))


TapeKey = Tuple


class TapeNoise:
    """Replays recorded draws. Each block's tape maps

      ("init", "U") -> (N, K), ("init", "V") -> (D, K),
      ("hyper", sweep, f) -> (chi2 (K,), lower (K, K), z (K,)),
      ("z", sweep, f) -> (n, K), ("z", sweep, f, shard) -> (n, K)

    to numpy arrays. A missing entry raises ``KeyError``: a chain that
    asks for a draw the tape never recorded is a schedule mismatch."""

    def __init__(self, tapes: Sequence[Dict[TapeKey, object]], device):
        self.tapes = list(tapes)
        self.device = torch.device(device)

    @property
    def batch(self) -> int:
        return len(self.tapes)

    def _stack(self, key, part=None):
        arrs = [t[key] if part is None else t[key][part] for t in self.tapes]
        return torch.from_numpy(np.stack(arrs).astype(np.float32)).to(
            self.device)

    def init(self, N: int, D: int, K: int):
        return self._stack(("init", "U")), self._stack(("init", "V"))

    def hyper(self, sweep: int, f: str, nu: float, K: int):
        key = ("hyper", sweep, f)
        return self._stack(key, 0), self._stack(key, 1), self._stack(key, 2)

    def factor(self, sweep: int, f: str, n: int, K: int,
               shard: Optional[int] = None):
        key = ("z", sweep, f) if shard is None else ("z", sweep, f,
                                                     int(shard))
        return self._stack(key)
