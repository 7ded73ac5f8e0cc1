"""The traffic generator every mix goes through.

A mix (``traffic/<mix>.json``) gives distributions of prompt and output
lengths.  Each is cut into ``strata`` equal-probability strata and
represented by each stratum's middle quantile: a fixed set of lengths that
no seed changes.  Request shape ``i`` pairs the i-th prompt quantile with
the ``(i * stride) % strata``-th output quantile (``stride`` coprime to
``strata``), so long prompts do not always bring long answers.  Client
``c``'s ``k``-th request takes shape ``(c + k) % strata``: a Latin square,
so the clients' k-th requests together are every shape once.

The seed draws every token id and nothing else: the order is fixed too.
The batcher pads an admission wave to a power-of-two bucket of its longest
prompt, so which prompts meet in a wave decides how much work a tick does;
an order drawn from the seed would give every seed a different amount of
work.  With greedy decoding and no end token, the ticks of a run, and what
each admits and decodes, are the same for every seed.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

_STRIDES = (5, 7, 11, 13, 17, 19, 23)


def quantiles(dist: dict, n: int) -> list[int]:
    """The middle quantile of each of ``n`` equal-probability strata of
    ``dist``, rounded and clipped to ``[min, max]``."""
    lo, hi = dist["min"], dist["max"]
    ps = [(i + 0.5) / n for i in range(n)]
    if dist["dist"] == "lognormal":
        nd = NormalDist()
        xs = [dist["median"] * math.exp(dist["sigma"] * nd.inv_cdf(p)) for p in ps]
    elif dist["dist"] == "uniform":
        xs = [lo + (hi - lo) * p for p in ps]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [int(min(hi, max(lo, round(x)))) for x in xs]


def seed_key(seed: int) -> int:
    """A seed as the non-negative 64-bit integer numpy and torch both take."""
    return seed % 2**64


class Schedule:
    """Every request of a closed loop: shape and token ids by (client, k)."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        n = mix["strata"]
        self.n = n
        self.clients = mix["clients"]
        self.vocab = vocab
        self.seed = seed_key(seed)
        stride = next(s for s in _STRIDES if math.gcd(s, n) == 1)
        prompts = quantiles(mix["prompt"], n)
        outputs = quantiles(mix["output"], n)
        self.shapes = [(prompts[i], outputs[(i * stride) % n]) for i in range(n)]

    def shape(self, client: int, k: int) -> tuple[int, int]:
        """(prompt length, output length) of client ``client``'s k-th request."""
        return self.shapes[(client + k) % self.n]

    def request(self, client: int, k: int) -> tuple[list[int], int]:
        """(prompt token ids, output length): the ids are drawn from (seed,
        client, k) alone, so they do not depend on the order of arrivals."""
        p, o = self.shape(client, k)
        rng = np.random.default_rng([self.seed, 1, client, k])
        return rng.integers(0, self.vocab, p).tolist(), o
