"""The generator: the seed draws the ids and never changes the work."""

import collections

import pytest

from lutvq_bench.core import spec
from lutvq_bench.core.traffic import Schedule, quantiles


@pytest.mark.parametrize("mix", ["chat-c64"])
def test_two_seeds_same_lengths_in_flight_other_ids(mix):
    m = spec.load_json(spec.BENCH / "traffic" / f"{mix}.json")
    a, b = Schedule(m, 7, 32768), Schedule(m, 2**31 + 9, 32768)
    for k in range(3 * m["strata"]):
        ra = collections.Counter(a.shape(c, k) for c in range(m["clients"]))
        rb = collections.Counter(b.shape(c, k) for c in range(m["clients"]))
        assert ra == rb  # the k-th requests of all clients: every shape once
        assert len(ra) == m["strata"]
        assert [a.shape(c, k) for c in range(m["clients"])] == \
            [b.shape(c, k) for c in range(m["clients"])]  # and in the same order
    pa, _ = a.request(0, 0)
    pb, _ = b.request(0, 0)
    assert pa != pb
    assert a.request(3, 5) == a.request(3, 5)  # ids depend on (seed, client, k) alone


def test_quantiles_are_the_strata_middles():
    d = {"dist": "lognormal", "median": 512, "sigma": 0.8, "min": 32, "max": 2048}
    q = quantiles(d, 64)
    assert q == sorted(q) and q[0] >= 32 and q[-1] == 2048
    assert q[31] < 512 < q[32]  # the median lies between the middle strata
    u = quantiles({"dist": "uniform", "min": 16, "max": 64}, 4)
    assert u == [22, 34, 46, 58]
    with pytest.raises(ValueError):
        quantiles({"dist": "pareto", "min": 1, "max": 2}, 2)
