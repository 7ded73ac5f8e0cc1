"""The seeded models' conditioning on the CPU: no part of a projection is
common to its rows, and at Yi-34B's depth the residual stream stays
conditioned (at a small width: the full one is for the card)."""

import torch
import torch.nn.functional as F

from lutvq_bench.models import llama as models
from lutvq_bench.reference import llama as ref
from lutvq_bench.tests import tiny

CPU = torch.device("cpu")


def config(hidden: int, heads: int, kv_heads: int, ffn: int, layers: int, theta: float) -> dict:
    return dict(tiny.CONFIG, hidden_size=hidden, num_attention_heads=heads,
                num_key_value_heads=kv_heads, intermediate_size=ffn, num_hidden_layers=layers,
                rope_theta=theta, vocab_size=512)


def test_codebooks_are_centred_so_no_projection_has_a_common_row():
    """W·1 a row: with a codebook mean, every row shares ``G · Σ mean`` (a
    rank-one part: mean/rms ≈ 0.06·sqrt(G), 0.5 at 64 groups); centred,
    the rows' sums are independent and their mean is ~1/sqrt(d_out) of
    their spread."""
    a = models.arch(config(512, 4, 1, 1024, 2, 1e6))
    w = dict(models.raw_weights(a, 5, CPU))
    assert w["codebooks"].float().mean(dim=3).abs().max() < 1e-3
    for pi, name in enumerate(models.PROJECTIONS):
        for li in range(a["layers"]):
            m = ref.dequantize(w[name][0][li], w["codebooks"][li, pi], w[name][1][li])
            sums = m.sum(dim=1)
            assert sums.mean().abs() / sums.pow(2).mean().sqrt() < 0.2, (name, li)


def test_yi_depth_keeps_the_residual_stream_conditioned():
    """60 layers at θ 5e6 and Yi's 7:1 grouping: no position's residual
    stream grows past twice the median, and its mean across channels
    stays at the size a random vector's has (1/sqrt(hidden) of its RMS),
    at every layer."""
    a = models.arch(config(448, 7, 1, 1280, 60, 5e6))
    w = dict(models.raw_weights(a, 9, CPU))
    seq = torch.randint(0, a["vocab"], (96,), generator=torch.Generator().manual_seed(9))
    h, dh, eps = a["heads"], a["head_dim"], a["eps"]
    x = w["embed"][seq].float()
    with torch.no_grad():
        for li in range(a["layers"]):
            p = {n: ref.dequantize(w[n][0][li], w["codebooks"][li, pi], w[n][1][li])
                 for pi, n in enumerate(models.PROJECTIONS)}
            xn = ref.rms_norm(x, w["norms"][li, 0], eps)
            q = ref.rope((xn @ p["wq"].T).reshape(len(seq), h, dh), a["rope_theta"])
            k = ref.rope((xn @ p["wk"].T).reshape(len(seq), -1, dh), a["rope_theta"])
            v = (xn @ p["wv"].T).reshape(len(seq), -1, dh)
            x = x + ref.attention(q, k, v) @ p["wo"].T
            xn = ref.rms_norm(x, w["norms"][li, 1], eps)
            x = x + (F.silu(xn @ p["w_gate"].T) * (xn @ p["w_up"].T)) @ p["w_down"].T
            rms = x.pow(2).mean(dim=-1).sqrt()
            assert rms.max() < 2 * rms.median(), li
            assert (x.mean(dim=-1).abs() / rms).max() < 5 / a["hidden"] ** 0.5, li
    assert 1.2 < rms.median() < 3.0
