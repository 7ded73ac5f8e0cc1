"""The reference against the port's plain path, at a tiny size on the CPU.

The reference imports nothing of the program; this test does, to hold the
two to each other on the same seeded weights."""

import torch

from lutvq_bench.models import llama as models
from lutvq_bench.reference import llama as ref
from lutvq_bench.tests import tiny

CPU = torch.device("cpu")


def test_dequantize_matches_the_ports_golden_dequantize():
    from tpu_lutvq_torch.core.config import aqlm_2x8
    from tpu_lutvq_torch.core.golden import dequantize
    from tpu_lutvq_torch.core.params import VQParams

    g = torch.Generator().manual_seed(3)
    codes = torch.randint(0, 256, (48, 8, 2), generator=g).to(torch.uint8)
    cb = torch.randn((2, 256, 8), generator=g).to(torch.float16)
    sc = (1 + 0.1 * torch.randn(48, generator=g)).to(torch.float16)
    mine = ref.dequantize(codes, cb, sc)
    theirs = dequantize(aqlm_2x8(64, shared_codebook=True), VQParams(cb[None], codes, sc))
    torch.testing.assert_close(mine, theirs.float(), rtol=1e-3, atol=1e-3)


def test_prefill_and_decode_logits_agree_with_the_port():
    """Prefill and then decode through the int8 cache (the port's plain
    path) against one causal pass of the reference over the whole
    sequence."""
    from tpu_lutvq_torch.models.llama import init_caches, llama_decode_step, llama_forward

    arch = models.arch(tiny.CONFIG)
    cfg, w = models.build_program(arch, 11, CPU)
    raw = dict(models.raw_weights(arch, 11, CPU))
    toks = torch.randint(0, arch["vocab"], (1, 24), generator=torch.Generator().manual_seed(5))
    caches = init_caches(cfg, 1, device="cpu")
    pre, caches = llama_forward(cfg, w, toks[:, :16], caches, 0, strategy="dequant_mm",
                                attn="xla")
    steps = [pre[0, -1]]
    for t in range(16, 23):
        lg, caches = llama_decode_step(cfg, w, toks[:, t], caches, torch.tensor([t]),
                                       strategy="dequant_mm", attn="xla")
        steps.append(lg[0])
    port = torch.stack(steps)
    want = ref.forward(arch, raw, [toks[0]], [torch.arange(15, 23)])[0]
    scale = want.abs().max()
    assert (port - want).abs().max() / scale < 2e-2
    assert (pre[0] - ref.forward(arch, raw, [toks[0, :16]], [torch.arange(16)])[0]).abs().max() \
        / scale < 2e-2


def test_int8_round_trip_is_the_ports_cache_format():
    from tpu_lutvq_torch.models.kv_cache import quantize_kv

    x = torch.randn(5, 3, 128, generator=torch.Generator().manual_seed(1)) * 4
    q, s = quantize_kv(x)
    torch.testing.assert_close(ref.int8_round_trip(x), q.float() * s[..., None], rtol=0, atol=1e-6)
