"""Operations and bytes from shapes, against counts worked out by hand."""

import pytest

from lutvq_bench.core import counts, peaks

AQLM = {"group": 8, "codebooks": 2, "code_bits": 8, "codebook_bytes": 2, "scale_bytes": 2}


def test_mistral_q_projection_at_64_rows():
    ops, nbytes = counts.projection(64, 4096, 4096, x_bytes=4, y_bytes=4, weights=AQLM)
    assert ops == 2 * 64 * 4096 * 4096  # 2,147,483,648
    # codes 4096 rows x 512 groups x 2 bytes; 2 x 256 x 8 fp16 codebook
    # entries; 4096 fp16 scales; 64 x 4096 f32 in and out
    assert nbytes == 4_194_304 + 8_192 + 8_192 + 1_048_576 + 1_048_576
    assert peaks.bound_s(ops, nbytes) == pytest.approx(ops / 989e12)


def test_yi_down_projection_at_one_row():
    ops, nbytes = counts.projection(1, 20480, 7168, x_bytes=2, y_bytes=4, weights=AQLM)
    assert ops == 2 * 20480 * 7168
    assert nbytes == 7168 * 2560 * 2 + 8_192 + 7168 * 2 + 20480 * 2 + 7168 * 4
    assert peaks.bound_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_attention_decode_and_prefill_by_hand():
    kw = dict(heads=32, kv_heads=8, head_dim=128, q_bytes=4, out_bytes=4, kv_bytes=1,
              kv_scale_bytes=4)
    # two decoding sequences at positions 99 and 9: contexts 100 and 10
    ops, nbytes = counts.attention([(1, 100), (1, 10)], **kw)
    assert ops == 4 * 32 * 128 * (100 + 10)
    assert nbytes == 2 * 110 * 8 * (128 + 4) + 2 * 32 * 128 * 8
    # a 3-token prompt: its rows see 1, 2 and 3 keys (Yi's 56/8 heads)
    kw.update(heads=56)
    ops, nbytes = counts.attention([(3, 3)], **kw)
    assert ops == 4 * 56 * 128 * 6
    assert nbytes == 2 * 3 * 8 * (128 + 4) + 3 * 56 * 128 * 8


def test_layer_params():
    assert counts.layer_params(4096, 14336, 4096, 1024) == 218_103_808
    assert counts.layer_params(7168, 20480, 7168, 1024) == 557_842_432
