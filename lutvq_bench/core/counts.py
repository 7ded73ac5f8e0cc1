"""Operations and bytes of a layer call, from its shapes alone: the same
whatever kernel implements the layer.  Each input byte is read once and
each output byte written once."""

from __future__ import annotations


def projection(rows: int, d_in: int, d_out: int, *, x_bytes: int, y_bytes: int,
               weights: dict) -> tuple[float, float]:
    """(operations, bytes) of one AQLM projection ``(rows, d_in) → (rows, d_out)``.

    ``weights`` is the configuration's format: ``codebooks`` additive
    codebooks of ``2**code_bits`` entries over groups of ``group`` inputs,
    each ``codebook_bytes`` an element, one codebook set a layer, and one
    ``scale_bytes`` scale an output.  Codes: ``codebooks * code_bits`` bits
    a group of each output row."""
    g = weights["group"]
    n_cb, bits = weights["codebooks"], weights["code_bits"]
    codes = d_out * (d_in // g) * n_cb * bits / 8
    codebooks = n_cb * (2 ** bits) * g * weights["codebook_bytes"]
    scales = d_out * weights["scale_bytes"]
    nbytes = codes + codebooks + scales + rows * d_in * x_bytes + rows * d_out * y_bytes
    return 2.0 * rows * d_in * d_out, float(nbytes)


def attention(queries: list[tuple[int, int]], *, heads: int, kv_heads: int, head_dim: int,
              q_bytes: int, out_bytes: int, kv_bytes: int, kv_scale_bytes: int
              ) -> tuple[float, float]:
    """(operations, bytes) of causal attention over a cache.

    ``queries``: one ``(n, context)`` per sequence: its ``n`` newest
    positions attend over the first ``context`` rows of its cache (causal
    within the ``n``), so the i-th of them sees ``context - n + 1 + i``
    rows.  Operations: QKᵀ and PV, 2·2·head_dim FLOPs a (head, query, key).
    Bytes: K and V at each sequence's context (``kv_bytes`` an element plus
    one ``kv_scale_bytes`` scale a row and head each), the queries read
    once, the outputs written once."""
    ops = 0.0
    nbytes = 0.0
    for n, ctx in queries:
        keys = n * (ctx - n + 1) + n * (n - 1) / 2  # Σ_i (ctx - n + 1 + i)
        ops += 4.0 * heads * head_dim * keys
        nbytes += 2 * ctx * kv_heads * (head_dim * kv_bytes + kv_scale_bytes)
        nbytes += n * heads * head_dim * (q_bytes + out_bytes)
    return ops, nbytes


def layer_params(hidden: int, ffn: int, q_dim: int, kv_dim: int) -> int:
    """Weights of one decoder layer's seven projections (the norms omitted)."""
    return hidden * (q_dim + 2 * kv_dim) + q_dim * hidden + 3 * hidden * ffn
