"""``attn="auto"``: pick the attention path (counterpart of
``tpu_lutvq.models.attn_policy``, same decisions).

The four constants are the JAX package's, measured there on a TPU v5e
against its Pallas kernels.  They are kept so that the port picks the same
path as the reference at every shape (the parity tests rely on it), and
they are provisional on the H100: no crossover has been measured on the
card yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

# B*window (tokens) from which decode runs the flash kernel, slab / paged.
FLASH_CROSSOVER_SLAB = 1024
FLASH_CROSSOVER_PAGED = 512
# Slab decode with per-layer tuple caches below this batch stays on the
# einsum path (the reference's B=1 end-to-end loss with tuple caches).
MIN_BATCH_FOR_FLASH_SLAB = 2
# Prefill (T > 1) switches to the tiled flash kernel once the einsum path's
# f32 score + prob transients, 2*4*B*H*T*window bytes, would pass this.
XLA_PREFILL_TRANSIENT_BUDGET = 2 * 1024**3


def resolve_attn(
    attn: str,
    *,
    batch: int,
    window: int,
    heads: int,
    t: int = 1,
    paged: bool = False,
) -> str:
    """Resolve ``"auto"`` to ``"flash"`` or ``"xla"``; any other value is
    returned as given.  ``heads`` (query heads) sizes the prefill transient."""
    if attn != "auto":
        return attn
    if t > 1:
        transient = 2 * 4 * batch * heads * t * window  # score + prob, f32
        return "flash" if transient > XLA_PREFILL_TRANSIENT_BUDGET else "xla"
    if not paged and batch < MIN_BATCH_FOR_FLASH_SLAB:
        return "xla"
    threshold = FLASH_CROSSOVER_PAGED if paged else FLASH_CROSSOVER_SLAB
    return "flash" if batch * window >= threshold else "xla"
