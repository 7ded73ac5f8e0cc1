"""``attn="auto"``: pick the attention path (counterpart of
``tpu_lutvq.models.attn_policy``, the same rule).

The four constants come from the card: ``dataflow/h100_attn.csv`` (NVIDIA
H100 80GB HBM3, 700.00 W; ``python3 chip_smoke.py --sweep``) times flash
decode (D, and F over a paged pool) against the einsum path at the Llama-2
7B (32/32 heads) and 70B (64/8) layouts, int8 KV, batch 1-16 × window
256-4096; flash prefill (E) against the einsum prefill at T 64-1024, batch
1 and 4; and whole decode steps of 4-layer 7B and 70B models with per-layer
tuple caches under each path.  ``dataflow.attn_sweep.attn_constants``
derives them from that table by device time: flash won every measured
decode row (slab and paged) from B·window = 256, the smallest measured,
every whole step from batch 1 (the tuple caches are updated in place, so
the reference's batch-1 loss does not arise) and every prefill row, so the
einsum prefill keeps no transient budget.
"""

from __future__ import annotations

# B*window (tokens) from which decode runs the flash kernel, slab / paged:
# the smallest measured point, flash won from there on
FLASH_CROSSOVER_SLAB = 256
FLASH_CROSSOVER_PAGED = 256
# Slab decode with per-layer tuple caches below this batch stays on the
# einsum path: the flash step won at every measured batch
MIN_BATCH_FOR_FLASH_SLAB = 1
# Prefill (T > 1) takes the tiled flash kernel once the einsum path's f32
# score + prob transients, 2*4*B*H*T*window bytes, pass this: flash won at
# every measured prefill
XLA_PREFILL_TRANSIENT_BUDGET = 0


def resolve_attn(
    attn: str,
    *,
    batch: int,
    window: int,
    t: int = 1,
    paged: bool = False,
    heads: int = 0,
    stacked: bool = False,
) -> str:
    """Resolve ``"auto"`` to ``"flash"`` or ``"xla"``; any other value is
    returned as given.  ``heads`` (query heads) sizes the prefill transient.
    ``stacked``: decode reads a stacked container's planes in place (the
    hybrid and scan modes), where the reference lifts its batch gate
    (``attn_policy.py:74-109``).  On the H100 ``MIN_BATCH_FOR_FLASH_SLAB``
    is 1, so the gate lets every batch through either way and ``stacked``
    changes no route today."""
    if attn != "auto":
        return attn
    if t > 1:
        transient = 2 * 4 * batch * heads * t * window  # score + prob, f32
        return "flash" if transient > XLA_PREFILL_TRANSIENT_BUDGET else "xla"
    if not paged and not stacked and batch < MIN_BATCH_FOR_FLASH_SLAB:
        return "xla"
    threshold = FLASH_CROSSOVER_PAGED if paged else FLASH_CROSSOVER_SLAB
    return "flash" if batch * window >= threshold else "xla"
