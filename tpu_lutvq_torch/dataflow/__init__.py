"""The traffic model of the projection strategies on the H100
(``traffic``), the sweep that measures them on the card (``sweep``) and the
attention crossover (``attn_sweep``)."""

from tpu_lutvq_torch.dataflow.chips import CHIPS, ChipSpec, default_chip  # noqa: F401
from tpu_lutvq_torch.dataflow.traffic import (  # noqa: F401
    STRATEGIES,
    KernelCost,
    estimate,
    pick_strategy,
)
