"""VQ<D,M,N,K> semantics: configs, params, golden model."""

from tpu_lutvq_torch.core.config import (  # noqa: F401
    VQConfig,
    aqlm_2x8,
    aqlm_1x16,
    pq_ann,
    rq_ann,
    tmac,
)
from tpu_lutvq_torch.core.params import VQParams, init_vq_params  # noqa: F401
