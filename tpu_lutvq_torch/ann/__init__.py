"""ANN search engine: k-means, PQ/RQ/mixed-width PQ with f32, int8 and int16
table scans, SDC and OPQ (counterpart of ``tpu_lutvq.ann``)."""

from tpu_lutvq_torch.ann.kmeans import kmeans  # noqa: F401
from tpu_lutvq_torch.ann.pq import ProductQuantizer, ResidualQuantizer  # noqa: F401
from tpu_lutvq_torch.ann.opq import OPQ  # noqa: F401
