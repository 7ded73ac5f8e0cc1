"""VQ scheme configuration (pure Python, identical to ``tpu_lutvq.core.config``).

Every LUT-VQ scheme is a 4-tuple ``VQ<D, M, N, K>`` (input dim, #subvectors,
#codebooks per subvector, #clusters per codebook) plus a ``vq_type`` switch
for T-MAC bit-serial codebooks (reference: vq_dataflow_sim/vq.py:4-36).  The
port keeps its own copy because importing the JAX package pulls in jax.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class VQConfig:
    """A ``VQ<D, M, N, K>`` vector-quantization scheme.

    Weight matrix ``W ∈ R^{d_out × d_in}`` is stored as codebooks + codes:

    - codebook: ``(M_cb, N, K, d)`` float, where ``d = d_in // M`` is the
      subvector width and ``M_cb ∈ {M, 1}`` (``1`` = codebook shared across
      subvectors, as in real AQLM checkpoints).
    - codes:    ``(d_out, M, N)`` integer indices in ``[0, K)``.

    ``y = W x`` is computed as LUT construction
    ``lut[m,n,k] = Σ_d codebook[m,n,k,d] · x[m·d+d]`` followed by
    lookup-accumulate ``y[j] = Σ_m Σ_n lut[m, n, codes[j,m,n]]``
    (reference: vq.py:280-302).
    """

    d_in: int
    n_subvec: int  # M
    n_codebook: int  # N
    n_cluster: int  # K
    vq_type: str = "vq"  # "vq" (random/learned codebooks) | "tmac" (bit-serial)
    shared_codebook: bool = False  # codebook shape (1, N, K, d) instead of (M, N, K, d)

    def __post_init__(self):
        if self.d_in % self.n_subvec != 0:
            raise ValueError(
                f"d_in={self.d_in} not divisible by n_subvec={self.n_subvec}"
            )
        if self.n_cluster & (self.n_cluster - 1):
            raise ValueError(f"n_cluster={self.n_cluster} must be a power of two")
        if self.vq_type not in ("vq", "tmac"):
            raise ValueError(f"unknown vq_type {self.vq_type!r}")
        if self.vq_type == "tmac" and self.n_cluster != 2**self.d_subvec:
            raise ValueError(
                "tmac requires n_cluster == 2**d_subvec "
                f"(got K={self.n_cluster}, d={self.d_subvec})"
            )

    # --- derived geometry (reference: vq.py:13-22) ---

    @property
    def d_subvec(self) -> int:
        """Subvector width d = D / M."""
        return self.d_in // self.n_subvec

    @property
    def index_bits(self) -> int:
        """Bits per stored code (BW in the reference, vq.py:21)."""
        return int(math.log2(self.n_cluster))

    @property
    def n_groups(self) -> int:
        """Total lookup groups per output element: G = M·N."""
        return self.n_subvec * self.n_codebook

    @property
    def lut_entries(self) -> int:
        """LUT entries per input vector: M·N·K."""
        return self.n_groups * self.n_cluster

    @property
    def bits_per_weight(self) -> float:
        """Effective weight precision: index bits amortized over d_subvec dims."""
        return self.n_codebook * self.index_bits / self.d_subvec

    def codes_bytes(self, d_out: int) -> int:
        """Compulsory code traffic for one layer (the VeLU floor, vq.py:253-263)."""
        return d_out * self.n_groups * self.index_bits // 8

    def codebook_shape(self) -> tuple[int, int, int, int]:
        m_cb = 1 if self.shared_codebook else self.n_subvec
        return (m_cb, self.n_codebook, self.n_cluster, self.d_subvec)

    def codebook_bytes(self, itemsize: int = 2) -> int:
        m, n, k, d = self.codebook_shape()
        return m * n * k * d * itemsize


# --- named instances (reference: vq.py:311-320, sim_dataflow.py:33-52) ---


def aqlm_2x8(d_in: int, group: int = 8, shared_codebook: bool = False) -> VQConfig:
    """AQLM "2x8": 2 additive codebooks × 256 entries over groups of ``group``.

    Reference instance: ``AQLM = (D, D//g, 2, 256)`` (sim_dataflow.py:48-52).
    """
    return VQConfig(d_in, d_in // group, 2, 256, shared_codebook=shared_codebook)


def aqlm_1x16(d_in: int, group: int = 8, shared_codebook: bool = True) -> VQConfig:
    """AQLM "1x16": one codebook of 2^16 entries (rq_lut GPU path, code1x16)."""
    return VQConfig(d_in, d_in // group, 1, 65536, shared_codebook=shared_codebook)


def pq_ann(d: int = 128, m: int = 8, k: int = 256) -> VQConfig:
    """Classic product quantization for ANN search (sim_dataflow.py:38-42)."""
    return VQConfig(d, m, 1, k)


def rq_ann(d: int = 128, n_codebooks: int = 4, k: int = 256) -> VQConfig:
    """Residual quantization: 1 subvector, additive codebooks (sim_dataflow.py:43-47)."""
    return VQConfig(d, 1, n_codebooks, k)


def tmac(d_in: int, bits: int = 4, group: int = 4) -> VQConfig:
    """T-MAC bit-serial: ``bits`` binary codebooks of ±1·2^n patterns over
    groups of ``group`` (reference: vq.py:38-62, sim_dataflow.py:33-37)."""
    return VQConfig(d_in, d_in // group, bits, 2**group, vq_type="tmac")


def llama2_shapes(model: str) -> dict[str, tuple[int, int]]:
    """(d_in, d_out) for Llama-2 projections — the reference's benchmark shapes
    (benchmark/kernel/rq_lut/benchmark_rq_gemm_cpu.py:27-37)."""
    dims = {
        "7b": (4096, 11008),
        "13b": (5120, 13824),
        "70b": (8192, 28672),
    }
    d, ffn = dims[model.lower()]
    return {
        "qkv_proj": (d, d),
        "o_proj": (d, d),
        "gate_proj": (d, ffn),
        "up_proj": (d, ffn),
        "down_proj": (ffn, d),
    }
