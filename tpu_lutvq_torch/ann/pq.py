"""Product / residual quantization for ANN search (counterpart of
``tpu_lutvq.ann.pq``): the QuickerADC engine (faiss-simd/VecProductQuantizer.h)
over the port's lookup kernels.

Per query batch: distance tables by matmul (VecProductQuantizer.h:1056-1105)
→ the scan, which is the LUT-GEMV lookup with the database codes as its
output columns (``d_out = n``): bf16 tables (``table_dtype="f32"``, the JAX
package's default kernels), per-query int8 or int16 tables with exact integer
sums (QuantizerMAX, :182-298), or f32 tables for the refine bounds → top-k
over the full score matrix.  Every tensor stays on the device of its inputs.

The port differs from the JAX package in one way that does not change a
result: ``encode`` works through the database in chunks of
``ENCODE_ROWS`` rows, where the JAX package materialises ``(n, M, K)``
distances at once (16 GB for a million PQ16 codes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_lutvq_torch.ann.kmeans import kmeans
from tpu_lutvq_torch.core.config import VQConfig
from tpu_lutvq_torch.core.params import VQParams
from tpu_lutvq_torch.kernels.lut_ctor import LANE
from tpu_lutvq_torch.kernels.lut_gemv import lut_gemv_packed, pack_params

ENCODE_ROWS = 1 << 15  # database rows encoded at a time


def _codes_dtype(k: int) -> torch.dtype:
    """uint8 codes up to K = 256 (as the JAX package); int32 above, where
    the JAX package uses uint16, which torch barely supports."""
    return torch.uint8 if k <= 256 else torch.int32


def _nearest(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest row of ``c (K, d)`` per row of ``x (n, d)``."""
    c2 = (c * c).sum(dim=1)
    return torch.argmin(c2[None] - 2 * (x @ c.T), dim=1)


def _top(scores: torch.Tensor, topk: int, smallest: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted top-k values and indices per row."""
    return torch.topk(scores, topk, dim=1, largest=not smallest)


@dataclasses.dataclass
class ProductQuantizer:
    """PQ<d, M, K>: M subquantizers of K centroids over d/M dims each
    (the reference's PQ workload: sim_dataflow.py:38-42)."""

    d: int
    m: int
    k: int = 256
    centroids: Optional[torch.Tensor] = None  # (M, K, d/M)

    @property
    def dsub(self) -> int:
        return self.d // self.m

    @property
    def cfg(self) -> VQConfig:
        return VQConfig(self.d, self.m, 1, self.k)

    def train(self, generator: torch.Generator, x: torch.Tensor, iters: int = 25,
              init: str = "sample") -> "ProductQuantizer":
        """Per-subquantizer k-means (VecProductQuantizer.h:649-725)."""
        xs = x.reshape(x.shape[0], self.m, self.dsub)
        self.centroids = torch.stack([
            kmeans(generator, xs[:, mm], self.k, iters, init)[0] for mm in range(self.m)
        ])  # (M, K, dsub)
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) → (n, M) codes, the nearest centroid per subvector
        (VecProductQuantizer.h:884-938)."""
        c = self.centroids.float()
        c2 = (c * c).sum(dim=-1)  # (M, K)
        out = torch.empty((x.shape[0], self.m), dtype=_codes_dtype(self.k), device=x.device)
        for r0 in range(0, x.shape[0], ENCODE_ROWS):
            xs = x[r0 : r0 + ENCODE_ROWS].reshape(-1, self.m, self.dsub).float()
            dots = torch.einsum("nmd,mkd->nmk", xs, c)
            out[r0 : r0 + ENCODE_ROWS] = torch.argmin(c2[None] - 2.0 * dots, dim=-1)
        return out

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """(n, M) → (n, d) reconstruction (VecProductQuantizer.h:946-1007)."""
        m_idx = torch.arange(self.m, device=codes.device)[None, :]
        return self.centroids[m_idx, codes.long()].reshape(codes.shape[0], self.d)

    # --- distance tables (VecProductQuantizer.h:1023-1105) ---

    def ip_tables(self, queries: torch.Tensor) -> torch.Tensor:
        """Inner-product tables ``(q, M, K)``."""
        qs = queries.reshape(queries.shape[0], self.m, self.dsub).float()
        return torch.einsum("qmd,mkd->qmk", qs, self.centroids.float())

    def l2_tables(self, queries: torch.Tensor) -> torch.Tensor:
        """Squared-L2 tables ``||q||² − 2q·c + ||c||²`` per subvector
        (pairwise_L2sqr, :1097-1101), exact distances."""
        qs = queries.reshape(queries.shape[0], self.m, self.dsub).float()
        c = self.centroids.float()
        dots = torch.einsum("qmd,mkd->qmk", qs, c)
        c2 = (c * c).sum(dim=-1)
        q2 = (qs * qs).sum(dim=-1)
        return q2[..., None] - 2.0 * dots + c2[None]

    # --- search ---

    def search(
        self,
        queries: torch.Tensor,
        codes: torch.Tensor,
        topk: int = 10,
        metric: str = "l2",
        table_dtype: str = "f32",
        refine_groups: Optional[int] = None,
        shortlist: Optional[int] = None,
        stats: Optional[dict] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Scan the encoded database; (values, indices) of the top-k nearest
        (metric="l2", ascending) or highest-scoring (metric="ip").

        ``table_dtype``: "f32" scans with the JAX package's default tables
        (bf16 entries from two queries up, f32 for a lone query at K ≤ 128),
        "int8"/"int16" with per-query range-quantized tables and exact
        integer sums (QuantizerMAX, VecProductQuantizer.h:182-298 and the
        epi16 variants, :2369-2730).

        ``refine_groups=m0`` (L2 only) scans the first ``m0`` subquantizers
        for lower bounds, then rescores ``shortlist``-sized rounds of
        candidates exactly until no unscored bound beats the running k-th
        best: the exact top-k of the f32 tables, with ``stats`` receiving
        ``scored_frac`` (see :func:`_search_refined`)."""
        tables = self.l2_tables(queries) if metric == "l2" else self.ip_tables(queries)
        variant = {"int8": "i8", "int16": "i16"}.get(table_dtype, "auto")
        if refine_groups is not None and metric != "l2":
            # IP partial sums are not monotone bounds (terms can be negative)
            raise ValueError("refine_groups requires metric='l2' (IP partial "
                             "sums are not monotone bounds)")
        if refine_groups is not None and refine_groups < self.m:
            return _search_refined(
                self.cfg, tables, codes, topk, m0=refine_groups,
                shortlist=shortlist or max(4 * topk, 32), stats=stats,
            )
        scores = _scan_codes(self.cfg, tables, codes, variant=variant)  # (q, n)
        return _top(scores, topk, smallest=metric == "l2")


def _scan_codes(
    cfg: VQConfig,
    tables: torch.Tensor,
    codes: torch.Tensor,
    variant: str = "auto",
) -> torch.Tensor:
    """Score every database code against per-query tables through the
    lookup kernels: ``scores[q, i] = Σ_m tables[q, m, codes[i, m]]``, in
    launches of 8 queries that share one pass over the codes."""
    n = codes.shape[0]
    params = VQParams(
        codebook=torch.zeros((1, 1, 1, 1), device=codes.device),  # unused: tables given
        codes=codes.reshape(n, cfg.n_subvec, cfg.n_codebook),
    )
    packed = pack_params(cfg, params)
    lut = tables.reshape(tables.shape[0], cfg.n_groups, cfg.n_cluster).float()
    if cfg.n_cluster < LANE:
        lut = F.pad(lut, (0, LANE - cfg.n_cluster))
    return lut_gemv_packed(cfg, packed, lut, variant=variant)


def _search_refined(
    cfg: VQConfig,
    tables: torch.Tensor,  # (q, M, K) full tables
    codes: torch.Tensor,  # (n, M)
    topk: int,
    *,
    m0: int,
    shortlist: int,
    stats: Optional[dict] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bound-driven exact refine: the reference's lossless heap prune
    (VecProductQuantizer.h:1150-1152,1243-1252: skip a code whose
    partial-group lower bound ≥ the current k-th best) in batched rounds.

    1. a scan over the first ``m0`` subquantizers gives a lower bound per
       (query, code), since L2 group terms are ≥ 0;
    2. each round scores the ``shortlist`` best-bound unscored candidates
       per query exactly (a gather of their table entries) and tightens the
       running k-th best;
    3. it stops when no unscored bound beats the k-th best: every unscored
       code's distance ≥ its bound ≥ the k-th best, so the scored set holds
       the exact top-k.
    """
    q, n = tables.shape[0], codes.shape[0]
    sub_cfg = VQConfig(m0 * cfg.d_subvec, m0, cfg.n_codebook, cfg.n_cluster)
    # the bounds must come from the f32 tables: a bf16 or int8 rounding could
    # lift a bound above a true top-k member's distance and prune it
    partial = _scan_codes(sub_cfg, tables[:, :m0], codes[:, :m0], variant="f32")
    r = min(max(shortlist, topk), n)
    dev = tables.device
    m_idx = torch.arange(cfg.n_subvec, device=dev)[None, None, :]
    q_idx = torch.arange(q, device=dev)[:, None, None]
    codes_i = codes.long()
    inf = float("inf")
    exact = torch.full((q, n), inf, device=dev)  # scored entries hold exact distances
    kth = torch.full((q,), inf, device=dev)
    kk = min(topk, n)
    # f32 slack: the kernel's and torch's sum orders and the q²−2qc+c² table
    # construction can move a bound by ~1 ulp; never prune inside it
    eps = 1e-5
    while True:
        open_b = torch.where(torch.isfinite(exact), inf, partial)
        thresh = kth[:, None] * (1 + eps) + eps
        open_b = torch.where(open_b < thresh, open_b, inf)
        if not bool(torch.isfinite(open_b).any()):
            break
        cand = torch.topk(open_b, r, dim=1, largest=False).indices  # best bounds first
        sc = tables[q_idx, m_idx, codes_i[cand]].sum(dim=-1)  # (q, r)
        # rows whose bound was already ∞ (query finished) keep what they hold
        valid = torch.isfinite(torch.gather(open_b, 1, cand))
        exact.scatter_(1, cand, torch.where(valid, sc, torch.gather(exact, 1, cand)))
        kth = torch.topk(exact, kk, dim=1, largest=False).values[:, -1]
    if stats is not None:
        stats["scored_frac"] = float(torch.isfinite(exact).sum()) / (q * n)
    return _top(exact, kk, smallest=True)


@dataclasses.dataclass
class ResidualQuantizer:
    """RQ<d, N, K>: N additive codebooks trained on successive residuals
    (the reference's RQ workload, sim_dataflow.py:43-47)."""

    d: int
    n_codebooks: int
    k: int = 256
    codebooks: Optional[torch.Tensor] = None  # (N, K, d)

    @property
    def cfg(self) -> VQConfig:
        return VQConfig(self.d, 1, self.n_codebooks, self.k)

    def train(self, generator: torch.Generator, x: torch.Tensor,
              iters: int = 25) -> "ResidualQuantizer":
        resid = x.float()
        cbs = []
        for _ in range(self.n_codebooks):
            c, a = kmeans(generator, resid, self.k, iters)
            cbs.append(c)
            resid = resid - c[a]
        self.codebooks = torch.stack(cbs)  # (N, K, d)
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Greedy residual encoding → (n, N) codes."""
        out = torch.empty((x.shape[0], self.n_codebooks), dtype=_codes_dtype(self.k),
                          device=x.device)
        for r0 in range(0, x.shape[0], ENCODE_ROWS):
            resid = x[r0 : r0 + ENCODE_ROWS].float()
            for nn in range(self.n_codebooks):
                c = self.codebooks[nn]
                a = _nearest(resid, c)
                out[r0 : r0 + ENCODE_ROWS, nn] = a
                resid = resid - c[a]
        return out

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        n_idx = torch.arange(self.n_codebooks, device=codes.device)[None]
        return self.codebooks[n_idx, codes.long()].sum(dim=1)

    def search(self, queries: torch.Tensor, codes: torch.Tensor,
               topk: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
        """IP search over additive codes: score = Σ_n q·c_n[code_n]."""
        tables = torch.einsum("qd,nkd->qnk", queries.float(), self.codebooks)
        return _top(_scan_codes(self.cfg, tables, codes), topk, smallest=False)


@dataclasses.dataclass
class MixedPQ:
    """Heterogeneous sub-quantizer widths (QuickerADC's 5/5/6-bit and
    8/8-bit epi16 variants): per-subquantizer ``ks``, tables padded to the
    next power of two of ``max(ks)``; codes never index the padding."""

    d: int
    ks: tuple  # e.g. (32, 32, 64) — one K per subquantizer
    quantizers: Optional[list] = None  # per-sub centroids (K_i, dsub)

    def __post_init__(self):
        self.ks = tuple(self.ks)
        if self.d % len(self.ks):
            raise ValueError(f"d={self.d} not divisible by m={len(self.ks)}")

    @property
    def m(self) -> int:
        return len(self.ks)

    @property
    def dsub(self) -> int:
        return self.d // self.m

    @property
    def k_max(self) -> int:
        return max(self.ks)

    @property
    def cfg(self) -> VQConfig:
        return VQConfig(self.d, self.m, 1, 1 << (self.k_max - 1).bit_length())

    def train(self, generator: torch.Generator, x: torch.Tensor, iters: int = 20) -> "MixedPQ":
        xs = x.reshape(x.shape[0], self.m, self.dsub)
        self.quantizers = [kmeans(generator, xs[:, mm], k, iters)[0]
                           for mm, k in enumerate(self.ks)]
        return self

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.empty((x.shape[0], self.m), dtype=_codes_dtype(self.k_max), device=x.device)
        for r0 in range(0, x.shape[0], ENCODE_ROWS):
            xs = x[r0 : r0 + ENCODE_ROWS].reshape(-1, self.m, self.dsub).float()
            for mm, c in enumerate(self.quantizers):
                out[r0 : r0 + ENCODE_ROWS, mm] = _nearest(xs[:, mm], c)
        return out

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        rec = [self.quantizers[mm][codes[:, mm].long()] for mm in range(self.m)]
        return torch.stack(rec, dim=1).reshape(codes.shape[0], self.d)

    def search(self, queries: torch.Tensor, codes: torch.Tensor, topk: int = 10,
               metric: str = "l2") -> tuple[torch.Tensor, torch.Tensor]:
        """Scan with per-subquantizer tables zero-padded to a uniform width."""
        qs = queries.reshape(queries.shape[0], self.m, self.dsub).float()
        kp = self.cfg.n_cluster  # _scan_codes lane-pads to 128 itself
        tabs = []
        for mm, c in enumerate(self.quantizers):
            dots = qs[:, mm] @ c.float().T  # (q, K_mm)
            if metric == "l2":
                c2 = (c.float() ** 2).sum(dim=1)
                q2 = (qs[:, mm] ** 2).sum(dim=1, keepdim=True)
                t = q2 - 2 * dots + c2[None]
            else:
                t = dots
            tabs.append(F.pad(t, (0, kp - t.shape[1])))
        tables = torch.stack(tabs, dim=1)  # (q, m, kp)
        return _top(_scan_codes(self.cfg, tables, codes), topk, smallest=metric == "l2")


def sdc_tables(pq: ProductQuantizer) -> torch.Tensor:
    """Symmetric distance tables ``sdc[m, k1, k2] = ||c_m[k1] − c_m[k2]||²``
    (the reference's SDC path, VecProductQuantizer.h:1309-1387)."""
    c = pq.centroids.float()  # (M, K, d)
    c2 = (c * c).sum(dim=-1)
    dots = torch.einsum("mkd,mjd->mkj", c, c)
    return c2[:, :, None] - 2.0 * dots + c2[:, None, :]


def sdc_search(
    pq: ProductQuantizer,
    query_codes: torch.Tensor,  # (q, M) encoded queries
    db_codes: torch.Tensor,  # (n, M)
    topk: int = 10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric (code-to-code) L2 search: each query's code row selects
    its distance tables, which drive the same scan."""
    sdc = sdc_tables(pq)  # (M, K, K)
    m_idx = torch.arange(pq.m, device=sdc.device)[None, :]
    tables = sdc[m_idx, query_codes.long()]  # (q, M, K)
    return _top(_scan_codes(pq.cfg, tables, db_codes), topk, smallest=True)
