"""Carry JAX-package parameters into the port.

The inputs are the JAX package's pytrees with every leaf already turned
into a numpy array (``jax.tree.map(np.asarray, tree)``), or its ANN
objects, whose array fields anything ``np.array`` takes may fill.  This
module needs no jax: it reads the containers' fields by name.  Every
function puts its tensors on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_lutvq_torch.ann.opq import OPQ
from tpu_lutvq_torch.ann.pq import MixedPQ, ProductQuantizer, ResidualQuantizer
from tpu_lutvq_torch.kernels.lut_gemv import PackedVQ
from tpu_lutvq_torch.models.kv_cache import KVCache
from tpu_lutvq_torch.models.linear import DenseLinear, QuantizedLinear
from tpu_lutvq_torch.models.paged_cache import PagedKVCache
from tpu_lutvq_torch.models.llama import LayerWeights, LlamaConfig, LlamaWeights

_PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy → torch, including ml_dtypes' bfloat16 (bit-exact)."""
    a = np.array(a)  # a writable copy: jax hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def packed_from_numpy(p, device="cuda") -> PackedVQ:
    """A JAX ``PackedVQ`` (numpy leaves) → the port's, nibble, out_group
    and shard packs included."""

    def opt(a):
        return None if a is None else tensor_from_numpy(a, device)

    return PackedVQ(
        codes_t=tensor_from_numpy(p.codes_t, device),
        codebook=tensor_from_numpy(p.codebook, device),
        scales=opt(p.scales),
        d_out=int(p.d_out),
        shards=int(p.shards),
        nibbles=bool(p.nibbles),
        out_group=int(p.out_group),
        zero_points=opt(p.zero_points),
    )


def llama_from_numpy(cfg: LlamaConfig, tree, device="cuda") -> LlamaWeights:
    """A JAX ``LlamaWeights`` (per-layer tuple, numpy leaves) → the port's."""
    if len(tree.layers) != cfg.n_layers:
        raise ValueError(
            f"tree has {len(tree.layers)} layers, cfg {cfg.n_layers} "
            "(stacked weights are not ported)"
        )
    layers = tuple(
        LayerWeights(
            attn_norm=tensor_from_numpy(lw.attn_norm, device),
            mlp_norm=tensor_from_numpy(lw.mlp_norm, device),
            **{
                name: QuantizedLinear(packed_from_numpy(getattr(lw, name).packed, device))
                for name in _PROJECTIONS
            },
        )
        for lw in tree.layers
    )
    return LlamaWeights(
        embed=tensor_from_numpy(tree.embed, device),
        layers=layers,
        final_norm=tensor_from_numpy(tree.final_norm, device),
        lm_head=DenseLinear(tensor_from_numpy(tree.lm_head.w, device)),
    )


def kv_caches_from_numpy(caches, device="cuda") -> tuple[KVCache, ...]:
    """The JAX package's per-layer slab caches (numpy leaves) → the port's."""
    return tuple(
        KVCache(*(tensor_from_numpy(getattr(c, f), device) for f in KVCache._fields))
        for c in caches
    )


def paged_caches_from_numpy(caches, device="cuda") -> tuple[PagedKVCache, ...]:
    """The JAX package's per-layer paged caches (numpy leaves) → the port's."""
    return tuple(
        PagedKVCache(*(tensor_from_numpy(getattr(c, f), device) for f in PagedKVCache._fields))
        for c in caches
    )


def pq_from_numpy(pq, device="cuda") -> ProductQuantizer:
    """A JAX ``ProductQuantizer`` → the port's, with its centroids."""
    return ProductQuantizer(int(pq.d), int(pq.m), int(pq.k),
                            centroids=tensor_from_numpy(pq.centroids, device))


def rq_from_numpy(rq, device="cuda") -> ResidualQuantizer:
    """A JAX ``ResidualQuantizer`` → the port's, with its codebooks."""
    return ResidualQuantizer(int(rq.d), int(rq.n_codebooks), int(rq.k),
                             codebooks=tensor_from_numpy(rq.codebooks, device))


def mixed_pq_from_numpy(mpq, device="cuda") -> MixedPQ:
    """A JAX ``MixedPQ`` → the port's, with each subquantizer's centroids."""
    return MixedPQ(int(mpq.d), tuple(int(k) for k in mpq.ks),
                   quantizers=[tensor_from_numpy(c, device) for c in mpq.quantizers])


def opq_from_numpy(opq, device="cuda") -> OPQ:
    """A JAX ``OPQ`` → the port's: the rotation and the PQ behind it."""
    return OPQ(int(opq.d), int(opq.m), int(opq.k),
               rotation=tensor_from_numpy(opq.rotation, device),
               pq=pq_from_numpy(opq.pq, device))
