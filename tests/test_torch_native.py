"""The port's native host library (``tpu_lutvq_torch/csrc/lutvq_pack.cpp``
through ``tpu_lutvq_torch.utils.native``) bit for bit against its numpy
branches and the JAX package's ``tpu_lutvq.utils.native``."""

import numpy as np
import pytest

from tpu_lutvq.utils import native as jnative
from tpu_lutvq_torch.utils import native


@pytest.fixture
def numpy_branch(monkeypatch):
    """Run a call through the numpy branches (as where the library cannot build)."""
    def run(fn, *a, **kw):
        with monkeypatch.context() as m:
            m.setattr(native, "_load", lambda: None)
            return fn(*a, **kw)
    return run


def test_library_builds_from_the_port_source():
    assert native.have_native()
    assert native.SOURCE.name == "lutvq_pack.cpp" and native.SOURCE.parent.name == "csrc"
    assert "tpu_lutvq_torch" in str(native.SOURCE)
    assert native._load().lutvq_abi_version() == native.ABI_VERSION


@pytest.mark.parametrize("shape", [(217, 403), (1, 64), (64, 1), (1024, 256)])
def test_transpose_u8(shape, numpy_branch):
    a = np.random.RandomState(sum(shape)).randint(0, 256, size=shape).astype(np.uint8)
    got = native.transpose_u8(a)
    assert got.flags.c_contiguous and got.shape == shape[::-1]
    np.testing.assert_array_equal(got, a.T)
    np.testing.assert_array_equal(got, numpy_branch(native.transpose_u8, a))
    np.testing.assert_array_equal(got, jnative.transpose_u8(a))


@pytest.mark.parametrize("local,local_pad,shards,fill", [(4, 6, 3, 7), (512, 1024, 2, 0),
                                                          (5, 5, 4, 1)])
def test_shard_repack_u8(local, local_pad, shards, fill, numpy_branch):
    a = np.random.RandomState(local).randint(0, 256, size=(9, local * shards)).astype(np.uint8)
    got = native.shard_repack_u8(a, local, local_pad, shards, fill)
    assert got.shape == (9, local_pad * shards)
    np.testing.assert_array_equal(got, numpy_branch(native.shard_repack_u8, a, local,
                                                    local_pad, shards, fill))
    np.testing.assert_array_equal(got, jnative.shard_repack_u8(a, local, local_pad, shards,
                                                               fill))


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("d_out,m,n,k,g", [(37, 6, 2, 64, 8), (16, 4, 1, 65536, 8),
                                           (8, 3, 2, 16, 72)])
def test_dequant_additive(d_out, m, n, k, g, scaled, numpy_branch):
    """Bit-equal to the numpy branch and to JAX's (native or numpy); g > 64
    takes the numpy branch in both packages."""
    rng = np.random.RandomState(d_out + g)
    codes = rng.randint(0, k, size=(d_out, m, n)).astype(np.uint16 if k > 256 else np.int64)
    cb = rng.randn(n, k, g).astype(np.float32)
    sc = (1 + 0.1 * rng.randn(d_out)).astype(np.float32) if scaled else None
    got = native.dequant_additive(codes, cb, sc)
    assert got.dtype == np.float32 and got.shape == (d_out, m * g)
    np.testing.assert_array_equal(got, numpy_branch(native.dequant_additive, codes, cb, sc))
    np.testing.assert_array_equal(got, jnative.dequant_additive(codes.astype(np.int64), cb, sc))


def test_nibble_packs_match_reference():
    codes = np.random.RandomState(3).randint(0, 16, size=(33, 64)).astype(np.uint8)
    packed = native.pack_nibbles_np(codes)
    np.testing.assert_array_equal(packed, jnative.pack_nibbles_np(codes))
    np.testing.assert_array_equal(native.unpack_nibbles_np(packed), codes)
