"""psum_exact: the 64-bit-integer all-reduce built from 16-bit limbs.

Not every backend lowers a 64-bit integer all-reduce, so all 64-bit
reductions ride as four 16-bit limbs in uint32.  These tests pin the
decomposition's exactness — mod-2**64 wraparound, signed leaves, mixed
trees — against python ints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kat_tpu.parallel.collectives import psum_exact

N = 8


def _mesh():
    devs = jax.devices()
    if len(devs) < N:
        pytest.skip(f"need {N} devices")
    return Mesh(np.array(devs[:N]), ("d",))


def _psum(vals):
    """Run psum_exact over the mesh on per-device values [N, ...]."""
    mesh = _mesh()

    def body(x):
        return psum_exact(x[0], ("d",))

    fn = shard_map(body, mesh=mesh, in_specs=(P("d"),), out_specs=P())
    return jax.jit(fn)(vals)


def test_u64_large_values_exact():
    rng = np.random.default_rng(0)
    # values up to 2**63: the plain u32-limb sums must carry exactly
    vals = rng.integers(0, 1 << 63, size=(N, 16), dtype=np.uint64)
    out = np.asarray(_psum(jnp.asarray(vals)))
    want = np.array([sum(int(v) for v in vals[:, j]) % (1 << 64)
                     for j in range(16)], dtype=np.uint64)
    np.testing.assert_array_equal(out, want)
    assert out.dtype == np.uint64


def test_u64_mod_2_64_wrap():
    vals = np.full((N, 3), (1 << 64) - 1, dtype=np.uint64)
    out = np.asarray(_psum(jnp.asarray(vals)))
    want = (N * ((1 << 64) - 1)) % (1 << 64)
    np.testing.assert_array_equal(out, np.full(3, want, np.uint64))


def test_i64_signed_exact():
    rng = np.random.default_rng(1)
    vals = rng.integers(-(1 << 40), 1 << 40, size=(N, 8), dtype=np.int64)
    out = np.asarray(_psum(jnp.asarray(vals)))
    np.testing.assert_array_equal(out, vals.sum(axis=0))
    assert out.dtype == np.int64


def test_mixed_tree_and_narrow_passthrough():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 62, size=(N, 4), dtype=np.uint64)
    b = rng.integers(0, 1 << 30, size=(N, 4), dtype=np.uint32)
    c = rng.integers(0, 100, size=(N,), dtype=np.int32)
    mesh = _mesh()

    def body(xa, xb, xc):
        return psum_exact({"a": xa[0], "b": xb[0], "c": xc[0]}, ("d",))

    fn = shard_map(body, mesh=mesh, in_specs=(P("d"),) * 3,
                   out_specs={"a": P(), "b": P(), "c": P()})
    out = jax.jit(fn)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    np.testing.assert_array_equal(
        np.asarray(out["a"]),
        np.array([sum(int(v) for v in a[:, j]) % (1 << 64)
                  for j in range(4)], np.uint64))
    np.testing.assert_array_equal(np.asarray(out["b"]), b.sum(axis=0,
                                                              dtype=np.uint32))
    np.testing.assert_array_equal(np.asarray(out["c"]), c.sum(axis=0,
                                                              dtype=np.int32))
    assert out["a"].dtype == jnp.uint64
    assert out["b"].dtype == jnp.uint32


def test_no_u64_in_collective_hlo():
    """The property the real chip enforces: no 64-bit all-reduce anywhere.

    Compile the sharded histogram + a psum_exact body and assert the
    lowered HLO's all-reduce ops carry no 64-bit integer operands."""
    mesh = _mesh()

    def body(x):
        h = jnp.zeros((16,), jnp.uint64).at[x[0] % 16].add(jnp.uint64(1))
        return psum_exact(h, ("d",))

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("d"),),
                           out_specs=P()))
    x = jnp.arange(N * 4, dtype=jnp.uint32).reshape(N, 4)
    hlo = fn.lower(x).compile().as_text()
    for line in hlo.splitlines():
        if "all-reduce" in line:
            assert "u64" not in line and "s64" not in line, line
