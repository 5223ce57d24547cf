"""Mesh collectives that stay exact for every dtype we use.

The analysis layer keeps uint64 counters for reference parity
(CompCounters / SparseMatrix are uint64 in the reference,
lib/include/kat/comp_counters.hpp, lib/include/kat/sparse_matrix.hpp), and
not every backend lowers a 64-bit integer all-reduce.

`psum_exact` keeps the uint64 API exact by decomposing every 64-bit
integer leaf into four 16-bit limbs held in uint32, all-reducing those,
and recombining mod 2**64:

    sum_i(x_i) mod 2**64  ==  sum_j( psum(limb_j(x)) << 16j ) mod 2**64

Each limb is < 2**16, so its u32 all-reduce is overflow-free for meshes
up to 65536 devices; the recombination is modular, so signed (two's
complement) leaves come out exact as well.  The decomposition runs on
EVERY backend — the CPU test suite then exercises byte-for-byte the same
collective the GPUs run.  Whether a plain 64-bit psum over NCCL would do is
an open measurement (ROADMAP D4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_N_LIMBS = 4
_LIMB_MASK = np.uint64(0xFFFF)


def _is_wide_int(x) -> bool:
    dt = jnp.asarray(x).dtype
    return jnp.issubdtype(dt, jnp.integer) and dt.itemsize == 8


def psum_exact(tree, axis_names):
    """`jax.lax.psum` with exact 64-bit integer leaves on every backend.

    Non-64-bit leaves pass through a regular psum untouched; 64-bit
    integer leaves ride as four uint32 limb planes (one fused psum for
    the whole tree) and are recombined locally.
    """
    leaves, treedef = jax.tree.flatten(tree)
    staged = []
    for x in leaves:
        if _is_wide_int(x):
            u = jnp.asarray(x).astype(jnp.uint64)
            staged.append([((u >> np.uint64(16 * j)) & _LIMB_MASK)
                           .astype(jnp.uint32) for j in range(_N_LIMBS)])
        else:
            staged.append(x)
    summed = jax.lax.psum(staged, axis_names)
    out = []
    for x, s in zip(leaves, summed):
        if _is_wide_int(x):
            u = s[0].astype(jnp.uint64)
            for j in range(1, _N_LIMBS):
                u = u + (s[j].astype(jnp.uint64) << np.uint64(16 * j))
            out.append(u.astype(jnp.asarray(x).dtype))
        else:
            out.append(s)
    return jax.tree.unflatten(treedef, out)
