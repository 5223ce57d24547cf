"""Device-side reductions over count tables: histogram binning, GC-vs-coverage
matrices, spectra.  These replace the reference's per-thread hash-slice scans
merged at the end (histogram.cc:183-199, gcp.cc:179-197, P3/P4 in SURVEY §2.5)
with single scatter-add passes; under a mesh they run per-shard and merge with
`psum`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .counting import CountTable
from .kmers import gc_count


def mask_bincount(shape, idx, mask01, **scatter_kw) -> jax.Array:
    """Scatter-add of a 0/1 weight mask into a uint64 accumulator —
    accumulated in uint32 and widened afterwards.  Since every element
    contributes at most 1 and table capacities are < 2^32, uint32
    accumulation is exact.  idx may be an index array or a tuple (2D
    bins)."""
    acc = jnp.zeros(shape, jnp.uint32).at[idx].add(
        mask01.astype(jnp.uint32), **scatter_kw)
    return acc.astype(jnp.uint64)


def binned_sums(total_bins: int, bins: jax.Array, masks) -> tuple:
    """Sum one or more 0/1 masks into `total_bins` FLAT in-range bins,
    returned as uint64 arrays (exact: see mask_bincount).  `bins` MUST
    already be clamped in range (no drop semantics here)."""
    return tuple(mask_bincount((total_bins,), bins, m) for m in masks)


def binned_sum(total_bins: int, bins: jax.Array,
               mask01: jax.Array) -> jax.Array:
    return binned_sums(total_bins, bins, (mask01,))[0]


def monotone_packed_sums(packed: jax.Array, requests, masks) -> tuple:
    """Several binned 0/1-mask sums whose bin indices all derive from one
    packed key: ``bin = (packed // div) % mod``.

    comp packs (spectrum bin, matrix column) pairs into one key so that
    spectra, matrices and row 0 come out of a single call.  requests:
    tuple of (div, mod, mask_index).  Returns one uint64 (mod,) array per
    request."""
    return tuple(
        mask_bincount((mod,), (packed // div) % mod, masks[mi])
        for div, mod, mi in requests)


@functools.partial(jax.jit, static_argnames=("base", "ceil", "inc",
                                              "nb_buckets"))
def hist_from_counts(counts: jax.Array, base: int, ceil: int, inc: int,
                     nb_buckets: int) -> jax.Array:
    """Occurrence histogram with KAT's bucket rules (histogram.cc:188-196):
    val < base -> bucket 0; val > ceil -> last bucket; else (val-base)/inc.
    Padding entries (count 0 in a table) are excluded — jellyfish hashes
    never store zero counts.
    """
    c = counts.astype(jnp.int64)
    bucket = jnp.where(c < base, 0,
                       jnp.where(c > ceil, nb_buckets - 1,
                                 (c - base) // inc)).astype(jnp.int32)
    return binned_sums(nb_buckets, bucket, (c > 0,))[0]


@functools.partial(jax.jit, static_argnames=("mer_len", "cvg_bins"))
def gcp_matrix(table: CountTable, mer_len: int, cvg_bins: int,
               cvg_scale: float = 1.0) -> jax.Array:
    """GC-count x coverage matrix of distinct k-mers (gcp.cc:179-197).

    Returns [mer_len + 1, cvg_bins + 1] uint64; rows indexed by GC count
    (0..mer_len), columns by scaled coverage (clamped to cvg_bins).  Note the
    reference allocates `width = mer_len` and silently drops GC == mer_len
    entries at merge/print (SURVEY §5.1.3) — the writer applies that quirk.
    Generic over narrow/wide tables.
    """
    from . import tables as _tables

    gc = _tables.gc_of_keys(table).astype(jnp.int32)
    c = table.counts.astype(jnp.float64)
    cvg_pos = jnp.where(table.counts == 0, 0,
                        jnp.ceil(c * cvg_scale)).astype(jnp.int64)
    cvg_pos = jnp.minimum(cvg_pos, cvg_bins).astype(jnp.int32)
    # gc (<= mer_len by construction, incl. sentinel rows whose weight
    # is 0) and cvg_pos (clamped) are always in range, so the 2D count
    # collapses to one flat binned sum
    flat = gc * (cvg_bins + 1) + cvg_pos
    return binned_sums((mer_len + 1) * (cvg_bins + 1), flat,
                       (table.counts > 0,))[0].reshape(
        mer_len + 1, cvg_bins + 1)


@functools.partial(jax.jit, static_argnames=("nb_bins",))
def spectrum(counts: jax.Array, weights: jax.Array, nb_bins: int) -> jax.Array:
    """CompCounters::updateSpectrum (comp_counters.cc:130-140): count<=0 ->
    bin 0, count>=nb_bins -> last bin, else bin=count.  `weights` is a 0/1
    participation mask (every caller passes real/shared masks; that bound
    is what makes the uint32-accumulating scatter exact)."""
    return binned_sums(nb_bins, spectrum_bins(counts, nb_bins),
                       (weights,))[0]


def spectrum_bins(counts: jax.Array, nb_bins: int) -> jax.Array:
    """The spectrum's bin index per entry (factored so several spectra
    over the same counts can share one binned_sums call)."""
    c = counts.astype(jnp.int64)
    return jnp.where(c <= 0, 0,
                     jnp.where(c >= nb_bins, nb_bins - 1,
                               c)).astype(jnp.int32)
