"""Device-side comparison kernels for `kat comp`.

The reference walks hash1 slice-parallel, randomly probing hash2/hash3 per
key (src/comp.cc:366-484 `compareSlice`).  Here both tables are sorted
arrays, so every "random probe" becomes a vectorized binary-search gather
and all counters/matrices/spectra are scatter-add reductions — three fused
passes instead of a mutex-merged thread pool.  Generic over narrow
(k <= 31) and wide (k <= 63) tables via core/tables.py.

Quirk parity (SURVEY §5.1.2): in the reference's pass 2 the canonical flag
argument receives a *pointer* (`src/comp.cc:447`), i.e. always true, so
pass-2 queries into hash1 are canonicalized regardless of how hash1 was
counted.  `pass2` reproduces exactly that.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import tables
from .stats import (binned_sum, binned_sums, mask_bincount,
                    monotone_packed_sums, spectrum, spectrum_bins)


def _scale_clamp(counts: jax.Array, scale: float, bins: int) -> jax.Array:
    """scaleCounter + clamp (comp.hpp:303-306, comp.cc:458-463)."""
    c = counts.astype(jnp.float64)
    scaled = jnp.where(counts == 0, 0,
                       jnp.ceil(c * scale)).astype(jnp.int64)
    return jnp.minimum(scaled, bins - 1).astype(jnp.int32)


def _maybe_canonical(words, k: int, canonical: bool):
    if canonical:
        return tables.canonicalize(words, k)
    return words


@functools.partial(jax.jit, static_argnames=(
    "k", "d1_bins", "d2_bins", "dm_size", "canon2", "canon3", "three",
    "d1_scale", "d2_scale", "sorted2", "sorted3"))
def pass1(t1, t2, t3, k: int, d1_bins: int, d2_bins: int, dm_size: int,
          d1_scale: float, d2_scale: float,
          canon2: bool, canon3: bool, three: bool,
          sorted2: bool = False, sorted3: bool = False, h2_pre=None):
    """Iterate hash1 entries; probe hash2 (and hash3).  Returns counters,
    spectra and matrices (comp.cc:366-433).

    sorted2/sorted3: the probe stream is t1's own (sorted) keys; when the
    canonicalization is an identity — no canonicalization requested, or
    t1 already stores canonical keys — the stream stays sorted and the
    join lookup skips its sort/un-permute passes (callers assert this
    from the inputs' canonical flags)."""
    real = tables.real_mask(t1)
    h1 = jnp.where(real, t1.counts, 0).astype(jnp.uint64)
    words1 = tables.key_words(t1)

    if h2_pre is not None:
        # fused cross-probe (tables.lookup_dual): pass 1 and pass 2 share
        # ONE table merge; h2_pre is already aligned with t1's slots
        h2 = jnp.where(real, h2_pre.astype(jnp.uint64), 0)
    else:
        q2 = _maybe_canonical(words1, k, canon2)
        h2 = jnp.where(real, tables.lookup(
            t2, q2, assume_sorted=sorted2).astype(jnp.uint64), 0)
    if three:
        q3 = _maybe_canonical(words1, k, canon3)
        h3 = jnp.where(real, tables.lookup(
            t3, q3, assume_sorted=sorted3).astype(jnp.uint64), 0)
    else:
        h3 = jnp.zeros_like(h1)

    w = real.astype(jnp.uint64)
    shared = real & (h1 > 0) & (h2 > 0)
    ws = shared.astype(jnp.uint64)

    counters = {
        "hash1_total": jnp.sum(h1),
        "hash1_distinct": jnp.sum(w),
        "hash1_only_total": jnp.sum(jnp.where(real & (h2 == 0), h1, 0)),
        "hash1_only_distinct": jnp.sum(w * (h2 == 0)),
        "shared_hash1_total": jnp.sum(jnp.where(shared, h1, 0)),
        "shared_hash2_total": jnp.sum(jnp.where(shared, h2, 0)),
        "shared_distinct": jnp.sum(ws),
    }
    s1 = _scale_clamp(h1, d1_scale, d1_bins)
    s2 = _scale_clamp(h2, d2_scale, d2_bins)
    if d1_scale == 1.0 and d1_bins == dm_size and \
            d1_bins * d2_bins < 2**31:
        # Default config: with a unit scale and d1_bins == dm_size,
        # _scale_clamp and spectrum_bins are the SAME integer function,
        # so the spectrum bin IS the matrix row — the spectra are the
        # high-part coarsening of the flat matrix key, and one packed key
        # yields spectrum1, shared_spectrum1 AND main_mx.
        packed = s1 * d2_bins + s2
        spectrum1, shared_spectrum1, mx = monotone_packed_sums(
            packed,
            ((d2_bins, dm_size, 0), (d2_bins, dm_size, 1),
             (1, d1_bins * d2_bins, 0)), (w, ws))
        main_mx = mx.reshape(d1_bins, d2_bins)
    else:
        # spectrum1 and shared_spectrum1 bin the SAME h1 counts
        spectrum1, shared_spectrum1 = binned_sums(
            dm_size, spectrum_bins(h1, dm_size), (w, ws))
        # s1/s2 are clamped in range, so the 2D count collapses to one
        # flat binned sum
        main_mx = binned_sum(d1_bins * d2_bins, s1 * d2_bins + s2,
                             w).reshape(d1_bins, d2_bins)
    if h2_pre is not None:
        # Under the fused dual probe the shared key set is exactly
        # symmetric (a key is shared iff stored in BOTH tables with a
        # positive count), so shared_spectrum2 — binned by h2, which is
        # t2's own count for the key — is computed on pass2's stream
        # instead, where it rides pass2's packed binning.
        # Callers sum the two contributions; this one is all zero.
        shared_spectrum2 = jnp.zeros((dm_size,), jnp.uint64)
    else:
        shared_spectrum2 = spectrum(h2, ws, dm_size)

    if three:
        s3 = _scale_clamp(h3, d2_scale, d2_bins)
        ends_w = w * (s2 == s3)
        mixed_w = w * ((s2 != s3) & (h3 > 0))
        middle_w = w * ((s2 != s3) & (h3 == 0))
        # all three matrices bin the SAME flat (s1, s3) key
        ends_mx, mixed_mx, middle_mx = (
            m.reshape(d1_bins, d2_bins) for m in binned_sums(
                d1_bins * d2_bins, s1 * d2_bins + s3,
                (ends_w, mixed_w, middle_w)))
    else:
        ends_mx = mixed_mx = middle_mx = None

    return counters, spectrum1, shared_spectrum1, shared_spectrum2, \
        main_mx, ends_mx, mixed_mx, middle_mx


@functools.partial(jax.jit, static_argnames=("k", "d2_bins", "dm_size",
                                             "d2_scale", "sorted1"))
def pass2(t2, t1, k: int, d2_bins: int, dm_size: int, d2_scale: float,
          sorted1: bool = False, h1_pre=None):
    """Iterate hash2 entries; probe hash1 (comp.cc:436-463).  Queries are
    ALWAYS canonicalized — the reference's pointer-as-bool bug (§5.1.2).
    sorted1: t2 stores canonical keys, so the always-canonicalize is an
    identity and the probe stream stays sorted (see pass1).

    Returns (counters, spectrum2, row0, shared_spectrum2) — the last is
    this pass's contribution to shared_spectrum2 (nonzero only when
    h1_pre marks the dual probe; callers add it to pass1's)."""
    real = tables.real_mask(t2)
    h2 = jnp.where(real, t2.counts, 0).astype(jnp.uint64)
    if h1_pre is not None:
        h1 = jnp.where(real, h1_pre.astype(jnp.uint64), 0)
    else:
        q1 = tables.canonicalize(tables.key_words(t2), k)
        h1 = jnp.where(real, tables.lookup(
            t1, q1, assume_sorted=sorted1).astype(jnp.uint64), 0)

    w = real.astype(jnp.uint64)
    only = real & (h1 == 0)
    counters = {
        "hash2_total": jnp.sum(h2),
        "hash2_distinct": jnp.sum(w),
        "hash2_only_total": jnp.sum(jnp.where(only, h2, 0)),
        "hash2_only_distinct": jnp.sum(w * (h1 == 0)),
    }
    # shared_spectrum2's contribution when the dual probe is active (see
    # pass1: the shared set is symmetric, so t2's stream computes it)
    want_shared2 = h1_pre is not None
    shared2 = real & (h1 > 0) & (h2 > 0)

    s2 = _scale_clamp(h2, d2_scale, d2_bins)
    spec2 = spectrum_bins(h2, dm_size)
    if dm_size * d2_bins < 2**31 and d2_scale > 0:
        # spectrum2, row0 (and shared_spectrum2) all derive from the
        # packed (spectrum bin, column) key of h2.
        packed = spec2 * d2_bins + s2
        masks = (w, only) + ((shared2,) if want_shared2 else ())
        reqs = ((d2_bins, dm_size, 0), (1, d2_bins, 1)) + (
            ((d2_bins, dm_size, 2),) if want_shared2 else ())
        outs = monotone_packed_sums(packed, reqs, masks)
        spectrum2, row0 = outs[0], outs[1]
        shared_spectrum2 = (outs[2] if want_shared2
                            else jnp.zeros((dm_size,), jnp.uint64))
    else:
        spectrum2 = spectrum(h2, w, dm_size)
        row0 = mask_bincount((d2_bins,), s2, only)
        shared_spectrum2 = (spectrum(h2, shared2, dm_size) if want_shared2
                            else jnp.zeros((dm_size,), jnp.uint64))
    return counters, spectrum2, row0, shared_spectrum2


@jax.jit
def pass3(t3):
    """Totals over hash3 (comp.cc:466-479)."""
    real = tables.real_mask(t3)
    h3 = jnp.where(real, t3.counts, 0).astype(jnp.uint64)
    return {"hash3_total": jnp.sum(h3),
            "hash3_distinct": jnp.sum(real.astype(jnp.uint64))}
