"""Minimizer-bucketed key transform for a chunked counting flush.

If the fresh stream arrives PRE-GROUPED into buckets that are a prefix of
the sort order, each aligned chunk can sort independently, with work
capped at the chunk size instead of the whole flush — the KMC2/minimizer
super-k-mer idea (PAPERS.md) recast for fixed shapes:
the variable-length grouping happens on the host (native/fastxio.cpp
router) where shapes are free, and the device only ever sees fixed
[chunks, slots] geometry.

The transformed key makes bucket bits FREE instead of costing spare key
bits.  All k-mers of one bucket share an m-base minimizer, so the key is
re-encoded without its redundant minimizer bases:

    key' = [ mix26(minimizer) | pos | strand | rest ]
           (26 + 5 + 1 + 2(k-m) bits)

  - minimizer: the smallest canonical m-mer (min of substring and its
    reverse complement) over the canonical k-mer's k-m+1 positions —
    strand-symmetric, so consecutive read windows share it regardless of
    which strand each window's canonical form takes (supermer runs
    survive canonical strand flips).
  - mix26: an INVERTIBLE 26-bit mixer, so key' top bits are uniform for
    any genome (raw minimizers are heavily skewed — poly-A — which would
    blow up fixed bucket capacities); invertibility lets finish() decode
    the table back to plain canonical keys.
  - pos: leftmost position of the minimizer in the canonical k-mer
    (5 bits, k-m+1 <= 17 positions for k <= 29).
  - strand: 1 iff the canonical m-mer at pos is the reverse complement
    of the k-mer's forward substring there (m is odd, so never both) —
    without it the substring bases cannot be reconstructed.
  - rest: the other 2(k-m) bits of the k-mer, in order.

key' <-> key is a bijection, so equal counts aggregate identically; the
count table is simply sorted by key' during counting and re-sorted by
key once at finish().  Buckets = top bits of key' = top bits of
mix26(minimizer): every k-mer occurrence lands in the bucket its
supermer was routed to, and bucket order IS key' order, so concatenated
sorted chunks form a globally sorted stream.

Bit budget: 31 + 2(k-m) <= 64 requires k <= m + 16; with m=13 the path
covers k in (13, 29].

No counter consumes the transform at present: it and the host router are
kept for minimizer-partitioned counting passes (ROADMAP R2(b)).

Reference role: replaces nothing in KAT/jellyfish (the reference sorts
nothing); this is the device-side analogue of KMC2's signature-partitioned
bins [Deorowicz et al., PAPERS.md].
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .kmers import SENTINEL, reverse_complement

M_DEFAULT = 13
M26 = (1 << 26) - 1
POS_BITS = 5

# Invertible 26-bit mixer constants (odd multipliers; the xorshift by 13
# is its own inverse since 13 >= 26/2).  Inverses are mod-2^26 modular
# inverses, precomputed here so host (C++), oracle and device all agree.
_MIX_A = 41474379   # odd, ~2^26 * golden ratio
_MIX_B = 56006713   # odd
_MIX_A_INV = pow(_MIX_A, -1, 1 << 26)
_MIX_B_INV = pow(_MIX_B, -1, 1 << 26)


def supports(k: int, m: int = M_DEFAULT) -> bool:
    """Can the bucketed path encode k with this minimizer width?  m must
    be odd (no self-rc m-mers, so the strand bit is unambiguous)."""
    return m < k <= m + 16 and m <= 15 and m % 2 == 1


def keyp_bits(k: int, m: int = M_DEFAULT) -> int:
    return 2 * m + POS_BITS + 1 + 2 * (k - m)


def mix26(x):
    """Invertible mixer on 26-bit values (jnp/np uint32 arrays or ints)."""
    if isinstance(x, int):
        x ^= x >> 13
        x = (x * _MIX_A) & M26
        x ^= x >> 13
        x = (x * _MIX_B) & M26
        x ^= x >> 13
        return x
    u = jnp.uint32 if isinstance(x, jax.Array) else np.uint32
    m26 = u(M26)
    x = x ^ (x >> u(13))
    x = (x * u(_MIX_A)) & m26
    x = x ^ (x >> u(13))
    x = (x * u(_MIX_B)) & m26
    x = x ^ (x >> u(13))
    return x


def unmix26(x):
    """Inverse of mix26."""
    if isinstance(x, int):
        x ^= x >> 13
        x = (x * _MIX_B_INV) & M26
        x ^= x >> 13
        x = (x * _MIX_A_INV) & M26
        x ^= x >> 13
        return x
    u = jnp.uint32 if isinstance(x, jax.Array) else np.uint32
    m26 = u(M26)
    x = x ^ (x >> u(13))
    x = (x * u(_MIX_B_INV)) & m26
    x = x ^ (x >> u(13))
    x = (x * u(_MIX_A_INV)) & m26
    x = x ^ (x >> u(13))
    return x


def _rc26(x, m: int):
    """Canonical-strand complement of a 2m-bit packed m-mer (vector)."""
    u = jnp.uint32
    mask = u((1 << (2 * m)) - 1)
    y = (~x) & mask
    # reverse 2-bit groups within 32 bits, then realign to 2m bits
    y32 = ((y & u(0x33333333)) << u(2)) | ((y >> u(2)) & u(0x33333333))
    y32 = ((y32 & u(0x0F0F0F0F)) << u(4)) | ((y32 >> u(4)) & u(0x0F0F0F0F))
    y32 = ((y32 & u(0x00FF00FF)) << u(8)) | ((y32 >> u(8)) & u(0x00FF00FF))
    y32 = (y32 << u(16)) | (y32 >> u(16))
    return (y32 >> u(32 - 2 * m)) & mask


def _extract_bits(hi, lo, shift: int, width: int):
    """bits [shift, shift+width) of a (hi, lo) u64 pair, width <= 26,
    static shift — returns uint32."""
    u = jnp.uint32
    mask = u((1 << width) - 1)
    if shift >= 32:
        v = hi >> u(shift - 32)
    elif shift + width <= 32:
        v = lo >> u(shift)
    else:
        v = (lo >> u(shift)) | (hi << u(32 - shift))
    return v & mask


def _shl64(hi, lo, s):
    """(hi, lo) << s for a TRACED per-element shift s in [0, 63]."""
    u = jnp.uint32
    s = s.astype(jnp.uint32)
    big = s >= u(32)
    sb = jnp.where(big, s - u(32), s)
    # s < 32 branch (lo >> (32-s) is poison at s=0; mask it)
    hi_small = jnp.where(
        sb == 0, hi, (hi << sb) | (lo >> (u(32) - jnp.maximum(sb, u(1)))))
    lo_small = lo << sb
    hi_out = jnp.where(big, lo << sb, hi_small)
    lo_out = jnp.where(big, u(0), lo_small)
    return hi_out, lo_out


def _shr64(hi, lo, s):
    """(hi, lo) >> s for a TRACED per-element shift s in [0, 63]."""
    u = jnp.uint32
    s = s.astype(jnp.uint32)
    big = s >= u(32)
    sb = jnp.where(big, s - u(32), s)
    lo_small = jnp.where(
        sb == 0, lo, (lo >> sb) | (hi << (u(32) - jnp.maximum(sb, u(1)))))
    hi_small = hi >> sb
    lo_out = jnp.where(big, hi >> sb, lo_small)
    hi_out = jnp.where(big, u(0), hi_small)
    return hi_out, lo_out


def minimizer_device(chi, clo, k: int, m: int = M_DEFAULT):
    """(min_value, leftmost_pos) of the canonical m-mers over a packed
    canonical k-mer (vectorized).  Positions scan the canonical
    orientation; rc m-mers come from the whole-key reverse complement
    (the m-mer at canonical pos j is the rc of the rc-key's m-mer at
    k-m-j), so each position costs two static extracts + a min."""
    rhi, rlo = reverse_complement(chi, clo, k)
    minval = jnp.full(chi.shape, M26 + 1, jnp.uint32)
    minpos = jnp.zeros(chi.shape, jnp.uint32)
    strand = jnp.zeros(chi.shape, jnp.uint32)
    for j in range(k - m + 1):
        # base i occupies bits [2(k-1-i), 2(k-i)); m-mer at pos j spans
        # bases j..j+m-1 -> bits [2(k-j-m), 2(k-j))
        f = _extract_bits(chi, clo, 2 * (k - j - m), 2 * m)
        # the rc-strand m-mer at canonical pos j is the rc key's m-mer at
        # pos k-m-j, i.e. bits [2j, 2j + 2m)
        r = _extract_bits(rhi, rlo, 2 * j, 2 * m)
        cm = jnp.minimum(f, r)
        upd = cm < minval
        minval = jnp.where(upd, cm, minval)
        minpos = jnp.where(upd, jnp.uint32(j), minpos)
        strand = jnp.where(upd, jnp.where(r < f, jnp.uint32(1),
                                          jnp.uint32(0)), strand)
    return minval, minpos, strand


def _assemble_keyp(chi, clo, minval, minpos, strand, k: int, m: int):
    """key' assembly from a canonical key + its minimizer triple."""
    u = jnp.uint32
    mixv = mix26(minval)
    rb = 2 * (k - m)
    # rest = bases [0, pos) ++ bases [pos+m, k)
    bot_bits = (u(2) * (u(k - m) - minpos)).astype(jnp.uint32)
    top_hi, top_lo = _shr64(chi, clo, u(2 * m) + bot_bits)  # bases < pos
    bot_mask_hi, bot_mask_lo = _shl64(
        jnp.zeros_like(chi), jnp.ones_like(clo), bot_bits)
    # (1 << bot_bits) - 1 as a u64 pair
    bm_lo = bot_mask_lo - u(1)
    bm_hi = bot_mask_hi - jnp.where(bot_mask_lo == 0, u(1), u(0))
    bot_hi = chi & bm_hi
    bot_lo = clo & bm_lo
    rest_hi, rest_lo = _shl64(top_hi, top_lo, bot_bits)
    rest_hi = rest_hi | bot_hi
    rest_lo = rest_lo | bot_lo
    # key' = mixv << (POS_BITS+1+rb) | pos << (1+rb) | strand << rb | rest
    # (rb static; head has 32 bits)
    head = (((mixv << u(POS_BITS)) | minpos) << u(1)) | strand
    if rb >= 32:
        hh, hl = head << u(rb - 32) if rb > 32 else head, \
            jnp.zeros_like(clo)
    elif rb == 0:
        hh, hl = jnp.zeros_like(chi), head
    else:
        hh, hl = head >> u(32 - rb), head << u(rb)
    khi = hh | rest_hi
    klo = hl | rest_lo
    is_sent = (chi == SENTINEL) & (clo == SENTINEL)
    return (jnp.where(is_sent, chi, khi), jnp.where(is_sent, clo, klo))


@functools.partial(jax.jit, static_argnames=("k", "m"))
def encode_keys(chi, clo, k: int, m: int = M_DEFAULT):
    """Canonical packed keys -> transformed key' (hi, lo) pairs.

    SENTINEL keys pass through unchanged (they still sort last: key' has
    at most 64 bits whose top 6 come from mixv < 2^26, so key'hi can
    never reach 0xFFFFFFFF)."""
    if not supports(k, m):
        raise ValueError(f"bucketed path unsupported for k={k}, m={m}")
    minval, minpos, strand = minimizer_device(chi, clo, k, m)
    return _assemble_keyp(chi, clo, minval, minpos, strand, k, m)


@functools.partial(jax.jit, static_argnames=("k", "m"))
def decode_keys(khi, klo, k: int, m: int = M_DEFAULT):
    """Inverse of encode_keys (SENTINEL passthrough)."""
    if not supports(k, m):
        raise ValueError(f"bucketed path unsupported for k={k}, m={m}")
    u = jnp.uint32
    rb = 2 * (k - m)
    head_hi, head_lo = _shr64(khi, klo, jnp.full(khi.shape, rb, jnp.uint32))
    del head_hi  # head has 32 bits
    strand = head_lo & u(1)
    minpos = (head_lo >> u(1)) & u((1 << POS_BITS) - 1)
    minval = unmix26((head_lo >> u(1 + POS_BITS)) & u(M26))
    # the k-mer's forward substring at minpos: rc of minval if the
    # canonical m-mer was the rc strand
    sub = jnp.where(strand != 0, _rc26(minval, m), minval)
    # rest = key' & ((1 << rb) - 1)
    if rb >= 32:
        rest_hi = khi & u((1 << (rb - 32)) - 1)
        rest_lo = klo
    else:
        rest_hi = jnp.zeros_like(khi)
        rest_lo = klo & u((1 << rb) - 1)
    bot_bits = (u(2) * (u(k - m) - minpos)).astype(jnp.uint32)
    top_hi, top_lo = _shr64(rest_hi, rest_lo, bot_bits)
    one_hi, one_lo = _shl64(jnp.zeros_like(khi), jnp.ones_like(klo),
                            bot_bits)
    bm_lo = one_lo - u(1)
    bm_hi = one_hi - jnp.where(one_lo == 0, u(1), u(0))
    bot_hi = rest_hi & bm_hi
    bot_lo = rest_lo & bm_lo
    # C = ((top << 2m) | sub) << bot_bits | bot
    mid_hi, mid_lo = _shl64(top_hi, top_lo,
                            jnp.full(khi.shape, 2 * m, jnp.uint32))
    mid_lo = mid_lo | sub
    chi, clo = _shl64(mid_hi, mid_lo, bot_bits)
    chi = chi | bot_hi
    clo = clo | bot_lo
    is_sent = (khi == SENTINEL) & (klo == SENTINEL)
    return (jnp.where(is_sent, khi, chi), jnp.where(is_sent, klo, clo))


# ---------------------------------------------------------------------------
# Supermer records: the host router's on-the-wire format.
#
# One u64 per record: [ len (3 bits, 63..61) | bases (2*(k-1+S) bits,
# LEFT-aligned at bit 2*(k-1+S)-1 .. 0 of the field) ], where
# S = rec_windows(k) is the fixed per-record window budget.  A record
# holds `len` consecutive windows (len in 0..S; 0 = padding record);
# window j of a record spans bases j..j+k-1, i.e. bits
# [F - 2(k+j), F - 2j) with F = 2*(k-1+S).  Bases beyond the used
# k-1+len prefix are zero and never read.
# ---------------------------------------------------------------------------


def rec_windows(k: int) -> int:
    """Windows per u64 supermer record: the largest POWER OF TWO S with
    2*(k-1+S) + 3 <= 64 (pow2 so chunk_slots = rec_per_chunk * S stays a
    power of two for the chunked sort geometry); len field is 3 bits."""
    s = (64 - 3) // 2 - (k - 1)
    if s < 1:
        raise ValueError(f"k={k} too large for u64 supermer records")
    return 4 if s >= 4 else (2 if s >= 2 else 1)


def _rc_field(bhi, blo, width_bits: int):
    """Reverse complement of a packed base field of STATIC width (<= 61
    bits) held in a u32 pair — one whole-record computation that every
    window and minimizer candidate then reads with static shifts."""
    u = jnp.uint32

    def rev2(x):
        x = ((x & u(0x33333333)) << u(2)) | ((x >> u(2)) & u(0x33333333))
        x = ((x & u(0x0F0F0F0F)) << u(4)) | ((x >> u(4)) & u(0x0F0F0F0F))
        x = ((x & u(0x00FF00FF)) << u(8)) | ((x >> u(8)) & u(0x00FF00FF))
        return (x << u(16)) | (x >> u(16))

    # complement, reverse 2-bit groups across the 64-bit pair, then
    # realign so the field sits in the low `width_bits`
    rhi, rlo = rev2(~blo), rev2(~bhi)
    sh = 64 - width_bits  # in [3, 32] for k >= 14 .. fields <= 61 bits
    if sh == 32:
        out_hi, out_lo = jnp.zeros_like(rhi), rhi
    elif sh < 32:
        out_lo = (rlo >> u(sh)) | (rhi << u(32 - sh))
        out_hi = rhi >> u(sh)
    else:
        out_lo = rhi >> u(sh - 32)
        out_hi = jnp.zeros_like(rhi)
    mask_hi = u((1 << (width_bits - 32)) - 1) if width_bits > 32 else u(0)
    return out_hi & mask_hi, out_lo


@functools.partial(jax.jit, static_argnames=("k", "m", "canonical"))
def expand_records(rhi, rlo, k: int, m: int = M_DEFAULT,
                   canonical: bool = True):
    """Supermer records -> per-window transformed keys.

    Cost structure: the record's reverse complement is computed ONCE (_rc_field), so every window's rc and
    every minimizer candidate's rc strand are static extracts; candidate
    (value, pos, strand) triples pack into ONE u32 whose min is the
    leftmost minimizer (26-bit value | 5-bit pos | strand — value-major,
    earliest pos on ties), computed per RECORD position and min-reduced
    per window.

    Args:
      rhi/rlo: uint32 halves of the u64 records, ANY shape (kept).
    Returns:
      (khi, klo, valid): [rec_windows(k), *rhi.shape] uint32 key' planes
      (SENTINEL in invalid slots) — window-major so every op runs on the
      record array's own (wide-minor-dim) tiling; the caller reshapes
      into chunk slots.  Within-chunk slot ORDER is irrelevant (the
      chunked sort normalizes it), only chunk MEMBERSHIP matters.
    """
    if not canonical:
        raise ValueError("bucketed path requires canonical counting")
    u = jnp.uint32
    S = rec_windows(k)
    F = 2 * (k - 1 + S)
    ln = (rhi >> u(29)).astype(jnp.uint32)  # bits 61..63 of the u64
    bhi = rhi & u(0x1FFFFFFF)               # bases field, high word
    blo = rlo
    ghi, glo = _rc_field(bhi, blo, F)       # rc of the whole record

    # minimizer candidates per RECORD position t (m-mer over bases
    # t..t+m-1): fwd from the record, rc from the record's rc (the m-mer
    # at t maps to rc position F/2 - m - t), packed value-major
    n_cand = (k - m) + S  # positions 0 .. k-m+S-1
    cand = []      # pos-field = t: min-reduce keeps FORWARD-leftmost ties
    cand_rev = []  # pos-field = n_cand-1-t: keeps FORWARD-RIGHTMOST ties
    #                (= canonical-leftmost when the window canonicalizes
    #                to the rc strand — the tie rule must follow the
    #                CANONICAL orientation or equal k-mers arriving via
    #                opposite strands would encode different key')
    for t in range(n_cand):
        f = _extract_bits(bhi, blo, F - 2 * (t + m), 2 * m)
        r = _extract_bits(ghi, glo, 2 * t, 2 * m)
        cm = jnp.minimum(f, r)
        strand = jnp.where(r < f, u(1), u(0))
        cand.append((cm << u(POS_BITS + 1)) | (u(t) << u(1)) | strand)
        cand_rev.append((cm << u(POS_BITS + 1))
                        | (u(n_cand - 1 - t) << u(1)) | strand)

    mask_hi = u((1 << (2 * k - 32)) - 1) if 2 * k > 32 else u(0)
    lo_mask = u(0xFFFFFFFF) if 2 * k >= 32 else u((1 << (2 * k)) - 1)
    khis, klos, valids = [], [], []
    for j in range(S):
        # window j = bits [shift, shift + 2k) of the bases field
        shift = F - 2 * (k + j)  # <= 2(S-1) < 32
        if shift == 0:
            fl = blo
        else:
            fl = (blo >> u(shift)) | (bhi << u(32 - shift))
        fh = (bhi >> u(shift)) & mask_hi
        fl = fl & lo_mask
        # window rc from the record rc: same window, mirrored offset
        rshift = 2 * j
        if rshift == 0:
            rl = glo
        else:
            rl = (glo >> u(rshift)) | (ghi << u(32 - rshift))
        rh = _extract_bits(ghi, glo, rshift + 32, 2 * k - 32) \
            if 2 * k > 32 else jnp.zeros_like(ghi)
        rl = rl & lo_mask
        rc_less = (rh < fh) | ((rh == fh) & (rl < fl))
        chi = jnp.where(rc_less, rh, fh)
        clo = jnp.where(rc_less, rl, fl)
        # minimizer of window j = min over candidates t in [j, j+k-m];
        # the tie orientation follows the window's canonical strand
        best_f = cand[j]
        best_r = cand_rev[j]
        for t in range(j + 1, j + (k - m) + 1):
            best_f = jnp.minimum(best_f, cand[t])
            best_r = jnp.minimum(best_r, cand_rev[t])
        best = jnp.where(rc_less, best_r, best_f)
        minval = best >> u(POS_BITS + 1)
        pos_field = (best >> u(1)) & u((1 << POS_BITS) - 1)
        pos_rec = jnp.where(rc_less, u(n_cand - 1) - pos_field,
                            pos_field)
        strand = best & u(1)
        minpos = pos_rec - u(j)  # window-relative (forward orientation)
        # the candidate scan ran on the FORWARD record; for rc-strand
        # windows mirror the position and flip the strand bit
        minpos = jnp.where(rc_less, u(k - m) - minpos, minpos)
        strand = jnp.where(rc_less, strand ^ u(1), strand)
        khi_j, klo_j = _assemble_keyp(chi, clo, minval, minpos, strand,
                                      k, m)
        valid = jnp.uint32(j) < ln
        khis.append(jnp.where(valid, khi_j, SENTINEL))
        klos.append(jnp.where(valid, klo_j, SENTINEL))
        valids.append(valid)
    khi = jnp.stack(khis, axis=0)
    klo = jnp.stack(klos, axis=0)
    valid = jnp.stack(valids, axis=0)
    return khi, klo, valid


def bucket_of_keyp(khi, klo, k: int, m: int = M_DEFAULT,
                   bucket_bits: int = 12):
    """Bucket id = top bucket_bits of key' (pure function of the key)."""
    kb = keyp_bits(k, m)
    sh = kb - bucket_bits
    u = jnp.uint32
    if sh >= 32:
        return (khi >> u(sh - 32)) & u((1 << bucket_bits) - 1)
    return (((khi << u(32 - sh)) | (klo >> u(sh)))
            & u((1 << bucket_bits) - 1))
