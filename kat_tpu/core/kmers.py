"""2-bit k-mer encoding and vectorized sliding-window extraction.

Data-parallel analogue of jellyfish's `mer_dna` + `mer_iterator` (reference:
deps/jellyfish-2.2.0/include/jellyfish/mer_dna.hpp:330-437 and
mer_iterator.hpp:61-89).  A k-mer (k <= 31) is a 64-bit packed integer,
represented as a pair of uint32 arrays ``(hi, lo)`` so every op stays in
native 32-bit lanes.

Packing convention (identical to jellyfish so .jf files round-trip):
  base codes A=0, C=1, G=2, T=3; the FIRST character of the k-mer occupies
  the MOST significant bit pair, i.e. ``value = sum(code[i] << 2*(k-1-i))``.
Canonical k-mer = min(forward, reverse-complement) as a 64-bit integer
(mer_dna.hpp:436 `get_canonical`).

Invalid windows (containing a non-ACGT base, or padding) get the sentinel
key 0xFFFFFFFF_FFFFFFFF, which sorts after every real k-mer for k <= 31.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Sentinel key marking invalid / padding windows. For k <= 31 no real k-mer
# reaches this value because bits 2k..63 of a real key are always zero.
SENTINEL = np.uint32(0xFFFFFFFF)

MAX_K = 31        # packed-u64 (hi, lo) fast path
MAX_K_WIDE = 255  # wide path (kmers as 2*(k//32+1) x uint32, big-first);
#                   the reference's mer_dna supports arbitrary k via word
#                   arrays (mer_dna.hpp) — 255 covers every practical
#                   k-mer use at 16 sort planes max

# 256-entry ASCII -> 2-bit code table; 4 = invalid (mirrors mer_dna::code
# returning -1 for non-ACGT, mer_dna.hpp:382).
_CODE_LUT = np.full(256, 4, dtype=np.uint8)
for _ch, _c in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _CODE_LUT[ord(_ch)] = _c
    _CODE_LUT[ord(_ch.lower())] = _c

PAD_BYTE = 0  # any byte that encodes to "invalid" works as padding


def encode_ascii(buf: np.ndarray) -> np.ndarray:
    """uint8 ASCII array -> 2-bit codes (0..3) with 4 marking invalid."""
    return _CODE_LUT[buf]


def spec_valid(k: int) -> None:
    if not (1 <= k <= MAX_K):
        raise ValueError(
            f"k={k} out of supported range [1, {MAX_K}] for the packed-u64 "
            "k-mer path")


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def extract_kmers(codes: jax.Array, k: int, canonical: bool = True):
    """Extract all k-length windows from a batch of encoded sequences.

    Args:
      codes: [..., L] uint8 array of 2-bit base codes (>=4 marks invalid /
        padding).  Any leading batch shape is preserved.
      k: k-mer length (1..31).
      canonical: if True return min(fwd, revcomp) per window
        (mer_iterator.hpp:82-87 semantics); else the forward k-mer.

    Returns:
      (hi, lo, valid): uint32/uint32/bool arrays of shape [..., L-k+1].
      Invalid windows carry the SENTINEL key.
    """
    spec_valid(k)
    L = codes.shape[-1]
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")

    c32 = codes.astype(jnp.uint32)
    fwd_hi = jnp.zeros(codes.shape[:-1] + (W,), jnp.uint32)
    fwd_lo = jnp.zeros_like(fwd_hi)
    rc_hi = jnp.zeros_like(fwd_hi)
    rc_lo = jnp.zeros_like(fwd_hi)
    bad = jnp.zeros(codes.shape[:-1] + (W,), jnp.bool_)

    # k static slices; XLA fuses the whole accumulation into one VPU pass.
    for j in range(k):
        c = jax.lax.slice_in_dim(c32, j, j + W, axis=-1)
        bad = bad | (c >= 4)
        cc = c & 3  # keep shifts well-defined for invalid lanes
        fshift = 2 * (k - 1 - j)  # position j from the left
        rshift = 2 * j            # same base lands at mirrored position in rc
        comp = cc ^ 3
        if fshift >= 32:
            fwd_hi = fwd_hi | (cc << (fshift - 32))
        else:
            fwd_lo = fwd_lo | (cc << fshift)
        if rshift >= 32:
            rc_hi = rc_hi | (comp << (rshift - 32))
        else:
            rc_lo = rc_lo | (comp << rshift)

    if canonical:
        rc_less = (rc_hi < fwd_hi) | ((rc_hi == fwd_hi) & (rc_lo < fwd_lo))
        hi = jnp.where(rc_less, rc_hi, fwd_hi)
        lo = jnp.where(rc_less, rc_lo, fwd_lo)
    else:
        hi, lo = fwd_hi, fwd_lo

    hi = jnp.where(bad, SENTINEL, hi)
    lo = jnp.where(bad, SENTINEL, lo)
    return hi, lo, ~bad


def gc_count(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """Number of G/C bases in packed k-mers (reference str_utils.hpp:151).

    With codes A=00, C=01, G=10, T=11 a base is G or C iff its two bits
    differ, so GC = popcount((x ^ (x >> 1)) & 0x5555...) per word.  Upper
    unused bits are zero for real keys so they contribute nothing.
    """
    m = jnp.uint32(0x55555555)
    g_lo = jax.lax.population_count((lo ^ (lo >> 1)) & m)
    g_hi = jax.lax.population_count((hi ^ (hi >> 1)) & m)
    return (g_lo + g_hi).astype(jnp.uint32)


def reverse_complement(hi: jax.Array, lo: jax.Array, k: int):
    """Reverse-complement of packed k-mers (mer_dna.hpp:409 semantics)."""
    spec_valid(k)

    def rev2(x):
        # Reverse 2-bit groups within a uint32 word.
        x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
        x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
        x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
        x = (x << 16) | (x >> 16)
        return x

    chi = ~hi
    clo = ~lo
    # After complement + full 64-bit 2-bit-group reversal, the k-mer sits in
    # the top 2k bits; shift right by 64-2k.
    rhi, rlo = rev2(clo), rev2(chi)  # swap words = reverse across the pair
    shift = 64 - 2 * k
    if shift == 0:
        out_hi, out_lo = rhi, rlo
    elif shift < 32:
        out_lo = (rlo >> shift) | (rhi << (32 - shift))
        out_hi = rhi >> shift
    else:
        out_lo = rhi >> (shift - 32)
        out_hi = jnp.zeros_like(rhi)
    mask_hi, mask_lo = key_mask(k)
    return out_hi & mask_hi, out_lo & mask_lo


# ---------------------------------------------------------------------------
# Wide keys: k in (31, 127] packed into 4/6/8 uint32 words, BIG-first (w[0]
# holds the most significant bits) so lexicographic multi-key sorts order
# keys numerically.  This is the analogue of mer_dna's multi-64-bit-word
# arrays (mer_dna.hpp: k-mer "as array of 64-bit words"), with the word
# count chosen per k (even counts so .jf 64-bit key packing stays aligned).
# Real keys use the low 2k bits; the sentinel is all-ones in every word.
# ---------------------------------------------------------------------------

N_WORDS_WIDE = 4  # word count for the (31, 63] range (compat constant)


def words_for_k(k: int) -> int:
    """2 for the packed-u64 fast path; 3 for k in (31, 47]; 2*(k//32+1)
    words beyond (4/6/8/10/... for k <= 63/95/127/159/...).

    The 3-word path exists because most above-31 k values sit
    in (32, 47] and a 4th sort plane costs ~25% extra compare-exchange
    work for bits that are always zero; 2k <= 94 < 96 keeps the sentinel
    unambiguous.  Beyond 47 the word count always leaves at least one
    unused high bit so the all-ones SENTINEL can never collide with a
    real key (a poly-T k-mer fills exactly 2k bits) — hence k=64 takes 6
    words, not 4."""
    if 1 <= k <= MAX_K:
        return 2
    if k <= 47:
        return 3
    if k <= MAX_K_WIDE:
        return 2 * (k // 32 + 1)
    raise ValueError(f"k={k} out of supported range [1, {MAX_K_WIDE}]")


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def extract_kmers_wide(codes: jax.Array, k: int, canonical: bool = True):
    """extract_kmers for wide k: returns (words, valid) where words is a
    words_for_k(k)-tuple of uint32 arrays, big-first."""
    if not (MAX_K < k <= MAX_K_WIDE):
        raise ValueError(f"wide path requires {MAX_K} < k <= {MAX_K_WIDE}")
    L = codes.shape[-1]
    W = L - k + 1
    if W <= 0:
        raise ValueError(f"sequence length {L} shorter than k={k}")

    c32 = codes.astype(jnp.uint32)
    nw = words_for_k(k)
    shape = codes.shape[:-1] + (W,)
    fwd = [jnp.zeros(shape, jnp.uint32) for _ in range(nw)]
    rc = [jnp.zeros(shape, jnp.uint32) for _ in range(nw)]
    bad = jnp.zeros(shape, jnp.bool_)

    for j in range(k):
        c = jax.lax.slice_in_dim(c32, j, j + W, axis=-1)
        bad = bad | (c >= 4)
        cc = c & 3
        comp = cc ^ 3
        fshift = 2 * (k - 1 - j)
        rshift = 2 * j
        fw, fb = fshift // 32, fshift % 32
        rw, rb = rshift // 32, rshift % 32
        # words are big-first: bit position b lives in word (nw-1 - b//32)
        fwd[nw - 1 - fw] = fwd[nw - 1 - fw] | (cc << fb)
        rc[nw - 1 - rw] = rc[nw - 1 - rw] | (comp << rb)

    if canonical:
        less = jnp.zeros(shape, jnp.bool_)
        eq = jnp.ones(shape, jnp.bool_)
        for w in range(nw):
            less = less | (eq & (rc[w] < fwd[w]))
            eq = eq & (rc[w] == fwd[w])
        words = tuple(jnp.where(less, rc[w], fwd[w]) for w in range(nw))
    else:
        words = tuple(fwd)

    words = tuple(jnp.where(bad, SENTINEL, w) for w in words)
    return words, ~bad


def gc_count_words(words) -> jax.Array:
    """GC count over a big-first word tuple (same bit trick as gc_count)."""
    m = jnp.uint32(0x55555555)
    total = None
    for w in words:
        g = jax.lax.population_count((w ^ (w >> 1)) & m)
        total = g if total is None else total + g
    return total.astype(jnp.uint32)


def reverse_complement_words(words, k: int):
    """Reverse-complement over a big-first 4-word key (k <= 63)."""

    def rev2(x):
        x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
        x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
        x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
        x = (x << 16) | (x >> 16)
        return x

    nw = len(words)
    # complement + full 2-bit-group reversal across the concatenated words
    rev = [rev2(~words[nw - 1 - i]) for i in range(nw)]
    # shift right by (32*nw - 2k) bits across the word array (big-first)
    shift = 32 * nw - 2 * k
    ws, bs = shift // 32, shift % 32
    out = []
    for i in range(nw):
        src = i - ws
        v = jnp.zeros_like(words[0])
        if 0 <= src < nw:
            v = rev[src] >> bs
            if bs and src - 1 >= 0:
                v = v | (rev[src - 1] << (32 - bs))
        elif bs and 0 <= src - 1 < nw:
            v = rev[src - 1] << (32 - bs)
        out.append(v)
    # mask to 2k bits
    bits = 2 * k
    masked = []
    for i in range(nw):
        top_bits = bits - 32 * (nw - 1 - i)
        if top_bits <= 0:
            masked.append(jnp.zeros_like(out[i]))
        elif top_bits >= 32:
            masked.append(out[i])
        else:
            masked.append(out[i] & jnp.uint32((1 << top_bits) - 1))
    return tuple(masked)


def canonicalize_words(words, k: int):
    """min(key, revcomp) over word tuples, preserving sentinels."""
    rcw = reverse_complement_words(words, k)
    less = jnp.zeros_like(words[0], jnp.bool_)
    eq = jnp.ones_like(words[0], jnp.bool_)
    for w in range(len(words)):
        less = less | (eq & (rcw[w] < words[w]))
        eq = eq & (rcw[w] == words[w])
    is_sent = None
    for w in words:
        s = w == SENTINEL
        is_sent = s if is_sent is None else (is_sent & s)
    return tuple(
        jnp.where(is_sent, words[i], jnp.where(less, rcw[i], words[i]))
        for i in range(len(words)))


def pack_string_words(s: str, n_words: int = N_WORDS_WIDE) -> tuple[int, ...]:
    """Host-side: ACGT string -> big-first uint32 word tuple."""
    v = pack_string(s)
    return tuple((v >> (32 * (n_words - 1 - i))) & 0xFFFFFFFF
                 for i in range(n_words))


def words_to_int(words_row) -> int:
    v = 0
    for w in words_row:
        v = (v << 32) | int(w)
    return v


def canonicalize(hi: jax.Array, lo: jax.Array, k: int):
    """min(key, revcomp(key)) per element (mer_dna.hpp:436 get_canonical),
    preserving SENTINEL padding keys (whose revcomp would otherwise alias the
    poly-A k-mer 0)."""
    rhi, rlo = reverse_complement(hi, lo, k)
    less = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    chi = jnp.where(less, rhi, hi)
    clo = jnp.where(less, rlo, lo)
    is_sent = (hi == SENTINEL) & (lo == SENTINEL)
    return (jnp.where(is_sent, hi, chi), jnp.where(is_sent, lo, clo))


def key_mask(k: int):
    """(hi, lo) uint32 masks covering the 2k used bits."""
    bits = 2 * k
    lo_bits = min(bits, 32)
    hi_bits = max(bits - 32, 0)
    lo_m = np.uint32(0xFFFFFFFF) if lo_bits == 32 else np.uint32((1 << lo_bits) - 1)
    hi_m = np.uint32((1 << hi_bits) - 1)
    return jnp.uint32(hi_m), jnp.uint32(lo_m)


# ---------------------------------------------------------------------------
# Host-side helpers (numpy; small data, used by tests/tools/goldens)
# ---------------------------------------------------------------------------

def _rev2_u64_np(x: np.ndarray) -> np.ndarray:
    """Reverse the 2-bit groups of uint64 values (vectorized host-side)."""
    m = np.uint64
    x = ((x & m(0x3333333333333333)) << m(2)) | \
        ((x >> m(2)) & m(0x3333333333333333))
    x = ((x & m(0x0F0F0F0F0F0F0F0F)) << m(4)) | \
        ((x >> m(4)) & m(0x0F0F0F0F0F0F0F0F))
    x = ((x & m(0x00FF00FF00FF00FF)) << m(8)) | \
        ((x >> m(8)) & m(0x00FF00FF00FF00FF))
    x = ((x & m(0x0000FFFF0000FFFF)) << m(16)) | \
        ((x >> m(16)) & m(0x0000FFFF0000FFFF))
    return (x << m(32)) | (x >> m(32))


def canonical_np(keys: np.ndarray, k: int) -> np.ndarray:
    """min(key, revcomp) for packed u64 keys (mer_dna.hpp:436 semantics),
    vectorized numpy — for host-side paths (checkpoint sharding, lookup
    capacity planning) that must not touch any device."""
    m = np.uint64
    keys = np.asarray(keys, np.uint64)
    rc = _rev2_u64_np(~keys) >> m(64 - 2 * k)
    rc &= m((1 << (2 * k)) - 1)
    return np.minimum(keys, rc)


def _rev2_u32_np(x: np.ndarray) -> np.ndarray:
    m = np.uint32
    x = ((x & m(0x33333333)) << m(2)) | ((x >> m(2)) & m(0x33333333))
    x = ((x & m(0x0F0F0F0F)) << m(4)) | ((x >> m(4)) & m(0x0F0F0F0F))
    x = ((x & m(0x00FF00FF)) << m(8)) | ((x >> m(8)) & m(0x00FF00FF))
    return (x << m(16)) | (x >> m(16))


def canonical_words_np(words: np.ndarray, k: int) -> np.ndarray:
    """Row-wise canonical form of big-first [n, nw] uint32 word keys
    (numpy mirror of canonicalize_words)."""
    n, nw = words.shape
    rev = np.empty_like(words)
    for i in range(nw):
        rev[:, i] = _rev2_u32_np(~words[:, nw - 1 - i])
    shift = 32 * nw - 2 * k
    ws, bs = divmod(shift, 32)
    rc = np.zeros_like(words)
    for i in range(nw):
        src = i - ws
        if 0 <= src < nw:
            v = rev[:, src] >> np.uint32(bs) if bs else rev[:, src].copy()
            if bs and src - 1 >= 0:
                v |= rev[:, src - 1] << np.uint32(32 - bs)
        elif bs and 0 <= src - 1 < nw:
            v = rev[:, src - 1] << np.uint32(32 - bs)
        else:
            v = np.zeros(n, np.uint32)
        rc[:, i] = v
    bits = 2 * k
    for i in range(nw):
        top = bits - 32 * (nw - 1 - i)
        if top <= 0:
            rc[:, i] = 0
        elif top < 32:
            rc[:, i] &= np.uint32((1 << top) - 1)
    less = np.zeros(n, np.bool_)
    eq = np.ones(n, np.bool_)
    for i in range(nw):
        less |= eq & (rc[:, i] < words[:, i])
        eq &= rc[:, i] == words[:, i]
    return np.where(less[:, None], rc, words)


def pack_string(s: str) -> int:
    """Pack an ACGT string into the 64-bit integer key (host-side)."""
    v = 0
    for ch in s:
        c = int(_CODE_LUT[ord(ch)])
        if c >= 4:
            raise ValueError(f"invalid base {ch!r}")
        v = (v << 2) | c
    return v


def unpack_string(v: int, k: int) -> str:
    out = []
    for i in range(k):
        out.append("ACGT"[(v >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def rc_int(v: int, k: int) -> int:
    r = 0
    for _ in range(k):
        r = (r << 2) | (3 - (v & 3))
        v >>= 2
    return r


def canonical_int(v: int, k: int) -> int:
    return min(v, rc_int(v, k))


def split_u64(v) -> tuple[np.uint32, np.uint32]:
    v = int(v)
    return np.uint32(v >> 32), np.uint32(v & 0xFFFFFFFF)


def join_u64(hi, lo) -> np.ndarray:
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)
