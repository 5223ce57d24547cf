"""kat_tpu — a k-mer analysis framework for accelerators, in JAX.

A ground-up JAX/XLA re-design of the capabilities of TGAC/KAT v2.4.2
(Mapleson et al., Bioinformatics 2016).  Instead of
KAT's shared-memory Jellyfish CAS hash (reference
deps/jellyfish-2.2.0/include/jellyfish/large_hash_array.hpp), the counting core
is a functional pack -> extract -> sort -> segment-reduce pipeline that runs on
the GPU, with the k-mer space hash-partitioned across devices of a
`jax.sharding.Mesh` (k-mers routed to owner shards with `all_to_all`, low-dim
results merged with `psum`).

Public surface:
    kat_tpu.core      -- 2-bit k-mer encoding, window extraction, counting
    kat_tpu.parallel  -- device-mesh sharded counting / lookup
    kat_tpu.io        -- FASTA/FASTQ readers, jellyfish .jf codec, mme headers
    kat_tpu.tools     -- hist / gcp / comp / sect / cold / filter workloads
    kat_tpu.analysis  -- spectra / peak-fitting / distribution analysis
    kat_tpu.cli       -- `kat`-compatible command line
"""

import os as _os

import jax as _jax

# Persistent XLA compilation cache.  JAX_COMPILATION_CACHE_DIR, when set,
# is honoured by JAX itself; otherwise the cache lives at one fixed path
# inside the checkout, so every run of the same code finds what an
# earlier run compiled.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

# 64-bit parity: counters/totals in the reference are uint64 and scale
# factors are C doubles (e.g. gcp.cc:190 `ceil(count * scale)`).  Hot-path
# arrays (keys, per-window data) are explicitly uint32 pairs, so this only
# affects accumulators and host-visible statistics.
_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

DEFAULT_MER_LEN = 27  # reference: lib/include/kat/jellyfish_helper.hpp:75
DEFAULT_HASH_SIZE = 100_000_000  # reference: jellyfish_helper.hpp:76
DEFAULT_NB_BINS = 1001  # reference: lib/include/kat/comp_counters.hpp:32
