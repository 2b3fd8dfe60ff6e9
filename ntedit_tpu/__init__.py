"""ntedit_tpu — genome polishing & SNV detection on an accelerator.

A from-scratch re-design of the capabilities of bcgsc/ntEdit v2.1.1
(reference layout documented in SURVEY.md) built on JAX/XLA: dense
prefix-scan rolling-hash flagging, device-resident Bloom filters, and an
exact native repair engine over sharded contig windows.
"""

__version__ = "0.1.0"

import os as _os

# Fixed in-checkout location used when JAX_COMPILATION_CACHE_DIR is unset.
# The path is part of JAX's cache key, so it never depends on a temporary
# name, a process id or the time.
DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _enable_persistent_compile_cache() -> None:
    """Persist compiled dense-pass programs across processes (reference
    analogue: the engine is a compiled-once C++ binary — here one cached
    XLA program serves every invocation).  JAX reads
    JAX_COMPILATION_CACHE_DIR itself; only when it is unset is the cache
    pointed at DEFAULT_CACHE_DIR."""
    import jax

    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


_enable_persistent_compile_cache()
