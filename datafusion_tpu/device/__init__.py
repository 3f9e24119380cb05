"""Device compute path: jit-compiled XLA programs for the hot operators.

Where the host path (`physical/`) runs vectorized numpy per batch, this
package provides traceable JAX equivalents with static shapes — the
bucketed-tile design of SURVEY.md §7: masked fixed-capacity arrays,
sort-based grouping (argsort -> change-flags -> cumsum ids -> segment
reductions), and shard_map collectives for the distributed exchange.
"""
import os as _os

import jax as _jax

# int64 keys and float64 accumulation are part of SQL semantics; enable
# regardless of import order (the env-var path in __init__ only works when
# datafusion_tpu is imported before jax).
_jax.config.update("jax_enable_x64", True)

# persistent compilation cache: query shapes repeat across runs and
# processes. JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and
# wins; otherwise the cache lives at one fixed path inside the checkout
# (a path that moves never hits).
_REPO_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))), ".jax_cache")


def compile_cache_dir(environ=_os.environ) -> str:
    """The persistent compilation cache directory in effect."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _REPO_CACHE_DIR


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _REPO_CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .groupby import device_group_aggregate, device_filter_reduce  # noqa: F401,E402
