"""Device lexicographic sort: `lax.sort` over encoded order-key words.

Device replacement for the host `np.lexsort` hot loop used by
SortExec / TopK / window ordering (reference shapes: `sorts/sort.rs:668`
sort_batch -> arrow lexsort, `topk/mod.rs:75`, window ordering in
`bounded_window_agg_exec.rs:239`). Sort keys are first encoded into
monotonic words on the host (`sort.py order_keys`: [null-rank u8,
value u64] per key, already direction/nulls adjusted), so the device
program is type-agnostic: one stable multi-operand `lax.sort` whose last
operand is the row index — the returned permutation realizes the exact
SQL order, bit-identical to `np.lexsort` (both stable over the same
words).

Padding rows (capacity bucketing keeps compiled shapes O(log n)) carry a
leading pad-flag key word so they sort strictly after every live row and
never pollute a LIMIT slice.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .device_aggregate import _bucket_capacity

# program cache: (cap, word dtypes, out_cap) -> jitted fn
_SORT_CACHE: dict = {}
_SORT_CACHE_MAX = 256

# below this row count the sort stays on the host (threshold to be
# measured on the H100: ROADMAP A4)
DEFAULT_MIN_ROWS = 1 << 17


def _min_rows(config) -> int:
    for reader in (lambda: config.get(
            "datafusion.tpu.device_sort_min_rows"),
            lambda: config.options.get(
                "datafusion.tpu.device_sort_min_rows")):
        try:
            return int(reader())
        except Exception:  # noqa: BLE001 — wrong config flavor / absent
            continue
    return DEFAULT_MIN_ROWS


def device_lexsort(keys: List[np.ndarray], n: int,
                   limit: Optional[int] = None,
                   metrics=None) -> np.ndarray:
    """Stable ascending permutation over key words (most-significant
    first) — the device twin of ``np.lexsort(tuple(reversed(keys)))``.
    `n` must be positive."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    cap = _bucket_capacity(n)
    # LIMIT slices transfer a bucketed prefix so programs are shared
    # across close fetch values
    k = min(n, limit) if limit is not None else n
    out_cap = min(cap, _bucket_capacity(max(k, 1), floor=1024))

    dtypes = tuple(str(np.asarray(w).dtype) for w in keys)
    cache_key = (cap, dtypes, out_cap)
    fn = _SORT_CACHE.get(cache_key)
    if fn is None:
        n_words = len(keys)

        def step(words, nn):
            iota = jnp.arange(cap, dtype=jnp.int64)
            pad = (iota >= nn).astype(jnp.uint8)
            ops = (pad,) + tuple(words) + (iota,)
            # is_stable + trailing iota == np.lexsort's stable semantics
            out = lax.sort(ops, num_keys=n_words + 1, is_stable=True)
            return out[-1][:out_cap]

        fn = jax.jit(step)
        if len(_SORT_CACHE) >= _SORT_CACHE_MAX:
            _SORT_CACHE.clear()
        _SORT_CACHE[cache_key] = fn

    staged = []
    nbytes = 0
    for w in keys:
        w = np.asarray(w)
        nbytes += n * w.dtype.itemsize
        if len(w) < cap:
            w = np.pad(w, (0, cap - len(w)))
        staged.append(jnp.asarray(w))

    if metrics is not None:
        metrics.record_bytes(nbytes + n * 8)
        cm = metrics.device_compute
    else:
        import contextlib
        cm = contextlib.nullcontext()
    with cm:
        perm = np.asarray(fn(tuple(staged), np.int64(n)))
    return perm[:k]


def lexsort(keys: List[np.ndarray], n: int, limit: Optional[int] = None,
            metrics=None, config=None) -> np.ndarray:
    """Dispatch: device `lax.sort` for large inputs, host `np.lexsort`
    otherwise. `keys` are most-significant-first order words."""
    if n and n >= _min_rows(config):
        return device_lexsort(keys, n, limit=limit, metrics=metrics)
    order = np.lexsort(tuple(reversed([k[:n] for k in keys])))
    if limit is not None:
        order = order[:limit]
    return order
