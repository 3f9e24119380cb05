"""Fused device window evaluation.

ONE jitted XLA program runs [stable lexsort -> partition/peer
segmentation -> rank / offset / frame-aggregate scans -> inverse
permutation], so a 10M-row window function costs one device dispatch
and one result transfer instead of a permutation download plus host
numpy passes.

Reference parity: `windows/bounded_window_agg_exec.rs:239` evaluation +
the built-in window exprs (`physical-expr/src/window/{row_number,rank,
lead_lag,ntile,cume_dist}.rs`) and frame aggregates. Device re-design:
everything is a SEGMENT SCAN over the sorted space — `lax.sort` once,
then cumsum / cummax / flip tricks and gathers (no segment scatter, no
per-partition host loops; scatter with many segments was serialized by
the compiler this was first written for — ROADMAP A6). Results return
to input row order through one permutation scatter.

Supported here (the hot family; everything else stays on the host twin
in physical/plan/window.py): row_number, rank, dense_rank, percent_rank,
cume_dist, ntile, lag/lead (literal offset/default, RESPECT NULLS), and
sum/count/avg over ROWS frames, whole-partition frames, and the default
RANGE frame (UNBOUNDED PRECEDING .. CURRENT peer group).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_WIN_CACHE: dict = {}
_WIN_CACHE_MAX = 256

# below this row count the window stays on the host (threshold to be
# measured on the H100: ROADMAP A4)
DEFAULT_MIN_ROWS = 1 << 17


def min_rows(config) -> int:
    for reader in (lambda: config.get(
            "datafusion.tpu.device_window_min_rows"),
            lambda: config.options.get(
                "datafusion.tpu.device_window_min_rows")):
        try:
            return int(reader())
        except Exception:  # noqa: BLE001 — wrong config flavor / absent
            continue
    return DEFAULT_MIN_ROWS


def _bucket(n: int) -> int:
    from ..physical.plan.device_aggregate import _bucket_capacity
    return _bucket_capacity(n)


def device_window_eval(
    part_words: List[np.ndarray],      # partition-key order words (ms first)
    order_words: List[np.ndarray],     # ORDER BY order words (ms first)
    n: int,
    spec: Tuple,                       # static spec, see _build_step
    arg: Optional[np.ndarray] = None,        # value column (device repr)
    arg_valid: Optional[np.ndarray] = None,  # value validity
    default: Optional[np.ndarray] = None,    # lag/lead default column
    default_valid: Optional[np.ndarray] = None,
    metrics=None,
):
    """Evaluate one window function over all rows, fused on device.
    Returns a dict of np arrays in ORIGINAL row order — keys depend on
    the spec kind: ranks return {"data"}; lag/lead {"data", "valid"};
    frame aggregates {"sum", "cnt"} (host finalizes sum/avg/validity)."""
    import jax
    import jax.numpy as jnp

    cap = _bucket(n)
    words = list(part_words) + list(order_words)
    w_dtypes = tuple(str(np.asarray(w).dtype) for w in words)
    has_arg = arg is not None
    has_default = default is not None
    a_dtype = str(np.asarray(arg).dtype) if has_arg else None
    cache_key = (spec, cap, len(part_words), len(order_words), w_dtypes,
                 a_dtype, has_default)
    fn = _WIN_CACHE.get(cache_key)
    if fn is None:
        fn = jax.jit(_build_step(spec, cap, len(part_words),
                                 len(order_words), has_arg, has_default))
        if len(_WIN_CACHE) >= _WIN_CACHE_MAX:
            _WIN_CACHE.clear()
        _WIN_CACHE[cache_key] = fn

    def pad(a, fill=0):
        a = np.asarray(a)
        if len(a) < cap:
            a = np.concatenate([a, np.full(cap - len(a), fill, a.dtype)])
        return jnp.asarray(a)

    staged_words = tuple(pad(w) for w in words)
    nbytes = sum(np.asarray(w).dtype.itemsize for w in words) * n
    extras = []
    if has_arg:
        extras.append(pad(arg))
        extras.append(pad(arg_valid if arg_valid is not None
                          else np.ones(n, bool), False))
        nbytes += (np.asarray(arg).dtype.itemsize + 1) * n
    if has_default:
        extras.append(pad(default))
        extras.append(pad(default_valid if default_valid is not None
                          else np.ones(n, bool), False))
        nbytes += (np.asarray(default).dtype.itemsize + 1) * n
    if metrics is not None:
        metrics.record_bytes(nbytes + 8 * n)
        cm = metrics.device_compute
    else:
        import contextlib
        cm = contextlib.nullcontext()
    with cm:
        out = fn(staged_words, tuple(extras), np.int64(n))
    return {k: np.asarray(v)[:n] for k, v in out.items()}


def _build_step(spec, cap, n_part, n_order, has_arg, has_default):
    """spec is a static tuple:
      ("rank", fn_name)                      fn in row_number/rank/...
      ("ntile", k)
      ("shift", offset)                      lag(-off) / lead(+off)
      ("agg", agg_kind, lo_kind, lo_off, hi_kind, hi_off)
        agg_kind in {sum_f, sum_i, cnt}; bound kinds: "part" (partition
        edge), "cur" (current row), "peer" (peer-group edge),
        "rows" (current row +/- offset)
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    def step(words, extras, nn):
        iota = jnp.arange(cap, dtype=jnp.int64)
        padf = (iota >= nn).astype(jnp.uint8)
        n_words = len(words)
        ops = (padf,) + tuple(words) + (iota,) + tuple(extras)
        s = lax.sort(ops, num_keys=n_words + 2, is_stable=False)
        sp_words = s[1:1 + n_part]
        so_words = s[1 + n_part:1 + n_words]
        perm = s[n_words + 1]
        sextras = s[n_words + 2:]

        idx = iota
        start = jnp.concatenate([jnp.ones(1, bool),
                                 jnp.zeros(cap - 1, bool)])
        for w in sp_words:
            start = start | jnp.concatenate(
                [jnp.ones(1, bool), w[1:] != w[:-1]])
        # padding rows form their own trailing segment
        spad = s[0].astype(bool)
        start = start | jnp.concatenate(
            [jnp.ones(1, bool), spad[1:] != spad[:-1]])
        new_peer = start
        for w in so_words:
            new_peer = new_peer | jnp.concatenate(
                [jnp.ones(1, bool), w[1:] != w[:-1]])

        def ffill_right(mask):
            """For each row, the index of the NEAREST marked row at or
            after it (backward fill). Encoded in reversed coordinates so
            a single cummax over the flipped array picks the closest
            (smallest-index) marked row, not the largest."""
            enc = jnp.where(mask, jnp.int64(cap - 1) - idx, jnp.int64(-1))
            return (cap - 1) - jnp.flip(lax.cummax(jnp.flip(enc)))

        part_start = lax.cummax(jnp.where(start, idx, 0))
        end_mask = jnp.concatenate([start[1:], jnp.ones(1, bool)])
        part_end = ffill_right(end_mask)
        row_in_part = idx - part_start
        part_len = part_end - part_start + 1

        kind = spec[0]
        outs = {}
        if kind == "rank":
            name = spec[1]
            if name == "row_number":
                outs["data"] = (row_in_part + 1).astype(jnp.uint64)
            elif name == "rank":
                set_idx = lax.cummax(jnp.where(new_peer, idx, 0))
                outs["data"] = (set_idx - part_start + 1).astype(jnp.uint64)
            elif name == "dense_rank":
                dr = jnp.cumsum(new_peer.astype(jnp.int64))
                base = dr[part_start]
                outs["data"] = (dr - base + 1).astype(jnp.uint64)
            elif name == "percent_rank":
                set_idx = lax.cummax(jnp.where(new_peer, idx, 0))
                rank = set_idx - part_start + 1
                denom = jnp.maximum(part_len - 1, 1).astype(jnp.float64)
                outs["data"] = (rank - 1) / denom
            else:   # cume_dist
                last_of_peer = jnp.concatenate(
                    [new_peer[1:], jnp.ones(1, bool)])
                peer_end = ffill_right(last_of_peer)
                outs["data"] = (peer_end - part_start + 1) / \
                    part_len.astype(jnp.float64)
        elif kind == "ntile":
            k = spec[1]
            outs["data"] = jnp.minimum(
                row_in_part * k // jnp.maximum(part_len, 1) + 1,
                k).astype(jnp.uint64)
        elif kind == "shift":
            off = spec[1]
            vals, valid = sextras[0], sextras[1]
            src = idx + off
            in_part = (src >= part_start) & (src <= part_end)
            safe = jnp.clip(src, 0, cap - 1)
            data = vals[safe]
            v = valid[safe] & in_part
            if has_default:
                dd, dv = sextras[2], sextras[3]
                data = jnp.where(in_part, data, dd)
                v = jnp.where(in_part, v, dv)
            outs["data"] = data
            outs["valid"] = v
        elif kind == "agg":
            _, agg_kind, lo_kind, lo_off, hi_kind, hi_off = spec
            last_of_peer = jnp.concatenate([new_peer[1:], jnp.ones(1, bool)])
            peer_end = ffill_right(last_of_peer)
            peer_start = lax.cummax(jnp.where(new_peer, idx, 0))

            def bound(bk, boff, is_lo):
                if bk == "part":
                    return part_start if is_lo else part_end
                if bk == "cur":
                    return idx
                if bk == "peer":
                    return peer_start if is_lo else peer_end
                return idx + boff        # "rows"
            lo = jnp.maximum(bound(lo_kind, lo_off, True), part_start)
            hi = jnp.minimum(bound(hi_kind, hi_off, False), part_end)
            empty = lo > hi
            vals, valid = sextras[0], sextras[1]
            valid = valid & ~s[0].astype(bool)
            if agg_kind == "sum_f":
                x = jnp.where(valid, vals.astype(jnp.float64), 0.0)
            else:
                x = jnp.where(valid, vals.astype(jnp.int64), 0)
            ps = jnp.cumsum(x)
            hi_c = jnp.clip(hi, 0, cap - 1)
            lo_c = jnp.clip(lo - 1, 0, cap - 1)
            fsum = ps[hi_c] - jnp.where(lo >= 1, ps[lo_c], 0)
            pc = jnp.cumsum(valid.astype(jnp.int64))
            fcnt = pc[hi_c] - jnp.where(lo >= 1, pc[lo_c], 0)
            fsum = jnp.where(empty, 0, fsum)
            fcnt = jnp.where(empty, 0, fcnt)
            outs["sum"] = fsum
            outs["cnt"] = fcnt
        else:
            raise ValueError(kind)

        # back to input row order: sorted row i came from row perm[i]. A
        # permutation scatter (a second lax.sort keyed on perm is
        # rewritten into an ill-typed scatter by XLA:GPU's
        # permutation_sort_simplifier for uint64 outputs)
        return {k: jnp.zeros_like(v).at[perm].set(v, unique_indices=True)
                for k, v in outs.items()}

    return step
