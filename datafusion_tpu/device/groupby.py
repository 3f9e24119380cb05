"""Traceable grouped aggregation (the device GroupedHashAggregateStream).

Reference parity: `aggregates/row_hash.rs:524` `group_aggregate_batch` —
intern keys to dense ids, then reduce per group. On a static-shape machine
interning is *sort-based*: argsort the packed key word, mark run
boundaries, prefix-sum to dense ids. Reductions are then **sorted-aware**:

* sum/count: cumulative sum + gather at segment ends (two O(n) vector
  passes — no scatter, which the compiler this was first written for
  serialized; whether scatter pays on the H100 is ROADMAP A6),
* min/max: segmented associative scan (`lax.associative_scan` with a
  boundary-reset combiner) + gather at segment ends.

Everything is jit-traceable with static shapes; invalid rows sort to a
sentinel tail; unused group slots report invalid. The returned
`n_groups` lets the host detect `max_groups` overflow and fall back.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pack_keys(key_cols: List[jnp.ndarray], bits: List[int]) -> jnp.ndarray:
    """Pack multiple small-domain key columns into one int64 word."""
    packed = jnp.zeros(key_cols[0].shape, jnp.int64)
    shift = 0
    for col, b in zip(key_cols, bits):
        packed = packed | (col.astype(jnp.int64) << shift)
        shift += b
    return packed


def _segment_ends(ids_sorted: jnp.ndarray, max_groups: int) -> jnp.ndarray:
    """For ids sorted ascending, the index of the last row of each group
    (searchsorted — no scatter). Empty groups get end == start-1 handled
    by the difference trick at call sites."""
    return jnp.searchsorted(ids_sorted, jnp.arange(max_groups),
                            side="right", method="sort") - 1


def _seg_sum_sorted(vals: jnp.ndarray, ends: jnp.ndarray) -> jnp.ndarray:
    cs = jnp.cumsum(vals)
    at_end = jnp.where(ends >= 0, cs[jnp.clip(ends, 0, None)], 0)
    # empty segments share their predecessor's end -> difference 0
    prev = jnp.concatenate([jnp.zeros(1, at_end.dtype), at_end[:-1]])
    return at_end - prev


def _seg_minmax_two_key_sort(keys_masked: jnp.ndarray, vals: jnp.ndarray,
                             ends: jnp.ndarray, op: str) -> jnp.ndarray:
    """Segmented min/max via a two-key sort: `lax.sort((key, value))`
    orders values ascending within each key run, so the segment min sits at
    the segment start and the max at the segment end. One native sort in
    place of associative-scan/scatter formulations (ROADMAP A6)."""
    _, sv = jax.lax.sort((keys_masked, vals), num_keys=2)
    if op == "max":
        return sv[jnp.clip(ends, 0, None)]
    starts = jnp.concatenate([jnp.zeros(1, ends.dtype), ends[:-1] + 1])
    return sv[jnp.clip(starts, 0, sv.shape[0] - 1)]


_DENSE_MAX = 64


def _dense_group_aggregate(keys, row_valid, values, max_groups):
    """Small key spaces (<= _DENSE_MAX slots): the packed key IS the dense
    group id, so no sort/intern at all. Each slot's aggregates are plain
    masked whole-array reductions, unrolled over the small static G — no
    N×G one-hot materialization (which padded to 128 lanes and blew HBM)
    and no scatter/sort. XLA fuses mask+reduce per slot; traffic is
    G passes over the value columns, bandwidth-bound and compile-trivial."""
    g = max_groups
    ids = jnp.clip(keys, 0, g - 1).astype(jnp.int32)
    out_lists: Dict[str, list] = {name: [] for name in values}
    count_list = []
    for slot in range(g):
        in_slot = row_valid & (ids == slot)
        count_list.append(jnp.sum(in_slot.astype(jnp.int64)))
        for name, (kind, arr) in values.items():
            if kind == "count":
                out_lists[name].append(count_list[-1])
            elif kind == "sum":
                zero = jnp.asarray(
                    0, jnp.int64 if jnp.issubdtype(arr.dtype, jnp.integer)
                    else jnp.float64)
                a = jnp.where(in_slot, arr.astype(zero.dtype), zero)
                out_lists[name].append(jnp.sum(a))
            elif kind == "min":
                is_f = jnp.issubdtype(arr.dtype, jnp.floating)
                ident = jnp.asarray(
                    jnp.inf if is_f else jnp.iinfo(arr.dtype).max, arr.dtype)
                out_lists[name].append(jnp.min(jnp.where(in_slot, arr, ident)))
            elif kind == "max":
                is_f = jnp.issubdtype(arr.dtype, jnp.floating)
                ident = jnp.asarray(
                    -jnp.inf if is_f else jnp.iinfo(arr.dtype).min, arr.dtype)
                out_lists[name].append(jnp.max(jnp.where(in_slot, arr, ident)))
            else:
                raise ValueError(kind)
    out = {name: jnp.stack(v) for name, v in out_lists.items()}
    counts = jnp.stack(count_list)
    group_valid = counts > 0
    group_keys = jnp.where(group_valid, jnp.arange(g, dtype=jnp.int64),
                           jnp.int64(-1))
    n_groups = jnp.sum(group_valid.astype(jnp.int64))
    return group_keys, group_valid, out, n_groups


_SORTED_KINDS = frozenset({"sum", "count", "maxmono"})


def _sorted_group_aggregate(keys, row_valid, values, max_groups):
    """PRE-SORTED keys fast path: the caller guarantees `keys` is
    non-decreasing over the VALID rows (invalid rows may carry anything,
    anywhere). Skips the argsort AND the value reorder gathers, the
    biggest cost of the table path. Reference analog:
    GroupOrdering::Full in aggregates/order/full.rs — the reference also
    exploits input sorted on the group keys.

    Supports sum/count plus "maxmono": max of a value that is globally
    non-decreasing in row order (the FD representative-rowid lane), which
    a plain cummax realizes without per-segment resets."""
    n = keys.shape[0]
    neg_inf = jnp.int64(np.iinfo(np.int64).min)
    # last valid key at or before each row (valid keys are non-decreasing,
    # so a running max IS the last valid key)
    lastk = jax.lax.cummax(jnp.where(row_valid, keys, neg_inf))
    prev = jnp.concatenate([jnp.full(1, neg_inf, jnp.int64), lastk[:-1]])
    new_group = row_valid & (keys != prev)
    ids = jnp.cumsum(new_group.astype(jnp.int64)) - 1
    n_groups = ids[-1] + 1
    # invalid rows inherit the running id (contributions are masked), so
    # ids stays non-decreasing and searchsorted segment-ends apply
    ids = jnp.clip(ids, 0, max_groups - 1)
    ends = _segment_ends(ids, max_groups)

    out: Dict[str, jnp.ndarray] = {}
    for name, (kind, arr) in values.items():
        if kind == "count":
            out[name] = _seg_sum_sorted(row_valid.astype(jnp.int64), ends)
        elif kind == "sum":
            out[name] = _seg_sum_sorted(jnp.where(row_valid, arr, 0), ends)
        else:   # maxmono
            run = jax.lax.cummax(jnp.where(row_valid, arr, neg_inf))
            out[name] = run[jnp.clip(ends, 0, None)]
    counts = _seg_sum_sorted(row_valid.astype(jnp.int32), ends)
    group_valid = counts > 0
    group_keys = jnp.where(group_valid, lastk[jnp.clip(ends, 0, None)],
                           jnp.int64(-1))
    return group_keys, group_valid, out, n_groups


def device_group_aggregate(
    keys: jnp.ndarray,            # [n] packed int64 key word
    row_valid: jnp.ndarray,       # [n] bool — rows to aggregate
    values: Dict[str, Tuple[str, jnp.ndarray]],
    max_groups: int,
    assume_dense_keys: bool = False,
    assume_sorted_keys: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, Dict[str, jnp.ndarray], jnp.ndarray]:
    """Returns (group_keys [max_groups], group_valid [max_groups],
    {name: aggregate [max_groups]}, n_groups_actual). The caller checks
    n_groups_actual <= max_groups on the host (overflow -> fall back /
    re-run with a larger table).

    Dispatches to the dense one-hot path when `assume_dense_keys` is set
    and the key space is tiny; the caller guarantees keys in
    [0, max_groups) (true when max_groups == the exact packed-key space).
    With `assume_sorted_keys` (keys non-decreasing over valid rows) and
    only sum/count/maxmono slots, the sort-free path runs instead.
    Key -1 marks invalid rows and is allowed on both paths."""
    if assume_dense_keys and max_groups <= _DENSE_MAX:
        return _dense_group_aggregate(keys, row_valid, values, max_groups)
    if assume_sorted_keys and all(k in _SORTED_KINDS
                                  for k, _ in values.values()):
        return _sorted_group_aggregate(keys, row_valid, values, max_groups)
    sentinel = jnp.int64(0x7FFFFFFFFFFFFFFF)
    k = jnp.where(row_valid, keys, sentinel)
    order = jnp.argsort(k)
    ks = k[order]
    valid_s = row_valid[order]

    new_group = jnp.concatenate([jnp.array([True]), ks[1:] != ks[:-1]])
    new_group = new_group & valid_s
    ids = jnp.cumsum(new_group.astype(jnp.int64)) - 1
    n_groups = jnp.max(jnp.where(valid_s, ids, -1)) + 1
    ids = jnp.where(valid_s, jnp.minimum(ids, max_groups - 1),
                    jnp.int64(max_groups))   # invalid tail past every group
    ends = _segment_ends(ids, max_groups)

    out: Dict[str, jnp.ndarray] = {}
    for name, (kind, arr) in values.items():
        a = arr[order]
        if kind == "count":
            out[name] = _seg_sum_sorted(valid_s.astype(jnp.int64), ends)
        elif kind == "sum":
            out[name] = _seg_sum_sorted(jnp.where(valid_s, a, 0), ends)
        elif kind == "min":
            big = jnp.asarray(jnp.inf if jnp.issubdtype(a.dtype, jnp.floating)
                              else jnp.iinfo(a.dtype).max, a.dtype)
            out[name] = _seg_minmax_two_key_sort(
                k, jnp.where(row_valid, arr, big), ends, "min")
        elif kind == "max":
            small = jnp.asarray(-jnp.inf if jnp.issubdtype(a.dtype, jnp.floating)
                                else jnp.iinfo(a.dtype).min, a.dtype)
            out[name] = _seg_minmax_two_key_sort(
                k, jnp.where(row_valid, arr, small), ends, "max")
        elif kind == "distinct":
            # count(DISTINCT x): two-key sort groups equal (key, value)
            # pairs into runs; the run starts summed per key segment are
            # the distinct counts. The (key,value) sort shares the key
            # segment layout with the key-only sort, so `ends` applies.
            # NULL values arrive as INT64_MIN and are excluded.
            ks2, vs = jax.lax.sort((k, arr.astype(jnp.int64)), num_keys=2)
            new_pair = jnp.concatenate([
                jnp.ones(1, bool),
                (ks2[1:] != ks2[:-1]) | (vs[1:] != vs[:-1])])
            nullrep = jnp.int64(np.iinfo(np.int64).min)
            contrib = (new_pair & (ks2 != sentinel) & (vs != nullrep))
            out[name] = _seg_sum_sorted(contrib.astype(jnp.int64), ends)
        else:
            raise ValueError(f"unsupported device aggregate '{kind}'")

    counts = _seg_sum_sorted(valid_s.astype(jnp.int32), ends)
    group_valid = counts > 0
    group_keys = jnp.where(group_valid, ks[jnp.clip(ends, 0, None)],
                           jnp.int64(-1))
    return group_keys, group_valid, out, n_groups


def reorder_rows_packed(order, arrays):
    """Reorder many row-aligned arrays by one permutation with ONE 2D
    int32 row-gather instead of per-array gathers (whether the H100
    needs the int32 lanes is ROADMAP C2). int64 splits to hi/lo lanes,
    bool/int32 ride one lane, float32 bitcasts; float64 falls back to a
    direct gather."""
    lanes = []
    specs = []   # (kind, nlanes) per array
    for a in arrays:
        if a.dtype == jnp.int64:
            lanes.append((a >> 32).astype(jnp.int32))
            lanes.append(a.astype(jnp.uint32).astype(jnp.int32))
            specs.append(("i64", 2))
        elif a.dtype == jnp.bool_:
            lanes.append(a.astype(jnp.int32))
            specs.append(("bool", 1))
        elif a.dtype == jnp.float32:
            lanes.append(jax.lax.bitcast_convert_type(a, jnp.int32))
            specs.append(("f32", 1))
        elif a.dtype in (jnp.int32, jnp.uint32):
            lanes.append(a.astype(jnp.int32))
            specs.append(("i32", 1))
        else:
            specs.append(("direct", 0))
    gathered = None
    if lanes:
        gathered = jnp.stack(lanes, axis=1)[order]
    out = []
    li = 0
    for a, (kind, nl) in zip(arrays, specs):
        if kind == "direct":
            out.append(a[order])
        elif kind == "i64":
            hi = gathered[:, li].astype(jnp.int64)
            lo = gathered[:, li + 1].astype(jnp.uint32).astype(jnp.int64)
            out.append((hi << 32) | lo)
            li += 2
        elif kind == "bool":
            out.append(gathered[:, li] != 0)
            li += 1
        elif kind == "f32":
            out.append(jax.lax.bitcast_convert_type(
                gathered[:, li], jnp.float32))
            li += 1
        else:
            out.append(gathered[:, li])
            li += 1
    return out


_ROWSPACE_KINDS = frozenset({"sum", "count", "maxmono", "distinct"})


def rowspace_group_state(keys, row_valid, values):
    """Program-A half of the two-program ROW-SPACE grouped aggregation.

    The fixed-size [max_groups] group table costs a searchsorted-sort
    segment-ends pass plus per-slot gathers at table size; this layout
    instead keeps everything as O(n) scans over the row space and defers
    the (tiny) group-table materialization to `rowspace_group_emit`,
    sized by the EXACT live group count — two compiled programs, one
    scalar fetch between them, no overflow retry.
    Reference analog: GroupedHashAggregateStream emitting only occupied
    buckets (aggregates/row_hash.rs:524).

    `keys` must be non-decreasing over VALID rows (invalid rows may hold
    anything — their value-lane contributions are pre-masked to the
    aggregation identity by the caller). `values` maps slot name ->
    (kind, row_array) with kind in {"sum","count","maxmono","distinct"}.
    `keys` may be int32 (narrow packed key spaces): int32 scans/sorts
    move half the bytes of int64.

    Returns (lanes, n_groups): `lanes` is a flat dict of [n] row-space
    arrays (device-resident between the two programs)."""
    n = keys.shape[0]
    kdt = keys.dtype
    neg = jnp.asarray(np.iinfo(np.dtype(kdt)).min, kdt)
    big = jnp.asarray(np.iinfo(np.dtype(kdt)).max, kdt)
    kk = jnp.where(row_valid, keys, big)
    # last valid key at/before each row (keys non-decreasing over valid
    # rows -> running max IS the last valid key)
    lastk = jax.lax.cummax(jnp.where(row_valid, keys, neg))
    # next valid key strictly after each row: suffix-min of masked keys
    nk = jax.lax.cummin(kk[::-1])[::-1]
    nk_after = jnp.concatenate([nk[1:], jnp.full(1, big, kdt)])
    is_end = row_valid & (nk_after != keys)
    cs_end = jnp.cumsum(is_end.astype(jnp.int32))
    lanes = {"__lastk": lastk, "__cs_end": cs_end}
    for name, (kind, arr) in values.items():
        if kind == "sum":
            lanes[name] = jnp.cumsum(arr)
        elif kind == "count":
            lanes[name] = jnp.cumsum(arr.astype(jnp.int64))
        elif kind == "maxmono":
            lanes[name] = jax.lax.cummax(arr)
        elif kind == "atend":
            # emitted by a row-gather at the run-end row (any valid row of
            # the run works — used for the FD representative rowid)
            lanes[name] = arr
        elif kind == "distinct":
            ks2, vs = jax.lax.sort((kk, arr.astype(jnp.int64)), num_keys=2)
            if "__cs_end2" not in lanes:
                e2 = jnp.concatenate([ks2[1:] != ks2[:-1],
                                      jnp.ones(1, bool)]) & (ks2 != big)
                lanes["__cs_end2"] = jnp.cumsum(e2.astype(jnp.int32))
            nullrep = jnp.int64(np.iinfo(np.int64).min)
            new_pair = jnp.concatenate([
                jnp.ones(1, bool),
                (ks2[1:] != ks2[:-1]) | (vs[1:] != vs[:-1])])
            contrib = new_pair & (ks2 != big) & (vs != nullrep)
            lanes[name] = jnp.cumsum(contrib.astype(jnp.int64))
        else:
            raise ValueError(f"unsupported rowspace aggregate '{kind}'")
    n_groups = cs_end[n - 1]
    return lanes, n_groups


def rowspace_group_emit(lanes, kinds, out_cap):
    """Program-B half: materialize the [out_cap] group table from the
    row-space lanes. `out_cap` must be >= the live group count (the
    caller buckets the fetched n_groups). Run-end row ids come from a
    few-query binary-search searchsorted (~23 gathers of out_cap
    elements — microseconds at emit sizes; method='sort' above 32k
    queries where the binary scan's per-pass cost crosses over); per-slot
    results are cumulative-lane differences at consecutive ends."""
    cs_end = lanes["__cs_end"]
    n = cs_end.shape[0]
    # binary scan = ~23 passes of out_cap-element gathers (~9ns/lookup);
    # method='sort' re-sorts the n-row lane — scan wins through ~128k
    method = "sort" if out_cap > (1 << 17) else "scan"
    j = jnp.arange(out_cap, dtype=jnp.int32)
    rid = jnp.clip(jnp.searchsorted(cs_end, j, side="right", method=method),
                   0, n - 1)
    ng = cs_end[n - 1]
    ok = j < ng
    rid2 = None
    if "__cs_end2" in lanes:
        cs2 = lanes["__cs_end2"]
        rid2 = jnp.clip(jnp.searchsorted(cs2, j, side="right",
                                         method=method), 0, n - 1)
    out = {}
    for name, kind in kinds.items():
        if kind in ("sum", "count", "distinct"):
            lane = lanes[name]
            v = lane[rid2 if kind == "distinct" else rid]
            prev = jnp.concatenate([jnp.zeros(1, v.dtype), v[:-1]])
            out[name] = jnp.where(ok, v - prev, 0)
        else:   # maxmono / atend
            out[name] = lanes[name][rid]
    group_keys = jnp.where(ok, lanes["__lastk"][rid].astype(jnp.int64),
                           jnp.int64(-1))
    return group_keys, ok, out, ng


def device_group_aggregate_big(
    keys: jnp.ndarray,            # [n] packed int64 key word
    row_valid: jnp.ndarray,       # [n] bool
    values: Dict[str, Tuple[str, jnp.ndarray]],
) -> Tuple[jnp.ndarray, jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Unbounded-cardinality grouped aggregation: instead of a fixed
    ``max_groups`` table, group results live at their RUN-END slots of the
    key-sorted order. Returns (keys_sorted [n], is_end [n],
    {name: aggregate_at_end_slot [n]}). Rows where ``is_end`` is False are
    padding. Designed for the top-k emit (aggregate ORDER BY ... LIMIT k
    fused on device — see DeviceGroupAggregateExec), where the group table
    never materializes to the host. Costs one argsort + O(#slots)
    gathers."""
    n = keys.shape[0]
    sentinel = jnp.int64(0x7FFFFFFFFFFFFFFF)
    k = jnp.where(row_valid, keys, sentinel)
    order = jnp.argsort(k)
    ks = k[order]
    valid_s = ks != sentinel
    new_group = jnp.concatenate([jnp.array([True]), ks[1:] != ks[:-1]])
    is_end = jnp.concatenate([ks[1:] != ks[:-1], jnp.array([True])]) & valid_s
    # per-row index of its run start (cummax over marked starts)
    idx = jnp.arange(n, dtype=jnp.int64)
    start_idx = jax.lax.cummax(jnp.where(new_group, idx, jnp.int64(0)))

    out: Dict[str, jnp.ndarray] = {}
    for name, (kind, arr) in values.items():
        a = arr[order]
        if kind in ("sum", "count", "cnt"):
            vals = jnp.where(valid_s, a, 0) if kind == "sum" \
                else valid_s.astype(jnp.int64)
            cs = jnp.cumsum(vals)
            before = jnp.where(start_idx > 0,
                               cs[jnp.clip(start_idx - 1, 0, None)], 0)
            out[name] = cs - before           # meaningful at end slots
        elif kind in ("min", "max"):
            # two-key sort orders values within each key run; min sits at
            # the run start, max at the run end (== the slot itself)
            _, sv = jax.lax.sort((k, arr), num_keys=2)
            if kind == "min":
                out[name] = sv[start_idx]     # value at run start
            else:
                out[name] = sv                # value at run end == slot
        else:
            raise ValueError(
                f"unsupported big-mode device aggregate '{kind}'")
    keys_out = jnp.where(is_end, ks, jnp.int64(-1))
    return keys_out, is_end, out


def device_filter_reduce(pred_cols: List[jnp.ndarray],
                         reduce_expr: jnp.ndarray) -> jnp.ndarray:
    """Fused filter + scalar sum (TPC-H Q6 shape)."""
    mask = pred_cols[0]
    for p in pred_cols[1:]:
        mask = mask & p
    return jnp.sum(jnp.where(mask, reduce_expr, 0))
