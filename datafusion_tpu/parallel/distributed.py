"""Distributed two-phase aggregation over a device mesh.

This is the device-native RepartitionExec + AggregateMode::FinalPartitioned
(SURVEY.md §2.6.3-4): instead of channel-based row shuffles, the exchange
rides collectives inside one compiled SPMD program:

    per shard: sort-based partial aggregation  (device/groupby.py)
    exchange:  all_gather of the fixed-size partial state over the mesh
    final:     each shard reduces the groups it *owns*
               (hash(key) % n_shards == my shard index)

The all_gather ships `n_dev × max_groups` state rows — the broadcast
variant of the shuffle. It is the right choice when the partial state is
small relative to input rows (the common case: aggregation reduces), and
every byte moves over the device interconnect inside one XLA program. A slotted
`lax.all_to_all` variant that ships only owned rows is the planned
optimization for high-cardinality groups.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..device.groupby import device_group_aggregate


def make_mesh(n_devices: int, axis: str = "dp") -> Mesh:
    """One-dimensional mesh over the first n devices of the default
    backend. Raises when the backend has fewer devices: a plan never
    moves to another backend. (On the CPU backend,
    XLA_FLAGS=--xla_force_host_platform_device_count=N gives N devices.)"""
    devs = jax.devices()
    if len(devs) < n_devices:
        raise RuntimeError(
            f"need {n_devices} {devs[0].platform} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n_devices]), (axis,))


def default_mesh() -> Mesh:
    return make_mesh(len(jax.devices()))


def _splitmix64_jnp(x: jnp.ndarray) -> jnp.ndarray:
    """Same finalizer as physical/hashing.py so host and device shuffles
    place keys identically."""
    x = x.astype(jnp.uint64)
    x = x + jnp.uint64(0x9E3779B97F4A7C15)
    z = x
    z = (z ^ (z >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return z ^ (z >> jnp.uint64(31))


def distributed_group_aggregate(
    mesh: Mesh,
    keys: jnp.ndarray,                       # [n] packed int64, row-sharded
    row_valid: jnp.ndarray,                  # [n] bool
    values: Dict[str, Tuple[str, jnp.ndarray]],
    max_groups: int,
    axis: str = "dp",
):
    """Compile + run the full distributed aggregation step.

    Inputs are sharded on rows over `mesh`; the result is the full
    (replicated) group table: (group_keys, group_valid, {name: agg}).
    """
    names = tuple(values.keys())
    kinds = tuple(k for k, _ in values.values())
    arrays = [a for _, a in values.values()]
    n_shards = mesh.shape[axis]

    def step(keys_l, valid_l, *arrays_l):
        # ---- partial (per shard) ---------------------------------------
        vals = {n: (k, a) for n, k, a in zip(names, kinds, arrays_l)}
        gk, gv, partial_aggs, _ng = device_group_aggregate(
            keys_l, valid_l, vals, max_groups)

        # ---- exchange: all_gather partial state over the mesh ----------
        gk_all = jax.lax.all_gather(gk, axis)          # [n_shards, G]
        gv_all = jax.lax.all_gather(gv, axis)
        agg_all = {n: jax.lax.all_gather(a, axis) for n, a in partial_aggs.items()}

        # ---- final: reduce the groups this shard owns -------------------
        my = jax.lax.axis_index(axis)
        flat_k = gk_all.reshape(-1)
        flat_v = gv_all.reshape(-1)
        owner = (_splitmix64_jnp(flat_k.astype(jnp.uint64))
                 % jnp.uint64(n_shards)).astype(jnp.int32)
        mine = flat_v & (owner == my)
        merge_vals = {}
        for n, a in agg_all.items():
            kind = kinds[names.index(n)]
            # partial counts/sums merge by sum; min/max by min/max
            merge_kind = "sum" if kind in ("sum", "count") else kind
            merge_vals[n] = (merge_kind, a.reshape(-1))
        fk, fv, faggs, _ng2 = device_group_aggregate(flat_k, mine, merge_vals,
                                                     max_groups)
        # replicate the final table: gather every shard's owned slice
        fk_all = jax.lax.all_gather(fk, axis).reshape(-1)
        fv_all = jax.lax.all_gather(fv, axis).reshape(-1)
        faggs_all = {n: jax.lax.all_gather(a, axis).reshape(-1)
                     for n, a in faggs.items()}
        return fk_all, fv_all, faggs_all

    from jax import shard_map
    in_specs = (P(axis), P(axis)) + tuple(P(axis) for _ in arrays)
    out_specs = (P(), P(), {n: P() for n in names})
    fn = shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    sharding = NamedSharding(mesh, P(axis))
    keys = jax.device_put(keys, sharding)
    row_valid = jax.device_put(row_valid, sharding)
    arrays = [jax.device_put(a, sharding) for a in arrays]
    return jax.jit(fn)(keys, row_valid, *arrays)


def distributed_join_aggregate(
    mesh: Mesh,
    build_keys: jnp.ndarray,                 # [nb] int64 (replicated)
    build_payload: jnp.ndarray,              # [nb] payload joined in
    probe_keys: jnp.ndarray,                 # [n] int64, row-sharded
    probe_values: jnp.ndarray,               # [n] measure, row-sharded
    group_keys: jnp.ndarray,                 # [n] int64 group key, sharded
    max_groups: int,
    fanout_cap: int = 4,
    axis: str = "dp",
):
    """Distributed broadcast hash join + two-phase aggregation, one SPMD
    program: the (small) build side is replicated (the CollectLeft /
    broadcast-join strategy of SURVEY.md §2.6.5); each shard probes its
    probe rows, expands matches into a fixed per-shard fanout capacity,
    computes sum(build_payload + probe_values) per group, then the group
    tables exchange exactly like `distributed_group_aggregate`.

    Returns the replicated (group_keys, group_valid, {"s": sums,
    "c": counts}).
    """
    n_shards = mesh.shape[axis]

    order = jnp.argsort(build_keys)
    sb = build_keys[order]
    pb = build_payload[order]

    def step(pk_l, pv_l, gk_l):
        n_local = pk_l.shape[0]
        lo = jnp.searchsorted(sb, pk_l, side="left", method="sort")
        hi = jnp.searchsorted(sb, pk_l, side="right", method="sort")
        counts = jnp.minimum(hi - lo, fanout_cap)
        offs = jnp.cumsum(counts)
        cap = n_local * fanout_cap
        j = jnp.arange(cap)
        prow = jnp.clip(jnp.searchsorted(offs, j, side="right", method="sort"),
                        0, n_local - 1)
        within = j - (offs[prow] - counts[prow])
        bpos = jnp.clip(lo[prow] + within, 0, sb.shape[0] - 1)
        pair_valid = (j < offs[-1]) & (sb[bpos] == pk_l[prow])
        pair_group = gk_l[prow]
        pair_val = pv_l[prow] + pb[bpos]
        gk, gv, aggs, _ng = device_group_aggregate(
            pair_group, pair_valid,
            {"s": ("sum", pair_val), "c": ("count", pair_val)}, max_groups)
        # exchange partial tables: identical pattern to the aggregation path
        gk_all = jax.lax.all_gather(gk, axis).reshape(-1)
        gv_all = jax.lax.all_gather(gv, axis).reshape(-1)
        s_all = jax.lax.all_gather(aggs["s"], axis).reshape(-1)
        c_all = jax.lax.all_gather(aggs["c"], axis).reshape(-1)
        my = jax.lax.axis_index(axis)
        owner = (_splitmix64_jnp(gk_all.astype(jnp.uint64))
                 % jnp.uint64(n_shards)).astype(jnp.int32)
        mine = gv_all & (owner == my)
        fk, fv, faggs, _ng2 = device_group_aggregate(
            gk_all, mine, {"s": ("sum", s_all), "c": ("sum", c_all)},
            max_groups)
        return (jax.lax.all_gather(fk, axis).reshape(-1),
                jax.lax.all_gather(fv, axis).reshape(-1),
                {"s": jax.lax.all_gather(faggs["s"], axis).reshape(-1),
                 "c": jax.lax.all_gather(faggs["c"], axis).reshape(-1)})

    from jax import shard_map
    fn = shard_map(step, mesh=mesh,
                   in_specs=(P(axis), P(axis), P(axis)),
                   out_specs=(P(), P(), {"s": P(), "c": P()}),
                   check_vma=False)
    sharding = NamedSharding(mesh, P(axis))
    probe_keys = jax.device_put(probe_keys, sharding)
    probe_values = jax.device_put(probe_values, sharding)
    group_keys = jax.device_put(group_keys, sharding)
    return jax.jit(fn)(probe_keys, probe_values, group_keys)


def distributed_join_group_aggregate(
    mesh: Mesh,
    sb_keys: jnp.ndarray,          # [nb] int64 packed equi-key, SORTED (replicated)
    sb_group: jnp.ndarray,         # [nb] int64 build-side group-key part
    sb_values: Dict[str, jnp.ndarray],   # build-side agg-arg arrays [nb]
    probe_keys: jnp.ndarray,       # [n] int64 packed equi-key, row-sharded
    probe_valid: jnp.ndarray,      # [n] bool (side predicate + non-NULL keys)
    probe_group: jnp.ndarray,      # [n] int64 probe-side group-key part
    probe_values: Dict[str, jnp.ndarray],
    kinds: Dict[str, str],         # slot -> "sum" | "min" | "max"
    fills: Dict[str, float],       # slot -> value for non-matching pair lanes
    max_groups: int,
    fanout_cap: int,
    axis: str = "dp",
):
    """Production distributed broadcast-join + two-phase aggregation.

    The device-native CollectLeft hash join feeding a partitioned aggregate
    (SURVEY.md §2.6.4-5): the sorted build side is replicated over the
    mesh (in_specs P() — an implicit broadcast, the all_gather analog of
    the reference's shared OnceAsync build, hash_join.rs:313); probe rows
    are sharded; each shard expands its matches into a fixed
    `rows × fanout_cap` lane space (fanout_cap = exact max key
    multiplicity on the build side, computed by the caller), folds a
    fixed-size partial group table, and the tables exchange exactly like
    `distributed_group_aggregate`.

    Returns the replicated (group_keys, group_valid, {slot: agg}).
    """
    slot_names = tuple(sorted(set(sb_values) | set(probe_values)))
    b_names = tuple(n for n in slot_names if n in sb_values)
    p_names = tuple(n for n in slot_names if n in probe_values)
    n_shards = mesh.shape[axis]
    nb = sb_keys.shape[0]

    def step(sbk, sbg, pk_l, pvalid_l, pg_l, b_arrs, p_arrs):
        n_local = pk_l.shape[0]
        lo = jnp.searchsorted(sbk, pk_l, side="left", method="sort")
        hi = jnp.searchsorted(sbk, pk_l, side="right", method="sort")
        counts = jnp.where(pvalid_l, jnp.minimum(hi - lo, fanout_cap), 0)
        offs = jnp.cumsum(counts)
        cap = n_local * fanout_cap
        j = jnp.arange(cap)
        prow = jnp.clip(jnp.searchsorted(offs, j, side="right", method="sort"),
                        0, n_local - 1)
        within = j - (offs[prow] - counts[prow])
        bpos = jnp.clip(lo[prow] + within, 0, nb - 1)
        pair_valid = (j < offs[-1]) & (sbk[bpos] == pk_l[prow])
        pair_group = jnp.where(pair_valid, pg_l[prow] | sbg[bpos], 0)

        vals = {}
        for name in slot_names:
            if name in p_names:
                v = p_arrs[p_names.index(name)][prow]
            else:
                v = b_arrs[b_names.index(name)][bpos]
            v = jnp.where(pair_valid, v, jnp.asarray(fills[name], v.dtype))
            vals[name] = (kinds[name], v)
        gk, gv, partial_aggs, _ng = device_group_aggregate(
            pair_group, pair_valid, vals, max_groups)

        # ---- exchange + ownership reduce (same as the aggregation path)
        gk_all = jax.lax.all_gather(gk, axis).reshape(-1)
        gv_all = jax.lax.all_gather(gv, axis).reshape(-1)
        agg_all = {n: jax.lax.all_gather(a, axis).reshape(-1)
                   for n, a in partial_aggs.items()}
        my = jax.lax.axis_index(axis)
        owner = (_splitmix64_jnp(gk_all.astype(jnp.uint64))
                 % jnp.uint64(n_shards)).astype(jnp.int32)
        mine = gv_all & (owner == my)
        merge_vals = {n: ("sum" if kinds[n] == "sum" else kinds[n], a)
                      for n, a in agg_all.items()}
        fk, fv, faggs, _ng2 = device_group_aggregate(
            gk_all, mine, merge_vals, max_groups)
        return (jax.lax.all_gather(fk, axis).reshape(-1),
                jax.lax.all_gather(fv, axis).reshape(-1),
                {n: jax.lax.all_gather(a, axis).reshape(-1)
                 for n, a in faggs.items()})

    from jax import shard_map
    in_specs = (P(), P(), P(axis), P(axis), P(axis),
                tuple(P() for _ in b_names), tuple(P(axis) for _ in p_names))
    out_specs = (P(), P(), {n: P() for n in slot_names})
    fn = shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    shd = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    args = (jax.device_put(sb_keys, rep), jax.device_put(sb_group, rep),
            jax.device_put(probe_keys, shd), jax.device_put(probe_valid, shd),
            jax.device_put(probe_group, shd),
            tuple(jax.device_put(sb_values[n], rep) for n in b_names),
            tuple(jax.device_put(probe_values[n], shd) for n in p_names))
    return jax.jit(fn, static_argnums=())(*args)
