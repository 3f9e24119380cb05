"""DeviceJoinAggregateExec — hash join fused with group aggregation in
compiled device programs.

Reference parity: the HashJoinExec probe loop (`joins/hash_join.rs:1368`)
feeding GroupedHashAggregateStream — here the whole
`build -> probe -> expand pairs -> residual filter -> group aggregate`
pipeline runs on device, and ONLY the final group table crosses back to
the host. The joined intermediate is never materialized off-device.

Static-shape strategy for the data-dependent join fanout:
  1. a counting program computes per-probe-row match ranges
     (binary search over the sorted build hashes) and the total pair count;
  2. the host reads the total, picks a bucket-rounded capacity;
  3. an expansion program materializes pair indices into that fixed
     capacity (searchsorted over the prefix-sum of counts — all gathers),
     gathers both sides' columns at the pair indices, verifies exact key
     equality (hash-collision filter, `equal_rows_arr` analog), applies
     the residual predicate, and feeds the masked pairs straight into
     `device_group_aggregate`.

v1 scope: INNER equi joins, join keys that are plain columns, group-by /
aggregate / residual expressions lowerable by `device/lower.py`.
Everything else falls back to the host operators (`self.fallback`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ...common.batch import Batch, round_capacity
from ...common.column import Column
from ...common.schema import Schema
from ...runtime import BaselineMetrics, TaskContext
from ..expressions import ColumnExpr, PhysicalExpr
from .base import ExecutionPlan, Partitioning
from .device_aggregate import (DeviceGroupAggregateExec,
                               DeviceLoweringUnsupported, _STEP_CACHE,
                               _STEP_CACHE_MAX)


def _fnv_lut(dic) -> np.ndarray:
    from ..hashing import fnv_dictionary_lut
    if dic is None or len(dic) == 0:
        return np.zeros(1, np.uint64)
    return fnv_dictionary_lut(dic)


def _remap_lut(from_dic, to_dic) -> np.ndarray:
    """LUT: code in from_dic -> code in to_dic, -1 when absent (exact
    cross-dictionary equality for string join keys)."""
    if from_dic is None or len(from_dic) == 0:
        return np.full(1, -1, np.int64)
    tvals = to_dic.values.astype(str) if to_dic is not None and len(to_dic) \
        else np.array([], dtype=str)
    fvals = from_dic.values.astype(str)
    pos = np.searchsorted(tvals, fvals)
    pos = np.clip(pos, 0, max(len(tvals) - 1, 0))
    if len(tvals):
        match = tvals[pos] == fvals
        out = np.where(match, pos, -1).astype(np.int64)
    else:
        out = np.full(len(fvals), -1, np.int64)
    return out


# speculative pair-expansion capacities per compiled program shape
_CAP_CACHE: dict = {}


class DeviceJoinAggregateExec(DeviceGroupAggregateExec):
    """group_exprs / aggs / predicate are expressed against the PAIR
    column space: build source columns 0..nb-1, probe source columns
    nb..nb+np-1. `build_keys`/`probe_keys` are ColumnExprs against their
    side's source schema."""

    def __init__(self, build_source: ExecutionPlan, probe_source: ExecutionPlan,
                 build_keys: List[ColumnExpr], probe_keys: List[ColumnExpr],
                 build_predicate: Optional[PhysicalExpr],
                 probe_predicate: Optional[PhysicalExpr],
                 predicate: Optional[PhysicalExpr],
                 group_exprs, aggs, schema: Schema,
                 fallback: ExecutionPlan, max_groups: int = 1 << 22):
        ExecutionPlan.__init__(self)
        self.source = None
        self.build_source = build_source
        self.probe_source = probe_source
        self.build_keys = build_keys
        self.probe_keys = probe_keys
        self.build_predicate = build_predicate
        self.probe_predicate = probe_predicate
        self.predicate = predicate
        self.group_exprs = group_exprs
        self.aggs = aggs
        self._schema = schema
        self.fallback = fallback
        self.max_groups = max_groups
        self._n_build_cols = len(build_source.schema())

    def children(self):
        return [self.build_source, self.probe_source]

    def with_children(self, c):
        return DeviceJoinAggregateExec(
            c[0], c[1], self.build_keys, self.probe_keys,
            self.build_predicate, self.probe_predicate, self.predicate,
            self.group_exprs, self.aggs, self._schema, self.fallback,
            self.max_groups)

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def display_line(self):
        on = ", ".join(f"({l} = {r})" for l, r in
                       zip(self.build_keys, self.probe_keys))
        gb = ", ".join(n for _, n in self.group_exprs)
        ag = ", ".join(a.display for a in self.aggs)
        return (f"DeviceJoinAggregateExec: on=[{on}], gby=[{gb}], "
                f"aggr=[{ag}]")

    def _sig(self):
        return (
            "join_agg",
            tuple(str(k) for k in self.build_keys),
            tuple(str(k) for k in self.probe_keys),
            str(self.build_predicate), str(self.probe_predicate),
            str(self.predicate),
            tuple(str(e) for e, _ in self.group_exprs),
            tuple((a.display, a.name, tuple(str(x) for x in a.args))
                  for a in self.aggs),
            self.max_groups,
        )

    @staticmethod
    def _cached(key, make):
        fn = _STEP_CACHE.get(key)
        if fn is None:
            fn = make()
            if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                _STEP_CACHE.clear()
            _STEP_CACHE[key] = fn
        return fn

    # ------------------------------------------------------------------
    def _execute_device(self, partition: int, ctx: TaskContext) -> Optional[Batch]:
        import jax
        import jax.numpy as jnp
        from ...device.lower import LoweringError, lower_expr
        from ...device.groupby import device_group_aggregate

        m = BaselineMetrics(self.metrics, partition)
        from .base import collect_batch, execute_stream

        for k in self.build_keys + self.probe_keys:
            if not isinstance(k, ColumnExpr):
                raise DeviceLoweringUnsupported("join keys must be columns")

        # ---- lower expressions -----------------------------------------
        try:
            pred_l = lower_expr(self.predicate) if self.predicate is not None else None
            bpred_l = lower_expr(self.build_predicate) \
                if self.build_predicate is not None else None
            ppred_l = lower_expr(self.probe_predicate) \
                if self.probe_predicate is not None else None
            key_l = [lower_expr(e) for e, _ in self.group_exprs]
            agg_specs, slot_defs, slot_map = self._prepare_slots(lower_expr)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))

        # pair-space aux layout (predicate + group keys + slot args)
        pair_lowereds, seen = [], set()
        for low in ([pred_l] if pred_l is not None else []) + key_l + \
                [arg for _, arg in slot_defs.values() if arg is not None]:
            if id(low) not in seen:
                seen.add(id(low))
                pair_lowereds.append(low)
        pair_aux_offset, off = {}, 0
        for low in pair_lowereds:
            pair_aux_offset[id(low)] = off
            off += len(low.aux)

        # ---- collect + stage the build side ------------------------------
        build_batch = collect_batch(self.build_source, ctx)
        from ...runtime import MemoryReservation
        reservation = MemoryReservation("DeviceJoinAggregateExec[build]",
                                        ctx.memory_pool)
        reservation.try_grow(build_batch.nbytes())
        probe_batches = [b for b in execute_stream(self.probe_source, ctx)
                         if b.num_rows]

        # key-packing plan over the PAIR column space (per-column data comes
        # from whichever source owns the column)
        if len(probe_batches) > 1:
            for (e, _n) in self.group_exprs:
                if isinstance(e, ColumnExpr) and e.out_type.is_string and \
                        e.index >= self._n_build_cols:
                    raise DeviceLoweringUnsupported(
                        "probe-side string group keys need a single batch")
        pair_plan_batch = self._pair_planning_batch(build_batch, probe_batches)
        plan = self._plan_key_packing([pair_plan_batch] if pair_plan_batch else [],
                                      key_l)
        key_space = 1 << sum(plan.bits)
        max_groups = min(key_space, self.max_groups)
        dense_keys = key_space == max_groups

        nb_cols = self._n_build_cols
        bcap_staged = round_capacity(build_batch.capacity)
        b_cols = tuple(c.data_device_padded(bcap_staged)
                       for c in build_batch.columns)
        b_valids_present = tuple(c.validity_device_padded(bcap_staged)
                                 for c in build_batch.columns if c.has_nulls)
        b_null_layout = tuple(c.has_nulls for c in build_batch.columns)

        # string join keys: value hashing + exact compare auxiliaries
        bkey_dicts = [build_batch.columns[k.index].dictionary
                      if k.out_type.is_string else None
                      for k in self.build_keys]

        # ---- build program -------------------------------------------------
        nbuild = build_batch.num_rows
        bcap = build_batch.capacity

        # Dense unique-key fast path (PK-FK joins, most of TPC-H): when the
        # single build key holds unique integers in a bounded range, probe
        # via ONE direct-address LUT gather instead of hash + two
        # sort-based searchsorted passes per probe batch. Also
        # removes the pair-capacity scalar fetch: pairs <= probe rows, so
        # the pair space IS the probe space (out_cap static).
        dense_lut = None
        if (len(self.build_keys) == 1
                and self.build_keys[0].out_type.is_integer
                and self.probe_keys[0].out_type.is_integer):
            stats = build_batch.columns[self.build_keys[0].index] \
                .dense_key_stats()
            if stats is not None:
                kmin, span = stats
                bk0 = self.build_keys[0]

                def lut_prog(cols, present_valids, num_rows, baux):
                    valids = self._assemble_valids(jnp, cols, present_valids,
                                                   b_null_layout)
                    n = cols[bk0.index].shape[0]
                    valid = jnp.arange(n) < num_rows
                    if bpred_l is not None:
                        d, v = bpred_l.trace(cols, valids, baux)
                        valid = valid & d
                        if v is not None:
                            valid = valid & v
                    off = cols[bk0.index].astype(jnp.int64) - kmin
                    idx = jnp.where(valid, off, span)  # dead rows -> trash
                    lut = jnp.full(span + 1, -1, jnp.int32).at[idx].set(
                        jnp.arange(n, dtype=jnp.int32))
                    return lut[:span]

                jl = self._cached(
                    self._sig() + ("lut", int(kmin), int(span),
                                   b_null_layout, bcap_staged),
                    lambda: jax.jit(lut_prog))
                baux0 = tuple(np.asarray(spec.fn(build_batch)) for spec in
                              (bpred_l.aux if bpred_l is not None else []))
                m.record_bytes(nbuild * 8 + span * 4)
                lut_arr = jl(b_cols, b_valids_present, np.int64(nbuild),
                             baux0)
                dense_lut = (lut_arr, int(kmin), int(span))

        def build_prog(cols, present_valids, num_rows, aux_luts, baux):
            valids = self._assemble_valids(jnp, cols, present_valids,
                                           b_null_layout)
            valid = jnp.arange(cols[0].shape[0] if cols else 1) < num_rows
            if bpred_l is not None:
                d, v = bpred_l.trace(cols, valids, baux)
                valid = valid & d
                if v is not None:
                    valid = valid & v
            h = self._hash_keys(jnp, cols, valids, self.build_keys,
                                aux_luts, valid)
            order = jnp.argsort(h)
            return h[order], order

        b_luts = tuple(_fnv_lut(d) for d in bkey_dicts)
        if dense_lut is None:
            jb = self._cached(self._sig() + ("build", b_null_layout),
                              lambda: jax.jit(build_prog))
            # SOL: build-side hash + sort touches every build column once
            m.record_bytes(nbuild * (
                sum(int(c.dtype.device_dtype().itemsize)
                    for c in build_batch.columns)
                + sum(1 for c in build_batch.columns if c.has_nulls)))
            baux = tuple(np.asarray(spec.fn(build_batch)) for spec in
                         (bpred_l.aux if bpred_l is not None else []))
            sorted_hash, sorted_rows = jb(b_cols, b_valids_present,
                                          np.int64(nbuild), b_luts, baux)
        else:
            sorted_hash = sorted_rows = None

        # ---- probe loop (speculative capacity, one retry with exact
        # counts when the -3 poison sentinel surfaces at emit) -----------
        from .device_aggregate import DeviceCapacityRetry
        out = None
        for attempt in (True, False):
            state = None
            total_pairs = 0
            for pb in probe_batches:
                pair_view = self._pair_planning_batch(build_batch, [pb])
                paux = tuple(np.asarray(spec.fn(pb))
                             for spec in (ppred_l.aux if ppred_l is not None else []))
                pair_aux = []
                for low in pair_lowereds:
                    for spec in low.aux:
                        pair_aux.append(np.asarray(spec.fn(pair_view)))
                state, got = self._probe_batch(
                    jax, jnp, pb, b_cols, b_null_layout, b_valids_present,
                    sorted_hash, sorted_rows, bkey_dicts,
                    pred_l, ppred_l, key_l, slot_defs, plan, dense_keys,
                    max_groups, state, m, paux, tuple(pair_aux),
                    pair_aux_offset, speculate=attempt, dense_lut=dense_lut)
                total_pairs += got
            try:
                with m.elapsed_compute, m.device_compute:  # sync + transfer
                    out = self._emit(state, plan, slot_map, m)
            except DeviceCapacityRetry:
                if not attempt:
                    raise DeviceLoweringUnsupported(
                        "capacity retry looped")   # defensive; unreachable
                continue
            break
        if out is not None:
            m.record_output(out.num_rows)
        return out

    # ------------------------------------------------------------------
    def _prepare_slots(self, lower_expr):
        from ...device.lower import LoweringError
        from .device_aggregate import _DEVICE_AGGS
        agg_specs = []
        for a in self.aggs:
            kind = "avg" if a.name == "mean" else a.name
            if kind not in _DEVICE_AGGS:
                raise LoweringError(kind)
            if a.filter is not None or a.distinct:
                raise LoweringError("agg FILTER/DISTINCT on device TBD")
            if kind in ("min", "max") and a.out_type.is_string:
                raise LoweringError("string min/max on device TBD")
            arg = lower_expr(a.args[0]) if a.args else None
            sig = str(a.args[0]) if a.args else "*"
            agg_specs.append((a.display, kind, arg, sig))
        slot_defs, slot_map, uniq = {}, {}, {}

        def _slot(cat, sig, suffix, arg):
            key = (cat, sig)
            if key not in uniq:
                uniq[key] = f"v{len(uniq)}{suffix}"
                slot_defs[uniq[key]] = (cat, arg)
            return uniq[key]

        for display, kind, arg, sig in agg_specs:
            m_ = {}
            if kind in ("sum", "avg"):
                m_["s"] = _slot("sum", sig, "#s", arg)
                m_["c"] = _slot("cnt", sig, "#c", arg)
            elif kind == "count":
                m_["c"] = _slot("cnt", sig, "#c", arg)
            elif kind == "min":
                m_["n"] = _slot("min", sig, "#n", arg)
                m_["c"] = _slot("cnt", sig, "#c", arg)
            else:
                m_["x"] = _slot("max", sig, "#x", arg)
                m_["c"] = _slot("cnt", sig, "#c", arg)
            slot_map[display] = m_
        return agg_specs, slot_defs, slot_map

    def _pair_planning_batch(self, build_batch, probe_batches):
        """A zero-row pseudo-batch exposing pair-space columns so
        _plan_key_packing can see ranges/dictionaries."""
        if not probe_batches:
            return None
        from ...common.batch import concat_batches
        cols = list(build_batch.columns)
        # per-column range info comes from every probe batch: concat key
        # columns cheaply column-wise on host (ranges only; host min/max)
        probe_cols = []
        for i in range(len(probe_batches[0].columns)):
            if len(probe_batches) == 1:
                probe_cols.append(probe_batches[0].columns[i])
            else:
                from ...common.column import concat_columns
                probe_cols.append(concat_columns(
                    [b.columns[i] for b in probe_batches]))
        cols.extend(probe_cols)
        return _PairView(cols)

    @staticmethod
    def _assemble_valids(jnp, cols, present_valids, null_layout):
        valids, vi = [], 0
        for c, has in zip(cols, null_layout):
            if has:
                valids.append(present_valids[vi])
                vi += 1
            else:
                valids.append(jnp.ones(c.shape[0], bool))
        return tuple(valids)

    def _hash_keys(self, jnp, cols, valids, keys, luts, row_valid):
        """Deterministic device hash over the key columns (splitmix combine,
        FNV LUT for strings) — identical structure to host create_hashes."""
        out = None
        null_hash = jnp.uint64(0x9E3779B97F4A7C15)
        for i, k in enumerate(keys):
            c = cols[k.index]
            v = valids[k.index]
            if k.out_type.is_string:
                lut = luts[i]
                bits = lut[jnp.clip(c, 0, lut.shape[0] - 1)]
            elif jnp.issubdtype(c.dtype, jnp.floating):
                d = c.astype(jnp.float64)
                d = jnp.where(d == 0.0, 0.0, d)
                bits = jax_view_u64(jnp, d)
            else:
                bits = c.astype(jnp.int64).view(jnp.uint64) if hasattr(c, "view") \
                    else c.astype(jnp.uint64)
                bits = jax_bitcast_u64(jnp, c)
            h = _splitmix_jnp(jnp, bits)
            h = jnp.where(v, h, null_hash)
            if out is None:
                out = h
            else:
                out = _splitmix_jnp(
                    jnp, out ^ (h + jnp.uint64(0x9E3779B97F4A7C15)
                                + (out << jnp.uint64(6))
                                + (out >> jnp.uint64(2))))
        # rows with any NULL key never match: send them to the sentinel
        any_null = None
        for k in keys:
            v = valids[k.index]
            any_null = ~v if any_null is None else (any_null | ~v)
        dead = any_null | ~row_valid
        return jnp.where(dead, jnp.uint64(0xFFFFFFFFFFFFFFFF), out)

    # ------------------------------------------------------------------
    def _probe_batch(self, jax, jnp, pb, b_cols, b_null_layout,
                     b_valids_present, sorted_hash, sorted_rows, bkey_dicts,
                     pred_l, ppred_l, key_l, slot_defs, plan, dense_keys,
                     max_groups, state, m, paux, pair_aux, pair_aux_offset,
                     speculate=True, dense_lut=None):
        from ...device.groupby import device_group_aggregate

        nb_cols = self._n_build_cols
        pcap_staged = round_capacity(pb.capacity)
        p_cols = tuple(c.data_device_padded(pcap_staged) for c in pb.columns)
        p_valids_present = tuple(c.validity_device_padded(pcap_staged)
                                 for c in pb.columns if c.has_nulls)
        p_null_layout = tuple(c.has_nulls for c in pb.columns)
        # bandwidth accounting: probe-side bytes touched by the hash+count
        # and pair-expansion programs (device memory traffic)
        m.record_bytes(pb.num_rows * (
            sum(int(c.dtype.device_dtype().itemsize) for c in pb.columns)
            + sum(1 for c in pb.columns if c.has_nulls)))
        pkey_dicts = [pb.columns[k.index].dictionary
                      if k.out_type.is_string else None
                      for k in self.probe_keys]
        p_luts = tuple(_fnv_lut(d) for d in pkey_dicts)
        # exact string equality across dictionaries: probe code -> build code
        remaps = tuple(
            _remap_lut(pd_, bd)
            for pd_, bd in zip(pkey_dicts, bkey_dicts) if pd_ is not None)

        probe_keys = self.probe_keys
        build_keys = self.build_keys
        pred_l_ = pred_l
        ppred_l_ = ppred_l
        hash_keys = self._hash_keys
        assemble = self._assemble_valids

        def pair_tail(pair_cols, pair_valids, pair_valid, aux):
            """Shared pair-space epilogue: residual predicate, group-key
            packing, aggregate slot values, grouped aggregation. Used by
            both the generic expand program and the dense-LUT program."""
            def sub_aux(low):
                o = pair_aux_offset[id(low)]
                return aux[o:o + len(low.aux)]

            if pred_l_ is not None:
                d, v = pred_l_.trace(pair_cols, pair_valids, sub_aux(pred_l_))
                pair_valid = pair_valid & d
                if v is not None:
                    pair_valid = pair_valid & v
            packed = jnp.zeros(pair_valid.shape[0], jnp.int64)
            shift = 0
            for low, off, bits in zip(key_l, plan.offsets, plan.bits):
                kd, kv = low.trace(pair_cols, pair_valids, sub_aux(low))
                kk = kd.astype(jnp.int64) - jnp.int64(off) + 1
                if kv is not None:
                    kk = jnp.where(kv, kk, 0)
                packed = packed | (kk << shift)
                shift += bits
            values = {}
            for slot, (cat, arg) in slot_defs.items():
                if arg is None:
                    values[slot] = ("sum", pair_valid.astype(jnp.int64))
                    continue
                ad, av = arg.trace(pair_cols, pair_valids, sub_aux(arg))
                avail = pair_valid if av is None else (pair_valid & av)
                if cat == "sum":
                    acc = jnp.float64 if arg.out_dtype.is_float else jnp.int64
                    values[slot] = ("sum", jnp.where(avail, ad.astype(acc), 0))
                elif cat == "cnt":
                    values[slot] = ("sum", avail.astype(jnp.int64))
                elif cat == "min":
                    is_f = jnp.issubdtype(ad.dtype, jnp.floating)
                    ident = jnp.asarray(
                        jnp.inf if is_f else jnp.iinfo(ad.dtype).max, ad.dtype)
                    values[slot] = ("min", jnp.where(avail, ad, ident))
                else:
                    is_f = jnp.issubdtype(ad.dtype, jnp.floating)
                    ident = jnp.asarray(
                        -jnp.inf if is_f else jnp.iinfo(ad.dtype).min, ad.dtype)
                    values[slot] = ("max", jnp.where(avail, ad, ident))
            return device_group_aggregate(packed, pair_valid, values,
                                          max_groups,
                                          assume_dense_keys=dense_keys)

        if dense_lut is not None:
            # dense unique-key fast path: the pair space IS the (padded)
            # probe space — prow is the identity, brow is one LUT gather.
            # No hash, no searchsorted, no capacity fetch, no retry.
            lut_arr, kmin, span = dense_lut
            pk0 = probe_keys[0]

            def dense_prog(pcols, pvalids_present, bcols, bvalids_present,
                           lut, num_rows, aux, paux_):
                pvalids = assemble(jnp, pcols, pvalids_present, p_null_layout)
                bvalids = assemble(jnp, bcols, bvalids_present, b_null_layout)
                pcap = pcols[0].shape[0]
                valid = jnp.arange(pcap) < num_rows
                if ppred_l_ is not None:
                    d, v = ppred_l_.trace(pcols, pvalids, paux_)
                    valid = valid & d
                    if v is not None:
                        valid = valid & v
                off = pcols[pk0.index].astype(jnp.int64) - kmin
                inr = (off >= 0) & (off < span)
                braw = lut[jnp.clip(off, 0, span - 1)]
                pair_valid = valid & pvalids[pk0.index] & inr & (braw >= 0)
                brow = jnp.clip(braw, 0, bcols[0].shape[0] - 1)
                pair_cols = tuple(c[brow] for c in bcols) + pcols
                pair_valids = tuple(v[brow] for v in bvalids) + pvalids
                return pair_tail(pair_cols, pair_valids, pair_valid, aux)

            jd = self._cached(
                self._sig() + ("dense", p_null_layout, b_null_layout,
                               tuple(plan.offsets), tuple(plan.bits),
                               bool(dense_keys), max_groups, kmin, span,
                               pcap_staged,
                               b_cols[0].shape[0] if b_cols else 0),
                lambda: jax.jit(dense_prog))
            # SOL: one i32 LUT gather + the probe columns already counted
            m.record_bytes(pcap_staged * 12)
            from .device_aggregate import _overflow_poison
            with m.elapsed_compute, m.device_compute:
                part = jd(p_cols, p_valids_present, b_cols, b_valids_present,
                          lut_arr, np.int64(pb.num_rows), pair_aux, paux)
                gk = part[0] if dense_keys else \
                    _overflow_poison(max_groups)(part[0], part[3])
                state = (gk, part[1], part[2]) if state is None else \
                    self._merge(state, (gk, part[1], part[2]), jnp,
                                max_groups)
            # pairs <= probe rows for a unique-key build: report the probe
            # row count so total_pairs metrics stay an upper bound instead
            # of silently excluding dense-path batches
            return state, pb.num_rows

        def count_prog(pcols, pvalids_present, num_rows, shash, p_luts, paux_):
            pvalids = assemble(jnp, pcols, pvalids_present, p_null_layout)
            valid = jnp.arange(pcols[0].shape[0]) < num_rows
            if ppred_l_ is not None:
                d, v = ppred_l_.trace(pcols, pvalids, paux_)
                valid = valid & d
                if v is not None:
                    valid = valid & v
            h = hash_keys(jnp, pcols, pvalids, probe_keys, p_luts, valid)
            lo = jnp.searchsorted(shash, h, side="left", method="sort")
            hi = jnp.searchsorted(shash, h, side="right", method="sort")
            counts = jnp.where(valid & (h != jnp.uint64(0xFFFFFFFFFFFFFFFF)),
                               hi - lo, 0)
            return lo, counts, jnp.sum(counts)

        jc = self._cached(self._sig() + ("count", p_null_layout),
                          lambda: jax.jit(count_prog))
        lo, counts, total = jc(p_cols, p_valids_present,
                               np.int64(pb.num_rows), sorted_hash, p_luts,
                               paux)
        # `int(total)` is a blocking scalar device fetch. In
        # speculative mode reuse the last capacity seen for this program
        # shape; the expand program poisons the key lane with -3 when the
        # real pair count exceeds it, _emit raises DeviceCapacityRetry,
        # and _execute_device re-runs with exact counts. Steady state:
        # zero extra round-trips per probe batch.
        cap_key = self._sig() + ("cap", p_cols[0].shape[0] if p_cols else 0,
                                 sorted_hash.shape[0])
        out_cap = _CAP_CACHE.get(cap_key) if speculate else None
        if out_cap is None:
            total = int(total)
            if total == 0:
                _CAP_CACHE[cap_key] = round_capacity(1)
                return state, 0
            out_cap = round_capacity(total)
            prev = _CAP_CACHE.get(cap_key, 0)
            _CAP_CACHE[cap_key] = max(prev, out_cap)
            out_cap = _CAP_CACHE[cap_key]
            total_known = total
        else:
            total_known = 0

        def expand_prog(pcols, pvalids_present, bcols, bvalids_present,
                        lo, counts, srows, remaps, aux):
            offs = jnp.cumsum(counts)
            starts = offs - counts
            j = jnp.arange(out_cap)
            # pair j -> probe row via binary search on exclusive prefix sums
            prow = jnp.searchsorted(offs, j, side="right", method="sort")
            prow = jnp.clip(prow, 0, counts.shape[0] - 1)
            within = j - starts[prow]
            bpos = lo[prow] + within
            bpos = jnp.clip(bpos, 0, srows.shape[0] - 1)
            brow = srows[bpos]
            pair_valid = j < jnp.minimum(offs[-1], out_cap)

            bvalids = assemble(jnp, bcols, bvalids_present, b_null_layout)
            pvalids = assemble(jnp, pcols, pvalids_present, p_null_layout)

            # exact key verification at pair positions
            ri = 0
            for bk, pk in zip(build_keys, probe_keys):
                bval = bcols[bk.index][brow]
                pval = pcols[pk.index][prow]
                if bk.out_type.is_string:
                    remap = remaps[ri]
                    ri += 1
                    pmapped = remap[jnp.clip(pval, 0, remap.shape[0] - 1)]
                    eq = pmapped == bval.astype(jnp.int64)
                else:
                    eq = bval.astype(jnp.float64) == pval.astype(jnp.float64) \
                        if (jnp.issubdtype(bval.dtype, jnp.floating)
                            or jnp.issubdtype(pval.dtype, jnp.floating)) \
                        else bval.astype(jnp.int64) == pval.astype(jnp.int64)
                pair_valid = pair_valid & eq

            # pair column space: build cols gathered ++ probe cols gathered
            pair_cols = tuple(c[brow] for c in bcols) + \
                tuple(c[prow] for c in pcols)
            pair_valids = tuple(v[brow] for v in bvalids) + \
                tuple(v[prow] for v in pvalids)

            gk_, gv_, aggs_, ng_ = pair_tail(pair_cols, pair_valids,
                                             pair_valid, aux)
            # speculative capacity overflow -> poison -3 (retry signal)
            gk_ = jnp.where(offs[-1] > out_cap, jnp.full_like(gk_, -3), gk_)
            return gk_, gv_, aggs_, ng_

        je = self._cached(
            self._sig() + ("expand", p_null_layout, b_null_layout,
                           tuple(plan.offsets), tuple(plan.bits),
                           bool(dense_keys), max_groups, out_cap),
            lambda: jax.jit(expand_prog))
        # pair expansion gathers both sides once per emitted pair
        m.record_bytes(out_cap * 16)
        with m.elapsed_compute, m.device_compute:
            aux = pair_aux
            part = je(p_cols, p_valids_present, b_cols, b_valids_present,
                      lo, counts, sorted_rows, remaps, aux)
            # overflow check WITHOUT a blocking fetch: poison the key
            # lane on device (-2, impossible for packed keys); _emit
            # detects the sentinel after its single bulk fetch and raises
            # for host fallback.
            from .device_aggregate import _overflow_poison
            gk = part[0] if dense_keys else \
                _overflow_poison(max_groups)(part[0], part[3])
            state = (gk, part[1], part[2]) if state is None else \
                self._merge(state, (gk, part[1], part[2]), jnp, max_groups)
        return state, total_known


class _PairView:
    """Zero-row batch-like view over pair-space columns for packing plans."""

    def __init__(self, cols):
        self.columns = cols
        self.num_rows = 0


def _splitmix_jnp(jnp, x):
    x = x.astype(jnp.uint64)
    x = x + jnp.uint64(0x9E3779B97F4A7C15)
    z = x
    z = (z ^ (z >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return z ^ (z >> jnp.uint64(31))


def jax_view_u64(jnp, d):
    import jax
    return jax.lax.bitcast_convert_type(d, jnp.uint64)


def jax_bitcast_u64(jnp, c):
    import jax
    return jax.lax.bitcast_convert_type(c.astype(jnp.int64), jnp.uint64)
