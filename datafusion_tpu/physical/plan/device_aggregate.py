"""DeviceGroupAggregateExec — scan->filter->project->group-aggregate fused
into one jitted XLA program per shape bucket.

This is the device replacement for the reference's hot loop
(`aggregates/row_hash.rs:524`): instead of a hashtable intern + scatter
per batch on the CPU, the whole pipeline (predicate mask, measure
expressions, sort-based key intern, segment reductions, cross-batch state
merge) runs on the device; the host only stages padded column tiles and
resolves dictionary-dependent constants (`device/lower.py` aux inputs).

Group keys are packed exactly into one int64 word from per-column
(offset, bits) discovered by a cheap host min/max pass; when keys don't
fit 62 bits, or any expression can't be lowered, execution transparently
falls back to the host AggregateExec (`self.fallback`).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ...common import dt
from ...common.batch import Batch, round_capacity
from ...common.column import Column
from ...common.datatypes import TypeId
from ...common.schema import Schema
from ...runtime import BaselineMetrics, TaskContext
from ..expressions import PhysicalExpr
from .base import ExecutionPlan, Partitioning

_DEVICE_AGGS = {"count", "sum", "min", "max", "avg", "mean"}


class DeviceLoweringUnsupported(Exception):
    pass


class _GroupTableOverflow(Exception):
    """More groups than the fixed device table holds (key lane poisoned
    with -2). Top-k queries retry through the unbounded sorted path;
    everything else falls back to the host aggregate."""
    pass


class DeviceCapacityRetry(Exception):
    """Speculative pair-expansion capacity was too small (key lane poisoned
    with -3); the caller re-runs with exact counts."""
    pass


def _bucket_capacity(n: int, floor: int = 4096) -> int:
    """Next power of two >= n (>= floor): bounds staged padding at 2x while
    collapsing arbitrary table sizes onto O(log n) compiled shapes."""
    c = floor
    while c < n:
        c <<= 1
    return c


def _emit_capacity(n: int, floor: int = 4096) -> int:
    """Quarter-octave bucket >= n: emit buffers cross to the host, so
    padding is weighed above compiled-shape count here (1.125x worst case
    vs 2x for plain power-of-two; 4x the shape vocabulary). Whether the
    H100 needs this is ROADMAP C1."""
    c = floor
    while c < n:
        c <<= 1
    if c == floor:
        return c
    half = c >> 1
    for k in (0, 1, 2, 3):
        cand = half + (half >> 2) * k
        if cand >= n:
            return cand
    return c


class _PackPlan:
    def __init__(self, offsets, bits, key_types, key_dicts):
        self.offsets = offsets
        self.bits = bits
        self.key_types = key_types
        self.key_dicts = key_dicts


# compiled-step cache: identical (expressions, packing plan) -> same jitted
# program, so repeated queries skip retracing (the "compiled-kernel registry"
# of SURVEY.md §7). Keyed by structural signature; bounded LRU-ish.
_STEP_CACHE: Dict[tuple, object] = {}
_STEP_CACHE_MAX = 256
# jitted partial-table merge programs (one per shape/name signature)
_MERGE_CACHE: Dict[tuple, object] = {}


_POISON_CACHE = {}


def _overflow_poison(max_groups):
    """Jitted device-side overflow marker: when the group count exceeds
    the fixed table, every key becomes -2 (impossible for packed keys —
    invalid slots use -1, real keys are >= 0). `_emit` detects the
    sentinel after its single bulk fetch and raises for host fallback —
    replacing a blocking per-chunk scalar fetch."""
    fn = _POISON_CACHE.get(max_groups)
    if fn is None:
        import jax
        import jax.numpy as jnp
        fn = jax.jit(lambda gk, ng: jnp.where(
            ng > max_groups, jnp.full_like(gk, -2), gk))
        _POISON_CACHE[max_groups] = fn
    return fn


class DeviceGroupAggregateExec(ExecutionPlan):
    # class default so subclasses whose __init__ bypasses this one (join
    # chain / join-agg / distributed) read None until the fusion rule sets it
    post_filter: Optional[PhysicalExpr] = None

    def __init__(self, source: ExecutionPlan,
                 predicate: Optional[PhysicalExpr],
                 group_exprs: List[Tuple[PhysicalExpr, str]],
                 aggs: List,            # List[PhysAggregateExpr]
                 schema: Schema,
                 fallback: ExecutionPlan,
                 max_groups: int = 1 << 22,
                 topk: Optional[tuple] = None,
                 post_filter: Optional[PhysicalExpr] = None):
        super().__init__()
        self.source = source
        self.predicate = predicate
        self.group_exprs = group_exprs
        self.aggs = aggs
        self._schema = schema
        self.fallback = fallback
        self.max_groups = max_groups
        # (agg_index, asc, k): fused ORDER BY <aggregate> LIMIT k — emit
        # top-k group rows straight from the device (TopKAggregation
        # analog, reference: physical_optimizer/topk_aggregation.rs —
        # but selecting on-device instead of limiting the group table)
        self.topk = topk
        # HAVING-style predicate over this exec's OUTPUT schema, applied
        # to the group table ON DEVICE before emit: only surviving groups
        # cross to the host (Q18's `sum(l_quantity) > 300` keeps few of
        # its 1.5M groups). Set by the
        # FuseFilterIntoDeviceAggregate physical rule.
        self.post_filter = post_filter

    def schema(self):
        return self._schema

    def children(self):
        return [self.source]

    def with_children(self, c):
        return DeviceGroupAggregateExec(c[0], self.predicate, self.group_exprs,
                                        self.aggs, self._schema, self.fallback,
                                        self.max_groups, self.topk,
                                        self.post_filter)

    def output_partitioning(self):
        return Partitioning.unknown(1)

    # ------------------------------------------------------------------
    def execute(self, partition: int, ctx: TaskContext):
        self._attach_deferred_ctx(ctx)
        key = self._subtree_key(partition)
        cache = getattr(ctx, "subtree_cache", None)
        if cache is not None and key is not None and key in cache:
            out = cache[key]
            if out is not None:
                yield out
            return
        try:
            out = self._execute_device(partition, ctx)
        except (DeviceLoweringUnsupported, _GroupTableOverflow):
            yield from self.fallback.execute(partition, ctx)
            return
        if cache is not None and key is not None:
            cache[key] = out
        if out is not None:
            yield out

    def _attach_deferred_ctx(self, ctx):
        """Hand the query's TaskContext to every DeferredScalarExpr in
        this exec's expressions, so scalar subqueries run through the
        per-query subtree cache (shared CTE executions) instead of a
        fresh context."""
        from ..expressions import DeferredScalarExpr

        def walk(e):
            if isinstance(e, DeferredScalarExpr):
                e.bind_ctx(ctx)
            for c in e.children():
                walk(c)

        for e in self._deferred_expr_roots():
            if e is not None:
                walk(e)

    def _deferred_expr_roots(self):
        out = [getattr(self, "predicate", None),
               getattr(self, "probe_predicate", None),
               getattr(self, "build_predicate", None)]
        for e, _n in getattr(self, "group_exprs", []) or []:
            out.append(e)
        for a in getattr(self, "aggs", []) or []:
            out.extend(a.args)
            out.append(a.filter)
        for b in getattr(self, "builds", []) or []:
            out.extend(b.probe_keys)
            if b.sfilter is not None:
                out.append(b.sfilter[2])
        return out

    def _subtree_key(self, partition: int):
        """Structural identity of this subtree + leaf source identities —
        two identical aggregates over the same tables (inlined CTEs, e.g.
        TPC-H Q15's revenue0) share one execution per query."""
        try:
            tables = []
            stable = [True]

            def leaves(node):
                from .scan import WorkTableExec
                if isinstance(node, WorkTableExec):
                    # work-table contents change every recursion iteration:
                    # caching would freeze the first iteration's result
                    stable[0] = False
                    return
                t = getattr(node, "table", None)
                if t is not None:
                    tables.append(id(t))
                for c in node.children():
                    leaves(c)
            leaves(self)
            if not tables or not stable[0]:
                return None

            def esig(e):
                # display text alone is ambiguous (a.c1 and b.c1 both print
                # "c1"); include column indices structurally
                return (type(e).__name__, getattr(e, "index", None),
                        tuple(esig(c) for c in e.children()))
            sig = (tuple(esig(e) for e, _ in self.group_exprs),
                   tuple(esig(a) for ag in self.aggs for a in ag.args),
                   esig(self.predicate) if self.predicate is not None else None)
            return (type(self).__name__, partition,
                    self.display_indent(), sig, tuple(tables))
        except Exception:  # noqa: BLE001
            return None

    def _execute_device(self, partition: int, ctx: TaskContext) -> Optional[Batch]:
        import jax
        import jax.numpy as jnp
        from ...device.lower import LoweringError, lower_expr

        m = BaselineMetrics(self.metrics, partition)
        from .base import execute_stream
        batches = [b for b in execute_stream(self.source, ctx) if b.num_rows]

        # an aggregate over a PER-QUERY intermediate (join/window output,
        # not a registered-table scan) pays a fresh host->device transfer
        # of its whole input every execution, so above 8 MB it stays on
        # the host (e.g. TPC-H Q13's 1.5M-row LEFT-join output). The
        # cutoff is to be measured on the H100 (ROADMAP A4).
        if not self._source_is_scan() and batches:
            fresh = 0
            for b in batches:
                for c in b.columns:
                    try:
                        fresh += c.data_host().nbytes
                    except Exception:  # noqa: BLE001
                        pass
            if fresh > (8 << 20):
                raise DeviceLoweringUnsupported(
                    "uncached intermediate input: host aggregation beats "
                    "a fresh device transfer")

        try:
            pred_l = lower_expr(self.predicate) if self.predicate is not None else None
            key_l = [lower_expr(e) for e, _ in self.group_exprs]
            agg_specs = []   # (out_name, kind, Lowered or None, arg signature)
            for a in self.aggs:
                kind = "avg" if a.name == "mean" else a.name
                if kind not in _DEVICE_AGGS:
                    raise LoweringError(kind)
                if a.distinct and kind == "count" and a.args:
                    kind = "count_distinct"
                elif a.filter is not None or a.distinct:
                    raise LoweringError("agg FILTER/DISTINCT on device TBD")
                if kind in ("min", "max") and a.out_type.is_dict_coded:
                    raise LoweringError("string/binary min/max on device TBD")
                if len(a.args) > 1 or getattr(a, "order_by", None):
                    # count(a, b) null semantics / ordered aggregates need
                    # the host accumulators
                    raise LoweringError("multi-arg/ordered agg on device TBD")
                arg = lower_expr(a.args[0]) if a.args else None
                sig = str(a.args[0]) if a.args else "*"
                agg_specs.append((a.display, kind, arg, sig,
                                  a.out_type))
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))

        # slot dedup: aggregates sharing an argument expression share the
        # device-side sum/count/min/max slots (avg(x)+sum(x)+count(x) cost
        # one sum and one count) — keeps the fused program small
        slot_defs = {}   # slot name -> (slot kind, Lowered or None)
        slot_map = {}    # display -> {"s"/"c"/"n"/"x": slot name}
        uniq: Dict[tuple, str] = {}

        def _slot(cat: str, sig: str, suffix: str, arg):
            key = (cat, sig)
            if key not in uniq:
                uniq[key] = f"v{len(uniq)}{suffix}"
                slot_defs[uniq[key]] = (cat, arg)
            return uniq[key]

        for display, kind, arg, sig, out_t in agg_specs:
            m_ = {}
            if kind in ("sum", "avg"):
                m_["s"] = _slot("sum", sig, "#s", arg)
                m_["c"] = _slot("cnt", sig, "#c", arg)
            elif kind == "count_distinct":
                m_["d"] = _slot("distinct", sig, "#d", arg)
            elif kind == "count":
                m_["c"] = _slot("cnt", sig, "#c", arg)
            elif kind == "min":
                m_["n"] = _slot("min", sig, "#n", arg)
                m_["c"] = _slot("cnt", sig, "#c", arg)
                if out_t is not None and out_t.is_float:
                    m_["nn"] = _slot("nancnt", sig, "#nn", arg)
            else:  # max
                m_["x"] = _slot("max", sig, "#x", arg)
                m_["c"] = _slot("cnt", sig, "#c", arg)
                if out_t is not None and out_t.is_float:
                    m_["nn"] = _slot("nancnt", sig, "#nn", arg)
            slot_map[display] = m_

        plan = self._plan_key_packing(batches, key_l)
        # exact key space bound: product of per-column domains
        key_space = 1 << sum(plan.bits)
        max_groups = min(key_space, self.max_groups)
        dense_keys = key_space == max_groups
        has_distinct = any(cat == "distinct" for cat, _ in slot_defs.values())
        if has_distinct:
            # distinct rides the sorted path, and partial distinct counts
            # do not merge — the whole input must fit one program call
            dense_keys = False
            if len(batches) > 1 or \
                    (batches and batches[0].num_rows > (1 << 21)):
                raise DeviceLoweringUnsupported(
                    "count DISTINCT needs single-chunk input")
        # PRE-SORTED group key (reference analog: GroupOrdering::Full,
        # aggregates/order/full.rs): single no-null column already
        # non-decreasing -> the device aggregate skips the argsort and
        # the value reorder gathers entirely
        sorted_keys = False
        if not dense_keys and not has_distinct and \
                len(self.group_exprs) == 1 and batches:
            from ..expressions import ColumnExpr
            e0 = self.group_exprs[0][0]
            if isinstance(e0, ColumnExpr) and \
                    e0.index < len(batches[0].columns) and \
                    all(cat in ("sum", "cnt", "nancnt")
                        for cat, _ in slot_defs.values()):
                sorted_keys = all(
                    b.columns[e0.index].is_sorted_nondecreasing()
                    for b in batches)
        cache_key = (
            bool(dense_keys), bool(sorted_keys),
            str(self.predicate),
            tuple((str(e), str(e.out_type)) for e, _ in self.group_exprs),
            # arg TYPES matter: "sum(t.c)" over a re-created t with a
            # different column type must not reuse the old program
            tuple((a.display, a.name, getattr(a, "distinct", False),
                   tuple((str(x), str(x.out_type)) for x in a.args))
                  for a in self.aggs),
            tuple(plan.offsets), tuple(plan.bits), max_groups,
        )
        # deterministic lowered order for aux staging: predicate, keys, then
        # unique slot arguments (id-deduped — sum/count slots share objects)
        unique_lowereds = []
        seen_ids = set()
        for low in ([pred_l] if pred_l is not None else []) + key_l + \
                [arg for _, arg in slot_defs.values() if arg is not None]:
            if id(low) not in seen_ids:
                seen_ids.add(id(low))
                unique_lowereds.append(low)
        aux_offset = {}
        off = 0
        for low in unique_lowereds:
            aux_offset[id(low)] = off
            off += len(low.aux)

        # one jitted program per (cache_key, chunk size, null-mask layout)

        # chunk size bounds the per-step program and caps peak device
        # temporaries.
        # The dense path's program is tiny, so it takes whole batches.
        # Sparse chunks are large too: each inter-chunk merge re-sorts two
        # max_groups tables, so fewer chunks beats smaller working sets
        # (SF1 lineitem = one chunk, zero merges).
        chunk = 1 << 24 if dense_keys else 1 << 23

        # ROW-SPACE two-program path (see device_join_chain._execute_
        # rowspace): no fixed [max_groups] table, exact-count emit.
        # Key spaces <= 64 keep the unrolled dense path (cheaper still).
        rowspace = (
            (not dense_keys or max_groups > 64) and not self.topk and
            len(batches) == 1 and
            _bucket_capacity(batches[0].capacity) <= chunk and
            all(cat in ("sum", "cnt", "nancnt", "distinct")
                for cat, _ in slot_defs.values()))
        if rowspace:
            out = self._execute_rowspace_plain(
                jax, jnp, m, batches[0], pred_l, key_l, slot_defs,
                slot_map, plan, cache_key, unique_lowereds, aux_offset,
                sorted_keys)
            if out is not None:
                m.record_output(out.num_rows)
            return out

        def prepare_factory(null_layout, chunk_eff):
            key2 = ("prep", cache_key, null_layout, chunk_eff)
            f = _STEP_CACHE.get(key2)
            if f is None:
                st = self._make_step(pred_l, key_l, slot_defs, plan, jnp,
                                     max_groups, aux_offset, False,
                                     null_layout, chunk_eff)
                f = jax.jit(st.prepare)
                f.kinds = st.kinds
                _STEP_CACHE[key2] = f
            return f

        state = None
        for b in batches:
            # stage exact-shape device arrays; Column caches the device copy
            # so repeated queries over the same table skip the host->HBM
            # transfer entirely. ALL other staging (chunk slicing, validity
            # synthesis) happens inside the jitted program instead of as
            # eager dispatches.
            # bucket the staged capacity to a power of two so compiled
            # programs are shared across table sizes (a fresh capacity
            # otherwise recompiles every fused program)
            cap = _bucket_capacity(b.capacity)
            cols = tuple(c.data_device_padded(cap) for c in b.columns)
            present_valids = tuple(c.validity_device_padded(cap)
                                   for c in b.columns if c.has_nulls)
            null_layout = tuple(c.has_nulls for c in b.columns)
            if not cols:
                cols = ()
                null_layout = ()
            aux = self._collect_aux(unique_lowereds, b)
            chunk_eff = min(chunk, max(cap, 1))
            step_key = cache_key + (null_layout, chunk_eff, cap)
            jit_step = _STEP_CACHE.get(step_key)
            if jit_step is None:
                step = self._make_step(pred_l, key_l, slot_defs, plan, jnp,
                                       max_groups, aux_offset, dense_keys,
                                       null_layout, chunk_eff, sorted_keys)
                jit_step = jax.jit(step)
                jit_step.prepare = step.prepare
                if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                    _STEP_CACHE.clear()
                _STEP_CACHE[step_key] = jit_step
            chunk_bytes = sum(int(c.dtype.itemsize) for c in cols) + \
                sum(int(v.dtype.itemsize) for v in present_valids)
            for start in range(0, max(b.num_rows, 1), chunk_eff):
                rows_here = min(b.num_rows - start, chunk_eff)
                m.record_bytes(max(rows_here, 0) * chunk_bytes)
                with m.elapsed_compute, m.device_compute:
                    part = jit_step(cols, present_valids,
                                    np.int64(max(rows_here, 0)),
                                    np.int64(start), tuple(aux))
                    # dense tables cover the whole key space — overflow is
                    # impossible; otherwise mark overflow on-device
                    # (no blocking fetch; _emit checks the sentinel)
                    if dense_keys:
                        part = part[:3]
                    else:
                        part = (_overflow_poison(max_groups)(
                            part[0], part[3]), part[1], part[2])
                    state = part if state is None else \
                        self._merge(state, part, jnp, max_groups)

        lane_pick = self._topk_lane(slot_map) if self.topk else None
        with m.elapsed_compute, m.device_compute:
            # includes the device sync + transfer: dispatch above is
            # async, so the device window closes here
            try:
                if lane_pick is not None and state is not None \
                        and not dense_keys:
                    out = self._emit_topk(state[0], state[1], state[2],
                                          lane_pick, plan, slot_map, m)
                else:
                    out = self._emit(state, plan, slot_map, m)
            except _GroupTableOverflow:
                if not has_distinct:
                    # too many groups for the fixed table: re-run through
                    # the unbounded-cardinality sorted path — top-k emits
                    # only k rows; full emits compact the run-end layout
                    # on device and land the final table in host DRAM
                    # (SURVEY §5.4 HBM->host offload)
                    out = self._execute_big(
                        batches, prepare_factory, chunk,
                        unique_lowereds, lane_pick, plan, slot_map, m)
                else:
                    raise DeviceLoweringUnsupported(
                        "device group table overflow (poison sentinel)")
        if out is not None:
            m.record_output(out.num_rows)
        return out

    def _source_is_scan(self) -> bool:
        """True when the aggregate's input descends through stateless
        wrappers to table scans (whose columns cache their device copy
        across queries); joins/windows/etc. produce fresh batches."""
        from .projection import (CoalescePartitionsExec, FilterExec,
                                 GlobalLimitExec, ProjectionExec)
        from .scan import MemoryExec

        def walk(node):
            if isinstance(node, MemoryExec):
                return True
            if isinstance(node, (FilterExec, ProjectionExec,
                                 GlobalLimitExec, CoalescePartitionsExec)):
                return all(walk(c) for c in node.children())
            t = getattr(node, "table", None)
            return t is not None

        return walk(self.source)

    # ------------------------------------------------------------------
    @staticmethod
    def _phys_int_bounds(e, batches):
        """(lo, hi) integer bounds for an INTEGRAL-VALUED key expr, or
        None. Lets COMPUTED group keys pack: only expression shapes that
        provably produce integers qualify — including date_part, whose
        Float64 output (reference: date_part.rs returns Float64) always
        carries whole numbers."""
        from ..expressions import (BinaryPhysExpr, CastExpr, ColumnExpr,
                                   LiteralExpr, ScalarFunctionExpr)
        from ...expr.operator import Op
        B = DeviceGroupAggregateExec._phys_int_bounds
        if isinstance(e, ColumnExpr):
            t = e.out_type
            if t.is_boolean:
                return (0, 1)
            if not (t.is_integer or t.is_decimal or
                    t.id in (TypeId.DATE, TypeId.TIMESTAMP)):
                return None
            lo = hi = None
            for b in batches:
                d = b.columns[e.index].data_host()
                if len(d) == 0:
                    continue
                bl, bh = int(d.min()), int(d.max())
                lo = bl if lo is None else min(lo, bl)
                hi = bh if hi is None else max(hi, bh)
            return (0, 0) if lo is None else (lo, hi)
        if isinstance(e, LiteralExpr):
            v = e.value.value
            if v is None:
                return (0, 0)
            if isinstance(v, (int, np.integer, bool)):
                return (int(v), int(v))
            return None
        if isinstance(e, CastExpr) and e.out_type.is_integer:
            return B(e.expr, batches)
        if isinstance(e, BinaryPhysExpr) and \
                e.op in (Op.PLUS, Op.MINUS, Op.MULTIPLY) and \
                e.out_type.is_integer and e.left.out_type.is_integer and \
                e.right.out_type.is_integer:
            # integers only: decimal raw values carry scales, and
            # date/interval arithmetic is calendar logic
            lb, rb = B(e.left, batches), B(e.right, batches)
            if lb is None or rb is None:
                return None
            if e.op == Op.PLUS:
                return (lb[0] + rb[0], lb[1] + rb[1])
            if e.op == Op.MINUS:
                return (lb[0] - rb[1], lb[1] - rb[0])
            ps = [lb[0] * rb[0], lb[0] * rb[1], lb[1] * rb[0],
                  lb[1] * rb[1]]
            return (min(ps), max(ps))
        if isinstance(e, ScalarFunctionExpr) and \
                e.name in ("date_part", "datepart") and len(e.args) == 2:
            lit = e.args[0]
            if not isinstance(lit, LiteralExpr) or lit.value.value is None:
                return None
            from ...functions.datetime_impl import (_PART_ALIASES,
                                                    _TS_SCALE,
                                                    _days_to_ymd)
            part = _PART_ALIASES.get(str(lit.value.value).lower())
            fixed = {"quarter": (1, 4), "month": (1, 12), "day": (1, 31),
                     "doy": (1, 366), "week": (1, 53), "dow": (0, 6),
                     "hour": (0, 23), "minute": (0, 59),
                     "second": (0, 59), "millisecond": (0, 59_999),
                     "microsecond": (0, 59_999_999),
                     "nanosecond": (0, 59_999_999_999)}
            if part in fixed:
                return fixed[part]
            if part != "year":
                return None
            ct = e.args[1].out_type
            if getattr(ct, "tz", None):
                return None
            ib = B(e.args[1], batches)
            if ib is None:
                return None
            if ct.id == TypeId.DATE:
                to_us = 1000 if ct.unit == "ms" else 86_400_000_000
            elif ct.id == TypeId.TIMESTAMP:
                scale = _TS_SCALE[ct.unit]
                to_us = (10**6 // scale) if scale <= 10**6 \
                    else -(scale // 10**6)
            else:
                return None
            ends = np.asarray(ib, np.int64)
            us = ends // (-to_us) if to_us < 0 else ends * to_us
            y, _, _ = _days_to_ymd(us // 86_400_000_000)
            return (int(y[0]), int(y[1]))   # year is monotone in time
        return None

    def _plan_key_packing(self, batches, key_l,
                          group_exprs=None) -> _PackPlan:
        from ..expressions import ColumnExpr
        offsets, bits, key_types, key_dicts = [], [], [], []
        for (e, _name) in (group_exprs if group_exprs is not None
                           else self.group_exprs):
            t = e.out_type
            key_types.append(t)
            if t.is_dict_coded:
                if not isinstance(e, ColumnExpr):
                    raise DeviceLoweringUnsupported("string key must be a column")
                dics = {id(b.columns[e.index].dictionary) for b in batches}
                if len(dics) > 1:
                    raise DeviceLoweringUnsupported(
                        "per-batch dictionaries need host remap")
                dic = batches[0].columns[e.index].dictionary if batches else None
                key_dicts.append(dic)
                # codes stored as code+1 (0 = NULL): domain is len(dic)+1
                card = (len(dic) if dic is not None else 0) + 1
                offsets.append(0)
                bits.append(max(int(np.ceil(np.log2(card + 1))), 1))
            elif t.is_boolean:
                key_dicts.append(None)
                offsets.append(0)
                bits.append(2)
            elif t.is_integer or t.is_decimal or t.is_float or \
                    t.id in (TypeId.DATE, TypeId.TIMESTAMP):
                rng = self._phys_int_bounds(e, batches)
                if rng is None:
                    raise DeviceLoweringUnsupported(
                        f"group key {'type ' + str(t) if t.is_float else 'expr'}"
                        " not integer-boundable")
                lo, hi = rng
                key_dicts.append(None)
                offsets.append(lo)
                span = hi - lo + 1   # values stored v-lo+1, 0 = NULL
                bits.append(max(int(np.ceil(np.log2(span + 2))), 1))
            else:
                raise DeviceLoweringUnsupported(f"group key type {t}")
        if sum(bits) > 62:
            raise DeviceLoweringUnsupported(f"key bits {sum(bits)} > 62")
        return _PackPlan(offsets, bits, key_types, key_dicts)

    # ------------------------------------------------------------------
    def _make_step(self, pred_l, key_l, slot_defs, plan: _PackPlan, jnp,
                   max_groups, aux_offset, dense_keys=False,
                   null_layout=(), chunk_eff=None, sorted_keys=False):
        from ...device.groupby import device_group_aggregate
        import jax as _jax
        offsets, bits = plan.offsets, plan.bits

        def sub_aux(aux, low):
            o = aux_offset[id(low)]
            return aux[o:o + len(low.aux)]

        def prepare(full_cols, present_valids, num_rows, start, aux):
            # slice the resident table to this chunk inside the program
            if not full_cols:
                n = chunk_eff or 1
                cols = (jnp.zeros(n, np.int32),)
                valids = (jnp.ones(n, bool),)
            else:
                n = chunk_eff
                cols = tuple(
                    _jax.lax.dynamic_slice_in_dim(c, start, n)
                    if c.shape[0] > n else c for c in full_cols)
                valids = []
                vi = 0
                for c, has in zip(full_cols, null_layout):
                    if has:
                        v = present_valids[vi]
                        vi += 1
                        valids.append(
                            _jax.lax.dynamic_slice_in_dim(v, start, n)
                            if v.shape[0] > n else v)
                    else:
                        valids.append(jnp.ones(n, bool))
                valids = tuple(valids)
            row_valid = jnp.arange(n) < num_rows
            if pred_l is not None:
                d, v = pred_l.trace(cols, valids, sub_aux(aux, pred_l))
                row_valid = row_valid & d
                if v is not None:
                    row_valid = row_valid & v
            packed = jnp.zeros(n, jnp.int64)
            shift = 0
            for low, off, b in zip(key_l, offsets, bits):
                kd, kv = low.trace(cols, valids, sub_aux(aux, low))
                k = kd.astype(jnp.int64) - jnp.int64(off) + 1
                if kv is not None:
                    k = jnp.where(kv, k, 0)   # NULL key -> code 0
                packed = packed | (k << shift)
                shift += b
            values = {}
            for slot, (cat, arg) in slot_defs.items():
                if arg is None:            # count(*)
                    values[slot] = ("sum", row_valid.astype(jnp.int64))
                    continue
                ad, av = arg.trace(cols, valids, sub_aux(aux, arg))
                avail = row_valid if av is None else (row_valid & av)
                if cat == "sum":
                    # f32 inputs sum in f32 (reference accumulator width)
                    acc_np = (jnp.float32 if ad.dtype == jnp.float32
                              else jnp.float64) if arg.out_dtype.is_float \
                        else jnp.int64
                    values[slot] = ("sum", jnp.where(avail, ad.astype(acc_np), 0))
                elif cat == "cnt":
                    values[slot] = ("sum", avail.astype(jnp.int64))
                elif cat == "distinct":
                    # exact int64 representation; NULL -> INT64_MIN marker
                    if jnp.issubdtype(ad.dtype, jnp.floating):
                        f = ad.astype(jnp.float64)
                        f = jnp.where(f == 0.0, 0.0, f)   # -0.0 == 0.0; and
                        # -0.0's bits are the INT64_MIN null marker
                        rep = _jax.lax.bitcast_convert_type(f, jnp.int64)
                    else:
                        rep = ad.astype(jnp.int64)
                    nullrep = jnp.int64(np.iinfo(np.int64).min)
                    values[slot] = ("distinct",
                                    jnp.where(avail, rep, nullrep))
                elif cat == "nancnt":
                    # arrow total order: NaN sorts greatest. min/max over
                    # float lanes mask NaN out and this companion slot lets
                    # emit restore the NaN results (all-NaN min, any-NaN max)
                    values[slot] = ("sum",
                                    (avail & jnp.isnan(ad)).astype(jnp.int64))
                elif cat == "min":
                    if ad.dtype == jnp.bool_:
                        ad = ad.astype(jnp.int32)   # no iinfo for bool lanes
                    if jnp.issubdtype(ad.dtype, jnp.floating):
                        ident = jnp.asarray(jnp.inf, ad.dtype)
                        avail = avail & ~jnp.isnan(ad)
                    else:
                        ident = jnp.asarray(jnp.iinfo(ad.dtype).max, ad.dtype)
                    values[slot] = ("min", jnp.where(avail, ad, ident))
                else:  # max
                    if ad.dtype == jnp.bool_:
                        ad = ad.astype(jnp.int32)
                    if jnp.issubdtype(ad.dtype, jnp.floating):
                        ident = jnp.asarray(-jnp.inf, ad.dtype)
                        avail = avail & ~jnp.isnan(ad)
                    else:
                        ident = jnp.asarray(jnp.iinfo(ad.dtype).min, ad.dtype)
                    values[slot] = ("max", jnp.where(avail, ad, ident))
            return packed, row_valid, {k2: v2[1] for k2, v2 in
                                       values.items()}

        kinds = {slot: {"cnt": "sum", "nancnt": "sum"}.get(cat, cat)
                 for slot, (cat, _a) in slot_defs.items()}

        def step(full_cols, present_valids, num_rows, start, aux):
            packed, row_valid, arrs = prepare(
                full_cols, present_valids, num_rows, start, aux)
            values = {k2: (kinds[k2], arrs[k2]) for k2 in arrs}
            return device_group_aggregate(packed, row_valid, values,
                                          max_groups,
                                          assume_dense_keys=dense_keys,
                                          assume_sorted_keys=sorted_keys)
        step.prepare = prepare
        step.kinds = kinds
        return step

    def _execute_rowspace_plain(self, jax, jnp, m, batch, pred_l, key_l,
                                slot_defs, slot_map, plan, cache_key,
                                unique_lowereds, aux_offset, sorted_keys):
        """Row-space two-program aggregation for the PLAIN (joinless)
        device aggregate: program A = filter + key packing + value slots
        + (argsort when unsorted, value lanes reordered by one 2D int32
        row-gather) + O(n) scans; one scalar n_groups fetch; program B =
        exact-count emit. Same machinery as the chain exec's
        _execute_rowspace (device_join_chain.py); TPC-H Q15's revenue
        view aggregate: ~610ms -> ~130ms."""
        from ...device.groupby import (reorder_rows_packed,
                                       rowspace_group_emit,
                                       rowspace_group_state)
        cap = _bucket_capacity(batch.capacity)
        cols = tuple(c.data_device_padded(cap) for c in batch.columns)
        present_valids = tuple(c.validity_device_padded(cap)
                               for c in batch.columns if c.has_nulls)
        null_layout = tuple(c.has_nulls for c in batch.columns)
        if not cols:
            cols = ()
            null_layout = ()
        aux = tuple(self._collect_aux(unique_lowereds, batch))
        st = self._make_step(pred_l, key_l, slot_defs, plan, jnp,
                             0, aux_offset, False, null_layout, cap,
                             False)
        kinds = {}
        for slot, (cat, _arg) in slot_defs.items():
            kinds[slot] = "distinct" if cat == "distinct" else "sum"
        narrow = sum(plan.bits) <= 31

        def prog_a(full_cols, pv, num_rows, start, aux_):
            packed, row_valid, arrs = st.prepare(full_cols, pv, num_rows,
                                                 start, aux_)
            vals2 = {s: (kinds[s], a) for s, a in arrs.items()}
            if narrow:
                packed = packed.astype(jnp.int32)
            if not sorted_keys:
                sent = jnp.asarray(
                    np.iinfo(np.int32 if narrow else np.int64).max,
                    packed.dtype)
                kmask = jnp.where(row_valid, packed, sent)
                order = jnp.argsort(kmask)
                names_r = sorted(vals2)
                reordered = reorder_rows_packed(
                    order, [kmask] + [vals2[nm][1] for nm in names_r])
                packed = reordered[0]
                row_valid = packed != sent
                vals2 = {nm: (vals2[nm][0], arr)
                         for nm, arr in zip(names_r, reordered[1:])}
            return rowspace_group_state(packed, row_valid, vals2)

        step_key = ("rowspace_plain", cache_key, null_layout, cap)
        jit_a = _STEP_CACHE.get(step_key)
        if jit_a is None:
            jit_a = jax.jit(prog_a)
            if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                _STEP_CACHE.clear()
            _STEP_CACHE[step_key] = jit_a
        chunk_bytes = sum(int(c.dtype.itemsize) for c in cols) + \
            sum(int(v.dtype.itemsize) for v in present_valids)
        m.record_bytes(batch.num_rows * chunk_bytes)
        with m.elapsed_compute, m.device_compute:
            lanes, ng_dev = jit_a(cols, present_valids,
                                  np.int64(batch.num_rows), np.int64(0),
                                  aux)
            ng = int(ng_dev)    # one blocking fetch (absorbs A)
        out_cap = min(_emit_capacity(max(ng, 1)), cap)

        # LARGE outputs stay DEVICE-RESIDENT: the usual consumer of a
        # 500k-group table is another device operator (TPC-H Q20: the
        # (partkey,suppkey) revenue table feeds a semi-join build, which
        # also stages device-side), so it never crosses to the host.
        if out_cap >= (1 << 18) and ng > 0 and \
                self.post_filter is None and \
                self._emit_device_ok(plan):
            out = self._emit_device_resident(
                jax, jnp, m, lanes, kinds, out_cap, ng, plan, slot_map,
                cache_key)
            if out is not None:
                return out

        emit_key = ("rowspace_plain_emit", cache_key, out_cap,
                    tuple(sorted(lanes)), tuple(sorted(kinds.items())))
        jit_b = _STEP_CACHE.get(emit_key)
        if jit_b is None:
            def emit(lanes_):
                gk, gv, aggs, _n2 = rowspace_group_emit(lanes_, kinds,
                                                        out_cap)
                return gk, gv, aggs
            jit_b = jax.jit(emit)
            if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                _STEP_CACHE.clear()
            _STEP_CACHE[emit_key] = jit_b
        with m.elapsed_compute, m.device_compute:
            state = jit_b(lanes)
            return self._emit(state, plan, slot_map, m)

    def _emit_device_ok(self, plan) -> bool:
        """Device-resident emit covers int/dict group keys and
        sum(non-float)/count aggregates (the large-group-table shapes);
        everything else takes the host emit."""
        for t in plan.key_types:
            if t.is_boolean or t.is_float:
                return False
        for a in self.aggs:
            if a.name == "count" and not a.distinct:
                continue
            if a.name == "sum" and not a.out_type.is_float:
                continue
            return False
        return True

    def _emit_device_resident(self, jax, jnp, m, lanes, kinds, out_cap,
                              ng, plan, slot_map, cache_key):
        """Materialize the group table as DEVICE-RESIDENT Columns: key
        unpacking (shift/mask/offset) and aggregate finalization run in
        the emit program; the host only receives array handles. Mirrors
        _emit_arrays for the supported subset."""
        from ...device.groupby import rowspace_group_emit
        key_types = plan.key_types
        offsets, bits, dicts = plan.offsets, plan.bits, plan.key_dicts
        aggs_l = self.aggs
        slot_map_l = slot_map

        ek = ("rowspace_dev_emit", cache_key, out_cap,
              tuple(sorted(lanes)), tuple(sorted(kinds.items())))
        fn = _STEP_CACHE.get(ek)
        if fn is None:
            def emit(lanes_):
                gk, _okm, ag, _n2 = rowspace_group_emit(lanes_, kinds,
                                                        out_cap)
                outs = []
                shift = 0
                for i, t in enumerate(key_types):
                    b = bits[i]
                    raw = (gk >> shift) & ((1 << b) - 1)
                    shift += b
                    if t.is_dict_coded:
                        outs.append(jnp.maximum(raw - 1, 0)
                                    .astype(jnp.int32))
                    else:
                        outs.append((raw - 1 + offsets[i]).astype(
                            jnp.dtype(t.device_dtype())))
                    outs.append(raw != 0)     # validity
                for a in aggs_l:
                    slots = slot_map_l[a.display]
                    cnt = ag[slots["c"]]
                    if a.name == "count":
                        outs.append(cnt.astype(jnp.int64))
                        outs.append(jnp.ones(out_cap, bool))
                    else:
                        outs.append(ag[slots["s"]].astype(
                            jnp.dtype(a.out_type.device_dtype())))
                        outs.append(cnt > 0)
                return tuple(outs)
            fn = jax.jit(emit)
            if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                _STEP_CACHE.clear()
            _STEP_CACHE[ek] = fn
        with m.elapsed_compute, m.device_compute:
            arrs = fn(lanes)
        cols: List[Column] = []
        ai = 0
        for i, t in enumerate(key_types):
            data, valid = arrs[ai], arrs[ai + 1]
            ai += 2
            dic = dicts[i] if t.is_dict_coded else None
            cols.append(Column(t, data, valid, dic))
        for a in aggs_l:
            data, valid = arrs[ai], arrs[ai + 1]
            ai += 2
            if a.name == "count":
                cols.append(Column(dt.INT64, data, None))
            else:
                cols.append(Column(a.out_type, data, valid))
        m.record_output(ng)
        return Batch(self._schema, cols, ng)

    def _collect_aux(self, unique_lowereds, batch):
        import jax.numpy as jnp
        out = []
        for low in unique_lowereds:
            for spec in low.aux:
                out.append(np.asarray(spec.fn(batch)))
        return out

    def _merge(self, state, part, jnp, max_groups):
        """Merge two partial group tables in ONE jitted program (cached per
        shape/name signature) instead of ~20 eager per-op dispatches of
        device_group_aggregate per chunk."""
        import jax
        sk, sv, sa = state
        pk, pv, pa = part
        names = tuple(sorted(sa))
        key = (max_groups, sk.shape[0], pk.shape[0], names,
               tuple(str(sa[n].dtype) for n in names),
               tuple(str(pa[n].dtype) for n in names))
        fn = _MERGE_CACHE.get(key)
        if fn is None:
            from ...device.groupby import device_group_aggregate

            def run(sk, sv, pk, pv, s_vals, p_vals):
                keys = jnp.concatenate([sk, pk])
                valid = jnp.concatenate([sv, pv])
                values = {}
                for i, name in enumerate(names):
                    kind = "min" if name.endswith("#n") else \
                           "max" if name.endswith("#x") else "sum"
                    values[name] = (kind, jnp.concatenate(
                        [s_vals[i], p_vals[i]]))
                gk, gv, aggs, ng = device_group_aggregate(
                    keys, valid, values, max_groups,
                    assume_dense_keys=max_groups <= 64)
                if max_groups > 64:
                    gk = jnp.where(ng > max_groups,
                                   jnp.full_like(gk, -2), gk)
                return gk, gv, tuple(aggs[n] for n in names)

            fn = jax.jit(run)
            if len(_MERGE_CACHE) >= _STEP_CACHE_MAX:
                _MERGE_CACHE.clear()
            _MERGE_CACHE[key] = fn
        gk, gv, out = fn(sk, sv, pk, pv,
                         tuple(sa[n] for n in names),
                         tuple(pa[n] for n in names))
        return gk, gv, {n: out[i] for i, n in enumerate(names)}

    # ------------------------------------------------------------------
    @staticmethod
    def _fetch_state(state):
        """Device group table -> host in ONE transfer: a jitted packer
        concatenates every integer array into a single int64 lane (float
        aggregates into a second), one bulk transfer, host-side split."""
        import jax
        import jax.numpy as jnp
        keys, valid, aggs = state
        names = sorted(aggs)
        int_names = [n for n in names
                     if np.issubdtype(np.dtype(aggs[n].dtype), np.integer)]
        flt_names = [n for n in names if n not in int_names]

        # float aggregates keep a second lane (merging them by a
        # float64 -> int64 bitcast is ROADMAP C2); all-integer states (the
        # TPC-H decimal common case) ride a single transfer.
        # Large tables compact on-device before the transfer: one scalar
        # fetch (the live count) buys a bucketed valid-prefix transfer
        # instead of the whole 4M-slot table.
        out_cap = None
        g_full = int(keys.shape[0])
        if g_full >= (1 << 18):
            cfn = _STEP_CACHE.get("emit_count")
            if cfn is None:
                cfn = jax.jit(lambda v: jnp.sum(v.astype(jnp.int32)))
                _STEP_CACHE["emit_count"] = cfn
            ng = int(cfn(valid))
            cap = _bucket_capacity(max(ng, 1))
            if cap < g_full:
                out_cap = cap

        if out_cap is None:
            def pack(keys_, valid_, int_arrs, flt_arrs):
                ints = jnp.concatenate(
                    [keys_.astype(jnp.int64), valid_.astype(jnp.int64)]
                    + [a.astype(jnp.int64) for a in int_arrs])
                flts = jnp.concatenate(
                    [a.astype(jnp.float64) for a in flt_arrs]) \
                    if flt_arrs else jnp.zeros(0, jnp.float64)
                return ints, flts
            key = ("emit_pack", len(int_names), len(flt_names))
        else:
            cap_ = out_cap

            def pack(keys_, valid_, int_arrs, flt_arrs):
                # valid groups first (group order is arbitrary), then
                # slice every lane to the bucketed live count
                perm = jnp.argsort(~valid_, stable=True)[:cap_]
                keys_ = keys_[perm]
                valid_ = valid_[perm]
                ints = jnp.concatenate(
                    [keys_.astype(jnp.int64), valid_.astype(jnp.int64)]
                    + [a[perm].astype(jnp.int64) for a in int_arrs])
                flts = jnp.concatenate(
                    [a[perm].astype(jnp.float64) for a in flt_arrs]) \
                    if flt_arrs else jnp.zeros(0, jnp.float64)
                return ints, flts
            key = ("emit_pack_compact", g_full, out_cap,
                   len(int_names), len(flt_names))
        packer = _STEP_CACHE.get(key)
        if packer is None:
            packer = jax.jit(pack)
            _STEP_CACHE[key] = packer
        ints_d, flts_d = packer(keys, valid,
                                tuple(aggs[n] for n in int_names),
                                tuple(aggs[n] for n in flt_names))
        ints = np.asarray(ints_d)
        flts = np.asarray(flts_d) if flt_names else None
        g = len(ints) // (2 + len(int_names))
        keys_np = ints[:g]
        valid_np = ints[g:2 * g] != 0
        aggs_np = {}
        for i, n in enumerate(int_names):
            aggs_np[n] = ints[(2 + i) * g:(3 + i) * g]
        for i, n in enumerate(flt_names):
            aggs_np[n] = flts[i * g:(i + 1) * g]
        return keys_np, valid_np, aggs_np

    def _topk_lane(self, slot_map):
        """Resolve the fused ORDER BY target to an int64 device lane.
        Returns (slot_name, asc, k) or None when the order key has no
        exact integer lane (float sums, avg)."""
        idx, asc, k = self.topk
        if idx >= len(self.aggs):
            return None
        a = self.aggs[idx]
        slots = slot_map.get(a.display)
        if not slots:
            return None
        if "d" in slots:
            lane = slots["d"]
        elif a.name == "count":
            lane = slots["c"]
        elif a.name == "sum" and not a.out_type.is_float:
            lane = slots.get("s")
        elif a.name == "min" and not a.out_type.is_float:
            lane = slots.get("n")
        elif a.name == "max" and not a.out_type.is_float:
            lane = slots.get("x")
        else:
            return None
        if lane is None:
            return None
        return (lane, asc, int(k))

    def _emit_topk(self, keys, valid, aggs, lane_pick, plan, slot_map,
                   m) -> Optional[Batch]:
        """Device-side ORDER BY <agg> LIMIT k: one lax.top_k over the
        order lane, gather every lane at the winning slots, transfer only
        k rows (the group table itself never leaves the device)."""
        import jax
        import jax.numpy as jnp
        lane, asc, k = lane_pick
        names = sorted(aggs)
        int_names = [n for n in names
                     if np.issubdtype(np.dtype(aggs[n].dtype), np.integer)]
        flt_names = [n for n in names if n not in int_names]
        kk = int(min(k, int(keys.shape[0])))
        ck = ("emit_topk", kk, tuple(int_names), tuple(flt_names), asc,
              int(keys.shape[0]), lane)
        packer = _STEP_CACHE.get(ck)
        if packer is None:
            def pack(keys_, valid_, lane_arr, int_arrs, flt_arrs):
                minw = jnp.int64(np.iinfo(np.int64).min)
                w = lane_arr.astype(jnp.int64)
                w = jnp.where(valid_, -w if asc else w, minw)
                _, idx = jax.lax.top_k(w, kk)
                ints = jnp.concatenate(
                    [keys_[idx].astype(jnp.int64),
                     valid_[idx].astype(jnp.int64)]
                    + [a[idx].astype(jnp.int64) for a in int_arrs])
                flts = jnp.concatenate(
                    [a[idx].astype(jnp.float64) for a in flt_arrs]) \
                    if flt_arrs else jnp.zeros(0, jnp.float64)
                return ints, flts
            packer = jax.jit(pack)
            if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                _STEP_CACHE.clear()
            _STEP_CACHE[ck] = packer
        ints_d, flts_d = packer(keys, valid, aggs[lane],
                                tuple(aggs[n] for n in int_names),
                                tuple(aggs[n] for n in flt_names))
        ints = np.asarray(ints_d)
        flts = np.asarray(flts_d) if flt_names else None
        g = kk
        keys_np = ints[:g]
        valid_np = ints[g:2 * g] != 0
        if (keys_np == -2).any():
            raise _GroupTableOverflow()
        if (keys_np == -3).any():
            raise DeviceCapacityRetry()
        aggs_np = {}
        for i, n2 in enumerate(int_names):
            aggs_np[n2] = ints[(2 + i) * g:(3 + i) * g]
        for i, n2 in enumerate(flt_names):
            aggs_np[n2] = flts[i * g:(i + 1) * g]
        return self._emit_arrays(keys_np, valid_np, aggs_np, plan,
                                 slot_map, m)

    def _execute_big(self, batches, prepare_factory, chunk,
                     unique_lowereds, lane_pick, plan, slot_map,
                     m) -> Optional[Batch]:
        """Unbounded-cardinality route for fused top-k: stage every chunk's
        packed keys + pre-aggregation value arrays on device, reduce once
        with device_group_aggregate_big (group results at run-end slots of
        one global sort), then top-k emit. No fixed group table, no
        host-side factorize — the only host transfer is the k rows."""
        import jax.numpy as jnp
        from ...device.groupby import device_group_aggregate_big
        import jax
        keys_parts, valid_parts = [], []
        arr_parts: Dict[str, list] = {}
        kinds = None
        for b in batches:
            cap = _bucket_capacity(b.capacity)
            cols = tuple(c.data_device_padded(cap) for c in b.columns)
            present_valids = tuple(c.validity_device_padded(cap)
                                   for c in b.columns if c.has_nulls)
            null_layout = tuple(c.has_nulls for c in b.columns)
            if not cols:
                cols = ()
                null_layout = ()
            aux = self._collect_aux(unique_lowereds, b)
            chunk_eff = min(chunk, max(cap, 1))
            f = prepare_factory(null_layout, chunk_eff)
            kinds = f.kinds
            chunk_bytes = sum(int(c.dtype.itemsize) for c in cols) + \
                sum(int(v.dtype.itemsize) for v in present_valids)
            for start in range(0, max(b.num_rows, 1), chunk_eff):
                rows_here = min(b.num_rows - start, chunk_eff)
                m.record_bytes(max(rows_here, 0) * chunk_bytes)
                with m.elapsed_compute, m.device_compute:
                    pk, rv, arrs = f(cols, present_valids,
                                     np.int64(max(rows_here, 0)),
                                     np.int64(start), tuple(aux))
                    keys_parts.append(pk)
                    valid_parts.append(rv)
                    for slot, arr in arrs.items():
                        arr_parts.setdefault(slot, []).append(arr)
        if not keys_parts:
            return self._emit(None, plan, slot_map, m)
        nshape = sum(int(p.shape[0]) for p in keys_parts)
        ck = ("big_reduce", nshape, tuple(sorted(kinds.items())))
        reducer = _STEP_CACHE.get(ck)
        if reducer is None:
            def reduce_fn(kp, vp, ap):
                keys_all = jnp.concatenate(kp)
                valid_all = jnp.concatenate(vp)
                values = {slot: (kinds[slot], jnp.concatenate(parts))
                          for slot, parts in ap.items()}
                return device_group_aggregate_big(keys_all, valid_all,
                                                  values)
            reducer = jax.jit(reduce_fn)
            if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                _STEP_CACHE.clear()
            _STEP_CACHE[ck] = reducer
        with m.elapsed_compute, m.device_compute:
            gk, is_end, out_arrs = reducer(
                tuple(keys_parts), tuple(valid_parts),
                {slot: tuple(ps) for slot, ps in arr_parts.items()})
            if lane_pick is not None:
                return self._emit_topk(gk, is_end, out_arrs, lane_pick,
                                       plan, slot_map, m)
            # full-emit offload (SURVEY §5.4 HBM->host for aggregation
            # state): the group table overflowed its fixed size, so the
            # unbounded run-end layout compacts on device to the live
            # group count and the host holds the final table in DRAM —
            # no fixed-capacity retry, no host re-aggregation.
            cfn = _STEP_CACHE.get("emit_count")
            if cfn is None:
                import jax.numpy as _j
                import jax as _jx
                cfn = _jx.jit(lambda v: _j.sum(v.astype(_j.int32)))
                _STEP_CACHE["emit_count"] = cfn
            ng = int(cfn(is_end))
            out_cap = min(_bucket_capacity(max(ng, 1)), int(gk.shape[0]))
            names = tuple(sorted(out_arrs))
            ck2 = ("big_compact", int(gk.shape[0]), out_cap, names,
                   tuple(str(out_arrs[s].dtype) for s in names))
            comp = _STEP_CACHE.get(ck2)
            if comp is None:
                import jax as _jx

                def compact(gk_, is_end_, arrs):
                    perm = jnp.argsort(~is_end_, stable=True)[:out_cap]
                    return (gk_[perm], is_end_[perm],
                            tuple(a[perm] for a in arrs))
                comp = _jx.jit(compact)
                if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                    _STEP_CACHE.clear()
                _STEP_CACHE[ck2] = comp
            keys_c, valid_c, arrs_c = comp(
                gk, is_end, tuple(out_arrs[s] for s in names))
            state = (keys_c, valid_c,
                     {s: arrs_c[i] for i, s in enumerate(names)})
            return self._emit(state, plan, slot_map, m)

    def _apply_post_filter(self, state, plan: _PackPlan, slot_map):
        """Evaluate the fused HAVING predicate over the group table ON
        DEVICE: reconstruct each referenced output column from its lanes
        (the jnp twin of _emit_arrays) and AND the mask into group_valid.
        Poisoned tables (-2/-3 key sentinels) pass through untouched so
        overflow detection still fires after the fetch."""
        import jax
        import jax.numpy as jnp
        from ...device.lower import lower_expr
        keys, valid, aggs = state
        names = tuple(sorted(aggs))
        ck = ("post_filter", str(self.post_filter), int(keys.shape[0]),
              names, tuple(str(aggs[n].dtype) for n in names),
              tuple(plan.bits), tuple(plan.offsets))
        fn = _STEP_CACHE.get(ck)
        if fn is None:
            pred_l = lower_expr(self.post_filter)
            if pred_l.aux:
                raise DeviceLoweringUnsupported(
                    "post-filter needs host aux inputs")
            n_keys = len(self.group_exprs)

            def run(keys_, valid_, agg_arrs):
                a_by = {n: agg_arrs[i] for i, n in enumerate(names)}
                cols, valids = [], []
                shift = 0
                for i, t in enumerate(plan.key_types):
                    b = plan.bits[i]
                    raw = (keys_ >> shift) & ((1 << b) - 1)
                    shift += b
                    code = raw - 1 + plan.offsets[i]
                    if t.is_boolean:
                        cols.append(code != 0)
                    else:
                        cols.append(code.astype(
                            jnp.dtype(t.device_dtype().name)))
                    valids.append(raw != 0)
                for a in self.aggs:
                    slots = slot_map[a.display]
                    if "d" in slots:
                        cols.append(a_by[slots["d"]].astype(jnp.int64))
                        valids.append(jnp.ones_like(valid_))
                        continue
                    cnt = a_by[slots["c"]]
                    has = cnt > 0
                    if a.name == "count":
                        cols.append(cnt.astype(jnp.int64))
                        valids.append(jnp.ones_like(valid_))
                    elif a.name == "sum":
                        s = a_by[slots["s"]]
                        cols.append(s.astype(
                            jnp.dtype(a.out_type.device_dtype().name)))
                        valids.append(has)
                    elif a.name in ("avg", "mean"):
                        s = a_by[slots["s"]]
                        safe = jnp.where(has, cnt, 1)
                        cols.append(s.astype(jnp.float64) / safe)
                        valids.append(has)
                    elif a.name == "min":
                        x = a_by[slots["n"]].astype(
                            jnp.dtype(a.out_type.device_dtype().name))
                        if "nn" in slots:
                            nn = a_by[slots["nn"]]
                            x = jnp.where(has & (nn == cnt), jnp.nan, x)
                        cols.append(x)
                        valids.append(has)
                    else:
                        x = a_by[slots["x"]].astype(
                            jnp.dtype(a.out_type.device_dtype().name))
                        if "nn" in slots:
                            nn = a_by[slots["nn"]]
                            x = jnp.where(has & (nn > 0), jnp.nan, x)
                        cols.append(x)
                        valids.append(has)
                d, v = pred_l.trace(tuple(cols), tuple(valids), ())
                mask = d if v is None else (d & v)
                # keep poisoned tables intact for overflow detection
                poisoned = keys_[0] <= jnp.int64(-2)
                return jnp.where(poisoned, valid_, valid_ & mask)

            fn = jax.jit(run)
            if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                _STEP_CACHE.clear()
            _STEP_CACHE[ck] = fn
        new_valid = fn(keys, valid, tuple(aggs[n] for n in names))
        return keys, new_valid, aggs

    def _emit(self, state, plan: _PackPlan, slot_map, m,
              key_finalize=None) -> Optional[Batch]:
        if state is not None and self.post_filter is not None:
            state = self._apply_post_filter(state, plan, slot_map)
        if state is not None:
            keys_np, valid, aggs_np = self._fetch_state(state)
            if keys_np is not None and len(keys_np):
                if (keys_np == -2).any():
                    raise _GroupTableOverflow()
                if (keys_np == -3).any():
                    raise DeviceCapacityRetry()
        else:
            keys_np, valid, aggs_np = None, None, {}
        return self._emit_arrays(keys_np, valid, aggs_np, plan, slot_map, m,
                                 key_finalize=key_finalize)

    def _emit_arrays(self, keys_np, valid, aggs_np, plan: _PackPlan,
                     slot_map, m, key_finalize=None) -> Optional[Batch]:
        """key_finalize(sel, key_cols) -> key_cols: hook for emitters whose
        packed word carries a REDUCED key set (functional-dependence
        reduction in device_join_chain) — it reconstructs the dropped key
        columns and returns the full schema-ordered list."""
        n_keys = len(self.group_exprs)
        if keys_np is not None:
            sel = np.nonzero(valid)[0]
        else:
            sel = np.zeros(0, np.int64)
            keys_np = np.zeros(0, np.int64)
            aggs_np = {}

        if n_keys == 0 and len(sel) == 0:
            # scalar aggregate over empty input: one row of count=0 / NULLs
            keys_np = np.zeros(1, np.int64)
            sel = np.array([0])
            aggs_np = {}
            for slots in slot_map.values():
                for slot in slots.values():
                    aggs_np[slot] = np.zeros(
                        1, np.int64 if slot.endswith(("#c", "#d"))
                        else np.float64)
        elif n_keys > 0 and len(sel) == 0:
            return None

        cols: List[Column] = []
        keys_sel = keys_np[sel]
        shift = 0
        for i, t in enumerate(plan.key_types):
            b = plan.bits[i]
            raw = (keys_sel >> shift) & ((1 << b) - 1)
            shift += b
            is_null = raw == 0
            validity = None if not is_null.any() else ~is_null
            code = raw - 1 + plan.offsets[i]
            if t.is_dict_coded:
                cols.append(Column(t, np.maximum(raw - 1, 0).astype(np.int32),
                                   validity, plan.key_dicts[i]))
            elif t.is_boolean:
                cols.append(Column(t, (code != 0), validity))
            else:
                cols.append(Column(t, code.astype(t.device_dtype()), validity))

        if key_finalize is not None:
            cols = key_finalize(sel, cols, aggs_np)

        for a in self.aggs:
            slots = slot_map[a.display]
            if "d" in slots:               # count(DISTINCT x)
                d = aggs_np[slots["d"]][sel]
                cols.append(Column(dt.INT64, d.astype(np.int64)))
                continue
            cnt = aggs_np[slots["c"]][sel]
            has = cnt > 0
            v = None if has.all() else has
            if a.name == "count":
                cols.append(Column(dt.INT64, cnt.astype(np.int64)))
            elif a.name == "sum":
                s = aggs_np[slots["s"]][sel]
                cols.append(Column(a.out_type,
                                   s.astype(a.out_type.device_dtype()), v))
            elif a.name in ("avg", "mean"):
                s = aggs_np[slots["s"]][sel]
                safe = np.where(has, cnt, 1)
                if a.out_type.is_decimal:
                    at = a.args[0].out_type
                    in_scale = at.scale if at.is_decimal else 0
                    shift10 = 10 ** (a.out_type.scale - in_scale)
                    num = s.astype(object) * int(shift10)
                    den = safe.astype(object)
                    # reference divides in i128: truncation toward zero
                    # (DecimalAverager::avg, aggregate/utils.rs:213)
                    q = np.sign(num) * (np.abs(num) // den)
                    cols.append(Column(a.out_type, q.astype(np.int64), v))
                else:
                    cols.append(Column(dt.FLOAT64, s / safe, v))
            elif a.name == "min":
                x = aggs_np[slots["n"]][sel].astype(a.out_type.device_dtype())
                if "nn" in slots:
                    nn = aggs_np[slots["nn"]][sel]
                    x = np.where(has & (nn == cnt), np.nan, x)  # all-NaN group
                cols.append(Column(a.out_type, x, v))
            else:  # max
                x = aggs_np[slots["x"]][sel].astype(a.out_type.device_dtype())
                if "nn" in slots:
                    nn = aggs_np[slots["nn"]][sel]
                    x = np.where(has & (nn > 0), np.nan, x)     # NaN is greatest
                cols.append(Column(a.out_type, x, v))
        return Batch(self._schema, cols, len(sel))

    def display_line(self):
        gb = ", ".join(n for _, n in self.group_exprs)
        ag = ", ".join(a.display for a in self.aggs)
        p = f", predicate={self.predicate}" if self.predicate is not None else ""
        t = ""
        if self.topk is not None:
            i, asc, k = self.topk
            t = (f", topk=[{self.aggs[i].display} "
                 f"{'ASC' if asc else 'DESC'} LIMIT {k}]")
        pf = f", having={self.post_filter}" \
            if self.post_filter is not None else ""
        return f"DeviceGroupAggregateExec: gby=[{gb}], aggr=[{ag}]{p}{t}{pf}"
