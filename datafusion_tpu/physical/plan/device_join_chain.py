"""DeviceJoinChainAggregateExec — a multi-way join pipeline fused with
group aggregation into one jitted XLA program per probe chunk.

Reference parity: a stack of CollectLeft HashJoinExecs feeding
GroupedHashAggregateStream (`joins/hash_join.rs:1368` probe ->
`aggregates/row_hash.rs:524`). The device re-design executes the *fact
spine* (the largest relation) as the probe stream and every other
relation as a host-materialized **unique-key build table**: each probe
chunk runs `filter -> K x (searchsorted + gather) -> residuals -> group
aggregate` as a single device program, so joined intermediates never
materialize anywhere.

Why fanout-1 chains: TPC-H-style star/snowflake joins probe from the
fact table towards primary keys, so every join step matches at most one
build row and shapes stay static ([chunk] throughout — no pair
expansion, no scatter). Build-key uniqueness is verified on the host
when the build side materializes; duplicates fall back to the host plan
(the general single-join fanout path remains `device_join_agg.py`).

The chain is *re-derived from the equi-predicate graph*, not copied from
the planner's tree: the fusion rule (physical_optimizer._try_fuse_join_chain)
flattens the join tree into {relations, equi predicates, residual
filters, semi/anti constraints} and re-anchors on the largest relation.
This also repairs pathological join orders (e.g. TPC-H Q5's
supplier x customer many-to-many build) because every dimension joins
the spine through its key, and cross-dimension equalities become device
residual masks.

SEMI/ANTI steps (`join_type` LEFTSEMI/LEFTANTI) are membership tests
against a host-collected key set — they contribute a mask, no payload
(reference: hash_join.rs LeftSemi/LeftAnti).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ...common.batch import Batch, round_capacity
from ...common.column import Column
from ...runtime import BaselineMetrics, TaskContext
from ..expressions import ColumnExpr, PhysicalExpr
from .base import ExecutionPlan, Partitioning
from .device_aggregate import (DeviceGroupAggregateExec,
                               DeviceLoweringUnsupported, _STEP_CACHE,
                               _STEP_CACHE_MAX, _overflow_poison)

_KEY_SENTINEL = np.int64(np.iinfo(np.int64).max)

# key spaces at or below this use the unrolled dense-slot aggregate (one
# masked whole-array reduction per slot); larger spaces go ROW-SPACE
# (see _execute_rowspace) rather than the fixed [max_groups] table
_DENSE_ROWSPACE_MAX = 64

# Unfiltered direct-address LUTs, cached ACROSS QUERIES per build table's
# key columns: lut[packed_key - base] = build row (-1 = absent). Built and
# uploaded once per registered table; per-query build predicates fold in
# as a device-side mask. Replaces the per-query sorted-key upload and
# the per-hop sort-based searchsorted with ONE gather. Keys are
# Column._uid tuples — monotonic, never recycled — so a replaced/updated
# registered table can never alias a stale entry. Eviction is LRU one
# entry at a time under a byte budget.
# (Reference contrast: hash_join.rs rebuilds its chained hashmap per
# query.)
from collections import OrderedDict

_LUT_CACHE: "OrderedDict" = OrderedDict()
_LUT_CACHE_MAX = 16
_LUT_CACHE_MAX_BYTES = 256 << 20
_LUT_CACHE_BYTES = [0]

# Staged SEMI/ANTI membership LUTs cached ACROSS QUERIES: the staged
# arrays are a pure function of (member table version, key cols, build
# predicate text), so re-running the 6M-row lut_prog on every execution
# (Q21 has two such member scans) is pure waste. Keys use
# Column._uid tuples (monotonic, never recycled) so table updates can
# never alias a stale entry. Values hold DEVICE arrays — budgeted in
# HBM bytes, LRU-evicted one entry at a time.
_SEMI_LUT_CACHE: "OrderedDict" = OrderedDict()
_SEMI_LUT_CACHE_MAX = 12
_SEMI_LUT_CACHE_MAX_BYTES = 1 << 30
_SEMI_LUT_CACHE_BYTES = [0]

# Packed payload matrices cached ACROSS QUERIES per build table's payload
# columns: [bcap, L] int32 lane matrices (int64 split hi/lo, float32
# bitcast, validity as 0/1 lanes) so the probe step gathers ALL of a
# build's payload columns with ONE lane-vectorized 2D row-gather.
# Whether the H100 needs the int32 lane layout is ROADMAP C2. Keyed by
# Column._uid tuples (monotonic, never recycled).
# The byte budgets of these four caches are to be sized from the card's
# memory (ROADMAP B2).
_PMAT_CACHE: "OrderedDict" = OrderedDict()
_PMAT_CACHE_MAX = 24
_PMAT_CACHE_MAX_BYTES = 512 << 20
_PMAT_CACHE_BYTES = [0]

# Composed payload matrices (snowflake hops folded into their parent
# build's lanes at staging time) cached ACROSS QUERIES: keyed by the
# parent pmat identity + the ordered identities of every composed hop
# (table column uids + predicate text + probe wiring), so any change to
# a member table or per-query build predicate misses cleanly.
_CMP_CACHE: "OrderedDict" = OrderedDict()
_CMP_CACHE_MAX = 24
_CMP_CACHE_MAX_BYTES = 512 << 20
_CMP_CACHE_BYTES = [0]

# Speculative emit capacities: last observed group-count bucket per
# chain signature. A warm re-run fuses program A + emit + pack into ONE
# program with ONE blocking fetch (two fewer host syncs); if the live
# group count outgrew the speculated capacity the run falls back to the
# exact two-program path and the memo updates.
_OUTCAP_MEMO: dict = {}
_OUTCAP_MEMO_MAX = 512


def device_cache_bytes() -> int:
    """Total HBM bytes pinned by the cross-query device caches (direct
    LUTs, semi-membership LUTs, payload matrices, composed matrices)."""
    return (_LUT_CACHE_BYTES[0] + _SEMI_LUT_CACHE_BYTES[0] +
            _PMAT_CACHE_BYTES[0] + _CMP_CACHE_BYTES[0])


def evict_device_caches(max_bytes: int) -> int:
    """LRU-evict cross-query device cache entries until the total is at
    or below `max_bytes`. Returns the bytes freed."""
    freed = 0
    caches = [
        (_CMP_CACHE, _CMP_CACHE_BYTES, lambda e: int(e.nbytes)),
        (_PMAT_CACHE, _PMAT_CACHE_BYTES,
         lambda e: (0 if isinstance(e[0], tuple) else int(e[0].nbytes)) +
         sum(int(a.nbytes) for a in e[1])),
        (_SEMI_LUT_CACHE, _SEMI_LUT_CACHE_BYTES, _semi_lut_nbytes),
        (_LUT_CACHE, _LUT_CACHE_BYTES, lambda e: 2 * e[2].nbytes),
    ]
    while device_cache_bytes() > max_bytes:
        # evict from the largest cache first
        caches.sort(key=lambda c: -c[1][0])
        cache, nbytes_box, sizer = caches[0]
        if not cache:
            break
        _, old = cache.popitem(last=False)
        n = sizer(old)
        nbytes_box[0] -= n
        freed += n
    return freed


def _account_device_caches(reservation, ctx) -> None:
    """Register the cross-query device caches' HBM footprint against the
    query's MemoryPool (reference: memory_pool/mod.rs consumer
    accounting). Under ResourcesExhausted, LRU-evict cache entries until
    the footprint fits — the caches are an optimization, never a reason
    to fail a query."""
    from ...common.errors import ResourcesExhausted
    total = device_cache_bytes()
    if total <= 0:
        return
    for _ in range(32):
        try:
            reservation.try_grow(total)
            return
        except ResourcesExhausted:
            target = max(total // 2, 0)
            if evict_device_caches(target) <= 0:
                return   # nothing left to evict; run unaccounted
            total = device_cache_bytes()
            if total <= 0:
                return


def _semi_lut_nbytes(entry):
    tot = int(entry[0].nbytes) + int(entry[1].nbytes)
    for c in entry[2]:
        tot += int(c.nbytes)
    return tot


def _unfiltered_lut(bb, col_map, build, jnp):
    """(key_cols, lut_dev, lut_np, offsets, his, bits) for a build whose
    UNFILTERED key columns are unique non-null integers with a bounded
    packed domain; None when ineligible (duplicates, nulls, wide domain)."""
    key_cols = tuple(bb.columns[col_map[k.index]] for k in build.build_keys)
    ck = tuple(c._uid for c in key_cols)
    hit = _LUT_CACHE.get(ck)
    if hit is not None:
        _LUT_CACHE.move_to_end(ck)
        return hit
    n = bb.num_rows
    if n == 0:
        return None
    arrs = []
    for c in key_cols:
        if c.has_nulls or not c.dtype.is_integer:
            return None
        arrs.append(c.data_host()[:n].astype(np.int64))
    offsets, his, bits = [], [], []
    for a in arrs:
        lo, hi = int(a.min()), int(a.max())
        offsets.append(lo)
        his.append(hi)
        bits.append(max(int(np.ceil(np.log2(hi - lo + 2))), 1))
    span_total = 1 << sum(bits)
    if span_total > (1 << 24) or span_total > 16 * n:
        return None
    packed = np.zeros(n, np.int64)
    shift = 0
    for a, lo, w in zip(arrs, offsets, bits):
        packed |= (a - lo) << shift
        shift += w
    s = np.sort(packed)
    if s.shape[0] > 1 and (np.diff(s) == 0).any():
        return None
    lut_np = np.full(span_total, -1, np.int32)
    lut_np[packed] = np.arange(n, dtype=np.int32)
    lut_dev = jnp.asarray(lut_np)
    entry = (key_cols, lut_dev, lut_np,
             tuple(offsets), tuple(his), tuple(bits))
    nbytes = 2 * lut_np.nbytes    # host mirror + device copy
    while _LUT_CACHE and (len(_LUT_CACHE) >= _LUT_CACHE_MAX or
                          _LUT_CACHE_BYTES[0] + nbytes >
                          _LUT_CACHE_MAX_BYTES):
        _, old = _LUT_CACHE.popitem(last=False)
        _LUT_CACHE_BYTES[0] -= 2 * old[2].nbytes
    _LUT_CACHE[ck] = entry
    _LUT_CACHE_BYTES[0] += nbytes
    return entry


class ChainBuild:
    """One join step of the chain.

    probe_keys: exprs over the ACCUMULATED pair space (spine source
    columns first, then payloads of earlier builds in chain order).
    build_keys: ColumnExprs over the build source's OUTPUT schema.
    payload: build-output column indices appended to the pair space
    (INNER only; SEMI/ANTI contribute a mask and no columns).
    """

    __slots__ = ("source", "probe_keys", "build_keys", "payload",
                 "join_type", "sfilter")

    def __init__(self, source: ExecutionPlan,
                 probe_keys: List[PhysicalExpr],
                 build_keys: List[ColumnExpr],
                 payload: List[int], join_type: str = "INNER",
                 sfilter=None):
        self.source = source
        self.probe_keys = probe_keys
        self.build_keys = build_keys
        self.payload = payload
        self.join_type = join_type
        # SEMI/ANTI residual comparison `member_col OP probe_expr`:
        # (Op, member ColumnExpr over the build OUTPUT schema, pair-space
        # expr). Membership then means "any member row with this key
        # satisfying the comparison" — evaluated via per-key min/max LUTs.
        self.sfilter = sfilter


class DeviceJoinChainAggregateExec(DeviceGroupAggregateExec):
    def __init__(self, probe_source: ExecutionPlan,
                 probe_predicate: Optional[PhysicalExpr],
                 builds: List[ChainBuild],
                 predicate: Optional[PhysicalExpr],
                 group_exprs, aggs, schema, fallback: ExecutionPlan,
                 max_groups: int = 1 << 22):
        ExecutionPlan.__init__(self)
        self.source = probe_source
        self.probe_predicate = probe_predicate
        self.builds = builds
        self.predicate = predicate
        self.group_exprs = group_exprs
        self.aggs = aggs
        self._schema = schema
        self.fallback = fallback
        self.max_groups = max_groups

    def children(self):
        return [self.source] + [b.source for b in self.builds]

    def with_children(self, c):
        builds = [ChainBuild(src, b.probe_keys, b.build_keys, b.payload,
                             b.join_type, b.sfilter)
                  for src, b in zip(c[1:], self.builds)]
        return DeviceJoinChainAggregateExec(
            c[0], self.probe_predicate, builds, self.predicate,
            self.group_exprs, self.aggs, self._schema, self.fallback,
            self.max_groups)

    def output_partitioning(self):
        return Partitioning.unknown(1)

    def display_line(self):
        steps = ", ".join(
            f"{b.join_type}[{', '.join(str(k) for k in b.probe_keys)}]"
            + (f" filter=({b.sfilter[1]} {b.sfilter[0].value} "
               f"{b.sfilter[2]})" if b.sfilter is not None else "")
            for b in self.builds)
        gb = ", ".join(n for _, n in self.group_exprs)
        ag = ", ".join(a.display for a in self.aggs)
        return (f"DeviceJoinChainAggregateExec: chain=[{steps}], "
                f"gby=[{gb}], aggr=[{ag}]")

    def _sig(self):
        return (
            "join_chain",
            tuple((tuple(str(k) for k in b.probe_keys),
                   tuple(str(k) for k in b.build_keys),
                   tuple(b.payload), b.join_type,
                   None if b.sfilter is None else
                   (str(b.sfilter[0]), str(b.sfilter[1]),
                    str(b.sfilter[2]))) for b in self.builds),
            str(self.probe_predicate), str(self.predicate),
            tuple((str(e), str(e.out_type)) for e, _ in self.group_exprs),
            tuple((a.display, a.name, getattr(a, "distinct", False),
                   tuple((str(x), str(x.out_type)) for x in a.args))
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

        m = BaselineMetrics(self.metrics, partition)
        from .base import collect_batch, execute_stream

        # ---- lower pair-space expressions --------------------------------
        try:
            ppred_l = lower_expr(self.probe_predicate) \
                if self.probe_predicate is not None else None
            pred_l = lower_expr(self.predicate) \
                if self.predicate is not None else None
            key_l = [lower_expr(e) for e, _ in self.group_exprs]
            slot_defs, slot_map = self._chain_slots(lower_expr)
            probe_key_ls = []
            sfilter_ls = []
            for b in self.builds:
                for pk, bk in zip(b.probe_keys, b.build_keys):
                    if pk.out_type.is_string or bk.out_type.is_string or \
                            pk.out_type.is_float or bk.out_type.is_float:
                        # cross-table string codes / float keys need remap
                        # LUT / total-order encoding — host path for now
                        raise LoweringError("non-integer chain join key")
                probe_key_ls.append([lower_expr(k) for k in b.probe_keys])
                if b.sfilter is not None:
                    op, ocol, pexpr = b.sfilter
                    if not ocol.out_type.is_integer or \
                            pexpr.out_type.is_string:
                        raise LoweringError("semi filter needs int member col")
                    sfilter_ls.append(lower_expr(pexpr))
                else:
                    sfilter_ls.append(None)
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))

        # pair-space aux layout over every lowered expr
        lowereds, seen = [], set()
        for low in ([ppred_l] if ppred_l is not None else []) + \
                ([pred_l] if pred_l is not None else []) + key_l + \
                [arg for _, arg in slot_defs.values() if arg is not None] + \
                [k for ks in probe_key_ls for k in ks] + \
                [s for s in sfilter_ls if s is not None]:
            if id(low) not in seen:
                seen.add(id(low))
                lowereds.append(low)
        aux_offset, off = {}, 0
        for low in lowereds:
            aux_offset[id(low)] = off
            off += len(low.aux)

        staged_builds, host_builds, build_batches, reservation = \
            self._stage_chain_builds(ctx, jax, jnp, m)

        # ---- probe batches + group-key packing plan ----------------------
        probe_batches = [bt for bt in execute_stream(self.source, ctx)
                         if bt.num_rows]
        if len(probe_batches) > 1:
            for (e, _n) in self.group_exprs:
                if isinstance(e, ColumnExpr) and e.out_type.is_string and \
                        e.index < len(self.source.schema()):
                    raise DeviceLoweringUnsupported(
                        "probe-side string group keys need a single batch")
        pair_view = self._chain_pair_view(probe_batches, build_batches)

        # ---- functional-dependence group-key reduction --------------------
        # Payload columns of a unique-key INNER build are constant within
        # any group whose keys determine that build's probe keys, so they
        # can leave the packed word entirely (reference analog: the
        # optimizer's functional-dependence aggregate key analysis). The
        # device groups on the reduced word (Q18: 5 keys -> o_orderkey
        # alone); a representative-row lane lets the emit reconstruct the
        # dropped columns on the host. Also the only way wide/dict-coded
        # dependent keys (c_name, o_totalprice) fit the 62-bit word.
        kept_pos, dropped_pos = self._fd_reduce()
        if len(probe_batches) > 1:
            # reconstruction stitches per-batch columns (and per-batch
            # string dictionaries differ) — keep FD for the common
            # one-big-batch case only
            kept_pos = list(range(len(self.group_exprs)))
            dropped_pos = []
        group_exprs_red = [self.group_exprs[p] for p in kept_pos]
        key_l = [key_l[p] for p in kept_pos]
        fd_active = bool(dropped_pos)
        if fd_active:
            slot_defs = dict(slot_defs)
            slot_defs["__rep#x"] = ("rowid", None)

        plan = self._plan_key_packing([pair_view] if pair_view else [],
                                      key_l, group_exprs=group_exprs_red)
        key_space = 1 << sum(plan.bits)
        max_groups = min(key_space, self.max_groups)
        dense_keys = key_space == max_groups
        has_distinct = any(cat == "distinct" for cat, _ in slot_defs.values())

        # PRE-SORTED group keys (e.g. the TPC-H fact table is ordered by
        # its join key): the device aggregate skips the argsort + value
        # reorder entirely.
        # Conditions: single spine ColumnExpr key over a host-verified
        # non-decreasing no-null column, every slot sum-shaped (min/max/
        # distinct need the sorted reorder), and the hashed table path
        # (the dense path is already sort-free).
        sorted_keys = False
        if not dense_keys and not has_distinct and \
                len(group_exprs_red) == 1:
            e0 = group_exprs_red[0][0]
            if isinstance(e0, ColumnExpr) and \
                    e0.index < len(self.source.schema()) and \
                    probe_batches and \
                    all(cat in ("sum", "cnt", "nancnt", "rowid")
                        for cat, _ in slot_defs.values()):
                sorted_keys = all(
                    pb.columns[e0.index].is_sorted_nondecreasing()
                    for pb in probe_batches)
        if has_distinct:
            dense_keys = False
            if len(probe_batches) > 1 or \
                    (probe_batches and probe_batches[0].num_rows > (1 << 21)):
                raise DeviceLoweringUnsupported(
                    "count DISTINCT needs single-chunk input")

        # exactly the values the traced step CLOSES OVER (build_meta +
        # shapes/dtypes arrive as jit arguments and retrace on change):
        # pnull, key offsets, key highs, key bits, staging flag
        build_sig = tuple(
            (sb[4], sb[5], sb[6], sb[7], sb[8]) for sb in staged_builds)
        cache_key = self._sig() + (bool(dense_keys), bool(sorted_keys),
                                   tuple(plan.offsets),
                                   tuple(plan.bits), max_groups, build_sig,
                                   tuple(kept_pos))

        # fanout-1 chain joins never expand rows, so chunks can be large:
        # one chunk for SF1 lineitem avoids inter-chunk state merges
        chunk = 1 << 23

        # ---- ROW-SPACE two-program path (single batch/chunk) -------------
        # Replaces the fixed [max_groups] group table with O(n) scans +
        # an exact-count emit program: no searchsorted-sort segment-ends,
        # no per-slot gathers at table size,
        # no overflow poison/retry. See device/groupby.py rowspace_*.
        rowspace = (
            (not dense_keys or max_groups > _DENSE_ROWSPACE_MAX) and
            len(probe_batches) == 1 and
            round_capacity(probe_batches[0].capacity) <= chunk and
            all(cat in ("sum", "cnt", "nancnt", "rowid", "distinct")
                for cat, _ in slot_defs.values()))
        if rowspace:
            out = self._execute_rowspace(
                jax, jnp, m, probe_batches, build_batches, staged_builds,
                host_builds, lowereds, aux_offset, cache_key,
                ppred_l, pred_l, key_l, slot_defs, slot_map, probe_key_ls,
                sfilter_ls, plan, sorted_keys, kept_pos, dropped_pos,
                fd_active)
            if out is not None:
                m.record_output(out.num_rows)
            return out

        state = None
        pb_bases = []
        pb_base = 0
        for pb in probe_batches:
            pb_bases.append(pb_base)
            cap = round_capacity(pb.capacity)
            p_cols = tuple(c.data_device_padded(cap) for c in pb.columns)
            p_valids_present = tuple(c.validity_device_padded(cap)
                                     for c in pb.columns if c.has_nulls)
            p_null_layout = tuple(c.has_nulls for c in pb.columns)
            pv = self._chain_pair_view([pb], build_batches)
            aux = []
            for low in lowereds:
                for spec in low.aux:
                    aux.append(np.asarray(spec.fn(pv)))
            chunk_eff = min(chunk, max(cap, 1))
            step_key = cache_key + (p_null_layout, chunk_eff, cap)
            jit_step = self._cached(step_key, lambda: jax.jit(
                self._make_chain_step(
                    ppred_l, pred_l, key_l, slot_defs, probe_key_ls, plan,
                    jnp, max_groups, aux_offset, dense_keys, p_null_layout,
                    chunk_eff, staged_builds, sorted_keys, sfilter_ls)))
            chunk_bytes = sum(int(c.dtype.itemsize) for c in p_cols) + \
                sum(int(v.dtype.itemsize) for v in p_valids_present)
            build_args = tuple((sb[0], sb[1], sb[2], sb[3])
                               for sb in staged_builds)
            for start in range(0, max(pb.num_rows, 1), chunk_eff):
                rows_here = min(pb.num_rows - start, chunk_eff)
                m.record_bytes(max(rows_here, 0) * chunk_bytes)
                with m.elapsed_compute, m.device_compute:
                    part = jit_step(p_cols, p_valids_present, build_args,
                                    np.int64(max(rows_here, 0)),
                                    np.int64(start), np.int64(pb_base),
                                    tuple(aux))
                    if dense_keys:
                        part = part[:3]
                    else:
                        part = (_overflow_poison(max_groups)(
                            part[0], part[3]), part[1], part[2])
                    state = part if state is None else \
                        self._merge(state, part, jnp, max_groups)
            pb_base += pb.num_rows

        with m.elapsed_compute, m.device_compute:
            finalize = None
            if fd_active:
                finalize = self._fd_finalize(kept_pos, dropped_pos,
                                             probe_batches, pb_bases,
                                             build_batches, host_builds,
                                             staged_builds)
            out = self._emit(state, plan, slot_map, m, key_finalize=finalize)
        if out is not None:
            m.record_output(out.num_rows)
        return out

    def _stage_chain_builds(self, ctx, jax, jnp, m):
        """Materialize + stage every build table (shared by the
        aggregate- and row-returning chain execs): direct-address /
        semi-membership LUTs, or host-packed sorted keys."""
        from .base import collect_batch
        # ---- materialize + stage every build table -----------------------
        from ...runtime import MemoryReservation
        reservation = MemoryReservation("DeviceJoinChainAggregateExec[build]",
                                        ctx.memory_pool)
        staged_builds = []   # (skeys_dev, rows_dev, payload_cols, payload_valids,
        #                       payload_null_layout, offsets, his)
        host_builds = []     # (skeys_np, rows_np) — host probe twins for
        #                      emit-time FD key reconstruction
        build_batches = []   # (batch, col_map: build-output idx -> batch idx)
        hop_idents = []      # semantic identity per hop (for _CMP_CACHE keys)
        for b in self.builds:
            # stage through to the STABLE source columns when the build is
            # Filter/Projection over a leaf: the filter evaluates on the
            # host into the build row mask, and payload gathers read the
            # table's own (device-cache-resident) columns — a filtered
            # build otherwise re-transfers fresh arrays on every query.
            from ..physical_optimizer import _unwrap_side
            bb, mask0, col_map, pred_unw = None, None, None, None
            un = _unwrap_side(b.source)
            if un is not None:
                src, pred, exprs = un
                if all(isinstance(e, ColumnExpr) for e in exprs):
                    bb = collect_batch(src, ctx)
                    col_map = [e.index for e in exprs]
                    pred_unw = pred
            if bb is None:
                bb = collect_batch(b.source, ctx)
                col_map = list(range(len(bb.columns)))
            build_batches.append((bb, col_map))
            hop_idents.append((
                tuple(bb.columns[ci]._uid for ci in col_map),
                str(pred_unw), b.join_type, tuple(b.payload),
                tuple(str(k) for k in b.build_keys),
                None if b.sfilter is None else (str(b.sfilter[0]),
                                                str(b.sfilter[1]),
                                                str(b.sfilter[2]))))
            reservation.try_grow(bb.nbytes())

            # semi/anti membership LUT built ON DEVICE over the cached
            # staged source columns (build predicate lowered into the
            # program) — no per-query host argsort, no sorted-key H2D
            # upload. Duplicates are fine: membership
            # needs presence, not a unique row. Reference:
            # hash_join.rs LeftSemi/LeftAnti need any match.
            if b.join_type in ("LEFTSEMI", "LEFTANTI") and not b.payload:
                entry = self._stage_semi_member_lut(
                    b, bb, col_map, pred_unw, jax, jnp, m)
                if entry is not None:
                    staged_builds.append(entry)
                    host_builds.append((None, None))
                    continue
                if b.sfilter is not None:
                    # min/max membership is the only device strategy for
                    # filtered semis; the host paths don't evaluate it
                    raise DeviceLoweringUnsupported(
                        "filtered semi needs the device min/max LUT")

            # DEVICE-resident build batch (a row-returning chain output
            # feeding another chain): stage on device — two scalar
            # fetches instead of the full D2H round trip
            if pred_unw is None and b.sfilter is None and \
                    b.join_type == "INNER":
                entry = self._stage_build_device(b, bb, col_map, jax,
                                                 jnp, m)
                if entry is not None:
                    staged_builds.append(entry)
                    host_builds.append((entry[0], entry[1]))
                    continue

            if pred_unw is not None:
                from .. import kernels as K
                mask0 = np.asarray(K.true_mask(
                    pred_unw.evaluate(bb)))[:bb.num_rows].copy()
            if mask0 is None:
                mask0 = np.ones(bb.num_rows, bool)
            bcap = round_capacity(bb.capacity)
            pmat, f64s, pspec = self._stage_payload_matrix(
                b, bb, col_map, bcap, jax, jnp)

            # ---- direct-address LUT path (cached across queries) ---------
            lut_entry = _unfiltered_lut(bb, col_map, b, jnp)
            if lut_entry is not None:
                _, lut_dev, lut_np, offsets, his, bits = lut_entry
                if bool(mask0.all()):
                    lut_q = lut_dev
                else:
                    # per-query build predicate folds into the LUT as a
                    # device-side mask: ~1 byte/row H2D instead of the
                    # 8-byte sorted keys + 8-byte rows of the old path
                    maskp = np.zeros(bcap, bool)
                    maskp[:len(mask0)] = mask0
                    mk = ("masklut", lut_dev.shape[0], bcap)
                    fn = _STEP_CACHE.get(mk)
                    if fn is None:
                        fn = jax.jit(lambda lut, mask: jnp.where(
                            (lut >= 0) & mask[jnp.clip(
                                lut, 0, mask.shape[0] - 1)],
                            lut, jnp.int32(-1)))
                        if len(_STEP_CACHE) >= _STEP_CACHE_MAX:
                            _STEP_CACHE.clear()
                        _STEP_CACHE[mk] = fn
                    lut_q = fn(lut_dev, jnp.asarray(maskp))
                staged_builds.append((lut_q, jnp.zeros(1, jnp.int64),
                                      pmat, f64s, pspec,
                                      offsets, his, bits, True))
                host_builds.append((None, lut_np))
                continue

            key_arrs, key_valids = [], []
            for k in b.build_keys:
                col = bb.columns[col_map[k.index]]
                key_arrs.append(col.data_host().astype(np.int64))
                key_valids.append(None if not col.has_nulls
                                  else col.validity_host())
            mask = mask0
            for v in key_valids:
                if v is not None:
                    mask = mask & v[:bb.num_rows]
            key_arrs = [a[:bb.num_rows] for a in key_arrs]
            # pack multi-keys into one int64 from BUILD ranges; probe
            # values outside a range can never match
            offsets, his, bits = [], [], []
            nvalid = int(mask.sum())
            for a in key_arrs:
                av = a[mask]
                lo = int(av.min()) if nvalid else 0
                hi = int(av.max()) if nvalid else 0
                offsets.append(lo)
                his.append(hi)
                span = hi - lo + 1
                bits.append(max(int(np.ceil(np.log2(span + 1))), 1))
            if sum(bits) > 62:
                raise DeviceLoweringUnsupported(
                    f"chain join key bits {sum(bits)} > 62")
            packed = np.zeros(nvalid, np.int64)
            shift = 0
            for a, lo, w in zip(key_arrs, offsets, bits):
                packed |= (a[mask] - lo) << shift
                shift += w
            perm = np.argsort(packed, kind="stable")
            skeys = packed[perm]
            rows = np.nonzero(mask)[0][perm].astype(np.int64)
            if len(skeys) > 1 and (np.diff(skeys) == 0).any():
                if b.join_type in ("LEFTSEMI", "LEFTANTI"):
                    # semi/anti steps are membership tests: duplicates
                    # carry no payload, dedupe instead of bailing
                    # (reference: hash_join.rs LeftSemi needs any match)
                    keep = np.concatenate([[True], np.diff(skeys) != 0])
                    skeys = skeys[keep]
                    rows = rows[keep]
                else:
                    raise DeviceLoweringUnsupported(
                        "chain build keys not unique (fanout > 1)")
            kcap = round_capacity(max(len(skeys), 1))
            skeys_p = np.full(kcap, _KEY_SENTINEL, np.int64)
            skeys_p[:len(skeys)] = skeys
            rows_p = np.zeros(kcap, np.int64)
            rows_p[:len(rows)] = rows
            staged_builds.append((jnp.asarray(skeys_p), jnp.asarray(rows_p),
                                  pmat, f64s, pspec,
                                  tuple(offsets), tuple(his), tuple(bits),
                                  False))
            host_builds.append((skeys_p, rows_p))
        staged_builds = self._compose_staged_hops(staged_builds, hop_idents,
                                                  jax, jnp)
        staged_builds = self._fold_lut_pmat(staged_builds, hop_idents,
                                            jax, jnp)
        _account_device_caches(reservation, ctx)
        return staged_builds, host_builds, build_batches, reservation

    def _fold_lut_pmat(self, staged_builds, hop_idents, jax, jnp):
        """Merge a direct-address INNER hop's payload matrix INTO its LUT:
        lutmat[key] = [brow, pmat[max(brow,0)] lanes...], so the per-row
        walk needs ONE lane-vectorized row-gather per hop instead of two
        (probe + payload). Applied after composition (the folded lanes
        include any composed hops). Bounded by a lane budget — the LUT
        span can exceed the build row count by up to 16x."""
        out = list(staged_builds)
        for bi, b in enumerate(self.builds):
            sb = out[bi]
            if sb[8] is not True or b.join_type != "INNER":
                continue
            pmat = sb[2]
            if isinstance(pmat, tuple) or pmat is None:
                continue
            span = int(sb[0].shape[0])
            nl = int(pmat.shape[1])
            if span * (1 + nl) > (1 << 24):
                continue
            # the folded lanes embed composed downstream hops, so the key
            # covers EVERY hop's table/predicate identity + chain wiring
            fk = ("fold", tuple(hop_idents), bi, int(pmat.shape[0]), nl,
                  span, self._sig())
            hit = _CMP_CACHE.get(fk)
            if hit is not None:
                _CMP_CACHE.move_to_end(fk)
                lutmat = hit
            else:
                pk = ("foldprog", span, int(pmat.shape[0]), nl,
                      str(np.dtype(sb[0].dtype)))

                def make_fold():
                    def fold(lut, pm):
                        brow = jnp.maximum(lut, 0)
                        rows = pm[jnp.clip(brow, 0, pm.shape[0] - 1)]
                        return jnp.concatenate(
                            [lut.astype(jnp.int32)[:, None], rows], axis=1)
                    return jax.jit(fold)

                prog = self._cached(pk, make_fold)
                lutmat = prog(sb[0], pmat)
                nbytes = int(lutmat.nbytes)
                while _CMP_CACHE and (
                        len(_CMP_CACHE) >= _CMP_CACHE_MAX or
                        _CMP_CACHE_BYTES[0] + nbytes >
                        _CMP_CACHE_MAX_BYTES):
                    _, old = _CMP_CACHE.popitem(last=False)
                    _CMP_CACHE_BYTES[0] -= int(old.nbytes)
                _CMP_CACHE[fk] = lutmat
                _CMP_CACHE_BYTES[0] += nbytes
            out[bi] = (lutmat, sb[1], (), sb[3], sb[4], sb[5], sb[6],
                       sb[7], "lutmat")
        return out

    @staticmethod
    def _pspec_lanes(pspec):
        """Lane start index of each payload column inside its pmat (value
        lanes, then an optional validity lane per column) + total width."""
        starts = []
        li = 0
        for kind, _dt, has in pspec:
            starts.append(li)
            li += 2 if kind == "i64" else 0 if kind == "f64" else 1
            if has:
                li += 1
        return starts, li

    def _compose_staged_hops(self, staged_builds, hop_idents, jax, jnp):
        """Collapse snowflake hops at STAGING time. When every probe key
        of hop i is a payload column of ONE earlier INNER hop j, hop i's
        probe is a pure function of hop j's build row — so it runs once
        over hop j's |build| rows (e.g. TPC-H orders: 1.5M) instead of
        once per spine row (lineitem: 6M), and its results (found flag,
        payload lanes, min/max membership lanes) ride EXTRA int32 lanes
        of hop j's payload matrix. The per-row chain then resolves hop i
        from the lanes it already gathered for hop j: zero additional
        per-spine-row gathers. Chains compose transitively
        (lineitem->orders->customer->nation folds into one orders-keyed
        matrix). Composed matrices are cached across queries by semantic
        identity (_CMP_CACHE). Reference contrast: hash_join.rs probes
        every stacked CollectLeft join per batch row."""
        from ...expr.operator import Op  # noqa: F401 (walk-time compare)
        n_spine = len(self.source.schema())
        out = list(staged_builds)
        ranges = []
        off = n_spine
        for b in self.builds:
            lo = off
            if b.join_type == "INNER":
                off += len(b.payload)
            ranges.append((lo, off))
        registry = {}    # pair idx -> (owner hop, lane_start, kind, dt, has)
        width = {}       # executed hop -> current pmat lane width
        ckey = {}        # executed hop -> running _CMP_CACHE key
        for bi, b in enumerate(self.builds):
            sb = out[bi]
            is_lut = sb[8]
            # -- composability test ------------------------------------
            owner = None
            if b.probe_keys and all(isinstance(k, ColumnExpr) and
                                    k.index >= n_spine
                                    for k in b.probe_keys):
                owners = {registry[k.index][0] for k in b.probe_keys
                          if k.index in registry}
                if len(owners) == 1 and all(k.index in registry
                                            for k in b.probe_keys):
                    owner = owners.pop()
            eligible = (
                owner is not None and owner in width and
                is_lut in (True, False, "mmxlut", "mmx") and
                all(registry[k.index][2] in ("i64", "int")
                    for k in b.probe_keys) and
                (b.join_type != "INNER" or not isinstance(sb[3], tuple) or
                 not sb[3]) and
                out[owner][2] is not None and
                not isinstance(out[owner][2], tuple))
            if eligible and out[owner][2].shape[0] > (1 << 22):
                eligible = False
            if not eligible:
                # register own payload columns for later hops
                if b.join_type == "INNER" and b.payload and len(sb[4]):
                    starts, total = self._pspec_lanes(sb[4])
                    lo, _hi = ranges[bi]
                    for t in range(len(b.payload)):
                        kind, dt, has = sb[4][t]
                        registry[lo + t] = (bi, starts[t], kind, dt, has)
                    width[bi] = total
                    ckey[bi] = ("cmpbase", hop_idents[bi],
                                int(sb[2].shape[0])
                                if not isinstance(sb[2], tuple) else 0)
                continue

            # -- compose hop bi into hop `owner` -----------------------
            j = owner
            pmat_j = out[j][2]
            key_lanes = tuple(registry[k.index][1:] for k in b.probe_keys)
            offs_i, his_i, bits_i = sb[5], sb[6], sb[7]
            base = width[j]
            tag = ("member" if is_lut is True and
                   b.join_type in ("LEFTSEMI", "LEFTANTI") else
                   "mmxlut" if is_lut == "mmxlut" else
                   "mmx" if is_lut == "mmx" else
                   "lut" if is_lut is True else "sorted")
            pspec_i = sb[4] if b.join_type == "INNER" else ()
            _starts_i, lanes_i = self._pspec_lanes(pspec_i)
            if tag in ("mmxlut", "mmx"):
                val64 = (tag == "mmx" or
                         np.dtype(out[bi][1].dtype) == np.int64)
                nl_val = 2 if val64 else 1
                n_new = 1 + 2 * nl_val
            else:
                n_new = 1 + (lanes_i if tag in ("lut", "sorted") else 0)

            new_key = (ckey[j], hop_idents[bi],
                       tuple(str(k) for k in b.probe_keys),
                       offs_i, his_i, bits_i, tag)
            hit = _CMP_CACHE.get(new_key)
            if hit is not None:
                _CMP_CACHE.move_to_end(new_key)
                new_pmat = hit
            else:
                prog_key = ("cmpprog", tag, key_lanes, offs_i, his_i,
                            bits_i, int(pmat_j.shape[0]),
                            int(pmat_j.shape[1]),
                            tuple(np.dtype(a.dtype).str if not
                                  isinstance(a, tuple) else "t"
                                  for a in (sb[0], sb[1], sb[2])),
                            pspec_i, b.join_type)
                prog = self._cached(prog_key, lambda: jax.jit(
                    self._make_compose_prog(jnp, tag, key_lanes, offs_i,
                                            his_i, bits_i, pspec_i)))
                new_pmat = prog(pmat_j, sb[0], sb[1],
                                sb[2] if tag in ("lut", "sorted", "mmx")
                                else jnp.zeros((1, 1), jnp.int32))
                nbytes = int(new_pmat.nbytes)
                while _CMP_CACHE and (
                        len(_CMP_CACHE) >= _CMP_CACHE_MAX or
                        _CMP_CACHE_BYTES[0] + nbytes >
                        _CMP_CACHE_MAX_BYTES):
                    _, old = _CMP_CACHE.popitem(last=False)
                    _CMP_CACHE_BYTES[0] -= int(old.nbytes)
                _CMP_CACHE[new_key] = new_pmat
                _CMP_CACHE_BYTES[0] += nbytes

            sj = out[j]
            out[j] = (sj[0], sj[1], new_pmat, sj[3], sj[4], sj[5], sj[6],
                      sj[7], sj[8])
            if tag in ("mmxlut", "mmx"):
                marker = ("cmp", j, "mmx",
                          (base, base + 1, base + 1 + nl_val, nl_val))
                # (found lane, mn lane, mx lane, lanes per value)
            elif tag == "member" or not pspec_i:
                marker = ("cmp", j, "member", (base,))
            else:
                marker = ("cmp", j, "inner", (base, base + 1, pspec_i))
                lo, _hi = ranges[bi]
                starts_i, _tot = self._pspec_lanes(pspec_i)
                for t in range(len(b.payload)):
                    kind, dt, has = pspec_i[t]
                    registry[lo + t] = (j, base + 1 + starts_i[t], kind,
                                       dt, has)
            out[bi] = (jnp.zeros(1, jnp.int64), jnp.zeros(1, jnp.int64),
                       (), (), (), sb[5], sb[6], sb[7], marker)
            width[j] += n_new
            ckey[j] = new_key
        return out

    def _make_compose_prog(self, jnp, tag, key_lanes, offs_i, his_i,
                           bits_i, pspec_i):
        """Staging program for one hop composition: evaluate hop i's
        probe over hop j's build rows and append result lanes to j's
        payload matrix."""
        def prog(pmat_j, sk, br, pm):
            nrows = pmat_j.shape[0]
            packed = jnp.zeros(nrows, jnp.int64)
            ok = jnp.ones(nrows, bool)
            shift = 0
            for (lane, kind, _dt, has), lo_, hi_, w in zip(
                    key_lanes, offs_i, his_i, bits_i):
                if kind == "i64":
                    hi_l = pmat_j[:, lane].astype(jnp.int64)
                    lo_l = pmat_j[:, lane + 1].astype(jnp.uint32) \
                        .astype(jnp.int64)
                    val = (hi_l << 32) | lo_l
                    vl = lane + 2
                else:
                    val = pmat_j[:, lane].astype(jnp.int64)
                    vl = lane + 1
                if has:
                    ok = ok & (pmat_j[:, vl] != 0)
                ok = ok & (val >= lo_) & (val <= hi_)
                packed = packed | ((val - lo_) << shift)
                shift += w

            def split64(x):
                return [(x >> 32).astype(jnp.int32),
                        x.astype(jnp.uint32).astype(jnp.int32)]

            new = []
            if tag == "member":
                posc = jnp.clip(packed, 0, sk.shape[0] - 1)
                found = ok & (sk[posc] > 0)
                new.append(found.astype(jnp.int32))
            elif tag == "mmxlut":
                posc = jnp.clip(packed, 0, sk.shape[0] - 1)
                mn = sk[posc]
                mx = br[posc]
                lo_s = jnp.asarray(
                    np.iinfo(np.int32 if np.dtype(br.dtype) == np.int32
                             else np.int64).min, br.dtype)
                present = ok & (mx != lo_s)
                new.append(present.astype(jnp.int32))
                if np.dtype(br.dtype) == np.int64:
                    new += split64(mn) + split64(mx)
                else:
                    new += [mn.astype(jnp.int32), mx.astype(jnp.int32)]
            elif tag == "mmx":
                pk = jnp.where(ok, packed, jnp.int64(-1))
                pos = jnp.searchsorted(sk, pk, method="sort")
                posc = jnp.clip(pos, 0, sk.shape[0] - 1)
                present = (sk[posc] == pk) & ok
                mn = br[posc]
                mx = pm[0][posc]
                new.append(present.astype(jnp.int32))
                new += split64(mn.astype(jnp.int64)) + \
                    split64(mx.astype(jnp.int64))
            else:
                if tag == "lut":
                    posc = jnp.clip(packed, 0, sk.shape[0] - 1)
                    brow_i = sk[posc]
                    found = ok & (brow_i >= 0)
                    brow = jnp.maximum(brow_i, 0).astype(jnp.int64)
                else:   # sorted searchsorted staging
                    pk = jnp.where(ok, packed, jnp.int64(-1))
                    pos = jnp.searchsorted(sk, pk, method="sort")
                    posc = jnp.clip(pos, 0, sk.shape[0] - 1)
                    found = (sk[posc] == pk) & ok
                    brow = br[posc]
                new.append(found.astype(jnp.int32))
                if pspec_i:
                    rows_i = pm[jnp.clip(brow, 0, pm.shape[0] - 1)]
                    new.append(rows_i)
            cols = [pmat_j] + [x[:, None] if x.ndim == 1 else x
                               for x in new]
            return jnp.concatenate(cols, axis=1)
        return prog

    @staticmethod
    def _stage_payload_matrix(b, bb, col_map, bcap, jax, jnp):
        """(pmat, f64s, pspec) for a build's payload columns: one
        [bcap, L] int32 lane matrix gathered by build row in a single
        lane-vectorized 2D row-gather. int64 -> hi/lo lanes, float32 ->
        bitcast lane, bool -> 0/1 lane, other ints -> one lane; float64
        stays a direct per-column gather in `f64s`. Validity rides an
        extra 0/1 lane after its column's value lanes. pspec: per payload
        col (kind, np dtype str, has_nulls)."""
        if not b.payload:
            return (), (), ()
        cols = [bb.columns[col_map[i]] for i in b.payload]
        ck = tuple(c._uid for c in cols) + (bcap,)
        hit = _PMAT_CACHE.get(ck)
        if hit is not None:
            _PMAT_CACHE.move_to_end(ck)
            return hit
        lanes = []
        f64s = []
        pspec = []
        for c in cols:
            arr = c.data_device_padded(bcap)
            dt = np.dtype(arr.dtype)
            if dt == np.int64 or dt == np.uint64:
                lanes.append((arr >> 32).astype(jnp.int32))
                lanes.append(arr.astype(jnp.uint32).astype(jnp.int32))
                kind = "i64"
            elif dt == np.float64:
                f64s.append(arr)
                kind = "f64"
            elif dt == np.float32:
                lanes.append(jax.lax.bitcast_convert_type(arr, jnp.int32))
                kind = "f32"
            elif dt == np.bool_:
                lanes.append(arr.astype(jnp.int32))
                kind = "bool"
            else:
                lanes.append(arr.astype(jnp.int32))
                kind = "int"
            has = c.has_nulls
            if has:
                lanes.append(c.validity_device_padded(bcap)
                             .astype(jnp.int32))
            pspec.append((kind, str(dt), has))
        pmat = jnp.stack(lanes, axis=1) if lanes else ()
        entry = (pmat, tuple(f64s), tuple(pspec))

        def _nbytes(e):
            tot = sum(int(a.nbytes) for a in e[1])
            if not isinstance(e[0], tuple):
                tot += int(e[0].nbytes)
            return tot

        nbytes = _nbytes(entry)
        while _PMAT_CACHE and (len(_PMAT_CACHE) >= _PMAT_CACHE_MAX or
                               _PMAT_CACHE_BYTES[0] + nbytes >
                               _PMAT_CACHE_MAX_BYTES):
            _, old = _PMAT_CACHE.popitem(last=False)
            _PMAT_CACHE_BYTES[0] -= _nbytes(old)
        _PMAT_CACHE[ck] = entry
        _PMAT_CACHE_BYTES[0] += nbytes
        return entry

    def _stage_build_device(self, b, bb, col_map, jax, jnp, m):
        """Stage an INNER build whose batch is DEVICE-resident (a
        row-returning chain output feeding another chain, TPC-H
        Q2-shape) without the D2H round trip host packing would pay:
        one fetch for key ranges, one for the
        duplicate-key flag; sorted keys/rows and the payload matrix stay
        in HBM. FD key replay reads the device arrays lazily through
        numpy interop. Returns a staged entry or None when ineligible
        (host-resident keys, non-integer keys, nulls)."""
        from ...common.column import _is_jax
        n = bb.num_rows
        if n == 0:
            return None
        key_cols = [bb.columns[col_map[k.index]] for k in b.build_keys]
        # DEVICE-BORN columns only: a staged registered table also holds
        # a jax `_data`, but it keeps its host original (`_host_cache`)
        # and must take the host path — its direct-address LUTs cache
        # across queries, which this per-query path cannot
        if not all(_is_jax(c._data) and
                   getattr(c, "_host_cache", None) is None and
                   c.dtype.is_integer and not c.has_nulls
                   for c in key_cols):
            return None
        if bb.nbytes() < (4 << 20):
            return None   # small: the host D2H beats two blocking fetches
        bcap = round_capacity(bb.capacity)
        devs = tuple(c.data_device_padded(bcap) for c in key_cols)
        mk = ("dstage_minmax", len(devs), bcap,
              tuple(str(d.dtype) for d in devs))

        def make_mm():
            def mm(cols, nn):
                live = jnp.arange(bcap) < nn
                outs = []
                for c in cols:
                    v = c.astype(jnp.int64)
                    outs.append(jnp.min(jnp.where(
                        live, v, np.iinfo(np.int64).max)))
                    outs.append(jnp.max(jnp.where(
                        live, v, np.iinfo(np.int64).min)))
                return jnp.stack(outs)
            return jax.jit(mm)

        with m.elapsed_compute, m.device_compute:
            ranges = np.asarray(self._cached(mk, make_mm)(
                devs, np.int64(n)))
        offsets, his, bits = [], [], []
        for i in range(len(devs)):
            lo, hi = int(ranges[2 * i]), int(ranges[2 * i + 1])
            offsets.append(lo)
            his.append(hi)
            bits.append(max(int(np.ceil(np.log2(hi - lo + 2))), 1))
        if sum(bits) > 62:
            raise DeviceLoweringUnsupported(
                f"chain join key bits {sum(bits)} > 62")
        sk = ("dstage_sort", bcap, len(devs), tuple(offsets), tuple(bits),
              tuple(str(d.dtype) for d in devs))

        def make_sort():
            offs_t, bits_t = tuple(offsets), tuple(bits)

            def srt(cols, nn):
                live = jnp.arange(bcap) < nn
                packed = jnp.zeros(bcap, jnp.int64)
                shift = 0
                for c, lo, w in zip(cols, offs_t, bits_t):
                    packed = packed | ((c.astype(jnp.int64) - lo) << shift)
                    shift += w
                packed = jnp.where(live, packed, jnp.int64(_KEY_SENTINEL))
                skeys, rows = jax.lax.sort(
                    (packed, jnp.arange(bcap, dtype=jnp.int64)),
                    num_keys=1)
                dup = jnp.any((skeys[1:] == skeys[:-1]) &
                              (skeys[1:] != jnp.int64(_KEY_SENTINEL)))
                return skeys, rows, dup
            return jax.jit(srt)

        with m.elapsed_compute, m.device_compute:
            skeys_d, rows_d, dup_d = self._cached(sk, make_sort)(
                devs, np.int64(n))
            if bool(dup_d):
                raise DeviceLoweringUnsupported(
                    "chain build keys not unique (fanout > 1)")
        pmat, f64s, pspec = self._stage_payload_matrix(
            b, bb, col_map, bcap, jax, jnp)
        m.record_bytes(n * 8 * len(devs))
        return (skeys_d, rows_d, pmat, f64s, pspec,
                tuple(offsets), tuple(his), tuple(bits), False)

    def _stage_semi_member_lut(self, b, bb, col_map, pred, jax, jnp, m):
        """Membership LUT for a SEMI/ANTI step, computed on device:
        lut[packed_key] = 1 when any (predicate-surviving) member row has
        that key, -1 otherwise. Emitted in the is_lut staging format the
        probe step already dispatches on. Returns None when ineligible
        (non-int keys, unbounded span, unlowerable predicate)."""
        from ...device.lower import LoweringError, lower_expr
        try:
            bpred_l = lower_expr(pred) if pred is not None else None
        except LoweringError:
            return None
        nkeys = len(b.build_keys)
        mmx = b.sfilter is not None
        n = bb.num_rows
        if n == 0:
            # empty member side: nothing is ever in range
            zero = jnp.zeros(1, jnp.int64)
            if mmx:
                return (jnp.full(1, _KEY_SENTINEL, jnp.int64), zero,
                        (zero,), (), (), (0,) * nkeys, (-1,) * nkeys,
                        (1,) * nkeys, "mmx")
            return (jnp.full(1, -1, jnp.int8),
                    zero, (), (), (), (0,) * nkeys, (-1,) * nkeys,
                    (1,) * nkeys, True)
        key_cols = []
        offsets, his, bits = [], [], []
        for k in b.build_keys:
            c = bb.columns[col_map[k.index]]
            if not c.dtype.is_integer:
                return None
            key_cols.append(c)
            a = c.data_host()[:n]
            lo, hi = int(a.min()), int(a.max())
            offsets.append(lo)
            his.append(hi)
            bits.append(max(int(np.ceil(np.log2(hi - lo + 2))), 1))
        if sum(bits) > 62:
            return None
        # direct-address layout when the packed span is bounded: probe =
        # one (presence) or two (min/max) gathers, no per-probe sort.
        # Wide spans keep the sorted-unique spine + searchsorted probe.
        mmx_direct = mmx and sum(bits) <= 26
        span_total = 1 << min(sum(bits), 27)
        if mmx_direct:
            span_total = 1 << sum(bits)
        if not mmx and span_total > (1 << 26):
            return None   # presence LUT only for bounded spans
        fidx = None
        fit32 = False
        if mmx:
            fc = bb.columns[col_map[b.sfilter[1].index]]
            if not fc.dtype.is_integer:
                return None
            fidx = col_map[b.sfilter[1].index]
            if n:
                fa = fc.data_host()[:n]
                # storing the min/max lanes as int32 halves the probe's
                # gather traffic (needed on the H100? ROADMAP C2)
                fit32 = int(fa.min()) > np.iinfo(np.int32).min + 1 and \
                    int(fa.max()) < np.iinfo(np.int32).max
        kidx = tuple(col_map[k.index] for k in b.build_keys)
        sl_key = (tuple(c._uid for c in bb.columns), str(pred), kidx,
                  mmx, fidx)
        sl_hit = _SEMI_LUT_CACHE.get(sl_key)
        if sl_hit is not None:
            _SEMI_LUT_CACHE.move_to_end(sl_key)
            return sl_hit
        bcap = round_capacity(bb.capacity)
        cols = tuple(c.data_device_padded(bcap) for c in bb.columns)
        valids_present = tuple(c.validity_device_padded(bcap)
                               for c in bb.columns if c.has_nulls)
        null_layout = tuple(c.has_nulls for c in bb.columns)
        offs_t, bits_t = tuple(offsets), tuple(bits)

        def lut_prog(cols_, present_valids, num_rows, baux):
            valids = self._assemble_valids(jnp, cols_, present_valids,
                                           null_layout)
            valid = jnp.arange(cols_[0].shape[0]) < num_rows
            if bpred_l is not None:
                d, v = bpred_l.trace(cols_, valids, baux)
                valid = valid & d
                if v is not None:
                    valid = valid & v
            packed = jnp.zeros(cols_[0].shape[0], jnp.int64)
            shift = 0
            for ci, lo_, w in zip(kidx, offs_t, bits_t):
                valid = valid & valids[ci]
                packed = packed | ((cols_[ci].astype(jnp.int64) - lo_)
                                   << shift)
                shift += w
            idx = jnp.where(valid, packed, span_total)   # dead -> trash slot
            if not mmx:
                lut = jnp.full(span_total + 1, -1, jnp.int8).at[idx].set(1)
                return lut[:span_total]
            # per-key min/max of the member comparison column, SORT-based:
            # scatter-min/max with duplicate indices was serialized by the
            # compiler this was first written for, so this sorts (key,
            # value) pairs and reads each run's first/last element — sorts
            # and gathers only (scatter on the H100: ROADMAP A6)
            import jax as _jax
            fval = cols_[fidx].astype(jnp.int64)
            fvalid = valid & valids[fidx]
            big = jnp.int64(_KEY_SENTINEL)
            k = jnp.where(fvalid, packed, big)
            sk, sv = _jax.lax.sort((k, fval), num_keys=2)
            capn = sk.shape[0]
            first = jnp.concatenate([jnp.ones(1, bool),
                                     sk[1:] != sk[:-1]]) & (sk != big)
            cs = jnp.cumsum(first.astype(jnp.int64))
            n_uniq = cs[-1]
            jj = jnp.arange(capn)
            firstpos = jnp.searchsorted(cs, jj + 1, side="left",
                                        method="sort")
            lastpos = jnp.searchsorted(cs, jj + 1, side="right",
                                       method="sort") - 1
            fp = jnp.clip(firstpos, 0, capn - 1)
            lp = jnp.clip(lastpos, 0, capn - 1)
            ok_u = jj < n_uniq
            skeys_u = jnp.where(ok_u, sk[fp], big)
            if not mmx_direct:
                return skeys_u, sv[fp], sv[lp]
            # scatter each unique run's min/max at its packed address —
            # indices are unique (drop-mode discards the dead lanes), so
            # the scatter never serializes. Absent convention matches
            # the probe: mx == int64.min means "no member row".
            vdt = jnp.int32 if fit32 else jnp.int64
            hi_s = jnp.asarray(np.iinfo(np.int32 if fit32 else np.int64).max,
                               vdt)
            lo_s = jnp.asarray(np.iinfo(np.int32 if fit32 else np.int64).min,
                               vdt)
            idx_u = jnp.where(ok_u, skeys_u, jnp.int64(-1))
            mn_lut = jnp.full(span_total, hi_s, vdt) \
                .at[idx_u].set(sv[fp].astype(vdt), mode="drop")
            mx_lut = jnp.full(span_total, lo_s, vdt) \
                .at[idx_u].set(sv[lp].astype(vdt), mode="drop")
            return mn_lut, mx_lut

        jl = self._cached(
            self._sig() + ("semilut", kidx, offs_t, bits_t, null_layout,
                           bcap, str(pred), mmx, mmx_direct, fit32, fidx),
            lambda: jax.jit(lut_prog))
        baux = tuple(np.asarray(spec.fn(bb)) for spec in
                     (bpred_l.aux if bpred_l is not None else []))
        m.record_bytes(n * 8 * nkeys + (n * 24 if mmx else span_total))
        out = jl(cols, valids_present, np.int64(n), baux)
        if mmx and mmx_direct:
            mn_lut, mx_lut = out
            entry = (mn_lut, mx_lut, (), (), (), offs_t, tuple(his),
                     bits_t, "mmxlut")
        elif mmx:
            skeys_u, mn, mx = out
            entry = (skeys_u, mn, (mx,), (), (), offs_t, tuple(his),
                     bits_t, "mmx")
        else:
            entry = (out, jnp.zeros(1, jnp.int64), (), (), (),
                     offs_t, tuple(his), bits_t, True)
        nbytes = _semi_lut_nbytes(entry)
        while _SEMI_LUT_CACHE and (
                len(_SEMI_LUT_CACHE) >= _SEMI_LUT_CACHE_MAX or
                _SEMI_LUT_CACHE_BYTES[0] + nbytes >
                _SEMI_LUT_CACHE_MAX_BYTES):
            _, old = _SEMI_LUT_CACHE.popitem(last=False)
            _SEMI_LUT_CACHE_BYTES[0] -= _semi_lut_nbytes(old)
        _SEMI_LUT_CACHE[sl_key] = entry
        _SEMI_LUT_CACHE_BYTES[0] += nbytes
        return entry

    @staticmethod
    def _mmx_exists(jnp, op, mn, mx, sfilter_l, pair_cols, pair_valids,
                    sub_aux):
        """Filtered-semi membership from per-key min/max of the member
        comparison column: any member row with this key satisfying
        `member_col OP probe_expr`."""
        from ...expr.operator import Op
        xd, xv = sfilter_l.trace(tuple(pair_cols), tuple(pair_valids),
                                 sub_aux(sfilter_l))
        x = xd.astype(jnp.int64)
        if op == Op.NEQ:
            exists = (mn != x) | (mx != x)
        elif op == Op.LT:
            exists = mn < x
        elif op == Op.LTEQ:
            exists = mn <= x
        elif op == Op.GT:
            exists = mx > x
        else:   # GTEQ
            exists = mx >= x
        if xv is not None:
            exists = exists & xv
        return exists

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

    def _fd_finalize(self, kept_pos, dropped_pos, probe_batches, pb_bases,
                     build_batches, host_builds, staged_builds):
        """Emit hook: reconstruct functionally-dependent group-key columns
        from one representative spine row per group — replay the join
        chain on the host for just those rows (searchsorted over the same
        packed build keys the device used), then evaluate the dropped
        group expressions over the mini pair batch."""
        from ...common.column import Column

        class _Mini:
            def __init__(self, cols, n):
                self.columns = cols
                self.num_rows = n
                self.capacity = n

        def take_col(c, idx):
            v = c.validity_host()
            return Column(c.dtype, c.data_host()[idx],
                          None if v is None else v[idx], c.dictionary)

        def finalize(sel, cols, aggs_np):
            rep = aggs_np["__rep#x"][sel].astype(np.int64)
            n = len(rep)
            # global rowid -> (probe batch, local row)
            bases = np.asarray(pb_bases + [pb_bases[-1] +
                                           probe_batches[-1].num_rows]
                               if pb_bases else [0])
            which = np.clip(np.searchsorted(bases, rep, side="right") - 1,
                            0, max(len(probe_batches) - 1, 0))
            local = rep - bases[which]
            pair_cols = []
            for i in range(len(probe_batches[0].columns) if probe_batches
                           else 0):
                if len(probe_batches) == 1:
                    pair_cols.append(take_col(probe_batches[0].columns[i],
                                              local))
                else:
                    datas = [probe_batches[w].columns[i] for w in
                             range(len(probe_batches))]
                    # gather per source batch, stitched in rep order
                    out = None
                    for w in range(len(probe_batches)):
                        msk = which == w
                        got = take_col(datas[w], local[msk])
                        if out is None:
                            out = Column(got.dtype,
                                         np.zeros(n, got.data_host().dtype),
                                         None, got.dictionary)
                        od = out.data_host()
                        od[msk] = got.data_host()
                        out = Column(out.dtype, od, None, out.dictionary)
                    pair_cols.append(out)
            # replay INNER joins on host for the representative rows
            for bi, b in enumerate(self.builds):
                if b.join_type != "INNER":
                    continue
                skeys_np, rows_np = host_builds[bi]
                offs, his, bits = (staged_builds[bi][5], staged_builds[bi][6],
                                   staged_builds[bi][7])
                mini = _Mini(pair_cols, n)
                packed = np.zeros(n, np.int64)
                shift = 0
                for pk, lo_, w in zip(b.probe_keys, offs, bits):
                    val = pk.evaluate(mini).data_host().astype(np.int64)
                    packed |= (val - lo_) << shift
                    shift += w
                if skeys_np is None:
                    # LUT-staged build: rows_np IS the direct-address LUT
                    # (unfiltered; representative rows already survived the
                    # device-side mask, so their entries are the right rows)
                    brow = rows_np[np.clip(packed, 0, len(rows_np) - 1)]
                    brow = np.maximum(brow, 0).astype(np.int64)
                else:
                    pos = np.clip(np.searchsorted(skeys_np, packed), 0,
                                  len(skeys_np) - 1)
                    brow = rows_np[pos]
                bb, col_map = build_batches[bi]
                for i in b.payload:
                    pair_cols.append(take_col(bb.columns[col_map[i]], brow))
            mini = _Mini(pair_cols, n)
            full = [None] * len(self.group_exprs)
            for j, p in enumerate(kept_pos):
                full[p] = cols[j]
            for p in dropped_pos:
                full[p] = self.group_exprs[p][0].evaluate(mini)
            return full

        return finalize

    # ------------------------------------------------------------------
    def _chain_slots(self, lower_expr):
        """Same slot scheme as DeviceGroupAggregateExec (sum/cnt/min/max/
        nancnt/distinct dedup) — pair-space argument expressions."""
        from ...device.lower import LoweringError
        from .device_aggregate import _DEVICE_AGGS
        agg_specs = []
        for a in self.aggs:
            kind = "avg" if a.name == "mean" else a.name
            if kind not in _DEVICE_AGGS:
                raise LoweringError(kind)
            if a.distinct and kind == "count" and a.args:
                kind = "count_distinct"
            elif a.filter is not None or a.distinct:
                raise LoweringError("agg FILTER/DISTINCT on device TBD")
            if kind in ("min", "max") and a.out_type.is_dict_coded:
                raise LoweringError("string min/max on device TBD")
            if len(a.args) > 1 or getattr(a, "order_by", None):
                raise LoweringError("multi-arg/ordered agg on device TBD")
            arg = lower_expr(a.args[0]) if a.args else None
            sig = str(a.args[0]) if a.args else "*"
            agg_specs.append((a.display, kind, arg, sig, a.out_type))
        slot_defs, slot_map, uniq = {}, {}, {}

        def _slot(cat, sig, suffix, arg):
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
            else:
                m_["x"] = _slot("max", sig, "#x", arg)
                m_["c"] = _slot("cnt", sig, "#c", arg)
                if out_t is not None and out_t.is_float:
                    m_["nn"] = _slot("nancnt", sig, "#nn", arg)
            slot_map[display] = m_
        return slot_defs, slot_map

    def _fd_reduce(self):
        """(kept_positions, dropped_positions) of group_exprs under
        functional dependence: a group key that is a payload column of a
        unique-key INNER build whose probe keys are derivable from the
        remaining keys is group-constant and needs no packing bits."""
        n_spine = len(self.source.schema())
        if self.post_filter is not None or len(self.group_exprs) < 2:
            return list(range(len(self.group_exprs))), []
        # pair-space ranges of each INNER build's payload
        build_range = []
        off = n_spine
        for b in self.builds:
            lo = off
            if b.join_type == "INNER":
                off += len(b.payload)
            build_range.append((lo, off))
        payload_idx = {}    # pair index -> build index
        for bi, (lo, hi) in enumerate(build_range):
            for p in range(lo, hi):
                payload_idx[p] = bi
        gk = {}
        for pos, (e, _nm) in enumerate(self.group_exprs):
            if not isinstance(e, ColumnExpr):
                return list(range(len(self.group_exprs))), []
            gk[pos] = e.index
        # probe-key <-> key-payload equivalences (o_orderkey payload ==
        # l_orderkey probe value on matched rows)
        equiv = []
        for bi, b in enumerate(self.builds):
            if b.join_type != "INNER":
                continue
            lo, _hi = build_range[bi]
            for pk, bk in zip(b.probe_keys, b.build_keys):
                if isinstance(pk, ColumnExpr) and bk.index in b.payload:
                    equiv.append((pk.index, lo + b.payload.index(bk.index)))

        def closure(S):
            S = set(S)
            changed = True
            while changed:
                changed = False
                for a_, b_ in equiv:
                    if a_ in S and b_ not in S:
                        S.add(b_)
                        changed = True
                    if b_ in S and a_ not in S:
                        S.add(a_)
                        changed = True
                for bi, b in enumerate(self.builds):
                    if b.join_type != "INNER":
                        continue
                    if all(isinstance(pk, ColumnExpr) and pk.index in S
                           for pk in b.probe_keys):
                        lo, hi = build_range[bi]
                        for p in range(lo, hi):
                            if p not in S:
                                S.add(p)
                                changed = True
            return S

        kept = dict(gk)
        dropped = []
        # try widest candidates first: payload keys only
        for pos in sorted(gk, key=lambda p: -gk[p]):
            if gk[pos] not in payload_idx:
                continue            # spine keys stay
            others = {v for k, v in kept.items() if k != pos}
            if not others:
                break               # keep at least one key
            if gk[pos] in closure(others):
                dropped.append(pos)
                kept.pop(pos)
        if not dropped:
            return list(range(len(self.group_exprs))), []
        return sorted(kept), sorted(dropped)

    def _chain_pair_view(self, probe_batches, build_batches):
        """Zero-row pseudo-batch exposing the pair column space for
        _plan_key_packing ranges/dictionaries and aux staging: spine
        source columns, then each INNER build's payload columns."""
        if not probe_batches:
            return None
        from ...common.column import concat_columns
        cols = []
        for i in range(len(probe_batches[0].columns)):
            if len(probe_batches) == 1:
                cols.append(probe_batches[0].columns[i])
            else:
                cols.append(concat_columns(
                    [b.columns[i] for b in probe_batches]))
        for b, (bb, col_map) in zip(self.builds, build_batches):
            for i in b.payload:
                cols.append(bb.columns[col_map[i]])
        return _ChainPairView(cols)

    # ------------------------------------------------------------------
    def _chain_walk(self, jnp, n, pair_cols, pair_valids, row_valid,
                    build_args, build_meta, sub_aux, probe_key_ls,
                    sfilter_ls=None):
        """One pass over the join chain inside a compiled step:
        membership tests (LUT / min-max / searchsorted) and INNER
        payload gathers. Appends gathered columns to pair_cols /
        pair_valids in place; returns the surviving-row mask."""
        builds = self.builds
        pending = {}    # executed hop -> (gathered pmat rows, found mask)
        # the join chain: LUT gather / searchsorted membership +
        # payload gathers
        for bi, b in enumerate(builds):
            skeys, brows, pcols, pvalids_present = build_args[bi]
            pspec, koffs, khis, kbits, is_lut = build_meta[bi]
            rows_pre = None
            if isinstance(is_lut, tuple) and is_lut[0] == "cmp":
                # hop resolved at STAGING time into hop j's lanes — read
                # its found flag / payloads / min-max membership from the
                # rows already gathered for hop j; zero per-row gathers
                _, j, ctag, info = is_lut
                rows_j, _fj = pending[j]
                if ctag == "mmx":
                    fl, mnl, mxl, nlv = info
                    present = rows_j[:, fl] != 0
                    if nlv == 2:
                        mn = (rows_j[:, mnl].astype(jnp.int64) << 32) | \
                            rows_j[:, mnl + 1].astype(jnp.uint32) \
                            .astype(jnp.int64)
                        mx = (rows_j[:, mxl].astype(jnp.int64) << 32) | \
                            rows_j[:, mxl + 1].astype(jnp.uint32) \
                            .astype(jnp.int64)
                    else:
                        mn = rows_j[:, mnl].astype(jnp.int64)
                        mx = rows_j[:, mxl].astype(jnp.int64)
                    found = present & self._mmx_exists(
                        jnp, builds[bi].sfilter[0], mn, mx,
                        sfilter_ls[bi], pair_cols, pair_valids, sub_aux)
                elif ctag == "inner":
                    found = rows_j[:, info[0]] != 0
                else:   # member
                    found = rows_j[:, info[0]] != 0
                if b.join_type == "LEFTANTI":
                    row_valid = row_valid & ~found
                else:
                    row_valid = row_valid & found
                if ctag == "inner" and b.payload:
                    _fl, base, pspec_i = info
                    starts_i, _tot = self._pspec_lanes(pspec_i)
                    for t, (kind, dt, has) in enumerate(pspec_i):
                        li = base + starts_i[t]
                        if kind == "i64":
                            val = (rows_j[:, li].astype(jnp.int64) << 32) \
                                | rows_j[:, li + 1].astype(jnp.uint32) \
                                .astype(jnp.int64)
                            vl = li + 2
                        elif kind == "f32":
                            import jax as _jax
                            val = _jax.lax.bitcast_convert_type(
                                rows_j[:, li], jnp.float32)
                            vl = li + 1
                        elif kind == "bool":
                            val = rows_j[:, li] != 0
                            vl = li + 1
                        else:
                            val = rows_j[:, li].astype(jnp.dtype(dt))
                            vl = li + 1
                        pair_cols.append(val)
                        if has:
                            pair_valids.append((rows_j[:, vl] != 0) &
                                               found)
                        else:
                            pair_valids.append(found)
                continue
            packed = jnp.zeros(n, jnp.int64)
            ok = jnp.ones(n, bool)
            shift = 0
            for low, lo_, hi_, w in zip(probe_key_ls[bi], koffs, khis,
                                        kbits):
                kd, kv = low.trace(tuple(pair_cols), tuple(pair_valids),
                                   sub_aux(low))
                val = kd.astype(jnp.int64)
                ok = ok & (val >= lo_) & (val <= hi_)
                if kv is not None:
                    ok = ok & kv
                packed = packed | ((val - lo_) << shift)
                shift += w
            if is_lut in ("mmx", "mmxlut"):
                # per-key min/max of the member comparison column:
                # membership = any member row with this key whose column
                # satisfies `member_col OP probe_expr`. Direct-address
                # layout = two gathers; wide-span layout = sorted-unique
                # spine + searchsorted.
                from ...expr.operator import Op
                if is_lut == "mmxlut":
                    posc = jnp.clip(packed, 0, skeys.shape[0] - 1)
                    lo_s = jnp.asarray(np.iinfo(np.int32 if brows.dtype ==
                                                jnp.int32 else np.int64).min,
                                       brows.dtype)
                    mn = skeys[posc]
                    mx = brows[posc]
                    present = ok & (mx != lo_s)
                    mn = mn.astype(jnp.int64)
                    mx = mx.astype(jnp.int64)
                else:
                    packed = jnp.where(ok, packed, jnp.int64(-1))
                    pos = jnp.searchsorted(skeys, packed, method="sort")
                    posc = jnp.clip(pos, 0, skeys.shape[0] - 1)
                    present = (skeys[posc] == packed) & ok
                    mn = brows[posc]
                    mx = pcols[0][posc]
                found = present & self._mmx_exists(
                    jnp, builds[bi].sfilter[0], mn, mx, sfilter_ls[bi],
                    pair_cols, pair_valids, sub_aux)
                brow = jnp.zeros(n, jnp.int64)   # no payload for semis
            elif is_lut == "lutmat":
                # folded LUT+payload matrix: ONE row-gather resolves the
                # probe AND every payload lane (incl. composed hops)
                posc = jnp.clip(packed, 0, skeys.shape[0] - 1)
                rows_all = skeys[posc]
                brow_i32 = rows_all[:, 0]
                found = ok & (brow_i32 >= 0)
                brow = jnp.maximum(brow_i32, 0).astype(jnp.int64)
                rows_pre = rows_all[:, 1:]
            elif is_lut:
                # skeys IS the direct-address LUT: lut[packed] = build
                # row, -1 absent (per-query build predicate already
                # folded in as -1). In-range `ok` guarantees
                # packed < lut length.
                posc = jnp.clip(packed, 0, skeys.shape[0] - 1)
                brow_i32 = skeys[posc]
                found = ok & (brow_i32 >= 0)
                brow = jnp.maximum(brow_i32, 0).astype(jnp.int64)
            else:
                packed = jnp.where(ok, packed, jnp.int64(-1))
                pos = jnp.searchsorted(skeys, packed, method="sort")
                posc = jnp.clip(pos, 0, skeys.shape[0] - 1)
                found = (skeys[posc] == packed) & ok
                brow = brows[posc]
            if b.join_type == "LEFTANTI":
                row_valid = row_valid & ~found
            else:   # INNER and LEFTSEMI both require a match
                row_valid = row_valid & found
            if b.join_type == "INNER" and b.payload:
                # ONE lane-vectorized 2D row-gather fetches every payload
                # column (+ validity lanes); float64 columns gather
                # directly from the side tuple
                pmat, f64s = pcols, pvalids_present
                if rows_pre is not None:
                    rows = rows_pre
                else:
                    rows = pmat[brow] if len(pspec) and \
                        not isinstance(pmat, tuple) else None
                if rows is not None:
                    pending[bi] = (rows, found)
                li = 0
                fi = 0
                for kind, dt, has in pspec:
                    if kind == "i64":
                        hi = rows[:, li].astype(jnp.int64)
                        lo = rows[:, li + 1].astype(jnp.uint32) \
                            .astype(jnp.int64)
                        val = (hi << 32) | lo
                        li += 2
                    elif kind == "f32":
                        import jax as _jax
                        val = _jax.lax.bitcast_convert_type(
                            rows[:, li], jnp.float32)
                        li += 1
                    elif kind == "f64":
                        val = f64s[fi][brow]
                        fi += 1
                    elif kind == "bool":
                        val = rows[:, li] != 0
                        li += 1
                    else:
                        val = rows[:, li].astype(jnp.dtype(dt))
                        li += 1
                    pair_cols.append(val)
                    if has:
                        pair_valids.append((rows[:, li] != 0) & found)
                        li += 1
                    else:
                        pair_valids.append(found)

        return row_valid

    def _chain_core(self, ppred_l, pred_l, probe_key_ls, jnp, aux_offset,
                    p_null_layout, chunk_eff, staged_builds, sfilter_ls):
        """Shared traced front half of every chain program: chunk-slice
        the spine, probe predicate, chain walk, residual predicate.
        Returns (pair_cols, pair_valids, row_valid, sub_aux, n)."""
        import jax as _jax
        build_meta = [(sb[4], sb[5], sb[6], sb[7], sb[8])
                      for sb in staged_builds]

        def core(full_cols, present_valids, build_args, num_rows, start,
                 aux):
            def sub_aux(low):
                o = aux_offset[id(low)]
                return aux[o:o + len(low.aux)]

            if not full_cols:
                n = chunk_eff or 1
                pair_cols = [jnp.zeros(n, np.int32)]
                pair_valids = [jnp.ones(n, bool)]
            else:
                n = chunk_eff
                pair_cols = [
                    _jax.lax.dynamic_slice_in_dim(c, start, n)
                    if c.shape[0] > n else c for c in full_cols]
                pair_valids = []
                vi = 0
                for c, has in zip(full_cols, p_null_layout):
                    if has:
                        v = present_valids[vi]
                        vi += 1
                        pair_valids.append(
                            _jax.lax.dynamic_slice_in_dim(v, start, n)
                            if v.shape[0] > n else v)
                    else:
                        pair_valids.append(jnp.ones(n, bool))
            row_valid = jnp.arange(n) < num_rows
            if ppred_l is not None:
                d, v = ppred_l.trace(tuple(pair_cols), tuple(pair_valids),
                                     sub_aux(ppred_l))
                row_valid = row_valid & d
                if v is not None:
                    row_valid = row_valid & v

            row_valid = self._chain_walk(
                jnp, n, pair_cols, pair_valids, row_valid,
                build_args, build_meta, sub_aux, probe_key_ls,
                sfilter_ls)
            pair_cols = tuple(pair_cols)
            pair_valids = tuple(pair_valids)
            if pred_l is not None:
                d, v = pred_l.trace(pair_cols, pair_valids, sub_aux(pred_l))
                row_valid = row_valid & d
                if v is not None:
                    row_valid = row_valid & v
            return pair_cols, pair_valids, row_valid, sub_aux, n
        return core

    def _trace_packed_keys(self, jnp, key_l, plan, pair_cols, pair_valids,
                           sub_aux, n):
        packed = jnp.zeros(n, jnp.int64)
        shift = 0
        for low, off, w in zip(key_l, plan.offsets, plan.bits):
            kd, kv = low.trace(pair_cols, pair_valids, sub_aux(low))
            k = kd.astype(jnp.int64) - jnp.int64(off) + 1
            if kv is not None:
                k = jnp.where(kv, k, 0)
            packed = packed | (k << shift)
            shift += w
        return packed

    def _trace_slot_values(self, jnp, slot_defs, pair_cols, pair_valids,
                           row_valid, sub_aux, base, start, n,
                           sorted_keys, rowspace=False):
        import jax as _jax
        values = {}
        for slot, (cat, arg) in slot_defs.items():
            if cat == "rowid":
                # representative GLOBAL spine row per group (any
                # surviving row): lets the emit reconstruct
                # functionally-dependent group keys on the host. The
                # rowspace layout reads it AT the run-end row (always a
                # valid row) — no reduction; the table paths reduce it
                # (cummax when globally monotone, max otherwise).
                rid = base + start + jnp.arange(n, dtype=jnp.int64)
                if rowspace:
                    values[slot] = ("atend", rid)
                else:
                    values[slot] = ("maxmono" if sorted_keys else "max",
                                    jnp.where(row_valid, rid,
                                              jnp.int64(np.iinfo(np.int64).min)))
                continue
            if arg is None:
                values[slot] = ("sum", row_valid.astype(jnp.int64))
                continue
            ad, av = arg.trace(pair_cols, pair_valids, sub_aux(arg))
            avail = row_valid if av is None else (row_valid & av)
            if cat == "sum":
                acc_np = (jnp.float32 if ad.dtype == jnp.float32
                          else jnp.float64) if arg.out_dtype.is_float \
                    else jnp.int64
                values[slot] = ("sum",
                                jnp.where(avail, ad.astype(acc_np), 0))
            elif cat == "cnt":
                values[slot] = ("sum", avail.astype(jnp.int64))
            elif cat == "distinct":
                if jnp.issubdtype(ad.dtype, jnp.floating):
                    f = ad.astype(jnp.float64)
                    f = jnp.where(f == 0.0, 0.0, f)
                    rep = _jax.lax.bitcast_convert_type(f, jnp.int64)
                else:
                    rep = ad.astype(jnp.int64)
                nullrep = jnp.int64(np.iinfo(np.int64).min)
                values[slot] = ("distinct",
                                jnp.where(avail, rep, nullrep))
            elif cat == "nancnt":
                values[slot] = ("sum",
                                (avail & jnp.isnan(ad)).astype(jnp.int64))
            elif cat == "min":
                if ad.dtype == jnp.bool_:
                    ad = ad.astype(jnp.int32)
                if jnp.issubdtype(ad.dtype, jnp.floating):
                    ident = jnp.asarray(jnp.inf, ad.dtype)
                    avail = avail & ~jnp.isnan(ad)
                else:
                    ident = jnp.asarray(jnp.iinfo(ad.dtype).max, ad.dtype)
                values[slot] = ("min", jnp.where(avail, ad, ident))
            else:
                if ad.dtype == jnp.bool_:
                    ad = ad.astype(jnp.int32)
                if jnp.issubdtype(ad.dtype, jnp.floating):
                    ident = jnp.asarray(-jnp.inf, ad.dtype)
                    avail = avail & ~jnp.isnan(ad)
                else:
                    ident = jnp.asarray(jnp.iinfo(ad.dtype).min, ad.dtype)
                values[slot] = ("max", jnp.where(avail, ad, ident))
        return values

    def _make_chain_step(self, ppred_l, pred_l, key_l, slot_defs,
                         probe_key_ls, plan, jnp, max_groups, aux_offset,
                         dense_keys, p_null_layout, chunk_eff,
                         staged_builds, sorted_keys=False,
                         sfilter_ls=None):
        from ...device.groupby import device_group_aggregate
        core = self._chain_core(ppred_l, pred_l, probe_key_ls, jnp,
                                aux_offset, p_null_layout, chunk_eff,
                                staged_builds, sfilter_ls)

        def step(full_cols, present_valids, build_args, num_rows, start,
                 base, aux):
            pair_cols, pair_valids, row_valid, sub_aux, n = core(
                full_cols, present_valids, build_args, num_rows, start,
                aux)
            packed = self._trace_packed_keys(jnp, key_l, plan, pair_cols,
                                             pair_valids, sub_aux, n)
            values = self._trace_slot_values(
                jnp, slot_defs, pair_cols, pair_valids, row_valid,
                sub_aux, base, start, n, sorted_keys)
            return device_group_aggregate(packed, row_valid, values,
                                          max_groups,
                                          assume_dense_keys=dense_keys,
                                          assume_sorted_keys=sorted_keys)
        return step

    def _make_chain_rowspace_prog(self, ppred_l, pred_l, key_l, slot_defs,
                                  probe_key_ls, plan, jnp, aux_offset,
                                  p_null_layout, chunk_eff, staged_builds,
                                  sorted_keys, sfilter_ls):
        """Program A of the row-space path: chain walk + value slots +
        (argsort if keys unsorted, value lanes reordered by ONE packed
        2D int32 row-gather) + rowspace_group_state. Returns
        (lanes dict, n_groups) — lanes stay device-resident for the
        emit program."""
        from ...device.groupby import (reorder_rows_packed,
                                       rowspace_group_state)
        core = self._chain_core(ppred_l, pred_l, probe_key_ls, jnp,
                                aux_offset, p_null_layout, chunk_eff,
                                staged_builds, sfilter_ls)

        def prog(full_cols, present_valids, build_args, num_rows, start,
                 base, aux):
            pair_cols, pair_valids, row_valid, sub_aux, n = core(
                full_cols, present_valids, build_args, num_rows, start,
                aux)
            packed = self._trace_packed_keys(jnp, key_l, plan, pair_cols,
                                             pair_valids, sub_aux, n)
            values = self._trace_slot_values(
                jnp, slot_defs, pair_cols, pair_valids, row_valid,
                sub_aux, base, start, n, sorted_keys, rowspace=True)
            vals2 = {s: (("sum" if k in ("sum", "cnt", "nancnt") else k), a)
                     for s, (k, a) in values.items()}
            # narrow packed key spaces ride int32: the argsort and the
            # run-detection scans move half the bytes of int64
            narrow = sum(plan.bits) <= 31
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
        return prog

    def _execute_rowspace(self, jax, jnp, m, probe_batches, build_batches,
                          staged_builds, host_builds, lowereds, aux_offset,
                          cache_key, ppred_l, pred_l, key_l, slot_defs,
                          slot_map, probe_key_ls, sfilter_ls, plan,
                          sorted_keys, kept_pos, dropped_pos, fd_active):
        """Two-program row-space aggregation drive: program A (chain +
        scans) -> one scalar n_groups fetch -> program B (emit at the
        exact-count capacity bucket) -> host emit. Worst case two
        blocking fetches; no [max_groups] table, no overflow retry."""
        from .device_aggregate import _emit_capacity
        pb = probe_batches[0]
        cap = round_capacity(pb.capacity)
        p_cols = tuple(c.data_device_padded(cap) for c in pb.columns)
        p_valids_present = tuple(c.validity_device_padded(cap)
                                 for c in pb.columns if c.has_nulls)
        p_null_layout = tuple(c.has_nulls for c in pb.columns)
        pv = self._chain_pair_view([pb], build_batches)
        aux = []
        for low in lowereds:
            for spec in low.aux:
                aux.append(np.asarray(spec.fn(pv)))
        build_args = tuple((sb[0], sb[1], sb[2], sb[3])
                           for sb in staged_builds)
        kinds = {}
        for slot, (cat, _arg) in slot_defs.items():
            kinds[slot] = ("atend" if cat == "rowid" else
                           "distinct" if cat == "distinct" else "sum")

        step_key = cache_key + ("rowspace", p_null_layout, cap)
        make_a = lambda: self._make_chain_rowspace_prog(  # noqa: E731
            ppred_l, pred_l, key_l, slot_defs, probe_key_ls, plan,
            jnp, aux_offset, p_null_layout, cap, staged_builds,
            sorted_keys, sfilter_ls)
        chunk_bytes = sum(int(c.dtype.itemsize) for c in p_cols) + \
            sum(int(v.dtype.itemsize) for v in p_valids_present)
        m.record_bytes(pb.num_rows * chunk_bytes)
        import os
        import time as _time
        trace = os.environ.get("DATAFUSION_TPU_TRACE_TIME")
        t0 = _time.perf_counter()

        finalize = None
        if fd_active:
            finalize = self._fd_finalize(kept_pos, dropped_pos,
                                         probe_batches, [0],
                                         build_batches, host_builds,
                                         staged_builds)

        # ---- speculative fused single-fetch path ---------------------
        has_float = any(
            cat == "sum" and arg is not None and arg.out_dtype.is_float
            for cat, arg in slot_defs.values())
        spec_cap = _OUTCAP_MEMO.get(step_key)
        if spec_cap is not None and self.post_filter is None and \
                not has_float:
            from ...device.groupby import rowspace_group_emit
            names = tuple(sorted(kinds))
            ab_key = step_key + ("ab", spec_cap)

            def make_ab():
                prog_a = make_a()

                def ab(p_cols_, p_valids_, bargs, num_rows, start, base,
                       aux_):
                    lanes, ng = prog_a(p_cols_, p_valids_, bargs,
                                       num_rows, start, base, aux_)
                    gk, gv, aggs, _ng2 = rowspace_group_emit(
                        lanes, kinds, spec_cap)
                    return jnp.concatenate(
                        [ng.astype(jnp.int64).reshape(1),
                         gk.astype(jnp.int64), gv.astype(jnp.int64)] +
                        [aggs[nm].astype(jnp.int64) for nm in names])
                return jax.jit(ab)

            jit_ab = self._cached(ab_key, make_ab)
            with m.elapsed_compute, m.device_compute:
                buf = jit_ab(p_cols, p_valids_present, build_args,
                             np.int64(pb.num_rows), np.int64(0),
                             np.int64(0), tuple(aux))
                host = np.asarray(buf)   # the ONE blocking fetch
            ng = int(host[0])
            if trace:
                dt_ms = 1e3 * (_time.perf_counter() - t0)
                print(f"[rowspace] fusedAB {dt_ms:.1f}ms ng={ng} "
                      f"cap={spec_cap}", flush=True)
            if ng <= spec_cap:
                g = spec_cap
                keys_np = host[1:1 + g]
                valid_np = host[1 + g:1 + 2 * g] != 0
                aggs_np = {nm: host[1 + (2 + i) * g:1 + (3 + i) * g]
                           for i, nm in enumerate(names)}
                with m.elapsed_compute:
                    return self._emit_arrays(keys_np, valid_np, aggs_np,
                                             plan, slot_map, m,
                                             key_finalize=finalize)
            # speculation missed (group count grew): exact path below
            t0 = _time.perf_counter()
        jit_a = self._cached(step_key, lambda: jax.jit(make_a()))
        with m.elapsed_compute, m.device_compute:
            lanes, ng_dev = jit_a(p_cols, p_valids_present, build_args,
                                  np.int64(pb.num_rows), np.int64(0),
                                  np.int64(0), tuple(aux))
            ng = int(ng_dev)    # one blocking fetch (absorbs A)
        if trace:
            print(f"[rowspace] progA+ng {1e3*(_time.perf_counter()-t0):.1f}ms"
                  f" ng={ng}", flush=True)
            t0 = _time.perf_counter()
        out_cap = min(_emit_capacity(max(ng, 1)), cap)
        if len(_OUTCAP_MEMO) >= _OUTCAP_MEMO_MAX:
            _OUTCAP_MEMO.clear()
        _OUTCAP_MEMO[step_key] = out_cap
        lane_names = tuple(sorted(lanes))
        emit_key = cache_key + ("rowspace_emit", out_cap, lane_names,
                                tuple(sorted(kinds.items())))

        def make_emit():
            from ...device.groupby import rowspace_group_emit

            def emit(lanes_):
                gk, gv, aggs, _ng = rowspace_group_emit(lanes_, kinds,
                                                        out_cap)
                return gk, gv, aggs
            return jax.jit(emit)

        jit_b = self._cached(emit_key, make_emit)
        with m.elapsed_compute, m.device_compute:
            state = jit_b(lanes)
            if trace:
                _ = np.asarray(state[0][:1])
                print(f"[rowspace] progB {1e3*(_time.perf_counter()-t0):.1f}"
                      f"ms out_cap={out_cap}", flush=True)
                t0 = _time.perf_counter()
            out = self._emit(state, plan, slot_map, m,
                             key_finalize=finalize)
            if trace:
                print(f"[rowspace] emit {1e3*(_time.perf_counter()-t0):.1f}"
                      f"ms", flush=True)
            return out


class _ChainPairView:
    """Zero-row batch-like view over pair-space columns."""

    def __init__(self, cols):
        self.columns = cols
        self.num_rows = 0


class DeviceJoinChainRowsExec(DeviceJoinChainAggregateExec):
    """Row-RETURNING device join chain (the non-aggregate sibling of
    DeviceJoinChainAggregateExec): same spine + staged-build machinery,
    but instead of grouping, the surviving rows themselves are emitted —
    a mask program walks the chain, ONE scalar fetch reads the match
    count, and a compact program gathers the output columns for just the
    surviving rows. Output columns stay DEVICE-RESIDENT in the Batch
    (Column holds the jax array; host consumers pay one lazy D2H).

    Reference: the probe/emit half of HashJoinExec
    (joins/hash_join.rs:1368 process_probe_batch -> take/emit), executed
    as two compiled XLA programs instead of a per-batch host loop."""

    def __init__(self, probe_source: ExecutionPlan,
                 probe_predicate: Optional[PhysicalExpr],
                 builds: List[ChainBuild],
                 predicate: Optional[PhysicalExpr],
                 out_exprs: List[PhysicalExpr],
                 schema, fallback: ExecutionPlan):
        ExecutionPlan.__init__(self)
        self.source = probe_source
        self.probe_predicate = probe_predicate
        self.builds = builds
        self.predicate = predicate
        self.out_exprs = out_exprs
        self._schema = schema
        self.fallback = fallback
        # inherited helpers expect these
        self.group_exprs = []
        self.aggs = []
        self.max_groups = 0

    def with_children(self, c):
        builds = [ChainBuild(src, b.probe_keys, b.build_keys, b.payload,
                             b.join_type, b.sfilter)
                  for src, b in zip(c[1:], self.builds)]
        return DeviceJoinChainRowsExec(
            c[0], self.probe_predicate, builds, self.predicate,
            self.out_exprs, self._schema, self.fallback)

    def display_line(self):
        steps = ", ".join(
            f"{b.join_type}[{', '.join(str(k) for k in b.probe_keys)}]"
            + (f" filter=({b.sfilter[1]} {b.sfilter[0].value} "
               f"{b.sfilter[2]})" if b.sfilter is not None else "")
            for b in self.builds)
        return (f"DeviceJoinChainRowsExec: chain=[{steps}], "
                f"out=[{', '.join(str(e) for e in self.out_exprs)}]")

    def _sig(self):
        return (
            "join_rows",
            tuple((tuple(str(k) for k in b.probe_keys),
                   tuple(str(k) for k in b.build_keys),
                   tuple(b.payload), b.join_type,
                   None if b.sfilter is None else
                   (str(b.sfilter[0]), str(b.sfilter[1]),
                    str(b.sfilter[2]))) for b in self.builds),
            str(self.probe_predicate), str(self.predicate),
            tuple((str(e), str(e.out_type)) for e in self.out_exprs),
        )

    def _deferred_expr_roots(self):
        return (super()._deferred_expr_roots() + list(self.out_exprs))

    def execute(self, partition: int, ctx: TaskContext):
        self._attach_deferred_ctx(ctx)
        try:
            outs = self._execute_device(partition, ctx)
        except DeviceLoweringUnsupported:
            yield from self.fallback.execute(partition, ctx)
            return
        for b in outs:
            yield b

    # ------------------------------------------------------------------
    def _execute_device(self, partition: int, ctx: TaskContext):
        import jax
        import jax.numpy as jnp
        from ...device.lower import LoweringError, lower_expr

        m = BaselineMetrics(self.metrics, partition)
        from .base import execute_stream

        try:
            ppred_l = lower_expr(self.probe_predicate) \
                if self.probe_predicate is not None else None
            pred_l = lower_expr(self.predicate) \
                if self.predicate is not None else None
            probe_key_ls = []
            sfilter_ls = []
            for b in self.builds:
                for pk, bk in zip(b.probe_keys, b.build_keys):
                    if pk.out_type.is_string or bk.out_type.is_string or \
                            pk.out_type.is_float or bk.out_type.is_float:
                        raise LoweringError("non-integer chain join key")
                probe_key_ls.append([lower_expr(k) for k in b.probe_keys])
                if b.sfilter is not None:
                    op, ocol, pexpr = b.sfilter
                    if not ocol.out_type.is_integer or \
                            pexpr.out_type.is_string:
                        raise LoweringError("semi filter needs int member col")
                    sfilter_ls.append(lower_expr(pexpr))
                else:
                    sfilter_ls.append(None)
            for e in self.out_exprs:
                if e.out_type.is_string and not isinstance(e, ColumnExpr):
                    raise LoweringError("computed string output on device")
            out_ls = [lower_expr(e) for e in self.out_exprs]
        except LoweringError as e:
            raise DeviceLoweringUnsupported(str(e))

        lowereds, seen = [], set()
        for low in ([ppred_l] if ppred_l is not None else []) + \
                ([pred_l] if pred_l is not None else []) + out_ls + \
                [k for ks in probe_key_ls for k in ks] + \
                [s for s in sfilter_ls if s is not None]:
            if id(low) not in seen:
                seen.add(id(low))
                lowereds.append(low)
        aux_offset, off = {}, 0
        for low in lowereds:
            aux_offset[id(low)] = off
            off += len(low.aux)

        staged_builds, host_builds, build_batches, reservation = \
            self._stage_chain_builds(ctx, jax, jnp, m)
        build_meta = [(sb[4], sb[5], sb[6], sb[7], sb[8])
                      for sb in staged_builds]
        build_args = tuple((sb[0], sb[1], sb[2], sb[3])
                           for sb in staged_builds)

        probe_batches = [bt for bt in execute_stream(self.source, ctx)
                         if bt.num_rows]

        # mask/emit programs close over build_meta — key them by it
        cache_key = self._sig() + tuple(
            (sb[4], sb[5], sb[6], sb[7], sb[8]) for sb in staged_builds)
        out_batches = []
        for pb in probe_batches:
            cap = round_capacity(pb.capacity)
            p_cols = tuple(c.data_device_padded(cap) for c in pb.columns)
            p_valids_present = tuple(c.validity_device_padded(cap)
                                     for c in pb.columns if c.has_nulls)
            p_null_layout = tuple(c.has_nulls for c in pb.columns)
            pair_view = self._chain_pair_view([pb], build_batches)
            aux = []
            for low in lowereds:
                for spec in low.aux:
                    aux.append(np.asarray(spec.fn(pair_view)))
            aux = tuple(aux)

            def sub_aux_of(aux_arrs):
                def sub_aux(low):
                    o = aux_offset[id(low)]
                    return aux_arrs[o:o + len(low.aux)]
                return sub_aux

            def make_pair(full_cols, present_valids, n):
                pair_cols = list(full_cols)
                pair_valids = []
                vi = 0
                for c, has in zip(full_cols, p_null_layout):
                    if has:
                        pair_valids.append(present_valids[vi])
                        vi += 1
                    else:
                        pair_valids.append(jnp.ones(n, bool))
                return pair_cols, pair_valids

            def mask_prog(full_cols, present_valids, bargs, num_rows, a):
                sub_aux = sub_aux_of(a)
                pair_cols, pair_valids = make_pair(full_cols,
                                                   present_valids, cap)
                row_valid = jnp.arange(cap) < num_rows
                if ppred_l is not None:
                    d, v = ppred_l.trace(tuple(pair_cols),
                                         tuple(pair_valids),
                                         sub_aux(ppred_l))
                    row_valid = row_valid & d
                    if v is not None:
                        row_valid = row_valid & v
                row_valid = self._chain_walk(
                    jnp, cap, pair_cols, pair_valids, row_valid,
                    bargs, build_meta, sub_aux, probe_key_ls, sfilter_ls)
                if pred_l is not None:
                    d, v = pred_l.trace(tuple(pair_cols),
                                        tuple(pair_valids), sub_aux(pred_l))
                    row_valid = row_valid & d
                    if v is not None:
                        row_valid = row_valid & v
            # keep only the SPINE-width mask: gathered pair columns are
            # recomputed compactly by the emit program
                return row_valid[:cap], jnp.sum(row_valid.astype(jnp.int64))

            jm = self._cached(
                cache_key + ("mask", p_null_layout, cap),
                lambda: jax.jit(mask_prog))
            m.record_bytes(pb.num_rows * (
                sum(int(c.dtype.device_dtype().itemsize)
                    for c in pb.columns)
                + sum(1 for c in pb.columns if c.has_nulls)))
            with m.elapsed_compute, m.device_compute:
                row_valid, total = jm(p_cols, p_valids_present, build_args,
                                      np.int64(pb.num_rows), aux)
                total = int(total)   # the one scalar fetch per batch
            if total == 0:
                continue
            out_cap = round_capacity(total)

            def emit_prog(full_cols, present_valids, bargs, rv, a):
                sub_aux = sub_aux_of(a)
                csum = jnp.cumsum(rv.astype(jnp.int64))
                j = jnp.arange(out_cap)
                rid = jnp.searchsorted(csum, j, side="right", method="sort")
                ridc = jnp.clip(rid, 0, cap - 1)
                sliced = tuple(c[ridc] for c in full_cols)
                sliced_v = tuple(v[ridc] for v in present_valids)
                pair_cols, pair_valids = make_pair(sliced, sliced_v,
                                                   out_cap)
                ok = j < csum[cap - 1]
                # re-walk the chain on the compacted rows: every gather
                # now costs out_cap, not cap
                ok = self._chain_walk(
                    jnp, out_cap, pair_cols, pair_valids, ok,
                    bargs, build_meta, sub_aux, probe_key_ls, sfilter_ls)
                outs = []
                for low in out_ls:
                    d, v = low.trace(tuple(pair_cols), tuple(pair_valids),
                                     sub_aux(low))
                    outs.append((d, v))
                return tuple(outs)

            je = self._cached(
                cache_key + ("emit", p_null_layout, cap, out_cap),
                lambda: jax.jit(emit_prog))
            width = sum(int(e.out_type.device_dtype().itemsize)
                        for e in self.out_exprs)
            m.record_bytes(out_cap * (width + 8))
            with m.elapsed_compute, m.device_compute:
                outs = je(p_cols, p_valids_present, build_args, row_valid,
                          aux)

            cols = []
            for e, (d, v) in zip(self.out_exprs, outs):
                dic = None
                if e.out_type.is_string and isinstance(e, ColumnExpr):
                    dic = pair_view.columns[e.index].dictionary
                cols.append(Column(e.out_type, d, v, dic))
            batch = Batch(self._schema, cols, total)
            m.record_output(total)
            out_batches.append(batch)

        # hold the reservation until results are materialized
        self._reservation = reservation
        return out_batches
