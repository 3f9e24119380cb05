"""Distributed (multi-chip) aggregation through the SQL planner.

Reference parity: the reference scales aggregation by hash-repartitioning
partial states between tasks (`RepartitionExec` + AggregateMode
Partial/FinalPartitioned, SURVEY.md §2.6.3-4).  Here the exchange is a
mesh collective instead of a channel: rows are sharded over a
`jax.sharding.Mesh`, every shard computes a fixed-size partial group
table, the tables `all_gather` over the mesh, and each shard reduces the
groups it owns (hash % n_shards) — see `parallel/distributed.py`.

`DistributedAggregateExec` is the planner-visible operator: enabled with
``SET datafusion.tpu.mesh_devices = N`` (N > 1).  Group keys and
aggregate arguments are evaluated with the host expression kernels, rows
are padded to a multiple of the mesh size, and the SPMD program does the
grouping, reduction, and exchange.  Anything it cannot shard falls back
to the single-device / host paths like every other device operator.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ...common import dt
from ...common.batch import Batch, concat_batches
from ...runtime import BaselineMetrics, TaskContext
from .. import kernels as K
from .base import execute_stream
from .device_aggregate import (
    DeviceGroupAggregateExec, DeviceLoweringUnsupported, _PackPlan,
)

_MAX_KEY_BITS = 62


def _sol_bytes(m, *arrays):
    """SOL accounting: device bytes touched by a distributed program —
    every staged operand array read once (collective traffic counted by
    the exchange itself)."""
    total = 0
    def one(v):
        if isinstance(v, tuple):          # ("kind", array) value slots
            v = v[-1]
        return int(np.asarray(v).nbytes)
    for a in arrays:
        if a is None:
            continue
        if isinstance(a, dict):
            total += sum(one(v) for v in a.values())
        else:
            total += one(a)
    m.record_bytes(total)


class DistributedAggregateExec(DeviceGroupAggregateExec):
    """Single-phase aggregate executed SPMD over an N-device mesh."""

    def __init__(self, *args, mesh_devices: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh_devices = mesh_devices

    def with_children(self, c):
        return DistributedAggregateExec(
            c[0], self.predicate, self.group_exprs, self.aggs, self._schema,
            self.fallback, self.max_groups, mesh_devices=self.mesh_devices)

    # ------------------------------------------------------------------
    def _execute_device(self, partition: int, ctx: TaskContext) -> Optional[Batch]:
        from ...parallel.distributed import (
            distributed_group_aggregate, make_mesh,
        )

        m = BaselineMetrics(self.metrics, partition)
        batches = [b for b in execute_stream(self.source, ctx) if b.num_rows]
        if not batches:
            batch = None
        elif len(batches) == 1:
            batch = batches[0].compact()   # device-born: capacity-padded
        else:
            batch = concat_batches(batches[0].schema, batches)

        n = batch.num_rows if batch is not None else 0

        # ---- host evaluation of keys / predicate / agg args --------------
        if batch is not None:
            row_valid = np.ones(n, bool)
            if self.predicate is not None:
                row_valid = K.true_mask(self.predicate.evaluate(batch))
            key_cols = [e.evaluate(batch) for e, _ in self.group_exprs]
        else:
            row_valid = np.zeros(0, bool)
            key_cols = []

        plan = self._host_pack_plan(key_cols)
        packed = self._host_pack(key_cols, plan, n)

        # ---- slot layout (same dedup scheme as the fused device exec) ----
        slot_defs = {}     # slot -> (kind, arg expr or None)
        slot_map = {}
        uniq: Dict[tuple, str] = {}

        def _slot(cat, sig, suffix, arg):
            key = (cat, sig)
            if key not in uniq:
                uniq[key] = f"v{len(uniq)}{suffix}"
                slot_defs[uniq[key]] = (cat, arg)
            return uniq[key]

        for a in self.aggs:
            kind = "avg" if a.name == "mean" else a.name
            if kind not in ("count", "sum", "avg", "min", "max"):
                raise DeviceLoweringUnsupported(kind)
            if a.filter is not None or a.distinct:
                raise DeviceLoweringUnsupported("agg FILTER/DISTINCT")
            if kind in ("min", "max") and a.out_type.is_string:
                raise DeviceLoweringUnsupported("string min/max")
            arg = a.args[0] if a.args else None
            sig = str(a.args[0]) if a.args else "*"
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
            slot_map[a.display] = m_

        values: Dict[str, tuple] = {}
        for slot, (cat, arg) in slot_defs.items():
            if arg is None:
                values[slot] = ("count", np.zeros(n, np.int64))
                continue
            c = arg.evaluate(batch) if batch is not None else None
            av = K.valid_mask(c) if c is not None else np.zeros(0, bool)
            data = c.data_host() if c is not None else np.zeros(0)
            if cat in ("sum", "cnt"):
                if cat == "cnt":
                    values[slot] = ("sum", av.astype(np.int64))
                else:
                    x = data.astype(np.int64) if arg.out_type.is_decimal \
                        else data.astype(np.float64)
                    values[slot] = ("sum", np.where(av, x, 0))
            else:
                x = data.astype(np.float64) if not arg.out_type.is_decimal \
                    else data.astype(np.int64)
                if x.dtype.kind == "f":
                    sentinel = np.inf if cat == "min" else -np.inf
                else:
                    info = np.iinfo(np.int64)
                    sentinel = info.max if cat == "min" else info.min
                values[slot] = (cat, np.where(av, x, sentinel))

        # ---- shard: pad rows to a multiple of the mesh size ---------------
        n_dev = self.mesh_devices
        pad = (-n) % n_dev if n else n_dev
        if pad:
            packed = np.concatenate([packed, np.full(pad, -1, np.int64)])
            row_valid = np.concatenate([row_valid, np.zeros(pad, bool)])
            values = {s: (k, np.concatenate([a, np.zeros(pad, a.dtype)]))
                      for s, (k, a) in values.items()}

        key_space = 1 << sum(plan.bits)
        # statistics-driven exchange selection (reference analog:
        # enforce_distribution picks Hash repartition by cardinality):
        # - small key space -> broadcast all_gather of the whole table
        #   (one fixed table, cheapest collective)
        # - larger -> owned-slot all_to_all, whose global capacity scales
        #   as n_dev * per-shard table (parallel/exchange.py)
        broadcast_limit = min(self.max_groups, _BROADCAST_GROUP_LIMIT)
        if key_space > n_dev * self.max_groups:
            raise DeviceLoweringUnsupported(
                f"key space {key_space} exceeds mesh group capacity "
                f"{n_dev}x{self.max_groups}")

        mesh = make_mesh(n_dev)
        if key_space <= broadcast_limit:
            _sol_bytes(m, packed, row_valid, values)
            with m.elapsed_compute, m.device_compute:
                gk, gv, aggs = distributed_group_aggregate(
                    mesh, packed, row_valid, values, key_space)
        else:
            from ...parallel.exchange import (
                distributed_shuffle_group_aggregate)
            # CHAINED exchange (parallel/exchange.py): slot transport can
            # no longer overflow — skew adds while_loop rounds inside ONE
            # compiled program, never a recompile. The partial table is
            # sized >= local rows (cannot overflow); the final table gets
            # 2x slack for hash-ownership variance, and a genuine
            # overflow (distinct groups beyond mesh capacity) falls back
            # instead of retrying with a new shape.
            final_per_shard = max(64, _next_pow2(-(-key_space // n_dev)))
            partial = min(key_space,
                          max(final_per_shard, _next_pow2(
                              max(1, len(packed) // n_dev))))
            _sol_bytes(m, packed, row_valid, values)
            with m.elapsed_compute, m.device_compute:
                gk, gv, aggs, ovf = distributed_shuffle_group_aggregate(
                    mesh, packed, row_valid, values,
                    partial_groups=partial,
                    final_groups_per_shard=min(key_space,
                                               2 * final_per_shard),
                    slot_cap=min(partial, max(1, 4 * partial // n_dev)))
            if ovf:
                raise DeviceLoweringUnsupported(
                    "mesh final group tables exceeded")
        keys_np = np.asarray(gk)
        valid_np = np.asarray(gv)
        aggs_np = {s: np.asarray(a) for s, a in aggs.items()}

        if n == 0:
            keys_np = None
            valid_np = None
            aggs_np = {}
        out = self._emit_arrays(keys_np, valid_np, aggs_np, plan, slot_map, m)
        if out is not None:
            m.record_output(out.num_rows)
        return out

    # ------------------------------------------------------------------
    def _host_pack_plan(self, key_cols) -> _PackPlan:
        offsets, bits, types, dicts = [], [], [], []
        for c in key_cols:
            types.append(c.dtype)
            if c.dtype.is_string:
                size = len(c.dictionary.values) if c.dictionary is not None else 0
                offsets.append(0)
                bits.append(max(int(size + 1).bit_length(), 1))
                dicts.append(c.dictionary)
                continue
            dicts.append(None)
            if c.dtype.is_boolean:
                offsets.append(0)
                bits.append(2)
                continue
            if not (c.dtype.is_integer or c.dtype.is_decimal or
                    c.dtype.id.value in ("date", "timestamp", "time")):
                raise DeviceLoweringUnsupported(
                    f"group key type {c.dtype} on mesh")
            data = c.data_host()
            v = c.validity_host()
            vals = data[v] if v is not None else data
            lo = int(vals.min()) if len(vals) else 0
            hi = int(vals.max()) if len(vals) else 0
            offsets.append(lo)
            bits.append(max(int(hi - lo + 1).bit_length() + 1, 2))
        if sum(bits) > _MAX_KEY_BITS:
            raise DeviceLoweringUnsupported("group key space too wide")
        return _PackPlan(offsets, bits, types, dicts)

    def _host_pack(self, key_cols, plan: _PackPlan, n: int) -> np.ndarray:
        packed = np.zeros(n, np.int64)
        shift = 0
        for i, c in enumerate(key_cols):
            data = c.data_host()
            v = c.validity_host()
            if c.dtype.is_string:
                raw = data.astype(np.int64) + 1
            elif c.dtype.is_boolean:
                raw = data.astype(np.int64) + 1
            else:
                raw = data.astype(np.int64) - plan.offsets[i] + 1
            if v is not None:
                raw = np.where(v, raw, 0)
            packed |= raw << shift
            shift += plan.bits[i]
        return packed

    def display_line(self):
        base = super().display_line()
        return base.replace("DeviceGroupAggregate",
                            f"DistributedAggregate(mesh={self.mesh_devices})")


# key spaces at or below this broadcast the whole table; larger ones take
# the owned-slot all_to_all (statistics-driven exchange selection)
_BROADCAST_GROUP_LIMIT = 1 << 13


def _next_pow2(n: int) -> int:
    return 1 << max(int(n - 1).bit_length(), 4)


class DistributedJoinAggregateExec(DistributedAggregateExec):
    """Broadcast hash join + two-phase aggregation SPMD over the mesh.

    Planner-visible distributed join (SURVEY.md §2.6.5 CollectLeft):
    the compacted build side is replicated over the mesh, probe rows
    shard, matches expand into a fixed lane space, and group tables
    exchange over the mesh exactly like `DistributedAggregateExec`.
    Constructor mirrors `DeviceJoinAggregateExec`: group/agg/pair
    expressions live in the pair column space (build cols 0..nb-1,
    probe cols nb..).
    """

    def __init__(self, build_source, probe_source, build_keys, probe_keys,
                 build_predicate, probe_predicate, predicate,
                 group_exprs, aggs, schema, fallback,
                 max_groups: int = 1 << 20, mesh_devices: int = 0,
                 broadcast_threshold_rows: int = 131072):
        from .base import ExecutionPlan as _EP
        _EP.__init__(self)
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
        self.mesh_devices = mesh_devices
        # reference: hash_join_single_partition_threshold_rows — below this
        # the build side broadcasts (CollectLeft); above it, partitioned
        self.broadcast_threshold_rows = broadcast_threshold_rows
        self._n_build_cols = len(build_source.schema())

    def children(self):
        return [self.build_source, self.probe_source]

    def with_children(self, c):
        return DistributedJoinAggregateExec(
            c[0], c[1], self.build_keys, self.probe_keys,
            self.build_predicate, self.probe_predicate, self.predicate,
            self.group_exprs, self.aggs, self._schema, self.fallback,
            self.max_groups, mesh_devices=self.mesh_devices,
            broadcast_threshold_rows=self.broadcast_threshold_rows)

    def display_line(self):
        on = ", ".join(f"({l} = {r})" for l, r in
                       zip(self.build_keys, self.probe_keys))
        gb = ", ".join(n for _, n in self.group_exprs)
        ag = ", ".join(a.display for a in self.aggs)
        return (f"DistributedJoinAggregate(mesh={self.mesh_devices}): "
                f"on=[{on}], gby=[{gb}], aggr=[{ag}]")

    # ------------------------------------------------------------------
    def _side_of(self, e) -> str:
        nb = self._n_build_cols
        idxs = e.column_indices()
        if not idxs:
            return "p"            # literals ride the probe side
        if all(i < nb for i in idxs):
            return "b"
        if all(i >= nb for i in idxs):
            return "p"
        raise DeviceLoweringUnsupported("expression spans both join sides")

    def _to_side(self, e, side: str):
        """Rewrite a pair-space expr into the side's source column space."""
        from ..expressions import ColumnExpr, rewrite_columns
        nb = self._n_build_cols
        bs, ps = self.build_source.schema(), self.probe_source.schema()
        repl = [ColumnExpr(i if side == "b" else 0, f.name, f.dtype)
                for i, f in enumerate(bs)] + \
               [ColumnExpr(i if side == "p" else 0, f.name, f.dtype)
                for i, f in enumerate(ps)]
        return rewrite_columns(e, repl)

    @staticmethod
    def _collect_side(source, ctx) -> Optional[Batch]:
        batches = [b for b in execute_stream(source, ctx) if b.num_rows]
        if not batches:
            return None
        if len(batches) == 1:
            return batches[0].compact()    # device-born: capacity-padded
        return concat_batches(batches[0].schema, batches)

    # ------------------------------------------------------------------
    def _execute_device(self, partition: int, ctx: TaskContext) -> Optional[Batch]:
        from ...parallel.distributed import (
            distributed_join_group_aggregate, make_mesh,
        )
        m = BaselineMetrics(self.metrics, partition)
        bb = self._collect_side(self.build_source, ctx)
        pb = self._collect_side(self.probe_source, ctx)
        if bb is None or pb is None:
            raise DeviceLoweringUnsupported("empty join side on mesh")

        # ---- residual pair predicate folds into one side ------------------
        bpred, ppred = self.build_predicate, self.probe_predicate
        if self.predicate is not None:
            side = self._side_of(self.predicate)
            p = self._to_side(self.predicate, side)
            if side == "b":
                bpred = p if bpred is None else _and_expr(bpred, p)
            else:
                ppred = p if ppred is None else _and_expr(ppred, p)

        # ---- compact both sides host-side ---------------------------------
        def compact(batch, pred):
            if pred is None:
                return batch
            mask = K.true_mask(pred.evaluate(batch))
            idx = np.nonzero(mask)[0]
            return Batch(batch.schema,
                         [c.take_host(idx) for c in batch.columns], len(idx))

        bb = compact(bb, bpred)
        pb = compact(pb, ppred)
        if bb.num_rows == 0 or pb.num_rows == 0:
            raise DeviceLoweringUnsupported("empty join side on mesh")

        # ---- equi-key packing (joint plan over both sides) ----------------
        bk_cols = [k.evaluate(bb) for k in self.build_keys]
        pk_cols = [k.evaluate(pb) for k in self.probe_keys]
        bkeys = np.zeros(bb.num_rows, np.int64)
        pkeys = np.zeros(pb.num_rows, np.int64)
        bvalid = np.ones(bb.num_rows, bool)
        pvalid = np.ones(pb.num_rows, bool)
        shift = 0
        for bc, pc in zip(bk_cols, pk_cols):
            if bc.dtype.is_string and pc.dtype.is_string:
                bc, pc = K.unify_dictionaries(bc, pc)
                braw = bc.data_host().astype(np.int64)
                praw = pc.data_host().astype(np.int64)
                lo, hi = 0, max(len(bc.dictionary.values) - 1, 0)
            elif (bc.dtype.is_integer or bc.dtype.is_decimal or
                  bc.dtype.is_boolean or
                  bc.dtype.id.value in ("date", "timestamp", "time")):
                braw = bc.data_host().astype(np.int64)
                praw = pc.data_host().astype(np.int64)
                bv, pv = bc.validity_host(), pc.validity_host()
                bvals = braw[bv] if bv is not None else braw
                pvals = praw[pv] if pv is not None else praw
                lo = min(int(bvals.min()) if len(bvals) else 0,
                         int(pvals.min()) if len(pvals) else 0)
                hi = max(int(bvals.max()) if len(bvals) else 0,
                         int(pvals.max()) if len(pvals) else 0)
            else:
                raise DeviceLoweringUnsupported(
                    f"join key type {bc.dtype} on mesh")
            bits = max(int(hi - lo + 1).bit_length(), 1)
            if shift + bits > _MAX_KEY_BITS:
                raise DeviceLoweringUnsupported("join key space too wide")
            for raw, col, keys, valid in ((braw, bc, bkeys, bvalid),
                                          (praw, pc, pkeys, pvalid)):
                v = col.validity_host()
                if v is not None:
                    valid &= v
                keys |= np.clip(raw - lo, 0, (1 << bits) - 1) << shift
            shift += bits

        # ---- group keys: evaluate per side, pack with global shifts -------
        sides = [self._side_of(e) for e, _ in self.group_exprs]
        key_cols = [self._to_side(e, s).evaluate(bb if s == "b" else pb)
                    for (e, _), s in zip(self.group_exprs, sides)]
        plan = self._host_pack_plan(key_cols)
        key_space = 1 << sum(plan.bits)
        if key_space > self.max_groups:
            raise DeviceLoweringUnsupported(
                f"key space {key_space} exceeds mesh group table")
        bgroup = np.zeros(bb.num_rows, np.int64)
        pgroup = np.zeros(pb.num_rows, np.int64)
        gshift = 0
        for i, (c, s) in enumerate(zip(key_cols, sides)):
            data = c.data_host()
            v = c.validity_host()
            if c.dtype.is_string or c.dtype.is_boolean:
                raw = data.astype(np.int64) + 1
            else:
                raw = data.astype(np.int64) - plan.offsets[i] + 1
            if v is not None:
                raw = np.where(v, raw, 0)
            (bgroup if s == "b" else pgroup)[:] |= raw << gshift
            gshift += plan.bits[i]

        # ---- aggregate slots (same scheme as DistributedAggregateExec) ----
        slot_defs, slot_map, uniq = {}, {}, {}

        def _slot(cat, sig, suffix, arg):
            key = (cat, sig)
            if key not in uniq:
                uniq[key] = f"v{len(uniq)}{suffix}"
                slot_defs[uniq[key]] = (cat, arg)
            return uniq[key]

        for a in self.aggs:
            kind = "avg" if a.name == "mean" else a.name
            if kind not in ("count", "sum", "avg", "min", "max"):
                raise DeviceLoweringUnsupported(kind)
            if a.filter is not None or a.distinct:
                raise DeviceLoweringUnsupported("agg FILTER/DISTINCT")
            if kind in ("min", "max") and a.out_type.is_string:
                raise DeviceLoweringUnsupported("string min/max")
            arg = a.args[0] if a.args else None
            sig = str(a.args[0]) if a.args else "*"
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
            slot_map[a.display] = m_

        sb_values, p_values = {}, {}
        kinds, fills = {}, {}
        for slot, (cat, arg) in slot_defs.items():
            if arg is None:                     # count(*): one per pair
                p_values[slot] = np.ones(pb.num_rows, np.int64)
                kinds[slot], fills[slot] = "sum", 0
                continue
            s = self._side_of(arg)
            c = self._to_side(arg, s).evaluate(bb if s == "b" else pb)
            av = K.valid_mask(c)
            data = c.data_host()
            if cat in ("sum", "cnt"):
                if cat == "cnt":
                    arr = av.astype(np.int64)
                else:
                    arr = data.astype(np.int64) if c.dtype.is_decimal else \
                        data.astype(np.float64)
                    arr = np.where(av, arr, 0)
                kinds[slot], fills[slot] = "sum", 0
            else:
                arr = data.astype(np.int64) if c.dtype.is_decimal else \
                    data.astype(np.float64)
                if arr.dtype.kind == "f":
                    sentinel = np.inf if cat == "min" else -np.inf
                else:
                    info = np.iinfo(np.int64)
                    sentinel = info.max if cat == "min" else info.min
                arr = np.where(av, arr, sentinel)
                kinds[slot], fills[slot] = cat, sentinel
            (sb_values if s == "b" else p_values)[slot] = arr

        # ---- build side: drop NULL-key rows, sort by key, pad to bucket ---
        bsel = np.nonzero(bvalid)[0]
        if len(bsel) == 0:
            raise DeviceLoweringUnsupported("empty join side on mesh")
        nb_real = len(bsel)
        bkeys = bkeys[bsel]
        order = np.argsort(bkeys, kind="stable")
        bkeys = bkeys[order]
        bgroup = bgroup[bsel][order]
        sb_values = {k: v[bsel][order] for k, v in sb_values.items()}
        # exact max key multiplicity = the lane fanout the kernel needs
        from ..hashing import _dense_codes
        codes, ncodes = _dense_codes(bkeys)
        fanout = int(np.bincount(codes, minlength=max(ncodes, 1)).max())
        if fanout > 64:
            raise DeviceLoweringUnsupported(f"build fanout {fanout} > 64")
        nb_pad = _next_pow2(len(bkeys))
        if nb_pad > len(bkeys):
            pad = nb_pad - len(bkeys)
            bkeys = np.concatenate(
                [bkeys, np.full(pad, np.iinfo(np.int64).max)])
            bgroup = np.concatenate([bgroup, np.zeros(pad, np.int64)])
            sb_values = {k: np.concatenate([v, np.zeros(pad, v.dtype)])
                         for k, v in sb_values.items()}

        # ---- probe side: compact valid rows, pad to mesh bucket -----------
        psel = np.nonzero(pvalid)[0]
        if len(psel) == 0:
            raise DeviceLoweringUnsupported("empty join side on mesh")
        pkeys = pkeys[psel]
        pgroup = pgroup[psel]
        p_values = {k: v[psel] for k, v in p_values.items()}
        n_dev = self.mesh_devices
        np_pad = max(_next_pow2(len(pkeys)), n_dev)
        np_pad += (-np_pad) % n_dev
        pvalid2 = np.ones(len(pkeys), bool)
        if np_pad > len(pkeys):
            pad = np_pad - len(pkeys)
            pkeys = np.concatenate([pkeys, np.full(pad, -1, np.int64)])
            pgroup = np.concatenate([pgroup, np.zeros(pad, np.int64)])
            pvalid2 = np.concatenate([pvalid2, np.zeros(pad, bool)])
            p_values = {k: np.concatenate([v, np.zeros(pad, v.dtype)])
                        for k, v in p_values.items()}

        mesh = make_mesh(n_dev)
        # ---- statistics-driven join strategy ------------------------------
        # broadcast (CollectLeft) while the build side is small; the
        # PARTITIONED all_to_all join when it is not (reference:
        # join_selection.rs:314-358 via hash_join_single_partition_threshold;
        # here the row-count form of the same decision)
        if nb_real <= self.broadcast_threshold_rows:
            _sol_bytes(m, bkeys, bgroup, sb_values, pkeys, pvalid2, pgroup,
                       p_values)
            with m.elapsed_compute, m.device_compute:
                gk, gv, aggs = distributed_join_group_aggregate(
                    mesh, bkeys, bgroup, sb_values, pkeys, pvalid2, pgroup,
                    p_values, kinds, fills, key_space, fanout)
        else:
            from ...parallel.exchange import (
                distributed_partitioned_join_aggregate, host_owner)
            # re-shard the (sorted, padded) build side over rows
            bvalid2 = bkeys != np.iinfo(np.int64).max
            nb_pad2 = len(bkeys) + ((-len(bkeys)) % n_dev)
            if nb_pad2 > len(bkeys):
                extra = nb_pad2 - len(bkeys)
                bkeys = np.concatenate(
                    [bkeys, np.full(extra, np.iinfo(np.int64).max)])
                bgroup = np.concatenate([bgroup, np.zeros(extra, np.int64)])
                bvalid2 = np.concatenate([bvalid2, np.zeros(extra, bool)])
                sb_values = {k: np.concatenate([v, np.zeros(extra, v.dtype)])
                             for k, v in sb_values.items()}
            final_per_shard = max(64, _next_pow2(-(-key_space // n_dev)))
            nb_loc = len(bkeys) // n_dev
            np_loc = len(pkeys) // n_dev
            # The probe side streams through the CHAINED exchange (skew =
            # more while_loop rounds inside one program, never a bigger
            # shape), so salting is pure LOAD BALANCE now: spread a hot
            # probe key's join work over `salt` shards. Salted keys pack
            # as key*salt+s, so wide keys cannot salt.
            kmax = int(bkeys[bvalid2].max()) if bvalid2.any() else 0
            vpk = pkeys[pvalid2]
            salt = 1
            if len(vpk) and kmax <= (1 << 59):
                _, cnts = np.unique(vpk, return_counts=True)
                hot = int(cnts.max())
                avg = max(1, len(vpk) // n_dev)
                if hot > 2 * avg:
                    salt = int(min(_next_pow2(-(-hot // avg)), n_dev, 8))
            # build receive capacity: EXACT per-(sender, owner) counts from
            # the host-resident keys — no guessing, no retry
            senders = np.arange(len(bkeys)) // max(nb_loc, 1)
            per = np.zeros((n_dev, n_dev), np.int64)
            for r in range(salt):     # all replicas ship in ONE exchange
                own_r = host_owner(
                    bkeys, n_dev,
                    np.full(len(bkeys), r, np.uint64) if salt > 1 else None)
                own_r = np.where(bvalid2, own_r, n_dev)
                cnt = np.bincount(senders * (n_dev + 1) + own_r,
                                  minlength=n_dev * (n_dev + 1))
                per += cnt.reshape(n_dev, n_dev + 1)[:, :n_dev]
            build_cap = _next_pow2(int(per.max()) + 8)
            _sol_bytes(m, bkeys, bvalid2, bgroup, sb_values, pkeys,
                       pvalid2, pgroup, p_values)
            with m.elapsed_compute, m.device_compute:
                gk, gv, aggs, ovf = distributed_partitioned_join_aggregate(
                    mesh, bkeys, bvalid2, bgroup, sb_values,
                    pkeys, pvalid2, pgroup, p_values, kinds, fills,
                    final_groups_per_shard=min(key_space,
                                               2 * final_per_shard),
                    build_cap=build_cap,
                    probe_cap=_next_pow2(max(8, 4 * np_loc // n_dev)),
                    fanout_cap=fanout, salt=salt)
            if ovf:
                raise DeviceLoweringUnsupported(
                    "partitioned join capacity exceeded on mesh")
        keys_np = np.asarray(gk)
        valid_np = np.asarray(gv)
        aggs_np = {s: np.asarray(a) for s, a in aggs.items()}
        out = self._emit_arrays(keys_np, valid_np, aggs_np, plan, slot_map, m)
        if out is not None:
            m.record_output(out.num_rows)
        return out


def _and_expr(a, b):
    from ...common import dt as _dt
    from ...expr.operator import Op
    from ..expressions import BinaryPhysExpr
    return BinaryPhysExpr(a, Op.AND, b, _dt.BOOL)
