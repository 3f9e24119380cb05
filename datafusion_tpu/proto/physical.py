"""Physical-plan serialization (JSON tree).

Reference parity: `datafusion/proto/src/physical_plan` / the
PhysicalPlanNode message (`datafusion.proto:713-760` — ParquetScan,
HashJoin, Repartition, Aggregate, Filter, Projection, Sort, Limit,
Coalesce...). JSON instead of protobuf: the same tree structure without
codegen.

Table scans serialize by NAME and re-resolve against the RECEIVING
process's catalog — the same contract as the reference's shipped
ParquetScan file groups: each executor binds the scan to its local
shard of the data.
"""
from __future__ import annotations

from typing import Any, Dict

from ..expr.operator import Op
from .logical import (dtype_from_dict, dtype_to_dict, scalar_from_dict,
                      scalar_to_dict)


def schema_to_dict(schema) -> Dict[str, Any]:
    return {"fields": [
        {"name": f.name, "t": dtype_to_dict(f.dtype),
         "nullable": f.nullable, "qualifier": f.qualifier,
         "pk": f.primary_key} for f in schema]}


def schema_from_dict(d: Dict[str, Any]):
    from ..common.schema import Field, Schema
    return Schema([Field(f["name"], dtype_from_dict(f["t"]),
                         f["nullable"], f["qualifier"], f["pk"])
                   for f in d["fields"]])


# ---- physical expressions -------------------------------------------------

def pexpr_to_dict(e) -> Dict[str, Any]:
    from ..physical import expressions as X
    if isinstance(e, X.ColumnExpr):
        return {"k": "col", "i": e.index, "name": e.name,
                "t": dtype_to_dict(e.out_type)}
    if isinstance(e, X.LiteralExpr):
        return {"k": "lit", "v": scalar_to_dict(e.value)}
    if isinstance(e, X.BinaryPhysExpr):
        return {"k": "bin", "op": e.op.name,
                "l": pexpr_to_dict(e.left), "r": pexpr_to_dict(e.right),
                "t": dtype_to_dict(e.out_type)}
    if isinstance(e, X.NotExpr):
        return {"k": "not", "e": pexpr_to_dict(e.expr)}
    if isinstance(e, X.NegativeExpr):
        return {"k": "neg", "e": pexpr_to_dict(e.expr)}
    if isinstance(e, X.IsNullExpr):
        return {"k": "isnull", "e": pexpr_to_dict(e.expr),
                "neg": e.negated}
    if isinstance(e, X.CastExpr):
        return {"k": "cast", "e": pexpr_to_dict(e.expr),
                "t": dtype_to_dict(e.out_type), "safe": e.safe}
    if isinstance(e, X.CaseExpr):
        return {"k": "case",
                "op": pexpr_to_dict(e.operand) if e.operand is not None
                else None,
                "whens": [[pexpr_to_dict(w), pexpr_to_dict(t)]
                          for w, t in e.whens],
                "else": pexpr_to_dict(e.else_) if e.else_ is not None
                else None,
                "t": dtype_to_dict(e.out_type)}
    if isinstance(e, X.InListExpr):
        return {"k": "inlist", "e": pexpr_to_dict(e.expr),
                "items": [pexpr_to_dict(i) for i in e.items],
                "neg": e.negated}
    if isinstance(e, X.LikeExpr):
        return {"k": "like", "e": pexpr_to_dict(e.expr),
                "pat": pexpr_to_dict(e.pattern), "neg": e.negated,
                "ci": e.case_insensitive, "esc": e.escape}
    if isinstance(e, X.ScalarFunctionExpr):
        return {"k": "fn", "name": e.name,
                "args": [pexpr_to_dict(a) for a in e.args],
                "t": dtype_to_dict(e.out_type)}
    raise NotImplementedError(
        f"physical expr serialization for {type(e).__name__}")


def pexpr_from_dict(d: Dict[str, Any]):
    from ..physical import expressions as X
    k = d["k"]
    if k == "col":
        return X.ColumnExpr(d["i"], d["name"], dtype_from_dict(d["t"]))
    if k == "lit":
        return X.LiteralExpr(scalar_from_dict(d["v"]))
    if k == "bin":
        return X.BinaryPhysExpr(pexpr_from_dict(d["l"]), Op[d["op"]],
                                pexpr_from_dict(d["r"]),
                                dtype_from_dict(d["t"]))
    if k == "not":
        return X.NotExpr(pexpr_from_dict(d["e"]))
    if k == "neg":
        return X.NegativeExpr(pexpr_from_dict(d["e"]))
    if k == "isnull":
        return X.IsNullExpr(pexpr_from_dict(d["e"]), d["neg"])
    if k == "cast":
        return X.CastExpr(pexpr_from_dict(d["e"]), dtype_from_dict(d["t"]),
                          d["safe"])
    if k == "case":
        return X.CaseExpr(
            pexpr_from_dict(d["op"]) if d["op"] is not None else None,
            [(pexpr_from_dict(w), pexpr_from_dict(t))
             for w, t in d["whens"]],
            pexpr_from_dict(d["else"]) if d["else"] is not None else None,
            dtype_from_dict(d["t"]))
    if k == "inlist":
        return X.InListExpr(pexpr_from_dict(d["e"]),
                            [pexpr_from_dict(i) for i in d["items"]],
                            d["neg"])
    if k == "like":
        return X.LikeExpr(pexpr_from_dict(d["e"]),
                          pexpr_from_dict(d["pat"]), d["neg"], d["ci"],
                          d["esc"])
    if k == "fn":
        return X.ScalarFunctionExpr(d["name"],
                                    [pexpr_from_dict(a) for a in d["args"]],
                                    dtype_from_dict(d["t"]))
    raise NotImplementedError(f"physical expr tag {k}")


def _sort_to_dict(s) -> Dict[str, Any]:
    return {"e": pexpr_to_dict(s.expr), "asc": s.asc,
            "nf": s.nulls_first}


def _sort_from_dict(d):
    from ..physical.plan.sort import PhysSortExpr
    return PhysSortExpr(pexpr_from_dict(d["e"]), d["asc"], d["nf"])


def _agg_to_dict(a) -> Dict[str, Any]:
    return {"name": a.name, "args": [pexpr_to_dict(x) for x in a.args],
            "t": dtype_to_dict(a.out_type), "display": a.display,
            "distinct": a.distinct,
            "filter": pexpr_to_dict(a.filter) if a.filter is not None
            else None,
            "count_star": a.count_star,
            "order_by": [_sort_to_dict(s) for s in a.order_by],
            "ignore_nulls": a.ignore_nulls}


def _agg_from_dict(d):
    from ..physical.plan.aggregate import PhysAggregateExpr
    return PhysAggregateExpr(
        d["name"], [pexpr_from_dict(x) for x in d["args"]],
        dtype_from_dict(d["t"]), d["display"], distinct=d["distinct"],
        filter=pexpr_from_dict(d["filter"]) if d["filter"] is not None
        else None,
        count_star=d["count_star"],
        order_by=[_sort_from_dict(s) for s in d["order_by"]],
        ignore_nulls=d["ignore_nulls"])


# ---- plan nodes -----------------------------------------------------------

def phys_to_dict(p, table_names: Dict[int, str]) -> Dict[str, Any]:
    """Serialize a physical plan subtree. `table_names` maps
    id(TableProvider) -> registered name so scans ship by reference."""
    from ..physical.plan.aggregate import AggregateExec
    from ..physical.plan.projection import (CoalescePartitionsExec,
                                            FilterExec, GlobalLimitExec,
                                            ProjectionExec)
    from ..physical.plan.repartition import RepartitionExec
    from ..physical.plan.scan import MemoryExec
    from ..physical.plan.sort import SortExec
    from ..physical.plan.device_aggregate import DeviceGroupAggregateExec

    if isinstance(p, DeviceGroupAggregateExec):
        # device fusions are LOCAL decisions: ship the host-shaped
        # fallback tree; the receiving worker re-applies its own
        # physical optimizer (its chip, its fusion choices)
        return phys_to_dict(p.fallback, table_names)
    if isinstance(p, MemoryExec):
        name = table_names.get(id(p.table))
        if name is None:
            raise NotImplementedError("MemoryExec over an unregistered "
                                      "table cannot ship by reference")
        return {"k": "mem", "table": name, "projection": p.projection,
                "limit": p.limit}
    if isinstance(p, FilterExec):
        return {"k": "filter", "pred": pexpr_to_dict(p.predicate),
                "in": phys_to_dict(p.input, table_names)}
    if isinstance(p, ProjectionExec):
        return {"k": "proj",
                "exprs": [pexpr_to_dict(e) for e in p.exprs],
                "names": list(p.names), "nullables": p.nullables,
                "in": phys_to_dict(p.input, table_names)}
    if isinstance(p, GlobalLimitExec):
        return {"k": "limit", "skip": p.skip, "fetch": p.fetch,
                "in": phys_to_dict(p.input, table_names)}
    if isinstance(p, SortExec):
        return {"k": "sort",
                "exprs": [_sort_to_dict(s) for s in p.sort_exprs],
                "fetch": p.fetch, "preserve": p.preserve_partitioning,
                "in": phys_to_dict(p.input, table_names)}
    if isinstance(p, CoalescePartitionsExec):
        return {"k": "coalesce", "in": phys_to_dict(p.input, table_names)}
    if isinstance(p, RepartitionExec):
        part = p.partitioning
        return {"k": "repart", "kind": part.kind.name, "n": part.n,
                "exprs": [pexpr_to_dict(e) for e in part.exprs],
                "in": phys_to_dict(p.input, table_names)}
    if isinstance(p, AggregateExec):
        return {"k": "agg", "mode": p.mode.name,
                "groups": [[pexpr_to_dict(e), n]
                           for e, n in p.group_exprs],
                "aggs": [_agg_to_dict(a) for a in p.aggr_exprs],
                "in": phys_to_dict(p.input, table_names)}
    raise NotImplementedError(
        f"physical plan serialization for {type(p).__name__}")


def phys_from_dict(d: Dict[str, Any], ctx) -> Any:
    """Rebuild a physical plan against the receiving process's catalog
    (`ctx` is its SessionContext: scans bind to ITS shard of the data)."""
    from ..physical.plan.aggregate import AggregateExec, AggregateMode
    from ..physical.plan.base import Partitioning, PartitioningKind
    from ..physical.plan.projection import (CoalescePartitionsExec,
                                            FilterExec, GlobalLimitExec,
                                            ProjectionExec)
    from ..physical.plan.repartition import RepartitionExec
    from ..physical.plan.scan import MemoryExec
    from ..physical.plan.sort import SortExec

    k = d["k"]
    if k == "mem":
        table = ctx.get_table(d["table"])
        return MemoryExec(table, d["projection"], d["limit"])
    if k == "filter":
        return FilterExec(pexpr_from_dict(d["pred"]),
                          phys_from_dict(d["in"], ctx))
    if k == "proj":
        return ProjectionExec([pexpr_from_dict(e) for e in d["exprs"]],
                              list(d["names"]),
                              phys_from_dict(d["in"], ctx),
                              d.get("nullables"))
    if k == "limit":
        return GlobalLimitExec(phys_from_dict(d["in"], ctx), d["skip"],
                               d["fetch"])
    if k == "sort":
        return SortExec([_sort_from_dict(s) for s in d["exprs"]],
                        phys_from_dict(d["in"], ctx), d["fetch"],
                        d["preserve"])
    if k == "coalesce":
        return CoalescePartitionsExec(phys_from_dict(d["in"], ctx))
    if k == "repart":
        return RepartitionExec(
            phys_from_dict(d["in"], ctx),
            Partitioning(PartitioningKind[d["kind"]], d["n"],
                         [pexpr_from_dict(e) for e in d["exprs"]]))
    if k == "agg":
        return AggregateExec(AggregateMode[d["mode"]],
                             [(pexpr_from_dict(e), n)
                              for e, n in d["groups"]],
                             [_agg_from_dict(a) for a in d["aggs"]],
                             phys_from_dict(d["in"], ctx))
    raise NotImplementedError(f"physical plan tag {k}")
