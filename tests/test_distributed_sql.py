"""SQL planner -> mesh-distributed aggregation
(`SET datafusion.tpu.mesh_devices = N`): SPMD shard_map grouping +
collective exchange, checked against pandas on the virtual 8-device mesh."""
import numpy as np
import pandas as pd
import pytest

import datafusion_tpu as df
from datafusion_tpu.physical.plan.distributed_aggregate import (
    DistributedAggregateExec,
)


@pytest.fixture()
def mesh_ctx():
    ctx = df.SessionContext()
    ctx.config.set("datafusion.tpu.mesh_devices", 8)
    return ctx


def _spy(monkeypatch):
    calls = []
    orig = DistributedAggregateExec._execute_device

    def wrapper(self, p, c):
        calls.append(self.mesh_devices)
        return orig(self, p, c)

    monkeypatch.setattr(DistributedAggregateExec, "_execute_device", wrapper)
    return calls


def test_distributed_group_by_matches_pandas(mesh_ctx, monkeypatch):
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(1)
    n = 50_000
    g = rng.integers(0, 30, n)
    v = rng.normal(5, 2, n)
    x = rng.integers(0, 500, n)
    s = rng.choice(["p", "q", "r"], n).astype(object)
    mesh_ctx.register_arrays("t", {"g": g, "v": v, "x": x, "s": s})
    out = mesh_ctx.sql(
        "SELECT g, s, count(*) c, sum(v) sv, avg(v) av, min(x) mn, max(x) mx "
        "FROM t WHERE x > 50 GROUP BY g, s ORDER BY g, s").to_pandas()
    pdf = pd.DataFrame({"g": g, "v": v, "x": x, "s": s})
    pdf = pdf[pdf.x > 50]
    exp = pdf.groupby(["g", "s"]).agg(
        c=("v", "size"), sv=("v", "sum"), av=("v", "mean"),
        mn=("x", "min"), mx=("x", "max")).reset_index().sort_values(["g", "s"])
    assert calls, "distributed path was not used"
    assert len(out) == len(exp)
    np.testing.assert_array_equal(out["c"].to_numpy(), exp["c"].to_numpy())
    np.testing.assert_allclose(out["sv"].to_numpy(), exp["sv"].to_numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(out["av"].to_numpy(), exp["av"].to_numpy(),
                               rtol=1e-9)
    np.testing.assert_array_equal(out["mn"].to_numpy(), exp["mn"].to_numpy())
    np.testing.assert_array_equal(out["mx"].to_numpy(), exp["mx"].to_numpy())


def test_distributed_nullable_keys_and_args(mesh_ctx, monkeypatch):
    calls = _spy(monkeypatch)
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column
    from datafusion_tpu.common.schema import Field, Schema
    from datafusion_tpu.datasource.memory import MemTable
    g = np.array([1, 1, 2, 2, 3], np.int64)
    gv = np.array([True, True, True, False, True])
    v = np.array([10.0, 20.0, 30.0, 40.0, 50.0])
    vv = np.array([True, False, True, True, True])
    schema = Schema([Field("g", dt.INT64, True), Field("v", dt.FLOAT64, True)])
    batch = Batch(schema, [Column(dt.INT64, g, gv), Column(dt.FLOAT64, v, vv)])
    mesh_ctx.register_table("t", MemTable(schema, [[batch]]))
    out = mesh_ctx.sql(
        "SELECT g, count(v) c, sum(v) s FROM t GROUP BY g ORDER BY g NULLS FIRST"
    ).to_pydict()
    assert calls
    assert out == {"g": [None, 1, 2, 3], "c": [1, 1, 1, 1],
                   "s": [40.0, 10.0, 30.0, 50.0]}


def test_distributed_scalar_aggregate(mesh_ctx, monkeypatch):
    calls = _spy(monkeypatch)
    mesh_ctx.register_arrays("t", {"v": np.arange(10_001, dtype=np.float64)})
    out = mesh_ctx.sql("SELECT sum(v) s, count(*) c FROM t").to_pydict()
    assert calls
    assert out == {"s": [10_001 * 10_000 / 2], "c": [10_001]}


def test_distributed_falls_back_for_median(mesh_ctx):
    mesh_ctx.register_arrays("t", {"g": [1, 1, 2], "v": [1.0, 3.0, 5.0]})
    out = mesh_ctx.sql(
        "SELECT g, median(v) m FROM t GROUP BY g ORDER BY g").to_pydict()
    assert out == {"g": [1, 2], "m": [2.0, 5.0]}


# ---------------------------------------------------------------------------
# distributed join + aggregation through the planner
# ---------------------------------------------------------------------------

def _join_spy(monkeypatch):
    from datafusion_tpu.physical.plan.distributed_aggregate import (
        DistributedJoinAggregateExec,
    )
    calls = []
    orig = DistributedJoinAggregateExec._execute_device

    def wrapper(self, p, c):
        calls.append(self.mesh_devices)
        return orig(self, p, c)

    monkeypatch.setattr(DistributedJoinAggregateExec, "_execute_device",
                        wrapper)
    return calls


def test_distributed_join_aggregate_matches_pandas(mesh_ctx, monkeypatch):
    calls = _join_spy(monkeypatch)
    rng = np.random.default_rng(7)
    n, nb = 20_000, 400
    # build side has duplicate keys (fanout > 1) and string payload
    bkey = np.concatenate([np.arange(nb), rng.integers(0, nb, 100)])
    btype = rng.choice(["A", "B", "C"], len(bkey)).astype(object)
    pkey = rng.integers(0, nb * 2, n)     # half the probe keys miss
    qty = rng.random(n) * 10
    flag = rng.choice(["x", "y"], n).astype(object)
    mesh_ctx.register_arrays("part", {"p_partkey": bkey, "p_type": btype})
    mesh_ctx.register_arrays("li", {"l_partkey": pkey, "l_qty": qty,
                                    "l_flag": flag})
    out = mesh_ctx.sql(
        "SELECT p_type, l_flag, count(*) c, sum(l_qty) s, avg(l_qty) a, "
        "min(l_qty) mn, max(l_qty) mx "
        "FROM li JOIN part ON p_partkey = l_partkey "
        "WHERE l_qty > 1.0 GROUP BY p_type, l_flag "
        "ORDER BY p_type, l_flag").to_pandas()
    assert calls, "distributed join path was not used"
    li = pd.DataFrame({"l_partkey": pkey, "l_qty": qty, "l_flag": flag})
    part = pd.DataFrame({"p_partkey": bkey, "p_type": btype})
    j = li[li.l_qty > 1.0].merge(part, left_on="l_partkey",
                                 right_on="p_partkey")
    exp = j.groupby(["p_type", "l_flag"]).agg(
        c=("l_qty", "size"), s=("l_qty", "sum"), a=("l_qty", "mean"),
        mn=("l_qty", "min"), mx=("l_qty", "max")
    ).reset_index().sort_values(["p_type", "l_flag"])
    assert len(out) == len(exp)
    np.testing.assert_array_equal(out["c"].to_numpy(), exp["c"].to_numpy())
    np.testing.assert_allclose(out["s"].to_numpy(), exp["s"].to_numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(out["a"].to_numpy(), exp["a"].to_numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(out["mn"].to_numpy(), exp["mn"].to_numpy())
    np.testing.assert_allclose(out["mx"].to_numpy(), exp["mx"].to_numpy())


def test_distributed_join_build_side_group_and_arg(mesh_ctx, monkeypatch):
    calls = _join_spy(monkeypatch)
    # group key AND aggregated value both from the (replicated) build side
    mesh_ctx.register_arrays("d", {"k": [1, 2, 3], "grp": ["g1", "g2", "g1"],
                                   "w": [100.0, 200.0, 300.0]})
    mesh_ctx.register_arrays("f", {"fk": [1, 1, 2, 3, 3, 3, 9]})
    out = mesh_ctx.sql(
        "SELECT grp, count(*) c, sum(w) s FROM f JOIN d ON k = fk "
        "GROUP BY grp ORDER BY grp").to_pydict()
    assert calls
    assert out == {"grp": ["g1", "g2"], "c": [5, 1],
                   "s": [2 * 100.0 + 3 * 300.0, 200.0]}


def test_distributed_join_scalar_aggregate(mesh_ctx, monkeypatch):
    calls = _join_spy(monkeypatch)
    mesh_ctx.register_arrays("dim", {"k": np.arange(50)})
    mesh_ctx.register_arrays("fact", {"fk": np.arange(100) % 60,
                                      "v": np.ones(100)})
    out = mesh_ctx.sql(
        "SELECT count(*) c, sum(v) s FROM fact JOIN dim ON k = fk").to_pydict()
    assert calls
    exp_c = int(np.sum((np.arange(100) % 60) < 50))
    assert out == {"c": [exp_c], "s": [float(exp_c)]}


def test_distributed_join_null_keys_never_match(mesh_ctx, monkeypatch):
    calls = _join_spy(monkeypatch)
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column
    from datafusion_tpu.common.schema import Field, Schema
    from datafusion_tpu.datasource.memory import MemTable
    k = np.array([1, 2, 3], np.int64)
    kv = np.array([True, False, True])
    schema = Schema([Field("k", dt.INT64, True)])
    mesh_ctx.register_table("d", MemTable(
        schema, [[Batch(schema, [Column(dt.INT64, k, kv)])]]))
    fk = np.array([1, 2, 2, 3], np.int64)
    fkv = np.array([True, True, False, True])
    fschema = Schema([Field("fk", dt.INT64, True)])
    mesh_ctx.register_table("f", MemTable(
        fschema, [[Batch(fschema, [Column(dt.INT64, fk, fkv)])]]))
    out = mesh_ctx.sql(
        "SELECT count(*) c FROM f JOIN d ON k = fk").to_pydict()
    assert calls
    # only fk=1 and fk=3 match (NULLs never join)
    assert out == {"c": [2]}


def test_distributed_high_cardinality_shuffle(mesh_ctx, monkeypatch):
    """Key space above the broadcast limit routes to the owned-slot
    all_to_all exchange (parallel/exchange.py) and still matches pandas."""
    calls = _spy(monkeypatch)
    rng = np.random.default_rng(9)
    n = 60_000
    g = rng.integers(0, 20_000, n)     # key space > _BROADCAST_GROUP_LIMIT
    v = rng.integers(0, 100, n)
    mesh_ctx.register_arrays("hc", {"g": g, "v": v})
    out = mesh_ctx.sql(
        "SELECT g, count(*) c, sum(v) sv FROM hc GROUP BY g "
        "ORDER BY g").to_pandas()
    pdf = pd.DataFrame({"g": g, "v": v}).groupby("g").agg(
        c=("v", "size"), sv=("v", "sum")).reset_index().sort_values("g")
    assert calls, "distributed path was not used"
    assert len(out) == len(pdf)
    np.testing.assert_array_equal(out["g"].to_numpy(), pdf["g"].to_numpy())
    np.testing.assert_array_equal(out["c"].to_numpy(), pdf["c"].to_numpy())
    np.testing.assert_array_equal(out["sv"].to_numpy(), pdf["sv"].to_numpy())


def test_distributed_partitioned_join_by_stats(mesh_ctx, monkeypatch):
    """A build side above the broadcast-rows threshold selects the
    PARTITIONED all_to_all join; results match pandas."""
    mesh_ctx.config.set(
        "datafusion.optimizer.hash_join_single_partition_threshold_rows", 64)
    from datafusion_tpu.parallel import exchange as ex
    used = []
    orig = ex.distributed_partitioned_join_aggregate

    def spy(*a, **k):
        used.append(k.get("salt", 1))
        return orig(*a, **k)
    monkeypatch.setattr(ex, "distributed_partitioned_join_aggregate", spy)

    rng = np.random.default_rng(13)
    nb, n = 2_000, 40_000      # build side above the 64-row threshold
    mesh_ctx.register_arrays(
        "dim", {"k": np.arange(nb) % 500, "w": rng.integers(0, 9, nb)})
    mesh_ctx.register_arrays(
        "fact", {"fk": rng.integers(0, 600, n), "g": rng.integers(0, 16, n),
                 "v": rng.integers(0, 9, n)})
    out = mesh_ctx.sql(
        "SELECT g, sum(v) s, sum(w) sw, count(*) c FROM fact JOIN dim "
        "ON k = fk GROUP BY g ORDER BY g").to_pandas()
    assert used, "partitioned join path was not used"
    f = pd.DataFrame({"fk": np.asarray(
        mesh_ctx.table("fact").to_pydict()["fk"]),
        "g": np.asarray(mesh_ctx.table("fact").to_pydict()["g"]),
        "v": np.asarray(mesh_ctx.table("fact").to_pydict()["v"])})
    d = pd.DataFrame({"k": np.arange(nb) % 500,
                      "w": np.asarray(mesh_ctx.table("dim").to_pydict()["w"])})
    j = f.merge(d, left_on="fk", right_on="k")
    exp = j.groupby("g").agg(
        s=("v", "sum"), sw=("w", "sum"),
        c=("v", "size")).reset_index().sort_values("g")
    np.testing.assert_array_equal(out["g"].to_numpy(), exp["g"].to_numpy())
    np.testing.assert_array_equal(out["s"].to_numpy(), exp["s"].to_numpy())
    np.testing.assert_array_equal(out["sw"].to_numpy(), exp["sw"].to_numpy())
    np.testing.assert_array_equal(out["c"].to_numpy(), exp["c"].to_numpy())


def test_auto_mesh_from_stats(monkeypatch):
    """Stats-driven mesh participation (EnforceDistribution analog): NO
    `SET datafusion.tpu.mesh_devices` — the optimizer shards over the
    local device mesh because the source bytes exceed the configured
    per-chip budget."""
    calls = _spy(monkeypatch)
    ctx = df.SessionContext()
    # lower the budget so the 1M-row table qualifies on the CPU mesh
    ctx.config.set("datafusion.tpu.auto_mesh_min_bytes", 1 << 20)
    rng = np.random.default_rng(7)
    n = 200_000
    ctx.register_arrays("big", {"g": rng.integers(0, 50, n),
                                "v": rng.integers(0, 1000, n)})
    plan = ctx.sql("SELECT g, sum(v) s FROM big GROUP BY g"
                   ).create_physical_plan()
    text = str(plan.display_line()) if hasattr(plan, "display_line") else ""

    def find(node):
        if isinstance(node, DistributedAggregateExec):
            return True
        return any(find(c) for c in node.children())

    assert find(plan), f"expected DistributedAggregateExec, got {text}"
    out = ctx.sql("SELECT g, sum(v) s FROM big GROUP BY g ORDER BY g"
                  ).to_pydict()
    pdf = pd.DataFrame({"g": np.asarray(
        ctx.sql("SELECT g FROM big").to_pydict()["g"])})
    assert len(out["g"]) == 50
    assert calls, "distributed exec never ran"


def test_auto_mesh_not_for_small_tables():
    ctx = df.SessionContext()
    ctx.register_arrays("small", {"g": np.arange(100) % 5,
                                  "v": np.arange(100)})
    plan = ctx.sql("SELECT g, sum(v) FROM small GROUP BY g"
                   ).create_physical_plan()

    def find(node):
        if isinstance(node, DistributedAggregateExec):
            return True
        return any(find(c) for c in node.children())

    assert not find(plan)


def test_distributed_aggregate_over_no_rows(mesh_ctx):
    """An input that yields no batches (TPC-H Q17's shape at small
    scale) aggregates to NULL sums and zero counts on the mesh."""
    mesh_ctx.register_arrays("t", {"k": np.arange(100),
                                   "v": np.arange(100) * 1.5})
    mesh_ctx.sql("CREATE TABLE d AS SELECT k, CAST(v AS DECIMAL(15, 2)) m "
                 "FROM t")
    out = mesh_ctx.sql(
        "SELECT sum(m) sm, min(m) mn, sum(v) sv, count(*) c FROM "
        "(SELECT m, v FROM d JOIN t USING (k) WHERE v < 0 LIMIT 10) s"
    ).to_pydict()
    assert out == {"sm": [None], "mn": [None], "sv": [None], "c": [0]}
