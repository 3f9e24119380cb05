"""Device path: fused aggregate vs host path differential, fallback
behavior, mesh dryrun."""
import numpy as np
import pytest


def _two_ctxs():
    import datafusion_tpu as df
    rng = np.random.default_rng(3)
    n = 20_000
    data = {
        "g": rng.choice(list("abcdefgh"), n).astype(object),
        "k": rng.integers(-50, 50, n),
        "v": rng.normal(size=n) * 100,
        "d": rng.integers(0, 11, n) / 100.0,
    }
    on = df.SessionContext()
    on.register_arrays("t", data)
    off = df.SessionContext()
    off.config.set("datafusion.tpu.device_aggregate", False)
    off.register_arrays("t", data)
    return on, off


QUERIES = [
    "SELECT g, count(*) c, sum(v) s, avg(v) a, min(v) mn, max(v) mx "
    "FROM t GROUP BY g ORDER BY g",
    "SELECT g, k, sum(v * (1 - d)) s FROM t WHERE k > 0 GROUP BY g, k "
    "ORDER BY g, k",
    "SELECT count(*) c, sum(v) s FROM t WHERE g = 'c' AND v > 0",
    "SELECT k, count(*) c FROM t WHERE g IN ('a', 'b') GROUP BY k ORDER BY k",
    "SELECT g, sum(k) s FROM t WHERE g LIKE 'a%' GROUP BY g ORDER BY g",
    "SELECT sum(v) s FROM t WHERE v BETWEEN -10 AND 10",
]


@pytest.mark.parametrize("q", QUERIES)
def test_device_matches_host(q):
    on, off = _two_ctxs()
    a = on.sql(q).to_pydict()
    b = off.sql(q).to_pydict()
    assert a.keys() == b.keys()
    for k in a:
        av, bv = a[k], b[k]
        assert len(av) == len(bv), (k, len(av), len(bv))
        for x, y in zip(av, bv):
            if isinstance(x, float):
                assert x == pytest.approx(y, rel=1e-9), k
            else:
                assert x == y, k


def test_device_plan_engaged():
    on, _ = _two_ctxs()
    d = on.sql("SELECT g, sum(v) FROM t GROUP BY g")
    text = d.create_physical_plan().display_indent()
    assert "DeviceGroupAggregateExec" in text


def test_unsupported_agg_falls_back():
    on, _ = _two_ctxs()
    # median has no device lowering -> host AggregateExec in the plan
    d = on.sql("SELECT g, median(v) FROM t GROUP BY g")
    text = d.create_physical_plan().display_indent()
    assert "DeviceGroupAggregateExec" not in text
    out = d.to_pydict()
    assert len(out["g"]) == 8


def test_runtime_fallback_on_wide_keys():
    """64-bit-spanning int keys can't pack -> transparent host fallback."""
    import datafusion_tpu as df
    ctx = df.SessionContext()
    ctx.register_arrays("t", {
        "k": np.array([2**62, -2**62, 0, 2**62], dtype=np.int64),
        "v": np.array([1.0, 2.0, 3.0, 4.0]),
    })
    out = ctx.sql("SELECT k, sum(v) s FROM t GROUP BY k ORDER BY k").to_pydict()
    assert out["s"] == [2.0, 3.0, 5.0]


def test_nulls_through_device_path():
    import datafusion_tpu as df
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column
    from datafusion_tpu.common.schema import Field, Schema
    from datafusion_tpu.datasource.memory import MemTable
    g = Column(dt.INT64, np.array([1, 1, 2, 2, 0], np.int64),
               np.array([True, True, True, True, False]))
    v = Column(dt.FLOAT64, np.array([1.0, 2.0, 3.0, 4.0, 5.0]),
               np.array([True, False, True, True, True]))
    b = Batch(Schema([Field("g", dt.INT64, True), Field("v", dt.FLOAT64, True)]),
              [g, v])
    ctx = df.SessionContext()
    ctx.register_table("t", MemTable(b.schema, [[b]]))
    out = ctx.sql("SELECT g, count(*) c, count(v) cv, sum(v) s FROM t "
                  "GROUP BY g ORDER BY g NULLS FIRST").to_pydict()
    assert out["g"] == [None, 1, 2]
    assert out["c"] == [1, 2, 2]
    assert out["cv"] == [1, 1, 2]
    assert out["s"] == [5.0, 1.0, 7.0]


def test_dryrun_multichip():
    import __graft_entry__ as g
    g.dryrun_multichip(8)


def test_dryrun_multichip_four_devices():
    """The mesh size `chip_smoke.py --devices 4` runs."""
    import __graft_entry__ as g
    g.dryrun_multichip(4)


def test_explain_analyze_reports_achieved_bandwidth():
    import re
    on, _ = _two_ctxs()
    plan = "\n".join(on.sql("EXPLAIN ANALYZE SELECT g, sum(v) s FROM t "
                            "GROUP BY g").to_pydict()["plan"])
    line = next(ln for ln in plan.splitlines()
                if "DeviceGroupAggregateExec" in ln)
    assert re.search(r"achieved=\d+\.\dGB/s", line), line
    assert "%" not in line and "SOL" not in line


def test_metrics_summary_bandwidth_has_no_peak_share():
    from datafusion_tpu.runtime.metrics import MetricsSet
    ms = MetricsSet()
    ms.counter("bytes_touched", 0).add(3_000_000_000)
    ms.timer("device_compute", 0).nanos = 1_500_000_000
    summary = ms.summary()
    assert "achieved=2.0GB/s" in summary
    assert "%" not in summary


def test_entry_compiles():
    import sys
    sys.path.insert(0, "/root/repo")
    import jax
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_device_count_distinct_matches_host():
    """count(DISTINCT x) runs on the sorted device path for single-chunk
    inputs (two-key pair sort, run-start counting; NULLs excluded)."""
    import numpy as np
    import pandas as pd
    import datafusion_tpu as df
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column, Dictionary
    from datafusion_tpu.common.schema import Field, Schema
    from datafusion_tpu.datasource.memory import MemTable
    rng = np.random.default_rng(6)
    n = 40_000
    g = rng.integers(0, 8, n)
    x = rng.integers(0, 900, n)
    xv = rng.random(n) < 0.05
    s = rng.choice(list("abcde"), n).astype(object)
    codes, nv, dic = Dictionary.build(s)
    schema = Schema([Field("g", dt.INT64, False), Field("x", dt.INT64, True),
                     Field("s", dt.STRING, False)])
    b = Batch(schema, [Column(dt.INT64, g), Column(dt.INT64, x, ~xv),
                       Column(dt.STRING, codes, nv, dic)])
    ctx = df.SessionContext()
    ctx.register_table("cd", MemTable(schema, [[b]]))
    q = ("SELECT g, count(DISTINCT x) dx, count(DISTINCT s) ds, count(*) c "
         "FROM cd GROUP BY g ORDER BY g")
    pl = ctx.sql("EXPLAIN " + q).to_pydict()
    assert any("DeviceGroupAggregate" in r for r in pl["plan"])
    out = ctx.sql(q).to_pandas()
    pdf = pd.DataFrame({"g": g, "x": np.where(xv, np.nan, x), "s": s})
    exp = pdf.groupby("g").agg(dx=("x", "nunique"), ds=("s", "nunique"),
                               c=("s", "size")).reset_index()
    np.testing.assert_array_equal(out["dx"].to_numpy(), exp["dx"].to_numpy())
    np.testing.assert_array_equal(out["ds"].to_numpy(), exp["ds"].to_numpy())
    np.testing.assert_array_equal(out["c"].to_numpy(), exp["c"].to_numpy())


def test_group_table_overflow_poison_falls_back():
    """Overflow of the fixed device group table is detected via the
    on-device key-poison sentinel (no per-chunk scalar round-trip) and
    falls back to the host aggregate."""
    import numpy as np
    import pandas as pd
    import datafusion_tpu as df
    from datafusion_tpu.physical.plan import device_aggregate as DA
    orig_init = DA.DeviceGroupAggregateExec.__init__

    def small_init(self, *a, **k):
        orig_init(self, *a, **k)
        self.max_groups = 256
    DA.DeviceGroupAggregateExec.__init__ = small_init
    try:
        ctx = df.SessionContext()
        rng = np.random.default_rng(1)
        g = rng.integers(0, 100_000, 200_000)
        ctx.register_arrays("big", {"g": g, "v": rng.random(200_000)})
        out = ctx.sql(
            "SELECT count(*) c FROM (SELECT g, sum(v) s FROM big GROUP BY g)"
        ).to_pydict()
        assert out["c"] == [pd.Series(g).nunique()]
    finally:
        DA.DeviceGroupAggregateExec.__init__ = orig_init


def test_common_subtree_cache_shares_cte_execution():
    """Inlined non-recursive CTEs referenced twice (TPC-H Q15 shape) run
    the underlying device aggregate once per query."""
    import numpy as np
    import datafusion_tpu as df
    from datafusion_tpu.physical.plan import device_aggregate as DA
    calls = []
    orig = DA.DeviceGroupAggregateExec._execute_device

    def counting(self, p, c):
        calls.append(self.display_line())
        return orig(self, p, c)
    DA.DeviceGroupAggregateExec._execute_device = counting
    try:
        ctx = df.SessionContext()
        rng = np.random.default_rng(0)
        ctx.register_arrays("t", {"k": rng.integers(0, 50, 10_000),
                                  "v": rng.random(10_000)})
        out = ctx.sql(
            "WITH agg AS (SELECT k, sum(v) s FROM t GROUP BY k) "
            "SELECT count(*) c FROM agg "
            "WHERE s = (SELECT max(s) FROM agg)").to_pydict()
        assert out["c"][0] >= 1
        inner = [d for d in calls if "gby=[k]" in d]
        assert len(inner) == 1, calls   # shared, not re-executed
    finally:
        DA.DeviceGroupAggregateExec._execute_device = orig


def test_group_table_overflow_offloads_to_host():
    """A group-by with more groups than the device table completes via
    the unbounded sorted path (run-end layout, device compaction, final
    table in host DRAM) — no host re-aggregation fallback
    (SURVEY 5.4 HBM->host offload; reference analog row_hash.rs spill)."""
    import numpy as np

    import datafusion_tpu as df
    from datafusion_tpu.physical.plan.device_aggregate import (
        DeviceGroupAggregateExec)

    rng = np.random.default_rng(0)
    n = 50_000
    g = rng.integers(0, 20_000, n)
    v = rng.integers(0, 100, n)
    ctx = df.SessionContext()
    ctx.register_arrays("t", {"g": g, "v": v})
    d = ctx.sql("SELECT g, sum(v) s, count(*) c, min(v) mn, max(v) mx "
                "FROM t GROUP BY g")
    plan = d.create_physical_plan()

    found = []

    def walk(node):
        if isinstance(node, DeviceGroupAggregateExec):
            found.append(node)
        for ch in node.children():
            walk(ch)
    walk(plan)
    assert found, "expected a device aggregate in the plan"
    for node in found:
        node.max_groups = 64        # force the fixed table to overflow

    # executing the SAME exec object (fallback would also be correct —
    # assert the DEVICE path ran by checking its output_rows metric)
    from datafusion_tpu.physical.plan.base import collect
    batches = collect(plan, ctx.task_context())
    total = sum(b.num_rows for b in batches)
    assert total == len(np.unique(g))
    rows = found[0].metrics.counter("output_rows", 0).value
    assert rows == total, "device exec did not emit (host fallback ran)"

    import pandas as pd
    out = pd.DataFrame({
        "g": np.concatenate([np.asarray(b.columns[0].to_pylist(b.num_rows))
                             for b in batches]).astype(np.int64),
        "s": np.concatenate([np.asarray(b.columns[1].to_pylist(b.num_rows))
                             for b in batches]).astype(np.int64),
        "mx": np.concatenate([np.asarray(b.columns[4].to_pylist(b.num_rows))
                              for b in batches]).astype(np.int64),
    }).sort_values("g").reset_index(drop=True)
    want = pd.DataFrame({"g": g, "v": v}).groupby("g").agg(
        s=("v", "sum"), mx=("v", "max")).reset_index()
    np.testing.assert_array_equal(out["g"].values, want["g"].values)
    np.testing.assert_array_equal(out["s"].values, want["s"].values)
    np.testing.assert_array_equal(out["mx"].values, want["mx"].values)
