"""Plan serialization roundtrip (reference: datafusion/proto/tests —
every logical node survives serialize -> deserialize -> same results;
the 'multi-node without a cluster' proxy of SURVEY.md §4.3)."""
import numpy as np
import pytest

from datafusion_tpu.proto import plan_from_json, plan_to_json

QUERIES = [
    "SELECT a + 1 AS b FROM t WHERE a > 1",
    "SELECT s, count(*) c, sum(a) FROM t GROUP BY s HAVING count(*) > 0 "
    "ORDER BY s LIMIT 5",
    "SELECT t.a, u.a FROM t JOIN t u ON t.a = u.a",
    "SELECT DISTINCT s FROM t",
    "SELECT a, row_number() OVER (PARTITION BY s ORDER BY a) FROM t",
    "SELECT CASE WHEN a > 1 THEN 'x' ELSE 'y' END FROM t",
    "SELECT a FROM t WHERE s LIKE 'a%' AND a IN (1, 2, 3)",
    "SELECT a FROM t UNION ALL SELECT a + 1 FROM t",
    "SELECT a FROM t INTERSECT SELECT a FROM t",
    "SELECT CAST(a AS DOUBLE), abs(a) FROM t",
    "SELECT * FROM (VALUES (1, 'a'), (2, 'b')) v(x, y)",
]


@pytest.fixture()
def tctx(ctx):
    ctx.register_arrays("t", {"a": np.array([1, 2, 3]),
                              "s": np.array(["a", "bb", "abc"])})
    return ctx


@pytest.mark.parametrize("q", QUERIES)
def test_roundtrip(tctx, q):
    from datafusion_tpu.api.dataframe import DataFrame
    df = tctx.sql(q)
    js = plan_to_json(df.plan)
    plan2 = plan_from_json(js, tctx)
    df2 = DataFrame(tctx, plan2)
    assert df.plan.display() == plan2.display()
    assert df.to_pydict() == df2.to_pydict()


def test_roundtrip_optimized(tctx):
    from datafusion_tpu.api.dataframe import DataFrame
    df = tctx.sql("SELECT s, sum(a) FROM t WHERE a > 0 GROUP BY s")
    opt = df.optimized_plan()
    js = plan_to_json(opt)
    plan2 = plan_from_json(js, tctx)
    assert opt.display() == plan2.display()


def test_physical_plan_json_roundtrip():
    import datafusion_tpu as df
    from datafusion_tpu.physical.plan.base import collect_batch
    from datafusion_tpu.proto.physical import phys_from_dict, phys_to_dict
    rng = np.random.default_rng(0)
    n = 50
    ctx = df.SessionContext()
    ctx.register_arrays("t", {
        "g": rng.integers(0, 7, n),
        "s": np.array([f"k{i % 3}" for i in range(n)]),
        "v": rng.integers(0, 100, n).astype(np.int64),
        "f": rng.random(n),
    })
    plan = ctx.sql(
        "SELECT g, sum(v) s, count(*) c FROM t WHERE v > 10 GROUP BY g"
    ).create_physical_plan()
    names = {id(ctx.get_table("t")): "t"}
    back = phys_from_dict(phys_to_dict(plan, names), ctx)
    r1 = collect_batch(plan, ctx.task_context())
    r2 = collect_batch(back, ctx.task_context())
    assert sorted(map(tuple, zip(*[c.to_pylist(r1.num_rows)
                                   for c in r1.columns]))) == \
        sorted(map(tuple, zip(*[c.to_pylist(r2.num_rows)
                                for c in r2.columns])))
