"""Memory-limit enforcement (reference: core/tests/memory_limit/mod.rs —
run real queries under tiny memory pools and expect a clean
ResourcesExhausted error, never an OOM or wrong result)."""
import numpy as np
import pytest

import datafusion_tpu as df
from datafusion_tpu.common.errors import ResourcesExhausted
from datafusion_tpu.runtime import (FairSpillPool, GreedyMemoryPool,
                                    MemoryReservation, RuntimeEnv,
                                    UnboundedMemoryPool)


def _ctx(pool):
    ctx = df.SessionContext(runtime=RuntimeEnv(memory_pool=pool))
    rng = np.random.default_rng(0)
    n = 50_000
    ctx.register_arrays("t", {
        "k": rng.integers(0, 1000, n),
        "v": rng.normal(size=n),
        "s": rng.choice(list("abcdefgh"), n).astype(object),
    })
    return ctx


def test_sort_exceeds_tiny_pool():
    ctx = _ctx(GreedyMemoryPool(2_000))
    with pytest.raises(ResourcesExhausted):
        ctx.sql("SELECT * FROM t ORDER BY v").collect_batch()


def test_join_build_exceeds_tiny_pool():
    ctx = _ctx(GreedyMemoryPool(2_000))
    with pytest.raises(ResourcesExhausted):
        ctx.sql("SELECT count(*) c FROM t a JOIN t b ON a.k = b.k").collect_batch()


def test_queries_fit_in_large_pool():
    ctx = _ctx(GreedyMemoryPool(512 * 1024 * 1024))
    out = ctx.sql("SELECT count(*) c FROM (SELECT * FROM t ORDER BY v)").to_pydict()
    assert out["c"] == [50_000]


def test_greedy_pool_accounting():
    pool = GreedyMemoryPool(1000)
    r1 = MemoryReservation("a", pool)
    r1.try_grow(600)
    r2 = MemoryReservation("b", pool)
    with pytest.raises(ResourcesExhausted):
        r2.try_grow(600)
    r1.shrink(400)
    r2.try_grow(600)
    assert pool.reserved() == 800
    r1.free()
    r2.free()
    assert pool.reserved() == 0


def test_fair_spill_pool():
    pool = FairSpillPool(1000)
    a = MemoryReservation("a", pool, can_spill=True)
    b = MemoryReservation("b", pool, can_spill=True)
    # fair share is 500 each
    a.try_grow(450)
    with pytest.raises(ResourcesExhausted):
        b.try_grow(600)
    b.try_grow(450)


def test_sort_spills_with_disk_manager():
    """With a DiskManager the sort externalizes instead of erroring, and
    the result is identical to the in-memory sort (reference:
    sorts/sort.rs spill tests)."""
    from datafusion_tpu.runtime import DiskManager
    disk = DiskManager()
    ctx = df.SessionContext(runtime=RuntimeEnv(
        memory_pool=GreedyMemoryPool(200_000), disk_manager=disk))
    rng = np.random.default_rng(1)
    n = 60_000
    # several batches so the sorter buffers incrementally
    from datafusion_tpu.datasource.memory import MemTable
    from datafusion_tpu.common.batch import Batch
    batches = []
    vals = rng.normal(size=n)
    ks = rng.integers(0, 10**6, n)
    for i in range(0, n, 10_000):
        batches.append(Batch.from_arrays({
            "k": ks[i:i+10_000], "v": vals[i:i+10_000]}))
    ctx.register_table("t", MemTable(batches[0].schema, [batches]))
    out = ctx.sql("SELECT k, v FROM t ORDER BY v").to_pydict()
    sm = ctx.sql("EXPLAIN ANALYZE SELECT k, v FROM t ORDER BY v").to_pydict()
    assert any("spill_count" in p for p in sm["plan"]), sm["plan"]
    exp = np.sort(vals)
    np.testing.assert_allclose(np.array(out["v"]), exp)
    assert disk.spilled_bytes > 0


def test_unbounded_pool_tracks():
    pool = UnboundedMemoryPool()
    r = MemoryReservation("x", pool)
    r.try_grow(10**9)
    assert pool.reserved() == 10**9
    r.free()


class TestObjectStore:
    """ObjectStoreRegistry + CacheManager (reference:
    execution/src/object_store.rs, cache/cache_manager.rs)."""

    def test_memory_store_parquet_roundtrip(self, tmp_path):
        import io
        import pyarrow as pa
        import pyarrow.parquet as pq
        import datafusion_tpu as df
        from datafusion_tpu.datasource.object_store import InMemoryStore
        ctx = df.SessionContext()
        t = pa.table({"a": [1, 2, 3]})
        buf = io.BytesIO()
        pq.write_table(t, buf)
        store = InMemoryStore()
        store.put("d/t.parquet", buf.getvalue())
        ctx.register_object_store("mem", store)
        ctx.register_parquet("t", "mem://d/t.parquet")
        assert ctx.sql("SELECT sum(a) s FROM t").to_pydict() == {"s": [6]}

    def test_listing_cache_and_unknown_scheme(self, tmp_path):
        import pytest as _pt
        import datafusion_tpu as df
        from datafusion_tpu.common.errors import PlanError
        ctx = df.SessionContext()
        p = tmp_path / "x.csv"
        p.write_text("a,b\n1,2\n")
        ctx.register_csv("x1", str(p))
        ctx.register_csv("x2", str(p))
        assert ctx.runtime.cache_manager.list_files_cache.hits >= 1
        with _pt.raises(PlanError):
            ctx.register_csv("bad", "s3://nope/x.csv")

    def test_lru_eviction(self):
        from datafusion_tpu.runtime.cache_manager import LruCache
        c = LruCache(2)
        c.put("a", 1); c.put("b", 2); c.put("c", 3)
        assert c.get("a") is None and c.get("b") == 2 and c.get("c") == 3


def test_orc_external_table(tmp_path):
    import pyarrow as pa
    import pyarrow.orc as porc
    import datafusion_tpu as df
    p = str(tmp_path / "t.orc")
    porc.write_table(pa.table({"a": [1, 2, 3], "s": ["x", "y", "z"]}), p)
    ctx = df.SessionContext()
    ctx.sql(f"CREATE EXTERNAL TABLE o STORED AS ORC LOCATION '{p}'")
    assert ctx.sql("SELECT sum(a) s FROM o").to_pydict() == {"s": [6]}
    assert ctx.sql("SELECT a FROM o WHERE s = 'y'").to_pydict() == {"a": [2]}


def test_hash_agg_spills_with_disk_manager():
    """High-cardinality group-by under a tiny pool completes by spilling
    sorted partial state and merging runs (reference:
    aggregates/row_hash.rs:70-88,436-604)."""
    from datafusion_tpu.runtime import DiskManager
    from datafusion_tpu.datasource.memory import MemTable
    from datafusion_tpu.common.batch import Batch
    disk = DiskManager()
    ctx = df.SessionContext(runtime=RuntimeEnv(
        memory_pool=GreedyMemoryPool(300_000), disk_manager=disk))
    ctx.config.set("datafusion.tpu.device_aggregate", "false")
    rng = np.random.default_rng(7)
    n = 120_000
    ks = rng.integers(0, 50_000, n)           # ~40k distinct groups
    vs = rng.normal(size=n)
    batches = []
    for i in range(0, n, 10_000):
        batches.append(Batch.from_arrays({
            "k": ks[i:i+10_000], "v": vs[i:i+10_000]}))
    ctx.register_table("t", MemTable(batches[0].schema, [batches]))
    q = "SELECT k, sum(v) s, count(*) c FROM t GROUP BY k"
    out = ctx.sql(q).to_pydict()
    sm = ctx.sql("EXPLAIN ANALYZE " + q).to_pydict()
    assert any("spill_count" in p for p in sm["plan"]), sm["plan"]
    assert disk.spilled_bytes > 0
    # oracle
    import pandas as pd
    exp = (pd.DataFrame({"k": ks, "v": vs}).groupby("k")
           .agg(s=("v", "sum"), c=("v", "size")))
    got = pd.DataFrame(out).set_index("k").sort_index()
    assert len(got) == len(exp)
    np.testing.assert_allclose(got["s"].to_numpy(), exp["s"].to_numpy())
    np.testing.assert_array_equal(got["c"].to_numpy(), exp["c"].to_numpy())


def test_hash_agg_spill_string_keys():
    """Spill-merge with dictionary string keys: byte-encoded key order is
    value-deterministic across runs."""
    from datafusion_tpu.runtime import DiskManager
    from datafusion_tpu.datasource.memory import MemTable
    from datafusion_tpu.common.batch import Batch
    disk = DiskManager()
    ctx = df.SessionContext(runtime=RuntimeEnv(
        memory_pool=GreedyMemoryPool(250_000), disk_manager=disk))
    ctx.config.set("datafusion.tpu.device_aggregate", "false")
    rng = np.random.default_rng(3)
    n = 90_000
    ks = np.array([f"key_{i:06d}" for i in rng.integers(0, 30_000, n)])
    vs = rng.integers(0, 100, n)
    batches = []
    for i in range(0, n, 10_000):
        batches.append(Batch.from_arrays({
            "k": ks[i:i+10_000], "v": vs[i:i+10_000]}))
    ctx.register_table("t", MemTable(batches[0].schema, [batches]))
    out = ctx.sql("SELECT k, sum(v) s FROM t GROUP BY k").to_pydict()
    assert disk.spilled_bytes > 0
    import pandas as pd
    exp = pd.DataFrame({"k": ks, "v": vs}).groupby("k")["v"].sum()
    got = pd.DataFrame(out).set_index("k").sort_index()["s"]
    assert len(got) == len(exp)
    np.testing.assert_array_equal(got.to_numpy(), exp.to_numpy())


def test_device_lut_caches_under_memory_pool():
    """The cross-query device LUT/pmat caches are
    accounted against the query MemoryPool and LRU-evict under
    pressure instead of failing the query."""
    import numpy as np

    import datafusion_tpu as df
    from datafusion_tpu.physical.plan import device_join_chain as djc
    from datafusion_tpu.runtime.memory import (GreedyMemoryPool,
                                               MemoryReservation)

    ctx = df.SessionContext()
    n = 30_000
    rng = np.random.default_rng(0)
    ctx.register_arrays("f", {"k": np.sort(rng.integers(0, 5000, n)),
                              "v": rng.integers(0, 50, n).astype(np.int64)})
    ctx.register_arrays("d", {"k": np.arange(5000),
                              "w": rng.integers(0, 9, 5000)})
    sql = "SELECT w, sum(v) s FROM f JOIN d ON f.k = d.k GROUP BY w"
    expected = ctx.sql(sql + " ORDER BY w").to_pydict()
    before = djc.device_cache_bytes()
    assert before > 0, "chain staging should have populated the caches"

    # a pool with room for less than half the cached bytes: accounting
    # must EVICT (not raise), and the query must still answer correctly
    pool = GreedyMemoryPool(before // 2)
    res = MemoryReservation("test[cache-account]", pool)
    djc._account_device_caches(res, None)
    assert djc.device_cache_bytes() < before, "expected LRU eviction"
    assert pool.reserved() <= before // 2
    res.free()

    got = ctx.sql(sql + " ORDER BY w").to_pydict()
    assert got == expected
