"""Device lexsort (lax.sort) vs host np.lexsort parity.

The device path must be bit-identical to the host path: same stable
permutation for any multi-word key set, with and without LIMIT.
"""
import numpy as np
import pytest

from datafusion_tpu.physical.plan import device_sort


def _host(keys, n, limit=None):
    order = np.lexsort(tuple(reversed([k[:n] for k in keys])))
    return order[:limit] if limit is not None else order


@pytest.mark.parametrize("n", [1, 7, 1000, 5000])
@pytest.mark.parametrize("limit", [None, 1, 10])
def test_device_lexsort_matches_host(n, limit):
    rng = np.random.default_rng(42 + n)
    # two key exprs -> [rank u8, key u64] x2, with duplicates to
    # exercise stability
    k1 = rng.integers(0, 50, n).astype(np.uint64)
    r1 = rng.integers(0, 2, n).astype(np.uint8)
    k2 = rng.integers(0, 5, n).astype(np.uint64)
    r2 = np.zeros(n, np.uint8)
    keys = [r1, k1, r2, k2]
    got = device_sort.device_lexsort(keys, n, limit=limit)
    want = _host(keys, n, limit)
    np.testing.assert_array_equal(got, want)


def test_device_lexsort_full_u64_range():
    # float order keys use the whole uint64 range incl. the extremes
    n = 4096
    rng = np.random.default_rng(7)
    k = rng.integers(0, 2**63, n).astype(np.uint64)
    k[0] = np.uint64(0xFFFFFFFFFFFFFFFF)
    k[1] = np.uint64(0)
    keys = [np.zeros(n, np.uint8), k]
    got = device_sort.device_lexsort(keys, n)
    np.testing.assert_array_equal(got, _host(keys, n))


def test_sort_exec_device_threshold():
    """SortExec output is identical whether the device path triggers."""
    from datafusion_tpu.api.context import SessionContext
    n = 20_000
    rng = np.random.default_rng(3)
    ctx = SessionContext()
    ctx.register_arrays("t", {
        "a": rng.integers(0, 100, n),
        "b": rng.standard_normal(n),
    })
    sql = "SELECT a, b FROM t ORDER BY a DESC, b LIMIT 500"
    host = ctx.sql(sql).collect_batch()
    ctx.sql("SET datafusion.tpu.device_sort_min_rows = 1")
    frame = ctx.sql(sql)
    dev = frame.collect_batch()
    assert "device_compute=" in frame.executed_plan.display_indent(
        show_metrics=True)
    for hc, dc in zip(host.columns, dev.columns):
        np.testing.assert_array_equal(hc.to_pylist(host.num_rows),
                                      dc.to_pylist(dev.num_rows))


def test_window_device_order():
    """Window results identical through the device ordering path."""
    from datafusion_tpu.api.context import SessionContext
    n = 10_000
    rng = np.random.default_rng(5)
    ctx = SessionContext()
    ctx.register_arrays("t", {
        "g": rng.integers(0, 37, n),
        "v": rng.integers(0, 1000, n),
    })
    sql = ("SELECT g, v, row_number() OVER (PARTITION BY g ORDER BY v) rn, "
           "sum(v) OVER (PARTITION BY g ORDER BY v) s FROM t "
           "ORDER BY g, v, rn LIMIT 200")
    host = ctx.sql(sql).collect_batch()
    ctx.sql("SET datafusion.tpu.device_sort_min_rows = 1")
    dev = ctx.sql(sql).collect_batch()
    for hc, dc in zip(host.columns, dev.columns):
        np.testing.assert_array_equal(hc.to_pylist(host.num_rows),
                                      dc.to_pylist(dev.num_rows))
