"""Benchmark: TPC-H Q1 (SF1) through the FULL engine — SQL parse ->
logical optimize -> physical plan -> fused device aggregation on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
Exits non-zero when JAX finds no GPU.

Baseline: reference `tpch_mem` Q1 = 2182.44 ms for SF1 (~6.0M rows,
BASELINE.md) => ~2.75M rows/s. vs_baseline = our_throughput / theirs.
"""
from __future__ import annotations

import json
import time

import numpy as np

SF1_ROWS = 6_001_215
BASELINE_Q1_MS = 2182.44
BASELINE_ROWS_PER_SEC = SF1_ROWS / (BASELINE_Q1_MS / 1000.0)

Q1 = """
select
    l_returnflag, l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= date '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus
"""


def make_lineitem(n: int, seed: int = 0):
    """Vectorized SF1-shaped lineitem with exactly the Q1 columns."""
    from datafusion_tpu.common import dt
    from datafusion_tpu.common.batch import Batch
    from datafusion_tpu.common.column import Column, Dictionary
    from datafusion_tpu.common.schema import Field, Schema

    rng = np.random.default_rng(seed)
    # TPC-H money columns are DECIMAL(15,2): scaled int64 on device — exact
    # arithmetic
    dec2 = dt.decimal(15, 2)
    qty = (rng.integers(1, 51, n) * 100).astype(np.int64)
    price = rng.integers(90_000, 10_500_000, n).astype(np.int64)
    disc = (rng.integers(0, 11, n)).astype(np.int64)        # 0.00..0.10
    tax = (rng.integers(0, 9, n)).astype(np.int64)          # 0.00..0.08
    ship = rng.integers(8035, 10471, n).astype(np.int32)  # 1992..1998-08 days
    today = 9298  # 1995-06-17
    receipt = ship + rng.integers(1, 31, n)
    # returnflag from receiptdate, linestatus from shipdate (spec): rows with
    # ship <= today < receipt land in the (N, F) group
    rf = np.where(receipt <= today, np.where(rng.random(n) < 0.5, 0, 2), 1)
    ls = np.where(ship > today, 1, 0)   # F=0, O=1
    schema = Schema([
        Field("l_quantity", dec2, False),
        Field("l_extendedprice", dec2, False),
        Field("l_discount", dec2, False),
        Field("l_tax", dec2, False),
        Field("l_returnflag", dt.STRING, False),
        Field("l_linestatus", dt.STRING, False),
        Field("l_shipdate", dt.DATE, False),
    ])
    cols = [
        Column(dec2, qty), Column(dec2, price),
        Column(dec2, disc), Column(dec2, tax),
        Column(dt.STRING, rf.astype(np.int32), None,
               Dictionary(np.array(["A", "N", "R"], dtype=object))),
        Column(dt.STRING, ls.astype(np.int32), None,
               Dictionary(np.array(["F", "O"], dtype=object))),
        Column(dt.DATE, ship),
    ]
    return Batch(schema, cols, n)


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    import datafusion_tpu as df
    from datafusion_tpu.datasource.memory import MemTable

    ctx = df.SessionContext()
    batch = make_lineitem(SF1_ROWS)
    ctx.register_table("lineitem", MemTable(batch.schema, [[batch]]))

    # warmup: parse + plan + compile + stage to device
    out = ctx.sql(Q1).collect_batch()
    assert out.num_rows == 4, out.num_rows

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = ctx.sql(Q1).collect_batch()
        times.append(time.perf_counter() - t0)
    assert out.num_rows == 4
    best = min(times)
    rows_per_sec = SF1_ROWS / best
    print(json.dumps({
        "metric": "tpch_q1_sf1_full_engine_rows_per_sec",
        "value": round(rows_per_sec, 1),
        "unit": "rows/s",
        "vs_baseline": round(rows_per_sec / BASELINE_ROWS_PER_SEC, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
