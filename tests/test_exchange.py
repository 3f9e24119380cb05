"""Owned-slot all_to_all aggregation + distributed partitioned hash join
(parallel/exchange.py) against numpy oracles on an 8-device CPU mesh.

Covers the shuffle exchange:
  (a) global group count exceeding the per-shard table, via owned slots
  (b) a join where neither side fits broadcast
  (c) a zipf-skewed key distribution, salted
plus capacity-overflow reporting.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")


@pytest.fixture(scope="module")
def mesh():
    from datafusion_tpu.parallel.distributed import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (xla_force_host_platform_device_count)")
    return make_mesh(8)


def _oracle_group_sum(keys, valid, vals):
    out = {}
    for k, v in zip(keys[valid], vals[valid]):
        out[int(k)] = out.get(int(k), 0) + int(v)
    return out


def _table_to_dict(gk, gv, agg):
    gk = np.asarray(gk)
    gv = np.asarray(gv)
    agg = np.asarray(agg)
    return {int(k): int(a) for k, v, a in zip(gk, gv, agg) if v}


def test_shuffle_aggregate_high_cardinality(mesh):
    """Global distinct (600) far exceeds any single table the broadcast
    exchange could hold at per-shard size 128; owned slots scale it to
    8 * 128 = 1024."""
    from datafusion_tpu.parallel.exchange import (
        distributed_shuffle_group_aggregate)
    rng = np.random.default_rng(7)
    n = 8 * 512
    keys = rng.integers(0, 600, n).astype(np.int64)
    vals = rng.integers(0, 100, n).astype(np.int64)
    valid = rng.random(n) > 0.05
    gk, gv, aggs, ovf = distributed_shuffle_group_aggregate(
        mesh, keys, valid, {"s": ("sum", vals)},
        partial_groups=600, final_groups_per_shard=128)
    assert ovf == 0
    got = _table_to_dict(gk, gv, aggs["s"])
    assert got == _oracle_group_sum(keys, valid, vals)


def test_shuffle_aggregate_overflow_reported(mesh):
    from datafusion_tpu.parallel.exchange import (
        distributed_shuffle_group_aggregate)
    rng = np.random.default_rng(3)
    n = 8 * 256
    keys = rng.integers(0, 2000, n).astype(np.int64)   # > 8 * 16 capacity
    vals = np.ones(n, np.int64)
    _gk, _gv, _aggs, ovf = distributed_shuffle_group_aggregate(
        mesh, keys, np.ones(n, bool), {"c": ("count", vals)},
        partial_groups=2048, final_groups_per_shard=16)
    assert ovf > 0


def test_shuffle_aggregate_skewed_keys(mesh):
    """Zipf-skewed keys: the hot key collapses to one partial slot per
    shard before the exchange, so no salting is needed for aggregation."""
    from datafusion_tpu.parallel.exchange import (
        distributed_shuffle_group_aggregate)
    rng = np.random.default_rng(11)
    n = 8 * 512
    keys = np.minimum(rng.zipf(1.3, n), 400).astype(np.int64)
    vals = rng.integers(0, 10, n).astype(np.int64)
    valid = np.ones(n, bool)
    gk, gv, aggs, ovf = distributed_shuffle_group_aggregate(
        mesh, keys, valid, {"s": ("sum", vals)},
        partial_groups=512, final_groups_per_shard=128)
    assert ovf == 0
    assert _table_to_dict(gk, gv, aggs["s"]) == _oracle_group_sum(
        keys, valid, vals)


def _join_oracle(bk, bval, bg, bpay, pk, pval, pg, pvals):
    """sum(bpay + pvals) grouped by (pg | bg) over all equi-matches."""
    from collections import defaultdict
    build = defaultdict(list)
    for i in range(len(bk)):
        if bval[i]:
            build[int(bk[i])].append(i)
    sums = defaultdict(int)
    counts = defaultdict(int)
    for j in range(len(pk)):
        if not pval[j]:
            continue
        for i in build.get(int(pk[j]), ()):
            g = int(pg[j]) | int(bg[i])
            sums[g] += int(bpay[i]) + int(pvals[j])
            counts[g] += 1
    return dict(sums), dict(counts)


def _run_partitioned_join(mesh, bk, bval, bg, bpay, pk, pval, pg, pvals,
                          salt=1, fanout_cap=8,
                          final_groups_per_shard=64):
    from datafusion_tpu.parallel.exchange import (
        distributed_partitioned_join_aggregate)
    n_shards = 8
    build_cap = max(1, 4 * salt * len(bk) // (8 * n_shards) + 8)
    probe_cap = max(1, 4 * len(pk) // (8 * n_shards) + 8)
    return distributed_partitioned_join_aggregate(
        mesh,
        bk, bval, bg, {"bp": bpay},
        pk, pval, pg, {"pv": pvals},
        kinds={"bp": "sum", "pv": "sum", "c": "count"} | {},
        fills={"bp": 0, "pv": 0, "c": 0},
        final_groups_per_shard=final_groups_per_shard,
        build_cap=build_cap, probe_cap=probe_cap, fanout_cap=fanout_cap,
        salt=salt)


def test_partitioned_join_large_both_sides(mesh):
    """Neither side fits a broadcast table: 4096-row build x 4096-row
    probe, verified against a host oracle."""
    from datafusion_tpu.parallel.exchange import (
        distributed_partitioned_join_aggregate)
    rng = np.random.default_rng(5)
    nb = n = 8 * 512
    bk = rng.integers(0, 700, nb).astype(np.int64)
    bval = rng.random(nb) > 0.1
    bg = (rng.integers(0, 4, nb).astype(np.int64) << 8)
    bpay = rng.integers(0, 50, nb).astype(np.int64)
    pk = rng.integers(0, 700, n).astype(np.int64)
    pval = rng.random(n) > 0.1
    pg = rng.integers(0, 8, n).astype(np.int64)
    pvals = rng.integers(0, 50, n).astype(np.int64)

    gk, gv, aggs, ovf = distributed_partitioned_join_aggregate(
        mesh, bk, bval, bg, {"s": bpay}, pk, pval, pg, {"t": pvals},
        kinds={"s": "sum", "t": "sum"}, fills={"s": 0, "t": 0},
        final_groups_per_shard=16,
        build_cap=2 * 512, probe_cap=2 * 512, fanout_cap=16)
    assert ovf == 0
    sums, _counts = _join_oracle(bk, bval, bg, bpay, pk, pval, pg, pvals)
    got_s = _table_to_dict(gk, gv, aggs["s"])
    got_t = _table_to_dict(gk, gv, aggs["t"])
    got = {g: got_s.get(g, 0) + got_t.get(g, 0) for g in set(got_s) | set(got_t)}
    assert got == sums


def test_partitioned_join_skewed_salted(mesh):
    """Zipf-skewed probe keys: unsalted, the hot key's pairs all land on
    one shard; salt=4 spreads them (and still matches the oracle)."""
    from datafusion_tpu.parallel.exchange import (
        distributed_partitioned_join_aggregate)
    rng = np.random.default_rng(17)
    nb = 8 * 64
    n = 8 * 512
    bk = np.arange(nb).astype(np.int64) % 50
    bval = np.ones(nb, bool)
    bg = np.zeros(nb, np.int64)
    bpay = rng.integers(0, 5, nb).astype(np.int64)
    pk = np.minimum(rng.zipf(1.2, n), 50).astype(np.int64) - 1
    pval = np.ones(n, bool)
    pg = (pk % 8).astype(np.int64)
    pvals = rng.integers(0, 5, n).astype(np.int64)

    sums, _ = _join_oracle(bk, bval, bg, bpay, pk, pval, pg, pvals)
    for salt in (1, 4):
        gk, gv, aggs, ovf = distributed_partitioned_join_aggregate(
            mesh, bk, bval, bg, {"s": bpay}, pk, pval, pg, {"t": pvals},
            kinds={"s": "sum", "t": "sum"}, fills={"s": 0, "t": 0},
            final_groups_per_shard=16,
            # unsalted needs the full probe row budget on one shard; the
            # salted run spreads it
            build_cap=nb * max(salt, 1), probe_cap=n, fanout_cap=nb,
            salt=salt)
        assert ovf == 0, f"salt={salt}"
        got_s = _table_to_dict(gk, gv, aggs["s"])
        got_t = _table_to_dict(gk, gv, aggs["t"])
        got = {g: got_s.get(g, 0) + got_t.get(g, 0)
               for g in set(got_s) | set(got_t)}
        assert got == sums, f"salt={salt}"


def test_chained_shuffle_zipf_one_compile(mesh):
    """zipf(1.05) skew through a deliberately tiny per-round slot cap:
    the chained exchange absorbs the skew with extra while_loop ROUNDS
    inside ONE compiled program — exactly one trace per program shape,
    never a capacity retry (the round-2/3 recompile ladder is gone)."""
    from datafusion_tpu.parallel import exchange as ex
    rng = np.random.default_rng(42)
    n = 8 * 512
    keys = np.minimum(rng.zipf(1.05, n), 300).astype(np.int64)
    valid = np.ones(n, bool)
    before = len(ex.TRACE_LOG)
    for seed in (1, 2):            # same shape, different data
        v2 = np.random.default_rng(seed).integers(0, 10, n).astype(np.int64)
        gk, gv, aggs, ovf = ex.distributed_shuffle_group_aggregate(
            mesh, keys, valid, {"s": ("sum", v2)},
            partial_groups=512, final_groups_per_shard=128,
            slot_cap=8)            # tiny: forces many chained rounds
        assert ovf == 0
        assert _table_to_dict(gk, gv, aggs["s"]) == _oracle_group_sum(
            keys, valid, v2)
    traces = [t for t in ex.TRACE_LOG[before:] if t[0] == "shuffle"]
    assert len(traces) == 1, f"expected ONE compile, got {len(traces)}"


def test_chained_partitioned_join_zipf_one_compile(mesh):
    """zipf(1.05)-skewed probe keys with a small per-round probe cap and
    an EXACT host-computed build cap: one compile, zero retries, oracle-
    exact results. The hot key's rows stream through extra rounds."""
    from datafusion_tpu.parallel import exchange as ex
    rng = np.random.default_rng(9)
    nb, n = 8 * 64, 8 * 512
    bk = (np.arange(nb) % 50).astype(np.int64)
    bval = np.ones(nb, bool)
    bg = np.zeros(nb, np.int64)
    bpay = rng.integers(0, 5, nb).astype(np.int64)
    pk = np.minimum(rng.zipf(1.05, n), 50).astype(np.int64) - 1
    pval = np.ones(n, bool)
    pg = (pk % 8).astype(np.int64)
    # exact per-(sender, owner) build load from the host keys
    own = ex.host_owner(bk, 8)
    senders = np.arange(nb) // (nb // 8)
    per = np.bincount(senders * 9 + own, minlength=8 * 9).reshape(8, 9)
    build_cap = int(per[:, :8].max()) + 8
    before = len(ex.TRACE_LOG)
    for seed in (1, 2):
        pvals = np.random.default_rng(seed).integers(0, 5, n).astype(np.int64)
        gk, gv, aggs, ovf = ex.distributed_partitioned_join_aggregate(
            mesh, bk, bval, bg, {"s": bpay}, pk, pval, pg, {"t": pvals},
            kinds={"s": "sum", "t": "sum"}, fills={"s": 0, "t": 0},
            final_groups_per_shard=16,
            build_cap=build_cap, probe_cap=16, fanout_cap=16, salt=1)
        assert ovf == 0
        sums, _ = _join_oracle(bk, bval, bg, bpay, pk, pval, pg, pvals)
        got_s = _table_to_dict(gk, gv, aggs["s"])
        got_t = _table_to_dict(gk, gv, aggs["t"])
        got = {g: got_s.get(g, 0) + got_t.get(g, 0)
               for g in set(got_s) | set(got_t)}
        assert got == sums
    traces = [t for t in ex.TRACE_LOG[before:] if t[0] == "pjoin"]
    assert len(traces) == 1, f"expected ONE compile, got {len(traces)}"


def test_salting_spreads_hot_key(mesh):
    """The salted shuffle really uses more shards for one hot key."""
    import jax.numpy as jnp
    from datafusion_tpu.parallel.exchange import _owner
    hot = jnp.full(64, 7, jnp.int64)
    unsalted = np.unique(np.asarray(_owner(hot, 8)))
    salted = np.unique(np.asarray(_owner(hot, 8,
                                         jnp.arange(64, dtype=jnp.uint64) % 4)))
    assert len(unsalted) == 1
    assert len(salted) > 1
