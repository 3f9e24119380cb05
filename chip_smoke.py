"""Bring-up check: the engine's main path on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: TPC-H SF1, every phase
    python chip_smoke.py --devices 4  # four GPUs: the mesh path only

With no option, one process drives one GPU through the normal entry
point, `SessionContext` -> `ctx.sql(q).collect_batch()`, over TPC-H in
memory at SF1 (seed 1, all 8 tables, `register_tpch`):

1. environment: JAX version and devices, the card's name and power limit
   (from nvidia-smi), the compile-cache directory; no GPU -> exit 2;
2. generate and register the tables;
3. the 22 queries on the default (device) configuration: cold, second
   and warm seconds, and the operators that ran a device program;
4. the same 22 queries on a second context over the same tables on the
   host numpy path, each answer compared with the device answer;
5. one ORDER BY ... LIMIT and one window query over all of lineitem,
   above the device sort/window thresholds, each compared likewise;
6. device memory in use and the compiled memory analysis of the largest
   program of Q1 and of Q9.

The last line of a passing run is one JSON object,
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
Any mismatch exits 1 without it; any error propagates.

`--devices N` runs only the mesh path on N GPUs in this one process: the
TPC-H queries that plan a distributed operator at
`datafusion.tpu.mesh_devices = N`, compared with their one-device
answers, with the sharding of every program input printed; then
`__graft_entry__.dryrun_multichip(N)`, which checks itself against host
oracles.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np

SF = 1.0
SEED = 1
# float64 answers may differ in the last bits: the device reduces in
# another order (cumsum, segment sums) than the host. Integers, decimals
# (scaled int64), dates, strings and counts must match exactly.
FLOAT_RTOL = 1e-9
# a second context with these settings runs everything on the host
HOST_PATH = {
    "datafusion.tpu.device_aggregate": False,
    "datafusion.tpu.device_join_rows": False,
    "datafusion.tpu.device_sort_min_rows": 1 << 62,
    "datafusion.tpu.device_window_min_rows": 1 << 62,
}
SORT_SQL = ("SELECT l_orderkey, l_linenumber, l_extendedprice, l_shipdate "
            "FROM lineitem "
            "ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber "
            "LIMIT 1000")
# two PARTITION BYs: the windows evaluate over all rows at once (a shared
# PARTITION BY streams partition by partition instead, each too small to
# reach the device)
WINDOW_SQL = ("SELECT l_orderkey, l_linenumber, "
              "row_number() OVER (PARTITION BY l_orderkey "
              "ORDER BY l_linenumber) AS rn, "
              "sum(l_extendedprice) OVER (PARTITION BY l_suppkey "
              "ORDER BY l_orderkey, l_linenumber) AS running "
              "FROM lineitem")
SORT_MODULE = "datafusion_tpu.physical.plan.device_sort"
WINDOW_MODULE = "datafusion_tpu.device.window"


# ---- which device programs ran ----------------------------------------------
class ProgramLog:
    """While installed, wraps `jax.jit` so that every jitted program the
    engine calls is recorded under the current `label`: the module and
    name of the function it compiles (as "module:qualname"), the sharding
    of each array input, whether an input was split over several devices,
    and, for the call with the most input bytes, the abstract arguments,
    so that its compiled memory analysis can be read back. The engine
    jits at run time through `jax.jit`, so it sees the wrapper; programs
    jitted before `installed()` are not seen."""

    def __init__(self):
        self.label = None
        self.programs = collections.defaultdict(collections.Counter)
        self.shardings = collections.defaultdict(dict)
        self.sharded = collections.defaultdict(set)
        self.largest = {}

    @contextlib.contextmanager
    def installed(self):
        import jax
        real_jit = jax.jit

        def jit(fun, *args, **kwargs):
            jitted = real_jit(fun, *args, **kwargs)
            name = (f"{getattr(fun, '__module__', '?')}:"
                    f"{getattr(fun, '__qualname__', type(fun).__name__)}")

            def call(*a, **k):
                if self.label is not None:
                    self._record(name, jitted, a, k)
                return jitted(*a, **k)
            return call

        jax.jit = jit
        try:
            yield self
        finally:
            jax.jit = real_jit

    def _record(self, name, jitted, a, k):
        import jax
        leaves = jax.tree.leaves((a, k))
        if any(isinstance(x, jax.core.Tracer) for x in leaves):
            return   # a program called while another one traces
        label = self.label
        self.programs[label][name] += 1
        arrays = [x for x in leaves if isinstance(x, jax.Array)]
        self.shardings[label].setdefault(
            name, sorted({str(x.sharding) for x in arrays}))
        if any(len(x.sharding.device_set) > 1 and
               not x.sharding.is_fully_replicated for x in arrays):
            self.sharded[label].add(name)
        nbytes = sum(int(getattr(x, "nbytes", 0)) for x in leaves)
        if nbytes > self.largest.get(label, (-1,))[0]:
            self.largest[label] = (nbytes, name, jitted,
                                   jax.tree.map(_abstract, (a, k)))

    def modules(self, label):
        return {name.split(":")[0] for name in self.programs.get(label, ())}

    def memory_analysis(self, label):
        """(program name, input bytes, CompiledMemoryStats) of the
        largest program called under `label`."""
        nbytes, name, jitted, (a, k) = self.largest[label]
        return name, nbytes, jitted.lower(*a, **k).compile().memory_analysis()


def _abstract(x):
    import jax
    if isinstance(x, jax.Array):
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding,
                                    weak_type=x.weak_type)
    if isinstance(x, (np.ndarray, np.generic)):
        return jax.ShapeDtypeStruct(np.shape(x), x.dtype)
    return x


def device_operators(plan):
    """Names of the plan's operators whose metrics show time spent in a
    device program (a planned device operator that fell back to the host
    shows none)."""
    ran = []

    def walk(node):
        if node.metrics.sum("device_compute") > 0:
            ran.append(type(node).__name__)
        for c in node.children():
            walk(c)
    walk(plan)
    return ran


# ---- answers ---------------------------------------------------------------
def order_by_columns(sql):
    """Output columns named by the query's top-level ORDER BY, in order;
    stops at the first key that is not a plain column name (the rows are
    still ordered by that prefix)."""
    low = sql.lower()
    depth, start = 0, None
    for i, ch in enumerate(low):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif depth == 0 and low.startswith("order by", i) and \
                (i == 0 or not (low[i - 1].isalnum() or low[i - 1] == "_")):
            start = i + len("order by")
    if start is None:
        return []
    clause = re.split(r"\blimit\b", sql[start:], flags=re.I)[0]
    keys = []
    for item in clause.split(","):
        words = item.split()
        if not words or not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", words[0]):
            break
        if any(w.lower() not in ("asc", "desc", "nulls", "first", "last")
               for w in words[1:]):
            break
        keys.append(words[0].lower())
    return keys


def _host_columns(batch):
    """name -> (dtype text, values, valid) over the batch's rows; strings
    decoded, NULL slots zeroed so that they compare and sort alike."""
    n = batch.num_rows
    out = {}
    for f, c in zip(batch.schema.fields, batch.columns):
        data = np.asarray(c.data_host())[:n]
        v = c.validity_host()
        valid = np.ones(n, bool) if v is None else np.asarray(v, bool)[:n]
        if c.dtype.is_dict_coded:
            values = c.dictionary.values
            data = values[np.clip(data, 0, len(values) - 1)] if len(values) \
                else np.full(n, "", dtype=object)
            data = np.where(valid, data, "").astype(str)
        else:
            data = np.where(valid, data, np.zeros((), data.dtype))
        out[f.name] = (str(f.dtype), data, valid)
    return out


def _runs(cols, keys):
    """Run ids: consecutive rows equal on every key share an id."""
    n = len(next(iter(cols.values()))[1]) if cols else 0
    change = np.zeros(n, bool)
    for k in keys:
        _, data, valid = cols[k]
        change[1:] |= (data[1:] != data[:-1]) | (valid[1:] != valid[:-1])
    return np.cumsum(change)


def compare_batches(got, want, order_by=(), rtol=FLOAT_RTOL):
    """Mismatches between two result batches (empty when they agree).
    Rows compare as multisets, except that along `order_by` (output
    column names) the order must agree: rows are matched within each run
    of equal ORDER BY values, and the runs must line up. float64 values
    compare within `rtol` relative; everything else exactly."""
    if got.num_rows != want.num_rows:
        return [f"{got.num_rows} rows, expected {want.num_rows}"]
    g, w = _host_columns(got), _host_columns(want)
    if list(g) != list(w):
        return [f"columns {list(g)}, expected {list(w)}"]
    bad = [f"{name}: type {g[name][0]}, expected {w[name][0]}"
           for name in g if g[name][0] != w[name][0]]
    if bad:
        return bad
    keys = [k for k in order_by if k in g]
    runs_g, runs_w = _runs(g, keys), _runs(w, keys)
    if not np.array_equal(runs_g, runs_w):
        return [f"ORDER BY {keys}: rows in another order"]

    def sort_order(cols):
        sort_keys = [runs_g]
        for name, (_, data, valid) in cols.items():
            if data.dtype.kind == "U":
                both = np.concatenate([g[name][1], w[name][1]])
                data = np.searchsorted(np.unique(both), data)
            sort_keys += [data, valid]
        return np.lexsort(sort_keys[::-1])   # lexsort's primary key is last

    og, ow = sort_order(g), sort_order(w)
    for name in g:
        _, gd, gv = g[name]
        _, wd, wv = w[name]
        gd, gv, wd, wv = gd[og], gv[og], wd[ow], wv[ow]
        if not np.array_equal(gv, wv):
            bad.append(f"{name}: NULLs differ at "
                       f"{np.flatnonzero(gv != wv)[:5].tolist()}")
            continue
        if gd.dtype.kind == "f":
            close = (np.abs(gd - wd) <= rtol * np.maximum(np.abs(gd),
                                                         np.abs(wd))) \
                | (gd == wd) | (np.isnan(gd) & np.isnan(wd))
        else:
            close = gd == wd
        if not close.all():
            i = np.flatnonzero(~close)[:3]
            bad.append(f"{name}: {len(np.flatnonzero(~close))} values "
                       f"differ, e.g. {gd[i].tolist()} vs {wd[i].tolist()}")
    return bad


# ---- phases -----------------------------------------------------------------
def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def environment(n_devices):
    """Phase 1. Returns (jax device 0, card description)."""
    import jax
    print(f"jax {jax.__version__}; devices: {jax.devices()}", flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu" or len(jax.devices()) < n_devices:
        print(f"chip_smoke needs {n_devices} GPU(s); JAX found "
              f"{len(jax.devices())} {dev.platform} device(s)",
              file=sys.stderr)
        raise SystemExit(2)
    desc = card()
    print(f"card: {desc}", flush=True)
    from datafusion_tpu.device import compile_cache_dir
    print(f"compile cache: {compile_cache_dir()}", flush=True)
    return dev, desc


TABLES = ("region", "nation", "supplier", "part", "partsupp", "customer",
          "orders", "lineitem")


def context_over(ctx, settings):
    """A new context with `settings` over the tables `ctx` registered."""
    import datafusion_tpu as df
    out = df.SessionContext()
    for key, value in settings.items():
        out.config.set(key, value)
    for name in TABLES:
        out.register_table(name, ctx.get_table(name))
    return out


def make_contexts(sf=SF, seed=SEED):
    """Phase 2: (device context, host-path context, set-up seconds); both
    contexts read the same registered tables."""
    import datafusion_tpu as df
    from datafusion_tpu.tpch import register_tpch
    t0 = time.perf_counter()
    dev_ctx = df.SessionContext()
    register_tpch(dev_ctx, sf=sf, seed=seed)
    host_ctx = context_over(dev_ctx, HOST_PATH)
    setup = time.perf_counter() - t0
    rows = sum(b.num_rows for p in dev_ctx.get_table("lineitem").partitions
               for b in p)
    print(f"TPC-H sf={sf} seed={seed} generated and registered in "
          f"{setup:.3f} s; lineitem rows: {rows}", flush=True)
    return dev_ctx, host_ctx, setup


def _run(ctx, sql):
    frame = ctx.sql(sql)
    t0 = time.perf_counter()
    batch = frame.collect_batch()
    return batch, time.perf_counter() - t0, frame.executed_plan


def device_suite(dev_ctx, log, desc):
    """Phase 3: each query three times on the device path: cold, second
    (a join chain's second run compiles its speculative single-fetch
    program) and warm."""
    from datafusion_tpu.tpch import QUERIES
    answers = {}
    for n in sorted(QUERIES):
        log.label = f"Q{n}"
        batch, cold, plan = _run(dev_ctx, QUERIES[n])
        _, second, _ = _run(dev_ctx, QUERIES[n])
        _, warm, _ = _run(dev_ctx, QUERIES[n])
        answers[n] = batch
        ops = device_operators(plan)
        calls = sum(log.programs[log.label].values())
        print(f"Q{n:02d} rows={batch.num_rows} cold={cold:.3f}s "
              f"second={second:.3f}s warm={warm:.3f}s [{desc}] "
              f"device operators: "
              f"{', '.join(ops) or 'none'}; device program calls: {calls}",
              flush=True)
    log.label = None
    return answers


def host_suite(host_ctx, answers, log):
    """Phase 4: the same queries on the host path, compared."""
    from datafusion_tpu.tpch import QUERIES
    failures = []
    for n in sorted(QUERIES):
        log.label = f"host Q{n}"
        want, secs, _ = _run(host_ctx, QUERIES[n])
        bad = compare_batches(answers[n], want, order_by_columns(QUERIES[n]))
        if log.programs.get(log.label):
            bad.append(f"host path called device programs: "
                       f"{sorted(log.programs[log.label])}")
        print(f"Q{n:02d} host={secs:.3f}s "
              f"{'match' if not bad else 'MISMATCH ' + '; '.join(bad)}",
              flush=True)
        failures += [f"Q{n}: {b}" for b in bad]
    log.label = None
    return failures


def sort_and_window(dev_ctx, host_ctx, log, desc):
    """Phase 5: the device sort and the fused device window program over
    all of lineitem, each compared with the host path."""
    failures = []
    for tag, sql, module in (("sort", SORT_SQL, SORT_MODULE),
                             ("window", WINDOW_SQL, WINDOW_MODULE)):
        log.label = tag
        got, cold, _ = _run(dev_ctx, sql)
        _, warm, _ = _run(dev_ctx, sql)
        log.label = None
        want, host_secs, _ = _run(host_ctx, sql)
        bad = compare_batches(got, want, order_by_columns(sql))
        if module not in log.modules(tag):
            bad.append(f"no program of {module} ran")
        print(f"{tag}: rows={got.num_rows} cold={cold:.3f}s "
              f"warm={warm:.3f}s host={host_secs:.3f}s [{desc}] device "
              f"programs: {sorted(log.modules(tag))} "
              f"{'match' if not bad else 'MISMATCH ' + '; '.join(bad)}",
              flush=True)
        failures += [f"{tag}: {b}" for b in bad]
    return failures


def memory(dev, log, labels=("Q1", "Q9")):
    """Phase 6: device memory, and the compiled memory analysis of the
    largest program of each labelled query."""
    stats = dev.memory_stats()
    if stats is not None:
        print(f"device memory: peak_bytes_in_use="
              f"{stats.get('peak_bytes_in_use')} "
              f"bytes_limit={stats.get('bytes_limit')}", flush=True)
    for label in labels:
        name, nbytes, ma = log.memory_analysis(label)
        print(f"{label} largest program {name} (input bytes {nbytes}): "
              f"{ma}", flush=True)


def mesh(mesh_ctx, dev_ctx, log):
    """The mesh path (`mesh_ctx`, with `datafusion.tpu.mesh_devices`
    set), compared with one-device answers (`dev_ctx`)."""
    from datafusion_tpu.physical.plan.distributed_aggregate import (
        DistributedAggregateExec)
    from datafusion_tpu.tpch import QUERIES
    n_devices = int(mesh_ctx.config.options.get(
        "datafusion.tpu.mesh_devices"))

    def distributed(node):
        return isinstance(node, DistributedAggregateExec) or any(
            distributed(c) for c in node.children())

    failures, ran = [], 0
    for n in sorted(QUERIES):
        if not distributed(mesh_ctx.sql(QUERIES[n]).create_physical_plan()):
            continue
        want, one_secs, _ = _run(dev_ctx, QUERIES[n])
        log.label = f"mesh Q{n}"
        got, secs, plan = _run(mesh_ctx, QUERIES[n])
        bad = compare_batches(got, want, order_by_columns(QUERIES[n]))
        ops = device_operators(plan)
        if any(op.startswith("Distributed") for op in ops):
            ran += 1
            if not log.sharded[log.label]:
                bad.append("no device program received a row-sharded input")
        print(f"Q{n:02d} mesh={secs:.3f}s one-device={one_secs:.3f}s "
              f"device operators: {', '.join(ops) or 'none (host fallback)'}"
              f" {'match' if not bad else 'MISMATCH ' + '; '.join(bad)}",
              flush=True)
        for name, shardings in log.shardings[log.label].items():
            print(f"    {name}: {shardings}", flush=True)
        failures += [f"mesh Q{n}: {b}" for b in bad]
    log.label = None
    if not ran:
        failures.append(f"no TPC-H query ran a distributed operator at "
                        f"mesh_devices={n_devices}")
    import __graft_entry__
    __graft_entry__.dryrun_multichip(n_devices)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the mesh path on this many GPUs")
    args = ap.parse_args(argv)
    dev, desc = environment(args.devices)
    log = ProgramLog()
    with log.installed():
        dev_ctx, host_ctx, _ = make_contexts()
        if args.devices > 1:
            mesh_ctx = context_over(
                dev_ctx, {"datafusion.tpu.mesh_devices": args.devices})
            failures = mesh(mesh_ctx, dev_ctx, log)
        else:
            answers = device_suite(dev_ctx, log, desc)
            failures = host_suite(host_ctx, answers, log)
            failures += sort_and_window(dev_ctx, host_ctx, log, desc)
            memory(dev, log)
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), flush=True)
        return 1
    import jax
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
