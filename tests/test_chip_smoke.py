"""chip_smoke.py off the GPU: it refuses the CPU, its answer comparator,
its ORDER BY reader, and a rehearsal of its phases at SF0.01 in a
process where pandas and pyarrow cannot be imported."""
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from datafusion_tpu.common.batch import Batch
from datafusion_tpu.common.column import Column
from datafusion_tpu.common import dt
from datafusion_tpu.common.schema import Field, Schema

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(**cols):
    fields, columns = [], []
    for name, spec in cols.items():
        if isinstance(spec, tuple):          # (DataType, data, validity)
            t, data, valid = spec
            c = Column(t, np.asarray(data), valid)
        else:
            c = Column.from_numpy(np.asarray(spec))
        fields.append(Field(name, c.dtype))
        columns.append(c)
    return Batch(Schema(fields), columns)


def test_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs 1 GPU" in out.stderr


DEC = dt.decimal(15, 2)
COMPARE_CASES = [
    # (name, got, want, order_by, should match)
    ("same ints", dict(a=[1, 2, 3]), dict(a=[1, 2, 3]), (), True),
    ("int differs", dict(a=[1, 2, 3]), dict(a=[1, 2, 4]), (), False),
    ("decimal exact", dict(m=(DEC, [100, 250], None)),
     dict(m=(DEC, [100, 251], None)), (), False),
    ("string differs", dict(s=["a", "b"]), dict(s=["a", "c"]), (), False),
    ("strings, other dictionaries", dict(s=["b", "a", "b"]),
     dict(s=["b", "a", "b", "z"][:3]), (), True),
    ("float within rtol", dict(f=[1.0, 3.0]),
     dict(f=[1.0 + 1e-12, 3.0]), (), True),
    ("float beyond rtol", dict(f=[1.0, 3.0]),
     dict(f=[1.0 + 1e-6, 3.0]), (), False),
    ("float nan", dict(f=[np.nan, 1.0]), dict(f=[np.nan, 1.0]), (), True),
    ("unordered permutation", dict(a=[1, 2, 3], s=["x", "y", "z"]),
     dict(a=[3, 1, 2], s=["z", "x", "y"]), (), True),
    ("ordered permutation", dict(a=[1, 2, 3]), dict(a=[3, 2, 1]),
     ("a",), False),
    ("ordered, ties permuted", dict(k=[1, 1, 2], v=[5, 6, 7]),
     dict(k=[1, 1, 2], v=[6, 5, 7]), ("k",), True),
    ("ordered, tie rows differ", dict(k=[1, 1, 2], v=[5, 6, 7]),
     dict(k=[1, 1, 2], v=[6, 6, 7]), ("k",), False),
    ("nulls differ", dict(a=(dt.INT64, [1, 2], np.array([True, False]))),
     dict(a=(dt.INT64, [1, 2], None)), (), False),
    ("null slots ignore data",
     dict(a=(dt.INT64, [1, 7], np.array([True, False]))),
     dict(a=(dt.INT64, [1, 9], np.array([True, False]))), (), True),
    ("row count", dict(a=[1, 2]), dict(a=[1, 2, 3]), (), False),
    ("type", dict(a=[1, 2]), dict(a=[1.0, 2.0]), (), False),
    ("column names", dict(a=[1]), dict(b=[1]), (), False),
]


@pytest.mark.parametrize("name,got,want,order_by,ok", COMPARE_CASES,
                         ids=[c[0] for c in COMPARE_CASES])
def test_compare_batches(name, got, want, order_by, ok):
    bad = chip_smoke.compare_batches(_batch(**got), _batch(**want),
                                     order_by)
    assert (not bad) == ok, bad


@pytest.mark.parametrize("sql,keys", [
    ("select a from t", []),
    ("select a, b from t order by a desc, b limit 5", ["a", "b"]),
    ("select a from t\norder by\n    a,\n    b", ["a", "b"]),
    ("select row_number() over (partition by g order by v) r from t", []),
    ("select x from (select a x from t order by a) order by x desc",
     ["x"]),
    ("select a, b from t order by a, b + 1", ["a"]),
    ("select a from t order by a nulls first", ["a"]),
    (chip_smoke.SORT_SQL, ["l_extendedprice", "l_orderkey",
                           "l_linenumber"]),
    (chip_smoke.WINDOW_SQL, []),
])
def test_order_by_columns(sql, keys):
    assert chip_smoke.order_by_columns(sql) == keys


REHEARSAL = r"""
import sys


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "pyarrow"):
            raise ImportError(name + " is not installed")


sys.meta_path.insert(0, Refuse())
import jax
import chip_smoke as cs

log = cs.ProgramLog()
with log.installed():
    dev_ctx, host_ctx, _ = cs.make_contexts(0.01, 1)
    # the device paths SF1 takes: sort, window and row-returning joins
    small = {"datafusion.tpu.device_sort_min_rows": 1024,
             "datafusion.tpu.device_window_min_rows": 1024,
             "datafusion.tpu.device_join_rows_min_spine": 1}
    for key, value in small.items():
        dev_ctx.config.set(key, value)
    answers = cs.device_suite(dev_ctx, log, "rehearsal")
    failures = cs.host_suite(host_ctx, answers, log)
    failures += cs.sort_and_window(dev_ctx, host_ctx, log, "rehearsal")
    cs.memory(jax.devices()[0], log)
    mesh_ctx = cs.context_over(
        dev_ctx, dict(small, **{"datafusion.tpu.mesh_devices": 4}))
    failures += cs.mesh(mesh_ctx, dev_ctx, log)
assert len(answers) == 22, sorted(answers)
assert not failures, failures
loaded = [m for m in sys.modules if m.split(".")[0] in ("pandas", "pyarrow")]
assert not loaded, loaded
print("REHEARSAL OK")
"""


def test_rehearsal_without_pandas_or_pyarrow():
    """The TPC-H SF0.01 path answers all 22 queries, matching the host
    path, with pandas and pyarrow unimportable; the sort, window, memory
    and 4-device mesh phases pass on the CPU backend."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", REHEARSAL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0 and "REHEARSAL OK" in out.stdout, \
        out.stdout[-4000:] + out.stderr[-4000:]
