"""Test configuration.

The tests run on the CPU backend unless `JAX_PLATFORMS` is set
explicitly (e.g. `JAX_PLATFORMS=cuda` to run them on a GPU). Multi-device
sharding tests run on a virtual 8-device CPU mesh
(`xla_force_host_platform_device_count`). Must be set before jax
initializes.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def ctx():
    import datafusion_tpu as df
    c = df.SessionContext()
    # most tests introspect via information_schema, mirroring the reference
    # test harness's with_information_schema(true)
    c.config.options.set("datafusion.catalog.information_schema", True)
    return c


@pytest.fixture()
def emp_ctx():
    import datafusion_tpu as df
    c = df.SessionContext()
    c.config.options.set("datafusion.catalog.information_schema", True)
    c.register_arrays("emp", {
        "id": np.array([1, 2, 3, 4, 5]),
        "dept": np.array(["a", "b", "a", "c", "b"]),
        "sal": np.array([100.0, 200.0, 300.0, 400.0, 500.0]),
        "bonus": np.array([10.0, np.nan, 30.0, 40.0, 50.0]),
    })
    c.register_arrays("dept", {
        "name": np.array(["a", "b", "d"]),
        "loc": np.array(["NY", "SF", "LA"]),
    })
    return c


def sql_dict(ctx, q):
    return ctx.sql(q).to_pydict()
