"""datafusion_tpu — a vectorized SQL / DataFrame query engine whose hot
operators run as fused JAX/XLA programs on an accelerator.

Built from scratch in JAX with the capabilities of Apache DataFusion
(reference surveyed in SURVEY.md). The compute path is jitted XLA
programs over dense padded arrays + validity masks; strings
are dictionary-encoded; distribution is jax.sharding over a device mesh with
all-to-all shuffles instead of the reference's RepartitionExec channels.

Top-level API mirrors the reference:

    import datafusion_tpu as df
    ctx = df.SessionContext()
    ctx.register_parquet("lineitem", "lineitem.parquet")
    ctx.sql("SELECT count(*) FROM lineitem").show()
"""
from __future__ import annotations

import os

# 64-bit ints/floats are required for SQL semantics (int64 keys, decimal-as-
# scaled-int64). The env var only works when this package is imported
# before jax; when jax is already initialized the config update is the
# only reliable path — it MUST happen here (not in the lazily-imported
# device package), or the first staged arrays silently truncate to
# int32/float32 and f64 comparisons run in f32 (boundary rows vanish:
# Q6's `l_discount >= 0.05` dropped discount == 0.05).
os.environ.setdefault("JAX_ENABLE_X64", "1")
try:
    import jax as _jax

    _jax.config.update("jax_enable_x64", True)
except Exception:  # noqa: BLE001 — jax is optional at import time
    pass

__version__ = "0.1.0"

from .common import (  # noqa: F401,E402
    Batch, Column, ConfigOptions, DataFusionError, DataType, Field,
    ScalarValue, Schema, dt,
)


def __getattr__(name):
    # Lazy imports keep `import datafusion_tpu` light (no jax init) until a
    # session is created.
    if name in ("SessionContext", "SessionConfig"):
        from .api.context import SessionContext, SessionConfig
        return {"SessionContext": SessionContext, "SessionConfig": SessionConfig}[name]
    if name == "DataFrame":
        from .api.dataframe import DataFrame
        return DataFrame
    if name in ("col", "lit"):
        from .expr import expr_fns
        return getattr(expr_fns, name)
    if name in ("plan_to_sql", "expr_to_sql"):
        from .sql import unparser
        return getattr(unparser, name)
    if name in ("MemTable", "StreamTable", "TableProvider"):
        from . import datasource
        return getattr(datasource, name)
    if name in ("CatalogProvider", "SchemaProvider", "MemoryCatalogProvider",
                "MemorySchemaProvider"):
        from . import catalog
        return getattr(catalog, name)
    raise AttributeError(name)
