"""Distributed execution over a jax.sharding.Mesh.

Reference parity: the reference's intra-process partition parallelism
(SURVEY.md §2.6) mapped to chips: partitions = devices, RepartitionExec's
hash exchange = collectives over the device interconnect (`all_gather`/
`psum` via shard_map),
two-phase aggregation = per-shard partial + ownership-filtered final.
"""
from .distributed import (  # noqa: F401
    default_mesh, distributed_group_aggregate, distributed_join_aggregate,
    make_mesh,
)
