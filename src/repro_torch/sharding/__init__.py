"""Partitioning rules and their placement on a ``DeviceMesh`` (the port
of ``repro.sharding``)."""
from repro_torch.sharding.partition import (  # noqa: F401
    MeshShape, NamedSharding, P, batch_spec, cache_specs, distribute,
    is_dtensor, param_shardings, param_specs, placements,
)
