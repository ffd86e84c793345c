"""Parallel execution: the rank process group over the devices (`mesh`)
and the host fork pool (`host_pool`).

Counterpart of lighthouse_tpu/parallel. `host_pool` imports no torch
beyond what the package already loaded and is what the BLS host backend
and das/proofs pull in; the process-group helpers are exposed lazily, as
the JAX package exposes its mesh helpers.
"""

from . import host_pool  # noqa: F401

_MESH_SYMBOLS = ("Mesh", "batch_mesh", "close_mesh", "all_gather_rows", "shard_batch", "replicated",
                 "pad_to_multiple", "bucket_size")


def __getattr__(name):
    if name in _MESH_SYMBOLS or name == "mesh":
        from . import mesh

        if name == "mesh":
            return mesh
        return getattr(mesh, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
