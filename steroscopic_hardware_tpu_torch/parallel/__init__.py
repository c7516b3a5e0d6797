"""The multi-process tier on ``torch.distributed`` (counterpart of
``steroscopic_hardware_tpu/parallel``): row-band SAD with a halo exchange,
scanline-sharded SGM, landmark-sharded BA and the edge-sharded pose graph,
each run SPMD by every rank of a (batch, rows) ``DeviceMesh`` on its own
shard. ``python -m steroscopic_hardware_tpu_torch.parallel`` runs each once
(``dryrun``).

``make_mesh`` and ``disparity_sharded`` are exported as in the JAX
package, but loaded at first use: importing a submodule loads nothing
else of the tier."""

__all__ = ["make_mesh", "disparity_sharded"]


def __getattr__(name):
    if name == "make_mesh":
        from steroscopic_hardware_tpu_torch.parallel.mesh import make_mesh

        return make_mesh
    if name == "disparity_sharded":
        from steroscopic_hardware_tpu_torch.parallel.disparity_shard import (
            disparity_sharded,
        )

        return disparity_sharded
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
