"""Data parallelism over ranks (parallel/mesh.py).

Counterpart of ``ode_rl_tpu/parallel``: the ``'data'`` axis is ported;
the ``'model'`` (tensor-parallel) and ``'space'`` (height-sharded) axes
are not, and their entry points raise, naming their ROADMAP items.
"""

from ode_rl_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SP_ITEM,
                                        TP_ITEM, Mesh, make_mesh, replicate,
                                        shard_batch, shard_pytree)

SPACE_AXIS = "space"


def make_sp_mesh(*_args, **_kwargs):
    raise NotImplementedError(f"the 'space' axis (height-sharded frames) "
                              f"is not ported: {SP_ITEM}")


def shard_batch_sp(*_args, **_kwargs):
    raise NotImplementedError(f"the 'space' axis (height-sharded frames) "
                              f"is not ported: {SP_ITEM}")


__all__ = ["DATA_AXIS", "MODEL_AXIS", "SPACE_AXIS", "Mesh", "make_mesh",
           "make_sp_mesh", "replicate", "shard_batch", "shard_batch_sp",
           "shard_pytree"]
