"""Parallelism over ranks: counterpart of ``ode_rl_tpu/parallel``.

The ``'data'`` axis splits the batch (parallel/mesh.py), the ``'model'``
axis the output channels of the wide convolutions (parallel/tp.py), and
the ``'space'`` axis the frame height (parallel/sp.py); the dry run
(parallel/dryrun.py) holds each against the one-process step.
"""

from ode_rl_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, SPACE_AXIS,
                                        Mesh, gather_pytree, make_mesh,
                                        replicate, shard_batch, shard_pytree)
from ode_rl_torch.parallel.sp import make_sp_mesh, shard_batch_sp
from ode_rl_torch.parallel.tp import shard_params_tp, tp_param_spec

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SPACE_AXIS", "Mesh", "make_mesh",
           "make_sp_mesh", "replicate", "shard_batch", "shard_batch_sp",
           "shard_pytree", "gather_pytree", "tp_param_spec",
           "shard_params_tp"]
