"""Multi-device scaling: meshes of ranks, event-axis sharding, sweeps.

PyTorch counterpart of the JAX package's ``parallel`` package, on
``torch.distributed``:

  * **data axis** — independent frames, restarts, warm-start chains or
    sweep lanes split over the ranks of the mesh's ``data`` axis;
  * **event axis** — each rank votes its slice of a frame's events and the
    partial polarity planes are summed (``all_reduce``) over the ``event``
    group;
  * :mod:`.launch` starts the ranks (``torchrun``, or spawned processes)
    and :mod:`.dryrun` runs the steps once over an n-rank mesh.
"""

from .launch import run  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .sharding import (  # noqa: F401
    make_multichip_estimator,
    make_multichip_multistart,
    make_multichip_sequential,
    sharded_polarity_votes,
)
from .sweep import hyperparam_sweep, stack_events  # noqa: F401
