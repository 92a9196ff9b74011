"""Multi-process initialisation (``gist_tpu/multihost.py``): the
process group of a run launched by ``torchrun`` (or given an explicit
coordinator), in place of the reference's manual
``--rank``/``--dist-url``/``--world-size`` plumbing.

Every process runs the same program; after :func:`init_multihost` the
meshes of :mod:`gist_tpu_torch.parallel.comm` span its ranks.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

# what torchrun (torch.distributed.run) sets in every process it starts
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   backend: Optional[str] = None,
                   device="cuda") -> bool:
    """Initialise ``torch.distributed``'s default process group.

    With no arguments it reads the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun``
    sets them); ``coordinator`` (an init method such as
    ``tcp://host:port`` or ``file:///path``) with ``num_processes`` and
    ``process_id`` names the group explicitly.  ``backend`` defaults to
    ``nccl`` for a CUDA ``device`` and ``gloo`` for the CPU; it is never
    switched on an error.  Returns True when it initialised the group,
    False when there is nothing to join (no arguments and no launcher
    environment) or the group is already initialised."""
    import torch.distributed as dist

    from gist_tpu_torch.parallel.comm import default_backend, rank_device
    explicit = coordinator is not None
    launched = all(v in os.environ for v in _LAUNCHER_ENV)
    if not explicit and not launched:
        return False
    if dist.is_initialized():
        warnings.warn("init_multihost called with the process group "
                      "already initialised; skipping")
        return False
    backend = backend or default_backend(device)
    kwargs = {"backend": backend}
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes "
                             "and process_id")
        kwargs.update(init_method=coordinator, world_size=num_processes,
                      rank=process_id)
    if backend == "nccl":
        # the rank's card before the communicator exists
        rank_device(device)
    dist.init_process_group(**kwargs)
    return True
