"""The (dp, tp) mesh (``mesh.py``) and a launcher of one-host worlds
(``launch.py``)."""

from .mesh import (make_batch_sharding, make_mesh, make_param_shardings,
                   make_replicated, shard_batch_tree)
