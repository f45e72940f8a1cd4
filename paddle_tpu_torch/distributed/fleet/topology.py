"""The hybrid-parallel topology: counterpart of
``paddle_tpu/distributed/fleet/topology.py`` (Paddle's
``fleet/base/topology.py``: ``CommunicateTopology``,
``HybridCommunicateGroup``, ``ParallelMode``).

``CommunicateTopology`` is the JAX class: dims ``["data", "pipe",
"sharding", "sep", "model"]``, rank <-> coordinate by row-major order of
those dims (``get_rank``, ``get_coord``, ``get_axis_list``,
``get_comm_list``).

``HybridCommunicateGroup`` places the ranks as the JAX package places its
devices: on the mesh ``(pp, dp, sharding, sep, mp)``, pipeline outermost
and model innermost (the JAX ``_MESH_ORDER``), so rank ``r`` has the
coordinates the JAX package's device ``r`` has, and the ranks of one
tensor-parallel group are neighbours.  Each axis's groups are the port's
:func:`~paddle_tpu_torch.distributed.collective.new_group` over that
mesh's comm lists.  ``torch.distributed.new_group`` must be called by
every rank for every group in the same order, members or not, so all
groups of all axes are made in one fixed loop; a rank keeps the group of
each axis it belongs to.  A world of one process (no process group)
gets single-rank groups; a degree product other than the world size
raises.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..collective import new_group
from ..env import get_rank, get_world_size

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "ParallelMode"]


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = None
        self._world = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world

    def get_rank(self, **kwargs):
        coord = [kwargs[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(coord, tuple(self._dims)))

    def get_coord(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank,
                                                      tuple(self._dims)))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r in range(self._world)
                if self.get_coord(r)[axis] == index]

    def get_comm_list(self, axis_name):
        """Every group of ranks along ``axis_name`` (the ranks that differ
        in that coordinate alone), in rank order."""
        axis = self._parallel_names.index(axis_name)
        others = [i for i in range(len(self._dims)) if i != axis]
        groups = {}
        for r in range(self._world):
            coord = self.get_coord(r)
            groups.setdefault(tuple(coord[i] for i in others), []).append(r)
        return list(groups.values())


# the JAX package's mesh axis order: pp outermost ... mp innermost
_MESH_ORDER = ["pp", "dp", "sharding", "sep", "mp"]
_NAME_MAP = {"data": "dp", "pipe": "pp", "sharding": "sharding",
             "sep": "sep", "model": "mp"}
_MESH_NAMES = {v: k for k, v in _NAME_MAP.items()}


class HybridCommunicateGroup:
    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 dp_degree=1, mp_degree=1, pp_degree=1, sharding_degree=1,
                 sep_degree=1):
        if topology is not None:
            dims = {_NAME_MAP[n]: topology.get_dim(n)
                    for n in topology.get_hybrid_group_names()}
            dp_degree = dims.get("dp", 1)
            mp_degree = dims.get("mp", 1)
            pp_degree = dims.get("pp", 1)
            sharding_degree = dims.get("sharding", 1)
            sep_degree = dims.get("sep", 1)
        self._topo = topology
        self._dp_degree = dp_degree
        self._mp_degree = mp_degree
        self._pp_degree = pp_degree
        self._sharding_degree = sharding_degree
        self._sep_degree = sep_degree
        sizes = {"pp": pp_degree, "dp": dp_degree,
                 "sharding": sharding_degree, "sep": sep_degree,
                 "mp": mp_degree}
        world = get_world_size()
        if int(np.prod(list(sizes.values()))) != world:
            raise ValueError(f"hybrid degrees {sizes} need "
                             f"{int(np.prod(list(sizes.values())))} ranks; "
                             f"the job has {world}")
        # the ranks on the JAX package's mesh
        mesh = CommunicateTopology([_MESH_NAMES[a] for a in _MESH_ORDER],
                                   [sizes[a] for a in _MESH_ORDER])
        self.global_rank = get_rank()
        groups = {}
        for axis in _MESH_ORDER:              # every rank, every group
            for ranks in mesh.get_comm_list(_MESH_NAMES[axis]):
                g = new_group(ranks)
                if self.global_rank in ranks:
                    groups[axis] = g
        self._dp_group = groups["dp"]
        self._mp_group = groups["mp"]
        self._pp_group = groups["pp"]
        self._sharding_group = groups["sharding"]
        self._sep_group = groups["sep"]

    # ---- parallel mode
    def get_parallel_mode(self):
        if self._mp_degree > 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._pp_degree > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._sharding_degree > 1:
            return ParallelMode.SHARDING_PARALLEL
        return ParallelMode.DATA_PARALLEL

    def topology(self):
        return self._topo

    def get_global_rank(self):
        return self.global_rank

    # ---- accessors (the JAX package's and Paddle's)
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_data_parallel_rank(self):
        return self._dp_group.rank

    def get_data_parallel_group(self):
        return self._dp_group

    def get_data_parallel_group_src_rank(self):
        return 0

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_model_parallel_rank(self):
        return self._mp_group.rank

    def get_model_parallel_group(self):
        return self._mp_group

    def get_model_parallel_group_src_rank(self):
        return 0

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_stage_id(self):
        return self._pp_group.rank

    def get_pipe_parallel_group(self):
        return self._pp_group

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sharding_parallel_rank(self):
        return self._sharding_group.rank

    def get_sharding_parallel_group(self):
        return self._sharding_group

    def get_sharding_parallel_group_src_rank(self):
        return 0

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_sep_parallel_rank(self):
        return self._sep_group.rank

    def get_sep_parallel_group(self):
        return self._sep_group

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_p2p_groups(self):
        return self._pp_group
