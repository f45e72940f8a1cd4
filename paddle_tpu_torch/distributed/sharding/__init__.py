"""``paddle.distributed.sharding``: ``group_sharded_parallel`` and
``save_group_sharded_model``.  Counterpart of
``paddle_tpu/distributed/sharding/__init__.py``."""

import os

from ..fleet.sharding import group_sharded_parallel  # noqa: F401


def save_group_sharded_model(model, output, optimizer=None):
    from ...framework.io import save
    os.makedirs(output, exist_ok=True)
    save(model.state_dict(), os.path.join(output, "model.pdparams"))
    if optimizer is not None:
        save(optimizer.state_dict(), os.path.join(output, "model.pdopt"))
