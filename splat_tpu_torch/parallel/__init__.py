"""Multi-device rendering and training over ``torch.distributed``: the
port of ``splat_tpu.parallel`` (see :mod:`.sharding`), plus
:func:`shard_scene`, which cuts a rank's shard from a whole scene."""

from splat_tpu_torch.parallel.sharding import (
    make_mesh, render_batch_sharded, render_batch_sharded_tiled,
    render_batch_sharded_tiled_checked, render_sharded,
    render_sharded_tiled, render_sharded_tiled_checked, shard_scene)

__all__ = ["make_mesh", "render_sharded", "render_batch_sharded",
           "render_batch_sharded_tiled",
           "render_batch_sharded_tiled_checked",
           "render_sharded_tiled", "render_sharded_tiled_checked",
           "shard_scene"]
