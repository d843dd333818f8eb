"""Scene file I/O."""

from splat_tpu_torch.io.cache import load_npz, load_scene_cached, save_npz
from splat_tpu_torch.io.ply import (PlyError, load_ply, read_ply_arrays,
                                    save_ply, trim_ply)

__all__ = ["PlyError", "load_ply", "save_ply", "trim_ply", "read_ply_arrays",
           "load_scene_cached", "save_npz", "load_npz"]
