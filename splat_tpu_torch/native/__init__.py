"""Native (C++) host code, built with g++ at first use and loaded with
ctypes: the multithreaded PLY loader."""

from splat_tpu_torch.native.loader import NativeUnsupported, load_ply_native

__all__ = ["NativeUnsupported", "load_ply_native"]
