"""3D-Gaussian-Splatting PLY reader/writer (host side, NumPy).

Port of ``splat_tpu.io.ply``'s NumPy path with the same field semantics:
``x/y/z`` mean-centered (``center=True``), exp-activated ``scale_*``,
sigmoid ``opacity``, normalized scalar-first ``rot_*``, ``f_dc_*`` as the DC
band and ``f_rest_*`` transposed channel-major -> coefficient-major
(``f_rest_layout="inria"``) or copied verbatim (``"raw"``, the Rust loader's
quirk, PARITY.md).  Errors raise :class:`PlyError` naming the offending
header line or field.
"""

from __future__ import annotations

import io as _io
import os
import warnings

import numpy as np

from splat_tpu_torch.scene import GaussianScene


class PlyError(ValueError):
    """Malformed or unsupported PLY content."""


_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4",
    "double": "<f8", "float64": "<f8",
    "char": "<i1", "int8": "<i1",
    "uchar": "<u1", "uint8": "<u1",
    "short": "<i2", "int16": "<i2",
    "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def _parse_header(f):
    """Returns (format, [(element_name, count, [(prop_name, dtype), ...])])."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise PlyError(f"not a PLY file (magic={magic!r})")
    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    while True:
        line = f.readline()
        if not line:
            raise PlyError("unexpected EOF in header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] in ("comment", "obj_info"):
            continue
        if tokens[0] == "format":
            if len(tokens) < 2:
                raise PlyError(f"malformed format line: {line!r}")
            fmt = tokens[1]
        elif tokens[0] == "element":
            if len(tokens) < 3:
                raise PlyError(f"malformed element line: {line!r}")
            try:
                count = int(tokens[2])
            except ValueError:
                raise PlyError(f"bad element count in {line!r}") from None
            if count < 0:
                raise PlyError(f"negative element count in {line!r}")
            elements.append((tokens[1], count, []))
        elif tokens[0] == "property":
            if not elements:
                raise PlyError("property before any element")
            if len(tokens) < 3:
                raise PlyError(f"malformed property line: {line!r}")
            if tokens[1] == "list":
                raise PlyError("list properties are not supported for 3DGS")
            dt = _PLY_DTYPES.get(tokens[1])
            if dt is None:
                raise PlyError(f"unsupported property type {tokens[1]!r}")
            name = tokens[2]
            if any(name == p for p, _ in elements[-1][2]):
                raise PlyError(f"duplicate property {name!r}")
            elements[-1][2].append((name, dt))
        elif tokens[0] == "end_header":
            break
        else:
            warnings.warn(f"ignoring unrecognized PLY header line: "
                          f"{line.strip()!r}", stacklevel=3)
    if fmt not in ("binary_little_endian", "binary_big_endian", "ascii"):
        raise PlyError(f"unsupported format {fmt!r}")
    return fmt, elements


def read_ply_arrays(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """The 'vertex' element of a PLY as 1-D float32 arrays (raw values)."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        out: dict[str, np.ndarray] = {}
        for name, count, props in elements:
            dtype = np.dtype([(p, d) for p, d in props])
            if fmt == "ascii":
                text = [f.readline() for _ in range(count)]
                arr = np.loadtxt(_io.BytesIO(b"".join(text)),
                                 dtype=np.float64, ndmin=2)
                if arr.shape != (count, len(props)):
                    raise PlyError(
                        f"element {name}: expected {(count, len(props))} "
                        f"ascii values, got {arr.shape}")
                rec = np.zeros(count, dtype=dtype)
                for i, (p, _) in enumerate(props):
                    rec[p] = arr[:, i]
            else:
                buf = f.read(count * dtype.itemsize)
                if len(buf) < count * dtype.itemsize:
                    raise PlyError(
                        f"element {name}: payload truncated "
                        f"({len(buf)} < {count * dtype.itemsize} bytes)")
                rec = np.frombuffer(buf, dtype=dtype)
                if fmt == "binary_big_endian":
                    rec = rec.byteswap().view(rec.dtype.newbyteorder())
            if name == "vertex":
                for p, _ in props:
                    out[p] = np.ascontiguousarray(rec[p], dtype=np.float32)
        if not out:
            raise PlyError("no 'vertex' element found")
        return out


def arrays_to_scene(fields: dict[str, np.ndarray], *, center: bool = True,
                    f_rest_layout: str = "inria",
                    device=None) -> GaussianScene:
    """Apply the 3DGS activation pipeline and build a scene."""
    for req in ("x", "y", "z", "opacity"):
        if req not in fields:
            raise PlyError(f"missing required property {req!r}")
    n = fields["x"].shape[0]
    xyz = np.stack([fields["x"], fields["y"], fields["z"]], axis=1)
    if center and n > 0:
        xyz = xyz - xyz.mean(axis=0, keepdims=True)

    scales = np.exp(np.stack(
        [fields.get(f"scale_{i}", np.zeros(n, np.float32)) for i in range(3)],
        axis=1))
    opacities = 1.0 / (1.0 + np.exp(-fields["opacity"]))
    rots = np.stack(
        [fields.get(f"rot_{i}",
                    np.full(n, 1.0 if i == 0 else 0.0, np.float32))
         for i in range(4)], axis=1)
    rots = rots / np.maximum(
        np.linalg.norm(rots, axis=1, keepdims=True), 1e-12)

    dc = np.stack([fields.get(f"f_dc_{i}", np.zeros(n, np.float32))
                   for i in range(3)], axis=1)
    rest_names = sorted((k for k in fields if k.startswith("f_rest_")),
                        key=lambda k: int(k.split("_")[-1]))
    if rest_names:
        num_rest = len(rest_names)
        if num_rest % 3:
            raise PlyError(f"f_rest count {num_rest} not divisible by 3")
        rest = np.stack([fields[k] for k in rest_names], axis=1)
        k = num_rest // 3
        if f_rest_layout == "inria":
            rest = rest.reshape(n, 3, k).transpose(0, 2, 1)
        elif f_rest_layout == "raw":
            rest = rest.reshape(n, k, 3)
        else:
            raise PlyError(
                f"f_rest_layout must be 'inria' or 'raw', "
                f"got {f_rest_layout!r}")
    else:
        rest = np.zeros((n, 15, 3), np.float32)
    sh = np.concatenate([dc[:, None, :], rest], axis=1)

    return GaussianScene.create(
        means=xyz.astype(np.float32), quats=rots.astype(np.float32),
        scales=scales.astype(np.float32),
        opacities=opacities.astype(np.float32), sh=sh.astype(np.float32),
        device=device)


def native_enabled(native: bool | None, f_rest_layout: str) -> bool:
    """Whether :func:`load_ply` takes the C++ loader: on unless asked off
    (``native=False``, or ``SPLAT_TPU_NO_NATIVE`` set non-empty, the switch
    ``splat_tpu`` reads too), and never for ``f_rest_layout="raw"``, since
    the C++ loader hard-codes the INRIA transpose."""
    if f_rest_layout != "inria":
        return False
    if native is None:
        return not os.environ.get("SPLAT_TPU_NO_NATIVE")
    return native


def load_ply(path: str | os.PathLike, *, center: bool = True,
             native: bool | None = None, f_rest_layout: str = "inria",
             device=None) -> GaussianScene:
    """Load a pretrained 3DGS .ply into an activated scene on ``device``.

    native: read through the multithreaded C++ loader
      (:mod:`splat_tpu_torch.native`, built with g++ at first use) where
      the file has the standard schema (binary little-endian, all float32);
      other files take the NumPy reader.  None = on unless an environment
      variable turns it off (see :func:`native_enabled`).  A failed build
      raises.
    f_rest_layout: "inria" transposes the file's channel-major f_rest block
      to coefficient-major; "raw" copies it verbatim (the Rust loader's
      quirk, PARITY.md).
    """
    if native_enabled(native, f_rest_layout):
        from splat_tpu_torch.native.loader import (NativeUnsupported,
                                                   load_ply_native)
        try:
            return load_ply_native(path, center=center, device=device)
        except NativeUnsupported:
            pass          # not the standard schema: the NumPy reader
    return arrays_to_scene(read_ply_arrays(path), center=center,
                           f_rest_layout=f_rest_layout, device=device)


def save_ply(path: str | os.PathLike, scene: GaussianScene) -> None:
    """Write a scene as a 3DGS-schema binary PLY (inverse activations, so
    ``load_ply(center=False)`` reproduces the arrays)."""
    d = scene.to_numpy()
    n = d["means"].shape[0]
    eps = 1e-12
    op = np.clip(d["opacities"], eps, 1 - eps)
    cols: list[tuple[str, np.ndarray]] = []
    for i, name in enumerate("xyz"):
        cols.append((name, d["means"][:, i]))
    for name in ("nx", "ny", "nz"):
        cols.append((name, np.zeros(n, np.float32)))
    for i in range(3):
        cols.append((f"f_dc_{i}", d["sh"][:, 0, i]))
    rest = d["sh"][:, 1:, :].transpose(0, 2, 1).reshape(n, 45)
    for i in range(rest.shape[1]):
        cols.append((f"f_rest_{i}", rest[:, i]))
    cols.append(("opacity", np.log(op / (1 - op))))
    for i in range(3):
        cols.append((f"scale_{i}", np.log(np.maximum(d["scales"][:, i], eps))))
    for i in range(4):
        cols.append((f"rot_{i}", d["quats"][:, i]))

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name, _ in cols]
    header.append("end_header")
    rec = np.zeros(n, dtype=np.dtype([(name, "<f4") for name, _ in cols]))
    for name, v in cols:
        rec[name] = v.astype(np.float32)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def trim_ply(src: str | os.PathLike, dst: str | os.PathLike,
             count: int = 3) -> int:
    """Copy the first ``count`` splats of a PLY into a small fixture file
    (the reference's ``trim`` tool).  Returns the number written."""
    fields = read_ply_arrays(src)
    n = min(count, next(iter(fields.values())).shape[0])
    scene = arrays_to_scene({k: v[:n] for k, v in fields.items()},
                            center=False, device="cpu")
    save_ply(dst, scene)
    return n
