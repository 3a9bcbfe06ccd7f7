"""Production meshes (port of ``repro.launch.mesh``). Functions, not module
constants: importing this touches no process group (a ``DeviceMesh`` needs
one, made by the caller first)."""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single pod (256 devices) or 2x16x16 two pods (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    ranks of the default process group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def mesh_name(mesh) -> str:
    return "x".join(f"{size}{name}" for name, size
                    in zip(mesh.mesh_dim_names, mesh.shape))
