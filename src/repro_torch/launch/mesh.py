"""Production mesh construction, the twin of ``repro.launch.mesh``.

Defined as functions (never module-level constants) so importing this
module touches no device and no process group: the caller starts the
process group first (``torch.distributed.init_process_group``; the
dry-run starts the ``fake`` backend at the mesh's world size).  The
device type is CUDA unless the caller passes ``"cpu"``.
"""

from __future__ import annotations


def _mesh(shape: tuple, axes: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: 16x16 = 256 ranks ('data' x 'model'); the
    multi-pod variant adds a leading 'pod' axis (2 pods = 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_tiny_mesh(n_data: int = 2, n_model: int = 2,
                   device_type: str = "cuda"):
    """A small ('data', 'model') mesh for tests on a few ranks."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
