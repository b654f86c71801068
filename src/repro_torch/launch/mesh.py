"""Production and local meshes.

The port of ``repro.launch.mesh``.  Defined as FUNCTIONS (not module-level
constants) so importing this module touches no device and no process
group.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512 devices),
    by axis names and sizes: no one machine holds them, so the dry run
    lays its cells out over these without devices."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_local_mesh(device: str = "cuda"):
    """The ('data', 'model') mesh of the devices this process serves on.

    In an initialised ``torch.distributed`` process group it is a
    ``DeviceMesh`` of world x 1 (one card a rank), whose 'data' axis
    carries the group the corpus rows shard over: 1x1 in a one-rank
    group.  Without a process group (a DeviceMesh needs one) it is the
    1x1 :class:`AbstractMesh` of the one device.  ``device`` is the card
    ("cuda") unless the caller asks for the CPU; a missing card raises.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the local mesh runs on the card; "
                           "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no local mesh on device {dev}")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(dev.type, (dist.get_world_size(), 1),
                                mesh_dim_names=("data", "model"))
    return AbstractMesh((1, 1), ("data", "model"))


def local_model_devices(n: int, device: str = "cuda") -> list:
    """The ``n`` devices that stand for a mesh's 'model' axis in one
    process: ``cuda:0`` to ``cuda:n-1`` where there are n cards, else n
    times ``cuda:0`` (NCCL takes one rank a card, so several shards on one
    card share a process); ``["cpu"] * n`` when the caller asks for the
    CPU.  A missing card raises."""
    if device == "cpu":
        return ["cpu"] * n
    if device != "cuda":
        raise ValueError(f"no local model devices on {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the model axis runs on the card; "
                           "pass device='cpu' to run on the CPU")
    if torch.cuda.device_count() >= n:
        return [f"cuda:{j}" for j in range(n)]
    return ["cuda:0"] * n
