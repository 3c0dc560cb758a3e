"""Device meshes over the ranks of the process group.

Counterpart of ``svc_inference_pipeline_tpu/parallel/mesh.py``: a
``DeviceMesh`` with named axes over the ranks (one process per device),

* ``data``  — batch data parallelism,
* ``model`` — tensor parallelism (channel/head sharding), and the time
  shards of the sequence-parallel Whisper encoder,
* ``pipe``  — the GPipe stages of the denoiser, where
  ``cfg.parallel.pipeline_stages > 1``.

JAX's GSPMD inserts the collectives; here each module runs its own over the
group of its axis (:func:`axis_group`). A mesh over all ranks comes from
``init_device_mesh``; a smaller one (the first ``need`` ranks) from
``DeviceMesh`` over those ranks, which every rank must build.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from svc_inference_pipeline_tpu_torch.parallel.distributed import current_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def _device_type() -> str:
    return current_device().type


def mesh_over(ranks: Sequence[int], shape: Sequence[int], axis_names: Sequence[str]) -> DeviceMesh:
    """A mesh of ``shape`` over ``ranks`` (row-major), named ``axis_names``."""
    world = dist.get_world_size()
    ranks = list(ranks)
    if len(ranks) == world and ranks == list(range(world)):
        return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(axis_names))
    return DeviceMesh(_device_type(), torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_mesh(data: int = -1, model: int = 1, ranks: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS), pipe: int = 1) -> DeviceMesh:
    """A (data x model) mesh, with a trailing ``pipe`` axis when ``pipe > 1``.

    ``data=-1`` takes all the remaining ranks. Rank order follows
    ``ranks`` (default: the process group's), so the model axis, whose
    collectives run in every layer, joins adjacent ranks."""
    ranks = list(ranks if ranks is not None else range(dist.get_world_size()))
    n = len(ranks)
    inner = model * pipe
    if data == -1:
        assert n % inner == 0, (n, model, pipe)
        data = n // inner
    need = data * inner
    assert need <= n, f"mesh {data}x{model}x{pipe} needs {need} ranks, have {n}"
    shape, names = (data, model), tuple(axis_names)
    if pipe > 1:
        shape, names = (data, model, pipe), names + (PIPE_AXIS,)
    return mesh_over(ranks[:need], shape, names)


def mesh_from_config(cfg) -> DeviceMesh:
    """The mesh of ``cfg.parallel``: data and model sizes and axis names,
    and the ``pipe`` axis of ``pipeline_stages``."""
    p = cfg.parallel
    return make_mesh(
        data=p.get("data_parallel_size", -1),
        model=p.get("model_parallel_size", 1),
        axis_names=(p.get("data_axis", DATA_AXIS), p.get("model_axis", MODEL_AXIS)),
        pipe=int(p.get("pipeline_stages", 1)),
    )


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (1 without a mesh or such an axis)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's index along ``axis`` (0 without a mesh or such an axis)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group of this rank's ``axis`` (None where the axis has
    size 1: no collective is needed there)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)

