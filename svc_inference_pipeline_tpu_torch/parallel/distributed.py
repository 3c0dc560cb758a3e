"""Multi-process initialisation: one process per device.

Counterpart of ``svc_inference_pipeline_tpu/parallel/distributed.py``. JAX
rendezvouses its processes with ``jax.distributed.initialize``; here each
process joins a ``torch.distributed`` process group and owns one device,
and every collective of the package is written out over that group. The
same environment variables configure it:

* ``SVC_COORDINATOR`` (host:port of rank 0's TCP store),
* ``SVC_NUM_PROCESSES`` (the world size),
* ``SVC_PROCESS_ID`` (this process's rank),
* ``SVC_LOCAL_RANK`` (optional: the card of this host to take; else the
  rank modulo the host's card count).

The backend is NCCL on the GPU and gloo on the CPU, unless ``backend=``
names one. A dead peer fails a collective after ``timeout`` seconds instead
of wedging the group. JAX's Cloud-TPU metadata discovery has no
counterpart: it only finds TPU hosts.

Typical entry point, one process per card:

    from svc_inference_pipeline_tpu_torch.parallel import distributed, mesh
    distributed.ensure_initialized()
    m = mesh.make_mesh(data=-1, model=2)

:func:`spawn` runs a function on N local processes that are joined into one
group through a file store: the tests and ``chip_smoke.py`` use it.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from svc_inference_pipeline_tpu_torch.utils.devices import resolve_device

DEFAULT_TIMEOUT_S = 60.0

_DEVICE: Optional[torch.device] = None


def is_distributed_env() -> bool:
    """True when multi-process coordination is configured."""
    if os.environ.get("SVC_COORDINATOR"):
        return True
    return int(os.environ.get("SVC_NUM_PROCESSES", "1") or "1") > 1


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def bind_device(rank: int, device=None) -> torch.device:
    """This process's device: the CPU when ``device`` asks for it, else the
    card ``SVC_LOCAL_RANK`` (or ``rank`` modulo the host's card count)."""
    global _DEVICE
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("SVC_LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        dev = torch.device("cuda", dev.index if dev.index is not None else local)
        torch.cuda.set_device(dev)
    _DEVICE = dev
    return dev


def current_device() -> torch.device:
    """The device :func:`bind_device` gave this process (the CPU before any)."""
    return _DEVICE or torch.device("cpu")


def ensure_initialized(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, device=None, backend: Optional[str] = None,
                       timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group once; True when a multi-process group is set
    up (or already was), False for the single-process no-op. Explicit
    arguments win over the environment. ``device`` as in
    :func:`bind_device` (None: the GPU)."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("SVC_COORDINATOR")
    if num_processes is None and os.environ.get("SVC_NUM_PROCESSES"):
        num_processes = int(os.environ["SVC_NUM_PROCESSES"])
    if process_id is None and os.environ.get("SVC_PROCESS_ID"):
        process_id = int(os.environ["SVC_PROCESS_ID"])

    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError(
                "ensure_initialized: a coordinator address needs the process "
                "topology too — set SVC_NUM_PROCESSES and SVC_PROCESS_ID (or "
                "pass num_processes/process_id)"
            )
        dev = bind_device(process_id, device)
        dist.init_process_group(backend or default_backend(dev), init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout))
        return True
    if num_processes is not None and num_processes > 1:
        raise ValueError(
            "ensure_initialized: SVC_NUM_PROCESSES > 1 but no SVC_COORDINATOR "
            "— refusing to run as independent single-process copies"
        )
    return False


def process_info() -> dict:
    """Process topology for logs and metrics."""
    up = dist.is_available() and dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": torch.cuda.device_count() if current_device().type == "cuda" else 1,
        "global_devices": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else None,
        "device": str(current_device()),
    }


# ---------------------------------------------------------------------------
# local multi-process runs
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world_size, args, backend, init_file, out_dir, timeout, threads, device):
    torch.set_num_threads(threads)
    try:
        dev = bind_device(rank, device)
        dist.init_process_group(backend or default_backend(dev), init_method=f"file://{init_file}",
                                world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        result = fn(rank, world_size, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # the parent reads the traceback and fails the run
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def spawn(fn: Callable, world_size: int, args: Sequence[Any] = (), backend: Optional[str] = None,
          device=None, timeout: float = DEFAULT_TIMEOUT_S, join_timeout: float = 300.0,
          threads: int = 1, workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh processes
    joined into one group (``backend``, default by ``device``: NCCL on the
    GPU, gloo on the CPU) through a file store in ``workdir``; returns each
    rank's result (saved with ``torch.save``: keep it on the CPU). ``fn``
    must be importable by name. Collectives time out after ``timeout``
    seconds; the whole run after ``join_timeout``. A rank that raises, dies
    or outlives ``join_timeout`` fails the run at once: the other ranks are
    killed and ``RuntimeError`` (or ``TimeoutError``) names the rank, with
    its traceback."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir) as out_dir:
        init_file = os.path.join(out_dir, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, tuple(args), backend, init_file, out_dir, timeout,
                                   threads, device))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} failed:\n{_rank_error(out_dir, failed[0], procs)}")
                if time.monotonic() > deadline:
                    stuck = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(f"ranks {stuck} still running after {join_timeout:.0f}s")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(f"rank {failed[0]} failed:\n{_rank_error(out_dir, failed[0], procs)}")
            return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(world_size)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(5)


def _rank_error(out_dir: str, rank: int, procs) -> str:
    path = os.path.join(out_dir, f"rank{rank}.err")
    if os.path.exists(path):
        with open(path) as f:
            return f.read()
    return f"exit code {procs[rank].exitcode}"
