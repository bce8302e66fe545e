"""Several processes, each with its own devices, bootstrapping one batch:
the TPU package's `parallel/multihost.py` over ``torch.distributed``.

- `initialize` joins the process group (coordinator and rank from its
  arguments or from MOSFHET_COORDINATOR, MOSFHET_NUM_PROCESSES and
  MOSFHET_PROCESS_ID); with no coordinator it is a no-op returning False,
  and one process runs as before.
- `make_global_mesh` gives each process its part of the global mesh, a
  mesh of its own devices (the `model` axis inside the process, so a
  gadget-row split never crosses processes); process r holds the global
  `data` axis's r-th block of rows.
- `replicate` sends a key (any tree of tensors) from process 0 to every
  process once, at setup; `gather_results` returns every process's results
  to every process once, at the end, in rank order.
- Between them the blind rotation runs with no collective at all
  (`pbs_on_global_mesh` is `parallel.mesh.pbs_on_mesh` on the process's own
  mesh and batch shard): the batch is embarrassingly parallel.

The collectives run on the gloo backend, on host copies: they are few and
off the hot loop, and gloo lets several processes share one card (NCCL does
not put two ranks on one device).  A process that cannot join, or a
collective that fails, raises.
"""

from __future__ import annotations

import datetime
import io
import os
import pickle

import torch
import torch.distributed as dist

from . import mesh as _mesh

JOIN_TIMEOUT_S = 300.0


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join (or skip) the process group; True if several processes run.

    ``coordinator`` is "host:port" of process 0's rendezvous; the arguments
    default to MOSFHET_COORDINATOR / MOSFHET_NUM_PROCESSES /
    MOSFHET_PROCESS_ID.  Raises when the group cannot be formed within
    JOIN_TIMEOUT_S."""
    coordinator = coordinator or os.environ.get("MOSFHET_COORDINATOR")
    if not coordinator:
        return False
    num_processes = num_processes or int(os.environ["MOSFHET_NUM_PROCESSES"])
    process_id = (process_id if process_id is not None
                  else int(os.environ["MOSFHET_PROCESS_ID"]))
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(model: int = 1, names=("data", "model"),
                     devices=None) -> _mesh.Mesh:
    """This process's part of the global (data, model) mesh: its
    ``devices`` (default: its CUDA cards; raises without one) as
    (len / model, model), so each model group stays inside one process.
    Process r holds rows [r D, (r+1) D) of the global data axis (D its own
    data rows), in `gather_results`' rank order."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass the devices "
                               "(torch.device('cpu') repeated for the CPU)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return _mesh.make_mesh(devices, model=model, names=names)


def _dumps(tree):
    """``tree`` pickled with its tensors taken out: (bytes, the tensors in
    the order the bytes name them)."""
    found = []

    class _Out(pickle.Pickler):
        def persistent_id(self, obj):
            if isinstance(obj, torch.Tensor):
                found.append(obj)
                return len(found) - 1
            return None

    buf = io.BytesIO()
    _Out(buf).dump(tree)
    return buf.getvalue(), found


def _loads(data: bytes, tensors):
    """The tree of `_dumps`'s bytes with ``tensors`` put in."""
    class _In(pickle.Unpickler):
        def persistent_load(self, pid):
            return tensors[pid]

    return _In(io.BytesIO(data)).load()


def _map_tensors(tree, fn):
    """``tree`` rebuilt with every tensor t replaced by fn(t), whatever
    holds them (modules, dataclasses, containers)."""
    data, found = _dumps(tree)
    return _loads(data, [fn(t) for t in found])


def distribute_batch(local_arr, mesh, data_axis: str = "data"):
    """This process's slice of the global batch (a tensor or a tree of them,
    such as a TLWE), every process's of the same size, placed on the first
    device of its ``mesh``; `pbs_on_global_mesh` splits it over the
    process's data rows.  Raises when the processes' slices differ in
    size."""
    if data_axis not in mesh.axis_names:
        raise ValueError(f"{data_axis!r} is not an axis of the mesh")
    _, found = _dumps(local_arr)
    sizes = [t.shape[0] for t in found]
    if process_count() > 1:
        every = [None] * process_count()
        dist.all_gather_object(every, sizes)
        if any(s != sizes for s in every):
            raise ValueError(f"the processes hold batches of sizes {every}")
    return _map_tensors(local_arr, lambda t: t.to(mesh.devices[0][0]))


def replicate(tree, mesh):
    """Process 0's ``tree`` (keys, test vectors: any picklable tree of
    tensors) on every process, placed on the first device of its mesh: one
    broadcast at setup.  The other processes' ``tree`` is ignored."""
    if process_count() > 1:
        if process_index() == 0:
            data, found = _dumps(tree)
            host = [t.detach().cpu().contiguous() for t in found]
            head = [data, [(tuple(t.shape), t.dtype) for t in host]]
        else:
            head = [None, None]
        dist.broadcast_object_list(head, src=0)
        data, meta = head
        if process_index() != 0:
            host = [torch.empty(shape, dtype=dtype) for shape, dtype in meta]
        for t in host:
            dist.broadcast(t, src=0)
        tree = _loads(data, host)
    return _map_tensors(tree, lambda t: t.to(mesh.devices[0][0]))


def gather_results(result):
    """Every process's ``result`` (a tensor or a tree of them, such as a
    TLWE) concatenated along the batch axis in rank order, on the host of
    every process: one all-gather at the end.  One process: its result on
    the host."""
    def gather(t):
        t = t.detach().cpu().contiguous()
        if process_count() == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(process_count())]
        dist.all_gather(parts, t)
        return torch.cat(parts)

    return _map_tensors(result, gather)


def pbs_on_global_mesh(mesh, bk, torus_base: int,
                       model_axis: str | None = None):
    """The batched functional bootstrap of this process's batch shard
    (`distribute_batch`) with a replicated key (`replicate`): returns
    ``run(tv, c) -> TLWE``, `parallel.mesh.pbs_on_mesh` on the process's
    own mesh (one K1 launch per data row at model 1, K8a and K8b per step
    at model m > 1).  No collective runs inside; `gather_results` joins the
    processes' outputs."""
    return _mesh.pbs_on_mesh(mesh, bk, torus_base,
                             data_axis=mesh.axis_names[0],
                             model_axis=model_axis)
