"""Process meshes on ``torch.distributed`` (port of ``bathymetric_gnn_tpu/parallel/mesh.py``).

JAX lays its devices out as a named ``Mesh`` (``data`` x ``graph``) and
lets XLA insert the collectives; here each process owns one device, the
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group with the same dimension names, and every
sharded path takes the process group of the dimension it reduces over
(``mesh.get_group("data")``, ``"graph"``). ``graph`` is the fast-changing
dimension: ranks r and r + 1 share a graph group when it is > 1, so halo
exchanges stay between neighbouring ranks, which ``torchrun`` puts on one
node.

A rank keeps only its own slice of a batch (``shard_batch_pytree``,
``host_local_batch_to_global``): each process loads and holds its own
tiles, and nothing is gathered through rank 0.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    """The DeviceMesh's device type: "cuda" on an NCCL default group, else
    "cpu" (a gloo group moves host tensors, whatever device computes)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(
    n_devices: Optional[int] = None,
    graph_axis: int = 1,
    axis_names: Tuple[str, ...] = ("data", "graph"),
    shape: Optional[Sequence[int]] = None,
) -> DeviceMesh:
    """A (data x graph) mesh over the ranks of the default process group
    (``initialize_distributed`` first). ``n_devices`` must be the world
    size when given (one device a process). ``shape`` lays out a mesh of
    more dimensions instead, e.g. (data, row, col) with ``axis_names``
    ("data", "row", "col")."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed() first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the world has {n} "
                         "processes (one device each)")
    if shape is None:
        if n % graph_axis != 0:
            raise ValueError(f"{n} devices not divisible by graph axis "
                             f"{graph_axis}")
        shape = (n // graph_axis, graph_axis)
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} / names {axis_names} do not "
                         f"fit a world of {n}")
    return init_device_mesh(_device_type(), shape,
                            mesh_dim_names=tuple(axis_names))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device=None,
    backend: Optional[str] = None,
) -> dict:
    """Join the process group (idempotent; a no-op for one process).

    With no arguments and no ``RANK`` / ``WORLD_SIZE`` in the environment
    it does nothing. Under ``torchrun`` (its environment) or with
    ``coordinator_address`` ("tcp://host:port" or "file://path"),
    ``num_processes`` and ``process_id`` it calls ``init_process_group``:
    NCCL on the card ``cuda:LOCAL_RANK`` (``local_device_ids[0]`` when
    given), gloo when ``device="cpu"``, or the ``backend`` named. It never
    picks another backend than that by itself. Returns {processes,
    process_id, local_devices, global_devices}, the JAX function's keys
    (one device a process)."""
    env = os.environ
    if not dist.is_initialized() and (
            coordinator_address or num_processes
            or ("RANK" in env and "WORLD_SIZE" in env)):
        cpu = device is not None and torch.device(device).type == "cpu"
        if backend is None:
            backend = "gloo" if cpu else "nccl"
        kw = {}
        if coordinator_address is not None:
            kw["init_method"] = coordinator_address
        if num_processes is not None:
            kw["world_size"] = int(num_processes)
        if process_id is not None:
            kw["rank"] = int(process_id)
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("initialize_distributed: the NCCL backend "
                                   "needs a CUDA device (pass device='cpu' "
                                   "for gloo)")
            local = (int(local_device_ids[0]) if local_device_ids
                     else int(env.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(local)
            kw["device_id"] = torch.device("cuda", local)
        dist.init_process_group(backend, **kw)
    if not dist.is_initialized():
        return {"processes": 1, "process_id": 0, "local_devices": 1,
                "global_devices": 1}
    n = dist.get_world_size()
    return {"processes": n, "process_id": dist.get_rank(),
            "local_devices": 1, "global_devices": n}


def make_host_mesh(
    graph_axis: int = 1,
    axis_names: Tuple[str, str] = ("data", "graph"),
    local_world_size: Optional[int] = None,
) -> DeviceMesh:
    """Node-aware mesh: the ``graph`` (halo) dimension is kept within a
    node whenever ``graph_axis`` divides the node's device count
    (``LOCAL_WORLD_SIZE``, torchrun's, or ``local_world_size``), so the
    per-layer halo exchanges stay on the node's links and only the data
    all-reduces cross nodes. Ranks are node-major (torchrun's order), so
    a [data, graph] layout with graph minor keeps each graph group on one
    node when graph_axis <= the node's count."""
    n = dist.get_world_size()
    per_node = int(local_world_size if local_world_size is not None
                   else os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % graph_axis != 0:
        raise ValueError(f"{n} devices not divisible by graph={graph_axis}")
    if graph_axis > per_node and graph_axis % per_node != 0:
        raise ValueError(
            f"graph axis {graph_axis} spans hosts unevenly "
            f"({per_node} devices/host)")
    return make_mesh(graph_axis=graph_axis, axis_names=axis_names)


def _rank_slice(x, index: int, parts: int, dim: int = 0):
    size = x.shape[dim]
    if size % parts:
        raise ValueError(f"dim {dim} of size {size} not divisible by "
                         f"{parts}")
    step = size // parts
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * step, (index + 1) * step)
    return x[tuple(sl)]


def _map(tree, fn):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    if tree is None or np.isscalar(tree):
        return tree
    return fn(tree)


def shard_batch_pytree(tree, mesh: DeviceMesh):
    """This rank's slice of a [B, ...] batch (arrays or tensors, in dicts,
    lists or dataclasses such as ``PaddedGraph``): B split over ``data``
    in rank order, replicated over the other dimensions."""
    d = mesh.get_local_rank("data")
    nd = mesh.size(mesh.mesh_dim_names.index("data"))
    return _map(tree, lambda x: _rank_slice(x, d, nd))


def host_local_batch_to_global(tree, mesh: DeviceMesh,
                               spec_fn: Optional[Callable] = None):
    """This rank's part of a batch its process loaded: each process passes
    its own [B_local, ...] arrays (nothing is gathered through rank 0).

    Without ``spec_fn`` the local batch is this rank's as it is: every
    process of the JAX function's host loads a different B_local, and
    here a process is one rank. ``spec_fn(x)`` names, per array, the mesh
    dimension of each of its dims (None: not split), e.g. ("data",
    "graph", None) for the halo model's [B, rows, W] tiles, which then
    reads as the full local batch of the ranks that share this rank's
    graph group: the rows are split over ``graph`` (the data dimension is
    split across processes already)."""
    if spec_fn is None:
        return tree
    names = mesh.mesh_dim_names

    def take(x):
        for dim, name in enumerate(spec_fn(x)):
            if name is None or name == "data":
                continue
            ax = names.index(name)
            x = _rank_slice(x, mesh.get_local_rank(name), mesh.size(ax),
                            dim)
        return x

    return _map(tree, take)
