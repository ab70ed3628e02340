"""Starting the process group, the hybrid mesh and per-process data
slicing (``physicedit_tpu/parallel/multihost.py``).

The JAX package runs one controller per host over that host's chips; the
port runs one process per GPU, launched by ``torchrun`` (or any launcher
that gives each process its rank).  So where JAX's unit of data loading is
a host, the port's is a rank of the ``data`` axis: the ranks of one model
group load the same rows (deviation D3 in ROADMAP.md).  With one process
every helper degrades to the single-process case, as in JAX.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from physicedit_torch.parallel.sharding import DATA_AXIS, create_mesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device: str = "cuda") -> None:
    """Start the default process group: NCCL for ``device="cuda"`` (this
    process's GPU is ``LOCAL_RANK``), Gloo when the caller asks for the CPU.

    With no arguments the rank, world size and rendezvous come from the
    launcher's environment (``torchrun``: ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); ``coordinator_address`` is a
    ``host:port`` to rendezvous at instead.  Nothing happens for a single
    process, nor when the group is already up, so it is safe to call twice.
    """
    world = num_processes if num_processes is not None \
        else int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init, world_size=world,
                            rank=rank)


def is_main_process() -> bool:
    """True outside a process group and on its first rank, the one that
    writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def create_hybrid_mesh(n_data: int, n_model: int, device: str = "cuda"):
    """The (``data``, ``model``) mesh with the model axis inside one node
    and the data axis across nodes: ``create_mesh`` puts a model group on
    consecutive ranks, which ``torchrun`` places on one node when
    ``n_model`` divides the processes a node runs (``LOCAL_WORLD_SIZE``).
    One process: the plain mesh."""
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", str(n_data * n_model)))
    if per_node % n_model:
        raise ValueError(f"model axis {n_model} must divide the {per_node} processes of a node")
    return create_mesh(n_data, n_model, device)


def host_local_batch_slice(global_batch: int, mesh=None) -> tuple[int, int]:
    """(start, size) of this process's rows of the global batch: the rows
    of its coordinate on the mesh's ``data`` axis, or, without a mesh, of
    its rank in the world (each process its own data shard, JAX's
    per-host view)."""
    if mesh is not None:
        n, me = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)), mesh.get_local_rank(DATA_AXIS)
    elif dist.is_initialized():
        n, me = dist.get_world_size(), dist.get_rank()
    else:
        n, me = 1, 0
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over {n} data ranks")
    per = global_batch // n
    return me * per, per


def _device_of(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def global_batch_from_host_shards(local_tree, mesh):
    """This process's rows as tensors on its device (JAX assembles a global
    array from the hosts' shards; in SPMD each rank keeps its own shard,
    and the layers' collectives see the rest).  local_tree: a dict / list /
    tuple nest of arrays or tensors."""
    dev = _device_of(mesh)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return torch.as_tensor(x).to(dev)

    return place(local_tree)
