"""Several processes: the `torch.distributed` runtime, the process-group
mesh and the host-0 broadcast. Counterpart of
`frieda_tpu/parallel/multihost.py`.

The Fiat-Shamir channel is handled by design, not by messages: every
process that holds a shard of a blob runs the same transcript on its home
device from the same gathered roots (`core/fri.commit_phase_sharded`), so the
challenges agree everywhere, and every process assembles the same proof
bytes. What a process must learn from process 0 outside the prover (seeds,
job assignment, published proof bytes) goes through `broadcast_from_host0`;
`assert_same_across_hosts` guards determinism.

One process (no coordinator) is the common case: `initialize()` is then a
no-op that returns False, and the helpers are identities. Launch, one
process per card:

    from frieda_tpu_torch.parallel import multihost, sharding
    multihost.initialize(backend="nccl")        # torchrun's environment
    mesh = multihost.global_mesh(n_data=..., n_elem=...)
    com, proof = sharding.sharded_commit_and_prove(data, seed, cfg, mesh)

The backend is the caller's choice ("nccl" for cards, "gloo" for CPU
tensors); nothing here picks one from what the machine has.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str = "nccl") -> bool:
    """Start the `torch.distributed` runtime if (and only if) this is a
    multi-process launch; True if it is (now) live. Explicit arguments win
    (coordinator_address "host:port"), then torchrun's MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK; with neither, a no-op that returns
    False."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(f"multi-process launch needs a coordinator, a process count and a process "
                         f"id; got {coordinator_address!r}, {num_processes}, {process_id}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def _processes() -> tuple:
    """(process count, this process's index)."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def global_mesh(n_data: int | None = None, n_elem: int | None = None, devices=None):
    """(data, elem) mesh over every process's devices: each process passes
    its own (every CUDA device of the process by default), the same number
    in each. Slots are numbered process by process, so an n_elem that divides
    the per-process count keeps each blob's shards in one process. One
    process: `sharding.make_mesh`."""
    from .mesh import Mesh
    from .sharding import cuda_devices, make_mesh, mesh_shape

    world, _ = _processes()
    if world == 1:
        return make_mesh(n_data, n_elem, devices)
    devices = cuda_devices("global_mesh") if devices is None else list(devices)
    n_data, n_elem = mesh_shape(n_data, n_elem, world * len(devices))
    return Mesh(n_data, n_elem, devices, group=dist.group.WORLD)


def _carrier_device() -> torch.device:
    """Where the process group's messages live: the current card for NCCL,
    the CPU for the others."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_host0(value: np.ndarray | bytes) -> np.ndarray | bytes:
    """Process 0's value (bytes, or an array of the same shape and dtype in
    every process) in every process. One process: the value itself."""
    world, rank = _processes()
    if world == 1:
        return value
    dev = _carrier_device()
    if isinstance(value, bytes):
        n = torch.tensor([len(value) if rank == 0 else 0], dtype=torch.int64, device=dev)
        dist.broadcast(n, 0)
        buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=dev)
        if rank == 0 and value:
            buf.copy_(torch.frombuffer(bytearray(value), dtype=torch.uint8))
        dist.broadcast(buf, 0)
        return buf.cpu().numpy().tobytes()
    arr = np.ascontiguousarray(value)
    t = torch.from_numpy(arr.copy()).to(dev)
    dist.broadcast(t, 0)
    return t.cpu().numpy()


def assert_same_across_hosts(value: bytes, what: str = "value") -> None:
    """Raise AssertionError in every process whose bytes differ from process
    0's (a proof is a replicated computation: a difference is a bug, not a
    race). One process: nothing to compare."""
    world, rank = _processes()
    if world == 1:
        return
    ref = broadcast_from_host0(value)
    if ref != value:
        raise AssertionError(f"{what} diverged on process {rank} (len {len(value)} vs host-0 len {len(ref)})")
