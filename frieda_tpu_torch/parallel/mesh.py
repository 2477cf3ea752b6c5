"""A (data, elem) mesh of shard slots and the collectives the sharded paths
need: the counterpart of `jax.sharding.Mesh` and of the collectives that
XLA's SPMD partitioner inserts for the JAX package's sharded paths
(`frieda_tpu/parallel/sharding.py`, `frieda_tpu/core/fri.py:182-205`).

Layout. One blob's (C, M) array (coefficients, evaluations, an FRI layer)
lies over the `elem` axis of one mesh row in the cyclic layout: natural
column j is local column j // S of shard j mod S (S = n_elem, a power of
two). Every pairing after the low-degree extension is (j, j + M/2) in
natural order (the Merkle inner levels, both folds), so while S divides M/2
both halves of a pair lie on one shard, and a shard's local array is a
smaller instance of the same problem: the single-device kernels run on it
unchanged. Only the extension's stages at bits below log2 S pair two shards
(`fft_sharded.py`).

Slots. Slot (d, e) is number d * n_elem + e. `devices` is this process's
list of devices, and it may repeat one device: S shards on one card are
the port's form of the JAX tests' virtual CPU devices. Two carriers:

  * in-process (`group` None): the process holds every slot, slot g on
    devices[g]; a swap or a gather is a view or a device copy;
  * process-group (a `torch.distributed` group; `multihost.global_mesh`):
    process r holds the slots r * len(devices) ... (r + 1) * len(devices) - 1
    on its devices, and a swap or a gather of another process's shard is a
    point-to-point message (`batch_isend_irecv`).

The sharded algorithms are written once against the shards this process
holds (`Sharded`), so they run on either carrier. They need two
collectives: `swap` (the partner shard e ^ 2^i of an exchange stage) and
`all_gather` (small pieces: subtree roots, decommitment reads, layers
narrower than 2S). The contiguous layout's all-to-all is not needed.
"""

from __future__ import annotations

import torch


def _check_device(device) -> torch.device:
    """A device a mesh may hold: the CPU, or a CUDA device when CUDA is
    available (nothing moves to the CPU by itself), a bare "cuda" with the
    current card's index, so that "cuda" and "cuda:0" name one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"a mesh on {dev} requested, but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (n_data, n_elem) grid of shard slots over `devices` (this process's
    devices; repeats allowed), in one process (`group` None) or over the
    processes of a `torch.distributed` group. n_elem is a power of two. A
    mesh larger than its devices raises ValueError."""

    def __init__(self, n_data: int, n_elem: int, devices, group=None):
        if n_data < 1 or n_elem < 1 or n_elem & (n_elem - 1):
            raise ValueError(f"mesh ({n_data}, {n_elem}): n_data >= 1 and n_elem a power of two")
        devices = [_check_device(d) for d in devices]
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist

            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
        slots = n_data * n_elem
        if not devices or slots > self.world * len(devices):
            raise ValueError(f"a ({n_data}, {n_elem}) mesh needs {slots} device slots; "
                             f"{self.world} process(es) x {len(devices)} devices")
        self.n_data, self.n_elem = n_data, n_elem
        self.log_elem = n_elem.bit_length() - 1
        self.group = group
        self.per_process = len(devices)
        first = self.rank * len(devices)
        self._local = {g: devices[g - first] for g in range(first, min(first + len(devices), slots))}
        self._cache: dict = {}

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "elem": self.n_elem}

    def owner(self, d: int, e: int) -> int:
        """The process (group rank) that holds slot (d, e)."""
        return (d * self.n_elem + e) // self.per_process

    def is_local(self, d: int, e: int) -> bool:
        return d * self.n_elem + e in self._local

    def device(self, d: int, e: int) -> torch.device:
        return self._local[d * self.n_elem + e]

    def local_elems(self, d: int) -> list:
        """The shards of row d this process holds."""
        return [e for e in range(self.n_elem) if self.is_local(d, e)]

    def rows(self) -> list:
        """The rows of which this process holds a shard."""
        return [d for d in range(self.n_data) if self.local_elems(d)]

    def home(self, d: int) -> torch.device:
        """The device of this process's first shard of row d: where the row's
        replicated work runs (the transcript and the grind, the tree tops,
        layers narrower than 2S)."""
        elems = self.local_elems(d)
        if not elems:
            raise ValueError(f"this process holds no shard of row {d}")
        return self.device(d, elems[0])

    def blocks(self, d: int) -> list:
        """[(e0, k, device)]: the runs of consecutive local shards of row d on
        one device. A run's shards are the rows of one (k, ...) tensor, so a
        kernel with a blob axis takes them in one launch."""
        out = []
        for e in self.local_elems(d):
            dev = self.device(d, e)
            if out and out[-1][0] + out[-1][1] == e and out[-1][2] == dev:
                out[-1] = (out[-1][0], out[-1][1] + 1, dev)
            else:
                out.append((e, 1, dev))
        return out

    def cached(self, key, build):
        """build(), kept under `key` for the mesh's lifetime: the per-block
        twiddle and fold tables, which go with the mesh."""
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def _p2p(self, sends: list, recvs: list) -> None:
        """Post (tensor, group rank, tag) sends and receives as one batch and
        wait for all of them. Both sides of a pair of processes post their
        messages in the same order, with tags that tell them apart."""
        if not sends and not recvs:
            return
        import torch.distributed as dist

        ops = [dist.P2POp(dist.isend, t, group=self.group, tag=tag, group_peer=r) for t, r, tag in sends]
        ops += [dist.P2POp(dist.irecv, t, group=self.group, tag=tag, group_peer=r) for t, r, tag in recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def swap(self, d: int, bit: int, parts: dict) -> dict:
        """{e: partner}: for each local shard e of row d (`parts`) whose
        partner q = e ^ 2^bit is not a local shard on e's device, a copy of
        q's part on e's device (received from q's process, or copied from
        another local device). Pairs on one device need no copy: the caller
        updates both halves there."""
        out, sends, recvs = {}, [], []
        for e in sorted(parts, key=lambda e: min(e, e ^ (1 << bit))):
            q = e ^ (1 << bit)
            dev = self.device(d, e)
            if self.is_local(d, q):
                if self.device(d, q) != dev:
                    out[e] = parts[q].to(dev)
                continue
            buf = torch.empty_like(parts[e])
            sends.append((parts[e].contiguous(), self.owner(d, q), min(e, q)))
            recvs.append((buf, self.owner(d, q), min(e, q)))
            out[e] = buf
        self._p2p(sends, recvs)
        return out

    def all_gather(self, d: int, parts: dict, numels) -> list:
        """Every shard's flat piece of row d, in shard order, on the row's
        home device. parts: {e: tensor} for this process's shards of row d;
        numels[e]: the size of shard e's piece, which every process knows."""
        home = self.home(d)
        out = [None] * self.n_elem
        for e, t in parts.items():
            out[e] = t.reshape(-1).to(home)
        if self.group is not None:
            dtype = next(iter(parts.values())).dtype
            peers = sorted({self.owner(d, e) for e in range(self.n_elem)} - {self.rank})
            sends = [(parts[e].reshape(-1).contiguous(), r, e) for r in peers for e in sorted(parts)]
            recvs = []
            for e in range(self.n_elem):
                if out[e] is None:
                    out[e] = torch.empty(numels[e], dtype=dtype, device=home)
                    recvs.append((out[e], self.owner(d, e), e))
            self._p2p(sends, recvs)
        return out


class Sharded:
    """One blob's (C, M) int32 array on one mesh row, in the cyclic layout:
    shard e holds natural columns e, e + S, e + 2S, ... as its (C, M / S)
    part. `blocks` holds this process's parts: [(e0, (k, C, M / S) tensor)],
    one per run of consecutive shards on one device (`Mesh.blocks`)."""

    def __init__(self, mesh: Mesh, row: int, blocks: list):
        self.mesh, self.row, self.blocks = mesh, row, blocks

    @property
    def width(self) -> int:
        return self.mesh.n_elem * self.blocks[0][1].shape[-1]

    @property
    def device(self) -> torch.device:
        return self.mesh.home(self.row)

    def part(self, e: int) -> torch.Tensor:
        """Local shard e's (C, M / S) part."""
        for e0, t in self.blocks:
            if e0 <= e < e0 + t.shape[0]:
                return t[e - e0]
        raise KeyError(f"shard {e} is not held here")

    @property
    def parts(self) -> dict:
        """{e: (C, M / S) part} of the local shards."""
        return {e0 + i: t[i] for e0, t in self.blocks for i in range(t.shape[0])}

    def whole(self):
        """The (S, C, M / S) block when one block holds every shard of the
        row, else None."""
        if len(self.blocks) == 1 and self.blocks[0][1].shape[0] == self.mesh.n_elem:
            return self.blocks[0][1]
        return None

    def gather(self) -> torch.Tensor:
        """The (C, M) array in natural order on the row's home device: for
        tests, and for layers narrower than 2S, which continue replicated."""
        parts = self.parts
        shape = next(iter(parts.values())).shape
        pieces = self.mesh.all_gather(self.row, parts, [shape[0] * shape[1]] * self.mesh.n_elem)
        return torch.stack([p.view(shape) for p in pieces], dim=-1).reshape(shape[0], -1)


def new_sharded(mesh: Mesh, row: int, shape: tuple) -> Sharded:
    """An uninitialized `Sharded` of local parts of `shape` (C, M / S)."""
    return Sharded(mesh, row, [(e0, torch.empty((k, *shape), dtype=torch.int32, device=dev))
                               for e0, k, dev in mesh.blocks(row)])
