"""Multi-device commit and prover over a (data, elem) mesh: the counterpart of
`frieda_tpu/parallel/sharding.py`.

  * `data` splits a batch of blobs over the mesh rows; each blob keeps its
    own transcript;
  * `elem` splits one blob's evaluations, trees and FRI layers over the
    shards of a row, in the cyclic layout of `mesh.py`. Where the JAX package
    leaves the data movement to XLA's SPMD partitioner, here it is written
    out: the extension's exchange stages (`fft_sharded.py`), the gathered
    subtree roots of each tree and the layers narrower than 2S
    (`core/merkle.py`, `core/fri.commit_phase_sharded`).

The roots, proof wire bytes and verdicts equal the single-device port's and
the JAX package's. The coefficients come from the `ingest` kernel, once a
blob, where the JAX package's mesh path unpacks them on the host
(`frieda_tpu/core/fri.py:541`); the bytes are the same. A mesh of one
process (`make_mesh`) may put every shard on one card; a process-group mesh
(`multihost.global_mesh`) returns, for a blob of a row it holds no shard of,
None.
"""

from __future__ import annotations

import torch

from ..config import PcsConfig
from ..core import fft, fri, merkle
from ..ops import ingest as ingest_ops
from ..utils.packing import log_total_for, upload_words
from .fft_sharded import sharded_evaluate
from .mesh import Mesh


def make_mesh(n_data: int | None = None, n_elem: int | None = None, devices=None) -> Mesh:
    """A (data, elem) mesh in this process over `devices` (every CUDA device
    by default; raises without CUDA), which may repeat a device: tests pass
    ["cpu"] * 8, one card takes ["cuda:0"] * S. With neither size given,
    n_data = 1 and n_elem = the device count; with one, the other divides the
    count. Raises AssertionError for a mesh larger than the devices, as the
    JAX package's does."""
    devices = cuda_devices("make_mesh") if devices is None else list(devices)
    n_data, n_elem = mesh_shape(n_data, n_elem, len(devices))
    return Mesh(n_data, n_elem, devices[: n_data * n_elem])


def cuda_devices(what: str) -> list:
    """Every CUDA device of this process; raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} over the CUDA devices requested, but CUDA is not available")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_shape(n_data: int | None, n_elem: int | None, n: int) -> tuple:
    """(n_data, n_elem) over n device slots, the JAX package's rule: with
    neither given (1, n); with one, the other is n divided by it.
    AssertionError when the mesh has no slot or more slots than n."""
    if n_data is None and n_elem is None:
        n_data, n_elem = 1, n
    elif n_data is None:
        n_data = n // n_elem
    elif n_elem is None:
        n_elem = n // n_data
    if not 0 < n_data * n_elem <= n:
        raise AssertionError(f"a ({n_data}, {n_elem}) mesh over {n} devices")
    return n_data, n_elem


def _row_of(b: int, count: int, mesh: Mesh) -> int:
    """The mesh row of blob b of `count`: the blobs split into n_data
    contiguous runs, as the JAX package's P("data") sharding splits them."""
    return b * mesh.n_data // count


def sharded_commit_root(coeffs: torch.Tensor, log_domain: int, mesh: Mesh, row: int | None = None) -> torch.Tensor:
    """(8,) int32 root words of the commitment to (4, 2^L) int32 bit-reversed
    coefficients over a 2^log_domain domain, element-sharded over mesh row
    `row` (this process's first by default); equal to the single-device
    root, and the same in every process of a process-group mesh. A domain of
    fewer than S evaluations runs unsharded on the row's home device."""
    row = mesh.rows()[0] if row is None else row
    if 1 << log_domain < mesh.n_elem:
        home = mesh.home(row)
        evals = fft.evaluate_auto(coeffs.to(home), fft.stage_twiddles(log_domain, home))
        return merkle.root_level(evals).reshape(8)
    return merkle.sharded_root_level(sharded_evaluate(coeffs, log_domain, mesh, row)).reshape(8)


def _blob_root(data: bytes, log_blowup_factor: int, mesh: Mesh, row: int) -> torch.Tensor:
    """(8,) root words of one blob on mesh row `row`: upload, `ingest`, the
    sharded commit."""
    log_total = log_total_for(len(data))
    words = upload_words([data], log_total, mesh.home(row))[1][0]
    coeffs = ingest_ops.ingest(words, log_total - 2)
    return sharded_commit_root(coeffs, log_total - 2 + log_blowup_factor, mesh, row)


def commit_roots_batch(datas, log_blowup_factor: int, mesh: Mesh) -> list:
    """The 32-byte root of each blob (equal padded sizes, else
    AssertionError as in the JAX package), equal to `api.commit` per blob:
    the blobs split over the mesh rows, each blob's commit element-sharded
    over its row; one fetch at the end. A process-group mesh gives None for
    the blobs of rows this process holds no shard of."""
    datas = list(datas)
    if len({log_total_for(len(d)) for d in datas}) != 1:
        raise AssertionError("batch must share a padded size")
    local = set(mesh.rows())
    mine = [b for b in range(len(datas)) if _row_of(b, len(datas), mesh) in local]
    if not mine:
        return [None] * len(datas)
    home = mesh.home(_row_of(mine[0], len(datas), mesh))
    roots = torch.stack([_blob_root(datas[b], log_blowup_factor, mesh, _row_of(b, len(datas), mesh)).to(home)
                         for b in mine])
    got = dict(zip(mine, merkle.root_bytes_many(roots.view(-1, 8, 1))))
    return [got.get(b) for b in range(len(datas))]


def sharded_commit_and_prove(data: bytes, seed, pcs_config: PcsConfig, mesh: Mesh):
    """(commitment, Proof) of a blob, its commit phase element-sharded over
    this process's first mesh row (`core/fri.commit_phase_sharded`);
    bit-identical to the single-device `commit_and_prove`. When the row's
    shards all lie on one CUDA device and the carrier is in-process, the
    commit phase is one replay of its captured CUDA graph
    (`core/fri.dispatch_blobs`), the decommitment's gathers inside it, and
    `finish_proof` fetches once and launches nothing; a process-group mesh
    runs it eagerly, and a row over several devices or processes decommits
    after the fetch (one `merkle_open` launch a device)."""
    row = mesh.rows()[0]
    log_total = log_total_for(len(data))
    committed = fri.dispatch_blobs([data], log_total, [seed], pcs_config, mesh.home(row), mesh, row)[0]
    return fri.finish_proof(committed, log_total, pcs_config)


def _one_device(mesh: Mesh):
    """The device that holds every shard of an in-process mesh, or None
    (several devices, or a process group)."""
    if mesh.group is not None:
        return None
    devices = {mesh.device(d, e) for d in range(mesh.n_data) for e in range(mesh.n_elem)}
    return devices.pop() if len(devices) == 1 else None


def prove_many_sharded(datas, seeds, pcs_config: PcsConfig, mesh: Mesh):
    """[(commitment, Proof)] of each blob under its seed, in input order,
    bit-identical to the single-device proofs; each blob keeps its own
    transcript. Blobs must share a padded size, and seeds be all None or
    all set (ValueError, as in the JAX package). Counterpart of the JAX
    package's, which proves the whole batch as ONE dispatch of its commit
    phase vmapped over the blobs (`_fri_commit_fn(..., batched=True)`).

    Where every shard of the mesh lies on one device and the carrier is
    in-process (a mesh of one card's virtual shards, or of the CPU), the
    batch runs as batched dispatches here too: `core/fri.prove_block`, the
    one-card block pipeline (two dispatches, the second enqueued before the
    first one's finishes; on the card each one graph replay). Each blob's
    layers are whole, as the JAX batched program keeps its
    auto-sharded XLA stage loop rather than the shard_map path
    (`frieda_tpu/core/fri.py:199-205`): a row's shards are one buffer on
    one device, and the packed outputs equal one device's.

    Otherwise (shards on several devices, or a process-group mesh) the
    batch takes the per-blob route, `prove_many_per_blob`."""
    datas, seeds = list(datas), list(seeds)
    fri.batch_has_seed(seeds, len(datas))  # the JAX package's checks and messages, in its order
    log_totals = {log_total_for(len(d)) for d in datas}
    if len(log_totals) != 1:
        raise ValueError("batch must share a padded size")
    log_total = log_totals.pop()
    fri._layer_sizes(log_total, pcs_config)  # ValueError for a config this blob size cannot satisfy
    device = _one_device(mesh)
    if device is not None:
        return fri.prove_block(datas, log_total, seeds, pcs_config, device)
    return prove_many_per_blob(datas, seeds, log_total, pcs_config, mesh)


def prove_many_per_blob(datas, seeds, log_total: int, pcs_config: PcsConfig, mesh: Mesh):
    """`prove_many_sharded`'s route for a mesh over several devices or a
    process group, which takes any mesh: the blobs (2^log_total felts each,
    checked by the caller) split over the mesh rows, each blob's commit phase
    element-sharded over its row with its own transcript (`fri.dispatch_blobs`:
    a graph replay each where `sharded_commit_and_prove`'s is one, so a
    row's key holds as many captured instances as the row has blobs), every
    commit phase enqueued before the first decommitment. A process-group
    mesh gives None for the blobs of rows this process holds no shard of."""
    local = set(mesh.rows())
    pending = {}
    for b, (data, seed) in enumerate(zip(datas, seeds)):
        row = _row_of(b, len(datas), mesh)
        if row in local:
            pending[b] = fri.dispatch_blobs([data], log_total, [seed], pcs_config, mesh.home(row), mesh, row)[0]
    return [fri.finish_proof(pending[b], log_total, pcs_config) if b in pending else None
            for b in range(len(datas))]
