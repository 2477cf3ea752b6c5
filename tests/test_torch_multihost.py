"""The port's multi-process runtime (`frieda_tpu_torch.parallel.multihost`):
two processes on the CPU, joined by `torch.distributed` with the gloo
backend over a localhost address, run this file's worker (below, under
`__main__`): `initialize`, both branches of `broadcast_from_host0`,
`assert_same_across_hosts` (agreeing and diverging bytes), a
`sharded_commit_root` over the (1, 2) `global_mesh` (each process holds one
shard; the subtree roots and the decommitment's reads cross the process
boundary, and at blowup 0 the exchange stage too) equal to
`frieda_tpu.spec.commit`, `commit_roots_batch` over a (2, 1) mesh (a row a
process: each commits its own row's blob), and the sharded
proof of a frozen case equal to the JAX package's wire bytes in both
processes. Tests/test_multihost.py's list, on the port. Plus the
single-process helpers."""

import os
import pathlib
import socket
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = bytes((7 * i + 1) % 256 for i in range(2048))
LOG_BLOWUP = 2
FROZEN_CASE = "dryrun_960B"  # log_blowup 2, 8 queries: eight layers, four of them sharded


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_runtime():
    from frieda_tpu.spec import commit as sc

    address = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    want = [sc.commit(DATA, LOG_BLOWUP).hex(), sc.commit(DATA, 0).hex(),
            sc.commit(bytes(reversed(DATA)), LOG_BLOWUP).hex()]
    procs = [subprocess.Popen([sys.executable, __file__, address, str(pid), *want], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n---\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER_{pid}_OK" in out, f"worker {pid} incomplete:\n{out}"


def test_multihost_helpers_single_process():
    """One process: the helpers are identities, and the global mesh is the
    in-process mesh over the devices given."""
    from frieda_tpu_torch.parallel import multihost

    assert multihost.initialize() is False  # no coordinator: a no-op
    assert multihost.broadcast_from_host0(b"abc") == b"abc"
    arr = np.arange(5)
    assert (multihost.broadcast_from_host0(arr) == arr).all()
    multihost.assert_same_across_hosts(b"xyz")  # must not raise
    mesh = multihost.global_mesh(n_data=2, n_elem=4, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "elem": 4} and mesh.group is None


def _worker(address: str, pid: int, want_root: str, want_root_blowup0: str, want_other: str) -> None:
    import json

    import torch
    import torch.distributed as dist

    from chip_smoke import synthetic_data
    from frieda_tpu_torch.config import PcsConfig
    from frieda_tpu_torch.parallel import multihost, sharding
    from frieda_tpu_torch.utils.convert import to_numpy_u32
    from frieda_tpu_torch.utils.packing import log_total_for, upload_words

    assert multihost.initialize(address, 2, pid, backend="gloo") is True
    assert multihost.initialize() is True  # already live
    assert dist.get_world_size() == 2 and dist.get_rank() == pid

    got = multihost.broadcast_from_host0(b"seed-0042-from-host0" if pid == 0 else b"")
    assert got == b"seed-0042-from-host0", got
    arr = np.arange(7, dtype=np.int64) * (1 if pid == 0 else -1)
    assert (multihost.broadcast_from_host0(arr) == np.arange(7, dtype=np.int64)).all()
    multihost.assert_same_across_hosts(b"same-on-both", "probe")
    try:
        multihost.assert_same_across_hosts(b"host0-version" if pid == 0 else b"host1-version", "probe")
        diverged = False
    except AssertionError:
        diverged = True
    assert diverged == (pid != 0), diverged

    mesh = multihost.global_mesh(n_data=1, n_elem=2, devices=["cpu"])
    assert mesh.local_elems(0) == [pid] and mesh.group is not None
    log_total = log_total_for(len(DATA))
    words = upload_words([DATA], log_total, "cpu")[1][0]
    from frieda_tpu_torch.ops import ingest

    coeffs = ingest.ingest(words, log_total - 2)
    words = sharding.sharded_commit_root(coeffs, log_total - 2 + LOG_BLOWUP, mesh)
    root = to_numpy_u32(words).astype("<u4").tobytes()
    assert root.hex() == want_root, root.hex()
    multihost.assert_same_across_hosts(root, "sharded root")
    assert sharding.commit_roots_batch([DATA, DATA], LOG_BLOWUP, mesh) == [root, root]
    # blowup 0: the stage at bit 0 pairs the two processes' shards (a swap)
    root0 = to_numpy_u32(sharding.sharded_commit_root(coeffs, log_total - 2, mesh)).astype("<u4").tobytes()
    assert root0.hex() == want_root_blowup0, root0.hex()

    # a (2, 1) mesh: one row a process; each proves and commits its own row's blobs
    rows = multihost.global_mesh(n_data=2, n_elem=1, devices=["cpu"])
    other = bytes(reversed(DATA))
    got = sharding.commit_roots_batch([DATA, other], LOG_BLOWUP, rows)
    assert got[1 - pid] is None and got[pid].hex() == (want_root, want_other)[pid], got

    case = {c["name"]: c for c in json.loads((ROOT / "tests" / "data" / "frozen_proofs.json").read_text())}[
        FROZEN_CASE]
    data = synthetic_data(case["data_len"], case["data_seed_offset"])
    com, proof = sharding.sharded_commit_and_prove(data, case["seed"], PcsConfig.from_dict(case["config"]), mesh)
    assert com.hex() == case["commitment"]
    assert proof.to_bytes().hex() == case["wire_hex"]
    multihost.assert_same_across_hosts(proof.to_bytes(), "sharded proof")
    dist.barrier()
    dist.destroy_process_group()
    assert torch.distributed.is_initialized() is False
    print(f"WORKER_{pid}_OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], int(sys.argv[2]), *sys.argv[3:6])
