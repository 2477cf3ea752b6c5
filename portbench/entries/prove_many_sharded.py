"""parallel.sharding.prove_many_sharded on a one-card mesh: a request's
blobs (a block) in one call, each under its own seed; the next request
when every blob's commitment and Proof are back."""

from portbench import harness

PROVES = True


def make(cell, device):
    from frieda_tpu_torch.parallel import mesh, sharding

    cfg = harness.pcs_config(cell)
    one_card = mesh.Mesh(1, 1, [device])

    def call(blobs, seeds):
        return sharding.prove_many_sharded(blobs, seeds, cfg, one_card)

    return call


def release():
    from frieda_tpu_torch.core import fri

    fri.clear_commit_graphs()
