"""api.commit_and_prove: one blob a request under its seed; the next request
when the blob's commitment and Proof are back."""

from portbench import harness

PROVES = True


def make(cell, device):
    from frieda_tpu_torch import api

    if cell.blobs != 1:
        raise ValueError(f"commit_and_prove takes one blob a request, not {cell.blobs}")
    cfg = harness.pcs_config(cell)

    def call(blobs, seeds):
        return [api.commit_and_prove(blobs[0], seeds[0], cfg, device=device)]

    return call


def release():
    from frieda_tpu_torch.core import fri

    fri.clear_commit_graphs()
