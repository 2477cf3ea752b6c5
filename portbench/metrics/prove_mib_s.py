"""prove_mib_s: MiB of blob bytes whose commitment and Proof came back from single proof calls, over the window's seconds (every request of the
window, the window closing when the first request ends past --seconds)."""


def read(run):
    return run.mib_per_s()
