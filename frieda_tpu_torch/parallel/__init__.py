"""Multi-device forms of the commit and the prover over a (data, elem) mesh:
the counterpart of `frieda_tpu/parallel/` (`mesh.py`, `fft_sharded.py`,
`sharding.py`, `multihost.py`)."""
