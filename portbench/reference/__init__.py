"""The benchmark's plain reference of FRIDA (PyTorch and the host's
hashlib): packing, circle extension, BLAKE2s trees, FRI folds, the channel,
the grind and the openings, with the proof's wire encoding. It imports
nothing of the port and nothing of the JAX package."""
