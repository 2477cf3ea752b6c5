"""Fiat-Shamir Blake2sChannel (host, strictly sequential).

Jax-free copy of `frieda_tpu/core/channel.py`, the verifier's source of
truth: the verifier replays every proof's transcript on it. The prover runs
the same transcript in device memory (`core/device_channel.py`, the
`transcript` and `grind` kernels of `ops/channel.py`), so that its commit
phase never waits for the host; the tests hold the two bit-equal.

Conventions:
  * digest: 32 bytes, zero-initialized; every mix replaces it with
    blake2s-256(digest || payload) and resets the sent-counter.
  * mix_u64: payload = 8-byte little-endian value.
  * mix_digest (Merkle roots): payload = the 32-byte root.
  * mix_felts: payload = each QM31 as 4 u32 words little-endian.
  * draw_random_bytes: blake2s-256(digest || n_sent as 8-byte LE), counter++.
  * draw_felt: 8 u32 from one draw; retry while any >= 2P; reduce mod P;
    first 4 felts form the QM31.
  * trailing_zeros: of the u128 little-endian first 16 digest bytes.
"""

from __future__ import annotations

import hashlib

P = (1 << 31) - 1


def _blake2s(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


class Blake2sChannel:
    __slots__ = ("digest", "n_sent")

    def __init__(self):
        self.digest = bytes(32)
        self.n_sent = 0

    # -- mixing ------------------------------------------------------------

    def _update(self, new_digest: bytes):
        self.digest = new_digest
        self.n_sent = 0

    def mix_u64(self, value: int):
        self._update(_blake2s(self.digest + (value & ((1 << 64) - 1)).to_bytes(8, "little")))

    def mix_digest(self, root: bytes):
        assert len(root) == 32
        self._update(_blake2s(self.digest + root))

    def mix_felts(self, felts):
        """felts: iterable of QM31 4-tuples of ints."""
        payload = b"".join(
            int(c).to_bytes(4, "little") for f in felts for c in f
        )
        self._update(_blake2s(self.digest + payload))

    # -- drawing -----------------------------------------------------------

    def draw_random_bytes(self) -> bytes:
        out = _blake2s(self.digest + self.n_sent.to_bytes(8, "little"))
        self.n_sent += 1
        return out

    def draw_base_felts(self):
        """8 uniform M31 felts (rejection-sample the whole 8-lane draw)."""
        while True:
            raw = self.draw_random_bytes()
            words = [int.from_bytes(raw[4 * i : 4 * i + 4], "little") for i in range(8)]
            if all(w < 2 * P for w in words):
                return [w % P for w in words]

    def draw_felt(self):
        f = self.draw_base_felts()
        return (f[0], f[1], f[2], f[3])

    def trailing_zeros(self) -> int:
        v = int.from_bytes(self.digest[:16], "little")
        if v == 0:
            return 128
        return (v & -v).bit_length() - 1

    # -- misc --------------------------------------------------------------

    def clone(self) -> "Blake2sChannel":
        c = Blake2sChannel()
        c.digest = self.digest
        c.n_sent = self.n_sent
        return c


def sample_query_positions(channel: Blake2sChannel, log_domain_size: int, n_queries: int):
    """Draw n_queries positions in [0, 2^log_domain_size), then sort+dedup
    (SURVEY.md B.2; reference use-site src/proof.rs:60-62,96-97)."""
    mask = (1 << log_domain_size) - 1
    positions = []
    while len(positions) < n_queries:
        raw = channel.draw_random_bytes()
        for i in range(8):
            positions.append(int.from_bytes(raw[4 * i : 4 * i + 4], "little") & mask)
            if len(positions) == n_queries:
                break
    return sorted(set(positions))
