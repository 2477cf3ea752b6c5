"""The Fiat-Shamir channel of a FRIDA proof, on the host.

digest: 32 bytes, zero at the start; a mix replaces it with
BLAKE2s-256(digest || payload) and resets the draw counter. mix_u64 hashes
the value's 8 little-endian bytes, mix_digest a 32-byte root, mix_felts each
QM31's 4 words little-endian. A draw is BLAKE2s-256(digest || counter as 8
little-endian bytes), counter + 1. A felt draw takes 8 words from one draw,
again while any is >= 2P, reduced mod P, and keeps the first 4 as a QM31.
"""

from __future__ import annotations

import hashlib

P = (1 << 31) - 1


def _h(data: bytes) -> bytes:
    return hashlib.blake2s(data, digest_size=32).digest()


class Channel:
    def __init__(self):
        self.digest = bytes(32)
        self.n_sent = 0

    def _mix(self, payload: bytes) -> None:
        self.digest = _h(self.digest + payload)
        self.n_sent = 0

    def mix_u64(self, value: int) -> None:
        self._mix((value & ((1 << 64) - 1)).to_bytes(8, "little"))

    def mix_digest(self, root: bytes) -> None:
        self._mix(root)

    def mix_felts(self, felts) -> None:
        self._mix(b"".join(int(c).to_bytes(4, "little") for f in felts for c in f))

    def draw(self) -> bytes:
        out = _h(self.digest + self.n_sent.to_bytes(8, "little"))
        self.n_sent += 1
        return out

    def draw_felt(self) -> tuple:
        while True:
            raw = self.draw()
            words = [int.from_bytes(raw[4 * i : 4 * i + 4], "little") for i in range(8)]
            if all(w < 2 * P for w in words):
                return tuple(w % P for w in words[:4])

    def trailing_zeros(self) -> int:
        v = int.from_bytes(self.digest[:16], "little")
        return 128 if v == 0 else (v & -v).bit_length() - 1

    def queries(self, log_domain: int, n_queries: int) -> list:
        """n_queries positions in [0, 2^log_domain), 8 a draw, sorted and
        deduplicated."""
        mask = (1 << log_domain) - 1
        out = []
        while len(out) < n_queries:
            raw = self.draw()
            out += [int.from_bytes(raw[4 * i : 4 * i + 4], "little") & mask for i in range(8)]
        return sorted(set(out[:n_queries]))
