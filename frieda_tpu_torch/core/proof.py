"""Proof containers and stable (de)serialization.

Jax-free copy of `frieda_tpu/core/proof.py`; the wire format is the
interchange with the JAX package (a proof made here reads there and back,
byte for byte). Mirrors the reference's serde-serializable proof object
field-for-field:

  Proof { proof: FriProof, proof_of_work: u64, pcs_config: PcsConfig,
          log_size_bound: u32, evaluations: Vec<QM31> }
  FriProof { first_layer, inner_layers, last_layer_poly }
  FriLayerProof { fri_witness, decommitment, commitment }

QM31 values are 4-tuples of ints (a, b, c, d). Two wire formats:
  * to_dict/from_dict — JSON-able dict
  * to_bytes/from_bytes — compact little-endian binary layout
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..config import PcsConfig
from .merkle import MerkleDecommitment

QM31 = tuple  # (a, b, c, d) ints < P

P = (1 << 31) - 1


def _qm31_checked(f) -> tuple:
    """Validated QM31 from an untrusted 4-sequence. Raises ValueError, so
    deserialization of a malformed proof fails loudly at the boundary and
    `verify` never sees out-of-field values (reference: serde rejects
    malformed input before FriVerifier::commit, src/proof.rs:84-91)."""
    t = tuple(int(c) for c in f)
    if len(t) != 4 or any(not (0 <= c < P) for c in t):
        raise ValueError(f"invalid QM31 {f!r}")
    return t


def _commitment_checked(c: bytes) -> bytes:
    if not isinstance(c, bytes) or len(c) != 32:
        raise ValueError("commitment must be 32 bytes")
    return c


@dataclass
class FriLayerProof:
    fri_witness: list = field(default_factory=list)  # list[QM31]
    decommitment: MerkleDecommitment = field(default_factory=MerkleDecommitment)
    commitment: bytes = b"\x00" * 32

    def to_dict(self):
        return {
            "fri_witness": [list(map(int, f)) for f in self.fri_witness],
            "decommitment": self.decommitment.to_dict(),
            "commitment": self.commitment.hex(),
        }

    @classmethod
    def from_dict(cls, d):
        dec = MerkleDecommitment.from_dict(d["decommitment"])
        for h in dec.hash_witness:
            _commitment_checked(h)
        return cls(
            fri_witness=[_qm31_checked(f) for f in d["fri_witness"]],
            decommitment=dec,
            commitment=_commitment_checked(bytes.fromhex(d["commitment"])),
        )


@dataclass
class FriProof:
    first_layer: FriLayerProof
    inner_layers: list  # list[FriLayerProof]
    last_layer_poly: list  # list[QM31] coefficients

    def to_dict(self):
        return {
            "first_layer": self.first_layer.to_dict(),
            "inner_layers": [l.to_dict() for l in self.inner_layers],
            "last_layer_poly": [list(map(int, f)) for f in self.last_layer_poly],
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            first_layer=FriLayerProof.from_dict(d["first_layer"]),
            inner_layers=[FriLayerProof.from_dict(x) for x in d["inner_layers"]],
            last_layer_poly=[_qm31_checked(f) for f in d["last_layer_poly"]],
        )


@dataclass
class Proof:
    proof: FriProof
    proof_of_work: int
    pcs_config: PcsConfig
    log_size_bound: int
    evaluations: list  # list[QM31] at the sampled query positions (sorted order)

    @property
    def first_layer_commitment(self) -> bytes:
        """The data commitment: the FRI first layer root (src/proof.rs:68;
        equality with api::commit asserted by the reference's tests)."""
        return self.proof.first_layer.commitment

    def to_dict(self):
        return {
            "proof": self.proof.to_dict(),
            "proof_of_work": int(self.proof_of_work),
            "pcs_config": self.pcs_config.to_dict(),
            "log_size_bound": int(self.log_size_bound),
            "evaluations": [list(map(int, f)) for f in self.evaluations],
        }

    @classmethod
    def from_dict(cls, d):
        try:
            cfg = PcsConfig.from_dict(d["pcs_config"])
        except AssertionError as e:  # config range asserts -> parse error
            raise ValueError(f"invalid pcs_config: {e}") from e
        pow_nonce = int(d["proof_of_work"])
        log_size_bound = int(d["log_size_bound"])
        if not (0 <= pow_nonce < (1 << 64)):
            raise ValueError("proof_of_work out of u64 range")
        if not (0 <= log_size_bound <= 48):
            raise ValueError("log_size_bound out of range")
        return cls(
            proof=FriProof.from_dict(d["proof"]),
            proof_of_work=pow_nonce,
            pcs_config=cfg,
            log_size_bound=log_size_bound,
            evaluations=[_qm31_checked(f) for f in d["evaluations"]],
        )

    # -- compact binary wire format ----------------------------------------

    def to_bytes(self) -> bytes:
        out = bytearray()

        def w_u32(v):
            out.extend(struct.pack("<I", v))

        def w_qm31s(fs):
            w_u32(len(fs))
            for f in fs:
                out.extend(struct.pack("<4I", *[int(c) for c in f]))

        def w_layer(l: FriLayerProof):
            out.extend(l.commitment)
            w_qm31s(l.fri_witness)
            w_u32(len(l.decommitment.hash_witness))
            for h in l.decommitment.hash_witness:
                out.extend(h)

        out.extend(b"FRTP\x01")  # magic + version
        out.extend(struct.pack("<Q", self.proof_of_work))
        w_u32(self.log_size_bound)
        w_u32(self.pcs_config.pow_bits)
        w_u32(self.pcs_config.fri_config.log_blowup_factor)
        w_u32(self.pcs_config.fri_config.log_last_layer_degree_bound)
        w_u32(self.pcs_config.fri_config.n_queries)
        w_layer(self.proof.first_layer)
        w_u32(len(self.proof.inner_layers))
        for l in self.proof.inner_layers:
            w_layer(l)
        w_qm31s(self.proof.last_layer_poly)
        w_qm31s(self.evaluations)
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "Proof":
        from ..config import FriConfig

        off = 0

        def r(n):
            nonlocal off
            chunk = data[off : off + n]
            if len(chunk) != n:
                raise ValueError("truncated proof")
            off += n
            return chunk

        def r_u32():
            return struct.unpack("<I", r(4))[0]

        def r_qm31s():
            n = r_u32()
            return [_qm31_checked(struct.unpack("<4I", r(16))) for _ in range(n)]

        def r_layer():
            commitment = r(32)
            wit = r_qm31s()
            n_h = r_u32()
            dec = MerkleDecommitment([r(32) for _ in range(n_h)])
            return FriLayerProof(wit, dec, commitment)

        if r(5) != b"FRTP\x01":
            raise ValueError("bad proof magic/version")
        pow_nonce = struct.unpack("<Q", r(8))[0]
        log_size_bound = r_u32()
        if log_size_bound > 48:
            raise ValueError("log_size_bound out of range")
        pow_bits = r_u32()
        try:
            cfg = PcsConfig(
                pow_bits=pow_bits,
                fri_config=FriConfig(r_u32(), r_u32(), r_u32()),
            )
        except AssertionError as e:  # config range asserts -> parse error
            raise ValueError(f"invalid pcs_config: {e}") from e
        first = r_layer()
        inner = [r_layer() for _ in range(r_u32())]
        last = r_qm31s()
        evals = r_qm31s()
        if off != len(data):
            raise ValueError("trailing bytes in proof")
        return cls(FriProof(first, inner, last), pow_nonce, cfg, log_size_bound, evals)
