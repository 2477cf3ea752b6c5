"""Protocol configuration (value-passed, no globals).

Jax-free copy of `frieda_tpu/config.py`: stwo's FriConfig/PcsConfig as the
reference FRIDA library consumes them (reference `src/lib.rs`, `src/proof.rs`).
Heuristic soundness ~= n_queries * log_blowup_factor + pow_bits.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FriConfig:
    log_blowup_factor: int = 4
    log_last_layer_degree_bound: int = 0
    n_queries: int = 20

    def __post_init__(self):
        assert 1 <= self.log_blowup_factor <= 16
        assert 0 <= self.log_last_layer_degree_bound <= 10
        assert self.n_queries >= 1

    def to_dict(self):
        return {
            "log_blowup_factor": self.log_blowup_factor,
            "log_last_layer_degree_bound": self.log_last_layer_degree_bound,
            "n_queries": self.n_queries,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


@dataclass(frozen=True)
class PcsConfig:
    pow_bits: int = 20
    fri_config: FriConfig = FriConfig()

    def __post_init__(self):
        assert 0 <= self.pow_bits <= 60

    @property
    def security_bits(self) -> int:
        return (
            self.pow_bits
            + self.fri_config.log_blowup_factor * self.fri_config.n_queries
        )

    def to_dict(self):
        return {"pow_bits": self.pow_bits, "fri_config": self.fri_config.to_dict()}

    @classmethod
    def from_dict(cls, d):
        return cls(pow_bits=d["pow_bits"], fri_config=FriConfig.from_dict(d["fri_config"]))


# The reference's default configuration (src/lib.rs, benches/proof.rs).
DEFAULT_CONFIG = PcsConfig(pow_bits=20, fri_config=FriConfig(4, 0, 20))
