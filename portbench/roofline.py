"""The yardstick of the benchmark's roofline shares: a card's data-sheet
peaks and the least time a function's work takes on it.

A frozen copy of the arithmetic of the port's `utils/profiling.py`: the
work is the function's, whatever kernel does it. Each input is read once
and each kept output written once; the instructions are units of work
(BLAKE2s compressions, M31 butterflies, QM31 fold elements) times a fixed
per-unit floor of sm_90 integer instructions. The least time is the larger
of bytes over the memory rate and instructions over the instruction rate.
Nothing here reads the program's launch plan.
"""

from __future__ import annotations

from typing import NamedTuple


class Card(NamedTuple):
    hbm_bytes_s: float
    sms: int
    max_sm_clock_hz: float

    @property
    def int_instr_s(self) -> float:
        """Every SM's 4 schedulers issue one 32-lane instruction a cycle."""
        return self.sms * 4 * 32 * self.max_sm_clock_hz


# By `torch.cuda.get_device_name()`. NVIDIA H100 SXM5 80GB data sheet: 3.35
# TB/s of HBM3, 132 SMs at 1,980 MHz at most, so 33.45e12 integer
# instructions a second; peaks at the 700 W power limit.
CARDS = {
    "NVIDIA H100 80GB HBM3": Card(hbm_bytes_s=3.35e12, sms=132, max_sm_clock_hz=1.98e9),
}

# Instructions a unit (see the port's utils/profiling.py for their count):
BLAKE2S_COMPRESS_INSTR = 960  # one compression: 80 G of 12, the feed-forward, less a zero state's
M31_BUTTERFLY_INSTR = 7  # a' = a + t b, b' = a - t b
QM31_FOLD_INSTR = 117  # g = (lo + hi) + alpha (lo - hi) inv


def least_ms(n_bytes: float, n_instr: float, card: Card) -> float:
    """The least ms of the work on `card`: bytes or instructions, the
    longer."""
    return max(n_bytes / card.hbm_bytes_s, n_instr / card.int_instr_s) * 1e3


def lde_work(columns: int, log_l: int, n: int) -> tuple:
    """(bytes, butterflies) of extending columns x 2^log_l coefficients to
    2^n evaluations: log_l stages of 2^(n - 1) butterflies a column (the
    stages below them act on a dilated input and are copies)."""
    return 4 * columns * ((1 << log_l) + (1 << n)), columns * log_l << (n - 1)


def tree_work(log_leaves: int, top_log: int = 0) -> tuple:
    """(bytes, compressions) of a Merkle tree over 2^log_leaves 4-word
    leaves down to width 2^top_log: the leaves read, the top level written,
    2N - 2^top_log compressions."""
    n, top = 1 << log_leaves, 1 << top_log
    return 16 * n + 32 * top, 2 * n - top


def lde_ms(log_size: int, n: int, card: Card) -> float:
    """Least ms of one blob's extension: 4 columns of 2^log_size to 2^n."""
    n_bytes, butterflies = lde_work(4, log_size, n)
    return least_ms(n_bytes, butterflies * M31_BUTTERFLY_INSTR, card)


def trees_ms(log_leaves, card: Card) -> float:
    """Least ms of one blob's trees, one over 2^k leaves for each k in
    `log_leaves`, each to its root."""
    total = 0.0
    for k in log_leaves:
        n_bytes, compressions = tree_work(k)
        total += least_ms(n_bytes, compressions * BLAKE2S_COMPRESS_INSTR, card)
    return total
