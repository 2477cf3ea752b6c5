"""The frozen roofline arithmetic at the cells' shapes, held to counts
worked by hand."""

from portbench import roofline as rl

H100 = rl.CARDS["NVIDIA H100 80GB HBM3"]


def test_peaks():
    assert H100.int_instr_s == 132 * 4 * 32 * 1.98e9
    assert (rl.BLAKE2S_COMPRESS_INSTR, rl.M31_BUTTERFLY_INSTR, rl.QM31_FOLD_INSTR) == (960, 7, 117)


def test_tree_work():
    # a 2^26-leaf tree to its root: 2^27 - 1 compressions; 16 bytes a leaf read, the root written
    assert rl.tree_work(26) == (16 * 2**26 + 32, 2**27 - 1)
    assert rl.tree_work(19) == (16 * 2**19 + 32, 2**20 - 1)


def test_lde_work():
    # 4 columns x 2^22 coefficients extended to 2^26: 4 * 22 * 2^25 butterflies
    assert rl.lde_work(4, 22, 26) == (16 * (2**22 + 2**26), 4 * 22 * 2**25)
    assert rl.lde_work(4, 15, 19) == (16 * (2**15 + 2**19), 4 * 15 * 2**18)


def test_least_ms_takes_the_longer_side():
    instr = (2**27 - 1) * 960
    assert rl.least_ms(16 * 2**26 + 32, instr, H100) == instr / H100.int_instr_s * 1e3
    assert rl.least_ms(1e12, 0, H100) == 1e12 / 3.35e12 * 1e3


def test_the_proof_cells_trees():
    # frida-2p24: layers of 2^26 ... 2^5 leaves (n = 26, n_inner = 21)
    want = sum(2 * 2**k - 1 for k in range(5, 27)) * 960 / H100.int_instr_s * 1e3
    assert abs(rl.trees_ms(range(5, 27), H100) - want) < 1e-12
    assert abs(rl.lde_ms(22, 26, H100) - 4 * 22 * 2**25 * 7 / H100.int_instr_s * 1e3) < 1e-12
