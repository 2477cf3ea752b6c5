"""Port's sharded commit and prover (`frieda_tpu_torch.parallel`) on meshes of
CPU devices (`devices=["cpu"] * S`: every kernel's plain version) vs the JAX
package: `frieda_tpu.parallel.sharding` on its virtual 8-device CPU mesh, the
single-device `frieda_tpu.api.commit`, the frozen proofs' wire bytes (the
JAX package's), and the JAX verifier. The JAX sharded prover and sharded FFT
take minutes to trace on the CPU, so the proofs are held against the frozen
JAX bytes and the FFT's shards against the JAX stage loop
(`frieda_tpu.core.fft.evaluate`), which tests/test_sharding.py holds equal to
both. Tolerance: exact equality of every word, root and wire byte."""

import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import pathlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import synthetic_data  # noqa: E402
from frieda_tpu import api as japi  # noqa: E402
from frieda_tpu.config import FriConfig as JFriConfig  # noqa: E402
from frieda_tpu.config import PcsConfig as JPcsConfig  # noqa: E402
from frieda_tpu.core import fft as jfft  # noqa: E402
from frieda_tpu.core.proof import Proof as JProof  # noqa: E402
from frieda_tpu.parallel import sharding as jsharding  # noqa: E402
from frieda_tpu.spec import commit as sc  # noqa: E402
from frieda_tpu.utils.packing import ceil_log2, polynomial_from_bytes  # noqa: E402
from frieda_tpu_torch import api  # noqa: E402
from frieda_tpu_torch.config import FriConfig, PcsConfig  # noqa: E402
from frieda_tpu_torch.core import fft, fri, merkle  # noqa: E402
from frieda_tpu_torch.ops import fft as fft_ops  # noqa: E402
from frieda_tpu_torch.parallel import fft_sharded, sharding  # noqa: E402
from frieda_tpu_torch.parallel.mesh import Mesh, Sharded  # noqa: E402
from frieda_tpu_torch.utils.convert import from_numpy_u32, narrow, to_numpy_u32, widen  # noqa: E402
from frieda_tpu_torch.utils.packing import log_total_for, upload_words  # noqa: E402

torch.set_num_threads(1)

P = (1 << 31) - 1
DATA = bytes((7 * i + 1) % 256 for i in range(2048))  # tests/test_sharding.py's
LOG_BLOWUP = 2
PROVE_CFG = PcsConfig(pow_bits=5, fri_config=FriConfig(2, 0, 8))
CASES = {c["name"]: c for c in json.loads(
    (pathlib.Path(__file__).parent / "data" / "frozen_proofs.json").read_text())}


def _mesh(n_data, n_elem):
    return sharding.make_mesh(n_data, n_elem, devices=["cpu"] * (n_data * n_elem))


def _coeffs_rev(data: bytes):
    """(numpy bit-reversed coefficients, n) of a blob at LOG_BLOWUP, as
    tests/test_sharding.py makes them."""
    coeffs = polynomial_from_bytes(data)
    return jfft.bitrev_coeffs(coeffs), ceil_log2(coeffs.shape[1]) + LOG_BLOWUP


def _root_bytes(words) -> bytes:
    return np.asarray(words, np.uint32).astype("<u4").tobytes()


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_commit_root_matches_jax(mesh_shape):
    cr, n = _coeffs_rev(DATA)
    words = sharding.sharded_commit_root(from_numpy_u32(cr, "cpu"), n, _mesh(*mesh_shape))
    jwords = jsharding.sharded_commit_root(jnp.asarray(cr), n, jsharding.make_mesh(*mesh_shape))
    root = _root_bytes(to_numpy_u32(words))
    assert root == _root_bytes(jwords) == sc.commit(DATA, LOG_BLOWUP) == japi.commit(DATA, LOG_BLOWUP)


@pytest.mark.parametrize("n_elem", [2, 8])
def test_sharded_commit_root_large_domain(n_elem):
    """A 2^14 domain (log_l 10): every shard's tree is a fused leaf level and
    a collapse, as at the card's sizes; equal to the single-device root."""
    rng = np.random.default_rng(5)
    coeffs = from_numpy_u32(rng.integers(0, P, (4, 1 << 10), dtype=np.uint32), "cpu")
    words = sharding.sharded_commit_root(coeffs, 14, _mesh(1, n_elem))
    want = merkle.root_level(fft.evaluate_auto(coeffs, fft.stage_twiddles(14, "cpu")))
    assert torch.equal(words, want.reshape(8))


def test_commit_roots_batch_matches_jax():
    datas = [bytes((i * 31 + s) % 256 for i in range(1024)) for s in range(4)]
    roots = sharding.commit_roots_batch(datas, LOG_BLOWUP, _mesh(2, 4))
    assert roots == jsharding.commit_roots_batch(datas, LOG_BLOWUP, jsharding.make_mesh(2, 4))
    assert roots == [japi.commit(d, LOG_BLOWUP) for d in datas]


def test_commit_roots_batch_unequal_sizes_raise_as_jax():
    datas = [bytes(100), bytes(4000)]
    with pytest.raises(AssertionError):
        jsharding.commit_roots_batch(datas, LOG_BLOWUP, jsharding.make_mesh(2, 4))
    with pytest.raises(AssertionError, match="padded size"):
        sharding.commit_roots_batch(datas, LOG_BLOWUP, _mesh(2, 4))


@pytest.mark.parametrize("n_elem", [1, 2, 4, 8])
@pytest.mark.parametrize("log_l,n", [(8, 12), (5, 9)])
def test_sharded_evaluate_shards_match_jax(n_elem, log_l, n):
    """Shard s holds the natural-order evaluations [:, s::S] of the JAX
    package's transform (test_shard_map_fft_bit_exact's shapes and seed)."""
    rng = np.random.default_rng(3)
    for shape in [(8, 12), (5, 9)]:  # the JAX test's draw order
        coeffs = rng.integers(0, P, (4, 1 << shape[0]), dtype=np.uint32)
        if shape == (log_l, n):
            break
    cr = jfft.bitrev_coeffs(coeffs)
    ref = np.asarray(jfft.evaluate(jnp.asarray(cr), jfft.stage_twiddles(n)))
    out = fft_sharded.sharded_evaluate(from_numpy_u32(cr, "cpu"), n, _mesh(1, n_elem))
    assert isinstance(out, Sharded) and out.width == 1 << n
    for s, part in out.parts.items():
        assert np.array_equal(to_numpy_u32(part), ref[:, s::n_elem]), s
    assert np.array_equal(to_numpy_u32(out.gather()), ref)


# (log_l, n, log2 S): exchange stages (p_min < log2 S: one, two, all three),
# none (p_min == log2 S), and the unsharded fallback (log_l < log2 S)
@pytest.mark.parametrize("log_l,n,log_s", [(6, 8, 3), (7, 8, 3), (8, 8, 3), (4, 6, 3), (10, 14, 4), (3, 6, 4)])
def test_sharded_evaluate_exchange_stages(log_l, n, log_s):
    rng = np.random.default_rng(log_l * 100 + n)
    coeffs = from_numpy_u32(rng.integers(0, P, (4, 1 << log_l), dtype=np.uint32), "cpu")
    want = narrow(fft.evaluate(widen(coeffs), fft.stage_twiddles(n, "cpu")))
    S = 1 << log_s
    before = fft_ops.fft_exchange.launches
    out = fft_sharded.sharded_evaluate(coeffs, n, _mesh(1, S))
    assert all(torch.equal(part, want[:, s::S]) for s, part in out.parts.items())
    assert fft_ops.fft_exchange.launches == before  # the CPU runs the plain version, no kernel


def test_sharded_evaluate_domain_smaller_than_the_mesh_raises():
    coeffs = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="fewer than one evaluation"):
        fft_sharded.sharded_evaluate(coeffs, 2, _mesh(1, 8))
    words = sharding.sharded_commit_root(coeffs, 2, _mesh(1, 8))  # runs unsharded instead
    assert torch.equal(words, merkle.root_level(fft.evaluate_auto(coeffs, fft.stage_twiddles(2, "cpu"))).reshape(8))


def test_sharded_evaluate_over_shards_of_a_process_group_layout():
    """The same transform when the row's shards lie on two devices of one
    process (the swap copies a partner): the per-shard exchange path."""
    rng = np.random.default_rng(7)
    coeffs = from_numpy_u32(rng.integers(0, P, (4, 1 << 6), dtype=np.uint32), "cpu")
    want = narrow(fft.evaluate(widen(coeffs), fft.stage_twiddles(8, "cpu")))
    mesh = Mesh(1, 8, ["cpu"] * 8)
    mesh._local = {g: torch.device("cpu", 0) if g % 2 else torch.device("cpu") for g in range(8)}
    out = fft_sharded.sharded_evaluate(coeffs, 8, mesh)
    assert len(out.blocks) == 8 and out.whole() is None
    assert all(torch.equal(part, want[:, s::8]) for s, part in out.parts.items())


@pytest.mark.parametrize("n, n_elem, blocks", [(10, 4, [(0, 4)]), (9, 8, [(0, 3), (3, 5)]), (6, 2, [(1, 1)])])
def test_shard_tables_are_slices_of_the_full_tables_kept_by_the_mesh(n, n_elem, blocks):
    """Each block's stage and fold tables == the JAX package's tables taken
    at s::S for every shard s of the block, and the mesh keeps them: a
    second call returns the same tensor, a new mesh builds its own."""
    from frieda_tpu.core import circle as jcircle

    mesh = sharding.make_mesh(1, n_elem, devices=["cpu"] * n_elem)
    log_s = n_elem.bit_length() - 1
    jstages = [np.asarray(t) for t in jfft.stage_twiddles(n)]  # depth d = bit n - 1 - d
    jtw = jcircle.get_twiddles(n)
    jfold = [t for t in [jtw.ys_inv] + jtw.xs_layers_inv if len(t) >= n_elem]
    for e0, k in blocks:
        tw = fft_sharded.block_twiddles(mesh, n, e0, k, "cpu")
        inv = fri.block_fold_tables(mesh, n, e0, k, "cpu")
        assert tw.shape == (k, (1 << (n - log_s)) - 1) and len(inv) == len(jfold)
        for i in range(k):
            s = e0 + i
            want = np.concatenate([jstages[n - 1 - p][s::n_elem] for p in range(log_s, n)])
            np.testing.assert_array_equal(tw[i].numpy().view(np.uint32), want)
            for t, table in enumerate(inv):
                np.testing.assert_array_equal(table[i].numpy().view(np.uint32), jfold[t][s::n_elem])
        assert fft_sharded.block_twiddles(mesh, n, e0, k, "cpu") is tw
        assert fri.block_fold_tables(mesh, n, e0, k, "cpu") is inv
        other = sharding.make_mesh(1, n_elem, devices=["cpu"] * n_elem)
        assert fft_sharded.block_twiddles(other, n, e0, k, "cpu") is not tw


def test_fft_exchange_cpu_equals_plain():
    rng = np.random.default_rng(11)
    x = from_numpy_u32(rng.integers(0, P, (8, 4, 16), dtype=np.uint32), "cpu")
    tw = from_numpy_u32(rng.integers(0, P, (2,), dtype=np.uint32), "cpu")
    v = x.clone().view(2, 2, 2, 64)
    want_lo, want_hi = fft_ops.fft_exchange_plain(widen(v[:, 0]), widen(v[:, 1]), widen(tw))
    fft_ops.fft_exchange(v[:, 0], v[:, 1], tw)
    assert torch.equal(widen(v[:, 0]), want_lo) and torch.equal(widen(v[:, 1]), want_hi)
    a, b = x[0].clone().view(1, 1, -1), x[1].clone().view(1, 1, -1)
    lo, hi = fft_ops.fft_exchange_plain(widen(a), widen(b), widen(tw[:1]))
    keep_b = b.clone()
    fft_ops.fft_exchange(a, b, tw[:1], write_hi=False)
    assert torch.equal(widen(a), lo) and torch.equal(b, keep_b)
    fft_ops.fft_exchange(x[0].clone().view(1, 1, -1), b, tw[:1], write_lo=False)
    assert torch.equal(widen(b), hi)
    with pytest.raises(ValueError, match="overlap"):
        fft_ops.fft_exchange(v[:, 0], v[:, 0], tw)
    with pytest.raises(ValueError):
        fft_ops.fft_exchange(a, b, tw[:1], write_lo=False, write_hi=False)
    with pytest.raises(TypeError):
        fft_ops.fft_exchange(widen(a), widen(b), tw[:1])


def _frozen(name):
    case = CASES[name]
    return (synthetic_data(case["data_len"], case["data_seed_offset"]), case["seed"],
            PcsConfig.from_dict(case["config"]), case)


@pytest.mark.parametrize("name,mesh_shape", [
    ("dryrun_960B", (1, 8)), ("dryrun_960B", (2, 4)), ("dryrun_960B", (4, 2)),
    ("tiny_64B_default", (1, 8)), ("mid_4096B_lastlayer2", (1, 4)), ("mid_4096B_lastlayer2", (1, 16)),
])
def test_sharded_prove_matches_frozen_jax_bytes(name, mesh_shape):
    data, seed, cfg, case = _frozen(name)
    com, proof = sharding.sharded_commit_and_prove(data, seed, cfg, _mesh(*mesh_shape))
    assert com.hex() == case["commitment"]
    assert proof.to_bytes().hex() == case["wire_hex"]


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2)])
def test_sharded_prove_end_to_end_bit_identical(mesh_shape):
    """tests/test_sharding.py's case: the port's sharded proof equals its
    single-device proof (held to the JAX package's in test_torch_prove.py)
    and the JAX verifier accepts it."""
    c_single, p_single = api.commit_and_prove(DATA, 42, PROVE_CFG, device="cpu")
    c_sh, p_sh = sharding.sharded_commit_and_prove(DATA, 42, PROVE_CFG, _mesh(*mesh_shape))
    assert c_sh == c_single == japi.commit(DATA, 2)
    assert p_sh.to_bytes() == p_single.to_bytes()
    back = JProof.from_bytes(p_sh.to_bytes())
    assert japi.verify(back, 42)
    assert not japi.verify(back, 43)


def test_sharded_commit_phase_shards_every_wide_layer():
    """Layers at least 2S wide stay sharded (no full-width tensor); only the
    narrower ones are replicated; each has one tree of its kind."""
    S = 8
    log_total = log_total_for(len(DATA))
    words = upload_words([DATA], log_total, "cpu")[1][0]
    c = fri.commit_phase_sharded(words, log_total, 42, PROVE_CFG, _mesh(1, S), 0)
    widths = []
    for layer, tree in zip(c.layers, c.trees):
        if isinstance(layer, Sharded):
            widths.append(("sharded", layer.width))
            assert layer.width >= 2 * S and isinstance(tree, merkle.ShardedTree)
            assert all(p.shape[-1] == layer.width // S for p in layer.parts.values())
        else:
            widths.append(("replicated", layer.shape[1]))
            assert layer.shape[1] < 2 * S and isinstance(tree, merkle.PrunedTree)
    assert widths == [("sharded", 1 << k) for k in range(10, 3, -1)] + [("replicated", 8)]
    assert [r.hex() for r in c.roots] == [r.hex() for r in fri.commit_phase(
        words, log_total, 42, PROVE_CFG).roots]


def test_prove_many_sharded_matches_single_device_and_frozen():
    mesh = _mesh(2, 4)
    datas = [bytes((i * 13 + s) % 256 for i in range(2048)) for s in range(4)]
    seeds = [10, 11, 12, 13]
    batch = sharding.prove_many_sharded(datas, seeds, PROVE_CFG, mesh)
    for (cb, pb), d, s in zip(batch, datas, seeds):
        c_single, p_single = api.commit_and_prove(d, s, PROVE_CFG, device="cpu")
        assert cb == c_single
        assert pb.to_bytes() == p_single.to_bytes()
        assert japi.verify(JProof.from_bytes(pb.to_bytes()), s)
    data, seed, cfg, case = _frozen("dryrun_960B")
    for com, proof in sharding.prove_many_sharded([data, data], [seed, seed], cfg, mesh):
        assert com.hex() == case["commitment"] and proof.to_bytes().hex() == case["wire_hex"]


@pytest.mark.parametrize("datas,seeds,cfg,match", [
    ([b"a", b"b"], [1], PROVE_CFG, "seeds"),
    ([b"a", b"b"], [1, None], PROVE_CFG, "all None or all set"),
    ([bytes(100), bytes(4000)], [1, 2], PROVE_CFG, "padded size"),
    ([], [], PROVE_CFG, "all None or all set"),  # the JAX package checks the seeds first
    ([bytes(64)], [1], PcsConfig(pow_bits=5, fri_config=FriConfig(2, 8, 8)), "unsatisfiable"),
])
def test_prove_many_sharded_errors_are_jax(datas, seeds, cfg, match):
    jcfg = JPcsConfig(pow_bits=cfg.pow_bits, fri_config=JFriConfig(
        cfg.fri_config.log_blowup_factor, cfg.fri_config.log_last_layer_degree_bound,
        cfg.fri_config.n_queries))
    with pytest.raises(ValueError, match=match):
        jsharding.prove_many_sharded(datas, seeds, jcfg, jsharding.make_mesh(2, 4))
    with pytest.raises(ValueError, match=match):
        sharding.prove_many_sharded(datas, seeds, cfg, _mesh(2, 4))


def test_make_mesh_shapes_and_errors():
    mesh = sharding.make_mesh(devices=["cpu"] * 8)
    assert mesh.shape == {"data": 1, "elem": 8}
    assert sharding.make_mesh(n_elem=2, devices=["cpu"] * 8).shape == {"data": 4, "elem": 2}
    assert sharding.make_mesh(n_data=2, devices=["cpu"] * 8).shape == {"data": 2, "elem": 4}
    mesh = sharding.make_mesh(2, 2, devices=["cpu"] * 5)
    assert mesh.rows() == [0, 1] and mesh.local_elems(1) == [0, 1]
    assert mesh.blocks(1) == [(0, 2, torch.device("cpu"))]
    with pytest.raises(AssertionError):
        sharding.make_mesh(4, 4, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="power of two"):
        sharding.make_mesh(1, 3, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="slots"):
        Mesh(2, 4, ["cpu"] * 4)
    with pytest.raises(ValueError):
        Mesh(1, 2, ["meta", "meta"])


def test_cuda_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharding.make_mesh(1, 2, devices=["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharding.make_mesh()
