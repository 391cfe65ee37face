"""Cross tests of the port's kernel-grid autotune against the JAX package's
(mirrors ``tests/test_tuning.py``'s six cases on the port's keys): the sweep
persists its winner and ``from_dia`` resolves it (explicit > cache >
defaults), a corrupt cache reads as empty, the dtype/band-count/kind keys
are separate, the complex sweep, and invalid candidates skipped.  The port
tunes the dot kernels' blocks per SM (``dot_blocks_per_sm``), not the TPU's
(lanes, block_rows); the timer is monkeypatched so the winner is set, not
measured.  The size bucket and the key layout equal the JAX package's
(``_bucket``, ``kind|device|dtype|b<bands>|n<bucket>``); results of a tuned
operator match the JAX package's DIA SpMV within f32 rounding (rtol 1e-5)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sprsolve_tpu.ops.spmv import spmv_dia as jspmv_dia
from sprsolve_tpu.utils import problems as jprob
from sprsolve_tpu.utils import tuning as jtuning
import sprsolve_tpu_torch as tsp
from sprsolve_tpu_torch.ops import padded_dia as pd
from sprsolve_tpu_torch.utils import problems, tuning

torch.set_num_threads(2)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("SPRSOLVE_TUNE_CACHE", path)
    return path


@pytest.fixture
def timer(monkeypatch):
    """``time_fn`` replaced: a candidate's time is 1/blocks_per_sm µs, but
    4 blocks per SM is the fastest (0.1 µs)."""
    from sprsolve_tpu_torch.utils import timing

    def fake(step, x, iters=20, **kw):
        step(x)
        bps = fake.current
        return 1e-7 if bps == 4 else 1e-6 / bps

    fake.current = None
    build = tuning._sweep

    def sweep(kind, build_op, *args):
        def tracking(bps):
            fake.current = bps
            return build_op(bps)
        return build(kind, tracking, *args)

    monkeypatch.setattr(timing, "time_fn", fake)
    monkeypatch.setattr(tuning, "_sweep", sweep)
    return fake


def _dia(n_side=12, dtype=np.float32):
    return problems.grid_laplacian_dirichlet((n_side, n_side), dtype=dtype).to_dia()


def test_tune_persists_and_from_dia_resolves(cache, timer):
    m = _dia()
    op = tuning.tune_padded_dia(m, candidates=(2, 4, 8), iters=3, device="cpu")
    assert isinstance(op, tsp.PaddedDIA) and op.dot_blocks_per_sm == 4
    saved = json.load(open(cache))
    (key, ent), = saved.items()
    assert key == jtuning._key("dia", np.float32, len(m.offsets), m.shape[0])
    assert key.startswith("dia|cpu|float32|b5|n256")
    assert ent["blocks_per_sm"] == 4 and ent["gnnz_s"] > 0
    # a fresh from_dia with no explicit grid takes the tuned one, and a
    # nearby size of the same bucket (144 and 169 rows: 256) too
    assert tsp.PaddedDIA.from_dia(m).dot_blocks_per_sm == 4
    assert tsp.PaddedDIA.from_dia(_dia(13)).dot_blocks_per_sm == 4
    assert tsp.optimize(problems.grid_laplacian_dirichlet((12, 12), dtype=np.float32),
                        device="cpu").dot_blocks_per_sm == 4
    # the tuned operator computes what the JAX package's DIA does
    x = np.random.default_rng(0).standard_normal(m.shape[0]).astype(np.float32)
    got = op.unpad_vec(op.matvec(op.pad_vec(torch.from_numpy(x)))).numpy()
    jm = jprob.grid_laplacian_dirichlet((12, 12), dtype=np.float32).to_dia()
    np.testing.assert_allclose(got, np.asarray(jspmv_dia(jm, jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)


def test_explicit_grid_beats_cache(cache):
    m = _dia()
    tuning.store("dia", np.float32, len(m.offsets), m.shape[0], "cpu",
                 {"blocks_per_sm": 2}, 1.0)
    assert tsp.PaddedDIA.from_dia(m).dot_blocks_per_sm == 2
    assert tsp.PaddedDIA.from_dia(m, dot_blocks_per_sm=6).dot_blocks_per_sm == 6
    # the explicit grid reaches the kernel wrappers, whose plain versions on
    # the CPU do not depend on it
    op = tsp.PaddedDIA.from_dia(m, dot_blocks_per_sm=6)
    x = op.pad_vec(torch.ones(op.n))
    y, d = op.matvec_dot(x)
    y2, d2 = pd.dia_dot(op.bands, x, op.offsets, op.h, 1)
    assert torch.equal(y, y2) and torch.equal(d, d2)
    with pytest.raises(ValueError):
        tsp.PaddedDIA.from_dia(m, dot_blocks_per_sm=0)


def test_defaults_when_no_entry_and_when_corrupt(cache):
    m = _dia()
    assert tsp.PaddedDIA.from_dia(m).dot_blocks_per_sm is None
    with open(cache, "w") as f:
        f.write("{not json")
    assert tsp.PaddedDIA.from_dia(m).dot_blocks_per_sm is None   # no raise
    assert tuning.lookup("dia", np.float32, len(m.offsets), m.shape[0], "cpu") is None
    with open(cache, "w") as f:
        json.dump({tuning._key("dia", np.float32, len(m.offsets), m.shape[0], "cpu"):
                   {"blocks_per_sm": "many"}}, f)
    assert tsp.PaddedDIA.from_dia(m).dot_blocks_per_sm is None
    # the kernels' default grid: one wave of DOT_BLOCKS_PER_SM blocks per SM
    assert pd.persistent_grid(1 << 20, torch.float32, 132) == pd.persistent_grid(
        1 << 20, torch.float32, 132, pd.DOT_BLOCKS_PER_SM[torch.float32])


def test_dtype_bandcount_and_kind_keys_are_separate(cache):
    m = _dia()
    tuning.store("dia", np.float32, len(m.offsets), m.shape[0], "cpu",
                 {"blocks_per_sm": 2}, 1.0)
    assert tuning.lookup("dia", np.float64, len(m.offsets), m.shape[0], "cpu") is None
    assert tuning.lookup("dia", np.float32, len(m.offsets) + 2, m.shape[0], "cpu") is None
    assert tuning.lookup("cdia", np.float32, len(m.offsets), m.shape[0], "cpu") is None
    assert tuning.lookup("dia", torch.float32, len(m.offsets), m.shape[0], "cpu") is not None
    # the JAX package's bucket and key layout, a device name in the device's place
    for n in (1, 2, 144, 169, 256, 257, 1_000_000):
        assert tuning._bucket(n) == jtuning._bucket(n)
        assert tuning._key("cdia", np.complex64, 7, n, "cpu") == jtuning._key(
            "cdia", np.complex64, 7, n)
    assert tsp.PaddedDIA.from_dia(_dia(dtype=np.float64)).dot_blocks_per_sm is None


def test_tune_complex_persists_and_resolves(cache, timer):
    A, _, _ = problems.complex_symmetric_grid_with_diag((12, 12), dtype=np.complex64)
    m = A.to_dia()
    op = tuning.tune_complex_padded_dia(m, candidates=(2, 4), iters=3, device="cpu")
    assert isinstance(op, tsp.ComplexPaddedDIA) and op.dot_blocks_per_sm == 4
    assert tsp.ComplexPaddedDIA.from_dia(m).dot_blocks_per_sm == 4
    assert tsp.optimize(A, device="cpu").dot_blocks_per_sm == 4
    saved = json.load(open(cache))
    assert any(k.startswith("cdia|cpu|complex64") for k in saved)
    # the real "dia" entry of the planes' dtype is not touched
    assert tuning.lookup("dia", np.float32, len(m.offsets), m.shape[0], "cpu") is None
    # K6/K7 through the tuned operator equal the untuned one's on the CPU
    x = op.pad_vec(torch.ones(op.n, dtype=torch.complex64))
    untuned = tsp.ComplexPaddedDIA.from_dia(m, dot_blocks_per_sm=1)
    assert all(torch.equal(a, b) for a, b in zip(op.matvec_dot(x), untuned.matvec_dot(x)))


def test_invalid_candidates_are_skipped(cache, timer):
    m = _dia()
    op = tuning.tune_padded_dia(m, candidates=(-1, 0, 2), iters=2, device="cpu")
    assert isinstance(op, tsp.PaddedDIA) and op.dot_blocks_per_sm == 2
    # with nothing left, the default operator comes back and nothing persists
    op = tuning.tune_padded_dia(_dia(20), candidates=(0,), iters=2, device="cpu")
    assert op.dot_blocks_per_sm is None
    assert len(json.load(open(cache))) == 1


def test_tune_checks_every_candidate_gives_the_same_bits(cache, monkeypatch):
    """The sweep holds each candidate's y and dots to the first's, bit for
    bit, and raises where one differs (a grid-dependent kernel)."""
    m = _dia()
    real_dot = pd.dia_dot

    def grid_dependent(bands, x, offsets, h, blocks_per_sm=None):
        y, d = real_dot(bands, x, offsets, h)
        return y, d + (0 if blocks_per_sm in (None, 2) else 1e-3)

    monkeypatch.setattr(pd, "dia_dot", grid_dependent)
    with pytest.raises(RuntimeError, match="blocks_per_sm=3"):
        tuning.tune_padded_dia(m, candidates=(2, 3), iters=2, device="cpu")


def test_tune_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.tune_padded_dia(_dia(), candidates=(2,), iters=2)
