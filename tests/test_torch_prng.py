"""The port's reproduction of ``jax.random`` (``repro_torch/core/prng.py``)
against JAX itself, bit for bit; and the port's DEFAULT center draws, with
nothing injected, against the reference's: the stages decomposition, its
quotient and Phi must be byte-identical for the same seed, and the random
one-shot draw must be the reference's ``split`` uniforms."""

import torch_testing  # noqa: F401  (first: one thread, the x64 shim)

import jax

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.core import ClusterQuotientEstimator as RefCQ  # noqa: E402
from repro.core import open_session as ref_open_session  # noqa: E402
from repro.core.cluster import cluster as ref_cluster  # noqa: E402
from repro.graph import generators as ref_gen  # noqa: E402
from repro_torch.core import (ClusterQuotientEstimator,  # noqa: E402
                              open_session, prng)
from repro_torch.core.cluster import cluster  # noqa: E402
from repro_torch.core.engine import (default_oneshot_uniform_fn,  # noqa: E402
                                     default_uniform_fn)
from repro_torch.graph import generators as gen  # noqa: E402

SEEDS = [0, 1, 3, 123456789, 2**31 - 1]


def _words(key) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


def _bits(x) -> np.ndarray:
    x = np.asarray(x)
    assert x.dtype == np.float32
    return x.view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert prng.prng_key(seed) == _words(key)
    for stage in (0, 1, 7, 63):
        ks = jax.random.fold_in(key, stage)
        pks = prng.fold_in(prng.prng_key(seed), stage)
        assert pks == _words(ks)
        for t in (0, 1, 8):
            assert prng.fold_in(pks, t) == _words(jax.random.fold_in(ks, t))
    k1, k2 = jax.random.split(key)
    assert prng.split(prng.prng_key(seed)) == (_words(k1), _words(k2))


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 1_000_003])
@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_uniform_matches_jax_bit_for_bit(seed, n):
    key = jax.random.PRNGKey(seed)
    pkey = prng.prng_key(seed)
    for stage, t in ((0, 0), (5, 2)):
        want = jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, stage), t), (n,))
        got = prng.uniform(prng.fold_in(prng.fold_in(pkey, stage), t), n,
                           "cpu")
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    want = jax.random.uniform(jax.random.split(key)[1], (n,))
    got = prng.uniform(prng.split(pkey)[1], n, "cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


def test_default_draws_are_the_reference_streams():
    n = 4097
    key = jax.random.PRNGKey(11)
    stage_draw = default_uniform_fn(11, "cpu")
    np.testing.assert_array_equal(
        _bits(stage_draw(4, 1, n).numpy()),
        _bits(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, 4), 1), (n,))))
    k1, k2 = jax.random.split(key)
    oneshot_draw = default_oneshot_uniform_fn(11, "cpu")
    np.testing.assert_array_equal(_bits(oneshot_draw(0, 0, n).numpy()),
                                  _bits(jax.random.uniform(k1, (n,))))
    np.testing.assert_array_equal(_bits(oneshot_draw(0, 1, n).numpy()),
                                  _bits(jax.random.uniform(k2, (n,))))


def test_prng_key_rejects_negative_seed():
    with pytest.raises(ValueError, match="seed"):
        prng.prng_key(-1)


@pytest.mark.parametrize("n", [2000, 5000])
def test_default_draw_stages_decomposition_matches_reference(n):
    """Nothing injected on either side: the port's own default draw must
    give the reference's decomposition and Phi for the same seed."""
    ref_e, e = ref_gen.road_like(n, seed=0), gen.road_like(n, seed=0)
    for seed in (0, 3):
        want = ref_cluster(ref_e, 4, seed=seed)
        got = cluster(e, 4, seed=seed, backend="single", device="cpu")
        np.testing.assert_array_equal(want.final_c, got.final_c)
        np.testing.assert_array_equal(want.final_pathw, got.final_pathw)
        for f in ("radius", "n_stages", "growing_steps", "delta_end",
                  "n_clusters"):
            assert getattr(want, f) == getattr(got, f), f
    want = RefCQ().estimate(ref_open_session(ref_e))
    got = ClusterQuotientEstimator().estimate(
        open_session(e, backend="single", device="cpu"))
    for f in ("phi_approx", "phi_quotient", "radius", "n_clusters",
              "growing_steps", "n_stages", "connected"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.quotient_ecc, want.quotient_ecc)


def test_default_draw_decomposition_matches_reference_at_200k():
    """The same at n = 200,000 and the main path's tau of 16, where most
    stages draw hundreds of centers. k is the stages' drawn centers plus
    the nodes still uncovered when the stop rule fires (each a singleton
    cluster)."""
    n = 200_000
    ref_e, e = ref_gen.road_like(n, seed=0), gen.road_like(n, seed=0)
    for seed in (0, 1):
        want = ref_cluster(ref_e, 16, seed=seed)
        got = cluster(e, 16, seed=seed, backend="single", device="cpu")
        np.testing.assert_array_equal(want.final_c, got.final_c)
        np.testing.assert_array_equal(want.final_pathw, got.final_pathw)
        for f in ("radius", "n_stages", "growing_steps", "delta_end",
                  "n_clusters"):
            assert getattr(want, f) == getattr(got, f), f
        m = got.metrics
        assert m.centers_drawn + m.uncovered_at_stop == got.n_clusters
