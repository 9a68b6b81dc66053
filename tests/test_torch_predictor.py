"""The port's Ch. 3 merge-saving predictor (``repro_torch.core.predictor``)
against the JAX package's, on ``VideoExecModel.make_dataset`` data.

* ``RegressionTree``, ``GBDT``, ``NaivePredictor`` and ``accuracy`` are the
  same numpy code: predictions, staged RMSEs and accuracies are bit-equal.
* The MLP, started from the JAX package's initial parameters (rebuilt here
  with the same ``jax.random`` calls) carried over by
  ``bridge.params_from_jax``, predicts within atol 1e-5 of the JAX
  ``MLPPredictor`` after the same training (60 full-batch Adam steps on
  400 rows; measured: 4e-7, and 4e-7 at the benchmark's 500 steps on 5000
  rows): the same f32 arithmetic, with other summation orders in the
  products and gradients.
* ``MLPPredictor()`` resolves its device like every entry point of the
  port: CUDA unless told otherwise, raising on a host without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.merge_model import VideoExecModel
from repro.core import predictor as J
from repro_torch.bridge import params_from_jax
from repro_torch.core import predictor as P

MLP_ATOL = 1e-5


@pytest.fixture(scope="module")
def data():
    model = VideoExecModel(seed=1)
    X, y = model.make_dataset(400, np.random.default_rng(0))
    Xt, yt = model.make_dataset(150, np.random.default_rng(99))
    return X, y, Xt, yt


def test_regression_tree_bit_equal(data):
    X, y, Xt, _ = data
    ours = P.RegressionTree(max_depth=6, min_samples_split=20).fit(X, y)
    ref = J.RegressionTree(max_depth=6, min_samples_split=20).fit(X, y)
    for name in ("feature", "threshold", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    np.testing.assert_array_equal(ours.predict(Xt), ref.predict(Xt))


@pytest.mark.parametrize("kw", [dict(n_estimators=12, max_depth=5),
                                dict(n_estimators=8, max_depth=8,
                                     subsample=1.0, seed=3)])
def test_gbdt_bit_equal(data, kw):
    X, y, Xt, yt = data
    ours, ref = P.GBDT(**kw).fit(X, y), J.GBDT(**kw).fit(X, y)
    np.testing.assert_array_equal(ours.predict(Xt), ref.predict(Xt))
    assert ours.staged_rmse(Xt, yt) == ref.staged_rmse(Xt, yt)


def test_naive_and_accuracy_bit_equal(data):
    X, y, Xt, yt = data
    ours, ref = P.NaivePredictor().fit(X, y), J.NaivePredictor().fit(X, y)
    assert ours.table == ref.table
    np.testing.assert_array_equal(ours.predict(Xt), ref.predict(Xt))
    pred = ours.predict(Xt)
    for tau in (0.12, 0.08, 0.0):
        assert P.accuracy(pred, yt, tau) == J.accuracy(pred, yt, tau)


def _jax_init(d: int, hidden: int, seed: int) -> dict:
    """The JAX ``MLPPredictor.fit``'s initial parameters, by its own calls."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    h = hidden
    params = {
        "w1": jax.random.normal(k1, (d, h)) * (1.0 / np.sqrt(d)),
        "b1": jnp.zeros(h),
        "w2": jax.random.normal(k2, (h, h)) * (1.0 / np.sqrt(h)),
        "b2": jnp.zeros(h),
        "w3": jax.random.normal(k3, (h, 1)) * (1.0 / np.sqrt(h)),
        "b3": jnp.zeros(1),
    }
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("hidden,seed", [(64, 0), (16, 4)])
def test_mlp_from_jax_init_matches_jax(data, monkeypatch, hidden, seed):
    X, y, Xt, _ = data
    ref = J.MLPPredictor(hidden=hidden, steps=60, seed=seed).fit(X, y)
    init = _jax_init(X.shape[1], hidden, seed)
    seen = []

    def from_jax(d, h, s, device):
        seen.append((d, h, s))
        return params_from_jax(init, device)

    monkeypatch.setattr(P, "init_mlp_params", from_jax)
    ours = P.MLPPredictor(hidden=hidden, steps=60, seed=seed,
                          device="cpu").fit(X, y)
    assert seen == [(X.shape[1], hidden, seed)]
    got, want = ours.predict(Xt), ref.predict(Xt)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == want.shape == (len(Xt),)
    np.testing.assert_allclose(got, want, rtol=0, atol=MLP_ATOL)
    for k, v in ours._params.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_allclose(v.numpy(), ref._params[k], rtol=0,
                                   atol=MLP_ATOL)


def test_mlp_init_shapes_scales_and_seed():
    p = P.init_mlp_params(11, 64, 0, "cpu")
    ref = _jax_init(11, 64, 0)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert all(not v.any() for k, v in p.items() if k.startswith("b"))
    # normal draws over sqrt(fan-in): w1's std near 1/sqrt(11)
    assert abs(float(p["w1"].std()) * np.sqrt(11) - 1.0) < 0.15
    again = P.init_mlp_params(11, 64, 0, "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    other = P.init_mlp_params(11, 64, 1, "cpu")
    assert not torch.equal(p["w1"], other["w1"])


def test_mlp_learns_on_cpu(data):
    X, y, Xt, yt = data
    mlp = P.MLPPredictor(steps=200, device="cpu").fit(X, y)
    naive = P.NaivePredictor().fit(X, y)
    assert P.accuracy(mlp.predict(Xt), yt) > \
        P.accuracy(naive.predict(Xt), yt)


def test_mlp_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.MLPPredictor()
