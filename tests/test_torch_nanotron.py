"""nanotron of the port held against picasso_tpu.nanotron on the CPU: the
image preparation and the pick renders, the MLP's forward pass from
weights carried across from flax (params_from_jax), one batch's loss and
gradients against jax.value_and_grad, Adam against optax, training from
carried weights on JAX's tests/test_frontends.py::TestNanotron recipe,
the port's own initialisation against flax's lecun_normal, model files
of both packages, and the card's absence.

Tolerances (measured on the CPU, torch 2.13, jax 0.9, flax 0.12, optax
0.2.6, in the comments):
- prepare_img, rotate_img: equal (the same numpy and scipy code); the
  smooth pick renders within RENDER_REL of the image's maximum (the
  smoke's RENDER_AGREE for ``smooth``);
- logits from the same weights within LOGITS_REL of the largest |logit|
  (f32 products in another summation order);
- one batch's loss within LOSS_REL, gradients within GRAD_REL of the
  largest |gradient| of each tensor;
- Adam against optax from the same state and gradients: at most
  ADAM_ULPS f32 ulps apart after each of ADAM_STEPS steps (measured 0);
- training from the same weights: torch_parity.compare_mlp (loss curves
  within MLP_LOSS_REL, predictions equal; measured 1.8e-7 over 5
  epochs).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from picasso_tpu import nanotron as jn
from picasso_torch import nanotron as tn
from torch_parity import compare_mlp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER_REL = 1e-6
LOGITS_REL = 1e-6
LOSS_REL = 1e-6
GRAD_REL = 1e-5
ADAM_ULPS, ADAM_STEPS = 2, 4


def _make_locs(rng, kind, n_picks, start_group=0):
    """tests/test_frontends.py::TestNanotron's picks: tight spots or rings
    of 80 locs a pick."""
    rows = []
    for g in range(n_picks):
        cx, cy = rng.uniform(5, 27, 2)
        if kind == "spot":
            pts = rng.normal((cx, cy), 0.05, (80, 2))
        else:
            ang = rng.uniform(0, 2 * np.pi, 80)
            pts = np.column_stack([cx + 0.4 * np.cos(ang),
                                   cy + 0.4 * np.sin(ang)]
                                  ) + rng.normal(0, 0.03, (80, 2))
        for p in pts:
            rows.append((g + start_group, p[0], p[1]))
    arr = np.array(rows)
    locs = np.zeros(len(arr), [("frame", np.uint32), ("x", np.float32),
                               ("y", np.float32), ("group", np.int32),
                               ("lpx", np.float32), ("lpy", np.float32)])
    locs["frame"] = np.arange(len(arr)) % 100
    locs["x"], locs["y"] = arr[:, 1], arr[:, 2]
    locs["group"] = arr[:, 0]
    locs["lpx"] = locs["lpy"] = 0.03
    return locs


@pytest.fixture(scope="module")
def recipe():
    """JAX's recipe: 12 spot and 12 ring picks, rendered at oversampling
    10 in 20 x 20 images, four turns each (96 images)."""
    rng = np.random.default_rng(0)
    spots, rings = _make_locs(rng, "spot", 12), _make_locs(rng, "ring", 12)
    data, labels = [], []
    for locs, label in ((spots, 0), (rings, 1)):
        d, lab = jn.prepare_data(pd.DataFrame(locs), label, pick_radius=1.0,
                                 oversampling=10)
        data += d
        labels += lab
    return spots, rings, np.stack(data), np.asarray(labels)


def _jax_init(X, y, hidden=(32,)):
    """The JAX model's initial weights: its fit at max_iter 0."""
    return jn.MLPClassifier(hidden_layer_sizes=hidden, max_iter=0).fit(X, y)


def test_prepare_and_render_match_jax(recipe):
    spots, rings, X, _ = recipe
    walls = {}
    for locs, label in ((spots, 0), (rings, 1)):
        got, lab = tn.prepare_data(locs, label, pick_radius=1.0,
                                   oversampling=10, device="cpu", walls=walls)
        want, jlab = jn.prepare_data(pd.DataFrame(locs), label,
                                     pick_radius=1.0, oversampling=10)
        assert lab == jlab and len(got) == len(want) == 48
        for a, b in zip(got, want):
            assert a.shape == b.shape == (400,)
            np.testing.assert_allclose(a, b, rtol=0, atol=10 * RENDER_REL)
    assert walls["render"] > 0 and walls["rotations"] > 0
    img = np.random.default_rng(1).random((20, 20))
    np.testing.assert_array_equal(tn.prepare_img(img, 20, 10, 1),
                                  jn.prepare_img(img, 20, 10, 1))
    np.testing.assert_array_equal(tn.rotate_img(img, 90),
                                  jn.rotate_img(img, 90))
    for pick, picks in ((3, None), (0, (float(rings["x"][5]),
                                        float(rings["y"][5])))):
        got = tn.roi_to_img(rings, pick, 1.0, 10, picks, device="cpu")
        want = jn.roi_to_img(pd.DataFrame(rings), pick, 1.0, 10, picks)
        assert got.shape == want.shape == (20, 20)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RENDER_REL * want.max())


def test_params_from_jax_gives_flaxs_logits(recipe):
    _, _, X, y = recipe
    jm = _jax_init(X, y, hidden=(32, 16))
    tm = tn.MLPClassifier(hidden_layer_sizes=(32, 16), max_iter=0,
                          device="cpu").fit(X, y, tn.params_from_jax(
                              jm.params))
    got, want = tm._logits(X), jm._logits(X)
    assert got.shape == want.shape == (96, 2)
    assert np.abs(got - want).max() <= LOGITS_REL * np.abs(want).max()
    np.testing.assert_array_equal(tm.predict(X), jm.predict(X))
    np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X),
                               rtol=0, atol=1e-6)
    state = tn.params_from_jax(jm.params)
    assert state["0.weight"].shape == (32, 400)
    np.testing.assert_array_equal(state["2.weight"],
                                  jm.params["params"]["Dense_1"]["kernel"].T)


def test_one_batch_loss_and_gradients_match_jax(recipe):
    import jax
    import jax.numpy as jnp
    import optax

    _, _, X, y = recipe
    jm = _jax_init(X, y)
    model = jm._model()
    xb, yb = X[:64].astype(np.float32), y[:64]

    def loss_fn(p):
        logits = model.apply(p, jnp.asarray(xb))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(yb)).mean()

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jm.params)
    net = tn._network([400, 32, 2])
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                         tn.params_from_jax(jm.params).items()})
    loss_t = tn.cross_entropy(net(torch.from_numpy(xb)),
                              torch.from_numpy(yb.astype(np.int64)))
    grads_t = torch.autograd.grad(loss_t, list(net.parameters()))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= LOSS_REL * float(
        loss_j)
    for g_t, (name, g_j) in zip(grads_t, tn.params_from_jax(
            jax.device_get(grads_j)).items()):
        d = np.abs(g_t.numpy() - g_j).max()
        assert d <= GRAD_REL * np.abs(g_j).max(), (name, d)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def test_adam_matches_optax():
    """ADAM_STEPS steps of both from the same weights and gradients (f32
    gradients over seven decades), one state each: within ADAM_ULPS
    ulps after every step."""
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(5)
    shapes = [(40, 30), (30,), (2, 40)]
    params = [rng.normal(0, 0.2, s).astype(np.float32) for s in shapes]
    tx = optax.adam(1e-3)
    state = tx.init([jnp.asarray(p) for p in params])
    p_j = [jnp.asarray(p) for p in params]
    p_t = [torch.from_numpy(p.copy()) for p in params]
    opt = tn.Adam(p_t, 1e-3)
    worst = 0
    for _ in range(ADAM_STEPS):
        grads = [(rng.normal(0, 1, s) * 10.0 ** rng.uniform(-7, 0, s)
                  ).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state)
        p_j = optax.apply_updates(p_j, updates)
        opt.step([torch.from_numpy(g) for g in grads])
        worst = max(worst, max(_ulps(np.asarray(jax.device_get(a)),
                                     b.numpy()) for a, b in zip(p_j, p_t)))
    print(f"Adam against optax: at most {worst} f32 ulps")
    assert worst <= ADAM_ULPS


def test_training_from_carried_weights_matches_jax(recipe):
    """JAX's TestNanotron recipe (hidden (32,)) for 5 epochs from the
    same initial weights: compare_mlp on the loss curves and the
    predictions of every image."""
    _, _, X, y = recipe
    init = _jax_init(X, y)
    jm = jn.MLPClassifier(hidden_layer_sizes=(32,), max_iter=5).fit(X, y)
    tm = tn.MLPClassifier(hidden_layer_sizes=(32,), max_iter=5,
                          device="cpu").fit(X, y,
                                            tn.params_from_jax(init.params))
    assert len(tm.loss_curve_) == 5
    stats = compare_mlp(tm.loss_curve_, jm.loss_curve_, tm.predict(X),
                        jm.predict(X), what="port vs JAX")
    print("training from carried weights:", stats)
    assert tm.score(X, y) == jm.score(X, y)


def test_the_ports_recipe_trains_and_predicts(recipe, tmp_path):
    """JAX's TestNanotron end to end with the port's own init (60
    epochs): accuracy above 0.9, a fresh ring pick classified, and the
    port's model file round trip."""
    spots, rings, _, _ = recipe
    data, labels = [], []
    for locs, label in ((spots, 0), (rings, 1)):
        d, lab = tn.prepare_data(locs, label, pick_radius=1.0,
                                 oversampling=10, device="cpu")
        data += d
        labels += lab
    model = tn.train_model(data, labels, hidden_layer_sizes=(32,),
                           max_iter=60, device="cpu")
    assert model.score(np.stack(data), np.asarray(labels)) > 0.9
    test = _make_locs(np.random.default_rng(9), "ring", 1)
    pred, proba = tn.predict_structure(model, test, 0, pick_radius=1.0,
                                       oversampling=10, device="cpu")
    assert pred[0] == 1 and proba.shape == (1, 2)
    path = str(tmp_path / "model.sav")
    tn.save_model(path, model, {"classes": [0, 1]})
    loaded, info = tn.load_model(path, device="cpu")
    assert info == {"classes": [0, 1]}
    assert loaded.loss_curve_ == model.loss_curve_
    assert loaded.hidden_layer_sizes == (32,)
    np.testing.assert_array_equal(loaded._logits(np.stack(data)),
                                  model._logits(np.stack(data)))


def test_init_follows_flaxs_lecun_normal():
    """The port's init against flax Dense's default kernel initializer at
    (fan_in 400, fan_out 300): mean within 4 standard errors of 0, the
    std within 1% of sqrt(1 / fan_in) (the truncation's correction makes
    it so), every draw within 2 of the normal's standard deviations, and
    the two samples alike by a KS test; zero biases."""
    import jax
    from flax.linen import initializers
    from scipy.stats import ks_2samp

    fan_in, fan_out = 400, 300
    w = tn.init_params([fan_in, fan_out, 2], seed=3)
    kernel = w["0.weight"]
    assert kernel.shape == (fan_out, fan_in) and kernel.dtype == np.float32
    assert not w["0.bias"].any() and not w["2.bias"].any()
    flax_k = np.asarray(initializers.lecun_normal()(
        jax.random.PRNGKey(3), (fan_in, fan_out)))
    target = np.sqrt(1 / fan_in)
    for k in (kernel, flax_k):
        assert abs(k.mean()) <= 4 * target / np.sqrt(k.size)
        assert abs(k.std() / target - 1) <= 0.01
        assert np.abs(k).max() <= 2 * target / 0.87962566103423978 + 1e-7
    assert ks_2samp(kernel.ravel(), flax_k.ravel()).pvalue > 1e-3
    np.testing.assert_array_equal(tn.init_params([fan_in, fan_out, 2], 3)[
        "0.weight"], kernel)
    assert not np.array_equal(tn.init_params([fan_in, fan_out, 2], 4)[
        "0.weight"], kernel)


def test_load_model_reads_a_jax_model_file(recipe, tmp_path):
    """A file of picasso_tpu.nanotron.save_model loads in the port, in a
    process that never imports picasso_tpu, and predicts as JAX's model
    does."""
    _, _, X, y = recipe
    jm = jn.MLPClassifier(hidden_layer_sizes=(32,), max_iter=3).fit(X, y)
    path = str(tmp_path / "jax_model.sav")
    jn.save_model(path, jm, {"origin": "jax"})
    np.save(tmp_path / "X.npy", X)
    code = (
        "import sys, numpy as np\n"
        "from picasso_torch import nanotron\n"
        f"m, info = nanotron.load_model({path!r}, device='cpu')\n"
        "assert 'picasso_tpu' not in sys.modules and 'jax' not in "
        "sys.modules\n"
        f"X = np.load({str(tmp_path / 'X.npy')!r})\n"
        f"np.save({str(tmp_path / 'pred.npy')!r}, m.predict_proba(X))\n"
        "assert info == {'origin': 'jax'}, info\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    proba = np.load(tmp_path / "pred.npy")
    np.testing.assert_allclose(proba, jm.predict_proba(X), rtol=0, atol=1e-6)
    loaded, _ = tn.load_model(path, device="cpu")
    np.testing.assert_array_equal(loaded.predict(X), jm.predict(X))
    assert loaded.loss_curve_ == jm.loss_curve_
    assert list(loaded.classes_) == list(jm.classes_)


def test_nanotron_needs_the_card_by_default(recipe):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    spots, _, X, y = recipe
    calls = [
        lambda: tn.prepare_data(spots, 0, 1.0, 10),
        lambda: tn.roi_to_img(spots, 0, 1.0, 10),
        lambda: tn.train_model(list(X), list(y), max_iter=1),
        lambda: tn.MLPClassifier().fit(X, y),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    model = tn.MLPClassifier(device="cpu", max_iter=1).fit(X, y)
    model.device = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        model.predict(X)
