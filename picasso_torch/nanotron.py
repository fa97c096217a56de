"""Classification of picked structures from their rendered images: a
multilayer perceptron trained and evaluated on a torch device.

Counterpart of picasso_tpu/nanotron.py (prepare_img :25, rotate_img :38,
roi_to_img :43, prepare_data :75, MLPClassifier :113, train_model :220,
save_model :236, load_model :243, predict_structure :249). Locs are
numpy structured arrays. Each pick renders through render.render with
the ``smooth`` blur on ``device``; the rotations of the augmentation are
scipy's on the host, as in JAX.

The classifier is flax's MLP (ReLU hidden layers, linear logits) as an
``nn.Sequential`` with JAX's sklearn-like API and training schedule: a
``np.random.default_rng(seed)`` permutation each epoch, batches of
``min(batch_size, n)`` with the last partial batch dropped, the mean
softmax cross-entropy, and Adam in optax's order of operations
(:class:`Adam`). The losses are read back once an epoch. Its initial
weights follow flax ``Dense``'s defaults (LeCun normal kernels truncated
at two standard deviations, zero biases) drawn from a
``torch.Generator`` seeded with ``seed``: JAX's threefry draws are not
reproduced, so a fresh model agrees with JAX's in distribution only;
:func:`params_from_jax` carries a flax model's weights across.

A model file is a pickle of plain data (numpy weights, classes,
hyperparameters, info); :func:`load_model` also reads the pickles that
picasso_tpu.nanotron.save_model writes, without importing picasso_tpu.
"""

from __future__ import annotations

import math
import pickle
import time
from typing import Sequence

import numpy as np
import torch
from scipy import ndimage

from picasso_torch import lib, render

#: the file format tag of the port's model pickles
FORMAT = "picasso_torch.nanotron.MLPClassifier"


def prepare_img(img: np.ndarray, img_shape: int, alpha: float = 1,
                bg: float = 0) -> np.ndarray:
    """Scale, background-subtract, normalize and flatten one image, in f64
    (picasso/nanotron.py:21)."""
    img = alpha * np.asarray(img, float) - bg
    mx = img.max()
    if mx > 0:
        img = img / mx
    img = img.clip(min=0)
    return img.reshape(img_shape**2)


def rotate_img(img: np.ndarray, angle: float) -> np.ndarray:
    """Rotate an image by ``angle`` degrees on the host
    (picasso/nanotron.py:54)."""
    return ndimage.rotate(img, angle, reshape=False)


def _render_pick(pick_locs: np.ndarray, radius: float, oversampling: float,
                 device) -> np.ndarray:
    """The smooth render of one pick's locs in a square of side 2 (radius
    - 0.001) px about their f32 mean."""
    radius -= 0.001
    x_mean = np.mean(np.ascontiguousarray(pick_locs["x"]))
    y_mean = np.mean(np.ascontiguousarray(pick_locs["y"]))
    viewport = ((y_mean - radius, x_mean - radius),
                (y_mean + radius, x_mean + radius))
    _, image = render.render(pick_locs, None, viewport=viewport,
                             oversampling=oversampling, blur_method="smooth",
                             device=device)
    return image


def roi_to_img(locs: np.ndarray, pick: int, radius: float,
               oversampling: float, picks=None, *, device="cuda"
               ) -> np.ndarray:
    """Render one pick, the locs of group ``pick`` or those within
    ``radius`` of ``picks`` = (x, y) sorted by frame, on ``device``
    (picasso/nanotron.py:74)."""
    device = lib.resolve_device(device)
    if picks is None:
        pick_locs = locs[locs["group"] == pick]
    else:
        pick_locs = lib.locs_at(*picks, locs, radius)
        pick_locs = pick_locs[np.argsort(pick_locs["frame"], kind="stable")]
    return _render_pick(pick_locs, radius, oversampling, device)


def prepare_data(locs: np.ndarray, label: int, pick_radius: float,
                 oversampling: float, alpha: float = 10, bg: float = 1,
                 export: bool = False, *, device="cuda",
                 walls: dict | None = None):
    """Every pick (group) rendered on ``device`` and turned by 0, 90, 180
    and 270 degrees, each image prepared (:func:`prepare_img`) and
    labelled ``label`` (picasso/nanotron.py:148). Returns (images,
    labels). ``walls``, where given, gains the seconds of the renders
    (``render``) and of the rotations and preparation (``rotations``)."""
    device = lib.resolve_device(device)
    img_shape = int(2 * pick_radius * oversampling)
    data, labels = [], []
    t_render = t_rot = 0.0
    _, rows = lib.group_rows(locs["group"])
    for r in rows:
        t0 = time.perf_counter()
        pick_img = _render_pick(locs[r], pick_radius, oversampling, device)
        t1 = time.perf_counter()
        for angle in (0, 90, 180, 270):
            img = pick_img if angle == 0 else rotate_img(pick_img, angle)
            data.append(prepare_img(img, img_shape=img_shape, alpha=alpha,
                                    bg=bg))
            labels.append(label)
        t_render += t1 - t0
        t_rot += time.perf_counter() - t1
    if walls is not None:
        walls["render"] = walls.get("render", 0.0) + t_render
        walls["rotations"] = walls.get("rotations", 0.0) + t_rot
    return data, labels


# ---------------------------------------------------------------------------
# the MLP classifier
# ---------------------------------------------------------------------------


def init_params(sizes: Sequence[int], seed: int = 0) -> dict:
    """Initial weights of an MLP of layer ``sizes`` (inputs, hidden...,
    classes) as a state dict of numpy f32 arrays: flax ``Dense``'s
    defaults, kernels LeCun normal (variance_scaling(1, "fan_in",
    "truncated_normal"): a standard normal truncated to [-2, 2] by the
    inverse CDF, times sqrt(1 / fan_in) / 0.87962566103423978) and zero
    biases, drawn from a ``torch.Generator`` seeded with ``seed`` on the
    CPU, so every device starts from the same weights."""
    gen = torch.Generator().manual_seed(seed)
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    state = {}
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        u = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float64)
        z = (math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)).clamp(-2, 2)
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        state[f"{2 * i}.weight"] = (z * std).T.to(torch.float32).numpy()
        state[f"{2 * i}.bias"] = np.zeros(fan_out, np.float32)
    return state


def params_from_jax(params) -> dict:
    """A flax MLP's weights, ``{"params": {"Dense_i": {"kernel": (in,
    out), "bias": (out,)}}}`` of numpy arrays, as the port's state dict:
    each kernel transposed to ``nn.Linear``'s (out, in)."""
    dense = params["params"]
    state = {}
    for i in range(len(dense)):
        layer = dense[f"Dense_{i}"]
        state[f"{2 * i}.weight"] = np.ascontiguousarray(
            np.asarray(layer["kernel"], np.float32).T)
        state[f"{2 * i}.bias"] = np.asarray(layer["bias"], np.float32)
    return state


def _network(sizes: Sequence[int]) -> torch.nn.Sequential:
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        layers += [torch.nn.Linear(fan_in, fan_out), torch.nn.ReLU()]
    return torch.nn.Sequential(*layers[:-1])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean softmax cross-entropy of integer labels as optax forms it
    (softmax_cross_entropy_with_integer_labels): the logits less their
    (constant) row maximum, log-sum-exp less the label's logit."""
    shifted = logits - logits.max(dim=1, keepdim=True).values.detach()
    label_logits = torch.gather(shifted, 1, labels[:, None])[:, 0]
    return (torch.log(torch.exp(shifted).sum(dim=1)) - label_logits).mean()


class Adam:
    """optax.adam's update in its order of operations (b1, b2, eps,
    eps_root 0): mu = (1 - b1) g + b1 mu and nu = (1 - b2) g g + b2 nu,
    each product rounded; mu_hat and nu_hat divided by the bias
    corrections 1 - b ** count (formed in f32 on the host, so every
    device divides by the same numbers); the update -lr mu_hat /
    (sqrt(nu_hat) + eps) added to the parameter. torch.optim.Adam folds
    the bias corrections and eps into other roundings."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        """One update of every parameter from its gradient; each
        operation is one multi-tensor launch over all parameters."""
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** c)
        grads = list(grads)
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - self.b1),
                                torch._foreach_mul(self.mu, self.b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - self.b2),
            torch._foreach_mul(self.nu, self.b2))
        denom = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, bc2)), self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_copy_(self.mu, mu)
        torch._foreach_copy_(self.nu, nu)
        torch._foreach_copy_(self.params, torch._foreach_add(
            self.params, torch._foreach_mul(update, -self.lr)))


class MLPClassifier:
    """sklearn-like MLP classifier trained and evaluated on ``device``
    (picasso_tpu/nanotron.py:113): ``fit``, ``predict``,
    ``predict_proba``, ``score``, ``classes_``, ``loss_curve_``;
    ``params`` is the state dict (numpy) of the trained network."""

    def __init__(self, hidden_layer_sizes: Sequence[int] = (100,),
                 learning_rate: float = 1e-3, max_iter: int = 200,
                 batch_size: int = 128, seed: int = 0, device="cuda"):
        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.batch_size = batch_size
        self.seed = seed
        self.device = device
        self.params = None
        self.classes_ = None
        self.loss_curve_ = []
        self._net = None

    def _sizes(self, n_features: int) -> list[int]:
        return [n_features, *self.hidden_layer_sizes, len(self.classes_)]

    def _net_on(self, device) -> torch.nn.Sequential:
        """The network with :attr:`params` on ``device``, kept for the
        next call."""
        if self._net is None or next(self._net.parameters()).device != device:
            n_features = self.params["0.weight"].shape[1]
            net = _network(self._sizes(n_features))
            net.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                                 for k, v in self.params.items()})
            self._net = net.to(device)
        return self._net

    def fit(self, X, y, params: dict | None = None):
        """Train for ``max_iter`` epochs from ``params`` (a state dict,
        e.g. :func:`params_from_jax`'s) or from :func:`init_params`."""
        device = lib.resolve_device(self.device)
        X = np.asarray(X, np.float32)
        self.classes_, y_idx = np.unique(np.asarray(y), return_inverse=True)
        self.params = (init_params(self._sizes(X.shape[1]), self.seed)
                       if params is None else params)
        self._net = None
        net = self._net_on(device)
        weights = list(net.parameters())
        opt = Adam(weights, self.learning_rate)
        X_d = torch.from_numpy(X).to(device)
        y_d = torch.from_numpy(y_idx.astype(np.int64)).to(device)
        n = len(X)
        rng = np.random.default_rng(self.seed)
        bs = min(self.batch_size, n)
        self.loss_curve_ = []
        for _ in range(self.max_iter):
            order = torch.from_numpy(rng.permutation(n)).to(device)
            losses = []
            for start in range(0, n - bs + 1, bs):
                idx = order[start:start + bs]
                loss = cross_entropy(net(X_d[idx]), y_d[idx])
                opt.step(torch.autograd.grad(loss, weights))
                losses.append(loss.detach())
            if losses:
                self.loss_curve_.append(float(np.mean(
                    torch.stack(losses).cpu().numpy().astype(np.float64))))
        self.params = {k: v.detach().cpu().numpy().copy()
                       for k, v in net.state_dict().items()}
        return self

    def _logits(self, X) -> np.ndarray:
        device = lib.resolve_device(self.device)
        with torch.no_grad():
            return self._net_on(device)(torch.from_numpy(np.asarray(
                X, np.float32)).to(device)).cpu().numpy()

    def predict(self, X) -> np.ndarray:
        return self.classes_[np.argmax(self._logits(X), axis=1)]

    def predict_proba(self, X) -> np.ndarray:
        logits = self._logits(X)
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y)))


def train_model(data: list[np.ndarray], labels: list[int],
                hidden_layer_sizes: Sequence[int] = (100,),
                max_iter: int = 200, learning_rate: float = 1e-3, *,
                device="cuda") -> MLPClassifier:
    """Train a classifier on prepared pick images on ``device``
    (picasso_tpu/nanotron.py:220)."""
    model = MLPClassifier(hidden_layer_sizes=hidden_layer_sizes,
                          max_iter=max_iter, learning_rate=learning_rate,
                          device=device)
    return model.fit(np.stack(data), np.asarray(labels))


_HYPERPARAMETERS = ("hidden_layer_sizes", "learning_rate", "max_iter",
                    "batch_size", "seed")


def save_model(path: str, model: MLPClassifier, info: dict | None = None):
    """Pickle the trained model as plain data: the numpy weights,
    ``classes_``, the hyperparameters, the loss curve and ``info``."""
    blob = {"format": FORMAT,
            "params": {k: np.asarray(v) for k, v in model.params.items()},
            "classes_": np.asarray(model.classes_),
            "loss_curve_": list(model.loss_curve_),
            **{k: getattr(model, k) for k in _HYPERPARAMETERS}}
    with open(path, "wb") as f:
        pickle.dump({"model": blob, "info": info or {}}, f)


class _JaxModel:
    """What a pickled picasso_tpu.nanotron.MLPClassifier unpickles to:
    its attributes (flax ``params`` of numpy arrays, ``classes_``, the
    hyperparameters), and nothing of the JAX package."""


class _ModelUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "picasso_tpu":
            if (module, name) == ("picasso_tpu.nanotron", "MLPClassifier"):
                return _JaxModel
            raise pickle.UnpicklingError(f"{module}.{name} is not a model")
        return super().find_class(module, name)


def load_model(path: str, *, device="cuda") -> tuple[MLPClassifier, dict]:
    """(model on ``device``, info) from a file of :func:`save_model`, or
    of picasso_tpu.nanotron.save_model (its flax weights carried across
    by :func:`params_from_jax`)."""
    with open(path, "rb") as f:
        blob = _ModelUnpickler(f).load()
    saved, info = blob["model"], blob.get("info", {})
    if isinstance(saved, _JaxModel):
        saved = dict(vars(saved), params=params_from_jax(saved.params))
    elif not (isinstance(saved, dict) and saved.get("format") == FORMAT):
        raise ValueError(f"{path} holds no nanotron model")
    model = MLPClassifier(**{k: saved[k] for k in _HYPERPARAMETERS},
                          device=device)
    model.params = saved["params"]
    model.classes_ = np.asarray(saved["classes_"])
    model.loss_curve_ = list(saved.get("loss_curve_", []))
    return model, info


def predict_structure(mlp: MLPClassifier, locs: np.ndarray, pick: int,
                      pick_radius: float, oversampling: float, *,
                      device="cuda"):
    """Classify one pick: render it on ``device``, prepare the image and
    predict (picasso/nanotron.py:218). Returns (prediction,
    probabilities)."""
    img_shape = int(2 * pick_radius * oversampling)
    pick_img = roi_to_img(locs, pick=pick, radius=pick_radius,
                          oversampling=oversampling, device=device)
    img = prepare_img(pick_img, img_shape=img_shape, alpha=10, bg=1)
    return mlp.predict(img.reshape(1, -1)), mlp.predict_proba(
        img.reshape(1, -1))
