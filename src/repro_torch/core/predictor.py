"""Merge-saving prediction (dissertation Sections 3.3-3.4).

Implements Algorithm 1: a from-scratch **Gradient Boosted Decision Tree**
regressor with the dissertation's hyper-parameters — number of trees M,
learning rate L, estimator max depth D, min samples to split an internal
node S, min samples per leaf J (tuned values M=350, L=0.1, D=11, S=30, J=2).

Two baselines for Fig. 3.5: a *Naive* lookup (mean saving per operation
signature) and a small *MLP* trained in PyTorch.  Accuracy is Eq. 3.2: the
fraction of predictions within tolerance tau of the observed saving.

A copy of ``repro.core.predictor`` for the port: the trees, the lookup and
``accuracy`` are the same numpy code; the MLP is the PyTorch twin of the
JAX one (same network, same hand-written Adam, f32 on an explicit device).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["RegressionTree", "GBDT", "NaivePredictor", "MLPPredictor",
           "init_mlp_params", "mlp_forward", "train_mlp", "accuracy"]


# ---------------------------------------------------------------------------
# Exact-greedy regression tree (vectorized splits)
# ---------------------------------------------------------------------------

class RegressionTree:
    def __init__(self, max_depth: int = 11, min_samples_split: int = 30,
                 min_samples_leaf: int = 2):
        self.max_depth = max_depth
        self.min_split = min_samples_split
        self.min_leaf = min_samples_leaf
        # flat arrays; node 0 is the root
        self.feature: list[int] = []
        self.threshold: list[float] = []
        self.left: list[int] = []
        self.right: list[int] = []
        self.value: list[float] = []

    def _new_node(self, value: float) -> int:
        self.feature.append(-1)
        self.threshold.append(0.0)
        self.left.append(-1)
        self.right.append(-1)
        self.value.append(value)
        return len(self.value) - 1

    def _best_split(self, X: np.ndarray, y: np.ndarray):
        """Best (feature, threshold) by SSE reduction, or None."""
        n = len(y)
        best = (0.0, None, None)
        y_sum, y_sq = y.sum(), (y * y).sum()
        for f in range(X.shape[1]):
            order = np.argsort(X[:, f], kind="stable")
            xs, ys = X[order, f], y[order]
            cum = np.cumsum(ys)[:-1]
            cnt = np.arange(1, n)
            # candidate split after position i (left = first i+1 samples)
            valid = (xs[1:] != xs[:-1])
            valid &= (cnt >= self.min_leaf) & ((n - cnt) >= self.min_leaf)
            if not valid.any():
                continue
            left_mean = cum / cnt
            right_mean = (y_sum - cum) / (n - cnt)
            # SSE reduction = n_l*m_l^2 + n_r*m_r^2 - n*m^2 (+const)
            gain = cnt * left_mean ** 2 + (n - cnt) * right_mean ** 2 \
                - y_sum * y_sum / n
            gain = np.where(valid, gain, -np.inf)
            i = int(np.argmax(gain))
            if gain[i] > best[0] + 1e-12:
                thr = 0.5 * (xs[i] + xs[i + 1])
                best = (float(gain[i]), f, thr)
        if best[1] is None:
            return None
        return best[1], best[2]

    def _build(self, X: np.ndarray, y: np.ndarray, depth: int) -> int:
        node = self._new_node(float(y.mean()))
        if depth >= self.max_depth or len(y) < self.min_split or y.std() < 1e-12:
            return node
        split = self._best_split(X, y)
        if split is None:
            return node
        f, thr = split
        mask = X[:, f] <= thr
        self.feature[node] = f
        self.threshold[node] = thr
        self.left[node] = self._build(X[mask], y[mask], depth + 1)
        self.right[node] = self._build(X[~mask], y[~mask], depth + 1)
        return node

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        self._build(np.asarray(X, float), np.asarray(y, float), 0)
        self._freeze()
        return self

    def _freeze(self):
        self.feature = np.asarray(self.feature, np.int32)
        self.threshold = np.asarray(self.threshold, np.float64)
        self.left = np.asarray(self.left, np.int32)
        self.right = np.asarray(self.right, np.int32)
        self.value = np.asarray(self.value, np.float64)

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, float)
        node = np.zeros(len(X), dtype=np.int32)
        active = self.left[node] >= 0
        while active.any():
            f = self.feature[node[active]]
            thr = self.threshold[node[active]]
            go_left = X[active, f] <= thr
            nxt = np.where(go_left, self.left[node[active]],
                           self.right[node[active]])
            node[active] = nxt
            active = self.left[node] >= 0
        return self.value[node]


# ---------------------------------------------------------------------------
# Gradient boosting (Algorithm 1)
# ---------------------------------------------------------------------------

@dataclass
class GBDT:
    n_estimators: int = 350     # M
    learning_rate: float = 0.1  # L
    max_depth: int = 11         # D
    min_samples_split: int = 30  # S
    min_samples_leaf: int = 2   # J
    subsample: float = 0.8      # Step 2: t ⊂ T (80% of the benchmark set)
    seed: int = 0
    _trees: list = field(default_factory=list)
    _f0: float = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDT":
        X = np.asarray(X, float)
        y = np.asarray(y, float)
        rng = np.random.default_rng(self.seed)
        self._f0 = float(y.mean())            # B_0(x)
        pred = np.full(len(y), self._f0)
        self._trees = []
        for _ in range(self.n_estimators):
            r = y - pred                      # r_mi (Eq. 3.1, squared loss)
            idx = (rng.random(len(y)) < self.subsample).nonzero()[0] \
                if self.subsample < 1.0 else np.arange(len(y))
            tree = RegressionTree(self.max_depth, self.min_samples_split,
                                  self.min_samples_leaf).fit(X[idx], r[idx])
            self._trees.append(tree)
            pred = pred + self.learning_rate * tree.predict(X)  # B_m(x)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, float)
        out = np.full(len(X), self._f0)
        for tree in self._trees:
            out += self.learning_rate * tree.predict(X)
        return out

    def staged_rmse(self, X: np.ndarray, y: np.ndarray) -> list[float]:
        """RMSE after each boosting stage (for the Fig. 3.4a tuning curves)."""
        X = np.asarray(X, float)
        out = np.full(len(X), self._f0)
        rmses = []
        for tree in self._trees:
            out += self.learning_rate * tree.predict(X)
            rmses.append(float(np.sqrt(np.mean((out - y) ** 2))))
        return rmses


# ---------------------------------------------------------------------------
# Baselines (Fig. 3.5)
# ---------------------------------------------------------------------------

class NaivePredictor:
    """Lookup table of mean saving per operation signature (B,S,R,codecs)."""

    SIG_COLS = slice(5, 11)  # featurize() layout: B,S,R,mpeg4,vp9,hevc

    def fit(self, X: np.ndarray, y: np.ndarray) -> "NaivePredictor":
        self.table: dict[tuple, float] = {}
        self.default = float(np.mean(y))
        sigs = np.asarray(X)[:, self.SIG_COLS]
        for sig in np.unique(sigs, axis=0):
            mask = (sigs == sig).all(axis=1)
            self.table[tuple(sig)] = float(np.mean(y[mask]))
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        sigs = np.asarray(X)[:, self.SIG_COLS]
        return np.array([self.table.get(tuple(s), self.default) for s in sigs])


def init_mlp_params(d: int, hidden: int, seed: int, device) -> dict:
    """The MLP's initial parameters, with the JAX package's shapes and init
    scales (normal draws over the square root of the fan-in, zero biases),
    drawn from a ``torch.Generator`` seeded with ``seed`` (the draws are
    torch's, not ``jax.random``'s)."""
    g = torch.Generator().manual_seed(seed)
    h = hidden

    def normal(shape, fan_in):
        return torch.randn(shape, generator=g) * (1.0 / np.sqrt(fan_in))
    params = {"w1": normal((d, h), d), "b1": torch.zeros(h),
              "w2": normal((h, h), h), "b2": torch.zeros(h),
              "w3": normal((h, 1), h), "b3": torch.zeros(1)}
    return {k: v.to(device=device, dtype=torch.float32)
            for k, v in params.items()}


def mlp_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    a = torch.tanh(x @ p["w1"] + p["b1"])
    a = torch.tanh(a @ p["w2"] + p["b2"])
    return (a @ p["w3"] + p["b3"])[:, 0]


def train_mlp(params: dict, x: torch.Tensor, t: torch.Tensor, steps: int,
              lr: float) -> dict:
    """Full-batch Adam from ``params`` for ``steps`` steps, the update of
    the JAX trainer written out: beta1 0.9, beta2 0.999, bias correction
    with ``i + 1`` in f32, eps 1e-8 outside the square root.  Gradients come
    from autograd; parameters and moments stay f32 on ``x``'s device."""
    p = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(w) for k, w in p.items()}
    b1, b2 = torch.tensor(0.9), torch.tensor(0.999)      # f32, as JAX's
    for i in range(steps):
        for w in p.values():
            w.requires_grad_(True)
        loss = torch.mean((mlp_forward(p, x) - t) ** 2)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        c1, c2 = float(1 - b1 ** (i + 1)), float(1 - b2 ** (i + 1))
        with torch.no_grad():
            for k, g in grads.items():
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                mh = m[k] / c1
                vh = v[k] / c2
                p[k] = p[k].detach() - lr * mh / (torch.sqrt(vh) + 1e-8)
    return {k: w.detach() for k, w in p.items()}


class MLPPredictor:
    """Small PyTorch MLP (2 hidden layers) trained with Adam on z-scored
    features — the [PKG+20]-style baseline.

    ``device`` is where it trains and predicts: None means CUDA (raising
    when no card is present); pass ``"cpu"`` to run on the host."""

    def __init__(self, hidden: int = 64, steps: int = 800, lr: float = 3e-3,
                 seed: int = 0, device=None):
        self.hidden, self.steps, self.lr, self.seed = hidden, steps, lr, seed
        self.device = resolve_device(device)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "MLPPredictor":
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        self.mu, self.sd = X.mean(0), X.std(0) + 1e-6
        Xn = (X - self.mu) / self.sd
        params = init_mlp_params(X.shape[1], self.hidden, self.seed,
                                 self.device)
        self._params = train_mlp(
            params, torch.from_numpy(Xn).to(self.device),
            torch.from_numpy(y).to(self.device), self.steps, self.lr)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        Xn = (np.asarray(X, np.float32) - self.mu) / self.sd
        with torch.no_grad():
            out = mlp_forward(self._params,
                              torch.from_numpy(Xn).to(self.device))
        return out.cpu().numpy()


def accuracy(pred: np.ndarray, truth: np.ndarray, tau: float = 0.12) -> float:
    """Eq. 3.2: percentage of predictions within tau of the observation."""
    return float(100.0 * np.mean(np.abs(pred - truth) <= tau))
