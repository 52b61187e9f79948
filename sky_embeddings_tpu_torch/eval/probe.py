"""Linear probes in torch on the features' device: closed-form ridge, FISTA
elastic net and L-BFGS multinomial logistic (port of
``sky_embeddings_tpu/eval/probe_jax.py``).

The pretraining loop fits these every ``verbose_iters`` on frozen embeddings
(reference ``utils/pretrain_fns.py:52-159``: ``LogisticRegression(C=0.01)``
accuracy and ``ElasticNet(alpha=1e-4, l1_ratio=0.9)`` R², 80/20 split), so
the features never leave the card and no sklearn is needed.

- Every product runs in fp32 with TF32 off (:func:`_fp32_products`), as JAX
  pins ``Precision.HIGHEST``: TF32's ~3 digits are coarser than the probes'
  tiny regularisers.
- The split replicates ``train_test_split(random_state=42)`` exactly
  (``RandomState(42).permutation``).
- Logistic: the objective of JAX's ``_logistic_loss`` (mean log-loss +
  ||w||²/(2·C·n), intercept unpenalised) under ``torch.optim.LBFGS`` with a
  strong-Wolfe line search and JAX's (optax's) memory of 10.
- Elastic net: sklearn's objective by FISTA, step from a 32-iteration power
  estimate of the Gram's top eigenvalue padded 2%, 1000 steps, as JAX.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _fp32_products():
    """Full fp32 matrix products on the card (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=device).float()


def split_indices(n: int, test_size: float = 0.2, seed: int = 42):
    """sklearn ``train_test_split`` index selection: a ``RandomState(seed)``
    permutation whose first ``ceil(n * test_size)`` entries are the test set."""
    n_test = int(np.ceil(n * test_size))
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def standardize(x) -> torch.Tensor:
    """Feature-wise zero mean, unit population std (sklearn ``StandardScaler``;
    zero-variance features left centred)."""
    x = _as_f32(x)
    mean = x.mean(dim=0, keepdim=True)
    std = x.std(dim=0, unbiased=False, keepdim=True)
    return (x - mean) / torch.where(std == 0.0, torch.ones_like(std), std)


def ridge_fit(x, y, alpha: float = 1e-4, l1_ratio: float = 0.9):
    """Closed-form ridge at the L2 strength of sklearn ``ElasticNet(alpha,
    l1_ratio)`` in least-squares form, ``alpha·(1−l1_ratio)·n``, intercept
    unpenalised; returns (w, b)."""
    x = _as_f32(x)
    y = _as_f32(y, x.device)
    with _fp32_products():
        x_mean, y_mean = x.mean(dim=0), y.mean()
        xc, yc = x - x_mean, y - y_mean
        gram = xc.T @ xc + alpha * (1.0 - l1_ratio) * x.shape[0] * torch.eye(
            x.shape[1], device=x.device)
        w = torch.cholesky_solve((xc.T @ yc)[:, None], torch.linalg.cholesky(gram))[:, 0]
        return w, y_mean - x_mean @ w


def _soft_threshold(v: torch.Tensor, t: float) -> torch.Tensor:
    return torch.sign(v) * torch.clamp(v.abs() - t, min=0.0)


def enet_fit(x, y, alpha: float = 1e-4, l1_ratio: float = 0.9, max_steps: int = 1000):
    """sklearn's ElasticNet objective ``(1/2n)·||y − Xw − b||² +
    alpha·l1_ratio·||w||₁ + 0.5·alpha·(1−l1_ratio)·||w||²`` (intercept
    unpenalised) by ``max_steps`` FISTA steps; returns (w, b)."""
    x = _as_f32(x)
    y = _as_f32(y, x.device)
    n = x.shape[0]
    with _fp32_products():
        x_mean, y_mean = x.mean(dim=0), y.mean()
        xc, yc = x - x_mean, y - y_mean
        gram = xc.T @ xc / n
        xty = xc.T @ yc / n
        l1, l2 = alpha * l1_ratio, alpha * (1.0 - l1_ratio)
        v = torch.full((gram.shape[0],), gram.shape[0] ** -0.5, device=x.device)
        for _ in range(32):
            v = gram @ v
            v = v / torch.linalg.vector_norm(v)
        step = 1.0 / (torch.dot(v, gram @ v) * 1.02 + l2)
        w = wz = torch.zeros_like(xty)
        t = torch.ones((), device=x.device)
        for _ in range(max_steps):
            grad = gram @ wz - xty + l2 * wz
            w_new = _soft_threshold(wz - step * grad, step * l1)
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            wz = w_new + ((t - 1.0) / t_new) * (w_new - w)
            w, t = w_new, t_new
        return w, y_mean - x_mean @ w


def r2_score(y_true, y_pred) -> torch.Tensor:
    y_true = _as_f32(y_true)
    y_pred = _as_f32(y_pred, y_true.device)
    ss_res = ((y_true - y_pred) ** 2).sum()
    ss_tot = ((y_true - y_true.mean()) ** 2).sum()
    return 1.0 - ss_res / ss_tot


def logistic_fit(x, y, n_classes: int, c: float = 0.01, max_steps: int = 100):
    """Multinomial logistic regression, sklearn's lbfgs objective scaled by
    1/(C·n): mean log-loss + ||w||²/(2·C·n), intercept unpenalised. Returns
    (w (F, K), b (K,))."""
    x = _as_f32(x)
    y = _as_f32(y, x.device).long()
    inv_cn = 1.0 / (c * x.shape[0])
    w = torch.zeros((x.shape[1], n_classes), device=x.device, requires_grad=True)
    b = torch.zeros((n_classes,), device=x.device, requires_grad=True)
    opt = torch.optim.LBFGS([w, b], max_iter=max_steps, history_size=10,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(x @ w + b, y) + 0.5 * inv_cn * (w * w).sum()
        loss.backward()
        return loss

    with _fp32_products(), torch.enable_grad():
        opt.step(closure)
    return w.detach(), b.detach()


def logistic_predict(params, x) -> torch.Tensor:
    w, b = params
    with _fp32_products():
        return torch.argmax(_as_f32(x, w.device) @ w + b, dim=-1)


def _split(x: torch.Tensor, seed: int):
    tr, te = split_indices(x.shape[0], seed=seed)
    return (torch.as_tensor(tr, device=x.device), torch.as_tensor(te, device=x.device))


def probe_classification(x, y, c: float = 0.01, seed: int = 42) -> dict[str, float]:
    """80/20 split and a logistic fit on standardised features: train and
    validation accuracy."""
    x = standardize(x)
    y = _as_f32(y, x.device).long()
    tr, te = _split(x, seed)
    params = logistic_fit(x[tr], y[tr], int(y.max()) + 1, c=c)
    acc = lambda idx: float((logistic_predict(params, x[idx]) == y[idx]).float().mean())
    return {"train_lp_acc": acc(tr), "val_lp_acc": acc(te)}


def probe_regression(x, y, alpha: float = 1e-4, l1_ratio: float = 0.9,
                     seed: int = 42) -> dict[str, float]:
    """80/20 split and an elastic net on standardised features: train and
    validation R²."""
    x = standardize(x)
    y = _as_f32(y, x.device)
    tr, te = _split(x, seed)
    w, b = enet_fit(x[tr], y[tr], alpha=alpha, l1_ratio=l1_ratio)
    with _fp32_products():
        r2 = lambda idx: float(r2_score(y[idx], x[idx] @ w + b))
        return {"train_lp_r2": r2(tr), "val_lp_r2": r2(te)}
