"""Training-time linear probes over frozen embeddings (port of
``sky_embeddings_tpu/eval/linear_probe.py``, reference
``utils/pretrain_fns.py:52-159``).

The pretraining loop periodically fits a classifier (star/QSO/galaxy) and a
regressor (spec-z) on fixed probe sets to track embedding quality: 80/20
split, logistic accuracy and elastic-net R², features pooled by one of the
modes token / flatten / pool / centralpool / central / mean and
standardised.

- ``backend="torch"`` (default): the features stay on the model's device and
  the fits run there (``eval/probe.py``).
- ``backend="sklearn"``: the reference-exact host path, the parity oracle
  that the JAX package keeps too; sklearn is imported only here.

Probe sets come as an h5 path (read with h5py where the host has it) or as
an iterable of labelled batches (``cutouts`` and ``labels``; the card host
has no h5py), which must be re-iterable when the trainer probes more than
once (a list, not a generator).
"""

from __future__ import annotations

import numpy as np

from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents, host_array
from sky_embeddings_tpu_torch.utils.misc import select_centre


def pool_features(latents, combine: str = "central"):
    """(B, L, D) token features -> (B, F) probe features (reference
    ``get_embeddings`` pooling, ``pretrain_fns.py:136-153``); numpy arrays
    and torch tensors alike."""
    B = latents.shape[0]
    if combine == "token":
        return latents[:, :1].reshape(B, -1)
    if combine == "flatten":
        return latents.reshape(B, -1)
    if combine == "pool":
        return latents.max(axis=1) if isinstance(latents, np.ndarray) else latents.amax(dim=1)
    if combine == "centralpool":
        c = select_centre(latents, 16)
        return c.max(axis=1) if isinstance(c, np.ndarray) else c.amax(dim=1)
    if combine == "central":
        return select_centre(latents, 4).reshape(B, -1)
    if combine == "mean":
        return latents.mean(1)
    raise ValueError(f"unknown combine mode {combine!r}")


def probe_features(
    model,
    data,
    y_label: str,
    combine: str = "central",
    batch_size: int = 64,
    img_size: int = 64,
    to_host: bool = True,
):
    """Embed a probe set and pool its features; returns (X, y).

    ``data``: an h5 file path, or an iterable of dict batches whose
    ``labels`` hold ``y_label``'s values. Pooling runs per batch, so the
    full (N, L, D) token set is never held. With ``to_host=False`` the pooled
    features stay on the model's device and standardisation is left to the
    fit; otherwise they are standardised on the host (``StandardScaler``
    semantics) as numpy.
    """
    remove_prefix = combine != "token"
    if getattr(model, "pooled", False):
        combine = "flatten"  # the single pooled token (ref pretrain_fns.py:131-133)
    pool = lambda tokens: pool_features(tokens, combine)
    if isinstance(data, str):
        import h5py

        from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher

        batcher = build_h5_batcher(data, batch_size=batch_size, img_size=img_size,
                                   shuffle=False, drop_remainder=False)
        x = extract_latents(model, batcher, remove_prefix=remove_prefix, to_host=to_host,
                            batch_transform=pool)
        with h5py.File(data, "r") as f:
            y = np.asarray(f[y_label][: x.shape[0]])
    else:
        ys = []

        def collect(batches):
            for b in batches:
                ys.append(host_array(b["labels"]).reshape(len(b["cutouts"]), -1)[:, 0])
                yield b

        x = extract_latents(model, collect(data), remove_prefix=remove_prefix, to_host=to_host,
                            batch_transform=pool)
        y = np.concatenate(ys)[: x.shape[0]]
        if y_label == "class":
            y = y.astype(np.int64)
    if to_host:
        from sky_embeddings_tpu_torch.eval.probe import standardize

        x = standardize(x).numpy()
    return x, y


def _linear_probe_sklearn(x_cls, y_cls, x_reg, y_reg) -> dict[str, float]:
    from sklearn.linear_model import ElasticNet, LogisticRegression
    from sklearn.metrics import accuracy_score, r2_score
    from sklearn.model_selection import train_test_split

    metrics: dict[str, float] = {}
    if x_cls is not None:
        xtr, xte, ytr, yte = train_test_split(x_cls, y_cls, test_size=0.2, random_state=42)
        clf = LogisticRegression(max_iter=10000, C=0.01, random_state=42)
        clf.fit(xtr, ytr)
        metrics["train_lp_acc"] = float(accuracy_score(ytr, clf.predict(xtr)))
        metrics["val_lp_acc"] = float(accuracy_score(yte, clf.predict(xte)))
    if x_reg is not None:
        xtr, xte, ytr, yte = train_test_split(x_reg, y_reg, test_size=0.2, random_state=42)
        reg = ElasticNet(alpha=1e-4, l1_ratio=0.9, max_iter=10000, random_state=42)
        reg.fit(xtr, ytr)
        metrics["train_lp_r2"] = float(r2_score(ytr, reg.predict(xtr)))
        metrics["val_lp_r2"] = float(r2_score(yte, reg.predict(xte)))
    return metrics


def linear_probe(
    model,
    class_data=None,
    regress_data=None,
    combine: str = "central",
    img_size: int = 64,
    backend: str = "torch",
) -> dict[str, float]:
    """Fit the probes; returns {train_lp_acc, val_lp_acc, train_lp_r2,
    val_lp_r2} (those of the sets given). An attention-pooled model's
    features are its one pooled token, whatever ``combine`` says."""
    kw = dict(combine=combine, img_size=img_size)
    if backend == "torch":
        from sky_embeddings_tpu_torch.eval.probe import probe_classification, probe_regression

        metrics: dict[str, float] = {}
        if class_data:
            metrics.update(probe_classification(*probe_features(
                model, class_data, "class", to_host=False, **kw)))
        if regress_data:
            metrics.update(probe_regression(*probe_features(
                model, regress_data, "zspec", to_host=False, **kw)))
        return metrics
    if backend != "sklearn":
        raise ValueError(f"unknown probe backend {backend!r}")
    x_cls = y_cls = x_reg = y_reg = None
    if class_data:
        x_cls, y_cls = probe_features(model, class_data, "class", **kw)
    if regress_data:
        x_reg, y_reg = probe_features(model, regress_data, "zspec", **kw)
    return _linear_probe_sklearn(x_cls, y_cls, x_reg, y_reg)
