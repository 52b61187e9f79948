"""The port's SimMIM pretraining slice against the JAX package, on the CPU:
losses and masking ops, the learning-rate schedule and the weight-decay
groups, three AdamW steps of ``configs/mim_tiny.ini`` from the same params,
batch and masks, the trainer's validation masks, its checkpoint round trip,
the serving CLI twin restoring what the trainer saved, and the pretraining
CLI twin on synthetic h5 files.

Bars: the ops exact up to fp32 rounding (rtol 1e-6, atol 1e-7 for sums that
cancel to near zero in another order); the whole-slice losses
1e-5 relative and the params an absolute 1e-4 after three steps at
lr 1e-3 (see ``test_three_adamw_steps_match_jax``).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.models.mim import build_mim_model as jax_build_mim_model
from sky_embeddings_tpu.ops import losses as jlosses
from sky_embeddings_tpu.ops.masking import upsample_patch_mask as jax_upsample
from sky_embeddings_tpu.train.optim import decay_mask as jax_decay_mask
from sky_embeddings_tpu.train.optim import pretrain_optimizer as jax_pretrain_optimizer
from sky_embeddings_tpu.train.schedules import cosine_annealing as jax_cosine
from sky_embeddings_tpu_torch.configuration import load_config
from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.ops import losses as tlosses
from sky_embeddings_tpu_torch.ops.masking import simmim_batch_mask, upsample_patch_mask
from sky_embeddings_tpu_torch.train.optim import decay_mask, pretrain_optimizer
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer
from sky_embeddings_tpu_torch.train.schedules import cosine_annealing
from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")


def _flat(tree, prefix=""):
    """Nested dict -> {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nan_patches(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    x[0, 1, ::3] = np.nan
    x[2, 4] = np.nan  # an all-NaN patch
    return x


# -- ops --------------------------------------------------------------------------

def test_patch_stats_and_normalization_match_jax():
    x = _nan_patches()
    jm, jv = jlosses.patch_mean_and_var(jnp.asarray(x))
    tm, tv = tlosses.patch_mean_and_var(torch.from_numpy(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7, equal_nan=True)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-7, equal_nan=True)
    want = np.asarray(jlosses.normalize_patches(jnp.asarray(x)))
    got = tlosses.normalize_patches(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, equal_nan=True)
    assert np.isnan(got[2, 4]).all()


@pytest.mark.parametrize("loss_fn", ["l1", "mse"])
@pytest.mark.parametrize("mask_dims", ["full", "one_fewer"])
def test_masked_recon_loss_matches_jax(loss_fn, mask_dims):
    rng = np.random.default_rng(1)
    target = _nan_patches(2)
    pred = rng.normal(size=target.shape).astype(np.float32)
    shape = target.shape if mask_dims == "full" else target.shape[:-1]
    mask = (rng.random(shape) < 0.6).astype(np.float32)
    want = float(jlosses.masked_recon_loss(jnp.asarray(target), jnp.asarray(pred),
                                           jnp.asarray(mask), loss_fn))
    p = torch.from_numpy(pred).requires_grad_()
    got = tlosses.masked_recon_loss(torch.from_numpy(target), p, torch.from_numpy(mask), loss_fn)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    got.backward()  # NaN targets give zero gradient, not NaN
    assert torch.isfinite(p.grad).all() and (p.grad[torch.isnan(torch.from_numpy(target))] == 0).all()


def test_upsample_patch_mask_matches_jax():
    m = (np.random.default_rng(3).random((2, 3, 4, 4)) < 0.5).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(m), 4))
    got = upsample_patch_mask(torch.from_numpy(m), 4)
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_simmim_batch_mask_counts_and_ratios():
    """Each sample masks ceil(ratio * G^2) patches in every channel, with
    ratio = U(0, 1) * max_mask_ratio drawn first from the generator, and the
    pixel mask is constant over each patch."""
    B, C, img, p, max_ratio = 16, 3, 32, 4, 0.9
    G2 = (img // p) ** 2
    mask = simmim_batch_mask(torch.Generator().manual_seed(5), B, C, img, p, max_ratio)
    assert mask.shape == (B, C, img, img) and mask.dtype == torch.float32
    assert set(mask.unique().tolist()) <= {0.0, 1.0}
    patches = mask[:, :, ::p, ::p]
    torch.testing.assert_close(upsample_patch_mask(patches, p), mask, rtol=0, atol=0)
    ratio = torch.rand(B, generator=torch.Generator().manual_seed(5)) * max_ratio
    counts = patches.reshape(B, C, G2).sum(-1)
    want = torch.ceil(G2 * ratio)[:, None].expand(B, C)
    torch.testing.assert_close(counts, want, rtol=0, atol=0)
    assert float(ratio.max()) <= max_ratio and float(counts.max()) <= np.ceil(G2 * max_ratio)


def test_cosine_annealing_matches_optax():
    T = 20
    ours = cosine_annealing(1e-3, T, 1e7)
    ref = jax_cosine(1e-3, T, 1e7)
    for t in range(T + 6):
        # optax evaluates in fp32: 1 + cos cancels near t = T, so the bar is
        # about one fp32 ulp of init_lr
        np.testing.assert_allclose(ours(t), float(ref(t)), rtol=1e-6, atol=1e-10)
    assert ours(0) == 1e-3


# -- optimizer and whole slice ------------------------------------------------

def _jax_setup(seed=0):
    """The JAX mim_tiny model (fp32) and its params, every leaf perturbed so
    that biases, LN scales, the fill values and the tokens all matter."""
    cfg = jax_load_config("mim_tiny", CONFIGS)
    model = jax_build_mim_model(cfg, dtype=jnp.float32)
    imgs = jnp.zeros((2, 3, 16, 16), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), imgs, mask=jnp.zeros_like(imgs))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32), params)
    return cfg, model, params


def _port_trainer(params=None, seed=0):
    trainer = MIMPretrainer(load_config("mim_tiny", CONFIGS), dtype=torch.float32, seed=seed,
                            device="cpu")
    if params is not None:
        trainer.model.load_state_dict(params_from_jax(params))
    return trainer


def test_decay_mask_matches_jax():
    _, _, params = _jax_setup()
    want = _flat(jax.tree_util.tree_map(bool, jax_decay_mask(params)))
    got = decay_mask(_port_trainer().model.named_parameters())
    assert got == want
    assert got["cls_token"] and got["mask_token"] and got["patch_mask_values"]
    assert not got["encoder.block0.norm1.scale"]


def test_pretrain_optimizer_groups():
    model = _port_trainer().model
    opt = pretrain_optimizer(model, 1e-3, 0.05)
    mask = decay_mask(model.named_parameters())
    decayed, plain = opt.param_groups
    assert (decayed["weight_decay"], plain["weight_decay"]) == (0.05, 0.0)
    assert decayed["betas"] == (0.9, 0.95) and decayed["eps"] == 1e-8
    names = {id(p): n for n, p in model.named_parameters()}
    assert {names[id(p)] for p in decayed["params"]} == {n for n, d in mask.items() if d}
    assert len(decayed["params"]) + len(plain["params"]) == len(mask)


def _batches(n_steps, seed=7):
    data = make_cutouts(16 * n_steps, channels=3, img_size=16, seed=seed)  # whole-band NaNs
    assert np.isnan(data["cutouts"]).any()
    rng = np.random.default_rng(seed)
    masks = [(rng.random((16, 3, 4, 4)) < rng.uniform(0.2, 0.9)).astype(np.float32)
             for _ in range(n_steps)]
    masks = [np.asarray(jax_upsample(jnp.asarray(m), 4)) for m in masks]
    return [data["cutouts"][16 * i:16 * (i + 1)] for i in range(n_steps)], masks


def test_three_adamw_steps_match_jax():
    """Three AdamW steps of mim_tiny (depth 12, D=48, fp32) from the same
    params, batches (with NaN bands) and masks: JAX ``SkyMIM.apply`` +
    ``pretrain_optimizer`` + optax against ``MIMPretrainer.train_batch``.

    Params bound 1e-4 absolute, a tenth of lr: each step moves a parameter
    by lr (1e-3) times Adam's normalised step m/(sqrt(v) + eps), which is
    about 1 wherever the gradient is well above eps. The two frameworks'
    gradients agree to ~1e-6 relative, so their steps agree closely except
    on leaves whose gradient is near eps; measured 6.5e-5 at most. A fault
    in the schedule, the betas, the decay groups or the step indexing moves
    some leaf by about lr or more."""
    cfg, jmodel, params = _jax_setup()
    imgs, masks = _batches(3)
    tx = jax_pretrain_optimizer(params, jax_cosine(1e-3, 40, 1e7), 0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)

    @jax.jit
    def jstep(p, s, x, m):
        loss, grads = jax.value_and_grad(lambda q: jmodel.apply({"params": q}, x, mask=m)[0])(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    trainer = _port_trainer(params)
    for x, m in zip(imgs, masks):
        m = np.array(m)  # writable, for torch.from_numpy
        jp, opt_state, jloss = jstep(jp, opt_state, jnp.maximum(jnp.asarray(x), -3.0), jnp.asarray(m))
        loss = trainer.train_batch({"cutouts": x}, mask=torch.from_numpy(m))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert trainer.cur_iter == 3
    want = _flat(jax.tree_util.tree_map(np.asarray, jp))
    got = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-4, err_msg=name)
    start = _flat(params)
    moved = max(float(np.abs(got[n] - start[n]).max()) for n in want)
    assert moved > 1e-3  # the bound is below one step's size


def test_validation_masks_vary_across_batches_and_passes():
    trainer = _port_trainer()
    drawn = []
    draw = trainer.draw_mask
    trainer.draw_mask = lambda b, g: drawn.append(draw(b, g)) or drawn[-1]
    imgs, _ = _batches(1)
    batch = {"cutouts": imgs[0]}
    for idx in (0, 1, 0):
        assert np.isfinite(float(trainer.eval_batch(batch, idx=idx)))
    trainer.train_batch(batch)
    trainer.eval_batch(batch, idx=0)
    val0, val1, val0_again, _, val0_next = drawn
    assert torch.equal(val0, val0_again)  # same batch index, same pass
    assert not torch.equal(val0, val1)  # another batch
    assert not torch.equal(val0, val0_next)  # the next pass
    # validation draws leave the training stream alone
    fresh = _port_trainer()
    assert torch.equal(fresh.draw_mask(16, fresh.mask_gen), drawn[3])


def test_checkpoint_round_trip(tmp_path):
    trainer = _port_trainer(seed=3)
    imgs, _ = _batches(3, seed=9)
    for x in imgs[:2]:
        trainer.losses["train_loss"].append(float(trainer.train_batch({"cutouts": x})))
    path = checkpoint_path(str(tmp_path), "mim_tiny")
    assert path.endswith("mim_tiny.ckpt.pt")
    trainer.save(path)
    other = _port_trainer(seed=4)
    assert not other.restore(str(tmp_path / "absent.ckpt.pt"))
    assert other.restore(path)
    assert other.cur_iter == 2 and other.losses == trainer.losses
    for (n, a), b in zip(trainer.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = trainer.optimizer.state_dict(), other.optimizer.state_dict()
    for k in sa["state"]:
        for key in sa["state"][k]:
            assert torch.equal(sa["state"][k][key], sb["state"][k][key]), (k, key)
    # the restored run continues exactly: same mask stream, same update
    la = trainer.train_batch({"cutouts": imgs[2]})
    lb = other.train_batch({"cutouts": imgs[2]})
    assert float(la) == float(lb)


def test_serving_twin_restores_the_trainer_checkpoint(tmp_path):
    """Two steps of mim_tiny, saved; ``similarity_search.build_model_from_config``
    restores the same params (``_best`` first, then the latest)."""
    from sky_embeddings_tpu_torch import similarity_search as cli

    trainer = _port_trainer()
    imgs, _ = _batches(2, seed=11)
    for x in imgs:
        trainer.train_batch({"cutouts": x})
    model_dir = str(tmp_path)
    trainer.save(checkpoint_path(model_dir, "mim_tiny"))
    model, _ = cli.build_model_from_config(CONFIGS, model_dir, "mim_tiny", "cpu")
    for (n, a), b in zip(trainer.model.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), n
    fresh = _port_trainer(seed=1)
    fresh.save(checkpoint_path(model_dir, "mim_tiny", best=True))
    model, _ = cli.build_model_from_config(CONFIGS, model_dir, "mim_tiny", "cpu")
    assert torch.equal(model.cls_token, fresh.model.cls_token)


def test_pretrain_cli_twin_runs_on_cpu(tmp_path, monkeypatch, capsys):
    """``python -m sky_embeddings_tpu_torch.pretrain_mim mim_tiny --device cpu``
    on synthetic h5 files: 40 steps (the config's total), validation every
    20, a checkpoint at the end that a second run resumes as complete."""
    from sky_embeddings_tpu_torch import pretrain_mim
    from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5

    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / "tiny_train.h5"), n=64, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(data / "tiny_val.h5"), n=32, channels=3, img_size=16, seed=2)
    monkeypatch.setattr(pretrain_mim, "REPO_DIR", str(tmp_path))
    argv = ["mim_tiny", "-v", "20", "-ct", "100", "-dd", str(data), "--device", "cpu"]
    path = pretrain_mim.main(argv)
    out = capsys.readouterr().out
    assert "Batch Iterations: 40/40" in out and "val loss" in out
    assert "Linear probes" in out  # mim_tiny names probe files: skipped, said once
    trainer = _port_trainer()
    assert trainer.restore(path) and trainer.cur_iter == 40
    assert len(trainer.losses["val_loss"]) == 2 and np.isfinite(trainer.losses["train_loss"]).all()
    pretrain_mim.main(argv)
    assert "already complete" in capsys.readouterr().out
