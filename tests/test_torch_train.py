"""The port's SimMIM pretraining slice against the JAX package, on the CPU:
losses and masking ops, the learning-rate schedule and the weight-decay
groups, three AdamW steps from the same params, batches and masks of
``configs/mim_tiny.ini``, of a ViT-L (``mimlarge``) model with the MLP stash
and of one with remat and the RA/Dec token, the trainer's validation masks,
its checkpoint round trip,
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

from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.models.mim import build_mim_model as jax_build_mim_model
from sky_embeddings_tpu.ops import losses as jlosses
from sky_embeddings_tpu.ops.masking import upsample_patch_mask as jax_upsample
from sky_embeddings_tpu.train.optim import decay_mask as jax_decay_mask
from sky_embeddings_tpu.train.optim import pretrain_optimizer as jax_pretrain_optimizer
from sky_embeddings_tpu.train.schedules import cosine_annealing as jax_cosine
from sky_embeddings_tpu_torch.configuration import Config, load_config
from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.ops import losses as tlosses
from sky_embeddings_tpu_torch.ops.masking import simmim_batch_mask, upsample_patch_mask
from sky_embeddings_tpu_torch.train.optim import decay_mask, pretrain_optimizer
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer
from sky_embeddings_tpu_torch.train.schedules import cosine_annealing
from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The CPU models here are tiny: one thread runs them fastest, and it
    keeps the test workers that share the cores from spinning OpenMP pools
    against each other (the CLI twins ran 20-60x slower under contention)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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

# The trainer paths of test_three_adamw_steps_match_jax: configs/mim_tiny.ini;
# configs/mim_tiny_large.ini (mimlarge: 16 heads, the MLP stash on); the
# same with [TRAINING] remat, [ARCHITECTURE] ra_dec and 5 bands
PATHS = {
    "mim_tiny": ("mim_tiny", {}),
    "mimlarge_stash_mlp": ("mim_tiny_large", {}),
    "remat_ra_dec": ("mim_tiny_large", {"TRAINING": {"remat": "True"},
                                        "ARCHITECTURE": {"ra_dec": "True", "num_channels": "5"}}),
}


def _config(path="mim_tiny"):
    """(JAX config, port config) of a trainer path, overrides applied."""
    name, over = PATHS[path]
    base = jax_load_config(name, CONFIGS)
    d = {sec: {**dict(base[sec].items()), **over.get(sec, {})} for sec in base.sections()}
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _jax_setup(seed=0, path="mim_tiny"):
    """The JAX model of a trainer path (fp32) and its params, every leaf
    perturbed so that biases, LN scales, the fill values and the tokens all
    matter."""
    cfg, _ = _config(path)
    model = jax_build_mim_model(cfg, dtype=jnp.float32,
                                remat=cfg.training.bool("remat", False))
    imgs = jnp.zeros((2, model.in_chans, 16, 16), jnp.float32)
    kw = {"ra_dec": jnp.zeros((2, 2), jnp.float32)} if model.ra_dec else {}
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), imgs, mask=jnp.zeros_like(imgs),
                                 **kw)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32), params)
    return cfg, model, params


def _port_trainer(params=None, seed=0, path="mim_tiny"):
    trainer = MIMPretrainer(_config(path)[1], dtype=torch.float32, seed=seed, device="cpu")
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


def _batches(n_steps, seed=7, channels=3):
    """``n_steps`` batches of 16 cutouts (whole-band NaNs) with their RA/Dec,
    and a pixel mask for each."""
    data = make_cutouts(16 * n_steps, channels=channels, img_size=16, seed=seed)
    assert np.isnan(data["cutouts"]).any()
    rng = np.random.default_rng(seed)
    masks = [(rng.random((16, channels, 4, 4)) < rng.uniform(0.2, 0.9)).astype(np.float32)
             for _ in range(n_steps)]
    masks = [np.asarray(jax_upsample(jnp.asarray(m), 4)) for m in masks]
    ra_dec = np.stack([data["ra"], data["dec"]], axis=1)
    return [{"cutouts": data["cutouts"][16 * i:16 * (i + 1)], "ra_dec": ra_dec[16 * i:16 * (i + 1)]}
            for i in range(n_steps)], masks


@pytest.mark.parametrize("path", list(PATHS))
def test_three_adamw_steps_match_jax(path, monkeypatch):
    """Three AdamW steps (fp32) from the same params, batches (with NaN
    bands, and their RA/Dec where the model reads it) and masks: JAX
    ``SkyMIM.apply`` + ``pretrain_optimizer`` + optax against
    ``MIMPretrainer.train_batch``, on mim_tiny (depth 12, D=48), a ViT-L
    model with the MLP stash, and a ViT-L model with remat, the RA/Dec token
    and 5 bands. The ViT-L models are cut to depth 2 in both frameworks
    (their 16 heads and D=64 kept), so that JAX compiles in seconds.

    Params bound 1e-4 absolute, a tenth of lr: each step moves a parameter
    by lr (1e-3) times Adam's normalised step m/(sqrt(v) + eps), which is
    about 1 wherever the gradient is well above eps. The two frameworks'
    gradients agree to ~1e-6 relative, so their steps agree closely except
    on leaves whose gradient is near eps; measured 6.5e-5 at most. A fault
    in the schedule, the betas, the decay groups or the step indexing moves
    some leaf by about lr or more."""
    for mod in (jax_mim, port_mim):
        monkeypatch.setitem(mod._SIZES["large"], "depth", 2)
    cfg, jmodel, params = _jax_setup(path=path)
    batches, masks = _batches(3, channels=jmodel.in_chans)
    tx = jax_pretrain_optimizer(params, jax_cosine(1e-3, cfg.training.int("total_batch_iters"), 1e7),
                                0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)

    @jax.jit
    def jstep(p, s, x, m, rd):
        kw = {"ra_dec": rd} if jmodel.ra_dec else {}
        loss, grads = jax.value_and_grad(
            lambda q: jmodel.apply({"params": q}, x, mask=m, **kw)[0])(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    trainer = _port_trainer(params, path=path)
    assert trainer.model.ra_dec == jmodel.ra_dec and trainer.model.encoder.remat == jmodel.remat
    assert trainer.model.encoder.depth == 2 or path == "mim_tiny"
    for batch, m in zip(batches, masks):
        m = np.array(m)  # writable, for torch.from_numpy
        jp, opt_state, jloss = jstep(jp, opt_state, jnp.maximum(jnp.asarray(batch["cutouts"]), -3.0),
                                     jnp.asarray(m), jnp.asarray(batch["ra_dec"]))
        loss = trainer.train_batch(batch, mask=torch.from_numpy(m))
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
    batches, _ = _batches(1)
    batch = batches[0]
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
    batches, _ = _batches(3, seed=9)
    for batch in batches[:2]:
        trainer.losses["train_loss"].append(float(trainer.train_batch(batch)))
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
    la = trainer.train_batch(batches[2])
    lb = other.train_batch(batches[2])
    assert float(la) == float(lb)


def test_serving_twin_restores_the_trainer_checkpoint(tmp_path):
    """Two steps of mim_tiny, saved; ``similarity_search.build_model_from_config``
    restores the same params (``_best`` first, then the latest)."""
    from sky_embeddings_tpu_torch import similarity_search as cli

    trainer = _port_trainer()
    batches, _ = _batches(2, seed=11)
    for batch in batches:
        trainer.train_batch(batch)
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
    on synthetic h5 files: 40 steps (the config's total), validation and the
    linear probes on mim_tiny's probe file every 20, a checkpoint at the end
    that a second run resumes as complete."""
    from sky_embeddings_tpu_torch import pretrain_mim
    from sky_embeddings_tpu_torch.data.synthetic import write_structured_h5, write_synthetic_h5

    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / "tiny_train.h5"), n=64, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(data / "tiny_val.h5"), n=32, channels=3, img_size=16, seed=2)
    write_structured_h5(str(data / "tiny_probe.h5"), 160, channels=3, img_size=16, seed=3)
    monkeypatch.setattr(pretrain_mim, "REPO_DIR", str(tmp_path))
    argv = ["mim_tiny", "-v", "20", "-ct", "100", "-dd", str(data), "--device", "cpu"]
    path = pretrain_mim.main(argv)
    out = capsys.readouterr().out
    assert "Batch Iterations: 40/40" in out and "val loss" in out
    assert "lp acc" in out and "lp r2" in out  # mim_tiny names probe files
    trainer = _port_trainer()
    assert trainer.restore(path) and trainer.cur_iter == 40
    assert len(trainer.losses["val_loss"]) == 2 and np.isfinite(trainer.losses["train_loss"]).all()
    assert len(trainer.losses["val_lp_acc"]) == len(trainer.losses["val_lp_r2"]) == 2
    pretrain_mim.main(argv)
    assert "already complete" in capsys.readouterr().out
