"""The port's I-JEPA slice against the JAX package, on the CPU: the block
mask sampler (its invariants and its distribution beside JAX's), the
context and target encoders, the predictor and the loss (``l2`` and
``smooth_l1``) on the same params and masks in fp32 and bf16, their
gradients against ``jax.grad``, three steps of ``JEPATrainer`` against
JAX's ``JEPATrainer`` from the same params, batches and mask draws (the
schedules and the EMA with them), the validation masks, the checkpoint round
trip, weights both ways (the EMA target tree too), ``extract_latents`` on a
``SkyJEPA`` and the ``pretrain_jepa`` CLI twin on ``jepa_tiny``.

The models are cut to depth 2 and D = 64 (two heads of 32; the predictor
96 wide, one head, as ``jepa_tiny``'s) in both frameworks: the JAX
trainer's ``_SIZES["tiny"]`` is patched for the test alone.

Bars: fp32 forwards and losses 1e-5 relative; bf16 max|a-b|/max|b| 2e-2
(the bf16 bar of the port's model tests); gradients
||a-b||/||b|| per leaf 1e-4; after three trainer steps the losses 1e-5
relative and every parameter, online and EMA target, 1e-4 absolute (a
tenth of one step's size, see ``tests/test_torch_train.py``), but for the
key third of each qkv bias, whose gradient is rounding noise (see
``test_three_steps_match_jax_trainer``).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.eval.eval_fns import extract_latents as jax_extract_latents
from sky_embeddings_tpu.models import jepa as jax_jepa
from sky_embeddings_tpu.ops.jepa_masks import sample_block_masks as jax_sample
from sky_embeddings_tpu.train import jepa as jax_train
from sky_embeddings_tpu_torch.configuration import Config, load_config
from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents
from sky_embeddings_tpu_torch.models import jepa as port_jepa
from sky_embeddings_tpu_torch.models.jepa import SkyJEPA, standardize
from sky_embeddings_tpu_torch.models.weights import params_from_jax, params_to_jax
from sky_embeddings_tpu_torch.ops.jepa_masks import BlockMasks, mask_budgets, sample_block_masks
from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
from sky_embeddings_tpu_torch.train.schedules import cosine_ramp, linear_ramp, warmup_cosine_decay
from sky_embeddings_tpu_torch.utils.checkpoint import checkpoint_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
SMALL = dict(embed_dim=64, depth=2, num_heads=2)
GEOM = dict(img_size=16, patch_size=4, in_chans=3, pred_embed_dim=96, pred_depth=2,
            pixel_mean=0.01, pixel_std=0.5, **SMALL)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny CPU models: one thread runs them fastest and keeps the test
    workers that share the cores from spinning OpenMP pools against each
    other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_sizes(monkeypatch):
    """``model_type = tiny`` at depth 2 and D = 64 in both frameworks."""
    for mod in (jax_jepa, port_jepa):
        monkeypatch.setitem(mod._SIZES, "tiny", dict(SMALL))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _config_dict(**training):
    """tests/test_jepa.py's config: jepa_tiny's geometry, batch 8, 10 steps."""
    t = dict(batch_size=8, ema="[0.9, 1.0]", total_batch_iters=10, weight_decay=0.04,
             final_weight_decay=0.4, start_lr=2e-4, ref_lr=1e-3, final_lr=1e-6)
    t.update(training)
    return {
        "DATA": {}, "TRAINING": t,
        "MASK": dict(allow_overlap=False, aspect_ratio="[0.75, 1.5]", enc_mask_scale="[0.85, 1.0]",
                     min_keep=5, num_enc_masks=1, num_pred_masks=4, pred_mask_scale="[0.15, 0.2]"),
        "ARCHITECTURE": dict(img_size=16, num_channels=3, pixel_mean=0.0, pixel_std=1.0,
                             patch_size=4, model_type="tiny", pred_depth=2, pred_emb_dim=96),
    }


def _torch_masks(m) -> BlockMasks:
    return BlockMasks(*(torch.from_numpy(np.asarray(a).astype(np.int64 if a.dtype != bool else bool))
                        for a in m))


def _images(n, seed=0):
    """Cutouts with whole-band NaNs and a few NaN pixels, clipped at -3 (the
    loaders' clip, which the port's trainer repeats on the device)."""
    x = make_cutouts(n, channels=3, img_size=16, seed=seed)["cutouts"]
    x[0, 1, 2:5, 3:9] = np.nan
    assert np.isnan(x).any()
    return np.maximum(x, -3.0)


# -- masks ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [8, 4])
def test_mask_sampling_invariants(grid):
    """As tests/test_jepa.py checks JAX's: shapes, indices in range, at least
    min_keep valid context tokens, no valid context token in a valid target
    block unless the sample fell back to its raw context rectangle; and the
    surplus slots point at the first member."""
    B, L = 64, grid * grid
    m = sample_block_masks(torch.Generator().manual_seed(grid), B, grid)
    k_ctx, k_tgt = mask_budgets(grid)
    assert m.ctx_idx.shape == (B, k_ctx) and m.tgt_idx.shape == (B, 4, k_tgt)
    assert m.ctx_idx.dtype == m.tgt_idx.dtype == torch.int64
    assert int(m.ctx_idx.min()) >= 0 and int(m.ctx_idx.max()) < L and int(m.tgt_idx.max()) < L
    assert (m.ctx_valid.sum(1) >= 5).all()
    assert (m.tgt_valid.sum((1, 2)) >= 4).all()
    for b in range(B):
        ctx = set(m.ctx_idx[b][m.ctx_valid[b]].tolist())
        tgt = set(m.tgt_idx[b][m.tgt_valid[b]].tolist())
        if ctx & tgt:  # only the min_keep fallback to the raw context rectangle overlaps
            assert len(ctx - tgt) < 5
        assert len(ctx) == int(m.ctx_valid[b].sum())  # valid slots are distinct
        n = int(m.ctx_valid[b].sum())
        assert (m.ctx_idx[b, n:] == m.ctx_idx[b, 0]).all() and m.ctx_valid[b, :n].all()
        for t in range(4):
            n = int(m.tgt_valid[b, t].sum())
            assert (m.tgt_idx[b, t, n:] == m.tgt_idx[b, t, 0]).all()
    sizes = m.tgt_valid.sum(2).reshape(-1)
    assert int(sizes.min()) >= 1 and int(sizes.max()) <= np.ceil(0.2 * L) + 4


@pytest.mark.parametrize("grid", [8, 4])
def test_mask_distribution_matches_jax(grid):
    """Over 4 096 draws, the mean valid context and target counts and the
    mean target-block size within 3% of JAX's, and every target block's
    valid-count histogram within 0.03 in each bin."""
    B = 4096
    jm = jax_sample(jax.random.PRNGKey(grid), B, grid)
    tm = sample_block_masks(torch.Generator().manual_seed(grid), B, grid)
    j_ctx, t_ctx = np.asarray(jm.ctx_valid).sum(1), tm.ctx_valid.sum(1).numpy()
    j_tgt, t_tgt = np.asarray(jm.tgt_valid).sum(2), tm.tgt_valid.sum(2).numpy()
    assert abs(t_ctx.mean() / j_ctx.mean() - 1) < 0.03, (t_ctx.mean(), j_ctx.mean())
    assert abs(t_tgt.mean() / j_tgt.mean() - 1) < 0.03, (t_tgt.mean(), j_tgt.mean())
    k = tm.tgt_idx.shape[-1]
    hj = np.bincount(j_tgt.reshape(-1), minlength=k + 1) / j_tgt.size
    ht = np.bincount(t_tgt.reshape(-1), minlength=k + 1) / t_tgt.size
    assert np.abs(hj - ht).max() < 0.03
    assert tm.tgt_idx.shape == np.asarray(jm.tgt_idx).shape
    assert tm.ctx_idx.shape == np.asarray(jm.ctx_idx).shape


def test_masks_draw_on_the_generators_device_and_repeat():
    a = sample_block_masks(torch.Generator().manual_seed(3), 8, 8)
    b = sample_block_masks(torch.Generator().manual_seed(3), 8, 8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.ctx_idx.device.type == "cpu"


# -- model -----------------------------------------------------------------------------

def _models(dtype=jnp.float32, loss_fn="l2", seed=0):
    """The JAX model and the port's at GEOM, JAX's params with every leaf
    perturbed (biases, LN scales, the fill values and the mask token all
    matter), loaded into the port's."""
    jdt = dtype
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    jm = jax_jepa.SkyJEPA(loss_fn=loss_fn, dtype=jdt, **GEOM)
    imgs = jnp.zeros((2, 3, 16, 16), jnp.float32)
    masks = jax_sample(jax.random.PRNGKey(0), 2, jm.grid_size)
    tgt = jnp.zeros((2, jm.grid_size ** 2, jm.embed_dim), jnp.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), imgs, masks, tgt)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    tm = SkyJEPA(loss_fn=loss_fn, dtype=tdt, **GEOM)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


@pytest.mark.parametrize("dtype,bar", [(jnp.float32, 1e-5), (jnp.bfloat16, 2e-2)])
def test_encoder_and_predictor_match_flax(dtype, bar):
    """The encoder over the full grid and over a context set (NaN pixels
    filled), and the predictor over that context, on the same params and
    masks."""
    jm, params, tm = _models(dtype)
    x = _images(6)
    masks = jax_sample(jax.random.PRNGKey(1), 6, jm.grid_size)
    tmasks = _torch_masks(masks)
    xt = torch.from_numpy(x)
    v = {"params": params}
    full_j = jm.apply(v, jnp.asarray(x), method=jax_jepa.SkyJEPA.encode)
    ctx_j = jm.apply(v, jnp.asarray(x), masks.ctx_idx, method=jax_jepa.SkyJEPA.encode)
    pred_j = jm.apply(v, ctx_j, masks.ctx_idx, masks.tgt_idx[:, 1], method=jax_jepa.SkyJEPA.predict)
    with torch.no_grad():
        full_t = tm.encode(xt)
        ctx_t = tm.encode(xt, tmasks.ctx_idx)
        pred_t = tm.predict(torch.from_numpy(np.array(ctx_j, np.float32)).to(tm.dtype),
                            tmasks.ctx_idx, tmasks.tgt_idx[:, 1])
    assert full_t.shape == (6, 16, 64) and ctx_t.shape == (6, 16, 64) and pred_t.shape == (6, 5, 64)
    assert full_t.dtype == tm.dtype
    for got, want in ((full_t, full_j), (ctx_t, ctx_j), (pred_t, pred_j)):
        assert torch.isfinite(got.float()).all()
        assert _rel(got.float().numpy(), want) < bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_standardize_matches_jax(dtype):
    x = np.random.default_rng(2).normal(1.5, 2.0, size=(4, 7, 64)).astype(np.float32)
    x[0, 0] = 3.0  # a constant row: the clipped variance
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jax.nn.standardize(jnp.asarray(x, jdt), axis=-1, epsilon=1e-6), np.float32)
    got = standardize(torch.from_numpy(x).to(dtype)).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(got, want) < 2e-2


@pytest.mark.parametrize("loss_fn", ["l2", "smooth_l1"])
@pytest.mark.parametrize("dtype,bar", [(jnp.float32, 1e-5), (jnp.bfloat16, 2e-2)])
def test_loss_matches_flax(loss_fn, dtype, bar):
    jm, params, tm = _models(dtype, loss_fn)
    x = _images(6, seed=3)
    masks = jax_sample(jax.random.PRNGKey(4), 6, jm.grid_size)
    tgt = np.random.default_rng(5).normal(size=(6, 16, 64)).astype(np.float32) * 2.0
    tgt_c = jnp.asarray(tgt).astype(dtype)  # the target encoder's dtype
    want = float(jm.apply({"params": params}, jnp.asarray(x), masks, tgt_c))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), _torch_masks(masks),
                 torch.from_numpy(np.array(tgt_c, np.float32)).to(tm.dtype))
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), want, rtol=bar)


def test_gradients_match_jax_grad():
    """Every leaf's gradient of the fp32 loss, the context gather's repeated
    slots summed, against ``jax.grad`` on the same params, masks and
    targets."""
    jm, params, tm = _models(jnp.float32, seed=6)
    x = _images(6, seed=7)
    masks = jax_sample(jax.random.PRNGKey(8), 6, jm.grid_size)
    assert not np.asarray(masks.ctx_valid).all()  # repeated slots to sum
    tgt = np.random.default_rng(9).normal(size=(6, 16, 64)).astype(np.float32)
    jgrads = jax.grad(lambda p: jm.apply({"params": p}, jnp.asarray(x), masks, jnp.asarray(tgt)))(
        jax.tree_util.tree_map(jnp.asarray, params))
    want = {k: np.asarray(v) for k, v in _flat(jgrads).items()}
    tm.zero_grad()
    tm(torch.from_numpy(x), _torch_masks(masks), torch.from_numpy(tgt)).backward()
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name in want:
        err = np.linalg.norm(got[name] - want[name]) / (np.linalg.norm(want[name]) + 1e-30)
        assert err < 1e-4, (name, err)
    assert np.abs(got["encoder.patch_mask_values"]).max() > 0  # the NaN fill learns


# -- trainer ---------------------------------------------------------------------------

def _jax_lr_wd_ema(jt, step):
    """JAX's schedules at ``step``: optax's lr, and the weight decay and EMA
    momentum as ``train/jepa.py`` computes them (:103-107, :196)."""
    t = jt.config.training
    T = jt.total_batch_iters
    frac = jnp.clip(jnp.int32(step) / T, 0.0, 1.0)
    wd0, wd1 = t.float("weight_decay"), t.float("final_weight_decay")
    wd = wd1 + (wd0 - wd1) * 0.5 * (1.0 + jnp.cos(jnp.pi * frac))
    m = jt.ema0 + (jt.ema1 - jt.ema0) * frac
    return float(jt.lr_schedule(step)), float(wd), float(m)


def _port_trainer(params=None, target=None, seed=0, **training):
    tr = JEPATrainer(Config.from_dict(_config_dict(**training), name="jepa_t"), seed=seed,
                     device="cpu")
    if params is not None:
        tr.model.load_state_dict(params_from_jax(params))
    if target is not None:
        tr.target.load_state_dict(params_from_jax(target))
    return tr


def test_schedules_match_optax_and_jax(small_sizes):
    jt = jax_train.JEPATrainer(JaxConfig.from_dict(_config_dict(total_batch_iters=40), name="jepa_t"))
    t = jt.config.training
    lr = warmup_cosine_decay(t.float("start_lr"), t.float("ref_lr"), 40, t.float("final_lr"))
    wd = cosine_ramp(t.float("weight_decay"), t.float("final_weight_decay"), 40)
    ema = linear_ramp(jt.ema0, jt.ema1, 40)
    for step in range(46):
        want = _jax_lr_wd_ema(jt, step)
        # JAX evaluates in fp32: about one fp32 ulp of ref_lr
        np.testing.assert_allclose((lr(step), wd(step), ema(step)), want, rtol=1e-6, atol=1e-10)
    assert abs(lr(0) - 2e-4) < 1e-15 and abs(lr(4) - 1e-3) < 1e-15  # warmup = 4 steps
    with pytest.raises(ValueError):
        warmup_cosine_decay(2e-4, 1e-3, 1, 1e-6)  # optax refuses an empty decay


def test_three_steps_match_jax_trainer(small_sizes):
    """Three steps of JAX's ``JEPATrainer`` and the port's from the same
    params, EMA targets and batches, the port given the masks that JAX's
    step draws (``train/jepa.py:172-179`` replayed): the losses, the lr and
    weight decay of every step, then every parameter and EMA target leaf."""
    jt = jax_train.JEPATrainer(JaxConfig.from_dict(_config_dict(), name="jepa_t"))
    params = jax.device_get(jt.state.params)
    tr = _port_trainer(params, jax.device_get(jt.state.target_params))
    assert tr.model.encoder.encoder.depth == 2 and tr.model.embed_dim == 64
    rng = jt.state.rng
    x = _images(24, seed=11)
    for step in range(3):
        batch = {"cutouts": x[8 * step:8 * (step + 1)], "ra_dec": np.zeros((8, 2), np.float32)}
        _, k_mask, rng = jax.random.split(rng, 3)  # the state's next rng is k_next
        masks = jax_sample(k_mask, 8, 4, **jt.mask_params)
        jloss = float(jt.train_batch(batch))
        loss = tr.train_batch(batch, masks=_torch_masks(masks))
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
        want_lr, want_wd, _ = _jax_lr_wd_ema(jt, step)
        for group in tr.optimizer.param_groups:  # decayed: the ndim > 1 leaves
            decays = all(p.dim() > 1 for p in group["params"])
            assert decays or all(p.dim() <= 1 for p in group["params"])
            np.testing.assert_allclose((group["lr"], group["weight_decay"]),
                                       (want_lr, want_wd if decays else 0.0), rtol=1e-6, atol=1e-10)
    assert tr.cur_iter == jt.cur_iter == 3
    # The key third of each qkv bias is the exception: softmax is invariant
    # to it (q · b_k shifts a row's logits alike), so its gradient is
    # rounding noise in both frameworks, and Adam's normalised step of that
    # noise is arbitrary up to about lr a step. It is held to the sum of the
    # three steps' lr, and its gradient shown to be that noise.
    kb = tr.model.predictor.blocks.block0.attn.qkv.bias.grad.reshape(3, -1)
    assert float(kb[1].norm()) < 1e-5 * float(kb[0].norm())
    lr_sum = sum(_jax_lr_wd_ema(jt, t)[0] for t in range(3))
    for got_sd, want_tree in ((tr.model.state_dict(), jt.state.params),
                              (tr.target.state_dict(), jt.state.target_params)):
        want = {k: np.asarray(v) for k, v in _flat(jax.device_get(want_tree)).items()}
        got = {k: v.numpy() for k, v in got_sd.items()}
        assert set(got) == set(want)
        for name in want:
            g, w = got[name], want[name]
            if name.endswith("attn.qkv.bias"):
                g, w = g.reshape(3, -1), w.reshape(3, -1)
                np.testing.assert_allclose(g[1], w[1], rtol=0, atol=lr_sum, err_msg=name)
                g, w = g[[0, 2]], w[[0, 2]]
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)
    start = _flat(params)
    moved = max(float(np.abs(tr.model.state_dict()[n].numpy() - np.asarray(start[n])).max())
                for n in start)
    assert moved > 1e-4  # the bound is below what the steps moved


def test_target_starts_as_the_online_encoder_and_moves_less(small_sizes):
    tr = _port_trainer()
    online0 = {k: v.clone() for k, v in tr.model.encoder.state_dict().items()}
    assert all(torch.equal(v, online0[k]) for k, v in tr.target.state_dict().items())
    assert not any(p.requires_grad for p in tr.target.parameters())
    x = _images(16, seed=12)
    for i in range(2):
        tr.train_batch({"cutouts": x[8 * i:8 * (i + 1)]})
    key = "encoder.block0.attn.qkv.kernel"
    d_target = (tr.target.state_dict()[key] - online0[key]).abs().mean()
    d_online = (tr.model.encoder.state_dict()[key] - online0[key]).abs().mean()
    assert 0 < d_target < d_online


def test_validation_masks_vary_across_batches_and_passes(small_sizes):
    tr = _port_trainer()
    drawn = []
    draw = tr.draw_masks
    tr.draw_masks = lambda b, g: drawn.append(draw(b, g)) or drawn[-1]
    batch = {"cutouts": _images(8, seed=13)}
    losses = [float(tr.eval_batch(batch, idx=i)) for i in (0, 1, 0)]
    assert np.isfinite(losses).all() and losses[0] == losses[2] != losses[1]
    tr.train_batch(batch)
    tr.eval_batch(batch, idx=0)
    val0, val1, val0_again, train0, val0_next = drawn
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    assert same(val0, val0_again) and not same(val0, val1) and not same(val0, val0_next)
    fresh = _port_trainer()  # validation draws leave the training stream alone
    assert same(fresh.draw_masks(8, fresh.mask_gen), train0)


def test_checkpoint_round_trip(tmp_path, small_sizes):
    """Two steps, saved; a fresh trainer restores params, EMA targets,
    optimizer state, the mask stream and the losses, and the next step of
    each is bit-equal."""
    tr = _port_trainer(seed=3)
    x = _images(24, seed=14)
    for i in range(2):
        tr.losses["train_loss"].append(float(tr.train_batch({"cutouts": x[8 * i:8 * (i + 1)]})))
    path = checkpoint_path(str(tmp_path), "jepa_t")
    tr.save(path)
    other = _port_trainer(seed=4)
    assert not other.restore(str(tmp_path / "absent.ckpt.pt"))
    assert other.restore(path)
    assert other.cur_iter == 2 and other.losses == tr.losses
    for a, b in ((tr.model, other.model), (tr.target, other.target)):
        assert all(torch.equal(u, v) for u, v in zip(a.state_dict().values(), b.state_dict().values()))
    batch = {"cutouts": x[16:]}
    assert float(tr.train_batch(batch)) == float(other.train_batch(batch))
    for a, b in ((tr.model, other.model), (tr.target, other.target)):
        assert all(torch.equal(u, v) for u, v in zip(a.state_dict().values(), b.state_dict().values()))


def test_weights_both_ways_with_the_target_tree(small_sizes):
    """The port's state dicts name JAX's trees leaf for leaf: the online
    params (``encoder/...``, ``predictor/...``) and the EMA target
    (``encoder`` subtree alone), from JAX and back."""
    jt = jax_train.JEPATrainer(JaxConfig.from_dict(_config_dict(), name="jepa_t"))
    params = jax.device_get(jt.state.params)
    target = jt.target_variables()["params"]["encoder"]
    tr = _port_trainer(params, target)
    want = {k: np.asarray(v) for k, v in _flat(params).items()}
    back = _flat(params_to_jax(tr.model.state_dict()))
    assert set(back) == set(want) and {"encoder.patch_mask_values", "predictor.mask_token",
                                       "predictor.blocks.block1.ffn.fc2_kernel"} <= set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    got_t = _flat(tr.target_variables()["params"]["encoder"])
    want_t = _flat(target)
    assert set(got_t) == set(want_t) == {k[len("encoder."):] for k in want if k.startswith("encoder.")}
    for k in want_t:
        np.testing.assert_array_equal(got_t[k], np.asarray(want_t[k]))
    assert not any("pos_embed" in k for k in tr.model.state_dict())  # a constant, as in JAX


def test_extract_latents_on_a_jepa_model():
    """``extract_latents`` runs a ``SkyJEPA``'s online encoder over the full
    grid, as JAX's ``_encode_fn`` does; no prefix token to strip."""
    jm, params, tm = _models(jnp.float32, seed=15)
    x = _images(10, seed=16)
    batches = [{"cutouts": x[:6], "ra_dec": np.zeros((6, 2), np.float32)},
               {"cutouts": x[6:], "ra_dec": np.zeros((4, 2), np.float32)}]
    want = np.asarray(jax_extract_latents(jm, {"params": params}, batches))
    got = extract_latents(tm, batches)
    assert got.shape == want.shape == (10, 16, 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_trainer_refuses_parallel_knobs():
    """``tensor_parallel = 2`` in one process: JAX's divisibility error (two
    model ranks need two processes; the ranks' runs are in
    ``test_torch_tp.py``)."""
    d = _config_dict()
    d["TRAINING"]["tensor_parallel"] = 2
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        JEPATrainer(Config.from_dict(d), device="cpu")


def test_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """``build_jepa_model``, ``JEPATrainer`` and the ``pretrain_jepa`` twin
    default to the card: without CUDA they raise, naming the CPU switch,
    before the twin writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from sky_embeddings_tpu_torch import pretrain_jepa
    from sky_embeddings_tpu_torch.models.jepa import build_jepa_model

    cfg = Config.from_dict(_config_dict(), name="jepa_t")
    monkeypatch.setattr(pretrain_jepa, "REPO_DIR", str(tmp_path))
    (tmp_path / "configs").symlink_to(os.path.join(REPO, "configs"))
    for call in (lambda: build_jepa_model(cfg), lambda: JEPATrainer(cfg),
                 lambda: pretrain_jepa.main(["jepa_tiny", "-dd", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert sorted(os.listdir(tmp_path)) == ["configs"]


def test_pretrain_jepa_twin_runs_and_resumes_on_cpu(tmp_path, monkeypatch, capsys, small_sizes):
    """``python -m sky_embeddings_tpu_torch.pretrain_jepa jepa_tiny --device
    cpu`` on synthetic h5 files (jepa_tiny as shipped but for the patched
    depth and width): resumed from a checkpoint saved at step 10, it runs to
    the config's 30 steps with a validation pass every 10, saves, and a
    second run finds the training complete."""
    from sky_embeddings_tpu_torch import pretrain_jepa
    from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5

    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / "tiny_train.h5"), n=64, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(data / "tiny_val.h5"), n=32, channels=3, img_size=16, seed=2)
    monkeypatch.setattr(pretrain_jepa, "REPO_DIR", str(tmp_path))
    cfg = load_config("jepa_tiny", CONFIGS)
    assert cfg.training.int("total_batch_iters") == 30 and "dtype" not in cfg.training
    early = JEPATrainer(cfg, device="cpu")
    x = _images(16, seed=17)
    for _ in range(10):
        early.train_batch({"cutouts": x})
    path = checkpoint_path(str(tmp_path / "models"), "jepa_tiny")
    early.save(path)
    argv = ["jepa_tiny", "-v", "10", "-ct", "100", "-dd", str(data), "--device", "cpu"]
    assert pretrain_jepa.main(argv) == path
    out = capsys.readouterr().out
    assert "at iteration 10" in out and "Batch Iterations: 30/30" in out and "val loss" in out
    done = JEPATrainer(cfg, device="cpu")
    assert done.restore(path) and done.cur_iter == 30
    assert len(done.losses["val_loss"]) == 2 and np.isfinite(done.losses["train_loss"]).all()
    assert done.model.dtype == torch.float32
    pretrain_jepa.main(argv)
    assert "already complete" in capsys.readouterr().out
