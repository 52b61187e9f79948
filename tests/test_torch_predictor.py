"""The port's predictor against the JAX package: ``SkyViT``'s forward for each
pool, with and without the RA/Dec token and ``zero_pos_embed`` (fp32 atol
1e-5, bf16 max-rel 2e-2); ``build_predictor_model``'s parameter names and
shapes for every predictor config in ``configs/`` (JAX's from
``jax.eval_shape``, the scan layout through ``adapt_block_layout``); 3 AdamW
steps of ``ft`` / ``lp`` / ``fs`` against JAX + optax (losses 1e-5 relative,
params 1e-4 absolute); the optimizer's groups; ``warm_start_from_mim``;
``select_training_indices``; ``predictor_infer`` in fp32 and bf16; the
``ft`` steps also over a narrow ``mimlarge`` backbone (depth 2, D = 64, 16
heads of 4, the MLP stash, fp32);
``photoz_prediction_metrics``; the ``train_predictor`` / ``test_predictor``
twins and the serving twin on a predictor config; the semantic-validation
twin at ``--quick``. Models are cut to depth 2, D = 48."""

import glob
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.models.predictor import SkyViT as JaxSkyViT
from sky_embeddings_tpu.models.predictor import build_predictor_model as jax_build_predictor
from sky_embeddings_tpu.train import optim as jax_optim
from sky_embeddings_tpu.train.predictor import make_predictor_step as jax_make_step
from sky_embeddings_tpu.train.predictor import warm_start_from_mim as jax_warm_start
from sky_embeddings_tpu.train.schedules import linear_lr as jax_linear_lr
from sky_embeddings_tpu.train.state import TrainState
from sky_embeddings_tpu.utils.misc import samples_per_class as jax_samples_per_class
from sky_embeddings_tpu.utils.plotting import photoz_prediction_metrics as jax_photoz
from sky_embeddings_tpu_torch.configuration import Config, apply_overrides, load_config
from sky_embeddings_tpu_torch.data.synthetic import make_structured_cutouts
from sky_embeddings_tpu_torch.eval.eval_fns import predictor_infer
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.predictor import SkyViT, build_predictor_model
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.train import optim
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer, warm_start_from_mim
from sky_embeddings_tpu_torch.train.schedules import linear_lr
from sky_embeddings_tpu_torch.utils import checkpoint as ckpt
from sky_embeddings_tpu_torch.utils.misc import samples_per_class, select_training_indices
from sky_embeddings_tpu_torch.utils.plotting import evaluate_z, photoz_prediction_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=48, depth=2, num_heads=4)
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These models and batches are tiny: one thread runs them fastest, and
    it keeps the test workers that share the cores from spinning OpenMP
    pools against each other (tenfold slower under contention)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _perturbed(params, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + scale * rng.normal(size=a.shape)).astype(np.float32), params)


def _ra_dec(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 360, n), rng.uniform(-90, 90, n)], axis=1).astype(np.float32)


def _images(n, seed, channels=3):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(n, channels, 16, 16)).astype(np.float32)
    imgs[0, 1] = np.nan  # whole-band NaNs
    imgs[-1, 0] = np.nan
    return imgs


# ---------------------------------------------------------------------------
# the model

def _random_params(jmodel, seed, **kw):
    """Random params in the JAX tree's shapes (``jax.eval_shape``): LN
    scales near 1, kernels at fan-in scale, the rest N(0, 0.05), so that
    every leaf matters."""
    x = jnp.zeros((2, jmodel.in_chans, jmodel.img_size, jmodel.img_size))
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, **kw))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        n = rng.normal(size=s.shape)
        if getattr(path[-1], "key", None) == "scale":
            n = 1.0 + 0.05 * n
        elif len(s.shape) == 2:
            n = n * s.shape[0] ** -0.5
        else:
            n = 0.05 * n
        return n.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["plain", "ra_dec_zero_pos"])
@pytest.mark.parametrize("pool", ["map", "avg", "token"])
def test_skyvit_forward_matches_jax(pool, variant, dtype):
    """Each pool in both dtypes, plain and with the RA/Dec token on a zero
    pos-embed (PARITY #3); the mask is accepted and ignored."""
    flags = variant != "plain"
    kw = dict(TINY, num_labels=3, global_pool=pool, ra_dec=flags, zero_pos_embed=flags,
              label_means=(0.5, 1.0, -1.0), label_stds=(2.0, 0.5, 1.0), pixel_mean=0.1,
              pixel_std=1.3)
    jmodel = JaxSkyViT(**kw, dtype=_JDT[dtype])
    params = _random_params(jmodel, 1, **({"ra_dec": jnp.zeros((2, 2))} if flags else {}))
    imgs, rd = _images(4, 2), _ra_dec(4, 3)
    rd_j = {"ra_dec": jnp.asarray(rd)} if flags else {}
    apply = jax.jit(lambda p, x, extra: jmodel.apply({"params": p}, x, **extra))
    want = np.asarray(apply(params, jnp.asarray(imgs), rd_j), np.float32)
    model = SkyViT(**kw, dtype=_TDT[dtype])
    model.load_state_dict(params_from_jax(params))  # strict: the JAX tree's names
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), mask=torch.ones(4, 3, 16, 16),
                    ra_dec=torch.from_numpy(rd) if flags else None)
    assert got.dtype == _TDT[dtype] and got.shape == want.shape == (4, 3)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 2e-2, f"max-rel {rel:.3g}"
    if flags:
        assert not model.pos_embed.any()


def test_labels_normalisation_and_head_init():
    model = SkyViT(**TINY, num_labels=2, label_means=(0.5, 2.0), label_stds=(2.0, 4.0))
    model.reset_parameters(torch.Generator().manual_seed(0))
    lab = torch.tensor([[1.5, 6.0]])
    assert torch.allclose(model.normalize_labels(lab), torch.tensor([[0.5, 1.0]]))
    assert torch.allclose(model.denormalize_labels(model.normalize_labels(lab)), lab)
    k = model.head.kernel
    # flax truncated_normal(2e-5): cut at 2 sigma of the unscaled normal
    k = k.detach()
    assert k.abs().max() <= 2 * 2e-5 / 0.87962566 + 1e-12 and float(k.std()) > 1e-5
    with pytest.raises(ValueError, match="ra_dec=None"):
        SkyViT(**TINY, ra_dec=True)(torch.zeros(1, 3, 16, 16))


def _predictor_configs():
    names = []
    for path in sorted(glob.glob(os.path.join(CONFIGS, "*.ini"))):
        cfg = jax_load_config(os.path.basename(path)[:-4], CONFIGS)
        if "TRAINING" in cfg and ("pretained_mae" in cfg.training
                                  or "pretrained_mae" in cfg.training):
            names.append(os.path.basename(path)[:-4])
    return names


PREDICTOR_CONFIGS = _predictor_configs()
_JAX_SHAPES: dict = {}


def _jax_shapes(jmodel):
    """The JAX model's params as zero-stride numpy views of their shapes
    (``jax.eval_shape``), cached by architecture."""
    key = tuple(getattr(jmodel, f) for f in (
        "img_size", "patch_size", "in_chans", "embed_dim", "depth", "num_heads", "num_labels",
        "global_pool", "ra_dec", "scan_blocks"))
    if key not in _JAX_SHAPES:
        x = jnp.zeros((1, jmodel.in_chans, jmodel.img_size, jmodel.img_size))
        kw = {"ra_dec": jnp.zeros((1, 2))} if jmodel.ra_dec else {}
        abstract = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, **kw))["params"]
        _JAX_SHAPES[key] = jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.float32(0), s.shape), abstract)
    return _JAX_SHAPES[key]


@pytest.mark.parametrize("name", PREDICTOR_CONFIGS + ["huge"])
def test_predictor_params_match_jax_for_every_config(name):
    """Names and shapes of ``build_predictor_model`` (on the meta device)
    against the JAX tree, after ``adapt_block_layout`` (at ``huge`` JAX
    builds the scan layout); a config whose pretraining config is absent is
    refused alike by both."""
    over = {}
    if name == "huge":  # z_struct_ft_512 on a ViT-H backbone: JAX's scan default
        name, over = "z_struct_ft_512", {"model_type": "mimhuge", "embed_dim": "1280"}
    jcfg, cfg = jax_load_config(name, CONFIGS), load_config(name, CONFIGS)
    mae_name = cfg.pretrained_mae_name()
    assert mae_name == jcfg.pretrained_mae_name()
    if mae_name is not None and not os.path.exists(os.path.join(CONFIGS, mae_name + ".ini")):
        for loader in (jax_load_config, load_config):
            with pytest.raises(FileNotFoundError):
                loader(mae_name, CONFIGS)
        return
    if mae_name is None:
        jmae, mae = jcfg, cfg
    else:
        jmae, mae = jax_load_config(mae_name, CONFIGS), load_config(mae_name, CONFIGS)
    if over:
        d = {s: {**dict(jmae[s].items()), **(over if s == "ARCHITECTURE" else {})}
             for s in jmae.sections()}
        jmae, mae = JaxConfig.from_dict(d), Config.from_dict(d)
    jmodel = jax_build_predictor(jcfg, jmae)
    model = build_predictor_model(cfg, mae, device="meta")
    assert jmodel.scan_blocks == bool(over)
    sd = model.state_dict()
    want = ckpt.flatten(ckpt.adapt_block_layout(_jax_shapes(jmodel), ckpt.nest(sd)))
    assert sorted(want) == sorted(sd)
    for k, v in sd.items():
        assert tuple(v.shape) == want[k].shape, k
    assert (model.num_labels, model.global_pool, model.ra_dec, model.depth) == (
        jmodel.num_labels, jmodel.global_pool, jmodel.ra_dec, jmodel.depth)
    if over:  # JAX's tree was stacked
        assert "blocks" in _jax_shapes(jmodel)["encoder"]


# ---------------------------------------------------------------------------
# the optimizers and three steps against JAX + optax

def _mim_cfg(d=None):
    arch = {**dict(img_size=16, num_channels=3, pixel_mean=0.05, pixel_std=1.2, embed_dim=48,
                   patch_size=4, model_type="simmim"), **(d or {})}
    return {"DATA": {}, "TRAINING": dict(batch_size=8, total_batch_iters=5, weight_decay=0.05,
                                         init_lr=1e-3, final_lr_factor=1e4, loss_fn="L1"),
            "ARCHITECTURE": arch}


def _pred_cfg(loss, method):
    data = dict(label_keys="['zspec']", label_means="[0.64]", label_stds="[0.5]")
    if loss == "errs":
        data = dict(label_keys="['zspec', 'zspec_err']", label_means="[0.64]", label_stds="[0.5]")
    if loss == "ce":
        data = dict(label_keys="['class']", num_classes=3, label_means="[0]", label_stds="[1]")
    training = dict(
        train_method=method, pretained_mae="mim_t", num_train=-1, batch_size=8,
        total_batch_iters=4, layer_decay=0.75, weight_decay=1e-3, init_lr=2e-3,
        final_lr_factor=10.0, augment=False, use_label_errs=loss == "errs",
        loss_fn="crossentropy" if loss == "ce" else "mse")
    return {"DATA": data, "TRAINING": training,
            "ARCHITECTURE": dict(img_size=16, global_pool="map", dropout=0.0)}


def _both(d):
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _batches(n_steps, seed=5, channels=3):
    data = make_structured_cutouts(8 * n_steps, channels=channels, img_size=16, seed=seed)
    rd = np.stack([data["ra"], data["dec"]], 1)
    out = []
    for i in range(n_steps):
        sl = slice(8 * i, 8 * (i + 1))
        out.append({"cutouts": data["cutouts"][sl], "ra_dec": rd[sl],
                    "labels": {"mse": data["zspec"][sl, None],
                               "errs": np.stack([data["zspec"][sl], 0.05 + data["zspec_err"][sl]], 1),
                               "ce": data["class"][sl, None].astype(np.int32)}})
    return out


def test_layer_ids_scales_and_masks_match_jax():
    jcfg, cfg = _both(_pred_cfg("mse", "ft"))
    jm, jmae = _both(_mim_cfg())
    jmodel = jax_build_predictor(jcfg, jm)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 3, 16, 16))))["params"]
    model = build_predictor_model(cfg, jmae, device="meta")
    named = list(model.named_parameters())
    jscale = _flat(jax_optim.layer_scale_tree(params, jmodel.depth, 0.75))
    assert optim.layer_scale_tree(named, model.depth, 0.75) == {k: float(v) for k, v in jscale.items()}
    jmask = _flat(jax_optim.decay_mask(params, no_decay_names=("cls_token", "pos_embed")))
    assert optim.decay_mask(named, ("cls_token", "pos_embed")) == {k: bool(v) for k, v in jmask.items()}
    for pool in ("map", "avg"):
        jt = _flat(jax_optim.trainable_mask(params, "lp", pool))
        assert optim.trainable_mask(named, "lp", pool) == {k: bool(v) for k, v in jt.items()}
    assert optim.vit_layer_id("encoder.block1.attn.qkv.kernel", 12) == 2
    assert optim.vit_layer_id("cls_token", 12) == 0 and optim.vit_layer_id("head.bias", 12) == 13
    for t in range(7):  # the schedule, at optax's step indexing
        assert linear_lr(2e-3, 5, 10.0)(t) == pytest.approx(float(jax_linear_lr(2e-3, 5, 10.0)(t)),
                                                            rel=1e-6)


def _key_bias(name: str, shape):
    """The key slice of an attention's fused bias, or None."""
    if name.endswith("attn.qkv.bias"):
        d = shape[0] // 3
        return slice(d, 2 * d)
    if name.endswith("xattn.kv.bias"):
        return slice(0, shape[0] // 2)
    return None


# the shipped fp32 configs the card's fp32 path runs (chip_smoke.py), as
# shipped but cut to depth 2 and 16 x 16 cutouts: (config, its label, the
# overrides of the predictor config, and of its pretraining config when it
# names one: mim_1's ViT-B at D = 48)
SHIPPED = {
    "cls_fs_1k": ("ce", ["ARCHITECTURE.img_size=16", "ARCHITECTURE.patch_size=4",
                         "ARCHITECTURE.embed_dim=48", "TRAINING.batch_size=8",
                         "TRAINING.augment=False"], None),
    "lp_1": ("mse", ["ARCHITECTURE.img_size=16", "TRAINING.batch_size=8", "TRAINING.augment=False"],
             ["ARCHITECTURE.img_size=16", "ARCHITECTURE.patch_size=4", "ARCHITECTURE.embed_dim=48"]),
}
STEP_CASES = [("ft", "mse"), ("ft", "errs"), ("lp", "ce"), ("lp", "errs"), ("fs", "ce"),
              ("fs", "mse"), ("fs", "cls_fs_1k"), ("lp", "lp_1"), ("ft", "mimlarge")]
# a narrow mimlarge backbone (cls_ft_*_large's and z_ft_2's model type), cut
# to depth 2 at D = 64 in 16 heads of 4: the predictor trains it with the
# MLP stash (kernels 6 and 7 on the card), in fp32
MIMLARGE = {"model_type": "mimlarge", "embed_dim": 64}


def _shipped(name, overrides):
    """A shipped config with ``overrides``, in both frameworks."""
    cfg = apply_overrides(load_config(name, CONFIGS), overrides, name)
    return _both({sec: dict(cfg[sec].items()) for sec in cfg.sections()})


@pytest.mark.parametrize("method,loss", STEP_CASES)
def test_three_adamw_steps_match_jax(method, loss, monkeypatch):
    """Three steps (fp32, no augmentation) from the same params and batches:
    JAX ``make_predictor_step`` with optax's ``finetune_optimizer`` (layer
    decay 0.75, the PARITY #1 quirk: base lr = weight_decay 1e-3, decay
    0.05), ``linear_probe_optimizer`` (the backbone stop-gradient'ed) or
    ``supervised_optimizer`` against ``PredictorTrainer.train_batch``; mse,
    mse weighted by the label errors, cross-entropy; and two shipped fp32
    configs (``cls_fs_1k``: ``fs``, 9 bands, the RA/Dec token, 3-class
    cross-entropy; ``lp_1``: ``lp`` over ``mim_1``'s backbone, mse) with
    their own optimizer settings, cut to depth 2 and D = 48; and ``ft``, mse,
    over a ``mimlarge`` backbone at depth 2, D = 64, 16 heads of 4, with
    the MLP stash. Params bound 1e-4 absolute, a fraction of one step. Under
    ``lp`` the backbone stays bit-unchanged and gets no ``.grad``."""
    for mod in (jax_mim, port_mim):
        monkeypatch.setitem(mod._SIZES["base"], "depth", 2)
        monkeypatch.setitem(mod._SIZES["large"], "depth", 2)
    if loss == "mimlarge":
        label = "mse"
        jcfg, cfg = _both(_pred_cfg(label, method))
        jmae, mae = _both(_mim_cfg(MIMLARGE))
    elif loss in SHIPPED:
        label, over, mae_over = SHIPPED[loss]
        jcfg, cfg = _shipped(loss, over)
        mae_name = cfg.pretrained_mae_name()
        jmae, mae = (jcfg, cfg) if mae_name is None else _shipped(mae_name, mae_over)
        assert cfg.training.str("train_method") == method and "dtype" not in cfg.training
    else:
        label = loss
        jcfg, cfg = _both(_pred_cfg(loss, method))
        jmae, mae = _both(_mim_cfg())
    chans = mae.architecture.int("num_channels")
    tr = cfg.training
    total, lr0, wd = tr.int("total_batch_iters"), tr.float("init_lr"), tr.float("weight_decay", 0.0)
    jmodel = jax_build_predictor(jcfg, jmae)
    init = lambda key, x, rd: jmodel.init(key, x, ra_dec=rd)
    params = jax.jit(init)(jax.random.PRNGKey(0), jnp.zeros((2, chans, 16, 16)),
                           jnp.zeros((2, 2)) if jmodel.ra_dec else None)["params"]
    params = _perturbed(params, 3, 0.02)
    sched = lambda lr: jax_linear_lr(lr, total, tr.float("final_lr_factor"))
    if method == "ft":
        tx = jax_optim.finetune_optimizer(params, sched, jmodel.depth, tr.float("layer_decay"),
                                          lr0, wd)
    elif method == "lp":
        tx = jax_optim.linear_probe_optimizer(params, sched(lr0), wd, "map")
    else:
        tx = jax_optim.supervised_optimizer(params, sched(lr0), wd)
    trainable = jax_optim.trainable_mask(params, "lp", "map") if method == "lp" else None
    jstep = jax.jit(jax_make_step(jmodel, tx, jcfg.training.str("loss_fn"), label == "errs",
                                  False, {}, True, trainable=trainable, pixel_min=-3.0))
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params), tx,
                              jax.random.PRNGKey(1))
    trainer = PredictorTrainer(cfg, mae, dtype=torch.float32, device="cpu")
    if loss in SHIPPED:
        assert trainer.model.ra_dec == (loss == "cls_fs_1k") and trainer.model.in_chans == chans
    if loss == "mimlarge":
        enc = trainer.model.encoder
        assert enc.depth == 2 and enc.block0.num_heads == 16 and trainer.model.embed_dim == 64
        assert enc.block0.ffn.stash and not enc.remat
    trainer.model.load_state_dict(params_from_jax(params))
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for batch in _batches(3, channels=chans):
        b = {**batch, "labels": batch["labels"][label]}
        state, jloss, jmetric = jstep(state, jnp.asarray(b["cutouts"]), jnp.asarray(b["ra_dec"]),
                                      jnp.asarray(b["labels"]))
        tloss, tmetric = trainer.train_batch(b)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(tmetric), float(jmetric), rtol=1e-5, atol=1e-7)
    assert trainer.cur_iter == 3
    want = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    got = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    assert set(got) == set(want)
    for name in want:
        a, b = got[name].copy(), want[name].copy()
        key_bias = _key_bias(name, a.shape)
        if key_bias is not None:
            # the key bias's true gradient is 0 (a softmax is blind to it),
            # so both frameworks step it by Adam's ratio of rounding noise:
            # held within three steps' size, the rest at 1e-4
            np.testing.assert_allclose(a[key_bias], b[key_bias], rtol=0, atol=3 * lr0,
                                       err_msg=name)
            a[key_bias] = b[key_bias] = 0
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
    moved = max(float(np.abs(got[n] - start[n].numpy()).max()) for n in want)
    assert moved > 5e-4  # the bound is below one step's size
    if method == "lp":
        head = optim.trainable_mask(trainer.model.named_parameters(), "lp", "map")
        for n, p in trainer.model.named_parameters():
            if not head[n]:
                assert torch.equal(p.detach(), start[n]) and p.grad is None, n
        assert {n for g in trainer.optimizer.param_groups for n in g["names"]} == {
            n for n, t in head.items() if t}


def test_finetune_groups_and_the_parity_quirk():
    _, cfg = _both(_pred_cfg("mse", "ft"))
    _, mae = _both(_mim_cfg())
    model = build_predictor_model(cfg, mae, device="cpu")
    opt, base = optim.finetune_optimizer(model, 12, 0.75, 5e-4, 1e-3)
    assert base == 1e-3  # the config's weight_decay feeds the lr ...
    assert {g["weight_decay"] for g in opt.param_groups} == {0.0, optim.FT_DEFAULT_WEIGHT_DECAY}
    opt, base = optim.finetune_optimizer(model, 12, 0.75, 5e-4, 1e-3, compat_ft_lr=False)
    assert base == 5e-4 and {g["weight_decay"] for g in opt.param_groups} == {0.0, 1e-3}
    scales = {n: g["lr_scale"] for g in opt.param_groups for n in g["names"]}
    assert scales["cls_token"] == 0.75 ** 13 and scales["head.kernel"] == 1.0
    assert scales["encoder.block11.attn.qkv.kernel"] == 0.75
    optim.set_lr(opt, 1.0)
    assert all(g["lr"] == g["lr_scale"] for g in opt.param_groups)


# ---------------------------------------------------------------------------
# warm start, subsets, inference, metrics

def test_warm_start_lists_match_jax():
    dst = {"patch_embed": {"proj": {"kernel": np.zeros((48, 8)), "bias": np.zeros(8)}},
           "head": {"kernel": np.full((8, 3), 7.0), "bias": np.zeros(3)},
           "encoder": {"block0": {"w": np.zeros((2, 2))}, "block1": {"w": np.zeros((3, 2))}},
           "extra": np.zeros(4)}
    src = {"patch_embed": {"proj": {"kernel": np.ones((48, 8)), "bias": np.ones(8)}},
           "head": {"kernel": np.full((8, 3), -1.0)},
           "encoder": {"block0": {"w": np.ones((2, 2))}, "block1": {"w": np.ones((2, 2))}},
           "decoder": {"kernel": np.ones((2, 2))}}
    logs, jlogs = [], []
    merged, copied, fresh = warm_start_from_mim(dst, src, log_fn=logs.append)
    jmerged = jax_warm_start(jax.tree_util.tree_map(jnp.asarray, dst),
                             jax.tree_util.tree_map(jnp.asarray, src), log_fn=jlogs.append)
    assert logs == jlogs == ["Warm start: copied 3 tensors, kept fresh 3."]
    assert copied == ["patch_embed/proj/kernel", "patch_embed/proj/bias", "encoder/block0/w"]
    assert fresh == ["head", "encoder/block1/w", "extra"]
    for k, v in _flat(jmerged).items():
        np.testing.assert_array_equal(np.asarray(_flat(merged)[k]), v)


def test_warm_start_from_a_mim_checkpoint(tmp_path, monkeypatch):
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    for mod in (jax_mim, port_mim):
        monkeypatch.setitem(mod._SIZES["base"], "depth", 2)
    _, mim = _both(_mim_cfg())
    pre = MIMPretrainer(mim, seed=3, device="cpu")
    path = str(tmp_path / "mim_t.ckpt.pt")
    pre.save(path)
    trainer = PredictorTrainer(Config.from_dict(_pred_cfg("mse", "ft")), mim, seed=7, device="cpu")
    head = trainer.model.head.kernel.detach().clone()
    logs = []
    assert not trainer.warm_start(str(tmp_path / "absent.ckpt.pt"))
    assert trainer.warm_start(path, log_fn=logs.append)
    sd, mim_sd = trainer.model.state_dict(), pre.model.state_dict()
    shared = [k for k in sd if k in mim_sd]
    # every shared tensor copied; the pool (2 heads) and head kept fresh
    assert len(shared) == 2 * 12 + 6 and logs == [
        f"Warm start: copied {len(shared)} tensors, kept fresh 14."]
    for k in shared:
        assert torch.equal(sd[k], mim_sd[k]), k
    assert torch.equal(trainer.model.head.kernel, head)


def test_select_training_indices_matches_jax(tmp_path):
    from sky_embeddings_tpu.utils.misc import select_training_indices as jax_select
    from sky_embeddings_tpu_torch.data.synthetic import write_structured_h5

    path = write_structured_h5(str(tmp_path / "s.h5"), 90, channels=3, img_size=16,
                               class_fracs=(0.5, 0.3, 0.2), seed=4)
    counts = {0: 45, 1: 27, 2: 18}
    for balanced in (False, True):
        assert samples_per_class(counts, 40, balanced) == jax_samples_per_class(counts, 40, balanced)
        want = jax_select(path, 40, balanced)
        assert select_training_indices(path, 40, balanced) == want
        classes = make_structured_cutouts(90, 3, 16, seed=4, class_fracs=(0.5, 0.3, 0.2))["class"]
        assert select_training_indices(classes, 40, balanced) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_infer_matches_jax(dtype):
    """Denormalised outputs, in the head's dtype as JAX computes them, and
    the label errors dropped from the targets."""
    from sky_embeddings_tpu.eval.eval_fns import predictor_infer as jax_infer

    kw = dict(TINY, num_labels=1, label_means=(0.825,), label_stds=(0.448,))
    jmodel = JaxSkyViT(**kw, dtype=_JDT[dtype])
    params = _random_params(jmodel, 5)
    model = SkyViT(**kw, dtype=_TDT[dtype])
    model.load_state_dict(params_from_jax(params))
    batches = [{"cutouts": _images(6, s), "ra_dec": _ra_dec(6, s),
                "labels": np.random.default_rng(s).random((6, 2)).astype(np.float32)}
               for s in (1, 2)]
    jt, jp = jax_infer(jmodel, {"params": params}, batches, use_label_errs=True)
    t, p = predictor_infer(model.eval(), batches, use_label_errs=True)
    np.testing.assert_array_equal(t, jt)
    assert p.shape == jp.shape == (12, 1)
    if dtype == "float32":
        np.testing.assert_allclose(p, np.asarray(jp, np.float32), atol=1e-5)
    else:  # the outputs land on bf16's grid, as JAX's do
        assert np.array_equal(p, np.asarray(torch.from_numpy(p).bfloat16().float()))
        assert np.abs(p - np.asarray(jp, np.float32)).max() / np.abs(np.asarray(jp, np.float32)).max() <= 2e-2
    t2, p2, imgs = predictor_infer(model, batches, n_batches=1, return_images=True)
    assert t2.shape == (6, 2) and imgs.shape == (6, 3, 16, 16)


def test_photoz_metrics_match_jax():
    from sky_embeddings_tpu.utils.plotting import evaluate_z as jax_evaluate_z

    rng = np.random.default_rng(0)
    z = rng.uniform(0.05, 1.6, 500)
    zp = z + rng.normal(0, 0.05, 500) * (1 + z)
    zp[:20] += 0.5  # outliers
    assert photoz_prediction_metrics(zp, z, 0.15) == jax_photoz(zp, z, 0.15)
    got = evaluate_z(zp, z, n_bins=8, z_range=(0.2, 1.6), threshold=0.1)
    try:
        want = jax_evaluate_z(zp, z, n_bins=8, z_range=(0.2, 1.6), threshold=0.1)
    except Exception:  # pragma: no cover - hosts without matplotlib
        want = None
    if want is not None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert np.isfinite(got[2]).all() and len(got[0]) == 8


# ---------------------------------------------------------------------------
# the CLI twins

@pytest.fixture
def predictor_repo(tmp_path, monkeypatch):
    """A repo root with the configs, z_tiny's h5 files (tiny_train/tiny_val,
    3 bands, 16 x 16, zspec labels) and mim_tiny's checkpoint at depth 2."""
    from sky_embeddings_tpu_torch.data.synthetic import write_structured_h5
    from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

    monkeypatch.setitem(port_mim._SIZES["base"], "depth", 2)
    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    write_structured_h5(str(data / "tiny_train.h5"), 48, channels=3, img_size=16, seed=1)
    write_structured_h5(str(data / "tiny_val.h5"), 32, channels=3, img_size=16, seed=2)
    pre = MIMPretrainer(load_config("mim_tiny", CONFIGS), seed=1, device="cpu")
    pre.save(str(tmp_path / "models" / "mim_tiny.ckpt.pt"))
    return tmp_path, pre


def test_train_and_test_predictor_twins_on_cpu(predictor_repo, monkeypatch, capsys):
    """``train_predictor z_tiny --device cpu``: warm-started from mim_tiny,
    device-cached sets, 30 steps (the config's total), validation every 10,
    the best sidecar; a second run resumes; ``test_predictor`` prints and
    writes the metrics and draws JAX's figures; the serving twin builds the
    trained predictor."""
    from sky_embeddings_tpu_torch import similarity_search, test_predictor, train_predictor

    root, pre = predictor_repo
    for mod in (train_predictor, test_predictor, similarity_search):
        monkeypatch.setattr(mod, "REPO_DIR", str(root))
    argv = ["z_tiny", "-v", "10", "-ct", "100", "-dd", str(root / "data"), "--device", "cpu"]
    path = train_predictor.main(argv)
    out = capsys.readouterr().out
    assert "Warm-started from pretrained MIM checkpoint" in out
    assert "Device-caching tiny_train.h5" in out and "Batch Iterations: 30/30" in out
    assert os.path.exists(path.replace(".ckpt.pt", "_best.ckpt.pt"))
    payload = ckpt.load_checkpoint(path)
    assert payload["step"] == 30 and len(payload["losses"]["val_loss"]) == 3
    train_predictor.main(argv)
    assert "Resumed from" in capsys.readouterr().out

    metrics = test_predictor.main(["z_tiny", "-dd", str(root / "data"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "MAD=" in out
    # JAX's figures, drawn where matplotlib is installed, as this host has it
    assert sorted(os.listdir(root / "figures")) == [
        f"z_tiny_{f}.png" for f in ("progress", "redshift", "redshift_hexbin",
                                   "redshift_metrics", "redshift_snr")]
    with open(root / "results" / "z_tiny_test_metrics.json") as f:
        assert json.load(f) == json.loads(json.dumps(metrics))
    assert np.isfinite(metrics["mad"]) and len(metrics["bins"]["mad"]) == 8

    model, config = similarity_search.build_model_from_config(
        str(root / "configs"), str(root / "models"), "z_tiny", "cpu")
    assert isinstance(model, SkyViT) and config.pretrained_mae_name() == "mim_tiny"
    best = ckpt.load_checkpoint(path.replace(".ckpt.pt", "_best.ckpt.pt"))["params"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k


def test_serving_twin_searches_with_a_predictor(predictor_repo, monkeypatch):
    """``similarity_search z_tiny --device cpu`` end to end: the predictor's
    tokens (``SkyViT.encode``) embed targets and test set, both search modes."""
    from sky_embeddings_tpu_torch import similarity_search

    root, _ = predictor_repo
    monkeypatch.setattr(similarity_search, "REPO_DIR", str(root))
    data = str(root / "data")
    for extra in ([], ["-bank", "zbank.h5"]):
        out = similarity_search.main(["z_tiny", "-dd", data, "-tgt_fn", "tiny_val.h5",
                                      "-tst_fn", "tiny_train.h5", "-tgt_i", "[0,1]",
                                      "-snr", "[-100,100]", "-ns", "5", "-bs", "16",
                                      "--device", "cpu", *extra])
        res = np.load(out)
        assert res["test_scores"].shape == (5,) and np.isfinite(res["test_scores"]).all()
        assert res["target_features"].shape[1:] == (16 + 1, 48)


def test_semantic_validation_quick(tmp_path, monkeypatch):
    """``semantic_validation --quick --device cpu`` at its tiny shape (the
    encoder cut to depth 2): every stage runs and the JSON is written, with
    no gate."""
    from sky_embeddings_tpu_torch import semantic_validation as sv

    monkeypatch.setitem(port_mim._SIZES["base"], "depth", 2)
    (tmp_path / "configs").symlink_to(CONFIGS)
    monkeypatch.setattr(sv, "REPO_DIR", str(tmp_path))
    res = sv.main(["--quick", "-v", "10", "--device", "cpu"])
    with open(tmp_path / "results" / "semantic_validation_torch_quick.json") as f:
        assert json.load(f) == json.loads(json.dumps(res))
    assert res["gates_failed"] == [] and len(res["pretrain"]["val_lp_acc"]) == 2
    assert set(res["finetune"]) == {"ft", "fs"}
    assert all(np.isfinite(res["finetune"][k]["mad"]) for k in ("ft", "fs"))
    assert set(res["simsearch"]["chance"]) == {"qso", "galaxy", "star"}
    assert set(res["seconds"]) == {"survey", "pretrain", "finetune_ft", "finetune_fs", "simsearch"}
