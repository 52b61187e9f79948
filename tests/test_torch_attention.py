"""The port's attention kernels 12 and 13 and the attention modules against
the JAX package, on the CPU: ``attention_plain`` against the Pallas
``fused_attention`` run with ``interpret=True`` and against ``xla_attention``;
``attention_bwd_plain`` against ``_fused_attention_bwd_call`` in interpret
mode and against ``jax.vjp`` of ``fused_attention_ad``; ``AttentionFn``'s
gradient against autograd of the plain version; ``Attention``,
``CrossAttention``, ``Mlp`` and ``AttentionPoolLatent`` against the flax
modules with weights carried by ``models/weights.py``; and SimMIM with
``attn_pool`` (``mim_tiny`` with ``ARCHITECTURE.attn_pool = True``, cut to
depth 2): forward, ``decode`` and loss, three AdamW steps against JAX +
optax, and its weights round-tripped both ways.

Bars: fp32 atol 2e-5 for the kernels (tests/test_kernels.py), 1e-5 for the
modules; bf16 max|a-b|/max|b| <= 2e-2 for outputs (TOL_FWD of
tools/kernel_parity.py) and 3e-2 for each gradient (TOL_BWD); training
losses 1e-5 relative, params 1e-4 absolute after three steps
(tests/test_torch_train.py).
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
from sky_embeddings_tpu.models import layers as jl
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.models.mim import build_mim_model as jax_build_mim_model
from sky_embeddings_tpu.ops.kernels import attention as ja
from sky_embeddings_tpu.train.optim import pretrain_optimizer as jax_pretrain_optimizer
from sky_embeddings_tpu.train.schedules import cosine_annealing as jax_cosine
from sky_embeddings_tpu_torch.configuration import Config
from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
from sky_embeddings_tpu_torch.models import layers as tl
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.weights import params_from_jax, params_to_jax
from sky_embeddings_tpu_torch.ops.kernels import attention as ta
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TOL_F32 = 2e-5
TOL_FWD = 2e-2
TOL_BWD = 3e-2
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
H = 3
SHAPES = [(B, N, hd) for B in (4, 3) for N in (17, 65) for hd in (16, 32)]


def _close(got, want, dtype, bar):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL_F32)
    else:
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
        assert rel <= bar, f"max-rel {rel:.3g} > {bar}"


def _inputs(B, N, hd, dtype, seed=0):
    """qkv (B, N, 3D) and dctx (B, N, D), D = 3 heads of ``hd``, cast to
    ``dtype`` on each side."""
    rng = np.random.default_rng(seed + 7 * N + hd)
    qkv = rng.normal(size=(B, N, 3 * H * hd)).astype(np.float32)
    dctx = rng.normal(size=(B, N, H * hd)).astype(np.float32)
    j = [jnp.asarray(a).astype(_JDT[dtype]) for a in (qkv, dctx)]
    t = [torch.from_numpy(a).to(_TDT[dtype]) for a in (qkv, dctx)]
    return j, t


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,hd", SHAPES)
def test_attention_plain_matches_jax(B, N, hd, dtype, oracle):
    (jq, _), (tq, _) = _inputs(B, N, hd, dtype)
    if oracle == "xla":
        want = ja.xla_attention(jq, H)
    else:
        want = ja.fused_attention(jq, H, block_b=B, interpret=True)
    got = ta.attention_plain(tq, H)
    assert got.dtype == _TDT[dtype] and got.shape == (B, N, H * hd)
    _close(got.float().numpy(), _np(want), dtype, TOL_FWD)
    # the wrapper and the dispatcher take the plain version on CPU tensors
    assert torch.equal(ta.fused_attention(tq, H), got)
    assert torch.equal(ta.attention_context(tq, H), got)


@pytest.mark.parametrize("oracle", ["pallas_interpret", "vjp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,hd", SHAPES)
def test_attention_bwd_plain_matches_jax(B, N, hd, dtype, oracle):
    (jq, jd), (tq, td) = _inputs(B, N, hd, dtype, seed=1)
    if oracle == "vjp":
        _, vjp = jax.vjp(lambda q: ja.fused_attention_ad(q, H, B, True), jq)
        want = vjp(jd)[0]
    else:
        want = ja._fused_attention_bwd_call(jq, jd, H, block_b=B, interpret=True)
    got = ta.attention_bwd_plain(tq, td, H)
    assert got.dtype == _TDT[dtype] and got.shape == tq.shape
    _close(got.float().numpy(), _np(want), dtype, TOL_BWD)
    assert torch.equal(ta.fused_attention_bwd(tq, td, H), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,hd", [(4, 17, 16), (3, 65, 32)])
def test_attention_fn_gradient_matches_autograd_of_plain(B, N, hd, dtype):
    """``AttentionFn`` (kernel 13's plain version in the backward) against
    autograd through ``attention_plain`` in fp32; nothing launches on CPU."""
    _, (tq, td) = _inputs(B, N, hd, dtype, seed=2)
    launches = (ta.fused_attention.launches, ta.fused_attention_bwd.launches)
    x = tq.clone().requires_grad_()
    out = ta.attention_context(x, H)
    out.backward(td)
    ref = tq.float().clone().requires_grad_()
    ta.attention_plain(ref, H).backward(td.float())
    assert x.grad.dtype == _TDT[dtype]
    _close(x.grad.float().numpy(), ref.grad.numpy(), dtype, TOL_BWD)
    assert (ta.fused_attention.launches, ta.fused_attention_bwd.launches) == launches


# -- the modules --------------------------------------------------------------------

def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)


MODULES = {
    # name: (flax module, port module, input shapes)
    "attention": (lambda dt: jl.Attention(4, dtype=dt), lambda dt: tl.Attention(64, 4, dt),
                  [(3, 17, 64)]),
    "cross_attention": (lambda dt: jl.CrossAttention(4, dtype=dt),
                        lambda dt: tl.CrossAttention(64, 4, dt), [(3, 2, 64), (3, 17, 64)]),
    "mlp": (lambda dt: jl.Mlp(96, 48, dtype=dt), lambda dt: tl.Mlp(64, 96, 48, dt), [(3, 17, 64)]),
    "attention_pool": (lambda dt: jl.AttentionPoolLatent(4, 4.0, dtype=dt),
                       lambda dt: tl.AttentionPoolLatent(64, 4, 4.0, dt), [(3, 17, 64)]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODULES))
def test_attention_modules_match_flax(name, dtype):
    """Each module from the same (perturbed) flax params, loaded strictly
    into the port's module: outputs at 1e-5 in fp32, 2e-2 max-rel in bf16;
    the state dict maps back onto the flax tree exactly."""
    make_j, make_t, shapes = MODULES[name]
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jmod = make_j(_JDT[dtype])
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, xs))["params"], 4)
    want = _np(jmod.apply({"params": params}, *[jnp.asarray(x).astype(_JDT[dtype]) for x in xs]))
    tmod = make_t(_TDT[dtype])
    tmod.load_state_dict(params_from_jax(params))  # strict: the same leaves
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(x).to(_TDT[dtype]) for x in xs])
    assert got.dtype == _TDT[dtype] and got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    else:
        _close(got.float().numpy(), want, dtype, TOL_FWD)
    back = dict(jax.tree_util.tree_flatten_with_path(params_to_jax(tmod.state_dict()))[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(back[path], leaf)


def test_attention_module_gradients_match_flax():
    """``Attention``'s parameter and input gradients through ``AttentionFn``
    (kernel 13's plain version) against ``jax.grad`` of the flax module, fp32."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 17, 64)).astype(np.float32)
    g = rng.normal(size=(3, 17, 64)).astype(np.float32)
    jmod = jl.Attention(4)
    params = _perturbed(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 6)
    jgrads, jdx = jax.grad(lambda p, xx: (jmod.apply({"params": p}, xx) * g).sum(),
                           argnums=(0, 1))(params, jnp.asarray(x))
    tmod = tl.Attention(64, 4)
    tmod.load_state_dict(params_from_jax(params))
    xt = torch.from_numpy(x).requires_grad_()
    (tmod(xt) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), atol=1e-5)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for n, p in tmod.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=1e-5, err_msg=n)


def test_attention_pool_latent_init():
    """The latent draws from N(0, D^-0.5), as flax's ``normal(stddev=D^-0.5)``."""
    pool = tl.AttentionPoolLatent(256, 4)
    pool.reset_parameters(torch.Generator().manual_seed(0))
    std = float(pool.latent.detach().std())
    assert pool.latent.shape == (1, 1, 256) and 0.8 * 256 ** -0.5 < std < 1.2 * 256 ** -0.5


# -- SimMIM with attn_pool ------------------------------------------------------------

def _configs(over=None):
    base = jax_load_config("mim_tiny", CONFIGS)
    d = {sec: dict(base[sec].items()) for sec in base.sections()}
    d["ARCHITECTURE"]["attn_pool"] = "True"
    for sec, kv in (over or {}).items():
        d[sec].update(kv)
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _jax_pooled(monkeypatch, seed=0):
    """mim_tiny with attn_pool cut to depth 2 in both frameworks: the JAX
    model and its params, every leaf perturbed."""
    for mod in (jax_mim, port_mim):
        monkeypatch.setitem(mod._SIZES["base"], "depth", 2)
    jcfg, cfg = _configs()
    jmodel = jax_build_mim_model(jcfg, dtype=jnp.float32)
    assert jmodel.attn_pool and jmodel.simmim
    imgs = jnp.zeros((2, 3, 16, 16), jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(seed), imgs, mask=jnp.zeros_like(imgs))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32), params)
    return jcfg, cfg, jmodel, params


def _batches(n, seed=7):
    data = make_cutouts(16 * n, channels=3, img_size=16, seed=seed)
    assert np.isnan(data["cutouts"]).any()
    rng = np.random.default_rng(seed)
    masks = [np.repeat(np.repeat((rng.random((16, 3, 4, 4)) < rng.uniform(0.2, 0.9)), 4, 2), 4, 3)
             .astype(np.float32) for _ in range(n)]
    return [{"cutouts": data["cutouts"][16 * i:16 * (i + 1)]} for i in range(n)], masks


def test_attn_pool_model_builds_with_the_pool(monkeypatch):
    _, _, jmodel, params = _jax_pooled(monkeypatch)
    model = port_mim.build_mim_model(_configs()[1], device="cpu")
    assert model.pooled and model.dec_upsample == 16
    assert tuple(model.decoder_pred.kernel.shape) == (48, 16 * 16 * 3)
    assert {k for k in params_from_jax(params)} == set(model.state_dict())
    # MAE ignores attn_pool, as JAX does
    _, mae = _configs({"ARCHITECTURE": {"model_type": "base"}})
    mae_model = port_mim.build_mim_model(mae, device="cpu")
    assert not mae_model.pooled and not hasattr(mae_model, "pool")


def test_attn_pool_weights_round_trip_both_ways(monkeypatch):
    _, cfg, _, params = _jax_pooled(monkeypatch)
    model = port_mim.build_mim_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))  # strict
    back = params_to_jax(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    for leaf in ("latent", "xattn", "norm", "mlp"):
        assert leaf in params["pool"]
    # and from the port's own init into the flax tree
    fresh = port_mim.build_mim_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    tree = params_to_jax(fresh.state_dict())
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(params)
    reloaded = port_mim.build_mim_model(cfg, device="cpu")
    reloaded.load_state_dict(params_from_jax(tree))
    for (n, a), b in zip(fresh.state_dict().items(), reloaded.state_dict().values()):
        assert torch.equal(a, b), n


def test_attn_pool_forward_decode_and_loss_match_jax(monkeypatch):
    _, cfg, jmodel, params = _jax_pooled(monkeypatch, seed=1)
    batches, masks = _batches(1, seed=8)
    imgs, mask = batches[0]["cutouts"], masks[0]
    jtok, _, _ = jmodel.apply({"params": params}, jnp.asarray(imgs), mask=jnp.asarray(mask),
                              method=jax_mim.SkyMIM.encode)
    jpred = jmodel.apply({"params": params}, jtok, None, method=jax_mim.SkyMIM.decode)
    jloss, _, _ = jmodel.apply({"params": params}, jnp.asarray(imgs), mask=jnp.asarray(mask))
    model = port_mim.build_mim_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        tok, _, _ = model.encode(torch.from_numpy(imgs), mask=torch.from_numpy(mask))
        pred = model.decode(tok)
        loss, fpred, _ = model(torch.from_numpy(imgs), torch.from_numpy(mask))
    assert tok.shape == (16, 1, 48) and pred.shape == (16, 3, 16, 16)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), atol=1e-5)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-5)
    assert torch.equal(fpred, pred)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)


def test_three_adamw_steps_of_attn_pool_match_jax(monkeypatch):
    """Three AdamW steps (fp32) of ``mim_tiny`` with ``attn_pool`` at depth
    2 from the same params, batches (NaN bands) and masks: JAX
    ``SkyMIM.apply`` + ``pretrain_optimizer`` + optax against
    ``MIMPretrainer.train_batch``; the pool's leaves move too."""
    jcfg, cfg, jmodel, params = _jax_pooled(monkeypatch, seed=2)
    batches, masks = _batches(3, seed=9)
    tx = jax_pretrain_optimizer(params, jax_cosine(1e-3, jcfg.training.int("total_batch_iters"), 1e7),
                                0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)

    @jax.jit
    def jstep(p, s, x, m):
        loss, grads = jax.value_and_grad(lambda q: jmodel.apply({"params": q}, x, mask=m)[0])(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    trainer = MIMPretrainer(cfg, dtype=torch.float32, seed=0, device="cpu")
    trainer.model.load_state_dict(params_from_jax(params))
    assert trainer.model.pooled and trainer.model.encoder.depth == 2
    for batch, m in zip(batches, masks):
        jp, opt_state, jloss = jstep(jp, opt_state, jnp.maximum(jnp.asarray(batch["cutouts"]), -3.0),
                                     jnp.asarray(m))
        loss = trainer.train_batch(batch, mask=torch.from_numpy(m))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = {k: v.numpy() for k, v in params_from_jax(jax.tree_util.tree_map(np.asarray, jp)).items()}
    got = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-4, err_msg=name)
    start = params_from_jax(params)
    assert float((trainer.model.pool.latent.detach() - start["pool.latent"]).abs().max()) > 1e-3
