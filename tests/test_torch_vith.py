"""The port's ViT-H slice against the JAX package, on the CPU: the weight-
streaming MLP backward (kernel 9) and its slab partition, the attention
kernels' plain versions at ViT-H's head dim of 80, three AdamW steps of a
``mimhuge`` model at its full width (cut to depth 2 in both frameworks), and
the pretraining CLI twin running a ``mimhuge`` configuration given on its
command line.

Bars: fp32 atol 2e-5 for the kernels (tests/test_kernels.py's bar); bf16
max|a-b|/max|b| <= 2e-2 for outputs and 3e-2 for each gradient
(``TOL_FWD``/``TOL_BWD`` of tools/kernel_parity.py); the whole-slice losses
1e-5 relative and the params an absolute 1e-4 after three steps at lr 1e-3
(see ``tests/test_torch_train.py::test_three_adamw_steps_match_jax``).
"""

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
from sky_embeddings_tpu.ops.kernels import attn_block as jab
from sky_embeddings_tpu.ops.kernels import mlp_block as jmb
from sky_embeddings_tpu.train.optim import pretrain_optimizer as jax_pretrain_optimizer
from sky_embeddings_tpu.train.schedules import cosine_annealing as jax_cosine
from sky_embeddings_tpu_torch.configuration import Config
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.ops.kernels import attn_block as tab
from sky_embeddings_tpu_torch.ops.kernels import mlp_block as tmb
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer
from sky_embeddings_tpu_torch.utils.checkpoint import load_checkpoint

from test_torch_kernels import _GRADS, TOL_BWD, _as_np, _assert_close, _block_inputs
from test_torch_train import CONFIGS, _batches, _flat

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# -- kernel 9: the weight-streaming MLP backward -----------------------------------

@pytest.mark.parametrize("D,F", [(1280, 5120), (1024, 4096), (768, 3072), (48, 192), (64, 256),
                                 (1280, 2000), (2048, 8192), (1664, 6656), (4096, 1000)])
def test_stream_slab_matches_jax(D, F):
    """The slab partition, and with it the order of the fp32 dy sums, is JAX's."""
    assert tmb._stream_slab(D, F) == jmb._stream_slab(D, F)
    assert tmb._stream_slab(1280, 5120) == 1280  # ViT-H: four slabs


def _stream_inputs(dtype, seed=31):
    """B=8, N=17, D=48, F=192 block inputs and an output gradient g."""
    j, t = _block_inputs("mlp", dtype, B=8, N=17, D=48, F=192, seed=seed)
    g = np.random.default_rng(seed + 100).normal(size=(8, 17, 48)).astype(np.float32)
    return j, t, jnp.asarray(g).astype(_JDT[dtype]), torch.from_numpy(g).to(_TDT[dtype])


@pytest.fixture
def three_slabs(monkeypatch):
    """Slabs of 64 columns in both packages: F = 192 streams in 3 slabs, as
    tests/test_kernels.py forces it for the Pallas kernel."""
    for mod in (jmb, tmb):
        monkeypatch.setattr(mod, "_stream_slab", lambda D, F, **kw: 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_bwd_plain_matches_pallas(dtype, three_slabs):
    """Kernel 9's plain version against ``_pallas_bwd_stream`` in interpret
    mode, 3 slabs, every output."""
    j, t, jg, tg = _stream_inputs(dtype)
    want = jmb._pallas_bwd_stream(j[0], j[1].reshape(1, -1), j[2].reshape(1, -1), j[3],
                                  j[4].reshape(1, -1), j[5], jg, 0, True)
    want = [w[0] if w.shape[0] == 1 else w for w in want]
    got = tmb.mlp_block_bwd_stream_plain(*t[:6], tg)
    for name, a, b, leaf in zip(_GRADS["mlp"], got, want, t):
        assert a.dtype == leaf.dtype and a.shape == leaf.shape, name
        _assert_close(a.float().numpy(), _as_np(b), dtype, TOL_BWD)
    # on CPU tensors the wrapper takes it and launches nothing
    before = (tmb.mlp_block_bwd_stream.launches, tmb.mlp_block_bwd.launches)
    for a, b in zip(tmb.mlp_block_bwd_stream(*t[:6], tg), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (tmb.mlp_block_bwd_stream.launches, tmb.mlp_block_bwd.launches) == before == (0, 0)


def test_stream_bwd_with_one_slab_takes_kernel_8(monkeypatch):
    """At D=48, F=192 the weights fit one slab: the wrapper runs kernel 8
    (here its plain version), as ``_pallas_bwd_stream`` runs ``_pallas_bwd``."""
    assert tmb._stream_slab(48, 192) == 192
    _, t, _, tg = _stream_inputs("bfloat16", seed=32)
    calls = []
    k8 = tmb.mlp_block_bwd
    monkeypatch.setattr(tmb, "mlp_block_bwd", lambda *a: calls.append(1) or k8(*a))
    got = tmb.mlp_block_bwd_stream(*t[:6], tg)
    assert calls == [1]
    for a, b in zip(got, tmb.mlp_block_bwd_plain(*t[:6], tg)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_block_stream_grads_match_jax_vjp(dtype, three_slabs):
    """``fused_mlp_block(stash="stream")`` with grad against ``jax.vjp`` of
    JAX's (Pallas in interpret mode, row tiles of 68 over 3 slabs)."""
    j, t, jg, tg = _stream_inputs(dtype, seed=33)
    out, vjp = jax.vjp(lambda *a: jmb.fused_mlp_block(*a, 4, True, "stream"), *j)
    want = vjp(jg)
    leaves = [a.detach().clone().requires_grad_() for a in t]
    got_out = tmb.fused_mlp_block(*leaves, stash="stream")
    _assert_close(got_out.detach().float().numpy(), _as_np(out), dtype)
    got_out.backward(tg)
    for name, leaf, b in zip(_GRADS["mlp"] + ("db2",), leaves, want):
        assert leaf.grad.dtype == leaf.dtype and leaf.grad.shape == leaf.shape, name
        _assert_close(leaf.grad.float().numpy(), _as_np(b), dtype, TOL_BWD)
    # the Function's backward is the plain kernel 9, exactly
    for leaf, b in zip(leaves, tmb.mlp_block_bwd_stream_plain(*t[:6], tg)):
        torch.testing.assert_close(leaf.grad, b, rtol=0, atol=0)


# -- the attention kernels at head dim 80 ---------------------------------------------

def _attn80(dtype, N, seed, B=2, D=640):
    """B=2, D=640, 8 heads of 80 (the loop-heads body: 8 heads a 640-lane
    group) and an output gradient. Weights scale as D^-0.5, so qkv, the
    logits and the output stay O(1) at this width, as at D = 48."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    arrs = [0.5 * f32(B, N, D), 1.0 + 0.1 * f32(D), 0.1 * f32(D), f32(D, 3 * D) * D ** -0.5,
            0.01 * f32(3 * D), f32(D, D) * D ** -0.5, 0.01 * f32(D), f32(B, N, D)]
    cast = (0, 3, 5, 7)
    j = [jnp.asarray(a).astype(_JDT[dtype]) if i in cast else jnp.asarray(a) for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(_TDT[dtype]) if i in cast else torch.from_numpy(a) for i, a in enumerate(arrs)]
    return j[:7], t[:7], j[7], t[7]


@pytest.mark.parametrize("kernel", ["fwd", "fwd_stash", "bwd_stash", "bwd"])
@pytest.mark.parametrize("dtype,N", [("float32", 17), ("bfloat16", 17), ("bfloat16", 66)])
def test_attn_plain_versions_at_head_dim_80_match_pallas(kernel, dtype, N):
    """Kernels 1-4's plain versions against the Pallas kernels in interpret
    mode at hd = 80 (ViT-H's), N = 17 and 66 (the RA/Dec token)."""
    H = 8
    assert jab._use_loop_heads(H, 80)
    j, t, jg, tg = _attn80(dtype, N, seed=40 + N)
    row = lambda a: a.reshape(1, -1)
    jargs = (j[0], row(j[1]), row(j[2]), j[3], row(j[4]), j[5], row(j[6]))
    if kernel == "fwd":
        pairs = [(tab.attn_block_plain(*t, H), jab._pallas_fwd(*jargs, H, 2, True))]
    elif kernel == "fwd_stash":
        pairs = zip(tab.attn_block_fwd_stash_plain(*t, H), jab._pallas_fwd_stash(*jargs, H, 2, True))
    else:
        if kernel == "bwd_stash":
            _, qkv, probs = jab._pallas_fwd_stash(*jargs, H, 2, True)
            want = jab._pallas_bwd_stash(j[0], jargs[1], jargs[2], j[3], j[5], qkv, probs, jg, H,
                                         2, True)
            tq, tp = (torch.from_numpy(np.array(_as_np(a))).to(_TDT[dtype]) for a in (qkv, probs))
            got = tab.attn_block_bwd_stash_plain(t[0], t[1], t[2], t[3], t[5], tq, tp, tg, H)
        else:
            want = jab._pallas_bwd(*jargs, jg, H, 2, True)
            got = tab.attn_block_bwd_plain(*t[:6], tg, H)
        pairs = zip(got, [w[0] if w.shape[0] == 1 else w for w in want])
    for a, b in pairs:
        _assert_close(a.float().numpy(), _as_np(b), dtype, 2e-2 if kernel.startswith("fwd") else TOL_BWD)


# -- the slice: three AdamW steps of ViT-H at full width ------------------------------

# mimhuge at D = 1280 (16 heads of 80, F = 5120: the wide rule holds) over
# mim_tiny_large's 16x16x3 cutouts, cut to depth 2 in both frameworks
VITH = {"ARCHITECTURE": {"model_type": "mimhuge", "embed_dim": "1280"}}


def test_three_adamw_steps_of_vith_match_jax(monkeypatch):
    """Three AdamW steps (fp32) from the same params, batches (with NaN
    bands) and masks: JAX (whose wide MLP runs ``xla_mlp_block`` on the CPU)
    + optax against ``MIMPretrainer.train_batch``, whose wide MLP runs the
    plain kernel 9 over four slabs of 1280 and whose attention runs the
    plain kernels 1 and 4 at hd = 80 (``stash = False`` at huge). Bars as
    ``test_torch_train.py::test_three_adamw_steps_match_jax``."""
    for mod in (jax_mim, port_mim):
        monkeypatch.setitem(mod._SIZES["huge"], "depth", 2)
    base = jax_load_config("mim_tiny_large", CONFIGS)
    d = {sec: {**dict(base[sec].items()), **VITH.get(sec, {})} for sec in base.sections()}
    jcfg = JaxConfig.from_dict(d)
    jmodel = jax_build_mim_model(jcfg, dtype=jnp.float32)
    imgs = jnp.zeros((2, jmodel.in_chans, 16, 16), jnp.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), imgs, mask=jnp.zeros_like(imgs))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32), params)
    batches, masks = _batches(3, channels=jmodel.in_chans)
    tx = jax_pretrain_optimizer(params, jax_cosine(1e-3, jcfg.training.int("total_batch_iters"), 1e7),
                                0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)

    @jax.jit
    def jstep(p, s, x, m):
        loss, grads = jax.value_and_grad(lambda q: jmodel.apply({"params": q}, x, mask=m)[0])(p)
        updates, s = tx.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    trainer = MIMPretrainer(Config.from_dict(d), dtype=torch.float32, seed=0, device="cpu")
    trainer.model.load_state_dict(params_from_jax(params))
    enc = trainer.model.encoder
    assert enc.depth == 2 and trainer.model.embed_dim == 1280
    assert all(b.ffn.wide and not b.stash for b in (enc.block0, enc.block1))
    assert tmb._stream_slab(1280, 5120) == 1280
    for batch, m in zip(batches, masks):
        m = np.array(m)
        jp, opt_state, jloss = jstep(jp, opt_state, jnp.maximum(jnp.asarray(batch["cutouts"]), -3.0),
                                     jnp.asarray(m))
        loss = trainer.train_batch(batch, mask=torch.from_numpy(m))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _flat(jax.tree_util.tree_map(np.asarray, jp))
    got = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    assert set(got) == set(want)
    start = _flat(params)
    for name in want:
        a, b = got[name], want[name]
        if name.endswith("attn.qkv.bias"):
            # the key bias shifts every logit of a query alike, so softmax
            # makes its gradient exactly zero; Adam then normalises rounding
            # noise (~1e-9 against eps 1e-8) into steps that differ between
            # the frameworks. Held to what three steps at lr 1e-3 can move it.
            k = slice(1280, 2560)
            for side in (a, b):
                assert np.abs(side[k] - start[name][k]).max() <= 3.1e-3, name
            a, b = np.delete(a, np.r_[k]), np.delete(b, np.r_[k])
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=name)
    assert max(float(np.abs(got[n] - start[n]).max()) for n in want) > 1e-3


def test_pretrain_cli_twin_runs_a_vith_config_from_the_command_line(tmp_path, monkeypatch, capsys):
    """``pretrain_mim mim_tiny_large --set ARCHITECTURE.model_type=mimhuge
    ...`` on synthetic h5 files: the overrides build ViT-H (16 heads, the
    attention recompute backward), trained for the overridden 2 steps at a
    narrow width, into the checkpoint ``--run_name`` names."""
    from sky_embeddings_tpu_torch import pretrain_mim
    from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5

    monkeypatch.setitem(port_mim._SIZES["huge"], "depth", 2)
    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / "tiny_train.h5"), n=32, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(data / "tiny_val.h5"), n=16, channels=3, img_size=16, seed=2)
    monkeypatch.setattr(pretrain_mim, "REPO_DIR", str(tmp_path))
    argv = ["mim_tiny_large", "-v", "1", "-ct", "100", "-dd", str(data), "--device", "cpu",
            "--set", "ARCHITECTURE.model_type=mimhuge", "--set", "ARCHITECTURE.embed_dim=128",
            "--set", "TRAINING.total_batch_iters=2", "--run_name", "tiny_huge"]
    path = pretrain_mim.main(argv)
    out = capsys.readouterr().out
    assert path.endswith("tiny_huge.ckpt.pt")
    assert "Batch Iterations: 2/2" in out and "mimhuge" in out
    payload = load_checkpoint(path)
    assert payload["step"] == 2
    assert payload["params"]["encoder.block1.attn.qkv.kernel"].shape == (128, 384)
    with pytest.raises(ValueError, match="SECTION.key=value"):
        pretrain_mim.main(argv[:9] + ["--set", "embed_dim=64"])
