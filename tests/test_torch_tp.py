"""The port's tensor parallelism on the CPU (``parallel/sharding.py``, the
('data', 'model') mesh of ``parallel/mesh.py``, the tensor-parallel forms
of K2, K1 and kernels 4 and 8, ``[TRAINING] tensor_parallel`` in the MIM
and predictor trainers), against the JAX package and against one process.
Models are cut to depth 2 (D = 48; the MAE decoder to one 512-wide layer of
16 heads).

- ``param_specs`` equals JAX's ``param_specs`` leaf for leaf on a SimMIM,
  an MAE and a predictor tree (and on JAX's scan layout at ViT-H);
- ``shard_state`` / ``gather_state`` round-trip exactly at tp 2 and 4, and
  a rank's qkv slice is its own heads' q, k and v columns;
- each TP form's plain version, the ranks' partials summed, then finished,
  against JAX ``xla_attn_block`` / ``xla_mlp_block`` on the whole weights
  (fp32 atol 2e-5, bf16 max-rel 2e-2; ``seg_len`` too) and its gradients,
  the weights' gathered from the ranks', against ``jax.vjp`` (fp32 atol
  2e-5), at tp 2 and 4;
- two gloo ranks at ``tensor_parallel = 2`` (one spawn of
  ``torch_parallel_workers.tp_job``): 3 SimMIM and 3 MAE steps against
  JAX's single-device step (which JAX's own
  ``test_sharded_gradients_match_single_device`` equates with its
  tensor-parallel one) on the same params, batches and maskings: losses
  1e-5 relative, parameters 1e-4 absolute and the key biases the steps'
  summed lr (``test_torch_zero.py``'s bars of two data-parallel ranks
  against JAX: a key bias's gradient is rounding noise, whose Adam step
  the order of a sum decides); against the port's one process, losses
  1e-5 relative and the same bars, and for SimMIM
  ``parallel/smoke.param_gaps``'s tighter data-parallel bar, 2e-3 of the
  steps' summed lr (two ranks sum the proj and fc2 products in another
  order, and Adam turns that rounding into a step error in proportion to
  lr; measured 4.7e-7 to 1.1e-5 for SimMIM; the MAE decoder's small
  gradients carry it to 9.4e-6 to 5.2e-5, inside JAX's bar of 1e-4 but
  not 2e-3 of the lr); the replicated parameters bit-equal on
  both ranks; a TP save restored into a one-process port trainer and into
  JAX's ``MIMPretrainer`` bit-equal, one-process files (the port's and
  JAX's) restored into the ranks bit-equal to their shards, and a TP
  restore's next step bit-equal to the uninterrupted one; the predictor's
  ``ft`` on the ranks against one process (losses 1e-6 relative, the same
  parameter bars) and ``lp``'s step;
- four gloo ranks (data 2 x model 2, one spawn of ``tp_zero_job``) with
  ``zero_optimizer``: 3 SimMIM steps against one process over the global
  batch, the same bars, the moments sharded over the data group.

The whole-block rule (a block whose heads or MLP width the model axis does
not divide runs whole on every rank), in the same two spawns:

- ``maesimple`` (``mae_tiny`` as shipped but for the depth: its one-head
  512-wide decoder whole) at ``tensor_parallel = 2``: 3 steps against JAX's
  single-device step and one process at the MAE case's bars;
- I-JEPA at ``jepa_tiny``'s geometry cut to depth 2 and D = 64 (the
  encoder's 2 heads split, the 96-wide one-head predictor whole), the
  port's ``param_shardings`` / ``shard_state`` / ``gather_state`` exact at
  tp 2 and 4 and ``param_specs`` equal to JAX's on the ``SkyJEPA`` tree;
  on two ranks without and with ``zero_optimizer``, 3 steps from JAX's
  params and EMA target, the port given JAX's own mask draws, against
  JAX's single-device ``JEPATrainer`` (losses 1e-5 relative; parameters
  and EMA targets 1e-4 absolute, the key biases the steps' summed lr) and
  one process (losses 1e-5 relative, ``param_gaps``'s bars: 2e-3 of the
  summed lr, the key biases the summed lr; measured on the CPU: parameters
  5.8e-6 from JAX and 1.5e-6 from one process, whose losses the ranks
  equal, against a bar of 4.3e-6; four ranks 2.1e-6); every replicated
  leaf, the predictor's whole blocks included, bit-equal on both ranks;
  the TP save
  restored into a one-process port trainer and into JAX's trainer
  bit-equal, JAX's file restored into the ranks bit-equal to their shards,
  the restored step bit-equal to the uninterrupted one; four ranks (data 2
  x model 2) with ZeRO-1 against one process over the global batch at the
  same bars; ``jepa_tiny``'s own widths (192 wide, 3 heads; no block
  splits) one step, the ranks bit-equal.

About 120 s, most of it the two spawns.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import torch_parallel_workers as tpw
from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.models import jepa as jax_jepa
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.models.mim import build_mim_model as jax_build_mim_model
from sky_embeddings_tpu.models.predictor import build_predictor_model as jax_build_predictor
from sky_embeddings_tpu.ops.kernels import attn_block as jab
from sky_embeddings_tpu.ops.kernels import mlp_block as jmb
from sky_embeddings_tpu.ops.jepa_masks import sample_block_masks as jax_sample
from sky_embeddings_tpu.ops.masking import simmim_batch_mask as jax_simmim_batch_mask
from sky_embeddings_tpu.parallel.sharding import param_specs as jax_param_specs
from sky_embeddings_tpu.train.jepa import JEPATrainer as JaxJEPATrainer
from sky_embeddings_tpu.train.optim import pretrain_optimizer as jax_pretrain_optimizer
from sky_embeddings_tpu.train.pretrain import MIMPretrainer as JaxMIMPretrainer
from sky_embeddings_tpu.train.schedules import cosine_annealing as jax_cosine
from sky_embeddings_tpu_torch.configuration import Config, load_config
from sky_embeddings_tpu_torch.data.synthetic import make_cutouts, make_structured_cutouts
from sky_embeddings_tpu_torch.models import jepa as port_jepa
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.jepa import build_jepa_model
from sky_embeddings_tpu_torch.models.layers import Block
from sky_embeddings_tpu_torch.models.predictor import build_predictor_model
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.ops.jepa_masks import BlockMasks
from sky_embeddings_tpu_torch.ops.kernels import attn_block as tab
from sky_embeddings_tpu_torch.ops.kernels import mlp_block as tmb
from sky_embeddings_tpu_torch.parallel import sharding
from sky_embeddings_tpu_torch.parallel.smoke import param_gaps
from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer
from sky_embeddings_tpu_torch.utils import checkpoint as ckpt

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
B = 8  # the global batch
CUT = {"depth": 2, "decoder_depth": 1}
JEPA_SMALL = {"embed_dim": 64, "depth": 2, "num_heads": 2}
DEPTH = {"mim": {"base": CUT}, "jepa": {"tiny": JEPA_SMALL}}
TOL_F32, TOL_BF16 = 2e-5, 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(mp) -> None:
    """Both packages' size tables cut as :data:`DEPTH` says."""
    for mod in (jax_mim, port_mim):
        for k, v in CUT.items():
            mp.setitem(mod._SIZES["base"], k, v)
    for mod in (jax_jepa, port_jepa):
        mp.setitem(mod._SIZES, "tiny", dict(JEPA_SMALL))


@pytest.fixture
def small(monkeypatch):
    _cut(monkeypatch)


def _dict(cfg) -> dict:
    return {sec: dict(cfg[sec].items()) for sec in cfg.sections()}


def _configs(name: str, **arch):
    """(JAX config, port config) of ``name`` at batch ``B`` with ``arch``
    overrides."""
    d = _dict(jax_load_config(name, CONFIGS))
    d["TRAINING"]["batch_size"] = str(B)
    d["ARCHITECTURE"].update({k: str(v) for k, v in arch.items()})
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_params(jmodel, simmim: bool, seed: int = 0):
    """JAX params of ``jmodel``, perturbed on every leaf (numpy)."""
    x = jnp.zeros((2, 3, 16, 16), jnp.float32)
    kw = {"mask": jnp.zeros_like(x)} if simmim else {"mae_noise": jnp.zeros((2, 16))}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), x, **kw)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32), params)


# -- the rule table -----------------------------------------------------------------

def _abstract(jmodel, **kw):
    x = jnp.zeros((1, jmodel.in_chans, jmodel.img_size, jmodel.img_size))
    return jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, **kw))["params"]


def _jepa_dict(**training) -> dict:
    """``jepa_tiny`` at batch ``B``, 10 steps, EMA from 0.9 (so the target
    moves within three steps)."""
    d = _dict(jax_load_config("jepa_tiny", CONFIGS))
    d["TRAINING"].update(batch_size=str(B), total_batch_iters="10", ema="[0.9, 1.0]",
                         **{k: str(v) for k, v in training.items()})
    return d


def _jepa_abstract(jcfg):
    jmodel = jax_jepa.build_jepa_model(jcfg)
    g = jmodel.img_size // jmodel.patch_size
    masks = jax_sample(jax.random.PRNGKey(0), 1, g)
    x = jnp.zeros((1, jmodel.in_chans, jmodel.img_size, jmodel.img_size))
    tgt = jnp.zeros((1, g * g, jmodel.embed_dim))
    return jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, masks, tgt))["params"]


@pytest.mark.parametrize("tree", ["simmim", "mae", "predictor", "predictor_scan", "jepa"])
def test_param_specs_equal_jax_leaf_for_leaf(tree, small):
    """``param_specs`` of the JAX tree, nested, and of the port's flat state
    dict of the same model, against JAX's ``param_specs``: the same
    ``PartitionSpec`` at every path (patch embedding, attention pool and
    the scan layout's stacked prefix included; I-JEPA's whole predictor
    blocks too: the specs are JAX's whatever the port's layout)."""
    if tree == "jepa":
        d = _jepa_dict()
        abstract = _jepa_abstract(JaxConfig.from_dict(d))
        sd = build_jepa_model(Config.from_dict(d), device="cpu").state_dict()
    elif tree in ("simmim", "mae"):
        jcfg, cfg = _configs("mim_tiny" if tree == "simmim" else "mae_tiny",
                             **({} if tree == "simmim" else {"model_type": "base"}),
                             attn_pool=tree == "simmim")
        jmodel = jax_build_mim_model(jcfg, dtype=jnp.float32)
        kw = {"mask": jnp.zeros((1, 3, 16, 16))} if tree == "simmim" else {
            "mae_noise": jnp.zeros((1, 16))}
        abstract = _abstract(jmodel, **kw)
        sd = port_mim.build_mim_model(cfg, device="cpu").state_dict()
    else:
        name = "z_struct_ft_512"
        jcfg, cfg = jax_load_config(name, CONFIGS), load_config(name, CONFIGS)
        mae_name = cfg.pretrained_mae_name()
        d = _dict(jax_load_config(mae_name, CONFIGS))
        if tree == "predictor_scan":  # JAX builds the scan layout at ViT-H
            d["ARCHITECTURE"].update(model_type="mimhuge", embed_dim="1280")
        jmodel = jax_build_predictor(jcfg, JaxConfig.from_dict(d))
        assert jmodel.scan_blocks == (tree == "predictor_scan")
        abstract = _abstract(jmodel, **({"ra_dec": jnp.zeros((1, 2))} if jmodel.ra_dec else {}))
        sd = build_predictor_model(cfg, Config.from_dict(d), device="meta").state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(
        jax_param_specs(abstract), is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    want = {".".join(str(getattr(k, "key", k)) for k in path): spec for path, spec in leaves}
    got = _flat(sharding.param_specs(abstract))
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert tuple(got[name]) == tuple(spec), name
    assert any(tuple(s) for s in want.values())  # some leaf is sharded
    if tree != "predictor_scan":  # the port's own flat names: the loop layout's JAX paths
        flat = sharding.param_specs(sd)
        assert sorted(flat) == sorted(want)
        assert all(tuple(flat[k]) == tuple(want[k]) for k in want)


def _state(name="mim_tiny", **arch):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in CUT.items():
            mp.setitem(port_mim._SIZES["base"], k, v)
        model = port_mim.build_mim_model(_configs(name, **arch)[1], device="cpu")
        return model.state_dict(), model


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name, arch", [("mim_tiny", {}), ("mae_tiny", {"model_type": "base"})])
def test_shard_and_gather_round_trip_exactly(tp, name, arch):
    """Every rank's state dict from the whole one and back, bit for bit;
    only the blocks' qkv / proj / fc1 / fc2 leaves split (the patch
    embedding, LNs, bproj, fc2_bias and the MAE decoder_embed stay whole);
    rank r's qkv kernel and bias are its heads' columns of q, k and v."""
    sd, model = _state(name, **arch)
    blocks = sharding.split_blocks(model, tp)
    assert blocks == {n for n, m in model.named_modules() if isinstance(m, Block)}
    ranks = [sharding.shard_state(sd, r, tp, blocks) for r in range(tp)]
    back = sharding.gather_state(ranks, blocks)
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
    split = {k for k, v in sharding.param_shardings(sd, blocks).items() if v is not None}
    assert "encoder.block1.attn.qkv.kernel" in split and "patch_embed.proj.kernel" not in split
    assert all(k.rsplit(".", 2)[-2:] in (["qkv", "kernel"], ["qkv", "bias"], ["proj", "kernel"])
               or k.endswith(("fc1_kernel", "fc1_bias", "fc2_kernel")) for k in split)
    for k in sd:
        if k not in split:
            assert all(r[k] is sd[k] for r in ranks), k
    D = sd["encoder.block0.norm1.scale"].shape[0]
    Dl = D // tp
    for r in range(tp):
        kern, bias = (ranks[r][f"encoder.block0.attn.qkv.{n}"] for n in ("kernel", "bias"))
        cols = torch.cat([torch.arange(t * D + r * Dl, t * D + (r + 1) * Dl) for t in range(3)])
        assert torch.equal(kern, sd["encoder.block0.attn.qkv.kernel"][:, cols])
        assert torch.equal(bias, sd["encoder.block0.attn.qkv.bias"][cols])
        assert torch.equal(ranks[r]["encoder.block0.attn.proj.kernel"],
                           sd["encoder.block0.attn.proj.kernel"][r * Dl:(r + 1) * Dl])


@pytest.mark.parametrize("tp", [2, 4])
def test_jepa_split_and_whole_blocks_round_trip_exactly(tp, small):
    """An I-JEPA model that mixes split and whole blocks: at tp 2 the
    encoder's 2 heads split and the 96-wide one-head predictor stays whole,
    at tp 4 every block stays whole (2 heads); every rank's state dict
    from the whole one and back, bit for bit, the whole blocks' leaves the
    whole tensors themselves on every rank; a built rank's model (the
    layout :func:`shard_module` gives without a process group) reports the
    same split set and its target, a copy, too."""
    from sky_embeddings_tpu_torch.parallel.mesh import create_mesh

    model = build_jepa_model(Config.from_dict(_jepa_dict()), device="cpu")
    sd = model.state_dict()
    blocks = sharding.split_blocks(model, tp)
    want = {f"encoder.encoder.block{i}" for i in range(2)} if tp == 2 else set()
    assert blocks == want
    ranks = [sharding.shard_state(sd, r, tp, blocks) for r in range(tp)]
    back = sharding.gather_state(ranks, blocks)
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
    split = {k for k, v in sharding.param_shardings(sd, blocks).items() if v is not None}
    assert all(k.startswith("encoder.encoder.block") for k in split) and len(split) == 6 * len(want)
    for k in sd:
        if k not in split:
            assert all(r[k] is sd[k] for r in ranks), k
    mesh = create_mesh(1, tp, devices=list(range(tp)), device_type="cpu")
    sharding.shard_module(model, mesh)
    assert sharding.split_of(model) == blocks
    assert sharding.split_of(model.encoder) == {b[len("encoder."):] for b in blocks}
    for name, v in model.state_dict().items():
        assert torch.equal(v, ranks[0][name]), name
    pred = model.predictor.blocks.block0
    assert pred.tp is None and not pred.stash and not pred.ffn.stash


# -- the TP forms' plain versions ------------------------------------------------------

def _block(kind, dtype, B_=2, N=17, D=64, F=256, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    wa, wb = ((D, 3 * D), (D, D)) if kind == "attn" else ((D, F), (F, D))
    return ((0.5 * f32(B_, N, D)).to(dtype), 1 + 0.1 * f32(D), 0.1 * f32(D),
            (f32(*wa) * wa[0] ** -0.5).to(dtype), 0.01 * f32(wa[1]),
            (f32(*wb) * wb[0] ** -0.5).to(dtype), 0.01 * f32(wb[1]))


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if t.dtype == torch.bfloat16
                                                 else jnp.float32)


def _max_rel(a, b) -> float:
    b = np.asarray(b, np.float32)
    return float(np.abs(a.float().numpy() - b).max() / max(np.abs(b).max(), 1e-30))


def _shards(kind, t, tp):
    """Each rank's (w_a, b_a, w_b) of a block's whole weights."""
    rules = ((sharding.TPShard(1, True), sharding.TPShard(0, True), sharding.TPShard(0))
             if kind == "attn" else
             (sharding.TPShard(1), sharding.TPShard(0), sharding.TPShard(0)))
    return [[sharding.shard_tensor(w, rule, r, tp) for w, rule in zip((t[3], t[4], t[5]), rules)]
            for r in range(tp)]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind, seg", [("attn", 0), ("attn", 5), ("mlp", 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_plain_forms_summed_match_jax_xla_blocks(tp, kind, seg, dtype):
    """The ranks' halves of K2's / K1's TP form, summed (the all-reduce) and
    finished, against ``xla_attn_block`` / ``xla_mlp_block`` on the whole
    weights; in fp32 the backward halves of kernel 4's / 8's TP form,
    summed and finished, with every weight gradient gathered from the
    ranks, against ``jax.vjp`` of the same function."""
    H = 8
    t = _block(kind, dtype, N=20 if seg else 17, seed=tp + seg)
    g = torch.from_numpy(np.random.default_rng(7).normal(size=tuple(t[0].shape)).astype(np.float32))
    x, scale, bias, _, _, _, b_out = t
    if kind == "attn":
        fn = lambda *a: jab.xla_attn_block(*a, H, seg)  # noqa: E731
        fwd = lambda w: tab.attn_block_tp_fwd_plain(x, scale, bias, *w, H // tp, seg)  # noqa: E731
        bwd = lambda w: tab.attn_block_tp_bwd_plain(x, scale, bias, *w, g.to(dtype), H // tp,  # noqa: E731
                                                    seg)
        rules = (sharding.TPShard(1, True), sharding.TPShard(0, True), sharding.TPShard(0))
    else:
        fn = jmb.xla_mlp_block
        fwd = lambda w: tmb.mlp_block_tp_fwd_plain(x, scale, bias, *w)  # noqa: E731
        bwd = lambda w: tmb.mlp_block_tp_bwd_plain(x, scale, bias, *w, g.to(dtype))  # noqa: E731
        rules = (sharding.TPShard(1), sharding.TPShard(0), sharding.TPShard(0))
    shards = _shards(kind, t, tp)
    out = tmb.tp_finish_plain(x, sum(fwd(w) for w in shards), b_out)
    want, vjp = jax.vjp(fn, *map(_jax, t))
    assert out.dtype == dtype and out.shape == x.shape
    if dtype == torch.bfloat16:
        assert _max_rel(out, want) <= TOL_BF16
        return
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL_F32)
    halves = [bwd(w) for w in shards]
    dy = sum(h[0] for h in halves)
    dx, dscale, dbias, db_out = tmb.tp_bwd_finish_plain(x, scale, bias, g, dy)
    dw = [sharding.gather_tensor([h[i] for h in halves], rule) for i, rule in zip((1, 2, 3), rules)]
    grads = vjp(_jax(g))
    for got, ref in zip((dx, dscale, dbias, *dw, db_out), grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL_F32)


def test_tp_autograd_functions_take_the_plain_forms_on_cpu():
    """``fused_attn_block_tp`` / ``fused_mlp_block_tp`` with one rank's
    ``reduce`` a no-op at tp = 1 equal the whole blocks' plain paths, value
    and every gradient (the autograd Functions' wiring)."""
    for kind in ("attn", "mlp"):
        t = [a.clone().requires_grad_() for a in _block(kind, torch.float32, seed=11)]
        u = [a.detach().clone().requires_grad_() for a in t]
        if kind == "attn":
            a = tab.fused_attn_block_tp(*t, 4, lambda p: p)
            b = tab.fused_attn_block(*u, 4, stash=False)
        else:
            a = tmb.fused_mlp_block_tp(*t, lambda p: p)
            b = tmb.fused_mlp_block(*u)
        g = torch.randn(a.shape, generator=torch.Generator().manual_seed(1))
        (a * g).sum().backward()
        (b * g).sum().backward()
        assert torch.allclose(a, b, atol=1e-6)
        for p, q in zip(t, u):
            assert torch.allclose(p.grad, q.grad, atol=1e-5), kind


@pytest.mark.parametrize("D,dtype,refused", [(1280, torch.bfloat16, False),
                                             (1288, torch.bfloat16, True),
                                             (1536, torch.float32, False)])
def test_tp_backward_forms_refuse_bf16_rows_wider_than_their_ln_holds(D, dtype, refused):
    """The bf16 TP backward halves and finishes hold an LN row in registers
    (ViT-H's D = 1 280 at most); a wider bf16 row is refused before any
    launch, the fp32 forms take any width."""
    x = torch.zeros(1, 2, D, dtype=dtype)
    if refused:
        with pytest.raises(ValueError, match="at most 1280"):
            tmb.check_ln_held(x)
    else:
        tmb.check_ln_held(x)
    assert tab.check_ln_held is tmb.check_ln_held


# -- ranks -----------------------------------------------------------------------------

def _jax_steps(jcfg, params, batches, maskings, simmim: bool):
    """Three steps of JAX's single-device jitted step (``pretrain_optimizer``
    + optax) from ``params``: (losses, flat params)."""
    jmodel = jax_build_mim_model(jcfg, dtype=jnp.float32)
    tx = jax_pretrain_optimizer(params, jax_cosine(1e-3, jcfg.training.int("total_batch_iters"),
                                                   1e7), 0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    s = tx.init(jp)
    kw = "mask" if simmim else "mae_noise"

    @jax.jit
    def step(p, s, x, m):
        loss, g = jax.value_and_grad(lambda q: jmodel.apply({"params": q}, x, **{kw: m})[0])(p)
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    losses = []
    for b, m in zip(batches[:3], maskings[:3]):
        jp, s, loss = step(jp, s, jnp.maximum(jnp.asarray(b["cutouts"]), -3.0), jnp.asarray(m))
        losses.append(float(loss))
    return losses, {k: torch.from_numpy(np.array(v)) for k, v in _flat(jax.device_get(jp)).items()}


def _one_steps(cfg, state, batches, maskings, simmim: bool, **training):
    tr = MIMPretrainer(Config.from_dict({**_dict(cfg), "TRAINING": {
        **dict(cfg["TRAINING"].items()), **{k: str(v) for k, v in training.items()}}}),
        dtype=torch.float32, device="cpu")
    tr.model.load_state_dict(state)
    key = "mask" if simmim else "noise"
    losses = [float(tr.train_batch(b, **{key: torch.from_numpy(m)}))
              for b, m in zip(batches[:3], maskings[:3])]
    return losses, tpw.state(tr.model), tr, sum(tr.schedule(i) for i in range(3))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX and one-process references, then the two-rank and the
    four-rank spawns."""
    out_dir = str(tmp_path_factory.mktemp("tp"))
    with pytest.MonkeyPatch.context() as mp:
        _cut(mp)
        data = make_cutouts(4 * B, channels=3, img_size=16, seed=7)
        assert np.isnan(data["cutouts"]).any()
        rd = np.stack([data["ra"], data["dec"]], 1)
        batches = [{"cutouts": data["cutouts"][B * i:B * (i + 1)], "ra_dec": rd[B * i:B * (i + 1)]}
                   for i in range(4)]
        rng = np.random.default_rng(3)
        refs, payload = {}, {"depth": DEPTH, "out_dir": out_dir}
        for key, name, arch in (("simmim", "mim_tiny", {}),
                                ("mae", "mae_tiny", {"model_type": "base"}),
                                ("mae_simple", "mae_tiny", {})):
            jcfg, cfg = _configs(name, **arch)
            simmim = key == "simmim"
            jmodel = jax_build_mim_model(jcfg, dtype=jnp.float32)
            params = _jax_params(jmodel, simmim, seed=len(key))
            maskings = ([np.array(jax_simmim_batch_mask(jax.random.PRNGKey(i), B, 3, 16, 4, 0.9))
                         for i in range(4)] if simmim else
                        [rng.random((B, 16)).astype(np.float32) for _ in range(4)])
            state = params_from_jax(params)
            jl, jparams = _jax_steps(jcfg, params, batches, maskings, simmim)
            ol, oparams, one, lr_sum = _one_steps(cfg, state, batches, maskings, simmim)
            refs[key] = dict(jax=(jl, jparams), one=(ol, oparams), lr_sum=lr_sum, start=state)
            payload[key] = {"cfg": _dict(cfg), "params": state, "batches": batches,
                            "maskings": maskings}
            if simmim:  # one process's files, restored by the ranks
                one.save(os.path.join(out_dir, "one.ckpt.pt"))
                jt = JaxMIMPretrainer(jcfg, dtype=jnp.float32)
                jt.save(os.path.join(out_dir, "jax.ckpt.msgpack"))
                jax_whole = params_from_jax(jax.device_get(jt.state.params))
                payload["one_files"] = {".ckpt.pt": (os.path.join(out_dir, "one.ckpt.pt"),
                                                     tpw.state(one.model)),
                                        ".ckpt.msgpack": (os.path.join(out_dir, "jax.ckpt.msgpack"),
                                                          jax_whole)}
        # the predictor: ft over mim_tiny (augmentations on), one process
        mim = load_config("mim_tiny", CONFIGS)
        d = _dict(load_config("z_tiny", CONFIGS))
        d["TRAINING"]["batch_size"] = str(B)
        pcfg = Config.from_dict(d)
        sd = make_structured_cutouts(3 * B, channels=3, img_size=16, seed=5)
        prd = np.stack([sd["ra"], sd["dec"]], 1)
        pb = [{"cutouts": sd["cutouts"][B * i:B * (i + 1)], "ra_dec": prd[B * i:B * (i + 1)],
               "labels": sd["zspec"][B * i:B * (i + 1), None]} for i in range(3)]
        one = PredictorTrainer(pcfg, mim, dtype=torch.float32, seed=2, device="cpu")
        start = tpw.state(one.model)
        refs["pred"] = ([[float(v) for v in one.train_batch(b)] for b in pb],
                        [float(v) for v in one.eval_batch(pb[0])], tpw.state(one.model),
                        sum(one.schedule(i) for i in range(3)))
        payload["pred"] = {"cfg": _dict(pcfg), "mim_cfg": _dict(mim), "params": start,
                           "batches": pb}
        refs["jepa"], payload["jepa"] = _jepa_refs(out_dir, [b["cutouts"] for b in batches])
        two = tpw.run_ranks(tpw.tp_job, payload)
        four = tpw.run_ranks(tpw.tp_zero_job, payload, n=4)
        # a TP save restored by one process, the port's and JAX's
        _, cfg = _configs("mim_tiny")
        port = MIMPretrainer(cfg, dtype=torch.float32, device="cpu")
        assert port.restore(os.path.join(out_dir, "tp.ckpt.pt")) and port.cur_iter == 3
        jt = JaxMIMPretrainer(_configs("mim_tiny")[0], dtype=jnp.float32)
        assert jt.restore(os.path.join(out_dir, "tp.ckpt.msgpack"))
        restored = {"port": tpw.state(port.model),
                    "jax": params_from_jax(jax.device_get(jt.state.params)),
                    "jax_step": int(jt.state.step)}
        # the ranks' I-JEPA save restored by one process, the port's and JAX's
        port_j = JEPATrainer(Config.from_dict(_jepa_dict()), device="cpu")
        assert port_j.restore(os.path.join(out_dir, "tp_jepa.ckpt.pt")) and port_j.cur_iter == 3
        jj = JaxJEPATrainer(JaxConfig.from_dict(_jepa_dict(), name="jepa_t"))
        assert jj.restore(os.path.join(out_dir, "tp_jepa.ckpt.msgpack"))
        restored["jepa"] = {
            "port": (tpw.state(port_j.model), tpw.state(port_j.target)),
            "jax": (params_from_jax(jax.device_get(jj.state.params)),
                    params_from_jax(jax.device_get(jj.state.target_params))),
            "jax_step": int(jj.state.step)}
    return dict(refs=refs, two=two, four=four, restored=restored)


def _jepa_refs(out_dir: str, images: list):
    """I-JEPA's references and the ranks' payload: JAX's ``JEPATrainer``
    (its params, EMA target and initial file), three of its steps on
    ``images`` (clipped at -3, as the loaders clip) from its own mask
    draws, and the port's one process from the same params, target and
    masks."""
    jt = JaxJEPATrainer(JaxConfig.from_dict(_jepa_dict(), name="jepa_t"))
    jax_file = os.path.join(out_dir, "jax_jepa.ckpt.msgpack")
    jt.save(jax_file)
    params = params_from_jax(jax.device_get(jt.state.params))
    target = params_from_jax(jax.device_get(jt.state.target_params))
    rng, masks = jt.state.rng, []
    for _ in range(4):  # train/jepa.py's draws: the state's next rng is k_next
        _, k_mask, rng = jax.random.split(rng, 3)
        m = jax_sample(k_mask, B, jt.model.grid_size, **jt.mask_params)
        masks.append(BlockMasks(*(torch.from_numpy(np.asarray(a).astype(
            bool if a.dtype == bool else np.int64)) for a in m)))
    batches = [np.maximum(x, -3.0) for x in images]
    jl = [float(jt.train_batch({"cutouts": b, "ra_dec": np.zeros((B, 2), np.float32)}))
          for b in batches[:3]]
    jax_after = (params_from_jax(jax.device_get(jt.state.params)),
                 params_from_jax(jax.device_get(jt.state.target_params)))
    one = JEPATrainer(Config.from_dict(_jepa_dict()), device="cpu")
    one.model.load_state_dict(params)
    one.target.load_state_dict(target)
    ol = [float(one.train_batch({"cutouts": b}, masks=m)) for b, m in zip(batches[:3], masks[:3])]
    refs = dict(jax=(jl, *jax_after), one=(ol, tpw.state(one.model), tpw.state(one.target)),
                lr_sum=sum(one.lr_schedule(i) for i in range(3)), start=params)
    payload = {"cfg": _jepa_dict(), "params": params, "target": target, "batches": batches,
               "masks": masks, "jax_file": jax_file}
    return refs, payload


def _held(got: dict, want: dict, lr_sum: float):
    rest, keys = param_gaps(got, want)
    assert rest <= 2e-3 * lr_sum and keys <= lr_sum, (rest, keys)


@pytest.mark.parametrize("key", ["simmim", "mae", "mae_simple"])
def test_two_tp_ranks_match_jax_and_one_process(ranks, key):
    r0, r1 = (r[key] for r in ranks["two"])
    ref = ranks["refs"][key]
    assert ranks["two"][0]["mesh"] == ((1, 2), 0, 0, (slice(0, 8), 8), True)
    assert ranks["two"][1]["mesh"] == ((1, 2), 0, 1, (slice(0, 8), 8), True)
    assert r0["losses"] == r1["losses"] and r1["params"] is None
    np.testing.assert_allclose(r0["losses"], ref["jax"][0], rtol=1e-5)
    np.testing.assert_allclose(r0["losses"], ref["one"][0], rtol=1e-5)
    assert set(r0["params"]) == set(ref["start"])
    for want in (ref["jax"][1], ref["one"][1]):  # test_torch_zero.py's bars to JAX
        rest, keys = param_gaps(r0["params"], want)
        assert rest <= 1e-4 and keys <= ref["lr_sum"], (rest, keys)
    if key == "simmim":
        _held(r0["params"], ref["one"][1], ref["lr_sum"])
    for k, v in r0["params"].items():  # every leaf moved
        assert float((v - ref["start"][k]).abs().max()) > 0, k
    assert set(r0["replicated"]) == set(r1["replicated"])
    assert all(torch.equal(v, r1["replicated"][k]) for k, v in r0["replicated"].items())
    encoder = [f"encoder.block{i}" for i in range(2)]
    assert r0["split"] == r1["split"] == sorted(
        encoder + (["decoder.block0"] if key == "mae" else []))
    if key == "mae_simple":  # the one-head decoder: whole, and bit-equal on both ranks
        dec = [k for k in r0["replicated"] if k.startswith("decoder.block0.")]
        assert "decoder.block0.attn.qkv.kernel" in dec and len(dec) == 12


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(v, b[k]) for k, v in a.items())


@pytest.mark.parametrize("zero_on", [False, True])
def test_jepa_two_tp_ranks_match_jax_and_one_process(ranks, zero_on):
    """I-JEPA at ``tensor_parallel = 2``: the encoder's blocks split, the
    predictor's whole on both ranks, the target a copy sharded alike that
    shares the mesh; 3 steps against JAX's trainer and one process (the
    module docstring's bars); every replicated leaf of the model and the
    EMA target bit-equal on both ranks."""
    r0, r1 = (r["jepa"][zero_on] for r in ranks["two"])
    ref = ranks["refs"]["jepa"]
    layout = ranks["two"][0]["jepa"]["layout"]
    enc = [f"encoder.encoder.block{i}" for i in range(2)]
    assert layout["split"] == enc and layout["target_split"] == [b[8:] for b in enc]
    assert layout["enc_qkv"] == (64, 96) and layout["enc_fc2"] == (128, 64)
    assert layout["pred_qkv"] == (96, 288) and layout["pred_fc2"] == (384, 96)
    assert layout["target_qkv"] == (64, 96)
    assert layout["whole_recompute"] and layout["target_shares_mesh"]
    assert r0["losses"] == r1["losses"] and r1["params"] is None and r1["target"] is None
    for want in (ref["jax"][0], ref["one"][0]):
        np.testing.assert_allclose(r0["losses"], want, rtol=1e-5)
    for got, jax_want, one_want in ((r0["params"], ref["jax"][1], ref["one"][1]),
                                    (r0["target"], ref["jax"][2], ref["one"][2])):
        assert set(got) == set(jax_want)
        rest, keys = param_gaps(got, jax_want)
        assert rest <= 1e-4 and keys <= ref["lr_sum"], (rest, keys)
        _held(got, one_want, ref["lr_sum"])
    for k, v in r0["params"].items():  # every leaf moved
        assert float((v - ref["start"][k]).abs().max()) > 0, k
    for part in ("replicated", "target_replicated"):
        assert _same(r0[part], r1[part]), part
    pred = [k for k in r0["replicated"] if k.startswith("predictor.blocks.")]
    assert len(pred) == 2 * 12 and "predictor.blocks.block1.attn.qkv.kernel" in pred


def test_jepa_tp_checkpoints_move_between_layouts_and_frameworks(ranks):
    """The ranks' I-JEPA save (ZeRO on, one data index) in the port's
    format restored by one process and in JAX's by JAX's trainer, the
    parameters and the EMA target bit-equal to the ranks' gathered ones;
    JAX's one-device file restored by the ranks bit-equal to their shards;
    each rank's restored step (model and target) bit-equal to its
    uninterrupted one."""
    saved = ranks["two"][0]["jepa"][True]
    got = ranks["restored"]["jepa"]
    for which in ("port", "jax"):
        params, target = got[which]
        assert _same(params, saved["params"]) and _same(target, saved["target"]), which
    assert got["jax_step"] == 3
    for r in ranks["two"]:
        assert r["jepa"]["restored"] == {".ckpt.pt": True, ".ckpt.msgpack": True}
        assert r["jepa"]["from_jax"]


def test_jepa_tiny_widths_train_whole_on_two_tp_ranks(ranks):
    """``jepa_tiny``'s widths (a 192-wide 3-head encoder, a 96-wide one-head
    predictor) at ``tensor_parallel = 2``: no block splits, every block
    runs whole on both ranks, and one step leaves the ranks' losses,
    parameters and EMA targets bit-equal."""
    r0, r1 = (r["jepa"]["tiny"] for r in ranks["two"])
    assert r0["split"] == r1["split"] == []
    assert r0["loss"] == r1["loss"] and np.isfinite(r0["loss"])
    assert _same(r0["params"], r1["params"]) and _same(r0["target"], r1["target"])
    assert r0["params"]["encoder.encoder.block0.attn.qkv.kernel"].shape == (192, 576)


def test_tp_checkpoints_move_between_layouts_and_frameworks(ranks):
    """The TP save in the port's format restored by one process and in
    JAX's by JAX's trainer, bit-equal to the ranks' gathered parameters;
    one process's files (the port's and JAX's) restored by the ranks,
    bit-equal to their shards; a TP restore's next step bit-equal to the
    uninterrupted one."""
    saved = ranks["two"][0]["simmim"]["params"]
    for which in ("port", "jax"):
        got = ranks["restored"][which]
        assert set(got) == set(saved)
        assert all(torch.equal(got[k], v) for k, v in saved.items()), which
    assert ranks["restored"]["jax_step"] == 3
    for r in ranks["two"]:
        assert r["restored"] == {".ckpt.pt": True, ".ckpt.msgpack": True}
        assert r["from_one"] == {".ckpt.pt": True, ".ckpt.msgpack": True}


def test_predictor_ft_on_two_tp_ranks_matches_one_process(ranks):
    losses, val, params, lr_sum = ranks["refs"]["pred"]
    r0, r1 = (r["pred"] for r in ranks["two"])
    assert r0["losses"] == r1["losses"] and r0["val"] == r1["val"]
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-6)
    np.testing.assert_allclose(r0["val"], val, rtol=1e-6)
    _held(r0["params"], params, lr_sum)
    assert ranks["two"][0]["lp"] == ranks["two"][1]["lp"]
    # lp's first loss is ft's: the same weights, batch and draws
    np.testing.assert_allclose(ranks["two"][0]["lp"], losses[0], rtol=1e-6)


def test_four_ranks_data_and_model_with_zero_match_one_process(ranks):
    losses, params = ranks["refs"]["simmim"]["one"]
    four = ranks["four"]
    assert [r["mesh"] for r in four] == [((2, 2), 0, 0), ((2, 2), 0, 1), ((2, 2), 1, 0),
                                         ((2, 2), 1, 1)]
    assert all(r["sharded"] and r["ddp"] for r in four)
    assert all(r["losses"] == four[0]["losses"] for r in four)
    np.testing.assert_allclose(four[0]["losses"], losses, rtol=1e-5)
    _held(four[0]["params"], params, ranks["refs"]["simmim"]["lr_sum"])
    assert four[2]["params"] is not None and four[1]["params"] is None
    assert all(torch.equal(four[2]["params"][k], v) for k, v in four[0]["params"].items())
    for r in four[1:]:
        assert all(torch.equal(v, r["replicated"][k]) for k, v in four[0]["replicated"].items())


def test_jepa_four_ranks_data_and_model_with_zero_match_one_process(ranks):
    """I-JEPA on four ranks (data 2 x model 2, ZeRO-1 over the data group,
    DDP), each data index on its rows of the global batch and its block
    masks, against one process over the global batch."""
    ref = ranks["refs"]["jepa"]
    four = [r["jepa"] for r in ranks["four"]]
    assert all(r["sharded"] and r["ddp"] for r in four)
    assert all(r["losses"] == four[0]["losses"] for r in four)
    np.testing.assert_allclose(four[0]["losses"], ref["one"][0], rtol=1e-5)
    _held(four[0]["params"], ref["one"][1], ref["lr_sum"])
    _held(four[0]["target"], ref["one"][2], ref["lr_sum"])
    assert _same(four[0]["params"], four[2]["params"]) and four[1]["params"] is None
    for r in four[1:]:
        assert _same(four[0]["replicated"], r["replicated"])
        assert _same(four[0]["target_replicated"], r["target_replicated"])


TWIN = ("import sys; from sky_embeddings_tpu_torch.models import mim; "
        "mim._SIZES['base']['depth'] = 2; import torch; "
        "from sky_embeddings_tpu_torch import pretrain_mim as t; t.REPO_DIR = sys.argv[1]; "
        "t.main(sys.argv[2:]); torch.distributed.destroy_process_group()")


def test_pretrain_mim_twin_at_tensor_parallel_2(tmp_path):
    """``pretrain_mim mim_tiny --set TRAINING.tensor_parallel=2`` (depth 2,
    4 steps, validation, the probes and the figures at steps 2 and 4) as
    two ``SKY_DISTRIBUTED`` processes: one data index, so both read the
    whole batches; process 0 alone logs, draws and writes the whole
    checkpoint; its parameters against one process trained on the same
    batches and draws (``param_gaps``'s bars)."""
    import socket
    import subprocess
    import sys

    from sky_embeddings_tpu_torch.data.device_cache import build_cached_or_streaming_batcher
    from sky_embeddings_tpu_torch.data.synthetic import write_structured_h5, write_synthetic_h5
    from sky_embeddings_tpu_torch.configuration import apply_overrides

    repo = os.path.dirname(CONFIGS)
    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / "tiny_train.h5"), n=64, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(data / "tiny_val.h5"), n=32, channels=3, img_size=16, seed=2)
    write_structured_h5(str(data / "tiny_probe.h5"), 96, channels=3, img_size=16, seed=3)
    over = ["TRAINING.total_batch_iters=4", "TRAINING.batch_size=8", "TRAINING.tensor_parallel=2"]
    argv = ["mim_tiny", "-v", "2", "-ct", "100", "-dd", str(data), "--device", "cpu"]
    for o in over:
        argv += ["--set", o]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, SKY_DISTRIBUTED="1", SKY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   SKY_NUM_PROCESSES="2", SKY_PROCESS_ID=str(pid), OMP_NUM_THREADS="1",
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-c", TWIN, str(tmp_path), *argv], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
            assert p.returncode == 0, outs[-1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert "Batch Iterations: 4/4" in outs[0] and "lp acc" in outs[0]
    assert "Batch Iterations" not in outs[1]
    assert os.path.exists(tmp_path / "figures" / "mim_tiny_4iters.png")

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_mim._SIZES["base"], "depth", 2)
        cfg = apply_overrides(load_config("mim_tiny", CONFIGS), over[:2])
        batches = build_cached_or_streaming_batcher(
            cfg.data, str(data / "tiny_train.h5"), 8, img_size=16, shuffle=True,
            log_fn=lambda m: None, device="cpu").forever()
        one = MIMPretrainer(cfg, device="cpu")
        for _ in range(4):
            one.train_batch(next(batches))
        two = MIMPretrainer(cfg, device="cpu")
        assert two.restore(str(tmp_path / "models" / "mim_tiny.ckpt.pt")) and two.cur_iter == 4
    lr_sum = sum(one.schedule(t) for t in range(4))
    _held(tpw.state(two.model), tpw.state(one.model), lr_sum)


JEPA_TWIN = ("import sys; from sky_embeddings_tpu_torch.models import jepa; "
             f"jepa._SIZES['tiny'] = {JEPA_SMALL!r}; import torch; "
             "from sky_embeddings_tpu_torch import pretrain_jepa as t; t.REPO_DIR = sys.argv[1]; "
             "t.main(sys.argv[2:]); torch.distributed.destroy_process_group()")


def test_pretrain_jepa_twin_at_tensor_parallel_2(tmp_path):
    """``pretrain_jepa jepa_tiny --set TRAINING.tensor_parallel=2`` (depth 2,
    D = 64: the encoder split, the predictor whole; 4 steps, validation at
    steps 2 and 4) as two ``SKY_DISTRIBUTED`` processes: one data index, so
    both read the whole batches; process 0 alone logs and writes the whole
    checkpoint; its parameters and EMA target against one process trained
    on the same batches and mask draws: 1e-4 absolute, the key biases the
    summed lr, the MAE case's bars (measured on the CPU: 7.6e-6 at
    ``predictor.proj_in.kernel``, where Adam turns the encoder's split sums'
    rounding into a step error in proportion to lr over the 4 steps)."""
    import socket
    import subprocess
    import sys

    from sky_embeddings_tpu_torch.configuration import apply_overrides
    from sky_embeddings_tpu_torch.data.device_cache import build_cached_or_streaming_batcher
    from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5

    repo = os.path.dirname(CONFIGS)
    (tmp_path / "configs").symlink_to(CONFIGS)
    data = tmp_path / "data"
    data.mkdir()
    write_synthetic_h5(str(data / "tiny_train.h5"), n=64, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(data / "tiny_val.h5"), n=32, channels=3, img_size=16, seed=2)
    over = ["TRAINING.total_batch_iters=4", "TRAINING.batch_size=8", "TRAINING.tensor_parallel=2"]
    argv = ["jepa_tiny", "-v", "2", "-ct", "100", "-dd", str(data), "--device", "cpu"]
    for o in over:
        argv += ["--set", o]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, SKY_DISTRIBUTED="1", SKY_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   SKY_NUM_PROCESSES="2", SKY_PROCESS_ID=str(pid), OMP_NUM_THREADS="1",
                   PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-c", JEPA_TWIN, str(tmp_path), *argv],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
            assert p.returncode == 0, outs[-1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert "Batch Iterations: 4/4" in outs[0] and "val loss" in outs[0]
    assert "(2 processes)" in outs[0] and "Batch Iterations" not in outs[1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(port_jepa._SIZES, "tiny", dict(JEPA_SMALL))
        cfg = apply_overrides(load_config("jepa_tiny", CONFIGS), over[:2])
        batches = build_cached_or_streaming_batcher(
            cfg.data, str(data / "tiny_train.h5"), 8, img_size=16, shuffle=True,
            log_fn=lambda m: None, device="cpu").forever()
        one = JEPATrainer(cfg, device="cpu")
        for _ in range(4):
            one.train_batch(next(batches))
        two = JEPATrainer(cfg, device="cpu")
        assert two.restore(str(tmp_path / "models" / "jepa_tiny.ckpt.pt")) and two.cur_iter == 4
    lr_sum = sum(one.lr_schedule(t) for t in range(4))
    for got, want in ((two.model, one.model), (two.target, one.target)):
        rest, keys = param_gaps(tpw.state(got), tpw.state(want))
        assert rest <= 1e-4 and keys <= lr_sum, (rest, keys)
