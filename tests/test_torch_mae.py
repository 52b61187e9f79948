"""The port's MAE slice against the JAX package on the CPU: the MAE masking
ops; the packed-segment (``seg_len``) plain versions of kernels 1, 2 and 4
against the Pallas kernels in interpret mode (forwards) and ``jax.vjp`` of
``xla_attn_block(..., seg_len)`` (backwards), packed pairs of N=17 and four
packed at N=68; the port's packed block against its unpacked one; MAE
``SkyMIM`` (packed, ``maesimple``, the RA/Dec token at n=18, a ragged batch
that runs unpacked) against JAX ``SkyMIM(simmim=False, pack_tokens=4)`` with
the same ``mae_noise``; the weights of every MAE model type; and remat
against the stored path. The trainer and the CLI twins are in
tests/test_torch_mae_train.py.

Bars: kernels fp32 atol 2e-5, bf16 max|a-b|/max|b| 2e-2 forward and 3e-2
per gradient (tests/test_torch_kernels.py); the packed block against the
unpacked one fp32 atol 2e-5; the model loss rtol 1e-5 and pred atol 2e-5,
rtol 1e-4 (tests/test_full_model_parity.py), masks equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.models.mim import SkyMIM as JaxSkyMIM
from sky_embeddings_tpu.models.mim import build_mim_model as jax_build_mim_model
from sky_embeddings_tpu.ops import masking as jmask
from sky_embeddings_tpu.ops.kernels import attn_block as jab
from sky_embeddings_tpu_torch.configuration import Config
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.mim import SkyMIM, build_mim_model
from sky_embeddings_tpu_torch.models.weights import params_from_jax, params_to_jax
from sky_embeddings_tpu_torch.ops import masking as tmask
from sky_embeddings_tpu_torch.ops.kernels import attn_block as tab

TOL_F32, TOL_FWD, TOL_BWD = 2e-5, 2e-2, 3e-2
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_GRADS = ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj")


def _as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dtype, bar=TOL_FWD):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL_F32)
    else:
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
        assert rel <= bar, f"max-rel {rel:.3g} > {bar}"


# -- masking ops ------------------------------------------------------------------

def test_mae_masking_ops_match_jax():
    """The same noise keeps the same tokens (stable sorts), gives the same
    mask and restore indices; the unshuffle puts the kept tokens back beside
    the mask token exactly as JAX does. Drawn noise keeps the static count."""
    rng = np.random.default_rng(0)
    tokens = rng.normal(size=(5, 16, 8)).astype(np.float32)
    noise = rng.random((5, 16)).astype(np.float32)
    noise[1, 3] = noise[1, 7]  # a tie: the lower index is kept first in both
    want = jmask.mae_random_masking(None, jnp.asarray(tokens), 0.75, noise=jnp.asarray(noise))
    got = tmask.mae_random_masking(torch.from_numpy(tokens), 0.75, noise=torch.from_numpy(noise))
    assert got.tokens_kept.shape == (5, 4, 8) and got.mask.dtype == torch.float32
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dec = rng.normal(size=(5, 4, 6)).astype(np.float32)
    mtok = rng.normal(size=(1, 1, 6)).astype(np.float32)
    want = jmask.mae_unshuffle(jnp.asarray(dec), jnp.asarray(mtok), want.ids_restore)
    got = tmask.mae_unshuffle(torch.from_numpy(dec), torch.from_numpy(mtok), got.ids_restore)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = tmask.mae_random_masking(torch.from_numpy(tokens), 0.75,
                                     generator=torch.Generator().manual_seed(0))
    assert drawn.tokens_kept.shape == (5, 4, 8)
    assert drawn.mask.sum(dim=1).tolist() == [12.0] * 5


# -- the seg_len plain versions of kernels 1, 2 and 4 ------------------------------

def _block_inputs(dtype, B, N, D=64, seed=2):
    """(x, scale, bias, wqkv, bqkv, wproj, bproj) for JAX and the port; the
    activation and the two weight matrices in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [
        rng.normal(size=(B, N, D)).astype(np.float32) * 0.5,
        1.0 + 0.1 * rng.normal(size=D).astype(np.float32),
        0.1 * rng.normal(size=D).astype(np.float32),
        rng.normal(size=(D, 3 * D)).astype(np.float32) * 0.08,
        0.01 * rng.normal(size=3 * D).astype(np.float32),
        rng.normal(size=(D, D)).astype(np.float32) * 0.08,
        0.01 * rng.normal(size=D).astype(np.float32),
    ]
    cast = (0, 3, 5)
    j = [jnp.asarray(a).astype(_JDT[dtype]) if i in cast else jnp.asarray(a) for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(_TDT[dtype]) if i in cast else torch.from_numpy(a) for i, a in enumerate(arrs)]
    return j, t


# (samples, tokens per sample, samples packed per sequence): 4 packed pairs of
# N=17, and MAE's pack of 4 at N=68
PACKS = [(8, 17, 2), (8, 17, 4)]


def _packed_inputs(dtype, B, n, pack, seed):
    j, t = _block_inputs(dtype, B // pack, pack * n, seed=seed)
    g = np.random.default_rng(seed + 100).normal(size=(B // pack, pack * n, 64)).astype(np.float32)
    return j, t, jnp.asarray(g).astype(_JDT[dtype]), torch.from_numpy(g).to(_TDT[dtype])


def _pl(j):
    """The Pallas calls' (1, width) vectors."""
    return (j[0], j[1].reshape(1, -1), j[2].reshape(1, -1), j[3], j[4].reshape(1, -1), j[5],
            j[6].reshape(1, -1))


@pytest.mark.parametrize("B,n,pack", PACKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seg_forwards_match_pallas(dtype, B, n, pack):
    """Kernel 1 (K2) and kernel 2 with ``seg_len``: the primal, the stashed
    qkv and the stashed probabilities, zero outside each sample's block."""
    j, t, _, _ = _packed_inputs(dtype, B, n, pack, seed=31)
    S = B // pack
    want = jab._pallas_fwd(*_pl(j), 4, S, True, n)
    got = tab.attn_block_plain(*t, 4, n)
    assert got.shape == (S, pack * n, 64) and got.dtype == _TDT[dtype]
    _assert_close(got.float().numpy(), _as_np(want), dtype)
    jout, jqkv, jprobs = jab._pallas_fwd_stash(*_pl(j), 4, S, True, n)
    out, qkv, probs = tab.attn_block_fwd_stash_plain(*t, 4, n)
    for a, b in ((out, jout), (qkv, jqkv), (probs, jprobs)):
        _assert_close(a.float().numpy(), _as_np(b), dtype)
    seg = np.arange(pack * n) // n
    off = seg[:, None] != seg[None, :]
    assert (probs.float().numpy()[:, :, off] == 0).all()
    assert (_as_np(jprobs)[:, :, off] == 0).all()
    torch.testing.assert_close(out, got, rtol=0, atol=0)


@pytest.mark.parametrize("B,n,pack", PACKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seg_backwards_match_jax_vjp(dtype, B, n, pack):
    """Kernel 4's plain version with ``seg_len`` and kernel 3's from the
    packed stash (it takes no mask) against ``jax.vjp`` of
    ``xla_attn_block(..., seg_len)``."""
    j, t, jg, tg = _packed_inputs(dtype, B, n, pack, seed=32)
    _, vjp = jax.vjp(lambda *a: jab.xla_attn_block(*a, 4, n), *j)
    want = vjp(jg)
    _, qkv, probs = tab.attn_block_fwd_stash_plain(*t, 4, n)
    for got in (tab.attn_block_bwd_plain(*t[:6], tg, 4, n),
                tab.attn_block_bwd_stash_plain(t[0], t[1], t[2], t[3], t[5], qkv, probs, tg, 4)):
        for name, a, b, leaf in zip(_GRADS, got, want, t):
            assert a.dtype == leaf.dtype and a.shape == leaf.shape, name
            _assert_close(a.float().numpy(), _as_np(b), dtype, TOL_BWD)


@pytest.mark.parametrize("stash", [True, False])
@pytest.mark.parametrize("B,n,pack", PACKS + [(6, 18, 3)])
def test_packed_block_equals_unpacked(B, n, pack, stash):
    """``fused_attn_block(seg_len=n)`` over packed samples computes the
    unpacked block: the output and every gradient, fp32, through both
    autograd Functions (kernels 2 and 3; K2 and kernel 4)."""
    _, t = _block_inputs("float32", B, n, seed=33)
    g = torch.from_numpy(np.random.default_rng(34).normal(size=(B, n, 64)).astype(np.float32))
    runs = []
    for packed in (True, False):
        leaves = [a.clone().requires_grad_() for a in t]
        x = leaves[0].reshape(B // pack, pack * n, 64) if packed else leaves[0]
        out = tab.fused_attn_block(x, *leaves[1:], 4, stash=stash, seg_len=n if packed else 0)
        out = out.reshape(B, n, 64)
        out.backward(g)
        runs.append((out.detach(), [leaf.grad for leaf in leaves]))
    (oa, ga), (ob, gb) = runs
    np.testing.assert_allclose(oa.numpy(), ob.numpy(), atol=TOL_F32)
    for name, a, b in zip(_GRADS, ga, gb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL_F32, err_msg=name)
    # seg_len >= N is no mask
    torch.testing.assert_close(tab.attn_block_plain(*t, 4, n), tab.attn_block_plain(*t, 4),
                               rtol=0, atol=0)


# -- the model ----------------------------------------------------------------------

# img 32, patch 4: 64 patches, 16 kept, n = 17 tokens (18 with the RA/Dec token)
GEOM = dict(img_size=32, patch_size=4, in_chans=3, embed_dim=48, depth=2, num_heads=4)
DEC = dict(decoder_embed_dim=32, decoder_depth=2, decoder_num_heads=4)
CASES = {
    "packed": (dict(), 8),
    "maesimple": (dict(decoder_depth=1, decoder_num_heads=1), 8),
    "ra_dec": (dict(ra_dec=True), 8),
    "ragged_unpacked": (dict(), 6),
}


def _imgs(B, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 3, 32, 32)).astype(np.float32)
    x[0, 1] = np.nan  # a whole NaN band
    x[min(2, B - 1), 0, :5, :5] = np.nan
    rd = np.stack([rng.uniform(0, 360, B), rng.uniform(-90, 90, B)], 1).astype(np.float32)
    return x, rng.random((B, 64)).astype(np.float32), rd


def _jax_mae(kw, seed=0, geom=GEOM):
    """JAX MAE SkyMIM (pack_tokens 4, norm_pix_loss) and its params, every
    leaf perturbed."""
    model = JaxSkyMIM(**geom, **{**DEC, **kw}, simmim=False, pack_tokens=4, norm_pix_loss=True)
    x, noise, rd = _imgs(4, seed)
    extra = {"ra_dec": jnp.asarray(rd)} if model.ra_dec else {}
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x), mae_noise=jnp.asarray(noise),
                                 **extra)["params"]
    rng = np.random.default_rng(seed)
    return model, jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)).astype(np.float32), params)


def _port_mae(params, kw, **extra):
    model = SkyMIM(**GEOM, **{**DEC, **kw}, simmim=False, pack_tokens=4, norm_pix_loss=True, **extra)
    model.load_state_dict(params_from_jax(params))  # strict
    return model


@pytest.mark.parametrize("case", list(CASES))
def test_mae_model_matches_jax(case, monkeypatch):
    """``SkyMIM.forward`` against JAX ``SkyMIM.__call__`` from the same params
    and ``mae_noise`` (fp32): the mask equal, the loss and the patch
    predictions; the packed encoder runs N // n samples per sequence with
    ``seg_len = n`` (the ragged batch unpacked); ``encode`` without masking
    (serving) neither masks nor packs, as JAX."""
    kw, B = CASES[case]
    jmodel, params = _jax_mae(kw, seed=1)
    x, noise, rd = _imgs(B, seed=2)
    extra = {"ra_dec": rd} if kw.get("ra_dec") else {}
    jloss, jpred, jmask_ = jax.jit(jmodel.apply)(
        {"params": params}, jnp.asarray(x), mae_noise=jnp.asarray(noise),
        **{k: jnp.asarray(v) for k, v in extra.items()})
    model = _port_mae(params, kw)
    seen = []
    fwd = model.encoder.forward
    monkeypatch.setattr(model.encoder, "forward",
                        lambda h, seg_len=0: seen.append((tuple(h.shape), seg_len)) or fwd(h, seg_len))
    with torch.no_grad():
        loss, pred, mask = model(torch.from_numpy(x), mae_noise=torch.from_numpy(noise),
                                 **{k: torch.from_numpy(v) for k, v in extra.items()})
    n = 17 + bool(kw.get("ra_dec"))
    assert seen == ([((B // 4, 4 * n, 48), n)] if B % 4 == 0 else [((B, n, 48), 0)])
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask_))
    assert pred.shape == (B, 64, 48) and float(mask.sum()) == B * 48
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=2e-5, rtol=1e-4)

    want, _, _ = jax.jit(lambda p, *a, **k: jmodel.apply(p, *a, method=JaxSkyMIM.encode, **k))(
        {"params": params}, jnp.asarray(x), **{k: jnp.asarray(v) for k, v in extra.items()})
    seen.clear()
    with torch.inference_mode():
        tokens, m, ids = model.encode(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in extra.items()})
    assert m is None and ids is None and seen == [((B, 64 + n - 16, 48), 0)]
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want), atol=1e-5)


def test_mae_weights_of_every_model_type(monkeypatch):
    """``build_mim_model`` builds every MAE model type with the JAX tree's
    leaves, names and shapes (the JAX tree from ``jax.eval_shape``, so no
    weights are drawn there): the decoder, its blocks, ``mask_token``
    (1, 1, 512); ``maesimple``'s one-layer, one-head decoder; pack 4, mask
    ratio from [TRAINING]. A perturbed JAX params tree goes to the port and
    back bit for bit."""
    for size in ("base", "large", "huge"):  # depth 1: the names of every block are alike
        for mod in (jax_mim, port_mim):
            monkeypatch.setitem(mod._SIZES[size], "depth", 1)
    for model_type, width in (("base", 48), ("large", 64), ("huge", 64), ("maesimple", 48)):
        d = {"TRAINING": {"mask_ratio": "0.5"}, "ARCHITECTURE": dict(
            img_size="16", num_channels="3", embed_dim=str(width), patch_size="4",
            model_type=model_type)}
        port = build_mim_model(Config.from_dict(d), device="cpu")
        jmodel = jax_build_mim_model(JaxConfig.from_dict(d))
        x = jnp.zeros((2, 3, 16, 16), jnp.float32)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x,
                                mae_noise=jnp.zeros((2, 16), jnp.float32))["params"]
        want = {".".join(str(k.key) for k in path): tuple(leaf.shape)
                for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        assert got == want, model_type
        assert not port.simmim and port.pack_tokens == 4 and port.mask_ratio == 0.5
        dec_blocks = [getattr(port.decoder, f"block{i}") for i in range(port.decoder.depth)]
        want_dec = (1, 1) if model_type == "maesimple" else (8, 16)
        assert (port.decoder.depth, dec_blocks[0].num_heads) == want_dec
        assert port.mask_token.shape == (1, 1, 512) and dec_blocks[0].stash
    _, params = _jax_mae({}, seed=3)
    model = _port_mae(params, {})
    back = params_to_jax(model.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b) and any("decoder" in str(p[0]) for p, _ in flat_a)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_mae_remat_matches_the_stored_path_exactly():
    """MAE with remat (the packed encoder's blocks checkpointed, replayed
    with the same ``seg_len``; both stashes off) against the same model
    stored with the stashes off: the same loss and gradients, bit for bit."""
    _, params = _jax_mae({"ra_dec": True}, seed=4)
    x, noise, rd = _imgs(8, seed=5)
    runs = []
    for remat in (True, False):
        model = _port_mae(params, {"ra_dec": True}, remat=remat, stash=False).train()
        loss = model(torch.from_numpy(x), mae_noise=torch.from_numpy(noise), ra_dec=torch.from_numpy(rd))[0]
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()}))
    (la, ga), (lb, gb) = runs
    assert torch.equal(la, lb) and ga.keys() == gb.keys()
    for name, g in ga.items():
        assert g is not None and torch.equal(g, gb[name]), name
    assert float(ga["mask_token"].abs().max()) > 0
