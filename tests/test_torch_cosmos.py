"""The port's CosmicEmbeds and the small framework-free pieces beside it,
against the JAX package on the CPU.

CosmicEmbeds (``models/cosmos.py``) at ``tests/test_cosmos.py``'s TINY
geometry (16 x 16, patch 4, 3 bands, D = 48, depth 2, 4 heads; a pixel mean
and std that are not 0 and 1), from the flax params: ``generate`` with no
context, with a context and no mask, and with a context and a mask; the loss
with a NaN band in the target; every parameter's gradient against
``jax.grad``; three steps of ``torch.optim.Adam`` against
``optax.adam(3e-3)`` under the MSE and the L1 loss; the bf16 forward; the weights both ways. Then the
pos-embed tables and grid transfers (``models/pos_embed.py``: the 1-D table,
``interpolate_grid`` growing and shrinking the grid, ``central_crop_grid``,
each with and without a batch axis) and ``data/mask_generator.MaskGenerator``.

Bars: fp32 images and losses 1e-5 relative (max|a-b|/max|b| for images),
gradients ||a-b||/||b|| per leaf 1e-4, parameters 1e-4 absolute (the
other training tests' bars) after three steps (MSE) or one (L1, see
``test_three_adam_steps_match_optax``) but the key third of each qkv bias,
whose gradient is rounding noise (held to the steps' summed lr, as
``tests/test_torch_jepa.py`` holds it); bf16 images max-rel 2e-2;
``interpolate_grid`` 2e-6 of the table's largest value (summation order;
measured 1.0e-6 at worst over grids of 2 to 16 resized to 1 to 24); the
1-D table, the crops, the weights and the masks bit-equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from sky_embeddings_tpu.data.mask_generator import MaskGenerator as JaxMaskGenerator
from sky_embeddings_tpu.models import pos_embed as jpe
from sky_embeddings_tpu.models.cosmos import CosmicEmbeds as JaxCosmicEmbeds
from sky_embeddings_tpu_torch.data.mask_generator import MaskGenerator
from sky_embeddings_tpu_torch.models import pos_embed as tpe
from sky_embeddings_tpu_torch.models.cosmos import CosmicEmbeds
from sky_embeddings_tpu_torch.models.weights import params_from_jax, params_to_jax

TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=48, depth=2, num_heads=4,
            pixel_mean=0.05, pixel_std=0.8)
CONDS = ("none", "context", "masked")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(B=4, seed=0, nan=False):
    """target, RA/Dec, wavelengths and a pixel mask (1 = hidden; the right
    half hidden in every band, then a random quarter of the rest), numpy."""
    rng = np.random.default_rng(seed)
    target = rng.normal(size=(B, 3, 16, 16)).astype(np.float32)
    if nan:
        target[0, 1] = np.nan
    ra_dec = rng.uniform(0, 90, size=(B, 2)).astype(np.float32)
    waves = np.tile([480.0, 620.0, 770.0], (B, 1)).astype(np.float32)
    mask = (rng.random((B, 3, 16, 16)) < 0.25).astype(np.float32)
    mask[..., 8:] = 1.0
    return target, ra_dec, waves, mask


def _cond(cond, target, mask):
    return {"none": (), "context": (target,), "masked": (target, mask)}[cond]


def _models(dtype=jnp.float32, tdtype=torch.float32, seed=0, loss_fn="l1"):
    """The flax model, its params (numpy) and the port's model loaded from them."""
    target, ra_dec, waves, _ = _data()
    jm = JaxCosmicEmbeds(**TINY, dtype=dtype, loss_fn=loss_fn)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed), target, ra_dec,
                                                        waves)["params"])
    model = CosmicEmbeds(**TINY, dtype=tdtype, loss_fn=loss_fn)
    model.load_state_dict(params_from_jax(params))
    return jm, params, model


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("cond", CONDS)
def test_generate_matches_flax(cond):
    jm, params, model = _models()
    target, ra_dec, waves, mask = _data(seed=1)
    args = _cond(cond, target, mask)
    want = jm.apply({"params": params}, ra_dec, waves, *args, method=JaxCosmicEmbeds.generate)
    with torch.no_grad():
        got = model.generate(*_t(ra_dec, waves, *args))
    assert got.shape == (4, 3, 16, 16) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("cond", CONDS)
def test_loss_with_a_nan_band_and_every_gradient_match_jax(cond):
    """The loss (a NaN band in the target) and every leaf's gradient, which
    the loss reads (no context: all but ``patch_embed``; with a context and
    no mask: all but ``mask_token``)."""
    jm, params, model = _models()
    target, ra_dec, waves, mask = _data(seed=2, nan=True)
    args = _cond(cond, target, mask)
    want, jgrads = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, target, ra_dec, waves, *args))(params)
    jgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    loss = model(*_t(target, ra_dec, waves, *args))
    loss.backward()
    assert np.isfinite(float(want))
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))
    unread = {"none": "patch_embed.", "context": "mask_token", "masked": None}[cond]
    for name, p in model.named_parameters():
        if unread and name.startswith(unread):
            assert p.grad is None and not jgrads[name].any(), name
            continue
        g = p.grad
        assert g is not None and torch.isfinite(g).all(), name
        assert float((g - jgrads[name]).norm()) <= 1e-4 * float(jgrads[name].norm()) + 1e-12, name


@pytest.mark.parametrize("loss_fn", ["mse", "l1"])
def test_three_adam_steps_match_optax(loss_fn):
    """``tests/test_cosmos.py``'s step (``optax.adam(3e-3)`` on the loss)
    three times from the same params, against ``torch.optim.Adam`` at the
    same rate, a parameter the loss does not read given optax's zero
    gradient (which still counts a step); the steps take no context, the
    masked context and a context without a mask. Each step's loss within
    1e-5. The parameters within 1e-4 after the three steps under ``mse``;
    under ``l1`` (the default) after the first step only: the L1 gradient of
    a pixel is the sign of its error, so a prediction that lies within
    rounding of its target flips it in one framework and not the other, and
    Adam's normalised step turns that into a move of order lr (measured
    2.1e-3 after the third step of this seed, the losses still within
    2.8e-7)."""
    jm, params, model = _models(seed=3, loss_fn=loss_fn)
    batches = [_data(seed=10 + i) for i in range(3)]
    tx = optax.adam(3e-3)
    opt_state = tx.init(params)
    jp = params
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    D = TINY["embed_dim"]
    checked = 0
    for i, ((target, ra_dec, waves, mask), cond) in enumerate(zip(batches, ("none", "masked", "context"))):
        args = _cond(cond, target, mask)
        jloss, g = jax.value_and_grad(
            lambda p: jm.apply({"params": p}, target, ra_dec, waves, *args))(jp)
        updates, opt_state = tx.update(g, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        loss = model(*_t(target, ra_dec, waves, *args))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
        if i == (2 if loss_fn == "mse" else 0):
            # The key third of each qkv bias is the exception: softmax is
            # invariant to it, so its gradient is rounding noise in both
            # frameworks, and Adam's normalised step of that noise is
            # arbitrary up to lr a step. It is held to the steps' summed lr,
            # and its gradient shown to be that noise.
            kb = model.encoder.block0.attn.qkv.bias.grad.reshape(3, D)
            assert float(kb[1].norm()) < 1e-5 * float(kb[0].norm())
            want = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
            for name, p in model.state_dict().items():
                err = (p - want[name]).abs()
                if name.endswith("attn.qkv.bias"):
                    assert float(err[D:2 * D].max()) <= (i + 1) * 3e-3 + 1e-6, name
                    err = torch.cat([err[:D], err[2 * D:]])
                assert float(err.max()) <= 1e-4, name
            checked += 1
    assert checked == 1


@pytest.mark.parametrize("cond", CONDS)
def test_bf16_generate_matches_flax(cond):
    jm, params, model = _models(jnp.bfloat16, torch.bfloat16, seed=4)
    target, ra_dec, waves, mask = _data(seed=5)
    args = _cond(cond, target, mask)
    want = jm.apply({"params": params}, ra_dec, waves, *args, method=JaxCosmicEmbeds.generate)
    with torch.no_grad():
        got = model.generate(*_t(ra_dec, waves, *args))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got.numpy(), np.asarray(want, np.float32)) <= 2e-2


def test_weights_map_both_ways_exactly():
    """flax tree -> state dict -> tree, and a seeded port model's state dict
    -> tree -> state dict: the same names, shapes and values; the tree holds
    the JAX leaves and no more (the sin-cos table is a constant in both)."""
    _, params, model = _models(seed=5)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    back = dict(jax.tree_util.tree_flatten_with_path(params_to_jax(model.state_dict()))[0])
    assert {k for k, _ in flat} == set(back)
    for k, v in flat:
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    assert set(model.state_dict()) == set(params_from_jax(params))
    assert tuple(model.mask_token.shape) == (1, 1, 48) and tuple(model.pred.kernel.shape) == (48, 48)
    seeded = CosmicEmbeds(**TINY)
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    again = CosmicEmbeds(**TINY)
    again.load_state_dict(params_from_jax(params_to_jax(seeded.state_dict())))
    for k, v in seeded.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_reset_parameters_draws_flax_init_statistics():
    """A seeded model: xavier-uniform kernels within their bounds, zero
    biases, unit LN scales, the mask token at N(0, 0.02); finite images."""
    model = CosmicEmbeds(**{**TINY, "embed_dim": 64})
    model.reset_parameters(torch.Generator().manual_seed(1))
    sd = model.state_dict()
    bound = (6.0 / (64 + 48)) ** 0.5
    assert float(sd["pred.kernel"].abs().max()) <= bound and not sd["pred.bias"].any()
    assert torch.equal(sd["norm.scale"], torch.ones(64))
    assert 0.01 < float(sd["mask_token"].std()) < 0.03
    _, ra_dec, waves, _ = _data()
    with torch.no_grad():
        assert torch.isfinite(model.generate(*_t(ra_dec, waves))).all()


# -- pos-embed tables and grid transfers -------------------------------------------

@pytest.mark.parametrize("dim,length,prefix", [(64, 1, 0), (64, 7, 2), (10, 16, 1)])
def test_sincos_1d_bit_equal_to_jax(dim, length, prefix):
    got = tpe.sincos_pos_embed_1d(dim, length, prefix)
    assert got.dtype == np.float32 and np.array_equal(got, jpe.sincos_pos_embed_1d(dim, length, prefix))


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("old,new,prefix", [(4, 6, 1), (5, 8, 2), (4, 16, 0), (8, 5, 2), (6, 4, 1),
                                            (7, 3, 0), (8, 8, 2)])
def test_interpolate_grid_matches_jax(old, new, prefix, batch):
    """Growing the grid and shrinking it (JAX antialiases then), with and
    without a batch axis; prefix rows unchanged."""
    rng = np.random.default_rng(old * 31 + new)
    table = rng.normal(size=((3,) if batch else ()) + (prefix + old * old, 12)).astype(np.float32)
    want = np.asarray(jpe.interpolate_grid(jnp.asarray(table), new, prefix))
    got = tpe.interpolate_grid(table, new, prefix)
    assert tuple(got.shape) == want.shape == table.shape[:-2] + (prefix + new * new, 12)
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()
    assert np.array_equal(got.numpy()[..., :prefix, :], table[..., :prefix, :])


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("old,new,prefix", [(8, 4, 1), (7, 4, 2), (6, 6, 0), (5, 1, 1)])
def test_central_crop_grid_bit_equal_to_jax(old, new, prefix, batch):
    rng = np.random.default_rng(old * 7 + new)
    table = rng.normal(size=((2,) if batch else ()) + (prefix + old * old, 6)).astype(np.float32)
    want = np.asarray(jpe.central_crop_grid(jnp.asarray(table), new, prefix))
    assert np.array_equal(tpe.central_crop_grid(torch.from_numpy(table), new, prefix).numpy(), want)


def test_grid_transfers_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="not square"):
        tpe.interpolate_grid(np.zeros((1 + 10, 4), np.float32), 4, 1)
    with pytest.raises(ValueError, match="larger grid"):
        tpe.central_crop_grid(np.zeros((16, 4), np.float32), 5, 0)


# -- the SimMIM mask generator ------------------------------------------------------

@pytest.mark.parametrize("size,patch,ratio,chans", [(64, 8, 0.9, 1), (64, 8, 0.9, 5), (16, 4, 0.5, 3),
                                                    (192, 4, 0.9, 1)])
def test_mask_generator_bit_equal_to_jax(size, patch, ratio, chans):
    """The same generator state gives the same masks, call after call:
    (H, W) with one channel, (C, H, W) with more."""
    ours = MaskGenerator(size, patch, ratio, chans, rng=np.random.default_rng(7))
    ref = JaxMaskGenerator(size, patch, ratio, chans, rng=np.random.default_rng(7))
    for _ in range(4):
        a, b = ours(), ref()
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert a.shape == ((size, size) if chans == 1 else (chans, size, size))
        assert np.array_equal(a, b)
