"""The port's serving path against the JAX package on the CPU: similarity
scoring and running top-k, streaming search, embedding banks (and their
files), serving a model with the RA/Dec token, the HDF5 loader, the TTA
apply steps and the CLI twin. Inputs come from numpy seeds and go through
both packages with the same weights."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.models.mim import SkyMIM as JaxSkyMIM
from sky_embeddings_tpu.ops import similarity as jsim
from sky_embeddings_tpu_torch.models.mim import SkyMIM
from sky_embeddings_tpu_torch.models.weights import params_to_jax
from sky_embeddings_tpu_torch.ops import similarity as tsim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=48, depth=2, num_heads=4)


@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX variables, port model) sharing one set of fp32 weights."""
    jmodel = JaxSkyMIM(**TINY, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
    port = SkyMIM(**TINY).eval()
    port.reset_parameters(torch.Generator().manual_seed(3))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.state_dict()))
    return jmodel, {"params": params}, port


def _batches(n_batches, bs=8, seed=0, nan_frac=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        imgs = rng.normal(size=(bs, 3, 16, 16)).astype(np.float32)
        imgs[rng.random((bs, 3)) < nan_frac] = np.nan
        out.append({"cutouts": imgs, "ra_dec": rng.uniform(size=(bs, 2)).astype(np.float32)})
    return out


# -- scoring -------------------------------------------------------------------

def test_target_features_matches_jax():
    lat = np.random.default_rng(0).normal(size=(5, 7, 16)).astype(np.float32)
    jm, jw = jsim.target_features(jnp.asarray(lat))
    tm, tw = tsim.target_features(torch.from_numpy(lat))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("use_weights", [True, False])
@pytest.mark.parametrize("combine", ["mean", "min", "max"])
@pytest.mark.parametrize("metric", ["cosine", "MSE", "MAE"])
def test_compute_similarity_matches_jax(metric, combine, use_weights):
    rng = np.random.default_rng(1)
    tgt = rng.normal(size=(4, 6, 16)).astype(np.float32)
    test = rng.normal(size=(9, 6, 16)).astype(np.float32)
    kw = dict(metric=metric, combine=combine, use_weights=use_weights)
    want = jsim.compute_similarity(jnp.asarray(tgt), jnp.asarray(test), **kw)
    got = tsim.compute_similarity(torch.from_numpy(tgt), torch.from_numpy(test), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    want_top = jsim.compute_similarity(jnp.asarray(tgt), jnp.asarray(test), n_top_sims=3, **kw)
    got_top = tsim.compute_similarity(torch.from_numpy(tgt), torch.from_numpy(test), n_top_sims=3, **kw)
    np.testing.assert_allclose(got_top.numpy(), np.asarray(want_top), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("largest", [True, False])
def test_topk_update_tie_order_matches_lax_top_k(largest):
    """Ties resolve lowest index first, across the kept set and the batch."""
    scores = [np.array([0.5, 0.2, 0.5, 0.9, 0.2, 0.5], np.float32),
              np.array([0.5, 0.9, 0.2, 0.5], np.float32)]
    ids = [np.arange(6, dtype=np.int32), np.arange(6, 10, dtype=np.int32)]
    jstate = jsim.topk_init(5, {"id": jax.ShapeDtypeStruct((), jnp.int32)})
    tstate = tsim.topk_init(5, {"id": ((), torch.int32)}, "cpu")
    for s, i in zip(scores, ids):
        jstate = jsim.topk_update(jstate, jnp.asarray(s), {"id": jnp.asarray(i)}, largest)
        tstate = tsim.topk_update(tstate, torch.from_numpy(s), {"id": torch.from_numpy(i)}, largest)
    js, jp = jsim.topk_finalize(jstate, largest)
    ts, tp = tsim.topk_finalize(tstate, largest)
    np.testing.assert_array_equal(tp["id"].numpy(), np.asarray(jp["id"]))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _f32(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("largest", [True, False])
def test_topk_update_nan_order_matches_lax_top_k(largest):
    """NaN scores rank by the float total order, as ``lax.top_k`` ranks
    them: a NaN with the sign bit set (x86's 0/0) below -inf, one without it
    above +inf; the kept scores keep their bits, NaN signs included."""
    neg_nan, pos_nan = _f32(0xFFC00000), _f32(0x7FC00000)
    inf = np.float32(np.inf)
    scores = [np.array([-inf, -inf, neg_nan, 0.2, pos_nan, inf, -0.0, 0.0], np.float32),
              np.array([neg_nan, neg_nan, 0.5, pos_nan, -inf, 0.2], np.float32)]
    ids = [np.arange(8, dtype=np.int32), np.arange(8, 14, dtype=np.int32)]
    jstate = jsim.topk_init(7, {"id": jax.ShapeDtypeStruct((), jnp.int32)})
    tstate = tsim.topk_init(7, {"id": ((), torch.int32)}, "cpu")
    for s, i in zip(scores, ids):
        jstate = jsim.topk_update(jstate, jnp.asarray(s), {"id": jnp.asarray(i)}, largest)
        tstate = tsim.topk_update(tstate, torch.from_numpy(s), {"id": torch.from_numpy(i)}, largest)
        np.testing.assert_array_equal(tstate.payload["id"].numpy(), np.asarray(jstate.payload["id"]))
        np.testing.assert_array_equal(tstate.scores.numpy().view(np.uint32),
                                      np.asarray(jstate.scores).view(np.uint32))
    # the zero-variance case: x86's 0/0 is the negative NaN, so the empty
    # slots (-inf, payload zeros) outrank it
    state = tsim.topk_init(3, {"id": ((), torch.int32)}, "cpu")
    state = tsim.topk_update(state, torch.zeros(4) / torch.zeros(4), {"id": torch.arange(1, 5, dtype=torch.int32)})
    assert state.payload["id"].tolist() == [0, 0, 0] and bool(torch.isinf(state.scores).all())


# -- streaming search and banks --------------------------------------------------

def test_mim_simsearch_matches_jax(models):
    from sky_embeddings_tpu.eval.simsearch import mim_simsearch as jax_search
    from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents
    from sky_embeddings_tpu_torch.eval.simsearch import mim_simsearch

    jmodel, variables, port = models
    target = extract_latents(port, _batches(1, bs=3, seed=9), remove_prefix=False)
    batches = _batches(5)
    want = jax_search(jmodel, variables, target, batches, n_save=12, log_every=0)
    got = mim_simsearch(port, target, batches, n_save=12, log_every=0)
    np.testing.assert_array_equal(got[2], want[2])  # winners' ra/dec, best first
    np.testing.assert_allclose(got[3], want[3], atol=1e-5)  # scores
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)  # re-encoded features
    np.testing.assert_array_equal(got[0], want[0])  # images


def test_mim_simsearch_zero_variance_target_matches_jax(models):
    """One max-pooled target sample without augmentation has zero variance:
    its weights and every score are NaN in both packages, and the port keeps
    JAX's winners (the empty slots), not the NaN-scored cutouts."""
    from sky_embeddings_tpu.eval.simsearch import mim_simsearch as jax_search
    from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents
    from sky_embeddings_tpu_torch.eval.simsearch import mim_simsearch

    jmodel, variables, port = models
    target = extract_latents(port, _batches(1, bs=1, seed=4, nan_frac=0.0), remove_prefix=False)
    batches = _batches(3)
    kw = dict(n_save=6, max_pool=True, log_every=0)
    want = jax_search(jmodel, variables, target, batches, **kw)
    got = mim_simsearch(port, target, batches, **kw)
    np.testing.assert_array_equal(got[2], want[2])  # winners' ra/dec
    np.testing.assert_array_equal(got[3], want[3])  # scores, NaN where JAX has NaN
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("pool", ["mean", "max", "cls", "central"])
def test_build_bank_and_exact_query_match_jax(models, pool):
    from sky_embeddings_tpu.eval.bank import build_bank as jax_build
    from sky_embeddings_tpu_torch.eval.bank import build_bank
    from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents

    jmodel, variables, port = models
    batches = _batches(4, seed=2)
    jbank = jax_build(jmodel, variables, batches, pool=pool, dtype=jnp.float32)
    tbank = build_bank(port, batches, pool=pool, dtype=torch.float32)
    np.testing.assert_allclose(tbank.features.numpy(), jbank.features, atol=1e-4)
    np.testing.assert_allclose(tbank.mean, jbank.mean, atol=1e-5)
    np.testing.assert_allclose(tbank.std, jbank.std, rtol=1e-5)
    target = extract_latents(port, _batches(1, bs=3, seed=5), remove_prefix=False)
    js, ji = jbank.query(target, k=9, exact=True)
    ts, ti = tbank.query(target, k=9, exact=True)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(ts, np.asarray(js), atol=1e-5)


def test_ra_dec_model_serving_matches_jax():
    """A model with the RA/Dec token reads each batch's ra_dec in
    ``extract_latents`` (each TTA copy with its own sample's), in the
    streaming search (and the winners' re-encoding) and in ``build_bank``."""
    from sky_embeddings_tpu.eval.bank import build_bank as jax_build
    from sky_embeddings_tpu.eval.eval_fns import extract_latents as jax_extract
    from sky_embeddings_tpu.eval.simsearch import mim_simsearch as jax_search
    from sky_embeddings_tpu_torch.eval.bank import build_bank
    from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents
    from sky_embeddings_tpu_torch.eval.simsearch import mim_simsearch

    jmodel = JaxSkyMIM(**TINY, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2,
                       ra_dec=True)
    port = SkyMIM(**TINY, ra_dec=True).eval()
    port.reset_parameters(torch.Generator().manual_seed(4))
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.state_dict()))}
    batches = [dict(b, ra_dec=b["ra_dec"] * [360.0, 180.0] - [0.0, 90.0]) for b in _batches(4, seed=6)]
    want = jax_extract(jmodel, variables, batches[:1], remove_prefix=False)
    got = extract_latents(port, batches[:1], remove_prefix=False)
    assert got.shape == want.shape == (8, 18, 48)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    # with TTA the un-augmented copy of each sample leads its group of 1 + A
    tta = extract_latents(port, batches[:1], remove_prefix=False, apply_augmentations=True,
                          num_augmentations=2)
    np.testing.assert_allclose(tta[::3], np.asarray(want), atol=1e-4)
    target = got[:3]
    jres = jax_search(jmodel, variables, target, batches, n_save=10, log_every=0)
    tres = mim_simsearch(port, target, batches, n_save=10, log_every=0)
    np.testing.assert_array_equal(tres[2], jres[2])
    np.testing.assert_allclose(tres[3], jres[3], atol=1e-5)
    np.testing.assert_allclose(tres[1], jres[1], atol=1e-4)
    jbank = jax_build(jmodel, variables, batches, pool="mean", dtype=jnp.float32)
    tbank = build_bank(port, batches, pool="mean", dtype=torch.float32)
    assert tbank.n_extra == 2
    np.testing.assert_allclose(tbank.features.numpy(), jbank.features, atol=1e-4)


# -- bf16 search: the ranking of a bf16 model ---------------------------------------
#
# Each framework's own bf16 encoder rounds at other points (the tokens agree
# to max-rel 2e-2, test_torch_model.py), which moves bf16 scores by an ulp
# and so the ranks. These tests hand both searches the same bf16 tokens
# (a fixed tokenizer: the cutout's 16 patches of 48 values and their mean as
# the cls token, rounded to bf16) and hold the ranking itself.

class _JaxTokens:
    """JAX side of the shared tokenizer (the searches' ``model.apply``)."""

    num_extra_tokens, ra_dec = 1, False

    def apply(self, variables, imgs, method=None, **kw):
        B = imgs.shape[0]
        t = imgs.reshape(B, 3, 4, 4, 4, 4).transpose(0, 2, 4, 1, 3, 5).reshape(B, 16, 48)
        return jnp.concatenate([t.mean(1, keepdims=True), t], 1).astype(jnp.bfloat16)


class _PortTokens(torch.nn.Module):
    """The port's side: the same tokens, bit for bit (``model.encode``)."""

    num_extra_tokens, ra_dec = 1, False

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))  # the device the searches read

    def encode(self, imgs, ra_dec=None):
        B = imgs.shape[0]
        t = imgs.reshape(B, 3, 4, 4, 4, 4).permute(0, 2, 4, 1, 3, 5).reshape(B, 16, 48)
        return torch.cat([t.mean(1, keepdim=True), t], 1).to(torch.bfloat16), None, None


BF16_SEARCHES = {"default": dict(), "max_pool": dict(max_pool=True), "cls_token": dict(cls_token=True),
                 "mse": dict(metric="MSE"), "mae": dict(metric="MAE"), "mean": dict(combine="mean"),
                 "unweighted": dict(use_weights=False)}


@pytest.mark.parametrize("kw", BF16_SEARCHES.values(), ids=BF16_SEARCHES.keys())
def test_bf16_searches_rank_as_jax(kw):
    """A bf16 search, single (the serving twin's) and over 3 groups at once:
    the same 100 winners in the same order as JAX's ``mim_simsearch`` and
    ``mim_simsearch_multi`` (bf16 ties broken by the lower stream index, as
    ``lax.top_k``), with the same bf16 scores, bit for bit. The two JAX
    searches round their target statistics differently (inside and outside
    their compiled step), so each port search holds its own counterpart."""
    import ml_dtypes

    from sky_embeddings_tpu.eval.simsearch import mim_simsearch as jax_search
    from sky_embeddings_tpu.eval.simsearch import mim_simsearch_multi as jax_multi
    from sky_embeddings_tpu_torch.eval.simsearch import mim_simsearch, mim_simsearch_multi

    port = _PortTokens()
    batches = _batches(20, bs=16, nan_frac=0.0)
    targets = [port.encode(torch.from_numpy(b["cutouts"]))[0].float().numpy()
               for b in _batches(3, bs=3, seed=9, nan_frac=0.0)]
    kw = dict(kw, n_save=100, log_every=0)
    want = [jax_search(_JaxTokens(), {}, targets[0].astype(ml_dtypes.bfloat16), batches, **kw)]
    want += jax_multi(_JaxTokens(), {}, [t.astype(ml_dtypes.bfloat16) for t in targets], batches, **kw)
    got = [mim_simsearch(port, targets[0], batches, **kw)]
    got += mim_simsearch_multi(port, targets, batches, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[2], b[2])  # winners' ra/dec, best first
        np.testing.assert_array_equal(a[3], np.asarray(b[3], np.float32))  # bf16 scores
        np.testing.assert_array_equal(a[0], b[0])
    assert len(np.unique(want[0][3])) < 100  # genuine bf16 ties among the winners


def test_bf16_mean_bank_matches_jax():
    """``build_bank(pool="mean")`` on bf16 tokens pools in bf16, as JAX: the
    bank's statistics and bf16 rows bit for bit."""
    from sky_embeddings_tpu.eval.bank import build_bank as jax_build
    from sky_embeddings_tpu_torch.eval.bank import build_bank

    port = _PortTokens()
    batches = _batches(6, bs=16, seed=2, nan_frac=0.0)
    jbank = jax_build(_JaxTokens(), {}, batches, pool="mean")
    tbank = build_bank(port, batches, pool="mean")
    assert tbank.features.dtype == torch.bfloat16
    np.testing.assert_array_equal(tbank.mean, jbank.mean)
    np.testing.assert_array_equal(tbank.std, jbank.std)
    np.testing.assert_array_equal(tbank.features.view(torch.int16).numpy().view(np.uint16),
                                  jbank.features.view(np.uint16))


def test_bank_files_load_in_both_packages(models, tmp_path):
    """bf16 banks: a file written by either package loads in the other with
    the same bits, and both query the same winners."""
    from sky_embeddings_tpu.eval.bank import EmbeddingBank as JaxBank
    from sky_embeddings_tpu_torch.eval.bank import EmbeddingBank, build_bank
    from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents

    _, _, port = models
    bank = build_bank(port, _batches(4, seed=3), pool="mean")
    assert bank.features.dtype == torch.bfloat16
    ours = str(tmp_path / "port.h5")
    bank.save(ours)
    jbank = JaxBank.load(ours)
    assert str(jbank.features.dtype) == "bfloat16"
    np.testing.assert_array_equal(
        jbank.features.view(np.uint16), bank.features.view(torch.int16).numpy().view(np.uint16)
    )
    theirs = str(tmp_path / "jax.h5")
    jbank.save(theirs)
    back = EmbeddingBank.load(theirs, device="cpu")
    assert torch.equal(back.features, bank.features)
    assert back.pool == "mean" and back.n_extra == 1
    np.testing.assert_array_equal(back.ra_decs, bank.ra_decs)

    target = extract_latents(port, _batches(1, bs=3, seed=6), remove_prefix=False)
    ts, ti = back.query(target, k=8, exact=True)
    js, ji = jbank.query(target, k=8, exact=True)
    # JAX's bf16 path rounds w·t, w and the squares to bf16; the kernel's
    # math is fp32 on the upcast rows: scores agree at bf16 rounding level
    assert len(set(ti.tolist()) & set(np.asarray(ji).tolist())) >= 7
    np.testing.assert_allclose(np.sort(ts), np.sort(np.asarray(js)), atol=3e-3)


def test_query_raises_where_jax_takes_unported_routes(monkeypatch):
    """The routes that raised before the retrieval slice now answer as JAX's
    do: a bank of ``TWO_STAGE_MIN_ROWS`` rows takes the int8 two-stage
    scorer by default, and one over ``DEVICE_ROWS_LIMIT`` rows (lowered here
    in both packages) the chunked scorer; each gives JAX's winners."""
    from sky_embeddings_tpu.eval import bank as jbank_mod
    from sky_embeddings_tpu_torch.eval import bank as bank_mod

    n = bank_mod.TWO_STAGE_MIN_ROWS
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    args = (rng.uniform(size=(n, 2)).astype(np.float32), np.zeros(8), np.ones(8))
    bank = bank_mod.EmbeddingBank(torch.from_numpy(feats), *args, device="cpu")
    jbank = jbank_mod.EmbeddingBank(feats, *args)
    target = rng.normal(size=(2, 3, 8))
    for limit in (bank_mod.DEVICE_ROWS_LIMIT, n - 1):
        monkeypatch.setattr(bank_mod, "DEVICE_ROWS_LIMIT", limit)
        monkeypatch.setattr(jbank_mod, "DEVICE_ROWS_LIMIT", limit)
        ts, ti = bank.query(target, k=5)
        js, ji = jbank.query(target, k=5)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), atol=2e-5)
    assert bank._device_int8_bank is not None  # the first pass took the int8 route


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("indices", [None, [7, 3, 11, 0, 25, 26, 27]])
def test_h5_loader_matches_jax(tmp_path, indices):
    from sky_embeddings_tpu.data.h5_loader import build_h5_batcher as jax_batcher
    from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher
    from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5

    path = write_synthetic_h5(str(tmp_path / "s.h5"), n=30, channels=3, img_size=20, seed=2)
    kw = dict(batch_size=4, img_size=16, shuffle=indices is None, indices=indices,
              drop_remainder=False, seed=5)
    ours, ref = list(build_h5_batcher(path, **kw)), list(jax_batcher(path, **kw))
    assert len(ours) == len(ref) > 1
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_cutouts_match_jax():
    from sky_embeddings_tpu.data.synthetic import make_cutouts as jax_make
    from sky_embeddings_tpu_torch.data.synthetic import make_cutouts

    a, b = make_cutouts(6, seed=4), jax_make(6, seed=4)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


def test_augment_apply_steps_match_jax_augment_batch():
    """Feed the port's apply steps the values jax.random draws for the same
    key (redrawn here with augment_batch's key splits)."""
    from sky_embeddings_tpu.data.augment import augment_batch as jax_augment
    from sky_embeddings_tpu_torch.data import augment as A

    imgs = np.random.default_rng(3).normal(size=(6, 5, 16, 16)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_augment(key, jnp.asarray(imgs)))

    B, C = imgs.shape[:2]
    keys = jax.random.split(key, 5)
    kh, kv = jax.random.split(keys[0])
    k_area, k_ratio, k_y, k_x = jax.random.split(keys[1], 4)
    k_sigma, k_eps = jax.random.split(keys[3])
    k_n, k_pick = jax.random.split(keys[4])
    t = lambda a: torch.from_numpy(np.array(a))
    x = torch.from_numpy(imgs)
    x = A.apply_flips(x, t(jax.random.bernoulli(kh, 0.5, (B,))), t(jax.random.bernoulli(kv, 0.5, (B,))))
    x = A.apply_resized_crop(
        x,
        t(jax.random.uniform(k_area, (B,), minval=0.8, maxval=1.0)),
        t(jax.random.uniform(k_ratio, (B,), minval=jnp.log(0.9), maxval=jnp.log(1.1))),
        t(jax.random.uniform(k_y, (B,))), t(jax.random.uniform(k_x, (B,))),
    )
    x = A.apply_brightness(x, t(jax.random.uniform(keys[2], (B,), minval=0.8, maxval=1.0 / 0.8)))
    x = A.apply_noise(x, t(jax.random.uniform(k_sigma, (B,), minval=0.0, maxval=0.01)),
                      t(jax.random.normal(k_eps, imgs.shape)))
    x = A.apply_channel_nan(x, t(jax.random.randint(k_n, (B,), 0, 3)), t(jax.random.uniform(k_pick, (B, C))))
    got = x.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any()
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), atol=1e-5)

    # the draw steps give the same pipeline its inputs: shapes, NaN bands
    out = A.augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(imgs))
    assert out.shape == imgs.shape
    nan_bands = torch.isnan(out).all(dim=(2, 3)).sum(dim=1)
    assert int(nan_bands.max()) <= 2 and not torch.isnan(out[torch.isfinite(out).any(dim=(2, 3))]).all()


# -- the CLI twin ----------------------------------------------------------------

def test_cli_twin_matches_jax_library(tmp_path, models, monkeypatch):
    """``python -m sky_embeddings_tpu_torch.similarity_search mim_tiny
    --device cpu -aug False`` on synthetic files: its saved scores and
    winners equal the JAX library's on the CLI's own (fresh seeded) weights.
    The twin's root is a temporary directory (the configs linked, no
    checkpoint), where it writes its results and figures."""
    from sky_embeddings_tpu.eval.eval_fns import extract_latents as jax_extract
    from sky_embeddings_tpu.eval.simsearch import mim_simsearch as jax_search
    from sky_embeddings_tpu.data.h5_loader import build_h5_batcher
    from sky_embeddings_tpu_torch import similarity_search as cli
    from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5
    from sky_embeddings_tpu_torch.utils.misc import h5_snr

    (tmp_path / "configs").symlink_to(os.path.join(REPO, "configs"))
    monkeypatch.setattr(cli, "REPO_DIR", str(tmp_path))
    tgt = f"cli_tgt_{os.getpid()}.h5"
    write_synthetic_h5(str(tmp_path / tgt), n=6, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(tmp_path / "tst.h5"), n=40, channels=3, img_size=16, seed=2)
    out = cli.main(["mim_tiny", "-tgt_fn", tgt, "-tst_fn", "tst.h5", "-tgt_i", "[1,2]",
                    "-aug", "False", "-snr", "[-100,100]", "-bs", "8", "-ns", "10",
                    "-dd", str(tmp_path), "--device", "cpu"])
    try:
        res = dict(np.load(out))
    finally:
        os.remove(out)
    assert set(res) == {"test_ra_decs", "test_scores", "target_images", "target_features",
                        "test_images", "test_features"}

    model, config = cli.build_model_from_config(
        os.path.join(REPO, "configs"), str(tmp_path / "no_models"), "mim_tiny", "cpu")
    jmodel = JaxSkyMIM(img_size=16, patch_size=4, in_chans=3, embed_dim=48, depth=12,
                       num_heads=12, simmim=True)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))}
    snr = h5_snr(str(tmp_path / "tst.h5"))
    snr_min = np.nanmin(snr[:, :3], axis=1)
    idx = np.where((snr_min > -100) & (snr_min < 100))[0]
    tb = build_h5_batcher(str(tmp_path / tgt), batch_size=8, img_size=16, shuffle=False,
                          indices=[1, 2], drop_remainder=False)
    sb = build_h5_batcher(str(tmp_path / "tst.h5"), batch_size=8, img_size=16, shuffle=False,
                          indices=idx, drop_remainder=False)
    target = jax_extract(jmodel, variables, tb, remove_prefix=False)
    np.testing.assert_allclose(res["target_features"], target, atol=1e-4)
    _, _, ra, scores = jax_search(jmodel, variables, target, sb, n_save=10, max_pool=True,
                                  log_every=0)
    np.testing.assert_array_equal(res["test_ra_decs"], ra)
    # depth 12 (the config's zoo depth) of fp32 sums taken in another order
    np.testing.assert_allclose(res["test_scores"], scores, atol=5e-5)
