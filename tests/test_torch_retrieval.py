"""The port's survey-retrieval path against the JAX package on the CPU: the
multi-query scorer (kernel 11's plain version against the Pallas kernel in
interpret mode), the int8 two-stage and chunked scorers, the embedding
bank's routes, ``query_multi`` and lazy banks, multi-target streaming
search, the FITS reader and tile batcher, the ``sky_sim_search`` twin and
the serving twin's bank mode on the int8 route. Inputs come from numpy seeds
and go through both packages with the same weights.

Tolerances: fp32 scores atol 2e-5 (``tests/test_kernels.py``), streaming
search scores 1e-5, indices equal (the inputs are random floats, so there
are no ties for the two top-k orders to break differently)."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.models.mim import SkyMIM as JaxSkyMIM
from sky_embeddings_tpu.ops.kernels import simscore as jss
from sky_embeddings_tpu_torch.models.mim import SkyMIM
from sky_embeddings_tpu_torch.models.weights import params_to_jax
from sky_embeddings_tpu_torch.ops.kernels import simscore as tss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=48, depth=2, num_heads=4)
ATOL = 2e-5

t = torch.from_numpy
j = jnp.asarray


def _queries(rng, q, d):
    return (rng.normal(size=(q, d)).astype(np.float32),
            (rng.random((q, d)) + 0.1).astype(np.float32))


def _bf16_round(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


# -- kernel 11 and the scorers around it ------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_multi_scores_plain_matches_the_pallas_kernel(bf16):
    """Kernel 11's plain version against ``weighted_bank_scores_multi_pallas``
    (interpret mode) and the XLA formulation; a bf16 bank is read in its
    storage dtype by the port and cast to fp32 by JAX."""
    rng = np.random.default_rng(11)
    bank = rng.normal(size=(300, 64)).astype(np.float32)
    targets, weights = _queries(rng, 5, 64)
    if bf16:
        bank = _bf16_round(bank)
        stored = t(bank).to(torch.bfloat16)
        jbank = j(bank).astype(jnp.bfloat16)
    else:
        stored, jbank = t(bank), j(bank)
    got = tss.weighted_bank_scores_multi(stored, t(targets), t(weights))
    assert got.shape == (300, 5) and got.dtype == torch.float32
    pallas = jss.weighted_bank_scores_multi_pallas(jbank, j(targets), j(weights), interpret=True)
    xla = jss.weighted_bank_scores_multi_xla(j(bank), j(targets), j(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=ATOL)
    for q in range(5):  # each column is the single-target scorer's
        one = tss.weighted_bank_scores(stored, t(targets[q]), t(weights[q]))
        np.testing.assert_allclose(got[:, q].numpy(), one.numpy(), atol=ATOL)


def test_bank_topk_multi_matches_jax():
    rng = np.random.default_rng(12)
    bank = rng.normal(size=(200, 32)).astype(np.float32)
    targets, weights = _queries(rng, 3, 32)
    jv, ji = jss.bank_topk_multi(j(bank), j(targets), j(weights), 7)
    tv, ti = tss.bank_topk_multi(t(bank), t(targets), t(weights), 7)
    assert tv.shape == ti.shape == (3, 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_quantize_bank_int8_is_bit_equal_to_jax():
    rng = np.random.default_rng(23)
    rows = rng.normal(size=(500, 48)).astype(np.float32)
    rows[3] = 0.0  # the max(scale, 1e-30) guard
    rows[7, :5] = [0.5, -0.5, 1.5, 2.5, 127 / 254]  # ties that round half to even
    jb8, jrn = jss.quantize_bank_int8(j(rows))
    tb8, trn = tss.quantize_bank_int8(t(rows))
    assert tb8.dtype == torch.int8
    np.testing.assert_array_equal(tb8.numpy(), np.asarray(jb8))
    np.testing.assert_array_equal(trn.numpy(), np.asarray(jrn))
    # a bf16 bank quantises from its upcast values
    jb8, _ = jss.quantize_bank_int8(j(rows).astype(jnp.bfloat16))
    tb8, _ = tss.quantize_bank_int8(t(rows).to(torch.bfloat16))
    np.testing.assert_array_equal(tb8.numpy(), np.asarray(jb8))


def test_bank_topk_int8_matches_jax():
    rng = np.random.default_rng(22)
    bank = rng.normal(size=(20000, 64)).astype(np.float32)
    target = rng.normal(size=64).astype(np.float32)
    weights = (rng.random(64) + 0.1).astype(np.float32)
    jb8, jrn = jss.quantize_bank_int8(j(bank))
    jv, ji = jss.bank_topk_int8(jb8, jrn, j(bank), j(target), j(weights), 300, oversample=2048)
    tb8, trn = tss.quantize_bank_int8(t(bank))
    tv, ti = tss.bank_topk_int8(tb8, trn, t(bank), t(target), t(weights), 300, oversample=2048)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_bank_topk_multi_int8_matches_jax():
    rng = np.random.default_rng(31)
    bank = rng.normal(size=(20000, 64)).astype(np.float32)
    targets, weights = _queries(rng, 5, 64)
    jb8, jrn = jss.quantize_bank_int8(j(bank))
    jv, ji = jss.bank_topk_multi_int8(jb8, jrn, j(bank), j(targets), j(weights), 100,
                                      oversample=2048)
    tb8, trn = tss.quantize_bank_int8(t(bank))
    tv, ti = tss.bank_topk_multi_int8(tb8, trn, t(bank), t(targets), t(weights), 100,
                                      oversample=2048)
    assert tv.shape == ti.shape == (5, 100)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


@pytest.mark.parametrize("case", ["ragged_tail", "all_negative"])
def test_bank_topk_chunked_matches_jax(case):
    """JAX's two chunked cases: 5000 x 32 in slabs of 700 (a ragged tail),
    and an anti-aligned 1100 x 32 bank in slabs of 1000, whose tail slab is
    90% zero padding that scores 0 and must not beat the negative cosines."""
    if case == "ragged_tail":
        rng = np.random.default_rng(15)
        bank = rng.normal(size=(5000, 32)).astype(np.float32)
        target = rng.normal(size=32).astype(np.float32)
        weights = (rng.random(32) + 0.1).astype(np.float32)
        k, slab = 50, 700
    else:
        rng = np.random.default_rng(17)
        target = rng.normal(size=32).astype(np.float32)
        bank = (-target[None, :] + 0.05 * rng.normal(size=(1100, 32))).astype(np.float32)
        weights = (rng.random(32) + 0.1).astype(np.float32)
        k, slab = 40, 1000
    jv, ji = jss.bank_topk_chunked(bank, j(target), j(weights), k, slab_rows=slab)
    for host in (bank, t(bank)):  # a numpy bank and a tensor bank
        tv, ti = tss.bank_topk_chunked(host, t(target), t(weights), k, slab_rows=slab)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, atol=ATOL)
    if case == "all_negative":
        assert tv[0] < 0  # the scenario is real
    mv, mi = tss.bank_topk(t(bank), t(target), t(weights), k)
    np.testing.assert_array_equal(ti, mi.numpy())


# -- embedding banks ----------------------------------------------------------------

def _bank_pair(n, d, seed, dtype=np.float32):
    """(JAX bank, port bank) over the same (n, d) features and stats."""
    from sky_embeddings_tpu.eval.bank import EmbeddingBank as JaxBank
    from sky_embeddings_tpu_torch.eval.bank import EmbeddingBank

    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, d)).astype(np.float32)
    ra = rng.uniform(size=(n, 2)).astype(np.float32)
    mean, std = rng.normal(size=d) * 0.1, rng.uniform(0.5, 1.5, size=d)
    return (JaxBank(feats, ra, mean, std),
            EmbeddingBank(t(feats), ra, mean, std, device="cpu"))


def _target_groups(rng, g, d):
    return [rng.normal(size=(3, 5, d)).astype(np.float32) for _ in range(g)]


@pytest.mark.parametrize("use_weights", [True, False])
def test_bank_query_routes_match_jax(use_weights):
    """A 70 000-row bank (over ``TWO_STAGE_MIN_ROWS``): ``query`` on its
    default route (int8 two-stage, oversample 8192) and exact, and
    ``query_multi`` on both routes, give JAX's indices and scores."""
    from sky_embeddings_tpu_torch.eval.bank import TWO_STAGE_MIN_ROWS

    jbank, tbank = _bank_pair(70_000, 32, seed=40)
    assert tbank.features.shape[0] >= TWO_STAGE_MIN_ROWS
    groups = _target_groups(np.random.default_rng(41), 4, 32)
    for exact in (False, True):
        js, ji = jbank.query(groups[0], k=300, use_weights=use_weights, exact=exact)
        ts, ti = tbank.query(groups[0], k=300, use_weights=use_weights, exact=exact)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), atol=ATOL)
        js, ji = jbank.query_multi(groups, k=300, use_weights=use_weights, exact=exact)
        ts, ti = tbank.query_multi(groups, k=300, use_weights=use_weights, exact=exact)
        assert ts.shape == ti.shape == (4, 300)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        np.testing.assert_allclose(ts, np.asarray(js), atol=ATOL)
    # the int8 route is the default one
    assert tbank._device_int8_bank is not None


def test_lazy_bank_streams_from_disk(tmp_path):
    """A bf16 bank saved by the port and loaded lazily (features stay on
    disk, queries take the chunked route) answers as the in-memory bank;
    JAX's lazy view of the same file holds the same bits."""
    from sky_embeddings_tpu.eval.bank import EmbeddingBank as JaxBank
    from sky_embeddings_tpu_torch.eval.bank import EmbeddingBank, _DiskFeatures

    rng = np.random.default_rng(42)
    feats = t(rng.normal(size=(3000, 16)).astype(np.float32)).to(torch.bfloat16)
    bank = EmbeddingBank(feats, rng.uniform(size=(3000, 2)).astype(np.float32),
                         np.zeros(16), np.ones(16), pool="max", device="cpu")
    path = str(tmp_path / "bank.h5")
    bank.save(path)
    lazy = EmbeddingBank.load(path, device="cpu", lazy=True)
    assert isinstance(lazy.features, _DiskFeatures) and lazy.pool == "max"
    assert torch.equal(lazy.features[100:200], feats[100:200])
    jlazy = JaxBank.load(path, lazy=True)
    np.testing.assert_array_equal(np.asarray(jlazy.features[5:9]).view(np.uint16),
                                  feats[5:9].view(torch.int16).numpy().view(np.uint16))
    target = rng.normal(size=(4, 3, 16)).astype(np.float32)
    ls, li = lazy.query(target, k=25)
    ms, mi = EmbeddingBank.load(path, device="cpu").query(target, k=25)
    np.testing.assert_array_equal(li, mi)
    np.testing.assert_array_equal(ls, ms)
    with pytest.raises(ValueError, match="device-resident"):
        lazy.query_multi([target, target], k=5)


# -- multi-target streaming search ---------------------------------------------

@pytest.fixture(scope="module")
def models():
    """(JAX model, JAX variables, port model) sharing one set of fp32 weights."""
    jmodel = JaxSkyMIM(**TINY, decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
    port = SkyMIM(**TINY).eval()
    port.reset_parameters(torch.Generator().manual_seed(3))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.state_dict()))
    return jmodel, {"params": params}, port


def _batches(n_batches, bs=8, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        imgs = rng.normal(size=(bs, 3, 16, 16)).astype(np.float32)
        imgs[rng.random((bs, 3)) < 0.1] = np.nan
        out.append({"cutouts": imgs, "ra_dec": rng.uniform(size=(bs, 2)).astype(np.float32)})
    return out


def test_mim_simsearch_multi_matches_jax_and_single_searches(models):
    """G = 3 groups in one pass: each group's winners, scores and images as
    JAX's ``mim_simsearch_multi`` and as the port's single ``mim_simsearch``."""
    from sky_embeddings_tpu.eval.simsearch import mim_simsearch_multi as jax_multi
    from sky_embeddings_tpu_torch.eval.eval_fns import extract_latents
    from sky_embeddings_tpu_torch.eval.simsearch import mim_simsearch, mim_simsearch_multi

    jmodel, variables, port = models
    targets = [extract_latents(port, _batches(1, bs=2 + g, seed=20 + g), remove_prefix=False)
               for g in range(3)]
    batches = _batches(6, seed=7)
    kw = dict(n_save=12, max_pool=True, log_every=0)
    want = jax_multi(jmodel, variables, targets, batches, **kw)
    got = mim_simsearch_multi(port, targets, batches, **kw)
    assert len(got) == len(want) == 3
    for g, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a[2], b[2])  # winners' ra/dec, best first
        np.testing.assert_allclose(a[3], b[3], atol=1e-5)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_allclose(a[1], b[1], atol=1e-4)
        single = mim_simsearch(port, targets[g], batches, **kw)
        for x, y in zip(a, single):
            np.testing.assert_array_equal(x, y)


# -- FITS ---------------------------------------------------------------------------

def _write_tiles(root, wcs_mod, bands=("G", "R", "I"), n_tiles=2, size=(64, 72), seed=3):
    """Tiles of ``size`` pixels, one file per band, HSC calexp names, TAN WCS
    cards around RA 150, Dec 2.2; the R band of the last tile is missing."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    scale = 0.168 / 3600.0
    for i in range(n_tiles):
        wcs = wcs_mod.TanWCS(crpix=(30.5, 40.5), crval=(150.1 + 0.01 * i, 2.2),
                             cd=[[-scale, 0.0], [0.0, scale]])
        for c, band in enumerate(bands):
            if band == "R" and i == n_tiles - 1:
                continue
            data = rng.normal(size=size).astype(np.float32) + c
            wcs_mod.write_image(os.path.join(root, f"calexp-HSC-{band}-9813-{i},4.fits"), data,
                                wcs.to_cards())
    return root


def test_fits_reader_and_tile_batcher_match_jax(tmp_path):
    from sky_embeddings_tpu.data import fits_io as jio
    from sky_embeddings_tpu.data import fits_loader as jfl
    from sky_embeddings_tpu_torch.data import fits_io as tio
    from sky_embeddings_tpu_torch.data import fits_loader as tfl

    root = _write_tiles(str(tmp_path / "port"), tio)
    jroot = _write_tiles(str(tmp_path / "jax"), jio)
    for name in sorted(os.listdir(root)):  # the writers give the same bytes
        with open(os.path.join(root, name), "rb") as a, open(os.path.join(jroot, name), "rb") as b:
            assert a.read() == b.read(), name
    path = os.path.join(root, sorted(os.listdir(root))[0])
    (tdata, thead), (jdata, jhead) = tio.read_image(path), jio.read_image(path)
    np.testing.assert_array_equal(tdata, jdata)
    assert thead == jhead
    xs, ys = np.meshgrid(np.arange(0.0, 72.0, 7.5), np.arange(0.0, 64.0, 5.5))
    tw, jw = tio.TanWCS.from_header(thead), jio.TanWCS.from_header(jhead)
    for a, b in zip(tw.pixel_to_world(xs, ys), jw.pixel_to_world(xs, ys)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for a, b in zip(tw.world_to_pixel(*tw.pixel_to_world(xs, ys)), (xs, ys)):
        np.testing.assert_allclose(a, b, atol=1e-6)

    kw = dict(bands=("G", "R", "I"), min_bands=2, batch_size=8, img_size=16,
              shuffle=False, use_overlap=True, overlap=0.4)
    ours = list(tfl.build_fits_batcher([root], **kw))
    ref = list(jfl.build_fits_batcher([root], **kw))
    assert len(ours) == len(ref) == 2 * (len(tfl.overlap_coords((64, 72), 16, 0.4)) // 8)
    assert any(np.isnan(b["cutouts"][:, 1]).all() for b in ours)  # the missing band
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["cutouts"], b["cutouts"])
        np.testing.assert_allclose(a["ra_dec"], b["ra_dec"], atol=1e-6)


def test_fits_reader_thread_reraises_in_the_consumer(tmp_path):
    from sky_embeddings_tpu_torch.data import fits_io as tio
    from sky_embeddings_tpu_torch.data.fits_loader import FitsTileBatcher

    root = _write_tiles(str(tmp_path), tio)
    for band in ("G", "R", "I"):  # a tile none of whose files is FITS
        with open(os.path.join(root, f"calexp-HSC-{band}-9813-7,7.fits"), "wb") as f:
            f.write(b"not a FITS file")
    batcher = FitsTileBatcher([root], bands=("G", "R", "I"), min_bands=2, img_size=16,
                              batch_size=8, use_overlap=True, overlap=0.4, shuffle=False)
    with pytest.raises(ValueError, match="no readable band"):
        list(batcher)


# -- the CLI twins --------------------------------------------------------------------

def _twin_setup(tmp_path, monkeypatch, module):
    """``module.REPO_DIR`` -> ``tmp_path`` (configs linked, no checkpoint, so
    ``mim_tiny`` gets fresh seeded weights); returns (port model, JAX model,
    JAX variables) with those weights."""
    from sky_embeddings_tpu_torch import similarity_search as serving

    os.symlink(os.path.join(REPO, "configs"), tmp_path / "configs")
    monkeypatch.setattr(module, "REPO_DIR", str(tmp_path))
    model, _ = serving.build_model_from_config(
        os.path.join(REPO, "configs"), str(tmp_path / "models"), "mim_tiny", "cpu")
    jmodel = JaxSkyMIM(img_size=16, patch_size=4, in_chans=3, embed_dim=48, depth=12,
                       num_heads=12, simmim=True)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))}
    return model, jmodel, variables


@pytest.mark.parametrize("mode", ["bank", "stream"])
def test_sky_sim_search_twin_matches_jax(tmp_path, monkeypatch, mode):
    """``python -m sky_embeddings_tpu_torch.sky_sim_search mim_tiny -tgt_i
    [[1,2],[4,5]] -fits [...] --device cpu -aug False`` over two FITS tiles:
    each group's saved results against JAX's ``bank_sky_search`` (bank
    mode; bf16 banks, so scores agree at bf16 rounding) or
    ``mim_simsearch_multi`` (streaming)."""
    from sky_embeddings_tpu.data.fits_loader import build_fits_batcher as jax_batcher
    from sky_embeddings_tpu.eval.eval_fns import extract_latents as jax_extract
    from sky_embeddings_tpu.eval.simsearch import mim_simsearch_multi as jax_multi
    from sky_embeddings_tpu_torch import sky_sim_search as twin
    from sky_embeddings_tpu_torch.data import fits_io as tio
    from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher
    from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5

    sys.path.insert(0, REPO)
    import sky_sim_search as jax_cli

    model, jmodel, variables = _twin_setup(tmp_path, monkeypatch, twin)
    tiles = _write_tiles(str(tmp_path / "tiles"), tio)
    write_synthetic_h5(str(tmp_path / "tgt.h5"), n=6, channels=3, img_size=16, seed=1)
    argv = ["mim_tiny", "-tgt_fn", "tgt.h5", "-tgt_i", "[[1,2],[4,5]]", "-aug", "False",
            "-fits", repr([tiles]), "-bs", "8", "-ns", "10", "-dd", str(tmp_path),
            "--device", "cpu"]
    if mode == "bank":
        argv += ["-bank", "sky_bank.h5"]
    outs = twin.main(argv)
    assert [os.path.basename(o) for o in outs] == [
        f"mim_tiny_tgt_g{g}_skysearch_results.npz" for g in range(2)]
    res = [dict(np.load(o)) for o in outs]

    targets = [jax_extract(jmodel, variables,
                           build_h5_batcher(str(tmp_path / "tgt.h5"), batch_size=8, img_size=16,
                                            shuffle=False, indices=idx, drop_remainder=False),
                           remove_prefix=False) for idx in ([1, 2], [4, 5])]
    stream = jax_batcher([tiles], bands=["G", "R", "I"], min_bands=2, batch_size=8, img_size=16,
                         shuffle=False, use_overlap=True, overlap=0.4)
    if mode == "bank":
        assert os.path.exists(tmp_path / "results" / "sky_bank.h5")
        want = jax_cli.bank_sky_search(jmodel, variables, targets, stream,
                                       str(tmp_path / "jax_bank.h5"),
                                       SimpleNamespace(cls_token="False", max_pool="True", n_save=10))
        for r, (ra, scores, feats) in zip(res, want):
            assert set(r) == {"test_ra_decs", "test_scores", "target_images", "target_features",
                              "test_features"}
            # JAX's bf16 scorer rounds w·t, w and the squares to bf16
            np.testing.assert_allclose(np.sort(r["test_scores"]), np.sort(scores), atol=3e-3)
            same = {tuple(x) for x in r["test_ra_decs"].tolist()} & {tuple(x) for x in ra.tolist()}
            assert len(same) >= 8
        # a second run reuses the saved bank and answers the same
        again = [dict(np.load(o)) for o in twin.main(argv)]
        for a, b in zip(again, res):
            np.testing.assert_array_equal(a["test_ra_decs"], b["test_ra_decs"])
    else:
        want = jax_multi(jmodel, variables, targets, stream, n_save=10, max_pool=True,
                         log_every=0)
        for r, (imgs, _, ra, scores) in zip(res, want):
            np.testing.assert_array_equal(r["test_ra_decs"], ra)
            np.testing.assert_array_equal(r["test_images"], imgs)
            # depth 12 (the config's zoo depth) of fp32 sums taken in another order
            np.testing.assert_allclose(r["test_scores"], scores, atol=5e-5)
    for r, tgt in zip(res, targets):
        np.testing.assert_allclose(r["target_features"], tgt, atol=1e-4)


def test_serving_twin_bank_mode_takes_the_int8_route(tmp_path, monkeypatch):
    """The serving twin's ``-bank`` on a bank above ``TWO_STAGE_MIN_ROWS``
    (lowered to 16 rows here, in both packages) answers on the default int8
    route with the winners JAX's bank gives from the same file."""
    from sky_embeddings_tpu.eval import bank as jbank_mod
    from sky_embeddings_tpu_torch import similarity_search as cli
    from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5
    from sky_embeddings_tpu_torch.eval import bank as tbank_mod
    from sky_embeddings_tpu_torch.eval.bank import EmbeddingBank

    monkeypatch.setattr(tbank_mod, "TWO_STAGE_MIN_ROWS", 16)
    monkeypatch.setattr(jbank_mod, "TWO_STAGE_MIN_ROWS", 16)
    calls = []
    real = tbank_mod.bank_topk_int8
    monkeypatch.setattr(tbank_mod, "bank_topk_int8", lambda *a, **k: calls.append(1) or real(*a, **k))
    model, _, _ = _twin_setup(tmp_path, monkeypatch, cli)
    write_synthetic_h5(str(tmp_path / "tgt.h5"), n=6, channels=3, img_size=16, seed=1)
    write_synthetic_h5(str(tmp_path / "tst.h5"), n=40, channels=3, img_size=16, seed=2)
    argv = ["mim_tiny", "-tgt_fn", "tgt.h5", "-tst_fn", "tst.h5", "-tgt_i", "[1,2]", "-aug",
            "False", "-snr", "[-100,100]", "-bs", "8", "-ns", "10", "-dd", str(tmp_path),
            "-bank", "bank.h5", "--device", "cpu"]
    res = dict(np.load(cli.main(argv)))
    assert calls == [1]
    bank_path = str(tmp_path / "results" / "bank.h5")
    bank = EmbeddingBank.load(bank_path, device="cpu")
    assert bank.features.shape[0] == 40 > tbank_mod.TWO_STAGE_MIN_ROWS
    js, ji = jbank_mod.EmbeddingBank.load(bank_path).query(res["target_features"], k=10)
    np.testing.assert_array_equal(res["test_ra_decs"], bank.ra_decs[np.asarray(ji)])
    np.testing.assert_allclose(res["test_scores"], np.asarray(js), atol=ATOL)
