"""The port's offline data stages (``sky_embeddings_tpu_torch/data_processing``)
against the JAX package's on one synthetic FITS survey (two patches of
three HSC bands, TAN WCS, written with the port's ``data/fits_io.write_image``)
and catalogues built here: the parsed CSV catalogue, each patch's cutouts,
the created, combined, deduplicated, split and probe h5 files array for
array, the split and probe indices, the pixel scale, the cross-match masks
and the per-class and exported CSV text byte for byte; and without h5py
every stage that reads or writes h5 raises ``ImportError`` naming it.
"""

import os
import sys

import h5py
import numpy as np
import pytest

from sky_embeddings_tpu.data_processing import combine as j_combine
from sky_embeddings_tpu.data_processing import create_h5 as j_create
from sky_embeddings_tpu.data_processing import cross_match as j_cross
from sky_embeddings_tpu.data_processing import dedup as j_dedup
from sky_embeddings_tpu.data_processing import probe_sets as j_probe
from sky_embeddings_tpu.data_processing import resolution as j_res
from sky_embeddings_tpu.data_processing import split as j_split
from sky_embeddings_tpu_torch.data.fits_io import TanWCS, write_image
from sky_embeddings_tpu_torch.data.fits_loader import find_band_files
from sky_embeddings_tpu_torch.data.synthetic import write_synthetic_h5
from sky_embeddings_tpu_torch.data_processing import combine, create_h5, cross_match, dedup
from sky_embeddings_tpu_torch.data_processing import probe_sets, resolution, split

BANDS = ("G", "R", "I")


@pytest.fixture
def survey(tmp_path):
    """Two FITS patches (G and I present, R missing in the second) and a
    catalogue of 14 sources, 12 inside the patches and 2 at their edges."""
    scale = 2.0 / 3600.0
    rng = np.random.default_rng(0)
    rows = []
    for pi, (ra0, dec0) in enumerate([(150.0, 2.0), (150.2, 2.0)]):
        wcs = TanWCS(crpix=(100.5, 100.5), crval=(ra0, dec0), cd=[[-scale, 0], [0, scale]])
        for band in BANDS[: 3 - pi]:
            write_image(str(tmp_path / f"calexp-HSC-{band}-9813-{pi},0.fits"),
                        rng.normal(size=(200, 200)).astype(np.float32), wcs.to_cards())
        for s in range(7):
            x, y = (60 + 15 * s, 70 + 10 * s) if s < 6 else (5, 100)
            ra, dec = wcs.pixel_to_world(x, y)
            rows.append((float(ra), float(dec)))
    cat = str(tmp_path / "catalog.csv")
    with open(cat, "w") as f:
        f.write("name,ra,dec,zspec,zspec_err,class\n")
        for i, (ra, dec) in enumerate(rows):
            f.write(f"s{i},{ra},{dec},{0.1 + 0.05 * i},{0.01 * (i % 4)},{i % 3}\n")
    return str(tmp_path), cat


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in f}


def _assert_same_h5(a, b):
    da, db = _h5(a), _h5(b)
    assert sorted(da) == sorted(db)
    for k in da:
        assert da[k].dtype == db[k].dtype and da[k].shape == db[k].shape, k
        np.testing.assert_array_equal(da[k], db[k], err_msg=k)


def test_catalog_and_patch_cutouts_match_jax(survey):
    root, cat = survey
    ours, theirs = create_h5.catalog_from_csv(cat), j_create.catalog_from_csv(cat)
    assert sorted(ours) == sorted(theirs) == ["class", "dec", "ra", "zspec", "zspec_err"]
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    patches = find_band_files([root], BANDS, 2, verbose=False)
    assert len(patches) == 2
    for band_files in patches:
        got = create_h5.cutouts_for_patch(band_files, ours, img_size=32)
        want = j_create.cutouts_for_patch(band_files, theirs, img_size=32)
        assert sorted(got) == sorted(want) and len(got["cutouts"]) == 6
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_h5_pipeline_matches_jax(survey, tmp_path):
    """create -> combine -> dedup -> split -> probe sets, each stage's files
    equal to JAX's, its indices too."""
    root, cat = survey
    out = {}
    for tag, mod in (("p", create_h5), ("j", j_create)):
        out[tag] = mod.create_h5_dataset([root], mod.catalog_from_csv(cat),
                                         str(tmp_path / f"{tag}_set.h5"), bands=BANDS,
                                         img_size=32, verbose=False)
    _assert_same_h5(out["p"], out["j"])
    d = _h5(out["p"])
    assert d["cutouts"].shape == (12, 3, 32, 32) and np.isnan(d["cutouts"][6:, 2]).all()

    extra = write_synthetic_h5(str(tmp_path / "extra.h5"), 30, channels=3, img_size=32, seed=1)
    with h5py.File(extra, "a") as f:  # the catalogue's keys, and a duplicate of row 0
        for k in ("class",):
            del f[k]
        ra, dec = f["ra"][:], f["dec"][:]
        ra[0], dec[0] = d["ra"][0] + 0.2 / 3600, d["dec"][0]
        f["ra"][:], f["dec"][:] = ra, dec
    for k in ("class",):
        with h5py.File(out["p"], "a") as f:
            del f[k]
    comb = [mod.combine_h5_files([out["p"], extra], str(tmp_path / f"{tag}_comb.h5"), batch=7)
            for tag, mod in (("p", combine), ("j", j_combine))]
    _assert_same_h5(*comb)
    n_comb = _h5(comb[0])["ra"].shape[0]
    assert n_comb == 42

    kept = [mod.deduplicate_h5(comb[0], str(tmp_path / f"{tag}_dedup.h5"))
            for tag, mod in (("p", dedup), ("j", j_dedup))]
    assert kept == [41, 41]
    _assert_same_h5(str(tmp_path / "p_dedup.h5"), str(tmp_path / "j_dedup.h5"))

    parts = {}
    for tag, mod in (("p", split), ("j", j_split)):
        src = str(tmp_path / f"{tag}_dedup.h5")
        parts[tag] = mod.split_dataset(src, (0.6, 0.2, 0.2), seed=5)
    for a, b in zip(parts["p"], parts["j"]):
        _assert_same_h5(a, b)
    # the indices alone: the rows each JAX part holds
    ra_all = _h5(str(tmp_path / "p_dedup.h5"))["ra"]
    for idx, path in zip(split.split_indices(41, (0.6, 0.2, 0.2), seed=5), parts["j"]):
        np.testing.assert_array_equal(ra_all[idx], _h5(path)["ra"])
    with pytest.raises(ValueError, match="sum to 1"):
        split.split_indices(10, (0.5, 0.2, 0.2))


def test_probe_sets_and_indices_match_jax(tmp_path):
    src = write_synthetic_h5(str(tmp_path / "p.h5"), 90, channels=2, img_size=8, seed=3)
    classes = _h5(src)["class"]
    for per_class in (10, 40):
        n = [mod.make_probe_set(src, str(tmp_path / f"{tag}_cls.h5"), per_class=per_class, seed=4)
             for tag, mod in (("p", probe_sets), ("j", j_probe))]
        assert n[0] == n[1]
        _assert_same_h5(str(tmp_path / "p_cls.h5"), str(tmp_path / "j_cls.h5"))
        idx = probe_sets.probe_indices(classes, per_class, seed=4)
        np.testing.assert_array_equal(_h5(src)["ra"][idx], _h5(str(tmp_path / "j_cls.h5"))["ra"])
    for n_samples in (25, 200):
        n = [mod.make_regression_probe_set(src, str(tmp_path / f"{tag}_reg.h5"), n_samples, seed=6)
             for tag, mod in (("p", probe_sets), ("j", j_probe))]
        assert n[0] == n[1] == min(n_samples, 90)
        _assert_same_h5(str(tmp_path / "p_reg.h5"), str(tmp_path / "j_reg.h5"))
        np.testing.assert_array_equal(probe_sets.regression_probe_indices(90, n_samples, 6),
                                      np.flatnonzero(np.isin(_h5(src)["ra"],
                                                             _h5(str(tmp_path / "j_reg.h5"))["ra"])))


def test_resolution_matches_jax(survey, tmp_path):
    root, _ = survey
    with open(os.path.join(root, "broken.fits"), "wb") as f:
        f.write(b"not a fits file")
    for limit in (20, 2):
        assert resolution.measure_resolution([root], limit) == j_res.measure_resolution([root], limit)
    assert resolution.measure_resolution([root])["n"] == 5
    assert resolution.measure_resolution([str(tmp_path / "none")]) == {"n": 0}


def _catalogues(n=400, seed=0):
    rng = np.random.default_rng(seed)
    ra, dec = rng.uniform(150.0, 151.0, n), rng.uniform(1.0, 2.0, n)
    zspec = rng.uniform(0.1, 1.5, n)
    ra[1], dec[1] = ra[0] + 0.4 / 3600, dec[0]  # a close pair: both dropped by isolation
    jitter = 0.3 / 3600
    hsc = {"ra": ra, "dec": dec, "zspec": zspec, "zspec_err": 0.01 * zspec}
    classes = {"ra": np.concatenate([ra[:80] + jitter, ra[80:200], ra[:10] + 10.0, ra[300:310]]),
               "dec": np.concatenate([dec[:80], dec[80:200] + jitter, dec[:10], dec[300:310]]),
               "cspec": np.concatenate([np.full(80, 1), np.full(120, 2), np.full(10, 3),
                                        np.full(10, 0)])}
    return hsc, classes


@pytest.mark.parametrize("dedup_", [True, False])
def test_cross_match_matches_jax(tmp_path, dedup_):
    hsc, classes = _catalogues()
    for radius in (0.1, 0.5, 1.0):
        got = cross_match.cross_match_mask(hsc["ra"], hsc["dec"], classes["ra"], classes["dec"],
                                           radius)
        want = j_cross.cross_match_mask(hsc["ra"], hsc["dec"], classes["ra"], classes["dec"],
                                         radius)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(cross_match.isolated_mask(hsc["ra"], hsc["dec"], radius),
                                      j_cross.isolated_mask(hsc["ra"], hsc["dec"], radius))
    assert not cross_match.cross_match_mask(hsc["ra"], hsc["dec"], [], []).any()
    paths = {tag: mod.make_class_catalogs(hsc, classes, str(tmp_path / tag), dedup=dedup_)
             for tag, mod in (("p", cross_match), ("j", j_cross))}
    assert list(paths["p"]) == ["unknown", "star", "galaxy", "qso"]
    for name in paths["p"]:
        with open(paths["p"][name]) as a, open(paths["j"][name]) as b:
            text = a.read()
            assert text == b.read() and text.startswith("ra,dec,zspec,zspec_err\n")
    with open(paths["p"]["star"]) as f:
        assert len(f.readlines()) == 1 + 80 - 2 * dedup_


def test_h5_to_csv_matches_jax(tmp_path):
    src = write_synthetic_h5(str(tmp_path / "s.h5"), 20, channels=2, img_size=8, seed=2)
    assert cross_match.h5_to_csv(src, str(tmp_path / "p.csv")) == 20
    j_cross.h5_to_csv(src, str(tmp_path / "j.csv"))
    with open(tmp_path / "p.csv") as a, open(tmp_path / "j.csv") as b:
        assert a.read() == b.read()


def test_h5_stages_raise_without_h5py(survey, tmp_path, monkeypatch):
    """With h5py unimportable every stage that reads or writes h5 raises
    ``ImportError`` naming it; the catalogue, cutout, mask, index and
    resolution functions still run."""
    root, cat = survey
    catalog = create_h5.catalog_from_csv(cat)
    src = write_synthetic_h5(str(tmp_path / "s.h5"), 20, channels=2, img_size=8)
    monkeypatch.setitem(sys.modules, "h5py", None)
    stages = [
        lambda: create_h5.create_h5_dataset([root], catalog, str(tmp_path / "o.h5"), bands=BANDS,
                                            verbose=False),
        lambda: combine.combine_h5_files([src], str(tmp_path / "c.h5")),
        lambda: dedup.deduplicate_h5(src, str(tmp_path / "d.h5")),
        lambda: split.split_dataset(src),
        lambda: probe_sets.make_probe_set(src, str(tmp_path / "q.h5")),
        lambda: probe_sets.make_regression_probe_set(src, str(tmp_path / "r.h5")),
        lambda: cross_match.h5_to_csv(src, str(tmp_path / "x.csv")),
    ]
    for stage in stages:
        with pytest.raises(ImportError, match="h5py"):
            stage()
    band_files = find_band_files([root], BANDS, 2, verbose=False)[0]
    assert len(create_h5.cutouts_for_patch(band_files, catalog, 32)["cutouts"]) == 6
    assert dedup.duplicate_mask(catalog["ra"], catalog["dec"]).all()
    assert resolution.measure_resolution([root])["n"] == 5
    assert [len(i) for i in split.split_indices(20)] == [16, 2, 2]
