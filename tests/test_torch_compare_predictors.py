"""The port's ``compare_predictors`` and ``struct_sweep`` twins, on the CPU.

``family_configs`` equal to JAX's for every family prefix in ``configs/``;
the twin's ``evaluate_model`` on a checkpoint that JAX's trainer wrote
(``.ckpt.msgpack``) and a small ``write_structured_h5`` val set equal to
JAX's ``evaluate_model`` (accuracy exact; bias, MAD and outlier fraction
within 1e-5) for an mse head and a crossentropy head; the ``--json`` rows in
JAX's shape; the figure drawn with matplotlib and its skip line without;
``struct_sweep --quick`` training ``ft``, ``fs`` and ``ap`` at two sizes and
two seeds and writing its rows. Models cut to depth 2.
"""

import builtins
import glob
import json
import os
import shutil
import sys

import numpy as np
import pytest

import torch

from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.train.predictor import PredictorTrainer as JaxPredictorTrainer
from sky_embeddings_tpu_torch import compare_predictors as twin
from sky_embeddings_tpu_torch import semantic_validation as sv
from sky_embeddings_tpu_torch import struct_sweep
from sky_embeddings_tpu_torch.data.synthetic import write_structured_h5
from sky_embeddings_tpu_torch.models import mim as port_mim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
sys.path.insert(0, REPO)
import compare_predictors as jax_compare  # noqa: E402  (the JAX package's CLI)


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
def depth2(monkeypatch):
    for mod in (jax_mim, port_mim):
        monkeypatch.setitem(mod._SIZES["base"], "depth", 2)


def _families() -> list:
    """Every family prefix the configs hold: a name without its last token
    (``cls_ft_1k`` -> ``cls_ft``) and, for suffixed names, without its size
    token (``cls_ft_1k_wide`` -> ``cls_ft_wide``)."""
    out = set()
    for path in glob.glob(os.path.join(CONFIGS, "*.ini")):
        parts = os.path.splitext(os.path.basename(path))[0].split("_")
        if len(parts) >= 2:
            out.add("_".join(parts[:-1]))
        if len(parts) >= 3:
            out.add("_".join(parts[:-2] + parts[-1:]))
    return sorted(out)


@pytest.mark.parametrize("family", _families())
def test_family_configs_match_jax(family):
    assert twin.family_configs(CONFIGS, family) == jax_compare.family_configs(CONFIGS, family)


def test_struct_families_are_the_sweep():
    assert twin.family_configs(CONFIGS, "z_struct_ft") == [
        f"z_struct_ft_{n}" for n in ("128", "12k", "2048", "512", "8192")]


def _tiny_repo(root, loss):
    """A repo dir with ``mim_tiny`` and a ``z_x_<n>`` predictor (mse on
    ``zspec`` or 3-class crossentropy on ``class``, all rows or 24), its h5
    sets, and JAX's checkpoint of one training step."""
    os.makedirs(root / "configs")
    shutil.copy(os.path.join(CONFIGS, "mim_tiny.ini"), root / "configs")
    text = open(os.path.join(CONFIGS, "z_tiny.ini")).read().replace("augment = True",
                                                                     "augment = False")
    if loss == "crossentropy":
        text = (text.replace("label_keys = ['zspec']", "label_keys = ['class']\nnum_classes = 3")
                .replace("loss_fn = mse", "loss_fn = crossentropy"))
    for name, n in (("z_x_all", -1), ("z_x_24", 24)):
        (root / "configs" / f"{name}.ini").write_text(text.replace("num_train = -1",
                                                                   f"num_train = {n}"))
    data = root / "data"
    data.mkdir()
    write_structured_h5(str(data / "tiny_train.h5"), 40, 3, 16, seed=1)
    write_structured_h5(str(data / "tiny_val.h5"), 37, 3, 16, seed=2)
    models = root / "models"
    models.mkdir()
    mae = jax_load_config("mim_tiny", str(root / "configs"))
    from sky_embeddings_tpu_torch.data.h5_loader import build_h5_batcher

    label = "class" if loss == "crossentropy" else "zspec"
    batch = next(iter(build_h5_batcher(str(data / "tiny_train.h5"), batch_size=16, img_size=16,
                                       label_keys=[label], shuffle=False)))
    jt = JaxPredictorTrainer(jax_load_config("z_x_all", str(root / "configs")), mae)
    jt.train_batch({k: np.asarray(v) for k, v in batch.items()})
    for name in ("z_x_all", "z_x_24"):  # one model: num_train is only the x-axis here
        jt.save(str(models / f"{name}.ckpt.msgpack"))
    return str(root / "configs"), str(models), str(data)


@pytest.mark.parametrize("loss", ["mse", "crossentropy"])
def test_evaluate_model_matches_jax(tmp_path, depth2, loss):
    config_dir, model_dir, data_dir = _tiny_repo(tmp_path, loss)
    for name, n in (("z_x_all", 40), ("z_x_24", 24)):
        want = jax_compare.evaluate_model(name, config_dir, model_dir, data_dir)
        got = twin.evaluate_model(name, config_dir, model_dir, data_dir, device="cpu")
        assert got[0] == want[0] == n and set(got[1]) == set(want[1])
        if loss == "crossentropy":
            assert got[1] == want[1]
        else:
            for k in ("bias", "mad", "outlier_frac"):
                np.testing.assert_allclose(got[1][k], want[1][k], rtol=0, atol=1e-5, err_msg=k)
    assert twin.evaluate_model("z_x_24", config_dir, str(tmp_path / "none"), data_dir,
                               device="cpu") is None


def test_json_rows_have_jax_shape(tmp_path, depth2, monkeypatch, capsys):
    """``main -f z_x --json`` writes ``{family: [{"num_train": n, ...}]}``
    sorted by size, the keys of JAX's ``results/compare_predictors_struct.json``
    rows, and draws its figure."""
    _tiny_repo(tmp_path, "mse")
    monkeypatch.setattr(twin, "REPO_DIR", str(tmp_path))
    results = twin.main(["-f", "z_x", "--json", "-o", "cmp", "--device", "cpu"])
    assert [n for n, _ in sorted(results["z_x"], key=lambda r: r[0])] == [24, 40]
    with open(tmp_path / "results" / "cmp.json") as f:
        rows = json.load(f)
    with open(os.path.join(REPO, "results", "compare_predictors_struct.json")) as f:
        jax_rows = json.load(f)
    assert list(rows) == ["z_x"] and [r["num_train"] for r in rows["z_x"]] == [24, 40]
    assert all(set(r) == set(jax_rows["z_struct_ft"][0]) for r in rows["z_x"])
    assert (tmp_path / "figures" / "cmp.png").stat().st_size > 0


def test_figure_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    results = {"f": [(128, {"mad": 0.1}), (512, {"mad": 0.05})]}
    assert twin.plot_results(results, str(tmp_path / "a.png"))
    assert (tmp_path / "a.png").exists()
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError("hidden")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert not twin.plot_results(results, str(tmp_path / "b.png"))
    assert not (tmp_path / "b.png").exists()
    assert "Figure skipped: matplotlib is not installed." in capsys.readouterr().out


def test_struct_sweep_quick(tmp_path, depth2, monkeypatch):
    """``struct_sweep --quick``: ``mim_struct`` pretrained first (no checkpoint),
    ``ft``, ``fs`` and ``ap`` at two sizes and two seeds, each run's best
    checkpoint scored through the compare twin; the rows, the per-size
    spread and the ``ft`` < ``fs`` counts written."""
    shutil.copytree(CONFIGS, tmp_path / "configs")
    for mod in (sv, struct_sweep, twin):
        monkeypatch.setattr(mod, "REPO_DIR", str(tmp_path))
    res = struct_sweep.main(["--quick", "-s", "128", "512", "--seeds", "2", "--device", "cpu"])
    with open(tmp_path / "results" / "compare_predictors_struct_torch_quick.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(res))
    for fam in ("z_struct_ft", "z_struct_fs", "z_struct_ap"):
        rows = saved[fam]
        assert [(r["num_train"], r["seed"]) for r in rows] == [(16, 0), (16, 1), (64, 0), (64, 1)]
        assert all(np.isfinite([r["bias"], r["mad"], r["outlier_frac"]]).all() for r in rows)
        by = saved["by_size"][fam]
        assert [(s["num_train"], s["seeds"]) for s in by] == [(16, 2), (64, 2)]
        assert by[0]["mad_min"] <= by[0]["mad_mean"] <= by[0]["mad_max"]
    assert [r["seeds"] for r in saved["ft_below_fs"]] == [2, 2]
    assert "pretrain" in saved["seconds"] and saved["device"] == "cpu"
    assert os.path.exists(tmp_path / "models" / "z_struct_ap_512_quick_seed1.ckpt.pt")
