"""The port's device-resident dataset (``data/device_cache.py``) against the
JAX package's: the same batches from the same h5 file and seed over two
epochs (shuffled and in order, duplicate ``indices`` in caller order,
``drop_remainder`` off, class and float labels, bf16 storage, a central
crop), the arrays route equal to the h5 route, the byte guard, the label-key
rule and every ``device_cache`` mode of ``build_cached_or_streaming_batcher``;
a CUDA dataset without a card raises."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.data import device_cache as jax_cache
from sky_embeddings_tpu_torch.configuration import Config
from sky_embeddings_tpu_torch.data import device_cache
from sky_embeddings_tpu_torch.data.device_cache import DeviceDataset
from sky_embeddings_tpu_torch.data.h5_loader import H5Batcher
from sky_embeddings_tpu_torch.data.synthetic import structured_survey, write_structured_h5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These models and batches are tiny: one thread runs them fastest, and
    it keeps the test workers that share the cores from spinning OpenMP
    pools against each other (tenfold slower under contention)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cache") / "s.h5")
    write_structured_h5(path, 70, channels=3, img_size=20, seed=6, chunk=32)
    return path


def _np(batch):
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in batch.items()}


def _same_epochs(port, jax_ds, epochs=2):
    n = 0
    for _ in range(epochs):
        got, want = list(port), list(jax_ds)
        assert len(got) == len(want) == len(port) == len(jax_ds)
        for a, b in zip(got, want):
            a = _np(a)
            assert set(a) == set(b)
            for k in b:
                w = np.asarray(b[k].astype(jnp.float32) if b[k].dtype == jnp.bfloat16 else b[k])
                assert a[k].shape == w.shape and a[k].dtype == w.dtype, k
                np.testing.assert_array_equal(a[k], w, err_msg=k)
            n += 1
    return n


CASES = {
    "shuffled": dict(shuffle=True, batch_size=16),
    "in_order_ragged": dict(shuffle=False, batch_size=16, drop_remainder=False),
    "class_labels": dict(shuffle=True, batch_size=12, label_keys=["class"], seed=3),
    "float_labels": dict(shuffle=True, batch_size=12, label_keys=["zspec", "zspec_err"]),
    "duplicate_indices": dict(shuffle=False, batch_size=8, drop_remainder=False,
                              indices=[5, 3, 3, 60, 0, 5, 69, 12, 12, 1], label_keys=["class"]),
    "indices_shuffled": dict(shuffle=True, batch_size=4, indices=[9, 2, 2, 40, 7, 33, 33, 1]),
    "bf16_crop": dict(shuffle=True, batch_size=16, img_size=16, pixel_min=-0.5, pixel_max=2.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batches_equal_jax_over_two_epochs(survey, case):
    kw = dict(CASES[case])
    kw.setdefault("img_size", 20)
    dtypes = (torch.bfloat16, jnp.bfloat16) if case == "bf16_crop" else (torch.float32, jnp.float32)
    port = DeviceDataset(survey, dtype=dtypes[0], device="cpu", **kw)
    jds = jax_cache.DeviceDataset(survey, dtype=dtypes[1], **kw)
    assert port.num_samples == jds.num_samples
    assert _same_epochs(port, jds) > 0
    assert port.cutouts.dtype == dtypes[0]
    # the arrays route serves the same batches
    arrays = structured_survey(70, channels=3, img_size=20, seed=6, chunk=32)
    again = DeviceDataset.from_arrays(arrays, dtype=dtypes[0], device="cpu", **kw)
    for a, b in zip(again, DeviceDataset(survey, dtype=dtypes[0], device="cpu", **kw)):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, equal_nan=True, msg=k)


def test_take_forever_and_epoch_count(survey):
    port = DeviceDataset(survey, batch_size=16, device="cpu", seed=2)
    jds = jax_cache.DeviceDataset(survey, batch_size=16, seed=2)
    got = [_np(b)["cutouts"] for b in port.take(2)]
    want = [np.asarray(b["cutouts"]) for b in jds.take(2)]
    assert len(got) == 2 and all(np.array_equal(a, b, equal_nan=True) for a, b in zip(got, want))
    stream, jstream = port.forever(), jds.forever()
    for _ in range(9):  # past two epoch boundaries (4 batches an epoch)
        np.testing.assert_array_equal(_np(next(stream))["ra_dec"],
                                      np.asarray(next(jstream)["ra_dec"]))


def test_guards(survey):
    with pytest.raises(ValueError, match="mixes 'class'"):
        DeviceDataset(survey, 8, label_keys=["class", "zspec"], device="cpu")
    with pytest.raises(ValueError, match="max_bytes"):
        DeviceDataset(survey, 8, max_bytes=1000, device="cpu")
    with pytest.raises(ValueError, match="max_bytes"):
        jax_cache.DeviceDataset(survey, 8, max_bytes=1000)
    # 70 x 3 x 20 x 20 fp32 = 336 000 bytes fits exactly; bf16 halves it
    DeviceDataset(survey, 8, max_bytes=336_000, device="cpu")
    DeviceDataset(survey, 8, max_bytes=168_000, dtype="bfloat16", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceDataset(survey, 8)  # the default device is the card's
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceDataset.from_arrays(structured_survey(8, 3, 16, seed=1), 4)


@pytest.mark.parametrize("mode,limit,cached", [
    ("auto", None, True), ("True", None, True), ("False", None, False),
    ("auto", 1000, False), ("True", 1000, "raises"), ("1", None, True), ("0", None, False),
    ("maybe", None, "bad")])
def test_dispatch_modes_match_jax(survey, mode, limit, cached):
    data = {"device_cache": mode, "device_cache_dtype": "bfloat16"}
    if limit is not None:
        data["device_cache_bytes"] = str(limit)
    cfg = {"DATA": data}
    kw = dict(batch_size=8, img_size=20, label_keys=["zspec"], shuffle=False)
    calls = []
    if cached in ("raises", "bad"):
        match = "device_cache = True" if cached == "raises" else "True/False/auto"
        for fn, c in ((device_cache.build_cached_or_streaming_batcher, Config.from_dict(cfg)),
                      (jax_cache.build_cached_or_streaming_batcher, JaxConfig.from_dict(cfg))):
            with pytest.raises(ValueError, match=match):
                fn(c["DATA"], survey, log_fn=calls.append, **kw)
        return
    got = device_cache.build_cached_or_streaming_batcher(
        Config.from_dict(cfg)["DATA"], survey, log_fn=calls.append, device="cpu", **kw)
    want = jax_cache.build_cached_or_streaming_batcher(
        JaxConfig.from_dict(cfg)["DATA"], survey, log_fn=lambda m: None, **kw)
    assert isinstance(got, DeviceDataset if cached else H5Batcher)
    assert isinstance(want, jax_cache.DeviceDataset) == bool(cached)
    if cached:
        assert got.cutouts.dtype == torch.bfloat16 and calls and "Device-caching" in calls[0]
        assert _same_epochs(got, want, epochs=1) == 8
    # multi-process runs always stream
    multi = device_cache.build_cached_or_streaming_batcher(
        Config.from_dict(cfg)["DATA"], survey, process_count=2, process_index=0,
        log_fn=calls.append, device="cpu", **kw)
    assert isinstance(multi, H5Batcher)
