"""The port reads and writes the JAX package's checkpoints, on the CPU.

- ``utils/flax_msgpack``: ``serialize`` byte-equal to flax's
  ``msgpack_serialize`` and ``restore`` equal to ``msgpack_restore`` leaf for
  leaf, on fp32, bf16, int32 and uint32 leaves, Python and numpy scalars,
  ``{'0': ...}`` lists, nested dicts and chunked arrays (both modules' chunk
  limit patched to 4 KB); the port's ``save_checkpoint`` byte-equal to JAX's.
- Resuming a JAX run: the JAX trainer takes 2 steps and saves through its
  ``save_checkpoint``; the port restores the file and takes step 3 on the
  same batch with the masks JAX's step draws (its ``jax.random`` split
  replayed), held to JAX's step 3 (losses 1e-5 relative, params 1e-4
  absolute; the key part of each fused qkv or kv bias, whose gradient is
  rounding noise, to 3 lr). Then the port writes its state as ``.ckpt.msgpack``, a
  fresh JAX trainer restores it (params bit-equal) and both take step 4.
  For ``mim_tiny`` pretraining, predictor ``ft`` (layer-decay groups),
  ``fs`` and ``lp`` (``multi_transform``), JEPA with its target tree, and a
  scan-layout ``mimhuge`` tree; models cut to depth 2.
- A warm start from a JAX MIM checkpoint gives the model a warm start from
  the port's file of the same weights gives; ``find_checkpoint``.
- The ``port_torch_checkpoint`` twin's ``.ckpt.msgpack`` is byte-equal to the
  JAX tool's from the same reference state dict (``tests/torch_oracle.py``'s
  reference-layout models), and the port's model loaded from it matches the
  oracle's forward.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization as flax_ser

from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.models import jepa as jax_jepa
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.ops.jepa_masks import sample_block_masks as jax_sample
from sky_embeddings_tpu.ops.masking import simmim_batch_mask as jax_simmim_mask
from sky_embeddings_tpu.train.jepa import JEPATrainer as JaxJEPATrainer
from sky_embeddings_tpu.train.predictor import PredictorTrainer as JaxPredictorTrainer
from sky_embeddings_tpu.train.pretrain import MIMPretrainer as JaxMIMPretrainer
from sky_embeddings_tpu.utils import checkpoint as jax_ckpt
from sky_embeddings_tpu_torch import port_torch_checkpoint as port_tool
from sky_embeddings_tpu_torch.configuration import Config
from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
from sky_embeddings_tpu_torch.models import jepa as port_jepa
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.mim import SkyMIM
from sky_embeddings_tpu_torch.models.pos_embed import sincos_pos_embed_2d
from sky_embeddings_tpu_torch.models.predictor import SkyViT
from sky_embeddings_tpu_torch.models.weights import load_jax_params
from sky_embeddings_tpu_torch.ops.jepa_masks import BlockMasks
from sky_embeddings_tpu_torch.train import optim
from sky_embeddings_tpu_torch.train.jepa import JEPATrainer
from sky_embeddings_tpu_torch.train.predictor import PredictorTrainer
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer
from sky_embeddings_tpu_torch.utils import checkpoint as ckpt
from sky_embeddings_tpu_torch.utils import flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
sys.path.insert(0, REPO)


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
    """Every MIM size and JEPA's ``tiny`` cut to depth 2 in both packages
    (JEPA's at D = 64, two heads)."""
    for mod in (jax_mim, port_mim):
        for size in ("base", "large", "huge"):
            monkeypatch.setitem(mod._SIZES[size], "depth", 2)
    for mod in (jax_jepa, port_jepa):
        monkeypatch.setitem(mod._SIZES, "tiny", dict(embed_dim=64, depth=2, num_heads=2))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _equal_trees(want, got, path=""):
    """flax's restored tree against the port's: the same keys in the same
    order, the same types, every array bit-equal (bf16 as tensors)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(want) == list(got), path
        for k in want:
            _equal_trees(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _equal_trees(a, b, f"{path}/{i}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16", path
        assert tuple(got.shape) == want.shape, path
        assert got.view(torch.int16).numpy().tobytes() == want.view(np.int16).tobytes(), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


# ---------------------------------------------------------------------------
# the msgpack subset

def _bf16(a):
    """(numpy bf16 for flax, torch bf16 for the port) of the same values."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16)), t


def _tree(case):
    """(tree for flax, the same tree for the port) of a test case."""
    rng = np.random.default_rng(0)
    if case == "fp32":
        t = {"kernel": rng.normal(size=(7, 5)).astype(np.float32),
             "bias": rng.normal(size=(5,)).astype(np.float32),
             "big": rng.normal(size=(300, 70)).astype(np.float32)}
        return t, t
    if case == "bf16":
        a, b = _bf16(rng.normal(size=(3, 40)))
        s, u = _bf16(rng.normal(size=()))
        return {"w": a, "s": s}, {"w": b, "s": u}
    if case == "int_uint":
        t = {"i": rng.integers(-2 ** 31, 2 ** 31 - 1, size=(9,), dtype=np.int32),
             "u": rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32),
             "i64": np.arange(-3, 3, dtype=np.int64), "b": np.array([True, False]),
             "key": np.asarray(jax.random.PRNGKey(7))}
        return t, t
    if case == "python_scalars":
        t = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
                      -32768, -32769, -2 ** 31 - 1, 2 ** 63 - 1, -2 ** 63],
             "floats": [0.0, -1.5, 1e300, float("inf")], "flags": [True, False, None],
             "text": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "ü" * 40000],
             "raw": [b"", b"\x00\xff" * 200, b"x" * 70000], "z": complex(1.5, -2.0)}
        return t, t
    if case == "numpy_scalars":
        t = {"f32": np.float32(1.25), "f64": np.float64(-3.5), "i32": np.int32(-7),
             "u32": np.uint32(4_000_000_000), "b": np.bool_(True), "zero_d": np.asarray(2.5),
             "step": np.asarray(12, np.int32)}
        return t, t
    if case == "state_dict_lists":
        t = {"losses": {str(i): np.asarray(float(i) / 3) for i in range(12)},
             "counts": {"0": np.asarray(1, np.int32), "1": np.asarray(2, np.int32)}}
        return t, t
    if case == "nested":
        t = {"z": {"b": {"c": np.zeros((0, 3), np.float32), "a": {}}, "a": [1, [2, {"k": 3}]]},
             "10": np.ones((1, 1, 4), np.float32), "2": None,
             "map16": {f"k{i}": np.asarray(i, np.int32) for i in range(20)},
             "arr16": list(range(20)),
             "fortran": np.asfortranarray(rng.normal(size=(3, 4)).astype(np.float32)),
             "view": rng.normal(size=(6, 6)).astype(np.float32)[::2, 1:]}
        return t, t
    raise ValueError(case)


CASES = ["fp32", "bf16", "int_uint", "python_scalars", "numpy_scalars", "state_dict_lists",
         "nested"]


@pytest.mark.parametrize("case", CASES)
def test_serialize_is_byte_equal_to_flax(case):
    want_tree, port_tree = _tree(case)
    want = flax_ser.msgpack_serialize(want_tree)
    assert flax_msgpack.serialize(port_tree) == want


@pytest.mark.parametrize("case", CASES)
def test_restore_equals_flax(case):
    data = flax_ser.msgpack_serialize(_tree(case)[0])
    _equal_trees(flax_ser.msgpack_restore(data), flax_msgpack.restore(data))
    _equal_trees(flax_ser.msgpack_restore(data), flax_msgpack.restore(bytearray(data)))


@pytest.mark.parametrize("where", ["nested", "top", "bf16"])
def test_chunked_arrays_match_flax(where, monkeypatch):
    """Arrays above the chunk limit (patched to 4 KB in both modules): the
    ``__msgpack_chunked_array__`` record byte for byte, joined back on
    reading; one chunk of the limit, one over it, and a ragged tail."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 4096)
    rng = np.random.default_rng(1)
    big = rng.normal(size=(37, 100)).astype(np.float32)  # 14 800 B: 4 chunks
    if where == "nested":
        want_tree = port_tree = {"p": {"w": big, "edge": np.ones(1025, np.float32),
                                       "small": np.ones(1024, np.float32)}}
    elif where == "top":
        want_tree = port_tree = big
    else:
        a, b = _bf16(rng.normal(size=(50, 90)))
        want_tree, port_tree = {"w": a}, {"w": b}
    data = flax_ser.msgpack_serialize(want_tree)
    assert b"__msgpack_chunked_array__" in data
    assert flax_msgpack.serialize(port_tree) == data
    want, got = flax_ser.msgpack_restore(data), flax_msgpack.restore(data)
    if where == "top":
        np.testing.assert_array_equal(got, want)
    else:
        _equal_trees(want, got)


def test_save_checkpoint_is_the_jax_file(tmp_path):
    """The port's ``save_checkpoint`` of a payload is JAX's file of it byte
    for byte (lists as ``{'0': ...}``, every leaf an array), and its
    ``load_checkpoint`` equals JAX's; ``losses_to_lists`` as JAX's."""
    rng = np.random.default_rng(2)
    params = {"encoder": {"block0": {"w": rng.normal(size=(4, 3)).astype(np.float32)}},
              "head": {"bias": np.zeros(2, np.float32)}}
    payload = {"step": np.asarray(5, np.int32), "params": params,
               "rng": np.asarray(jax.random.PRNGKey(3)),
               "losses": {"train_loss": [0.5, 0.25], "batch_iters": [10, 20]}}
    jax_ckpt.save_checkpoint(str(tmp_path / "j.ckpt.msgpack"), payload)
    ckpt.save_checkpoint(str(tmp_path / "p.ckpt.msgpack"), payload)
    assert (tmp_path / "p.ckpt.msgpack").read_bytes() == (tmp_path / "j.ckpt.msgpack").read_bytes()
    want = jax_ckpt.load_checkpoint(str(tmp_path / "j.ckpt.msgpack"))
    got = ckpt.load_checkpoint(str(tmp_path / "j.ckpt.msgpack"))
    _equal_trees(want, got)
    assert ckpt.losses_to_lists(got["losses"]) == jax_ckpt.losses_to_lists(want["losses"])
    assert ckpt.load_checkpoint(str(tmp_path / "none.ckpt.msgpack")) is None


def test_find_checkpoint_prefers_the_ports_file(tmp_path):
    d = str(tmp_path)
    assert ckpt.find_checkpoint(d, "m") is None
    (tmp_path / "m.ckpt.msgpack").write_bytes(b"\x80")
    (tmp_path / "m_best.ckpt.msgpack").write_bytes(b"\x80")
    assert ckpt.find_checkpoint(d, "m") == os.path.join(d, "m.ckpt.msgpack")
    assert ckpt.find_checkpoint(d, "m", best=True) == os.path.join(d, "m_best.ckpt.msgpack")
    (tmp_path / "m.ckpt.pt").write_bytes(b"")
    assert ckpt.find_checkpoint(d, "m") == os.path.join(d, "m.ckpt.pt")


# ---------------------------------------------------------------------------
# trainers across frameworks

def _images(n, seed, channels=3):
    x = make_cutouts(n, channels=channels, img_size=16, seed=seed)["cutouts"]
    x[0, 1] = np.nan
    return x


def _batches(n_steps, bs, seed, channels=3, labels=False):
    x = _images(n_steps * bs, seed, channels)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_steps):
        b = {"cutouts": x[i * bs:(i + 1) * bs], "ra_dec": np.zeros((bs, 2), np.float32)}
        if labels:
            b["labels"] = rng.uniform(0.1, 1.5, size=(bs, 1)).astype(np.float32)
        out.append(b)
    return out


def _key_bias(name: str, shape):
    """The key slice of an attention's fused bias, or None."""
    if name.endswith("attn.qkv.bias"):
        return slice(shape[0] // 3, 2 * shape[0] // 3)
    if name.endswith("xattn.kv.bias"):
        return slice(0, shape[0] // 2)
    return None


def _port_layout(want_tree, got_sd):
    """JAX's params (either layout) flattened in the port's loop layout."""
    tree = jax.tree_util.tree_map(np.asarray, jax.device_get(want_tree))
    return _flat(ckpt.adapt_block_layout(tree, ckpt.nest(got_sd)))


def _assert_close_params(got_sd, want_tree, lr):
    want = _port_layout(want_tree, got_sd)
    got = {k: v.detach().numpy() for k, v in got_sd.items()}
    assert set(got) == set(want)
    for name in want:
        g, w = got[name].copy(), want[name].copy()
        key = _key_bias(name, g.shape)
        if key is not None:
            # softmax is blind to the key bias, so its gradient is rounding
            # noise and Adam's step of it is arbitrary up to about lr
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=3 * lr, err_msg=name)
            g[key] = w[key] = 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)


def _assert_bit_equal_params(got_sd, want_tree):
    want = _port_layout(want_tree, got_sd)
    assert set(got_sd) == set(want)
    for name, v in want.items():
        np.testing.assert_array_equal(got_sd[name].detach().numpy(), np.asarray(v), err_msg=name)


def _jax_cfg(d):
    return JaxConfig.from_dict(d), Config.from_dict(d)


def _cfg_dict(name, **sections):
    base = jax_load_config(name, CONFIGS)
    return {sec: {**dict(base[sec].items()), **sections.get(sec, {})} for sec in base.sections()}


def _mim_masks(jt, bs):
    """The SimMIM mask JAX's next training step draws (``make_mim_step``)."""
    _, k_mask, _ = jax.random.split(jt.state.rng, 3)
    m = jt.model
    return torch.from_numpy(np.array(jax_simmim_mask(k_mask, bs, m.in_chans, m.img_size,
                                                     m.patch_size, jt.max_mask_ratio)))


def _jepa_masks(jt, bs):
    """The block masks JAX's next JEPA step draws (``train/jepa.py``)."""
    _, k_mask, _ = jax.random.split(jt.state.rng, 3)
    m = jax_sample(k_mask, bs, jt.model.grid_size, **jt.mask_params)
    return BlockMasks(*(torch.from_numpy(np.asarray(a).astype(bool if a.dtype == bool else np.int64))
                        for a in m))


def _round_trip(tmp_path, jt, port, batches, draw, lr_of, target=False):
    """JAX's trainer ``jt``: 2 steps, saved. The port's ``port``: restored,
    step 3 against JAX's step 3; written as ``.ckpt.msgpack``, which ``jt``
    restores (params bit-equal); then both take step 4. ``draw(jt, B)`` gives
    the port's step the masks JAX's next step draws; ``lr_of(port, step)``
    is the step's largest lr."""
    for b in batches[:2]:
        jt.train_batch(b)
    a = str(tmp_path / "a.ckpt.msgpack")
    jt.save(a)
    assert port.restore(a) and port.cur_iter == 2
    _assert_bit_equal_params(port.model.state_dict(), jt.state.params)
    for step, b in ((3, batches[2]), (4, batches[3])):
        kw = draw(jt, len(b["cutouts"]))
        out, got = jt.train_batch(b), port.train_batch(b, **kw)
        want_loss = out[0] if isinstance(out, tuple) else out
        got_loss = got[0] if isinstance(got, tuple) else got
        np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5, err_msg=step)
        lr = lr_of(port, step - 1)
        _assert_close_params(port.model.state_dict(), jt.state.params, lr)
        if target:
            _assert_close_params(port.target.state_dict(), jt.state.target_params, lr)
        if step == 3:  # the port's state, written for JAX, replaces JAX's
            b_path = str(tmp_path / "b.ckpt.msgpack")
            port.save(b_path)
            assert jt.restore(b_path) and jt.cur_iter == 3
            _assert_bit_equal_params(port.model.state_dict(), jt.state.params)
            if target:
                _assert_bit_equal_params(port.target.state_dict(), jt.state.target_params)
            want_losses = ckpt.losses_to_lists(flax_msgpack.read(b_path)["losses"])
            assert jax_ckpt.losses_to_lists(jax_ckpt.load_checkpoint(b_path)["losses"]) == want_losses
    assert port.cur_iter == jt.cur_iter == 4


def test_resume_and_export_mim_tiny(tmp_path, depth2, capsys):
    """``mim_tiny`` pretraining (SimMIM, depth 2): the chain ``scale_by_adam ->
    add_decayed_weights -> scale_by_learning_rate``."""
    jcfg, cfg = _jax_cfg(_cfg_dict("mim_tiny"))
    _round_trip(tmp_path, JaxMIMPretrainer(jcfg), MIMPretrainer(cfg, dtype=torch.float32, device="cpu"),
                _batches(4, 16, 3), lambda jt, bs: {"mask": _mim_masks(jt, bs)},
                lambda port, s: float(port.schedule(s)))
    out = capsys.readouterr().out
    assert "seeded from seed 0 and step 2" in out and "starts fresh" not in out


def test_resume_and_export_scan_layout(tmp_path, depth2):
    """A ``mimhuge`` model (D = 64, 16 heads of 4) in JAX's scan layout
    (``scan_blocks``): its params and AdamW moments stacked over the blocks
    load into the port's loop layout through ``adapt_block_layout``, and
    the port's loop-layout file loads back into JAX's scan tree."""
    d = _cfg_dict("mim_tiny_large", ARCHITECTURE={"model_type": "mimhuge", "scan_blocks": "True"})
    jcfg, cfg = _jax_cfg(d)
    jt = JaxMIMPretrainer(jcfg)
    assert "blocks" in jt.state.params["encoder"]
    _round_trip(tmp_path, jt, MIMPretrainer(cfg, dtype=torch.float32, device="cpu"),
                _batches(4, 16, 4), lambda jt, bs: {"mask": _mim_masks(jt, bs)},
                lambda port, s: float(port.schedule(s)))


@pytest.mark.parametrize("method", ["ft", "fs", "lp"])
def test_resume_and_export_predictor(tmp_path, depth2, method):
    """``z_tiny`` (mse, ``map`` pool over ``mim_tiny``'s backbone, depth 2,
    no augmentation) as ``ft`` (layer-decay groups, ``scale_by_tree``), ``fs``
    and ``lp`` (``multi_transform``: the frozen leaves have empty moments)."""
    d = _cfg_dict("z_tiny", TRAINING={"train_method": method, "augment": "False"})
    jcfg, cfg = _jax_cfg(d)
    jmae, mae = _jax_cfg(_cfg_dict("mim_tiny"))
    _round_trip(tmp_path, JaxPredictorTrainer(jcfg, jmae),
                PredictorTrainer(cfg, mae, dtype=torch.float32, device="cpu"),
                _batches(4, 16, 5, labels=True), lambda jt, bs: {},
                lambda port, s: float(port.schedule(s)))  # the largest group's: scales <= 1
    if method == "lp":
        sd = flax_msgpack.read(str(tmp_path / "b.ckpt.msgpack"))["opt_state"]
        adam = optim.find_adam_state(sd)
        assert adam["mu"]["cls_token"] == {} and adam["mu"]["head"]["kernel"].shape == (48, 1)


def test_resume_and_export_jepa(tmp_path, depth2):
    """I-JEPA (``jepa_tiny``'s geometry at depth 2, D = 64): its own chain
    (the scheduled decay) and the EMA ``target_params`` tree."""
    d = {"DATA": {}, "TRAINING": dict(batch_size=8, ema="[0.9, 1.0]", total_batch_iters=10,
                                      weight_decay=0.04, final_weight_decay=0.4, start_lr=2e-4,
                                      ref_lr=1e-3, final_lr=1e-6),
         "MASK": dict(allow_overlap=False, aspect_ratio="[0.75, 1.5]", enc_mask_scale="[0.85, 1.0]",
                      min_keep=5, num_enc_masks=1, num_pred_masks=4, pred_mask_scale="[0.15, 0.2]"),
         "ARCHITECTURE": dict(img_size=16, num_channels=3, pixel_mean=0.0, pixel_std=1.0,
                              patch_size=4, model_type="tiny", pred_depth=2, pred_emb_dim=96)}
    jcfg, cfg = JaxConfig.from_dict(d, name="jepa_t"), Config.from_dict(d, name="jepa_t")
    batches = [{**b, "cutouts": np.maximum(b["cutouts"], -3.0)} for b in _batches(4, 8, 6)]
    _round_trip(tmp_path, JaxJEPATrainer(jcfg), JEPATrainer(cfg, device="cpu"), batches,
                lambda jt, bs: {"masks": _jepa_masks(jt, bs)},
                lambda port, s: float(port.lr_schedule(s)), target=True)


def test_warm_start_from_a_jax_mim_checkpoint(tmp_path, depth2):
    """``PredictorTrainer.warm_start`` from JAX's MIM file gives the model that
    a warm start from the port's file of the same weights gives, and it
    holds JAX's MIM weights."""
    jcfg, cfg = _jax_cfg(_cfg_dict("mim_tiny"))
    jt = JaxMIMPretrainer(jcfg)
    jt.train_batch(_batches(1, 16, 7)[0])
    jax_file, port_file = str(tmp_path / "m.ckpt.msgpack"), str(tmp_path / "m.ckpt.pt")
    jt.save(jax_file)
    mim = MIMPretrainer(cfg, dtype=torch.float32, device="cpu")
    assert mim.restore(jax_file)
    mim.save(port_file)
    _, pcfg = _jax_cfg(_cfg_dict("z_tiny"))
    models = []
    for path in (jax_file, port_file):
        tr = PredictorTrainer(pcfg, cfg, dtype=torch.float32, seed=3, device="cpu")
        assert tr.warm_start(path)
        models.append(tr.model.state_dict())
    assert set(models[0]) == set(models[1])
    for name in models[0]:
        torch.testing.assert_close(models[0][name], models[1][name], rtol=0, atol=0, msg=name)
    want = _flat(jax.device_get(jt.state.params))
    np.testing.assert_array_equal(models[0]["encoder.block1.attn.qkv.kernel"].numpy(),
                                  np.asarray(want["encoder.block1.attn.qkv.kernel"]))


def test_restore_without_optimizer_state_starts_fresh(tmp_path, depth2, capsys):
    """A file without ``opt_state`` or ``rng`` (the porting tools') resumes at
    its step with a fresh AdamW and a generator seeded from (seed, step),
    each said in one line; both formats."""
    _, cfg = _jax_cfg(_cfg_dict("mim_tiny"))
    tr = MIMPretrainer(cfg, dtype=torch.float32, device="cpu")
    params = tr.model.state_dict()
    for path, payload in (
            (str(tmp_path / "t.ckpt.msgpack"),
             {"step": np.asarray(7, np.int32),
              "params": ckpt.nest({k: v.numpy() for k, v in params.items()}), "losses": {}}),
            (str(tmp_path / "t.ckpt.pt"), {"step": 7, "params": params, "losses": {}})):
        ckpt.save_checkpoint(path, payload)
        fresh = MIMPretrainer(cfg, dtype=torch.float32, seed=4, device="cpu")
        assert fresh.restore(path) and fresh.cur_iter == 7 and not fresh.optimizer.state
        out = capsys.readouterr().out
        assert "AdamW starts fresh at step 7" in out and "seed 4 and step 7" in out
        want = torch.Generator().manual_seed(ckpt.generator_seed(4, 7)).get_state()
        assert torch.equal(fresh.mask_gen.get_state(), want)


# ---------------------------------------------------------------------------
# the porting tool's twin

def _oracle(kind):
    from tests.torch_oracle import OracleMaskedAutoencoderViT, OracleVisionTransformer

    geom = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=48, depth=2, num_heads=4)
    if kind == "simmim":
        model = OracleMaskedAutoencoderViT(simmim=True, norm_pix_loss=True, loss_fn="l1", **geom)
    else:
        model = OracleVisionTransformer(global_pool="map", num_classes=1, **geom)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        if kind == "simmim":  # the frozen sin-cos table, which both packages recompute
            model.pos_embed.copy_(torch.from_numpy(sincos_pos_embed_2d(48, 4, 1))[None])
    return model.eval(), geom


@pytest.mark.parametrize("kind", ["simmim", "predictor"])
def test_port_tool_twin_writes_the_jax_tools_file(tmp_path, monkeypatch, capsys, kind):
    """The twin's ``.ckpt.msgpack`` of a reference ``.pth.tar`` (an oracle's
    timm-named state dict with ``batch_iters`` and ``losses``) is the JAX
    tool's file byte for byte; its ``.ckpt.pt`` holds the same params; the
    port's model loaded from either matches the oracle's forward."""
    import tools.port_torch_checkpoint as jax_tool

    oracle, geom = _oracle(kind)
    src = str(tmp_path / "ref.pth.tar")
    torch.save({"batch_iters": 9, "losses": {"train_loss": [0.5, 0.4]},
                "model": oracle.state_dict()}, src)
    name, flags = ("mim_tiny", []) if kind == "simmim" else ("z_tiny", ["--predictor"])
    jax_out = str(tmp_path / "jax.ckpt.msgpack")
    monkeypatch.setattr(sys, "argv", ["port", src, name, jax_out, *flags, "--config_dir", CONFIGS])
    jax_tool.main()
    outs = [str(tmp_path / "port.ckpt.msgpack"), str(tmp_path / "port.ckpt.pt")]
    for out in outs:
        port_tool.main([src, name, out, *flags, "--config_dir", CONFIGS])
    assert "optimizer state is not ported" in capsys.readouterr().out
    with open(jax_out, "rb") as f, open(outs[0], "rb") as g:
        assert f.read() == g.read()
    x = _images(4, 8)
    rng = np.random.default_rng(9)
    mask = torch.from_numpy((rng.uniform(size=x.shape) < 0.5).astype(np.float32))
    with torch.no_grad():
        if kind == "simmim":
            want = oracle(torch.from_numpy(x), mask=mask)[0]
        else:
            want = oracle(torch.from_numpy(x))
    for out in outs:
        if kind == "simmim":
            model = SkyMIM(simmim=True, norm_pix_loss=True, loss_fn="l1", **geom)
        else:
            model = SkyViT(global_pool="map", num_labels=1, zero_pos_embed=True, **geom)
        payload = ckpt.load_checkpoint(out)
        assert int(np.asarray(payload["step"])) == 9
        if ckpt.is_jax_checkpoint(out):
            load_jax_params(model, payload["params"])
        else:
            model.load_state_dict(payload["params"])
        with torch.no_grad():
            got = model(torch.from_numpy(x), mask=mask)[0] if kind == "simmim" else \
                model(torch.from_numpy(x))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5)


def test_port_imports_no_msgpack_flax_or_ml_dtypes():
    """The modules of this slice, and every other module of the port,
    import neither jax nor flax, msgpack, ml_dtypes or the JAX package: the
    card host has none of them."""
    import pkgutil
    import subprocess

    import sky_embeddings_tpu_torch as pkg

    mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
            if not m.name.endswith("simscore_triton")]
    for new in ("utils.flax_msgpack", "compare_predictors", "struct_sweep",
                "port_torch_checkpoint"):
        assert f"{pkg.__name__}.{new}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "roots = ('jax', 'flax', 'msgpack', 'ml_dtypes', 'sky_embeddings_tpu')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
