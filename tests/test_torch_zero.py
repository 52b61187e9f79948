"""The port's data parallelism on two gloo ranks (CPU) against the JAX
package and against one process: SimMIM (``mim_tiny`` cut to depth 2,
D = 48), ZeRO-1 and its checkpoints.

One spawn of two ranks (``torch_parallel_workers.mim_job``) serves every
test here; the JAX references run in this process on conftest's 8-device
mesh:

- the loss denominator: a batch with NaN bands and SimMIM masks of ratio
  about 0.2 on rank 0's rows and 0.8 on rank 1's; the 2-rank DDP loss and
  every gradient equal one process over the concatenated batch to fp32
  rounding, while the mean of the ranks' own masked means (what DDP's
  averaging of per-rank losses gives) is far off;
- remat's gradients bit-equal to the stored path's under DDP;
- three AdamW steps of ``MIMPretrainer`` with ``zero_optimizer = True`` on
  2 ranks against JAX's jitted step over the 8-device mesh with
  ``parallel.zero.shard_opt_state`` on the same global batches and
  ``jax.random`` masks, sliced per rank for the port (losses 1e-5
  relative, parameters 1e-4 absolute, as ``test_torch_train.py``), and
  against the port's one-process trainer over the global batch
  (parameters 2e-6, JAX's own bound in ``test_zero.py``; the key third of
  each qkv bias, whose gradient is rounding noise, to the steps' summed
  lr: ``parallel/smoke.param_gaps``);
- ZeRO-1 against unsharded DDP: each rank's optimizer holds a proper
  subset of the moments, together all of them; parameters and the
  consolidated moments bit-equal to the unsharded optimizer's;
- the checkpoint written by rank 0 in both formats, restored on both ranks
  (each rank's share bit-equal, the next step bit-equal to the
  uninterrupted one), the ``.ckpt.msgpack`` loaded by the JAX trainer;
- ``create_mesh``, ``batch_sharding``, ``device_prefetch(sharding=...)``
  and ``put_global`` under the group.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_workers as tpw
from sky_embeddings_tpu.configuration import Config as JaxConfig
from sky_embeddings_tpu.configuration import load_config as jax_load_config
from sky_embeddings_tpu.models import mim as jax_mim
from sky_embeddings_tpu.models.mim import build_mim_model as jax_build_mim_model
from sky_embeddings_tpu.ops.masking import simmim_batch_mask as jax_simmim_batch_mask
from sky_embeddings_tpu.ops.masking import upsample_patch_mask as jax_upsample
from sky_embeddings_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from sky_embeddings_tpu.parallel.mesh import create_mesh as jax_create_mesh
from sky_embeddings_tpu.parallel.zero import shard_opt_state
from sky_embeddings_tpu.train.optim import pretrain_optimizer as jax_pretrain_optimizer
from sky_embeddings_tpu.train.pretrain import MIMPretrainer as JaxMIMPretrainer
from sky_embeddings_tpu.train.schedules import cosine_annealing as jax_cosine
from sky_embeddings_tpu_torch.configuration import Config
from sky_embeddings_tpu_torch.data.synthetic import make_cutouts
from sky_embeddings_tpu_torch.models import mim as port_mim
from sky_embeddings_tpu_torch.models.mim import build_mim_model
from sky_embeddings_tpu_torch.models.weights import params_from_jax
from sky_embeddings_tpu_torch.parallel.mesh import Sharding
from sky_embeddings_tpu_torch.parallel.smoke import param_gaps
from sky_embeddings_tpu_torch.train.pretrain import MIMPretrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16  # the global batch: 8 rows a rank
DEPTH = {"mim": {"base": {"depth": 2}}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _inputs():
    """mim_tiny's config (dict), JAX params perturbed on every leaf, four
    global batches with NaN bands and their jax.random masks, and the
    denominator case's cutouts and per-rank-ratio mask."""
    base = jax_load_config("mim_tiny", os.path.join(REPO, "configs"))
    d = {sec: dict(base[sec].items()) for sec in base.sections()}
    d["TRAINING"]["batch_size"] = str(B)
    cfg = JaxConfig.from_dict(d)
    model = jax_build_mim_model(cfg, dtype=jnp.float32)
    imgs = jnp.zeros((2, 3, 16, 16), jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), imgs, mask=jnp.zeros_like(imgs))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape)).astype(np.float32), params)
    data = make_cutouts(4 * B, channels=3, img_size=16, seed=7)
    assert np.isnan(data["cutouts"]).any()
    rd = np.stack([data["ra"], data["dec"]], 1)
    batches = [{"cutouts": data["cutouts"][B * i:B * (i + 1)], "ra_dec": rd[B * i:B * (i + 1)]}
               for i in range(4)]
    masks = [np.array(jax_simmim_batch_mask(jax.random.PRNGKey(i), B, 3, 16, 4, 0.9))
             for i in range(4)]
    ratio = np.repeat([0.2, 0.8], B // 2)[:, None, None, None]
    patch = (rng.random((B, 3, 4, 4)) < ratio).astype(np.float32)
    nan_mask = np.array(jax_upsample(jnp.asarray(patch), 4))
    return d, cfg, model, params, batches, masks, batches[0]["cutouts"].copy(), nan_mask


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX references, the port's one-process references and the two
    ranks' results."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_mim, port_mim):
            mp.setitem(mod._SIZES["base"], "depth", 2)
        d, jcfg, jmodel, params, batches, masks, nan_x, nan_mask = _inputs()
        state = params_from_jax(params)

        # JAX: ZeRO-1 over the 8-device mesh, the global batch data-sharded
        mesh = jax_create_mesh()
        rep, data_sh = NamedSharding(mesh, P()), jax_batch_sharding(mesh)
        tx = jax_pretrain_optimizer(params, jax_cosine(1e-3, jcfg.training.int("total_batch_iters"),
                                                       1e7), 0.05)
        jp = jax.device_put(jax.tree_util.tree_map(jnp.asarray, params), rep)
        opt_state, opt_sh = shard_opt_state(mesh, tx, tx.init(jp), jp)

        def jstep(p, s, x, m):
            loss, g = jax.value_and_grad(lambda q: jmodel.apply({"params": q}, x, mask=m)[0])(p)
            updates, s = tx.update(g, s, p)
            return optax.apply_updates(p, updates), s, loss

        jstep = jax.jit(jstep, out_shardings=(rep, opt_sh, None))
        jax_losses = []
        for b, m in zip(batches[:3], masks[:3]):
            x = jax.device_put(jnp.maximum(jnp.asarray(b["cutouts"]), -3.0), data_sh)
            jp, opt_state, loss = jstep(jp, opt_state, x, jax.device_put(jnp.asarray(m), data_sh))
            jax_losses.append(float(loss))
        jax_params = {k: np.asarray(v) for k, v in _flat(jax.device_get(jp)).items()}

        # the port, one process over the global batches
        cfg = Config.from_dict(d)
        one = MIMPretrainer(cfg, dtype=torch.float32, device="cpu")
        one.model.load_state_dict(state)
        one_losses = [float(one.train_batch(b, mask=torch.from_numpy(m)))
                      for b, m in zip(batches[:3], masks[:3])]
        model = build_mim_model(cfg, device="cpu")
        model.load_state_dict(state)
        x, m = torch.from_numpy(nan_x), torch.from_numpy(nan_mask)
        global_loss = model(x, m)[0]
        global_loss.backward()
        one_grads = tpw.grads(model)
        halves = []
        for r in range(2):
            model.zero_grad(set_to_none=True)
            loss = model(tpw.local_rows(x, r), tpw.local_rows(m, r))[0]
            loss.backward()
            halves.append((float(loss.detach()), tpw.grads(model)))

        out_dir = str(tmp_path_factory.mktemp("zero"))
        ranks = tpw.run_ranks(tpw.mim_job, {
            "cfg": d, "depth": DEPTH, "params": state, "batches": batches, "masks": masks,
            "nan_cutouts": nan_x, "nan_mask": nan_mask, "out_dir": out_dir})

        # the JAX trainer restores the 2-rank run's JAX-format file
        jt = JaxMIMPretrainer(jcfg, dtype=jnp.float32)
        jax_restored = jt.restore(os.path.join(out_dir, "zero.ckpt.msgpack"))
        jax_restored_params = {k: np.asarray(v) for k, v in
                               _flat(jax.device_get(jt.state.params)).items()}
        jax_restored_step = int(jt.state.step)
    torch.set_num_threads(n)
    return dict(start=state, jax_losses=jax_losses, jax_params=jax_params, one_losses=one_losses,
                one_params=tpw.state(one.model), global_loss=float(global_loss.detach()),
                one_grads=one_grads, halves=halves, ranks=ranks, jax_restored=jax_restored,
                jax_restored_params=jax_restored_params, jax_restored_step=jax_restored_step)


def _leaf_gap(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-30)


def test_loss_denominator_is_the_global_batch(run):
    """The two ranks' loss and every gradient equal one process's over the
    concatenated batch (fp32 rounding: 1e-6 relative on the loss, 1e-5 of
    each leaf's largest gradient), and the averaged per-rank losses and
    gradients are off by far more: the counts of masked, finite pixels
    differ about fourfold between the ranks."""
    tol_loss, tol_grad = 1e-6, 1e-5
    for r in run["ranks"]:
        got = r["stored"]
        assert abs(float(got["loss"]) - run["global_loss"]) <= tol_loss * abs(run["global_loss"])
        for name, want in run["one_grads"].items():
            g = got["grads"][name]
            if want is None:
                assert g is None, name
                continue
            assert _leaf_gap(g, want) <= tol_grad, (name, _leaf_gap(g, want))
    naive = np.mean([h[0] for h in run["halves"]])
    assert abs(naive - run["global_loss"]) > 100 * tol_loss * abs(run["global_loss"])
    name = "encoder.block0.attn.proj.kernel"
    naive_grad = (run["halves"][0][1][name] + run["halves"][1][1][name]) / 2
    assert _leaf_gap(naive_grad, run["one_grads"][name]) > 100 * tol_grad


def test_remat_gradients_bit_equal_under_ddp(run):
    for r in run["ranks"]:
        assert torch.equal(r["remat"]["loss"], r["stored"]["loss"])
        for name, g in r["stored"]["grads"].items():
            other = r["remat"]["grads"][name]
            assert (g is None and other is None) or torch.equal(g, other), name


def test_zero_steps_match_jax_over_the_8_device_mesh(run):
    """Losses 1e-5 relative, parameters 1e-4 absolute; the key third of
    each qkv bias to the three steps' summed lr (3e-3 bounds it): its
    gradient is rounding noise (shown here on one process's gradient), whose
    Adam step the order of JAX's 8-way sum decides."""
    kb = run["one_grads"]["encoder.block0.attn.qkv.bias"].reshape(3, -1)
    assert float(kb[1].norm()) < 1e-5 * float(kb[0].norm())
    want = {k: torch.tensor(v) for k, v in run["jax_params"].items()}
    for r in run["ranks"]:
        z = r["zero"]
        assert z["sharded"]
        np.testing.assert_allclose(z["losses"], run["jax_losses"], rtol=1e-5)
        assert set(z["params"]) == set(want)
        rest, keys = param_gaps(z["params"], want)
        assert rest <= 1e-4 and keys <= 3e-3, (rest, keys)
    moved = max(float((v - run["start"][k]).abs().max()) for k, v in z["params"].items())
    assert moved > 1e-3  # the bound is below one step's size


def test_zero_steps_match_one_process(run):
    """Parameters within 2e-6 of one process over the global batch (the
    key biases to the summed lr) and losses within 1e-6 relative; both
    ranks bit-equal."""
    r0, r1 = (r["zero"] for r in run["ranks"])
    assert r0["losses"] == r1["losses"]
    assert all(torch.equal(v, r1["params"][k]) for k, v in r0["params"].items())
    np.testing.assert_allclose(r0["losses"], run["one_losses"], rtol=1e-6)
    rest, keys = param_gaps(r0["params"], run["one_params"])
    assert rest <= 2e-6 and keys <= 3e-3, (rest, keys)


def test_zero_partitions_the_moments_and_matches_unsharded(run):
    names = [set(r["zero"]["local_state_names"]) for r in run["ranks"]]
    every = set(run["ranks"][0]["zero"]["all_names"])
    assert all(n and n < every for n in names)
    assert names[0] | names[1] == every and not names[0] & names[1]
    full = run["ranks"][0]["ddp"]["moment_bytes"]
    for r in run["ranks"]:
        assert not r["ddp"]["sharded"]
        assert 0.4 * full < r["zero"]["moment_bytes"] < 0.6 * full
        assert r["zero"]["losses"] == r["ddp"]["losses"]
        assert all(torch.equal(v, r["ddp"]["params"][k]) for k, v in r["zero"]["params"].items())
    assert run["ranks"][0]["consolidated_equal_unsharded"]


@pytest.mark.parametrize("fmt", [".ckpt.pt", ".ckpt.msgpack"])
def test_zero_checkpoint_round_trip(run, fmt):
    for r in run["ranks"]:
        assert r["restored"][fmt] == {"state_equal": True, "step_bit_equal": True}


def test_zero_msgpack_loads_in_the_jax_trainer(run):
    assert run["jax_restored"] and run["jax_restored_step"] == 3
    got = run["ranks"][0]["zero"]["params"]
    assert set(run["jax_restored_params"]) == set(got)
    for name, v in run["jax_restored_params"].items():
        np.testing.assert_array_equal(v, got[name].numpy(), err_msg=name)


def test_mesh_prefetch_and_put_global_under_the_group(run):
    for rank, r in enumerate(run["ranks"]):
        assert r["mesh"] == ((2, 1), ("data", "model"))
        assert r["batch_sharding"] == Sharding(torch.device("cpu"), True, rank, 2)
        assert r["replicated"] == Sharding(torch.device("cpu"), False, 0, 1)
        assert r["prefetch_equal"] and r["put_global_equal"]
