"""The port's kernel modules (sky_embeddings_tpu_torch/ops/kernels) against
the JAX package: the plain PyTorch versions against the ``xla_*`` oracles
and against the Pallas kernels run with ``interpret=True``, on the same
numpy inputs; the training kernels' plain versions (attention stash
forward and backward, MLP backward) against ``jax.vjp`` of the Pallas
``fused_attn_block(stash=True)`` and ``fused_mlp_block(stash=False)``. On
CPU tensors the wrappers and their autograd Functions must take the plain
versions and launch nothing.

Bars: fp32 atol 2e-5 (the bar tests/test_kernels.py uses; the Pallas MLP's
A-S erf passes it too); bf16 max|a-b|/max|b| <= 2e-2 (TOL_FWD of
tools/kernel_parity.py) for outputs and 3e-2 (TOL_BWD) for each gradient.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.ops.kernels import attn_block as jab
from sky_embeddings_tpu.ops.kernels import mlp_block as jmb
from sky_embeddings_tpu.ops.kernels import simscore as jss
from sky_embeddings_tpu_torch.ops.kernels import attn_block as tab
from sky_embeddings_tpu_torch.ops.kernels import mlp_block as tmb
from sky_embeddings_tpu_torch.ops.kernels import simscore as tss

TOL_F32 = 2e-5
TOL_BF16 = 2e-2
TOL_BWD = 3e-2
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _assert_close(got, want, dtype, bar=TOL_BF16):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL_F32)
    else:
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
        assert rel <= bar, f"max-rel {rel:.3g} > {bar}"


def _block_inputs(kind, dtype, B=8, N=17, D=48, F=192, seed=2):
    """(x, scale, bias, w_a, b_a, w_b, b_b) as numpy fp32; the activation and
    the two weight matrices are cast to ``dtype`` on each side."""
    rng = np.random.default_rng(seed)
    wa = (D, 3 * D) if kind == "attn" else (D, F)
    wb = (D, D) if kind == "attn" else (F, D)
    ws = 0.08 if kind == "attn" else 0.05
    arrs = [
        rng.normal(size=(B, N, D)).astype(np.float32) * 0.5,
        1.0 + 0.1 * rng.normal(size=D).astype(np.float32),
        0.1 * rng.normal(size=D).astype(np.float32),
        rng.normal(size=wa).astype(np.float32) * ws,
        0.01 * rng.normal(size=wa[1]).astype(np.float32),
        rng.normal(size=wb).astype(np.float32) * ws,
        0.01 * rng.normal(size=D).astype(np.float32),
    ]
    cast = (0, 3, 5)
    j = [jnp.asarray(a).astype(_JDT[dtype]) if i in cast else jnp.asarray(a) for i, a in enumerate(arrs)]
    t = [torch.from_numpy(a).to(_TDT[dtype]) if i in cast else torch.from_numpy(a) for i, a in enumerate(arrs)]
    return j, t


def _as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block_plain_matches_jax(dtype, oracle):
    j, t = _block_inputs("mlp", dtype)
    want = jmb.xla_mlp_block(*j) if oracle == "xla" else jmb.fused_mlp_block(*j, 4, True)
    got = tmb.mlp_block_plain(*t)
    assert got.dtype == _TDT[dtype]
    _assert_close(got.float().numpy(), _as_np(want), dtype)


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_block_plain_matches_jax(dtype, oracle):
    j, t = _block_inputs("attn", dtype, seed=3)
    if oracle == "xla":
        want = jab.xla_attn_block(*j, 4)
    else:
        want = jab.fused_attn_block(*j, 4, 4, 4, True)
    got = tab.attn_block_plain(*t, 4)
    assert got.dtype == _TDT[dtype]
    _assert_close(got.float().numpy(), _as_np(want), dtype)


def _bank_inputs(dtype, N=1000, D=48, seed=4):
    rng = np.random.default_rng(seed)
    bank = rng.normal(size=(N, D)).astype(np.float32)
    target = rng.normal(size=D).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=D).astype(np.float32)
    w /= w.sum()
    jb = jnp.asarray(bank).astype(_JDT[dtype])
    tb = torch.from_numpy(bank).to(_TDT[dtype])
    return (jb, jnp.asarray(target), jnp.asarray(w)), (tb, torch.from_numpy(target), torch.from_numpy(w))


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bank_scores_plain_matches_jax(dtype, oracle):
    j, t = _bank_inputs(dtype)
    if oracle == "xla":
        want = jss.weighted_bank_scores_xla(j[0].astype(jnp.float32), j[1], j[2])
    else:
        want = jss.weighted_bank_scores_pallas(*j, interpret=True, tile_n=256)
    got = tss.weighted_bank_scores_plain(*t)
    assert got.dtype == torch.float32 and got.shape == (1000,)
    _assert_close(got.numpy(), np.asarray(want), dtype)


def test_bank_topk_matches_lax_top_k():
    j, t = _bank_inputs("float32")
    want_v, want_i = jss.bank_topk(*j, 25)
    got_v, got_i = tss.bank_topk(*t, 25)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=TOL_F32)


def test_cpu_tensors_take_plain_path_and_launch_nothing():
    counters = (tmb.fused_mlp_block, tab.fused_attn_block, tss.weighted_bank_scores)
    before = [f.launches for f in counters]
    _, t = _block_inputs("mlp", "bfloat16")
    torch.testing.assert_close(tmb.fused_mlp_block(*t), tmb.mlp_block_plain(*t), rtol=0, atol=0)
    _, t = _block_inputs("attn", "bfloat16", seed=3)
    torch.testing.assert_close(tab.fused_attn_block(*t, 4), tab.attn_block_plain(*t, 4), rtol=0, atol=0)
    _, t = _bank_inputs("bfloat16")
    torch.testing.assert_close(
        tss.weighted_bank_scores(*t), tss.weighted_bank_scores_plain(*t), rtol=0, atol=0
    )
    assert [f.launches for f in counters] == before == [0, 0, 0]


# -- training kernels: stash forward/backward, MLP backward --------------------

_GRADS = {"attn": ("dx", "dscale", "dbias", "dwqkv", "dbqkv", "dwproj", "dbproj"),
          "mlp": ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")}


def _train_inputs(kind, dtype, seed):
    """B=4, N=17, D=64, H=4, F=256 block inputs and an output gradient g."""
    j, t = _block_inputs(kind, dtype, B=4, N=17, D=64, F=256, seed=seed)
    g = np.random.default_rng(seed + 100).normal(size=(4, 17, 64)).astype(np.float32)
    return j, t, jnp.asarray(g).astype(_JDT[dtype]), torch.from_numpy(g).to(_TDT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_stash_plain_matches_jax_vjp(dtype):
    j, t, jg, tg = _train_inputs("attn", dtype, seed=21)
    out, vjp = jax.vjp(lambda *a: jab.fused_attn_block(*a, 4, 4, 4, True, True), *j)
    want = vjp(jg)
    got_out, qkv, probs = tab.attn_block_fwd_stash_plain(*t, 4)
    _assert_close(got_out.float().numpy(), _as_np(out), dtype)
    # the stash itself against the Pallas stash forward
    _, jqkv, jprobs = jab._pallas_fwd_stash(
        j[0], j[1].reshape(1, -1), j[2].reshape(1, -1), j[3], j[4].reshape(1, -1), j[5],
        j[6].reshape(1, -1), 4, 4, True)
    assert qkv.shape == (4, 17, 192) and probs.shape == (4, 4, 17, 17)
    _assert_close(qkv.float().numpy(), _as_np(jqkv), dtype)
    _assert_close(probs.float().numpy(), _as_np(jprobs), dtype)
    got = tab.attn_block_bwd_stash_plain(t[0], t[1], t[2], t[3], t[5], qkv, probs, tg, 4)
    for name, a, b, leaf in zip(_GRADS["attn"], got, want, t):
        assert a.dtype == leaf.dtype and a.shape == leaf.shape, name
        _assert_close(a.float().numpy(), _as_np(b), dtype, TOL_BWD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_bwd_plain_matches_jax_vjp(dtype):
    j, t, jg, tg = _train_inputs("mlp", dtype, seed=22)
    _, vjp = jax.vjp(lambda *a: jmb.fused_mlp_block(*a, 4, True, False), *j)
    want = vjp(jg)
    got = tmb.mlp_block_bwd_plain(*t[:6], tg)
    for name, a, b, leaf in zip(_GRADS["mlp"], got, want, t):
        assert a.dtype == leaf.dtype and a.shape == leaf.shape, name
        _assert_close(a.float().numpy(), _as_np(b), dtype, TOL_BWD)


@pytest.mark.parametrize("kind", ["attn", "mlp"])
def test_autograd_functions_take_plain_versions_on_cpu(kind):
    """``fused_*`` with grad on CPU tensors: the Function's backward equals the
    plain backward exactly, and nothing is launched."""
    _, t, _, tg = _train_inputs(kind, "bfloat16", seed=23)
    leaves = [a.detach().clone().requires_grad_() for a in t]
    counters = (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd_stash,
                tmb.fused_mlp_block, tmb.mlp_block_bwd)
    before = [f.launches for f in counters]
    if kind == "attn":
        out = tab.fused_attn_block(*leaves, 4)
        want = tab.attn_block_bwd_stash_plain(t[0], t[1], t[2], t[3], t[5],
                                              *tab.attn_block_fwd_stash_plain(*t, 4)[1:], tg, 4)
    else:
        out = tmb.fused_mlp_block(*leaves)
        want = tmb.mlp_block_bwd_plain(*t[:6], tg)
    out.backward(tg)
    got = [leaf.grad for leaf in leaves]
    for name, a, b in zip(_GRADS[kind], got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert [f.launches for f in counters] == before


def test_unported_backwards_differentiate_the_plain_versions_on_cpu():
    """``stash=False`` (attention) and ``stash=True`` (MLP) need TPU kernels
    not ported yet; on the CPU they run through autograd of the plain
    forwards, which in fp32 gives the same gradients as the kernels' path."""
    for kind, kw, alt in (("attn", {"stash": False}, {}), ("mlp", {"stash": True}, {})):
        _, t, _, tg = _train_inputs(kind, "float32", seed=24)
        fn = (lambda *a, **k: tab.fused_attn_block(*a, 4, **k)) if kind == "attn" else tmb.fused_mlp_block
        grads = []
        for opts in (kw, alt):
            leaves = [a.detach().clone().requires_grad_() for a in t]
            fn(*leaves, **opts).backward(tg)
            grads.append([leaf.grad for leaf in leaves])
        for name, a, b in zip(_GRADS[kind], *grads):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=TOL_F32, msg=f"{kind} {name}")
