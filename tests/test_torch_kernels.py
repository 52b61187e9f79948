"""The port's kernel modules (sky_embeddings_tpu_torch/ops/kernels) against
the JAX package: the plain PyTorch versions against the ``xla_*`` oracles
and against the Pallas kernels run with ``interpret=True``, on the same
numpy inputs; the training kernels' plain versions (attention stash forward
and backward, attention recompute backward on both of its bodies, MLP
backward, MLP stash forward and backward) against the Pallas kernels and
against ``jax.vjp`` of the Pallas ``fused_attn_block`` and
``fused_mlp_block`` with each ``stash`` setting. On CPU tensors the wrappers
and their autograd Functions must take the plain versions and launch
nothing.

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


@pytest.fixture(autouse=True)
def _full_fp32_products():
    """Every test here compares fp32 products of the two frameworks at an
    absolute 2e-5. Pin both to full fp32 products for the test, whatever an
    earlier test in the same worker process left set: torch's fp32 matmul
    precision (``"medium"`` would run bf16 products on CPUs with AMX) and
    JAX's default matmul precision."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(prev)


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


def _mlp_stash_inputs(dtype, seed):
    """Block inputs, g, and the JAX stash forward's (out, a) on them."""
    j, t, jg, tg = _train_inputs("mlp", dtype, seed)
    jout, ja = jmb._pallas_fwd_stash(j[0], j[1].reshape(1, -1), j[2].reshape(1, -1), j[3],
                                     j[4].reshape(1, -1), j[5], j[6].reshape(1, -1), 4, True)
    return j, t, jg, tg, jout, ja


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_stash_forward_plain_matches_pallas(dtype):
    """Kernel 6: ``(out, a)`` against ``_pallas_fwd_stash`` in interpret mode."""
    _, t, _, _, jout, ja = _mlp_stash_inputs(dtype, seed=25)
    out, a = tmb.mlp_block_fwd_stash_plain(*t)
    assert out.dtype == a.dtype == _TDT[dtype] and a.shape == (4 * 17, 256)
    _assert_close(out.float().numpy(), _as_np(jout), dtype)
    _assert_close(a.float().numpy(), _as_np(ja), dtype)
    torch.testing.assert_close(out, tmb.mlp_block_plain(*t), rtol=0, atol=0)


@pytest.mark.parametrize("oracle", ["pallas_interpret", "vjp"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_stash_bwd_plain_matches_jax(dtype, oracle):
    """Kernel 7 from the same stashed ``a``: against ``_pallas_bwd_stash``;
    and, each side from its own stash forward, against ``jax.vjp`` of
    ``fused_mlp_block(stash=True)``."""
    j, t, jg, tg, _, ja = _mlp_stash_inputs(dtype, seed=26)
    if oracle == "pallas_interpret":
        want = jmb._pallas_bwd_stash(j[0], j[1].reshape(1, -1), j[2].reshape(1, -1), j[3], j[5],
                                     ja, jg, 4, True)
        want = [w.reshape(-1, *w.shape[2:]) if w.shape[0] == 1 else w for w in want]
        a = torch.from_numpy(np.array(_as_np(ja))).to(_TDT[dtype])
    else:
        _, vjp = jax.vjp(lambda *a: jmb.fused_mlp_block(*a, 4, True, True), *j)
        want = vjp(jg)
        a = tmb.mlp_block_fwd_stash_plain(*t)[1]
    got = tmb.mlp_block_bwd_stash_plain(t[0], t[1], t[2], t[3], t[5], a, tg)
    for name, a_, b, leaf in zip(_GRADS["mlp"], got, want, t):
        assert a_.shape == leaf.shape, name
        if oracle == "vjp":
            assert a_.dtype == leaf.dtype, name
        _assert_close(a_.float().numpy(), _as_np(b), dtype, TOL_BWD)


@pytest.mark.parametrize("body", ["unrolled", "loop_heads"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_recompute_bwd_plain_matches_jax_vjp(dtype, body):
    """Kernel 4 against ``jax.vjp`` of ``fused_attn_block(stash=False)``: D=64
    with 4 heads of 16 takes ``_bwd_kernel``; D=128 with 4 heads of 32 (a
    group of 4 heads per 128 lanes) takes ``_bwd_kernel_loop``."""
    D = 64 if body == "unrolled" else 128
    assert jab._use_loop_heads(4, D // 4) == (body == "loop_heads")
    j, t = _block_inputs("attn", dtype, B=4, N=17, D=D, seed=27)
    g = np.random.default_rng(127).normal(size=(4, 17, D)).astype(np.float32)
    jg, tg = jnp.asarray(g).astype(_JDT[dtype]), torch.from_numpy(g).to(_TDT[dtype])
    _, vjp = jax.vjp(lambda *a: jab.fused_attn_block(*a, 4, 4, 4, True, False), *j)
    want = vjp(jg)
    got = tab.attn_block_bwd_plain(t[0], t[1], t[2], t[3], t[4], t[5], tg, 4)
    for name, a, b, leaf in zip(_GRADS["attn"], got, want, t):
        assert a.dtype == leaf.dtype and a.shape == leaf.shape, name
        _assert_close(a.float().numpy(), _as_np(b), dtype, TOL_BWD)


@pytest.mark.parametrize("kind", ["attn", "mlp", "attn_recompute", "mlp_stash"])
def test_autograd_functions_take_plain_versions_on_cpu(kind):
    """``fused_*`` with grad on CPU tensors, each ``stash`` setting: the
    Function's backward equals the plain backward exactly, and nothing is
    launched."""
    _, t, _, tg = _train_inputs(kind.split("_")[0], "bfloat16", seed=23)
    leaves = [a.detach().clone().requires_grad_() for a in t]
    counters = (tab.fused_attn_block, tab.attn_block_fwd_stash, tab.attn_block_bwd_stash,
                tab.attn_block_bwd, tmb.fused_mlp_block, tmb.mlp_block_bwd,
                tmb.mlp_block_fwd_stash, tmb.mlp_block_bwd_stash)
    before = [f.launches for f in counters]
    if kind == "attn":
        out = tab.fused_attn_block(*leaves, 4)
        want = tab.attn_block_bwd_stash_plain(t[0], t[1], t[2], t[3], t[5],
                                              *tab.attn_block_fwd_stash_plain(*t, 4)[1:], tg, 4)
    elif kind == "attn_recompute":
        out = tab.fused_attn_block(*leaves, 4, stash=False)
        want = tab.attn_block_bwd_plain(*t[:6], tg, 4)
    elif kind == "mlp":
        out = tmb.fused_mlp_block(*leaves)
        want = tmb.mlp_block_bwd_plain(*t[:6], tg)
    else:
        out = tmb.fused_mlp_block(*leaves, stash=True)
        a = tmb.mlp_block_fwd_stash_plain(*t)[1]
        want = tmb.mlp_block_bwd_stash_plain(t[0], t[1], t[2], t[3], t[5], a, tg)
    out.backward(tg)
    got = [leaf.grad for leaf in leaves]
    for name, a, b in zip(_GRADS[kind.split("_")[0]], got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert [f.launches for f in counters] == before
