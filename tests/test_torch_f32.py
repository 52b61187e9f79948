"""The block kernels' fp32 forms on the CPU: the operand-dtype rule of the
CUDA wrappers (``mlp_block.operand_dtype``: a uniform fp32 or bf16 set is
taken by every block kernel, K1, K2 and kernels 2, 3, 4, 6, 7, 8, 9 and the
``seg_len`` forms of K2, 2 and 4; a mixed set is refused, naming the
kernel) and the checks around it, which load no library; heads of any width
taken in fp32 (``mim_tiny``'s 4) and refused in bf16 unless a multiple of
16, before any library loads; the fp32 stash (qkv and probabilities, the
MLP pre-activation, in fp32) and the fp32 plain versions that the card
holds the fp32 forms to, against ``jax.vjp`` of ``xla_attn_block`` /
``xla_mlp_block`` (fp32 atol 2e-5, as ``tests/test_torch_kernels.py``):
kernels 2, 3 and 4 unmasked and masked (``seg_len``), at heads of 4, 16
and 512, kernels 6 and 7, kernel 9 over several slabs; the fp32 GEMM's
plain version (``gemm.gemm_f32_plain``) in each form and epilogue against
numpy. The kernels themselves run on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sky_embeddings_tpu.ops.kernels import attn_block as jab
from sky_embeddings_tpu.ops.kernels import mlp_block as jmb
from sky_embeddings_tpu_torch.ops.kernels import attn_block as tab
from sky_embeddings_tpu_torch.ops.kernels import cuda_build
from sky_embeddings_tpu_torch.ops.kernels import gemm as tg
from sky_embeddings_tpu_torch.ops.kernels import mlp_block as tmb

TOL_F32 = 2e-5


@pytest.fixture(autouse=True)
def _highest_matmul_precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture
def no_library(monkeypatch):
    """Any attempt to load a CUDA library fails the test."""
    def refuse(name):
        raise AssertionError(f"library {name} loaded")
    monkeypatch.setattr(cuda_build, "load", refuse)


def _block(kind, dtype=torch.float32, B=2, N=17, D=64, F=256, seed=0):
    """(x, scale, bias, w_a, b_a, w_b, b_b): x and the weights in ``dtype``,
    LN parameters and biases fp32, from numpy."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    wa, wb = ((D, 3 * D), (D, D)) if kind == "attn" else ((D, F), (F, D))
    return ((0.5 * f32(B, N, D)).to(dtype), 1 + 0.1 * f32(D), 0.1 * f32(D),
            (f32(*wa) * wa[0] ** -0.5).to(dtype), 0.01 * f32(wa[1]),
            (f32(*wb) * wb[0] ** -0.5).to(dtype), 0.01 * f32(wb[1]))


@pytest.mark.parametrize("kernel", tmb.F32_KERNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operand_dtype_takes_a_uniform_set(kernel, dtype):
    x = torch.zeros(2, 3, 8, dtype=dtype)
    w = torch.zeros(8, 8, dtype=dtype)
    assert tmb.operand_dtype(kernel, x, w1=w, w2=w, stash=None) == dtype


@pytest.mark.parametrize("kernel", ["K1", "kernel 3", "kernel 6"])
def test_operand_dtype_refuses_a_mixed_set(kernel):
    f, b = torch.zeros(2, 3, 8), torch.zeros(2, 3, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"w1: torch.bfloat16 beside torch.float32 x.*bf16"):
        tmb.operand_dtype(kernel, f, w1=b[0], w2=f[0])
    with pytest.raises(ValueError, match="probs: torch.float32 beside torch.bfloat16"):
        tmb.operand_dtype(kernel, b, qkv=b, probs=f)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tmb.operand_dtype(kernel, f.half())


@pytest.mark.parametrize("kernel", ["kernel 4", "kernel 6", "kernel 7", "kernel 9", "K2 masked",
                                    "kernel 2 masked", "kernel 4 masked"])
def test_operand_dtype_refuses_fp32_on_the_routes_not_ported(kernel):
    """The routes that took bf16 only until their fp32 forms were written
    (kernels 4, 6, 7, 9 and the seg_len forms) now take a uniform fp32 set,
    as bf16; a mixed set stays refused, naming the kernel."""
    x, w = torch.zeros(2, 3, 8), torch.zeros(8, 8)
    assert kernel in tmb.F32_KERNELS
    assert tmb.operand_dtype(kernel, x, w1=w, w2=w) == torch.float32
    assert tmb.operand_dtype(kernel, x.bfloat16(), w1=w.bfloat16()) == torch.bfloat16
    with pytest.raises(ValueError, match=kernel + r" on CUDA takes bf16 or fp32 operands, all of"):
        tmb.operand_dtype(kernel, x, w1=w, w2=w.bfloat16())


def test_operand_dtype_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="none of the block kernels"):
        tmb.operand_dtype("kernel 3 masked", torch.zeros(2, 3, 8))


def test_mlp_checks_take_fp32_and_refuse_the_stash_and_stream(no_library):
    """Every MLP kernel, the stash and stream ones too, takes fp32 from the
    shapes alone; a mixed set and a non-fp32 bias stay refused."""
    args = _block("mlp")
    assert tmb._check_cuda_args(*args, kernel="K1") == torch.float32
    assert tmb._check_cuda_args(*args[:6], kernel="kernel 8") == torch.float32
    for kernel in ("kernel 6", "kernel 7", "kernel 9"):
        assert tmb._check_cuda_args(*args, kernel=kernel) == torch.float32
    with pytest.raises(ValueError, match="w2: torch.bfloat16 beside torch.float32"):
        tmb._check_cuda_args(*args[:5], args[5].bfloat16(), args[6], kernel="K1")
    with pytest.raises(ValueError, match="b1: want contiguous"):  # biases stay fp32
        tmb._check_cuda_args(*args[:4], args[4].double(), *args[5:], kernel="K1")


def test_attn_checks_take_fp32_and_refuse_kernel_4_and_masks(no_library):
    """Every attention kernel, kernel 4 and the masked forms too, takes fp32
    from the shapes alone (the fp32 cores' plan fits every N <= 256: no
    library asked); a mixed set and a wrong stash stay refused."""
    args = _block("attn")
    assert tab._check_cuda_args(*args, 4, "fwd") == torch.float32
    assert tab._check_cuda_args(*args, 4, "fwd", stash=True) == torch.float32
    assert tab._check_cuda_args(*args[:4], None, args[5], None, 4, "stash") == torch.float32
    assert tab._check_cuda_args(*args, 4, "recompute") == torch.float32
    assert tab._check_cuda_args(*args, 4, "recompute", seg_len=5) == torch.float32
    assert tab._check_cuda_args(*args, 4, "fwd", seg_len=5) == torch.float32
    assert tab._check_cuda_args(*args, 4, "fwd", seg_len=5, stash=True) == torch.float32
    with pytest.raises(ValueError, match="seg_len=-1 must be >= 0"):
        tab._check_cuda_args(*args, 4, "fwd", seg_len=-1)
    # seg_len >= N is no mask
    assert tab._check_cuda_args(*args, 4, "fwd", seg_len=17) == torch.float32
    with pytest.raises(ValueError, match="wproj: torch.bfloat16 beside torch.float32"):
        tab._check_cuda_args(*args[:5], args[5].bfloat16(), args[6], 4, "fwd")
    x, qkv, probs = tab.attn_block_fwd_stash_plain(*args, 4)
    with pytest.raises(ValueError, match="probs: want a contiguous .* torch.float32"):
        tab._check_bwd_inputs(args[0], 4, qkv=qkv, probs=probs.bfloat16(), g=x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("core", ["fwd", "stash", "recompute"])
def test_narrow_heads_are_refused_before_any_library_loads(dtype, core, no_library):
    """mim_tiny's D = 48 in 12 heads of 4, from the shapes alone: every
    attention kernel takes it in fp32, and refuses it in bf16 (its cores'
    mma.sync tiles are 16 wide along the head), saying that fp32 takes it."""
    args = _block("attn", dtype, D=48)
    if dtype == torch.float32:
        assert tab._check_cuda_args(*args, 12, core) == torch.float32
        return
    with pytest.raises(ValueError, match="head dim 4 must be a multiple of 16 in bf16.*fp32 takes"):
        tab._check_cuda_args(*args, 12, core)


def _jax(t):
    return jnp.asarray(t.numpy())


def test_fp32_stash_and_backward_match_jax_vjp_of_xla_attn_block():
    t = _block("attn", B=3, N=17, D=64, seed=3)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 17, 64)).astype(np.float32))
    out, vjp = jax.vjp(lambda *a: jab.xla_attn_block(*a, 4), *map(_jax, t))
    want = vjp(_jax(g))
    got_out, qkv, probs = tab.attn_block_fwd_stash_plain(*t, 4)
    assert got_out.dtype == qkv.dtype == probs.dtype == torch.float32
    assert qkv.shape == (3, 17, 192) and probs.shape == (3, 4, 17, 17)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=TOL_F32)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
    got = tab.attn_block_bwd_stash_plain(t[0], t[1], t[2], t[3], t[5], qkv, probs, g, 4)
    for a, b, leaf in zip(got, want, t):
        assert a.dtype == torch.float32 and a.shape == leaf.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_F32)


# (B, N, D, H, seg_len): heads of 16 at ViT-B's N, mim_tiny's 4 (D = 48 in
# 12 heads), mae_tiny's encoder packing (four samples of 5 tokens, 16
# heads of 4 at D = 64) and its 512-wide one-head decoder, segments of 17
# at N = 34 and ragged ones (N not a multiple of seg_len)
ATTN_CASES = [(3, 17, 64, 4, 0), (2, 17, 48, 12, 0), (2, 20, 64, 16, 5), (2, 17, 512, 1, 0),
              (3, 34, 64, 4, 17), (2, 23, 48, 12, 5)]


@pytest.mark.parametrize("B,N,D,H,seg", ATTN_CASES)
def test_fp32_attn_plain_versions_match_jax_vjp_masked_and_at_any_head(B, N, D, H, seg):
    """K2, kernel 2 (masked with seg_len > 0), kernel 3 from that stash and
    kernel 4 (recompute, masked the same way) in fp32 against the output and
    ``jax.vjp`` of ``xla_attn_block(..., seg_len)``: cross-segment
    probabilities exactly 0 in the fp32 stash."""
    t = _block("attn", B=B, N=N, D=D, seed=20 + D + seg)
    g = torch.from_numpy(np.random.default_rng(21).normal(size=(B, N, D)).astype(np.float32))
    out, vjp = jax.vjp(lambda *a: jab.xla_attn_block(*a, H, seg), *map(_jax, t))
    want = vjp(_jax(g))
    np.testing.assert_allclose(tab.attn_block_plain(*t, H, seg).numpy(), np.asarray(out),
                               atol=TOL_F32)
    got_out, qkv, probs = tab.attn_block_fwd_stash_plain(*t, H, seg)
    assert got_out.dtype == qkv.dtype == probs.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=TOL_F32)
    if seg:
        ids = torch.arange(N) // seg
        cross = ids[:, None] != ids[None, :]
        assert bool((probs[:, :, cross] == 0).all()) and bool(torch.isfinite(probs).all())
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
    stash = tab.attn_block_bwd_stash_plain(t[0], t[1], t[2], t[3], t[5], qkv, probs, g, H)
    recompute = tab.attn_block_bwd_plain(*t[:6], g, H, seg)
    for got in (stash, recompute):
        for a, b, leaf in zip(got, want, t):
            assert a.dtype == torch.float32 and a.shape == leaf.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_F32)


def test_fp32_mlp_plain_versions_match_jax_vjp_of_xla_mlp_block():
    t = _block("mlp", B=3, N=17, D=64, F=256, seed=5)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 17, 64)).astype(np.float32))
    out, vjp = jax.vjp(jmb.xla_mlp_block, *map(_jax, t))
    want = vjp(_jax(g))
    np.testing.assert_allclose(tmb.mlp_block_plain(*t).numpy(), np.asarray(out), atol=TOL_F32)
    got = tmb.mlp_block_bwd_plain(*t[:6], g)
    for a, b, leaf in zip(got, want, t):
        assert a.dtype == torch.float32 and a.shape == leaf.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_F32)


def test_fp32_mlp_stash_plain_versions_match_jax_vjp_of_xla_mlp_block():
    """Kernel 6's plain version keeps the pre-activation in fp32 (x's dtype)
    and its ``out`` is K1's; kernel 7's from that stash gives
    ``jax.vjp`` of ``xla_mlp_block``."""
    t = _block("mlp", B=2, N=17, D=64, F=256, seed=8)
    g = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 17, 64)).astype(np.float32))
    out, vjp = jax.vjp(jmb.xla_mlp_block, *map(_jax, t))
    want = vjp(_jax(g))
    got_out, a = tmb.mlp_block_fwd_stash_plain(*t)
    assert a.dtype == torch.float32 and a.shape == (34, 256)
    assert torch.equal(got_out, tmb.mlp_block_plain(*t))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=TOL_F32)
    y = tmb.layer_norm(t[0].reshape(34, 64), t[1], t[2])
    np.testing.assert_allclose(a.numpy(), (y @ t[3] + t[4]).numpy(), atol=1e-6)
    got = tmb.mlp_block_bwd_stash_plain(*t[:4], t[5], a, g)
    for x, b, leaf in zip(got, want, t):
        assert x.dtype == torch.float32 and x.shape == leaf.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(b), atol=TOL_F32)


def test_fp32_stream_plain_version_matches_jax_vjp_over_several_slabs(monkeypatch):
    """Kernel 9's plain version in fp32 over four slabs of 128 columns (the
    budget cut so that ``_stream_slab`` splits F = 512), with dy summed slab
    by slab, against ``jax.vjp`` of ``xla_mlp_block``; and through
    ``fused_mlp_block(stash="stream")``'s backward."""
    monkeypatch.setattr(tmb, "_STREAM_FIXED_BUDGET", 12 * 64 * 128)
    assert tmb._stream_slab(64, 512) == 128
    t = _block("mlp", B=3, N=17, D=64, F=512, seed=10)
    g = torch.from_numpy(np.random.default_rng(11).normal(size=(3, 17, 64)).astype(np.float32))
    _, vjp = jax.vjp(jmb.xla_mlp_block, *map(_jax, t))
    want = vjp(_jax(g))
    got = tmb.mlp_block_bwd_stream_plain(*t[:6], g)
    for a, b, leaf in zip(got, want, t):
        assert a.dtype == torch.float32 and a.shape == leaf.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_F32)
    leaves = [v.clone().requires_grad_() for v in t]
    tmb.fused_mlp_block(*leaves, stash="stream").backward(g)
    for leaf, b in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(b), atol=TOL_F32)


@pytest.mark.parametrize("form,epi", [(f, e) for f, es in tg.F32_FORM_EPILOGUES.items() for e in es])
def test_gemm_f32_plain_matches_numpy(form, epi):
    """The fp32 GEMM's plain version, which the card holds the kernel to, in
    each form and epilogue (dgelu: da = dh * gelu'(a) and h = gelu(a);
    bias_gelu_stash: gelu(acc + bias) and acc + bias; add: acc + resid)."""
    from scipy.special import erf

    rng = np.random.default_rng(7)
    M, N, K = 12, 8, 20
    sa = {"fwd": (M, K), "nt": (M, K), "tn": (K, M)}[form]
    sb = {"fwd": (K, N), "nt": (N, K), "tn": (K, N)}[form]
    a, b = rng.normal(size=sa).astype(np.float32), rng.normal(size=sb).astype(np.float32)
    bias, resid, aux = (rng.normal(size=s).astype(np.float32) for s in ((N,), (M, N), (M, N)))
    t = lambda v: torch.from_numpy(v)
    got, got_aux = tg.gemm_f32(t(a), t(b), form, epi, t(bias), t(resid), t(aux))
    acc = {"fwd": lambda: a.astype(np.float64) @ b, "nt": lambda: a.astype(np.float64) @ b.T,
           "tn": lambda: a.astype(np.float64).T @ b}[form]()
    gelu = lambda v: 0.5 * v * (1 + erf(v / np.sqrt(2)))
    dgelu = lambda v: 0.5 * (1 + erf(v / np.sqrt(2))) + v * np.exp(-0.5 * v * v) / np.sqrt(2 * np.pi)
    want = {"bias": lambda: acc + bias, "bias_gelu": lambda: gelu(acc + bias),
            "bias_residual": lambda: resid + acc + bias, "store": lambda: acc,
            "dgelu": lambda: acc * dgelu(aux.astype(np.float64)),
            "bias_gelu_stash": lambda: gelu(acc + bias), "add": lambda: acc + resid}[epi]()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if epi == "dgelu":
        np.testing.assert_allclose(got_aux.numpy(), gelu(aux.astype(np.float64)), atol=1e-6)
    elif epi == "bias_gelu_stash":
        np.testing.assert_allclose(got_aux.numpy(), acc + bias, rtol=1e-5, atol=1e-5)
    else:
        assert got_aux is None
    with pytest.raises(ValueError, match="epilogue"):
        tg.gemm_f32_plain(t(a), t(b), form, "dgelu" if form == "fwd" else "bias_gelu")
