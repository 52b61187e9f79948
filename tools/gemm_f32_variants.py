#!/usr/bin/env python3
"""The fp32 GEMM of the blocks' fp32 forms (``csrc/gemm_f32.cuh``) timed
beside fp32 ``torch.mm`` on one CUDA card, with copies of it that take a
part out (what bounds it) and with other slab depths (its error against
the depth over which the tensor cores sum from zero).

    python3 tools/gemm_f32_variants.py [times] [--tree DIR ...] [--rounds N]
    python3 tools/gemm_f32_variants.py strip [--tree DIR]
    python3 tools/gemm_f32_variants.py slab [--tree DIR]
    python3 tools/gemm_f32_variants.py sweep

Every mode builds ``csrc/mlp_block.cu`` of each tree (this checkout by
default; ``--tree`` names another checkout's root, e.g. a parent unpacked
with ``git archive``), whose ``sky_gemm_f32`` entry launches one product,
into its own library (one nvcc each, all at once), and calls that entry
through ctypes on preallocated fp32 operands drawn from one seed
(``torch.randn``, the weights scaled by 1/sqrt(K)). Times are CUDA events
over back-to-back launches, the fastest of ``--rounds`` rounds (4) taken in
turns (tree order, then reversed), so that two trees or variants meet the
same card state. Each product's max|a-b|/max|b| against fp32 ``torch.mm``
with TF32 off (the plain version's product) is printed beside its time.

``times``: every product of ``chip_smoke.py``'s ``gemm_f32_times`` at
``cls_fs_1k`` B=256 (M = 16 896 rows of ViT-B: qkv, proj, fc1, fc2 in the
forward form, dctx, dh, dy_mlp, dy_attn in the NT form, dW1, dW2, dWqkv,
dWproj in the TN form, split along K as the blocks launch them), and the
M = 2 112 products of kernel 4 at ``mim_32`` B=32 (D = 1 024) and of one
kernel 9 slab at ViT-H B=32 (D = fs = 1 280), in TFLOP/s beside
``torch.mm`` / ``torch.addmm`` on the same operands, for each tree, and
whether each tree's output equals the first tree's bit for bit.

``strip``: copies of the tree's ``gemm_f32.cuh`` with a part taken out, at
``cls_fs_1k``'s fc1 (forward), dy_mlp (NT) and dW1 (TN). The copies a tree
gets depend on its design: for the ``mma.sync`` one (the parent of the
wgmma design) ``one_tf32`` (the big x big product alone: no split of
either operand, one product), ``no_split`` (three products of the unsplit
values), ``no_slab_sums`` (every product summed straight into the running
sum: no from-zero slab sums and no fp32 adds) and ``loads_only`` (the
cp.async ring alone); for the wgmma one ``one_tf32``, ``no_split``,
``no_splitter`` (B's planes not written: the consumers read what the ring
holds), ``no_slab_sums`` and ``loads_only`` (no wgmma: the ring, the
split pass and the A fragments' loads alone). A copy's results are wrong
by design; only its time is read.

``slab``: the wgmma design with the slab depth ``SLAB_K`` (the k summed on
the tensor cores from zero before an fp32 add: 8-deep steps inside a ring
slot or whole slots) at 8 to 512 and the whole K, at dW1 (TN, M = 768, N = 3 072, K = 16 896) unsplit and split as the
blocks launch it, at dy_mlp (NT, K = 3 072) and at fc1: max|a-b|/max|b|
against fp32 ``torch.mm`` (TF32 off) and against an fp64 product, the
signed bias against the fp64 product (``Product.signed_bias``: the sums' shrink
toward zero, which the fp32 paths' gradient gaps follow), and the time.

``sweep``: this checkout's GEMM through ``gemm.gemm_f32`` with its plan
forced, at every tile width (128, 64) and, for the TN products, every
split count 1 to 8, at ``cls_fs_1k``'s fc1, dy_mlp and four weight
gradients and at every M = 2 112 product: each time beside the plan's
pick (``gemm.f32_plan``), the data its cost model is fitted to.

Prints the card's name and power limit, a line per product and a JSON line
of every number. Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("sky_embeddings_tpu_torch/ops/kernels/csrc")
FORMS = {"fwd": 0, "nt": 1, "tn": 2}
EPIS = {"bias": 0, "bias_gelu": 1, "bias_residual": 2, "store": 3, "dgelu": 4, "add": 6}

# (name, form, epilogue, M, N, K): cls_fs_1k B=256 (ViT-B, M = 256 x 66)
M_FS, D_B, F_B = 16896, 768, 3072
FS_PRODUCTS = (
    ("qkv", "fwd", "bias", M_FS, 3 * D_B, D_B),
    ("proj", "fwd", "bias_residual", M_FS, D_B, D_B),
    ("fc1", "fwd", "bias_gelu", M_FS, F_B, D_B),
    ("fc2", "fwd", "bias_residual", M_FS, D_B, F_B),
    ("dctx", "nt", "store", M_FS, D_B, D_B),
    ("dh", "nt", "dgelu", M_FS, F_B, D_B),
    ("dy_mlp", "nt", "store", M_FS, D_B, F_B),
    ("dy_attn", "nt", "store", M_FS, D_B, 3 * D_B),
    ("dW1", "tn", "store", D_B, F_B, M_FS),
    ("dW2", "tn", "store", F_B, D_B, M_FS),
    ("dWqkv", "tn", "store", D_B, 3 * D_B, M_FS),
    ("dWproj", "tn", "store", D_B, D_B, M_FS),
)
# M = 2 112: kernel 4 at mim_32 B=32 (N = 66, D = 1 024) and one slab of
# kernel 9 at ViT-H B=32 (N = 66, D = 1 280, fs = 1 280)
M_S = 2112
SMALL_PRODUCTS = (
    ("k4_qkv", "fwd", "bias", M_S, 3 * 1024, 1024),
    ("k4_dctx", "nt", "store", M_S, 1024, 1024),
    ("k4_dy", "nt", "store", M_S, 1024, 3 * 1024),
    ("k4_dWqkv", "tn", "store", 1024, 3 * 1024, M_S),
    ("k4_dWproj", "tn", "store", 1024, 1024, M_S),
    ("k9_fc1", "fwd", "bias", M_S, 1280, 1280),
    ("k9_dh", "nt", "dgelu", M_S, 1280, 1280),
    ("k9_dy", "nt", "add", M_S, 1280, 1280),
    ("k9_dW1", "tn", "store", 1280, 1280, M_S),
)
STRIP_PRODUCTS = ("fc1", "dy_mlp", "dW1")
SLAB_PRODUCTS = ("dW1", "dy_mlp", "fc1")
SLAB_DEPTHS = (8, 16, 32, 64, 128, 256, 512, 1 << 20)

# text substitutions of each strip copy, by design; every one must match
STRIPS_MMA_SYNC = {
    "one_tf32": [("          mma_tf32(part[nt], alo[ks], bhi[ks][nt]);\n"
                  "          mma_tf32(part[nt], ahi[ks], blo[ks][nt]);\n", "")],
    "no_split": [('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));\n'
                  "  const float rest = x - __uint_as_float(big);\n"
                  '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : "f"(rest));\n',
                  "  big = small = __float_as_uint(x);\n")],
    "no_slab_sums": [("mma_tf32(part[nt], ", "mma_tf32(acc[mt][nt], "),
                     ("        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[nt][e];\n",
                      "        for (int e = 0; e < 4; ++e) (void)part[nt][e];\n")],
    "loads_only": [("          mma_tf32(part[nt], alo[ks], bhi[ks][nt]);\n"
                    "          mma_tf32(part[nt], ahi[ks], blo[ks][nt]);\n"
                    "          mma_tf32(part[nt], ahi[ks], bhi[ks][nt]);\n", "")],
}
WGMMA_3 = ("          wgmma_tf32<BN>(s, a.lo[k], b_big + 2 * k, more);\n"
           "          wgmma_tf32<BN>(s, a.hi[k], b_small + 2 * k, 1);\n"
           "          wgmma_tf32<BN>(s, a.hi[k], b_big + 2 * k, 1);\n")
STRIPS_WGMMA = {
    "one_tf32": [(WGMMA_3, "          wgmma_tf32<BN>(s, a.hi[k], b_big + 2 * k, more);\n")],
    "no_split": [('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));\n'
                  "  const float rest = x - __uint_as_float(big);\n"
                  '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : "f"(rest));\n',
                  "  big = small = __float_as_uint(x);\n")],
    "no_splitter": [("      split_stage<FORM, BN>(", "      if (p.K < 0) split_stage<FORM, BN>(")],
    "no_slab_sums": [("constexpr int SLAB_K = ", "constexpr int SLAB_K = (1 << 20) + 0 * ")],
    # the fragments kept alive by an empty asm that reads them
    "loads_only": [(WGMMA_3, "".join(
        f'          asm volatile("" :: "r"(a.{x}[k][{i}]));\n' for x in ("lo", "hi") for i in range(4)))],
}


def _arg(args: list, name: str, default, many: bool = False):
    found = []
    while name in args:
        at = args.index(name)
        found.append(args[at + 1])
        del args[at:at + 2]
    if many:
        return found or default
    return type(default)(found[-1]) if found else default


def _card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gemm_f32_variants: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


def _build(jobs: dict) -> dict:
    """{label: (tree, [(old, new), ...])} -> {label: ctypes library}, one
    nvcc each, all at once."""
    sys.path.insert(0, str(ROOT))
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build

    work = cuda_build.BUILD_DIR / "gemm_f32_variants"
    work.mkdir(parents=True, exist_ok=True)
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    def one(item):
        label, (tree, subs) = item
        csrc = Path(tree).resolve() / CSRC
        text = (csrc / "gemm_f32.cuh").read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{label}: {csrc}/gemm_f32.cuh no longer holds {old!r}")
            text = text.replace(old, new)
        var = work / label
        var.mkdir(exist_ok=True)
        (var / "gemm_f32.cuh").write_text(text)
        (var / "mlp_block.cu").write_text((csrc / "mlp_block.cu").read_text())
        lib = work / f"lib{label}.so"
        subprocess.run([cuda_build._nvcc(), *flags, "-I", str(csrc), "-o", str(lib),
                        str(var / "mlp_block.cu")], check=True, capture_output=True)
        return label, lib

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(pool.map(one, jobs.items()))
    libs = {}
    for label, path in built.items():
        lib = ctypes.CDLL(str(path))
        lib.sky_gemm_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.sky_gemm_f32.restype = ctypes.c_int
        lib.sky_gemm_f32_ws.argtypes = [ctypes.c_int] * 3
        lib.sky_gemm_f32_ws.restype = ctypes.c_longlong
        libs[label] = lib
    return libs


class Product:
    """One product's operands, its fp32 torch.mm yardstick and reference."""

    def __init__(self, name, form, epi, M, N, K, gen):
        import torch

        self.name, self.form, self.epi, self.M, self.N, self.K = name, form, epi, M, N, K
        rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        sa = {"fwd": (M, K), "nt": (M, K), "tn": (K, M)}[form]
        sb = {"fwd": (K, N), "nt": (N, K), "tn": (K, N)}[form]
        self.a, self.b = rn(*sa), rn(*sb) * K ** -0.5
        if form == "tn":
            self.a, self.b = self.a * 0.1, self.b * 0.1
        self.bias = 0.01 * rn(N)
        self.resid = rn(M, N) if epi in ("bias_residual", "add") else None
        self.aux_in = rn(M, N) if epi == "dgelu" else None
        self.c = torch.empty(M, N, device="cuda")
        self.aux = self.aux_in.clone() if epi == "dgelu" else None
        self.flops = 2 * M * N * K

    def acc(self, dtype=None):
        import torch

        a, b = (self.a, self.b) if dtype is None else (self.a.to(dtype), self.b.to(dtype))
        return (torch.mm(a, b) if self.form == "fwd" else torch.mm(a, b.t()) if self.form == "nt"
                else torch.mm(a.t(), b))

    def library(self):
        import torch

        if self.form == "fwd":
            return torch.addmm(self.bias, self.a, self.b)
        return self.acc()

    def launch(self, lib, ws=True):
        import torch

        if self.epi == "add":
            self.c.copy_(self.resid)  # dy over the slabs: c is read and written
        if self.epi == "dgelu":
            self.aux.copy_(self.aux_in)  # the pre-activation in, its GELU out
        ptr = lambda t: None if t is None else t.data_ptr()
        wsp = None
        if self.form == "tn" and ws:
            n = lib.sky_gemm_f32_ws(self.M, self.N, self.K)
            key = (id(lib), n)
            if getattr(self, "_ws_key", None) != key:
                self._ws = torch.empty(max(n, 4), device="cuda")
                self._ws_key = key
            wsp = self._ws.data_ptr()
        err = lib.sky_gemm_f32(ptr(self.a), ptr(self.b), ptr(self.bias), ptr(self.resid),
                               ptr(self.c), ptr(self.aux), wsp, FORMS[self.form], EPIS[self.epi],
                               self.M, self.N, self.K, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{self.name}: sky_gemm_f32 returned CUDA error {err}")

    def rel_err(self, want=None):
        """max|c - want|/max|want| of the product before its epilogue: the
        epilogue is undone where it is linear (bias, residual, add) and the
        STORE / DGELU products compare their accumulator directly."""
        import torch

        want = self.acc() if want is None else want
        got = self.c
        if self.epi == "bias" or self.epi == "bias_residual":
            got = got - self.bias - (0 if self.resid is None else self.resid)
        elif self.epi == "add":
            got = got - self.resid
        elif self.epi in ("bias_gelu", "dgelu"):
            return None  # compared through the blocks' own tests
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    def signed_bias(self, exact):
        """The mean signed error toward the exact product's sign over its mean
        magnitude: below zero, the sums shrink (the tensor cores' accumulator
        rounds toward zero)."""
        got = self.c.double()
        if self.epi == "add":
            got = got - self.resid.double()
        return float(((got - exact) * exact.sign()).mean() / exact.abs().mean())


def _events_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def _reps(flops):
    return max(3, min(50, int(2e11 / flops)))


def _time_turns(calls: dict, flops: int, rounds: int) -> dict:
    times = {k: [] for k in calls}
    keys = list(calls)
    for r in range(rounds):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            times[k].append(_events_ms(calls[k], _reps(flops)))
    return {k: min(v) for k, v in times.items()}


def times(args: list) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    trees = _arg(args, "--tree", [str(ROOT)], many=True)
    rounds = _arg(args, "--rounds", 4)
    smi = _card()
    libs = _build({f"tree{i}": (t, []) for i, t in enumerate(trees)})
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi, "trees": trees, "products": {}}
    t0 = time.time()
    for spec in FS_PRODUCTS + SMALL_PRODUCTS:
        p = Product(*spec, gen)
        want = p.acc()
        errs, first, same = {}, None, {}
        for label, lib in libs.items():
            p.launch(lib)
            torch.cuda.synchronize()
            errs[label] = p.rel_err(want)
            if first is None:
                first = p.c.clone()
            same[label] = bool(torch.equal(p.c, first))
        calls = {label: (lambda lib=lib: p.launch(lib)) for label, lib in libs.items()}
        calls["torch"] = p.library
        t = _time_turns(calls, p.flops, rounds)
        rec = {"form": p.form, "epilogue": p.epi, "M": p.M, "N": p.N, "K": p.K,
               "ms": t, "tflops": {k: p.flops / v / 1e9 for k, v in t.items()},
               "max_rel_err": errs, "bit_equal_to_first_tree": same,
               "bound_ms": p.flops / 165e12 * 1e3}
        out["products"][p.name] = rec
        print(f"[{time.time() - t0:.0f} s] {p.name} ({p.form} {p.epi} M={p.M} N={p.N} K={p.K}): "
              + ", ".join(f"{k} {v:.4f} ms ({rec['tflops'][k]:.1f} TFLOP/s)" for k, v in t.items())
              + "; max-rel " + ", ".join(f"{k} {'n/a' if e is None else f'{e:.2e}'}"
                                         for k, e in errs.items())
              + "; bit-equal to tree0 " + ", ".join(f"{k} {v}" for k, v in same.items()),
              flush=True)
        del p, want, first
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def strip(args: list) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    tree = _arg(args, "--tree", str(ROOT))
    rounds = _arg(args, "--rounds", 4)
    smi = _card()
    text = (Path(tree).resolve() / CSRC / "gemm_f32.cuh").read_text()
    design = "wgmma" if "wgmma.mma_async" in text else "mma.sync"
    strips = STRIPS_WGMMA if design == "wgmma" else STRIPS_MMA_SYNC
    libs = _build({"as_shipped": (tree, []), **{k: (tree, v) for k, v in strips.items()}})
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi, "tree": tree, "design": design, "products": {}}
    for spec in FS_PRODUCTS:
        if spec[0] not in STRIP_PRODUCTS:
            continue
        p = Product(*spec, gen)
        calls = {label: (lambda lib=lib: p.launch(lib)) for label, lib in libs.items()}
        calls["torch"] = p.library
        t = _time_turns(calls, p.flops, rounds)
        rec = {"ms": t, "tflops": {k: p.flops / v / 1e9 for k, v in t.items()}}
        out["products"][p.name] = rec
        print(f"{p.name} ({design}): " + ", ".join(
            f"{k} {v:.4f} ms ({rec['tflops'][k]:.1f})" for k, v in t.items()), flush=True)
        del p
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def slab(args: list) -> int:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    tree = _arg(args, "--tree", str(ROOT))
    rounds = _arg(args, "--rounds", 2)
    smi = _card()
    text = (Path(tree).resolve() / CSRC / "gemm_f32.cuh").read_text()
    start = text.index("constexpr int SLAB_K = ")
    line = text[start:text.index("\n", start)]
    jobs = {f"slab{d}": (tree, [(line, f"constexpr int SLAB_K = {d};")]) for d in SLAB_DEPTHS}
    libs = _build(jobs)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi, "tree": tree, "shipped": line, "products": {}}
    for spec in FS_PRODUCTS:
        if spec[0] not in SLAB_PRODUCTS:
            continue
        p = Product(*spec, gen)
        want, exact = p.acc(), p.acc(torch.float64)
        splits = (True, False) if p.form == "tn" else (True,)
        for ws in splits:
            name = p.name + ("" if ws or p.form != "tn" else " unsplit")
            rec = {"vs_torch_mm": {}, "vs_fp64": {}, "signed_bias": {}}
            out["products"][name] = rec
            for label, lib in libs.items():
                p.launch(lib, ws)
                torch.cuda.synchronize()
                rec["vs_torch_mm"][label] = p.rel_err(want)
                rec["vs_fp64"][label] = p.rel_err(exact)
                rec["signed_bias"][label] = p.signed_bias(exact) if p.epi == "store" else None
            rec["torch_mm_vs_fp64"] = float((want.double() - exact).abs().max() / exact.abs().max())
            rec["torch_mm_signed_bias"] = float(((want.double() - exact) * exact.sign()).mean()
                                                / exact.abs().mean())
            calls = {label: (lambda lib=lib, ws=ws: p.launch(lib, ws)) for label, lib in libs.items()}
            rec["ms"] = _time_turns(calls, p.flops, rounds)
            print(f"{name}: " + ", ".join(
                f"{k} err {rec['vs_torch_mm'][k]} / fp64 {rec['vs_fp64'][k]} bias "
                f"{rec['signed_bias'][k]} {rec['ms'][k]:.4f} ms" for k in libs)
                + f"; torch.mm vs fp64 {rec['torch_mm_vs_fp64']:.2e}, bias "
                f"{rec['torch_mm_signed_bias']:.2e}", flush=True)
        del p, want, exact
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def sweep(args: list) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from sky_embeddings_tpu_torch.ops.kernels import gemm as G

    torch.backends.cuda.matmul.allow_tf32 = False
    rounds = _arg(args, "--rounds", 2)
    smi = _card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi, "products": {}}
    names = ("fc1", "dy_mlp", "dW1", "dW2", "dWqkv", "dWproj")
    for spec in [p for p in FS_PRODUCTS if p[0] in names] + list(SMALL_PRODUCTS):
        p = Product(*spec, gen)
        resid = p.resid if p.resid is not None else None
        plan = G.f32_plan(p.M, p.N, p.K, p.form == "tn", sms)
        calls = {}
        for bn in G.F32_BNS:
            for sp in (range(1, 9) if p.form == "tn" else (1,)):
                if math.ceil(math.ceil(p.K / G.F32_BK) / math.ceil(math.ceil(p.K / G.F32_BK) / sp)) != sp:
                    continue
                calls[f"{bn}x{sp}"] = (lambda bn=bn, sp=sp: G.gemm_f32(
                    p.a, p.b, p.form, p.epi, p.bias, resid, p.aux_in, bn=bn, splits=sp))
        t = _time_turns(calls, p.flops, rounds)
        best = min(t, key=t.get)
        pick = f"{plan.bn}x{plan.splits}"
        out["products"][p.name] = {"M": p.M, "N": p.N, "K": p.K, "ms": t, "plan": pick,
                                   "best": best}
        print(f"{p.name} ({p.form} M={p.M} N={p.N} K={p.K}): plan {pick} {t[pick]:.4f} ms, best "
              f"{best} {t[best]:.4f}; " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()),
              flush=True)
        del p
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def main(argv: list) -> int:
    mode = argv[0] if argv and not argv[0].startswith("--") else "times"
    rest = argv[1:] if argv and argv[0] == mode else argv
    return {"times": times, "strip": strip, "slab": slab, "sweep": sweep}[mode](rest)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
