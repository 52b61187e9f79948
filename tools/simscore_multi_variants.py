#!/usr/bin/env python3
"""Kernel 11 (``csrc/simscore_multi.cu``, the multi-query bank scorer) against
the CUDA-core version it replaced, and copies of it with parts taken out, on
one CUDA card. Imports nothing of JAX.

    python3 tools/simscore_multi_variants.py [--parent REF_OR_FILE] [--reps N]
    python3 tools/simscore_multi_variants.py strip [--reps N]

The default mode builds this tree's ``csrc/simscore_multi.cu`` and the
parent's (``--parent``: a file holding the older source, or a git ref whose
copy of the file ``git show`` prints; default ``61d5763``, the last commit
with the CUDA-core version), one ``nvcc`` each, at once, into their own
build directory, and calls both through their C entries on a 1M x 768 bank
(a seeded normal, bf16 and fp32) at Q = 1, 8, 16, 64 and 130 queries: each
output's max|a-b|/max|b| against ``weighted_bank_scores_multi_plain``, and
each kernel's time by CUDA events (4 alternating rounds of ``--reps``
launches, the fastest round), beside the bound (the larger of the bytes
over 3.35 TB/s and 4·N·D·Q operations over the bf16 tensor-core rate) and
``torch.mm`` of the bank with the (D, 2Q) matrix ``[wt | w]`` in the bank's
dtype, which reads the same bytes once (a yardstick of the read rate; the
port never calls it).

``strip`` builds this tree's source as it is and copies with a part taken
out: ``loads_only`` (no query split, no products: the ring streams the
bank and the epilogue stores), ``no_loads`` (nothing copied from device
memory: the products run on whatever shared memory holds) and
``no_split`` (the query slices are copied but not split into the planes),
and times them at the same shapes, with the bank's bytes per ms of each.
What the loads-only copy takes is how near the bank read comes to 3.35
TB/s.

Both print the card's name and power limit, a line per shape and a JSON
line of every number.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = "sky_embeddings_tpu_torch/ops/kernels/csrc/simscore_multi.cu"
N, D = 1 << 20, 768
QS = (1, 8, 16, 64, 130)
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12

# the lines of csrc/simscore_multi.cu that strip's copies change, and to what
STRIPS = {
    "loads_only": [("split_queries<T, NT>(", "if (false) split_queries<T, NT>("),
                   ("compute_tile<T, NT>(", "if (false) compute_tile<T, NT>(")],
    "no_loads": [("load_queries<T, NT>(a,", "if (false) load_queries<T, NT>(a,"),
                 ("load_bank<T, VEC, NT>(a,", "if (false) load_bank<T, VEC, NT>(a,")],
    "no_split": [("split_queries<T, NT>(", "if (false) split_queries<T, NT>(")],
}


def _arg(args: list, name: str, default):
    if name not in args:
        return default
    at = args.index(name)
    value = args[at + 1]
    del args[at:at + 2]
    return type(default)(value)


def _parent_source(ref: str) -> str:
    path = Path(ref)
    if path.is_file():
        return path.read_text()
    return subprocess.run(["git", "show", f"{ref}:{SOURCE}"], cwd=ROOT, capture_output=True,
                          text=True, check=True).stdout


def _build(sources: dict) -> dict:
    """{name: source text} -> {name: ctypes handle}, one nvcc each, at once."""
    sys.path.insert(0, str(ROOT))
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build

    work = cuda_build.BUILD_DIR / "simscore_multi_variants"
    work.mkdir(parents=True, exist_ok=True)
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]

    def one(name):
        (work / f"{name}.cu").write_text(sources[name])
        lib = work / f"lib{name}.so"
        subprocess.run([cuda_build._nvcc(), *flags, "-I", str(cuda_build.CSRC), "-o", str(lib),
                        str(work / f"{name}.cu")], check=True, capture_output=True)
        return lib

    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(one, sources)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.sky_scores_multi.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                                         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.sky_scores_multi.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _run(libs: dict, reps: int, parity: bool) -> dict:
    import torch

    sys.path.insert(0, str(ROOT))
    from sky_embeddings_tpu_torch.ops.kernels.simscore import weighted_bank_scores_multi_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bank_bf16 = torch.randn(N, D, generator=gen, device="cuda").to(torch.bfloat16)
    targets = torch.randn(max(QS), D, generator=gen, device="cuda")
    weights = torch.rand(max(QS), D, generator=gen, device="cuda") + 0.5
    weights = weights / weights.sum(dim=1, keepdim=True)
    out = {"card": smi}
    for dt in (torch.bfloat16, torch.float32):
        bank = bank_bf16.to(dt)
        tag = str(dt).replace("torch.", "")
        for q in QS:
            t, w = targets[:q], weights[:q]
            wt_t, w_t = (w * t).t().contiguous(), w.t().contiguous()
            tnorm = torch.sqrt(torch.sum(w * t ** 2, dim=1))
            res = torch.empty((N, q), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            calls = {name: (lambda lib=lib: lib.sky_scores_multi(
                bank.data_ptr(), int(dt == torch.bfloat16), wt_t.data_ptr(), w_t.data_ptr(),
                tnorm.data_ptr(), res.data_ptr(), N, D, q, stream)) for name, lib in libs.items()}
            yard = torch.cat([wt_t, w_t], 1).to(dt)
            calls["read_yardstick"] = lambda: torch.mm(bank, yard)
            rec = {}
            if parity:
                want = weighted_bank_scores_multi_plain(bank, t, w)
                for name in libs:
                    if calls[name]() != 0:
                        raise SystemExit(f"{name} {tag} Q={q}: launch failed")
                    torch.cuda.synchronize()
                    rec[name + "_max_rel"] = float((res - want).abs().max() / want.abs().max())
                del want
            times = {name: [] for name in calls}
            for rnd in range(4):
                for name in (list(calls) if rnd % 2 == 0 else list(calls)[::-1]):
                    fn = calls[name]
                    fn()
                    torch.cuda.synchronize()
                    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    s.record()
                    for _ in range(reps):
                        fn()
                    e.record()
                    e.synchronize()
                    times[name].append(s.elapsed_time(e) / reps)
            nbytes = N * D * bank.element_size() + 2 * q * D * 4 + q * 4 + N * q * 4
            bound = max(nbytes / PEAK_BYTES, 4 * N * D * q / PEAK_BF16) * 1e3
            rec.update({name + "_ms": min(v) for name, v in times.items()})
            rec["bound_ms"] = bound
            rec.update({name + "_bank_bytes_per_ms": N * D * bank.element_size() / min(v)
                        for name, v in times.items() if name != "read_yardstick"})
            out[f"{tag} Q={q}"] = rec
            print(f"{tag} Q={q}: " + ", ".join(f"{k} {v:.4g}" for k, v in rec.items()
                                                if not k.endswith("bytes_per_ms")), flush=True)
        del bank
    print(json.dumps(out), flush=True)
    return out


def main(argv: list) -> int:
    import torch

    if not torch.cuda.is_available():
        print("simscore_multi_variants: needs a CUDA card", file=sys.stderr)
        return 2
    strip = argv[:1] == ["strip"]
    args = argv[1:] if strip else argv
    reps = _arg(args, "--reps", 10)
    source = (ROOT / SOURCE).read_text()
    if strip:
        sources = {"as_shipped": source}
        for name, edits in STRIPS.items():
            text = source
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"strip {name}: {SOURCE} no longer holds {old!r}")
                text = text.replace(old, new)
            sources[name] = text
    else:
        sources = {"parent": _parent_source(_arg(args, "--parent", "61d5763")), "this_tree": source}
    _run(_build(sources), reps, parity=not strip)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
