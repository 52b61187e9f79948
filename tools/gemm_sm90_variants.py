#!/usr/bin/env python3
"""Variants of the port's forward GEMM (``csrc/gemm_sm90.cuh``), timed side
by side on one CUDA card.

    python3 tools/gemm_sm90_variants.py [--variants tma,regstore,as_erf]

Each variant is the checked-in header with a few text substitutions (each
must match, or the tool stops), built with the port's nvcc flags together
with ``csrc/mlp_block.cu`` (whose ``sky_gemm_sm90`` entry launches one
product) into its own library under ``csrc/build/variants/``. At ViT-B's
four forward products (qkv, proj, fc1, fc2 with their epilogues; M = 65 B
rows at B = 64 and 1024) each variant is held to the plain version
(max|a-b|/max|b| <= 2e-2) and timed with CUDA events over back-to-back
launches of the C entry on preallocated outputs, beside ``torch.addmm`` on
the same operands:

- ``tma``: the header as checked in (the output staged in shared memory
  and written by TMA stores; the residual loaded by TMA under the mainloop);
- ``regstore``: each thread stores its bf16 pairs straight from the
  accumulator registers and reads the residual the same way;
- ``as_erf``: the GELU epilogue with erf by Abramowitz-Stegun 7.1.26, as
  the TPU kernel computes it, instead of ``erff``.

Prints one line per product and a JSON line of every time. Needs the card;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REGSTORE_EPILOGUE = '''
template <int EPI, int BN>
__device__ __forceinline__ void epilogue_regs(const float* d, const Sm90Args& p, int mw, int n0) {
  const int t = threadIdx.x & 127;
  const int r0 = mw + (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (t & 3);
    if (col >= p.N) continue;
    const float b0 = __ldg(p.bias + col), b1 = __ldg(p.bias + col + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= p.M) continue;
      const size_t at = (size_t)row * p.N + col;
      float v0 = d[4 * j + 2 * h] + b0, v1 = d[4 * j + 2 * h + 1] + b1;
      if (EPI == EPI_BIAS_GELU_STASH)
        *reinterpret_cast<uint32_t*>(p.out2 + at) = pack_bf16x2(v0, v1);
      if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_STASH) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      }
      if (EPI == EPI_BIAS_RESIDUAL) {
        const uint32_t rv = *reinterpret_cast<const uint32_t*>(p.resid + at);
        v0 = __uint_as_float(rv << 16) + v0;
        v1 = __uint_as_float(rv & 0xFFFF0000u) + v1;
      }
      *reinterpret_cast<uint32_t*>(p.out + at) = pack_bf16x2(v0, v1);
    }
  }
}

template <int EPI, int BN>
__global__ void __launch_bounds__(THREADS, 1)'''

AS_ERF_GELU = '''
__device__ __forceinline__ float gelu_as(float v) {
  const float x = v * 0.70710678118654752f;
  const float ax = fabsf(x);
  const float t = __fdividef(1.0f, fmaf(0.3275911f, ax, 1.0f));
  float poly = fmaf(t, 1.061405429f, -1.453152027f);
  poly = fmaf(t, poly, 1.421413741f);
  poly = fmaf(t, poly, -0.284496736f);
  poly = fmaf(t, poly, 0.254829592f);
  poly *= t;
  const float y = fmaf(-poly, __expf(-ax * ax), 1.0f);
  return 0.5f * v * (1.0f + copysignf(y, x));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile('''

VARIANTS = {
    "tma": [],
    "regstore": [
        ("struct Sm90Args {\n  const float* bias;   // (N,)\n",
         "struct Sm90Args {\n  const float* bias;   // (N,)\n  bf16* out;\n  const bf16* resid;\n"),
        ("const Sm90Args p{static_cast<const float*>(bias), static_cast<bf16*>(out2), M, N, K};",
         "const Sm90Args p{static_cast<const float*>(bias), static_cast<bf16*>(out), "
         "static_cast<const bf16*>(resid), static_cast<bf16*>(out2), M, N, K};"),
        ("\ntemplate <int EPI, int BN>\n__global__ void __launch_bounds__(THREADS, 1)",
         REGSTORE_EPILOGUE),
        ("if (EPI == EPI_BIAS_RESIDUAL && kb == min(2, nk - 1) && leader && rows)", "if (false)"),
        ("        if (EPI == EPI_BIAS_RESIDUAL) {\n          mbar_wait(res_bar, res_phase);",
         "        if (false) {\n          mbar_wait(res_bar, res_phase);"),
        ("epilogue<EPI, BN>(d, p, &tma_out, stg, mw, n0, nb, wg, leader);",
         "epilogue_regs<EPI, BN>(d, p, mw, n0);"),
    ],
    "as_erf": [
        ("          v0 = gelu_erf(v0);\n          v1 = gelu_erf(v1);",
         "          v0 = gelu_as(v0);\n          v1 = gelu_as(v1);"),
        ("\ntemplate <int BN>\n__device__ __forceinline__ void wgmma_tile(", AS_ERF_GELU),
    ],
}


def build(name: str) -> ctypes.CDLL:
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build

    src = (cuda_build.CSRC / "gemm_sm90.cuh").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: pattern not found once: {old[:60]!r}")
        src = src.replace(old, new)
    d = cuda_build.BUILD_DIR / "variants" / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d, ignore=shutil.ignore_patterns("build"))
    (d / "gemm_sm90.cuh").write_text(src)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
           str(d / "mlp_block.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for variant {name}:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(d / "lib.so")).sky_gemm_sm90
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="tma,regstore,as_erf")
    names = ap.parse_args().variants.split(",")
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sky_embeddings_tpu_torch.ops.kernels import gemm as G

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    fns = {n: build(n) for n in names}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def ms(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    D, F, out = 768, 3072, {}
    for B in (64, 1024):
        M, iters = 65 * B, 50 if B == 64 else 20
        for prod, K, N, epi in (("qkv", D, 3 * D, "bias"), ("proj", D, D, "bias_residual"),
                                ("fc1", D, F, "bias_gelu"), ("fc2", F, D, "bias_residual")):
            a = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
            bias = 0.01 * torch.randn(N, generator=gen, device=dev)
            resid = torch.randn(M, N, generator=gen, device=dev).to(torch.bfloat16)
            want = G.gemm_plain(a, w, bias, epi, resid)[0].float()
            o, o2 = torch.empty_like(resid), torch.empty_like(resid)
            stream = torch.cuda.current_stream().cuda_stream
            row = {}
            for name, fn in fns.items():
                call = lambda: fn(a.data_ptr(), w.data_ptr(), bias.data_ptr(), resid.data_ptr(),
                                  o.data_ptr(), o2.data_ptr(), M, N, K, G.EPILOGUES[epi], stream)
                if call() != 0:
                    raise SystemExit(f"{name}: launch failed")
                torch.cuda.synchronize()
                rel = float((o.float() - want).abs().max() / want.abs().max())
                if rel > 2e-2:
                    raise SystemExit(f"{name} {prod} B={B}: max-rel {rel:.3e} over 2e-2")
                row[name] = ms(call, iters)
            b16 = bias.to(torch.bfloat16)
            row["addmm"] = ms(lambda: torch.addmm(b16, a, w), iters)
            tflop = 2 * M * K * N / 1e12
            cells = (f"{n} {t:.4f} ms {tflop / t * 1e3:.0f} TFLOP/s" for n, t in row.items())
            print(f"{prod} B={B}: " + " | ".join(cells), flush=True)
            out[f"{prod} B={B}"] = row
    print(json.dumps({"device": smi, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
