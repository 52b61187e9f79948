#!/usr/bin/env python3
"""Variants of kernel 7's first step, the stash dh product of the MLP stash
backward, timed side by side on one CUDA card.

    python3 tools/mlp_stash_variants.py

Kernel 7 (``csrc/mlp_block_bwd.cu``, entry ``sky_mlp_block_bwd_stash``)
computes dh = g @ W2ᵀ for each 128 x 128 hidden tile (the stash dh product
of ``csrc/gemm_sm90.cuh``), whose epilogue reads the tile of the bf16 stash
a and writes da_c = bf16(dh · gelu'(a)), h_c = bf16(gelu(a)) and db1's
column sums while the tensor cores wait. Each variant below is the
checked-in header with a few text substitutions (each must match once, or
the tool stops), built with the port's nvcc flags together with
``csrc/mlp_block_bwd.cu`` into its own library under
``csrc/build/variants/``:

- ``stash``: the header as checked in (GELU and GELU' with the TPU
  kernel's A-S erf, one shared exp);
- ``stash_erff``: the same epilogue with ``erff`` and its own ``expf``, as
  kernel 8's dual product computes them;
- ``stash_nomath``: GELU and GELU' replaced by the identity and one (what
  the math costs; the stash is still read and both outputs written);
- ``stash_noepi``: no epilogue and no stash load (the mainloop alone);
- ``stash_butterfly``: the column sums by the dual's butterfly (96
  shuffles a thread) in place of the reduce-scatter (28);
- ``stash_early_load``, ``stash_half_load``: the stash loaded two slabs
  into the mainloop (as EPI_BIAS_RESIDUAL's residual is) or half-way, in
  place of three slabs before its end;
- ``stash_end_stores``: h_c and da_c stored after the whole pass, in place
  of box by box;
- ``stash_onebuf``: an earlier design, one bf16 buffer a consumer (the
  stash, then h_c, then da_c, the stores in turn), erff, the column sums
  by a butterfly per 8-column group (96 shuffles a thread);
- ``stash_onebuf_bn256``: the same at 256-column tiles (a three-slot
  ring; two buffers would leave one slot);
- ``stash_pingpong``: each consumer owns whole 64 x 128 tiles (a ring slot
  holds g's 64 x 64 box and W2's box, six slots) and the consumers'
  mainloops take turns (named barriers 3 and 4), so that one consumer's
  epilogue runs under the other's mainloop.

At ``mim_25_large`` B=64 and 512 (M = 65 B, D = 768, F = 3 072) the
outputs of ``stash`` and ``stash_erff`` are held to the plain version
(max|a-b|/max|b| <= 3e-2) and every variant is timed with CUDA events over
back-to-back launches of its C entry on preallocated outputs, beside
``torch.mm`` of dh alone, dh alone on the K-major-B form rounded to bf16
(``ops/kernels/gemm.gemm_bwd``) and kernel 8's dual product
(``gemm_dual``), each variant's device time by ``torch.profiler`` beside
its events time, and kernels 7 and 8 with their device time by kernel.
Prints one line per shape and a JSON line of every time. Needs the card;
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ONEBUF_EPILOGUE = """      // (one buffer: gelu(a) over a, then da_c through the same buffer)
#pragma unroll
      for (int c = 0; c < BN / BOX; ++c) {
        if (c >= nb) break;
        const uint32_t box = sth + c * OUT_BOX_BYTES;
#pragma unroll
        for (int jj = 0; jj < BOX / 8; ++jj) {
          const int j = c * (BOX / 8) + jj;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = lr0 + 8 * h;
            const uint32_t at = box + lr * 128 + ((jj ^ (lr & 7)) << 4) + 4 * (t & 3);
            const uint32_t av = ld_shared_b32(at);
            float h0, h1, q0, q1;
            gelu_erf_and_grad(__uint_as_float(av << 16), h0, q0);
            gelu_erf_and_grad(__uint_as_float(av & 0xFFFF0000u), h1, q1);
            d[4 * j + 2 * h] *= q0;
            d[4 * j + 2 * h + 1] *= q1;
            s0 += d[4 * j + 2 * h];
            s1 += d[4 * j + 2 * h + 1];
            st_shared_b32(at, pack_bf16x2(h0, h1));
          }
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, o);
            s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          }
          if ((t & 31) < 4) {
            sums[(t >> 5) * BN + 8 * j + 2 * (t & 3)] = s0;
            sums[(t >> 5) * BN + 8 * j + 2 * (t & 3) + 1] = s1;
          }
        }
      }
      fence_proxy_async();
      wg_sync(wg);
      if (leader) {
        for (int c = 0; c < nb; ++c) tma_store_2d(&tma_h, sth + c * OUT_BOX_BYTES, n0 + c * BOX, mw);
        bulk_commit();
      }
      for (int col = t; col < BN && n0 + col < p.N; col += 128) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) s += sums[w * BN + col];
        p.part[(size_t)(mw / 64) * p.N + n0 + col] = s;
      }
      if (leader) bulk_wait_read();  // h_c's stores have read the buffer
      wg_sync(wg);
      store_bf16<BN>(d, &tma_da, sth, mw, n0, nb, wg, leader);
"""
LOAD = "        if (kb == max(nk - 3, 0) && leader && rows) {"
BOX_STORES = """        fence_proxy_async();  // the box's h_c and da_c leave while the next is computed
        wg_sync(wg);
        if (leader) {
          tma_store_2d(&tma_h, sth + c * OUT_BOX_BYTES, n0 + c * BOX, mw);
          tma_store_2d(&tma_da, std_ + c * OUT_BOX_BYTES, n0 + c * BOX, mw);
          bulk_commit();
        }
"""
END_STORES = """      fence_proxy_async();
      wg_sync(wg);
      if (leader) {
        for (int c = 0; c < nb; ++c) {
          tma_store_2d(&tma_h, sth + c * OUT_BOX_BYTES, n0 + c * BOX, mw);
          tma_store_2d(&tma_da, std_ + c * OUT_BOX_BYTES, n0 + c * BOX, mw);
        }
        bulk_commit();
      }
"""
# the column sums' reduce-scatter, from its first line through its last (a span)
SCATTER = ("      // the sums over the warp's 16 rows (the 8 lanes of one t % 4) by a\n",
           "        *reinterpret_cast<float2*>(row + 4 * k0 + 8) = make_float2(cs[2], cs[3]);\n"
           "      }\n")
BUTTERFLY = """#pragma unroll
      for (int i = 0; i < BN / 4; ++i) {
        cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 4);
        cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 8);
        cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 16);
      }
      if ((t & 31) < 4) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(sums + (t >> 5) * BN + 8 * j + 2 * (t & 3)) =
              make_float2(cs[2 * j], cs[2 * j + 1]);
      }
"""
# the checked-in epilogue, from its first line through its last (a span)
EPILOGUE = ("      // a -> bf16(gelu(a)) in place and bf16(dh * gelu'(a)) beside it, a\n",
            "      wg_sync(wg);  // the sums are read before the next tile's are staged\n")
ONEBUF = [(EPILOGUE, ONEBUF_EPILOGUE),
          ("  static constexpr int BUF_BYTES = 4 * HALF_BYTES;",
           "  static constexpr int BUF_BYTES = 2 * HALF_BYTES;"),
          ("    const uint32_t sth = buf0 + wg * (2 * C::HALF_BYTES);",
           "    const uint32_t sth = buf0 + wg * C::HALF_BYTES;"),
          (LOAD, "        if (kb == min(2, nk - 1) && leader && rows) {")]
PINGPONG = [
    ("  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;",
     "  static constexpr int STAGE_BYTES = A_BYTES / 2 + BN * BK * 2;"),
    ("      mbar_init(empty0 + 8 * s, 2);\n    }\n    mbar_init(stash0, 1);",
     "      mbar_init(empty0 + 8 * s, 1);\n    }\n    mbar_init(stash0, 1);"),
    ("  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;\n  const int nk = (p.K + BK - 1) / BK;\n\n"
     "  if (threadIdx.x == 0) {\n    for (int s = 0; s < C::STAGES; ++s) {\n"
     "      mbar_init(full0 + 8 * s, 1);\n      mbar_init(empty0 + 8 * s, 1);",
     "  const int tiles = ((p.M + 63) / 64) * n_tiles;\n  const int nk = (p.K + BK - 1) / BK;\n\n"
     "  if (threadIdx.x == 0) {\n    for (int s = 0; s < C::STAGES; ++s) {\n"
     "      mbar_init(full0 + 8 * s, 1);\n      mbar_init(empty0 + 8 * s, 1);"),
    ("        const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;\n"
     "        for (int kb = 0; kb < nk; ++kb) {",
     "        const int m0 = (tile / n_tiles) * 64, n0 = (tile % n_tiles) * BN;\n"
     "        for (int kb = 0; kb < nk; ++kb) {"),
    ("          tma_load_2d(slot + A_BYTES, &tma_w2, full, kb * BK, n0);",
     "          tma_load_2d(slot + A_BYTES / 2, &tma_w2, full, kb * BK, n0);"),
    ("    uint32_t stash_phase = 0;\n    float d[BN / 2];\n    int stage = 0;\n    uint32_t phase = 0;\n"
     "    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {\n"
     "      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;\n"
     "      const int mw = m0 + 64 * wg;",
     "    uint32_t stash_phase = 0;\n    float d[BN / 2];\n    int stage = 0;\n    uint32_t phase = 0;\n"
     "    for (int i = wg, tile = blockIdx.x + wg * gridDim.x; tile < tiles;\n"
     "         i += 2, tile += 2 * gridDim.x) {\n"
     "      if (i > 0) asm volatile(\"bar.sync %0, 256;\\n\" ::\"r\"(3 + wg) : \"memory\");\n"
     "      stage = (i * nk) % C::STAGES;\n"
     "      phase = ((i * nk) / C::STAGES) & 1;\n"
     "      const int n0 = (tile % n_tiles) * BN;\n"
     "      const int mw = (tile / n_tiles) * 64;"),
    ("        const uint32_t sg = base + stage * C::STAGE_BYTES + wg * (A_BYTES / 2);\n"
     "        const uint32_t sw = base + stage * C::STAGE_BYTES + A_BYTES;\n"
     "        fence_acc<BN / 2>(d);",
     "        const uint32_t sg = base + stage * C::STAGE_BYTES;\n"
     "        const uint32_t sw = base + stage * C::STAGE_BYTES + A_BYTES / 2;\n"
     "        fence_acc<BN / 2>(d);"),
    ("      if (leader) mbar_arrive(empty0 + 8 * prev);\n      if (!rows) continue;\n",
     "      if (leader) mbar_arrive(empty0 + 8 * prev);\n"
     "      if (tile + gridDim.x < tiles) asm volatile(\"bar.arrive %0, 256;\\n\" ::\"r\"(4 - wg) : \"memory\");\n"
     "      if (!rows) continue;\n"),
    # the launch: g in 64-row boxes, 64-row tiles, at least two a CTA
    ("  if (!encode_2d(&maps[0], g, M, K, BM) || !encode_2d(&maps[1], w2, N, K, STASH_BN) ||",
     "  if (!encode_2d(&maps[0], g, M, K, 64) || !encode_2d(&maps[1], w2, N, K, STASH_BN) ||"),
    ("  const int tiles = ((M + BM - 1) / BM) * ((N + STASH_BN - 1) / STASH_BN);\n"
     "  gemm_dh_stash_kernel<<<tiles < sms ? tiles : sms,",
     "  const int tiles = ((M + 63) / 64) * ((N + STASH_BN - 1) / STASH_BN);\n"
     "  gemm_dh_stash_kernel<<<(tiles + 1) / 2 < sms ? (tiles + 1) / 2 : sms,"),
]
MATH = ("          gelu_as_and_grad(__uint_as_float(av[i] << 16), h0, q0);\n"
        "          gelu_as_and_grad(__uint_as_float(av[i] & 0xFFFF0000u), h1, q1);\n")
VARIANTS = {
    "stash": [],
    "stash_erff": [(MATH, MATH.replace("gelu_as_and_grad", "gelu_erf_and_grad"))],
    "stash_nomath": [(MATH, "          h0 = __uint_as_float(av[i] << 16);\n"
                            "          h1 = __uint_as_float(av[i] & 0xFFFF0000u);\n"
                            "          q0 = q1 = 1.f;\n")],
    "stash_noepi": [("      if (!rows) continue;\n      mbar_wait(stash_bar", "      continue;\n"
                     "      mbar_wait(stash_bar"),
                    (LOAD, "        if (false) {")],
    "stash_butterfly": [(SCATTER, BUTTERFLY)],
    "stash_early_load": [(LOAD, "        if (kb == min(2, nk - 1) && leader && rows) {")],
    "stash_half_load": [(LOAD, "        if (kb == nk / 2 && leader && rows) {")],
    "stash_end_stores": [(BOX_STORES, ""), ("      wg_sync(wg);\n      // the four warps' sums",
                                            END_STORES + "      // the four warps' sums")],
    "stash_onebuf": ONEBUF,
    "stash_onebuf_bn256": ONEBUF + [("constexpr int STASH_BN = 128;", "constexpr int STASH_BN = 256;")],
    "stash_pingpong": PINGPONG,
}


def build(name: str) -> ctypes.CDLL:
    from sky_embeddings_tpu_torch.ops.kernels import cuda_build

    src = (cuda_build.CSRC / "gemm_sm90.cuh").read_text()
    for old, new in VARIANTS[name]:
        if isinstance(old, tuple):  # a span: from its first line through its last
            i = src.find(old[0])
            j = src.find(old[1], i)
            if i < 0 or j < 0 or src.count(old[0]) != 1:
                raise SystemExit(f"variant {name}: span not found once: {old[0][:60]!r}")
            old = src[i:j + len(old[1])]
        if src.count(old) != 1:
            raise SystemExit(f"variant {name}: pattern not found once: {old[:60]!r}")
        src = src.replace(old, new)
    d = cuda_build.BUILD_DIR / "variants" / f"mlp_{name}"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d, ignore=shutil.ignore_patterns("build"))
    (d / "gemm_sm90.cuh").write_text(src)
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
           str(d / "mlp_block_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed for variant {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    lib.sky_gemm_sm90_dh_stash.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.sky_gemm_sm90_dh_stash.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sky_embeddings_tpu_torch.ops.kernels import gemm as G
    from sky_embeddings_tpu_torch.ops.kernels import mlp_block as MB

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc per variant, all at once
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

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

    def by_kernel(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")}

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / b.float().abs().max())

    out = {}
    for B in (64, 512):
        label, N, D, F = f"mim_25_large B={B}", 65, 768, 3072
        M = B * N
        x = (0.5 * torch.randn(B, N, D, generator=gen, device=dev)).to(bf)
        s_ = 1 + 0.1 * torch.randn(D, generator=gen, device=dev)
        c_ = 0.1 * torch.randn(D, generator=gen, device=dev)
        w1 = (torch.randn(D, F, generator=gen, device=dev) * D ** -0.5).to(bf)
        b1 = 0.01 * torch.randn(F, generator=gen, device=dev)
        w2 = (torch.randn(F, D, generator=gen, device=dev) * F ** -0.5).to(bf)
        g = (0.1 * torch.randn(B, N, D, generator=gen, device=dev)).to(bf)
        g2, y = g.reshape(M, D), MB.layer_norm(x.reshape(M, D).float(), s_, c_).to(bf)
        a = G.gemm(y, w1, b1, "bias")[0]  # the stash: the bf16 fc1 pre-activation
        want = G.gemm_dh_stash_plain(g2, w2, a)
        da_c, h_c = torch.empty(M, F, dtype=bf, device=dev), torch.empty(M, F, dtype=bf, device=dev)
        part, db1 = torch.empty(-(-M // 64) * F, device=dev), torch.empty(F, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        iters = 20 if B == 64 else 5
        row = {}
        for name, lib in libs.items():
            call = lambda lib=lib: lib.sky_gemm_sm90_dh_stash(
                *(t.data_ptr() for t in (g2, w2, a, da_c, h_c, part, db1)), M, F, D, stream)
            if call():
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            if name in ("stash", "stash_erff"):
                err = max(rel(p, q) for p, q in zip((da_c, h_c, db1), want))
                if err > 3e-2:
                    raise SystemExit(f"{name} {label}: max-rel {err:.3e} over 3e-2")
                row[name + "_max_rel"] = err
            row[name] = ms(call, iters)
            row[name + "_device"] = sum(by_kernel(call).values())
        w2t = w2.t()
        row["torch_mm"] = ms(lambda: torch.mm(g2, w2t), iters)
        row["dh_nt_bf16"] = ms(lambda: G.gemm_bwd(g2, w2, "nt", "store"), iters)
        row["dual"] = ms(lambda: G.gemm_dual(y, w1, b1, g2, w2), iters)
        row["kernel7_by_kernel"] = by_kernel(lambda: MB.mlp_block_bwd_stash(x, s_, c_, w1, w2, a, g))
        row["kernel8_by_kernel"] = by_kernel(lambda: MB.mlp_block_bwd(x, s_, c_, w1, b1, w2, g))
        cells = (f"{n} {t:.4f} ms" for n, t in row.items()
                 if isinstance(t, float) and not n.endswith(("_max_rel", "_device")))
        print(f"{label} (M={M}, D={D}, F={F}): " + " | ".join(cells), flush=True)
        print("  device ms (profiler): " + " | ".join(
            f"{n[:-7]} {t:.4f}" for n, t in row.items() if n.endswith("_device")), flush=True)
        for k in ("kernel7_by_kernel", "kernel8_by_kernel"):
            print(f"  {k}: total {sum(row[k].values()):.4f} ms: " + ", ".join(
                f"{n.split('(')[0]} {t:.4f}" for n, t in row[k].items()), flush=True)
        out[label] = row
    print(json.dumps({"device": smi, "ms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
