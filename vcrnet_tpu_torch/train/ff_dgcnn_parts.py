"""What the feed-forward and DGCNN eval kernels' time is made of on the card.

    python3 -m vcrnet_tpu_torch.train.ff_dgcnn_parts [--csrc DIR]

Compiles ``pointer_ff.cu`` and ``dgcnn_eval.cu`` from ``--csrc`` (default:
this package's sources; another checkout's ``vcrnet_tpu_torch/csrc`` times
that checkout's kernels: ``dgcnn_eval.cu``'s C interface is the same, and
``pointer_ff.cu`` is called with or without its hidden scratch as its source
declares it), each alone with nvcc into a shared library with a C shim, and
times them with CUDA events (median of 25) on seeded random inputs at
B = 64 and 8, N = 1024 (D = 512, F = 1024; k = 20 neighbours of random
points in [-1, 1]^3, emb 512):

* ``fused_ff``, and a build with the second product's launch cut (a source
  of two launches): the first product alone; the difference is the second;
* ``dgcnn_eval``, and a build with the projection's launch cut: the edge
  kernel alone; the difference is the projection.

A cut whose text the source does not hold is reported and skipped; the cut
builds' results are wrong and only their times are read. Beside them, the
library's sequences for the same work, yardsticks only: ``F.linear``, relu,
``F.linear`` in bf16 for the feed-forward (three calls), and one bf16
``torch.addmm`` and a relu for DGCNN's projection of the concat (bf16 out
where the kernel writes f32).

The full builds are held against the plain versions first (2^-6 of the
largest output for the feed-forward, 2e-2 for DGCNN), so that a wrong call
through a shim cannot pass for a time. Prints the card's ``nvidia-smi`` name
and power limit first, one line a timing, and last one JSON object of them
all. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess

import torch
import torch.nn.functional as F

from vcrnet_tpu_torch.ops import _build, dgcnn, knn, pointer
from vcrnet_tpu_torch.train.edge_conv_parts import _call, build, rel_err, time_ms

N, K, D, FF, EMB = 1024, 20, 512, 1024, 512
BUILD_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "ff_dgcnn_parts")

# pointer_ff.cu with a hidden scratch (two launches of the product), and
# without (the earlier design's one kernel); the shim's own argument list is
# the same
_FF_SHIM_H = """
extern "C" int shim(const void* y, const void* w1, const void* b1, const void* w2, const void* b2,
                    void* hidden, void* out, int rows, int d, int f, void* stream) {
  return static_cast<int>(vcr_pointer_ff(y, w1, b1, w2, b2, hidden, out, rows, d, f,
                                         static_cast<cudaStream_t>(stream)));
}
"""
_FF_SHIM_ONE = """
extern "C" int shim(const void* y, const void* w1, const void* b1, const void* w2, const void* b2,
                    void* hidden, void* out, int rows, int d, int f, void* stream) {
  (void)hidden;
  return static_cast<int>(vcr_pointer_ff(y, w1, b1, w2, b2, out, rows, d, f,
                                         static_cast<cudaStream_t>(stream)));
}
"""
_DGCNN_SHIM = """
extern "C" int shim(const float* x, const int* idx, const void* w1, const float* b1,
                    const void* w2, const float* b2, const void* w3, const float* b3,
                    const void* w4, const float* b4, const void* w5, const float* b5, void* cat,
                    float* out, int batch, int n, int k, int emb, void* stream) {
  return static_cast<int>(vcr_dgcnn_eval(x, idx, w1, b1, w2, b2, w3, b3, w4, b4, w5, b5, cat, out,
                                         batch, n, k, emb, static_cast<cudaStream_t>(stream)));
}
"""

# cuts: (text in the source, its replacement); the first whose text the
# source holds is made
_FF_FIRST_ONLY = (
    ("  if (err != cudaSuccess) return err;  // h is written\n",
     "  return err;  // h is written\n"),
)
_DGCNN_EDGES_ONLY = (
    ("  if (err != cudaSuccess) return err;  // cat is written\n",
     "  return err;  // cat is written\n"),
    ("  err = cudaGetLastError();\n  if (err != cudaSuccess) return err;\n\n"
     "  const size_t smem = align128(vcr::gemm::tile_bytes(kCat))",
     "  return cudaGetLastError();\n\n"
     "  const size_t smem = align128(vcr::gemm::tile_bytes(kCat))"),
)


def _pick(text: str, alternatives) -> tuple | None:
    for old, new in alternatives:
        if old in text:
            return ((old, new),)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=_build.CSRC_DIR, help="the kernels' source directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ff_dgcnn_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(f"card: {card}; sources {os.path.abspath(args.csrc)}", flush=True)
    texts = {}
    for src in ("pointer_ff.cu", "dgcnn_eval.cu"):
        with open(os.path.join(args.csrc, src)) as fh:
            texts[src] = fh.read()
    shims = {"pointer_ff.cu": _FF_SHIM_H if "void* hidden" in texts["pointer_ff.cu"]
             else _FF_SHIM_ONE, "dgcnn_eval.cu": _DGCNN_SHIM}
    jobs = {"fused_ff": ("pointer_ff.cu", ()), "dgcnn_eval": ("dgcnn_eval.cu", ())}
    for name, src, alternatives in (("fused_ff_first_product", "pointer_ff.cu", _FF_FIRST_ONLY),
                                    ("dgcnn_eval_edges", "dgcnn_eval.cu", _DGCNN_EDGES_ONLY)):
        picked = _pick(texts[src], alternatives)
        if picked is None:
            print(f"{name}: the source holds no such launch; skipped", flush=True)
        else:
            jobs[name] = (src, picked)
    # one build directory per source tree, so that two trees timed in one
    # run do not share libraries
    tag = hashlib.sha1(os.path.abspath(args.csrc).encode()).hexdigest()[:12]
    libs = build(args.csrc, jobs, shims, os.path.join(BUILD_DIR, tag))

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    out = {}

    def report(name, ms, **extra):
        out[name] = dict(ms=ms, **extra)
        print(f"{name}: {ms} ms {extra if extra else ''}", flush=True)

    def parts(name, whole, first, what_first, what_rest):
        if first in out:
            report(f"{name}_{what_rest}", out[whole]["ms"] - out[first]["ms"],
                   note=f"the whole less the {what_first}")

    # ---- the feed-forward sublayer
    ff_w = (randn(D, FF, scale=D ** -0.5), randn(FF, scale=0.1),
            randn(FF, D, scale=FF ** -0.5), randn(D, scale=0.1))
    w1_t, w2_t = ff_w[0].t().contiguous(), ff_w[2].t().contiguous()
    for b in (64, 8):
        y = randn(b, N, D)
        hidden = torch.empty(b, N, FF, dtype=bf16, device=dev)
        o = torch.empty_like(y)

        def call(lib):
            _call(lib.shim, y, *ff_w, hidden, o, b * N, D, FF)

        call(libs["fused_ff"])
        torch.cuda.synchronize()
        want = pointer.fused_ff_ref(y, *ff_w)
        err = rel_err(o.float(), want.float())
        if err > 2 ** -6:
            raise RuntimeError(f"fused_ff B={b} through the shim: relative err {err}")
        name = f"fused_ff_B{b}"
        report(name, time_ms(lambda: call(libs["fused_ff"])), rel_err=err)
        if "fused_ff_first_product" in libs:
            report(f"{name}_first_product", time_ms(lambda: call(libs["fused_ff_first_product"])))
            parts(name, name, f"{name}_first_product", "first product", "second_product")

        def library():
            return F.linear(torch.relu(F.linear(y, w1_t, ff_w[1])), w2_t, ff_w[3])

        lib_err = rel_err(library().float(), want.float())
        if lib_err > 5e-2:
            raise RuntimeError(f"library feed-forward B={b}: relative err {lib_err}")
        report(f"{name}_library_seq", time_ms(library), rel_err=lib_err, calls=3)
        del hidden, want

    # ---- DGCNN's eval chain
    folded = [(randn(i, o, scale=i ** -0.5, dtype=torch.float32),
               randn(o, scale=0.1, dtype=torch.float32))
              for i, o in dgcnn.STAGE_WIDTHS + ((dgcnn.CAT_WIDTH, EMB),)]
    args_w = [t for w, bias in folded for t in (w.to(bf16).contiguous(), bias.contiguous())]
    w5, b5 = args_w[8], folded[4][1].to(bf16)
    for b in (64, 8):
        x = torch.rand(b, N, 3, generator=g, device=dev) * 2 - 1
        idx = knn.fused_knn_ref(x, K)
        cat = torch.empty(b, N, dgcnn.CAT_WIDTH, dtype=bf16, device=dev)
        o = torch.empty(b, N, EMB, device=dev)

        def call(lib):
            _call(lib.shim, x, idx, *args_w, cat, o, b, N, K, EMB)

        call(libs["dgcnn_eval"])
        torch.cuda.synchronize()
        want = dgcnn.fused_dgcnn_eval_ref(x, idx, folded, EMB)
        err = rel_err(o, want)
        if err > 2e-2:
            raise RuntimeError(f"dgcnn_eval B={b} through the shim: relative err {err}")
        name = f"dgcnn_eval_B{b}"
        report(name, time_ms(lambda: call(libs["dgcnn_eval"])), rel_err=err)
        if "dgcnn_eval_edges" in libs:
            report(f"{name}_edges", time_ms(lambda: call(libs["dgcnn_eval_edges"])))
            parts(name, name, f"{name}_edges", "edge kernel", "projection")
        cat2d = cat.view(b * N, dgcnn.CAT_WIDTH)
        report(f"{name}_library_projection",
               time_ms(lambda: torch.relu(torch.addmm(b5, cat2d, w5))), calls=2)
        del want, cat, o
    print(json.dumps({"card": card, "sources": args.csrc, "parts": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
