"""What the SN-block kernels' time is made of on the card.

    python3 -m vcrnet_tpu_torch.train.gather_max_parts [--csrc DIR]

Compiles ``knn_gather_max.cu``, ``knn.cu``, ``gather_max_from_idx.cu`` and
``gather_max_bwd.cu`` from ``--csrc`` (default: this package's sources;
another checkout's ``vcrnet_tpu_torch/csrc`` times that checkout's kernels,
whose C interface is the same), each alone with nvcc into a shared library
with a C shim, and times them with CUDA events (median of 25) on seeded
random clouds in [-1, 1]^3 with a bf16 table of F = 256 channels, k = 20:

* at B = 64 clouds of N = 1024 (the 64-pair request): ``knn_gather_max``;
  ``knn`` on the same xyz, which runs the same scores and selection and no
  gather; ``gather_max_from_idx`` on ``knn_gather_max``'s idx, which runs
  the same gather and no selection (a gather by channel slices from shared
  memory, another design than ``knn_gather_max``'s: the difference is not
  the scores and the selection alone); ``gather_max_from_idx`` with winners, and at the other
  sizes of the served paths (B = 64, N = 768 and 885; B = 8, N = 3072);
* at 2B = 128 clouds (the training step): ``knn_gather_max`` with winners,
  and ``gather_max_bwd`` from them, alone and behind a zero fill of dv (the
  fill that a kernel adding into dv needs from its caller);
* ``knn_gather_max`` and ``gather_max_bwd`` at B = 8, N = 3072;
* variants: builds of one source from a copy of the sources with one
  constant changed (``VARIANTS``: queries a warp, the backward's slice and
  block), at the request's or the step's shape.
  A variant whose text the sources do not hold is reported and skipped.

Each library is held against the plain versions first (idx equal to
``knn``'s, gather-max and winners exact on that idx, dv within 1e-5), so
that a wrong call through the shim cannot pass for a time. Prints the
card's ``nvidia-smi`` name and power limit first, one line a timing, and
last one JSON object of them all. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from vcrnet_tpu_torch.ops import _build, edgeconv
from vcrnet_tpu_torch.train.edge_conv_parts import _call, build, time_ms

K, F = 20, 256
BUILD_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "gather_max_parts")

SHIMS = {
    "knn_gather_max.cu": """
extern "C" int shim(const float* x, const float* norms, const void* values, void* out, int* idx,
                    void* win, int batch, int n, int f, int k, void* stream) {
  return static_cast<int>(vcr_knn_gather_max(x, norms, values, out, idx, win, batch, n, f, k,
                                             static_cast<cudaStream_t>(stream)));
}
""",
    "knn.cu": """
extern "C" int shim(const void* x, const float* norms, int* idx, int batch, int n, int c, int k,
                    int is_bf16, void* stream) {
  return static_cast<int>(vcr_knn(x, norms, idx, batch, n, c, k, is_bf16,
                                  static_cast<cudaStream_t>(stream)));
}
""",
    "gather_max_from_idx.cu": """
extern "C" int shim(const int* idx, const void* values, void* out, void* win, int batch, int n,
                    int f, int k, void* stream) {
  return static_cast<int>(vcr_gather_max_from_idx(idx, values, out, win, batch, n, f, k,
                                                  static_cast<cudaStream_t>(stream)));
}
""",
    "gather_max_bwd.cu": """
extern "C" int shim(const int* idx, const void* win, const void* ct, float* dv, int batch, int n,
                    int f, int k, void* stream) {
  return static_cast<int>(vcr_gather_max_bwd(idx, win, ct, dv, batch, n, f, k,
                                             static_cast<cudaStream_t>(stream)));
}
""",
}


# a variant: (source it builds, [(file of the sources, text, replacement)])
_QW = ("knn_scores.cuh", "constexpr int kQueriesPerWarp = 2;")
_BUDGET = ("gather_max_bwd.cu", "constexpr size_t kSliceBudget = 232448;")
_THREADS = ("gather_max_bwd.cu", "constexpr int kThreads = 1024;")
_SLICE64 = ("gather_max_from_idx.cu", "if (slice_smem(n, 32, k) <= kSliceBudget)")
_GATHER_THREADS = ("gather_max_from_idx.cu", "constexpr int kThreads = 1024;")
VARIANTS = {
    # slices of 32 channels where 64 fit (two queries a warp), with all the
    # block's indices at once (one block an SM at N = 1024), or with a ring
    # of indices small enough for two blocks an SM
    "gather_max_from_idx_slices_32":
        ("gather_max_from_idx.cu", [(*_SLICE64, "if (false)")]),
    "gather_max_from_idx_slices_32_two_blocks":
        ("gather_max_from_idx.cu", [(*_SLICE64, "if (false)"),
                                    ("gather_max_from_idx.cu",
                                     "constexpr size_t kBlockBudget = kSliceBudget;",
                                     "constexpr size_t kBlockBudget = 114688;")]),
    "gather_max_from_idx_threads_512":
        ("gather_max_from_idx.cu", [(*_GATHER_THREADS, "constexpr int kThreads = 512;")]),
    # the rows' loop cut: staging, indices and stores alone
    "gather_max_from_idx_no_rows":
        ("gather_max_from_idx.cu", [("gather_max_from_idx.cu", "for (int r = 0; r < kk; r += 4)",
                                     "for (int r = 0; r < 0; r += 4)")]),
    # the running max by max.bf16x2 (no winners; -0 and +0 not ordered as idx)
    "gather_max_from_idx_hmax2":
        ("gather_max_from_idx.cu", [("gather_max_from_idx.cu",
                                     "const uint32_t gt = gt_mask(v[i], m);\n          m = (v[i] & gt) | (m & ~gt);",
                                     "const uint32_t gt = 0;\n          const __nv_bfloat162 mx = "
                                     "__hmax2(*reinterpret_cast<const __nv_bfloat162*>(&v[i]), "
                                     "*reinterpret_cast<const __nv_bfloat162*>(&m));\n"
                                     "          m = *reinterpret_cast<const uint32_t*>(&mx);")]),
    "knn_gather_max_queries_per_warp_1":
        ("knn_gather_max.cu", [(*_QW, "constexpr int kQueriesPerWarp = 1;")]),
    "knn_gather_max_queries_per_warp_4":
        ("knn_gather_max.cu", [(*_QW, "constexpr int kQueriesPerWarp = 4;")]),
    "gather_max_bwd_slice_budget_64k":
        ("gather_max_bwd.cu", [(*_BUDGET, "constexpr size_t kSliceBudget = 65536;")]),
    "gather_max_bwd_threads_512":
        ("gather_max_bwd.cu", [(*_THREADS, "constexpr int kThreads = 512;")]),
}


def _variant_sources(csrc: str, dst: str, patches) -> str | None:
    """A copy of ``csrc`` in ``dst`` with the patches made, or None where a
    patch's text is not in its file."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for name, old, new in patches:
        path = os.path.join(dst, name)
        with open(path) as fh:
            text = fh.read()
        if old not in text:
            return None
        with open(path, "w") as fh:
            fh.write(text.replace(old, new, 1))
    return dst


def build_variants(csrc: str, build_dir: str) -> dict:
    """{variant: loaded library} for the variants the sources allow,
    compiled in parallel."""
    jobs = {}
    for name, (src, patches) in VARIANTS.items():
        vsrc = _variant_sources(csrc, os.path.join(build_dir, name), patches)
        if vsrc is None:
            print(f"{name}: the sources hold no such constant; skipped", flush=True)
        else:
            jobs[name] = (vsrc, src)
    if not jobs:
        return {}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = pool.map(lambda item: build(item[1][0], {item[0]: (item[1][1], ())}, SHIMS,
                                            os.path.join(item[1][0], "lib")), jobs.items())
    return {name: lib[name] for name, lib in zip(jobs, built)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=_build.CSRC_DIR, help="the kernels' source directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_max_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"card: {smi.strip().splitlines()[0]}; sources {os.path.abspath(args.csrc)}",
          flush=True)
    # one build directory per source tree, so that two trees timed in one
    # run do not share libraries
    tag = hashlib.sha1(os.path.abspath(args.csrc).encode()).hexdigest()[:12]
    libs = build(args.csrc, {src[:-3]: (src, ()) for src in SHIMS}, SHIMS,
                 os.path.join(BUILD_DIR, tag))
    variants = build_variants(args.csrc, os.path.join(BUILD_DIR, tag, "variants"))
    fused, knn_lib = libs["knn_gather_max"].shim, libs["knn"].shim
    from_idx, bwd = libs["gather_max_from_idx"].shim, libs["gather_max_bwd"].shim

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}

    def report(name, ms, **extra):
        out[name] = dict(ms=ms, **extra)
        print(f"{name}: {ms} ms {extra if extra else ''}", flush=True)

    def inputs(b, n):
        x = torch.rand(b, n, 3, generator=g, device=dev) * 2 - 1
        values = torch.randn(b, n, F, generator=g, device=dev).to(bf16)
        o = torch.empty_like(values)
        idx = torch.empty(b, n, K, dtype=torch.int32, device=dev)
        win = torch.empty(b, n, F, dtype=torch.uint8, device=dev)
        return x, (x * x).sum(-1), values, o, idx, win

    def checked_fused(b, n, winners):
        """Run knn_gather_max once and hold it against knn and the plain version."""
        x, norms, values, o, idx, win = inputs(b, n)
        w = win if winners else None
        _call(fused, x, norms, values, o, idx, w, b, n, F, K)
        knn_idx = torch.empty_like(idx)
        _call(knn_lib, x, norms, knn_idx, b, n, 3, K, 0)
        torch.cuda.synchronize()
        if not torch.equal(idx, knn_idx):
            raise RuntimeError(f"knn_gather_max B={b} N={n}: idx differs from knn's")
        ref_out, _, ref_win = edgeconv.fused_knn_gather_max_ref(None, values, idx=idx,
                                                                winners=True)
        if not torch.equal(o, ref_out) or (winners and not torch.equal(win, ref_win)):
            raise RuntimeError(f"knn_gather_max B={b} N={n}: differs from the plain version")
        return x, norms, values, o, idx, w

    def checked_bwd(b, n, idx, win, with_variants=False):
        ct = torch.randn(b, n, F, generator=g, device=dev).to(bf16)
        want = edgeconv.gather_max_bwd_ref(idx, win, ct)
        dv = torch.zeros(b, n, F, device=dev)
        libs_here = {f"gather_max_bwd_B{b}_N{n}": bwd}
        if with_variants:
            libs_here.update({name: lib.shim for name, lib in variants.items()
                              if name.startswith("gather_max_bwd")})
        for name, fn in libs_here.items():
            dv.zero_()
            _call(fn, idx, win, ct, dv, b, n, F, K)
            torch.cuda.synchronize()
            err = (dv - want).abs().max().item()
            if err > 1e-5:
                raise RuntimeError(f"{name}: max abs err {err} > 1e-5")
            report(name, time_ms(lambda: _call(fn, idx, win, ct, dv, b, n, F, K)),
                   max_abs_err=err)

        def zero_and_bwd():
            dv.zero_()
            _call(bwd, idx, win, ct, dv, b, n, F, K)

        report(f"gather_max_bwd_with_zero_fill_B{b}_N{n}", time_ms(zero_and_bwd))

    # ---- the request's shapes: the split of knn_gather_max
    b, n = 64, 1024
    x, norms, values, o, idx, _ = checked_fused(b, n, winners=False)
    report("knn_gather_max", time_ms(lambda: _call(fused, x, norms, values, o, idx, None, b, n,
                                                   F, K)))
    knn_idx = torch.empty_like(idx)
    report("knn_xyz", time_ms(lambda: _call(knn_lib, x, norms, knn_idx, b, n, 3, K, 0)))
    fo = torch.empty_like(o)
    _call(from_idx, idx, values, fo, None, b, n, F, K)
    torch.cuda.synchronize()
    if not torch.equal(fo, o):
        raise RuntimeError("gather_max_from_idx: differs from knn_gather_max on its idx")
    report("gather_max_from_idx", time_ms(lambda: _call(from_idx, idx, values, fo, None, b, n,
                                                        F, K)))
    report("knn_gather_max_less_gather_max_from_idx",
           out["knn_gather_max"]["ms"] - out["gather_max_from_idx"]["ms"])
    win = torch.empty(b, n, F, dtype=torch.uint8, device=dev)
    _call(from_idx, idx, values, fo, win, b, n, F, K)
    torch.cuda.synchronize()
    ref_out, _, ref_win = edgeconv.fused_knn_gather_max_ref(None, values, idx=idx, winners=True)
    if not (torch.equal(fo, ref_out) and torch.equal(win, ref_win)):
        raise RuntimeError("gather_max_from_idx with winners: differs from the plain version")
    report("gather_max_from_idx_winners", time_ms(lambda: _call(from_idx, idx, values, fo, win,
                                                                b, n, F, K)))
    for name, lib in variants.items():  # each held to the main build's outputs
        if not name.startswith("gather_max_from_idx"):
            continue
        vo = torch.empty_like(o)

        def call(fn=lib.shim):
            _call(fn, idx, values, vo, None, b, n, F, K)

        call()
        torch.cuda.synchronize()
        if not name.endswith("_no_rows") and not torch.equal(vo, o):  # a cut build: time alone
            raise RuntimeError(f"{name}: differs from the main build")
        report(name, time_ms(call))
    for b2, n2 in ((64, 768), (64, 885), (8, 3072)):
        x2, _, values2, o2, idx2, _ = checked_fused(b2, n2, winners=False)
        fo2 = torch.empty_like(o2)
        _call(from_idx, idx2, values2, fo2, None, b2, n2, F, K)
        torch.cuda.synchronize()
        if not torch.equal(fo2, o2):
            raise RuntimeError(f"gather_max_from_idx B={b2} N={n2}: differs from knn_gather_max")
        report(f"gather_max_from_idx_B{b2}_N{n2}",
               time_ms(lambda: _call(from_idx, idx2, values2, fo2, None, b2, n2, F, K)))
    for name, lib in variants.items():  # each held to the main build's outputs
        if not name.startswith("knn_gather_max"):
            continue
        vo, vidx = torch.empty_like(o), torch.empty_like(idx)

        def call(fn=lib.shim):
            _call(fn, x, norms, values, vo, vidx, None, b, n, F, K)

        call()
        torch.cuda.synchronize()
        if not (torch.equal(vo, o) and torch.equal(vidx, idx)):
            raise RuntimeError(f"{name}: differs from the main build")
        report(name, time_ms(call))

    # ---- the training step's shapes: winners, then the backward from them
    b = 128
    x, norms, values, o, idx, win = checked_fused(b, n, winners=True)
    report("knn_gather_max_winners_B128",
           time_ms(lambda: _call(fused, x, norms, values, o, idx, win, b, n, F, K)))
    checked_bwd(b, n, idx, win, with_variants=True)

    # ---- the large partial crop's shape
    b, n = 8, 3072
    x, norms, values, o, idx, win = checked_fused(b, n, winners=True)
    report("knn_gather_max_B8_N3072",
           time_ms(lambda: _call(fused, x, norms, values, o, idx, None, b, n, F, K)))
    checked_bwd(b, n, idx, win)
    print(json.dumps({"card": smi.strip().splitlines()[0], "sources": args.csrc,
                      "parts": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
