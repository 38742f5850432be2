"""What the edge-conv kernels' time is made of on the card.

    python3 -m vcrnet_tpu_torch.train.edge_conv_parts [--csrc DIR]

Compiles ``edge_conv.cu``, ``edge_conv_from_idx.cu`` and ``edge_conv_bwd.cu``
from ``--csrc`` (default: this package's sources; another checkout's
``vcrnet_tpu_torch/csrc`` times that checkout's kernels, whose C interface
is the same), each alone with nvcc into a shared library with a C shim,
and times them with CUDA events (median of 25) at B = 64 clouds of
N = 1024, k = 20, C = 64, F = 128 (the backward at 2B = 128 clouds, as the
training step runs it), on seeded random inputs:

* the forward's split: ``edge_conv`` without and with winners, and
  ``edge_conv_from_idx`` on its idx, which runs the same edge phase with no
  score product and no selection; the difference is the scores and the
  selection;
* the backward with parts left out: builds of ``edge_conv_bwd.cu`` without
  the scatter into da (``red_add_v4`` made a no-op, so its shuffles and
  roundings go too), without dW2's sum, and without both, cut from the
  source text. Their results are wrong; only their times are read. A cut
  whose text the source does not hold is reported and skipped.

The full builds are held against the plain versions first, so that a
wrong call through the shim cannot pass for a time. Prints the card's
``nvidia-smi`` name and power limit first, one line a timing, and last one
JSON object of them all. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from vcrnet_tpu_torch.ops import _build, edgeconv

B, N, K, C, F = 64, 1024, 20, 64, 128
BUILD_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "edge_conv_parts")

# a cut: (text in the source, its replacement)
_NO_DA = ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n#define red_add_v4(...) ((void)0)\n')
_NO_DW2 = ("accw[c] = fmaf(zc[c * kZStride], dp, accw[c]);", "(void)zc;")
BWD_VARIANTS = {"full": (), "no_da": (_NO_DA,), "no_dw2": (_NO_DW2,),
                "no_da_no_dw2": (_NO_DA, _NO_DW2)}

_SHIMS = {
    "edge_conv.cu": """
extern "C" int shim(const void* x, const float* norms, const void* a, const void* h,
                    const void* w2, const void* b2, void* x1, void* x2, int* idx, void* win1,
                    void* win2, int batch, int n, int c, int k, float slope, void* stream) {
  return static_cast<int>(vcr_edge_conv(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, batch,
                                        n, c, k, slope, static_cast<cudaStream_t>(stream)));
}
""",
    "edge_conv_from_idx.cu": """
extern "C" int shim(const int* idx, const void* a, const void* h, const void* w2, const void* b2,
                    void* x1, void* x2, int batch, int n, int k, float slope, void* stream) {
  return static_cast<int>(vcr_edge_conv_from_idx(idx, a, h, w2, b2, x1, x2, batch, n, k, slope,
                                                 static_cast<cudaStream_t>(stream)));
}
""",
    "edge_conv_bwd.cu": """
extern "C" int shim_grid(int rows, int* blocks, long long* scratch_floats) {
  int64_t s = 0;
  const int err = static_cast<int>(vcr_edge_conv_bwd_grid(rows, blocks, &s));
  *scratch_floats = s;
  return err;
}
extern "C" int shim(const int* idx, const void* win1, const void* win2, const void* a,
                    const void* h, const void* w2, const void* x2, const void* ct1,
                    const void* ct2, float* da, float* dh, float* dw2, float* db2,
                    float* partial, int blocks, int batch, int n, int k, float slope,
                    void* stream) {
  return static_cast<int>(vcr_edge_conv_bwd(idx, win1, win2, a, h, w2, x2, ct1, ct2, da, dh, dw2,
                                            db2, partial, blocks, batch, n, k, slope,
                                            static_cast<cudaStream_t>(stream)));
}
""",
}


def _source(csrc: str, src: str, cuts, shims: dict = _SHIMS) -> str | None:
    with open(os.path.join(csrc, src)) as fh:
        text = fh.read()
    for old, new in cuts:
        if old not in text:
            return None
        text = text.replace(old, new, 1)
    return text + shims[src]


def build(csrc: str, jobs: dict, shims: dict = _SHIMS, build_dir: str = BUILD_DIR) -> dict:
    """{name: (source file, cuts)} -> {name: loaded library or None where a
    cut does not apply}, each source with its C shim from ``shims``,
    compiled in parallel into ``build_dir``."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    os.makedirs(build_dir, exist_ok=True)

    def one(name):
        src, cuts = jobs[name]
        text = _source(csrc, src, cuts, shims)
        if text is None:
            return name, None
        cu = os.path.join(build_dir, f"{name}.cu")
        lib = os.path.join(build_dir, f"{name}.so")
        with open(cu, "w") as fh:
            fh.write(text)
        r = subprocess.run([nvcc, *_build.CUDA_FLAGS, "-shared", "-Xcompiler", "-fPIC",
                            "-I", os.path.abspath(csrc), "-o", lib, cu, "-ldl"],
                           capture_output=True, text=True, timeout=900)
        if r.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{r.stdout}{r.stderr}")
        return name, ctypes.CDLL(lib)

    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(one, jobs))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def _call(fn, *args) -> None:
    conv = [_ptr(a) if isinstance(a, torch.Tensor) or a is None else
            ctypes.c_float(a) if isinstance(a, float) else ctypes.c_int(a) for a in args]
    err = fn(*conv, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default=_build.CSRC_DIR, help="the kernels' source directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("edge_conv_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"card: {smi.strip().splitlines()[0]}; sources {os.path.abspath(args.csrc)}",
          flush=True)
    jobs = {"edge_conv": ("edge_conv.cu", ()),
            "edge_conv_from_idx": ("edge_conv_from_idx.cu", ())}
    jobs.update({f"edge_conv_bwd_{v}": ("edge_conv_bwd.cu", cuts)
                 for v, cuts in BWD_VARIANTS.items()})
    libs = build(args.csrc, jobs)

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf16)

    out = {}

    def report(name, ms, **extra):
        out[name] = dict(ms=ms, **extra)
        print(f"{name}: {ms} ms {extra if extra else ''}", flush=True)

    # ---- forward: scores and selection against the edge phase alone
    x = randn(B, N, C)
    a, h = randn(B, N, F, scale=0.5), randn(B, N, F, scale=0.5)
    w2, b2 = randn(F, F, scale=F ** -0.5), randn(F, scale=0.1)
    norms = x.float().square().sum(-1)
    x1, x2 = torch.empty_like(a), torch.empty_like(a)
    idx = torch.empty(B, N, K, dtype=torch.int32, device=dev)
    win1 = torch.empty(B, N, F, dtype=torch.uint8, device=dev)
    win2 = torch.empty_like(win1)
    fwd = libs["edge_conv"].shim

    def conv(w1=None, w2_=None):
        _call(fwd, x, norms, a, h, w2, b2, x1, x2, idx, w1, w2_, B, N, C, K, 0.0)

    conv()
    torch.cuda.synchronize()
    r1, r2 = edgeconv.fused_edge_conv_ref(x, a, h, w2, b2, K, idx=idx)[:2]
    err = max((x1.float() - r1.float()).abs().max().item(),
              (x2.float() - r2.float()).abs().max().item())
    if err > 2e-2:
        raise RuntimeError(f"edge_conv through the shim: max abs err {err} > 2e-2")
    report("edge_conv", time_ms(conv), max_abs_err=err)
    report("edge_conv_winners", time_ms(lambda: conv(win1, win2)))
    fx1, fx2 = torch.empty_like(a), torch.empty_like(a)
    frm = libs["edge_conv_from_idx"].shim

    def from_idx():
        _call(frm, idx, a, h, w2, b2, fx1, fx2, B, N, K, 0.0)

    from_idx()
    torch.cuda.synchronize()
    if not torch.equal(fx1, x1):
        raise RuntimeError("edge_conv_from_idx through the shim: x1 differs from edge_conv's")
    report("edge_conv_from_idx", time_ms(from_idx))
    report("edge_conv_scores_and_selection",
           out["edge_conv"]["ms"] - out["edge_conv_from_idx"]["ms"],
           note="edge_conv less edge_conv_from_idx")

    # ---- backward at twice the clouds, from the forward's idx and winners
    B2 = 2 * B
    x = randn(B2, N, C)
    a, h = randn(B2, N, F, scale=0.5), randn(B2, N, F, scale=0.5)
    norms = x.float().square().sum(-1)
    x1, x2 = torch.empty_like(a), torch.empty_like(a)
    idx = torch.empty(B2, N, K, dtype=torch.int32, device=dev)
    win1 = torch.empty(B2, N, F, dtype=torch.uint8, device=dev)
    win2 = torch.empty_like(win1)
    _call(fwd, x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, B2, N, C, K, 0.0)
    ct1, ct2 = randn(B2, N, F), randn(B2, N, F)
    for v in BWD_VARIANTS:
        lib = libs[f"edge_conv_bwd_{v}"]
        if lib is None:
            print(f"edge_conv_bwd_{v}: the sources hold no such part; skipped", flush=True)
            continue
        blocks, floats = ctypes.c_int(0), ctypes.c_longlong(0)
        if lib.shim_grid(ctypes.c_int(B2 * N), ctypes.byref(blocks), ctypes.byref(floats)):
            raise RuntimeError(f"edge_conv_bwd_{v}: grid query failed")
        da = torch.zeros(B2, N, F, device=dev)
        dh = torch.empty_like(da)
        dw2, db2 = torch.empty(F, F, device=dev), torch.empty(F, device=dev)
        partial = torch.empty(floats.value, device=dev)

        def bwd():
            _call(lib.shim, idx, win1, win2, a, h, w2, x2, ct1, ct2, da, dh, dw2, db2, partial,
                  blocks.value, B2, N, K, 0.0)

        extra = {}
        if v == "full":
            bwd()
            torch.cuda.synchronize()
            want = edgeconv.edge_conv_bwd_ref(idx, win1, win2, a, h, w2, x2, ct1, ct2)
            errs = [rel_err(gv, wv) for gv, wv in zip((da, dh, dw2, db2), want)]
            if errs[0] > 2 ** -7 or max(errs[1:]) > 1e-4:
                raise RuntimeError(f"edge_conv_bwd through the shim: relative errors {errs}")
            extra = dict(rel_errs=errs)
        report(f"edge_conv_bwd_{v}", time_ms(bwd), blocks=blocks.value, **extra)
    print(json.dumps({"card": smi.strip().splitlines()[0], "sources": args.csrc,
                      "parts": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
