"""What the edge-conv kernels' time is made of on the card.

    python3 -m vcrnet_tpu_torch.train.edge_conv_parts [--csrc DIR] [--sizes 1024,1000,885]
    python3 -m vcrnet_tpu_torch.train.edge_conv_parts --csrc DIR DIR ... [--rounds 12]

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
  whose text the source does not hold is reported and skipped. The
  backward runs at each cloud size N of ``--sizes`` (default 1024; sources
  from before it took a ragged last round refuse N % 16 != 0: give them
  ``--sizes 1024`` alone).

Sources that have the f32 instance (``vcr_edge_conv_f32knn``: an f32 kNN
space at C = 64, LPDNet's after ``t_net_fea``) also time it on an f32 x
with the same a, h, W2 and b2, without and with winners. Where the sources
have its split pass (``vcr_edge_split``: x as three bf16 planes, which the
f32 instance takes in place of x), a call of the f32 instance is the split
into the shim's own scratch and then the instance, and the split is also
timed alone (``edge_split``).

Given several source directories, it times each one's forward
(``edge_conv`` without and with winners at B clouds, and the f32 instance's
where the sources have it) and full backward (at 2B clouds), at the first
size, in turns within one process: ``--rounds`` rounds, each timing every
source once (median of 25 a call) in an order that rotates and reverses
from round to round, then each source's median over the rounds against the
first's and the rounds in which it was slower, call by call. Separate
processes of one call differ by a few per cent on the same source; turns
in one process take that spread out of a parent/change comparison.

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


# the f32 instance's entry point (vcr_edge_conv's signature), in sources that have it
_F32_SHIM = """
extern "C" int shim_f32(const void* x, const float* norms, const void* a, const void* h,
                        const void* w2, const void* b2, void* x1, void* x2, int* idx, void* win1,
                        void* win2, int batch, int n, int c, int k, float slope, void* stream) {
  return static_cast<int>(vcr_edge_conv_f32knn(x, norms, a, h, w2, b2, x1, x2, idx, win1, win2,
                                               batch, n, c, k, slope,
                                               static_cast<cudaStream_t>(stream)));
}
"""


# the same in sources whose f32 instance takes the planes of its split pass:
# the split into a scratch the shim keeps (grown on demand), then the instance
_F32_SPLIT_SHIM = """
#include <cuda_runtime.h>
extern "C" int shim_split(const float* x, void* planes, int count, void* stream) {
  return static_cast<int>(vcr_edge_split(x, planes, count, static_cast<cudaStream_t>(stream)));
}
extern "C" int shim_f32(const void* x, const float* norms, const void* a, const void* h,
                        const void* w2, const void* b2, void* x1, void* x2, int* idx, void* win1,
                        void* win2, int batch, int n, int c, int k, float slope, void* stream) {
  static void* planes = nullptr;
  static size_t bytes = 0;
  const int count = batch * n * c;
  if (3 * 2 * static_cast<size_t>(count) > bytes) {
    if (planes != nullptr) cudaFree(planes);
    bytes = 3 * 2 * static_cast<size_t>(count);
    const cudaError_t err = cudaMalloc(&planes, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int err = shim_split(static_cast<const float*>(x), planes, count, stream);
  if (err) return err;
  return static_cast<int>(vcr_edge_conv_f32knn(planes, norms, a, h, w2, b2, x1, x2, idx, win1,
                                               win2, batch, n, c, k, slope,
                                               static_cast<cudaStream_t>(stream)));
}
"""


def _source(csrc: str, src: str, cuts, shims: dict = _SHIMS) -> str | None:
    with open(os.path.join(csrc, src)) as fh:
        text = fh.read()
    for old, new in cuts:
        if old not in text:
            return None
        text = text.replace(old, new, 1)
    if src == "edge_conv.cu" and "cudaError_t vcr_edge_conv_f32knn(" in text:
        text += _F32_SPLIT_SHIM if "cudaError_t vcr_edge_split(" in text else _F32_SHIM
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
    ap.add_argument("--csrc", nargs="+", default=[_build.CSRC_DIR],
                    help="the kernels' source directory; several: the forward and backward "
                         "of each in turns")
    ap.add_argument("--sizes", default=str(N), help="cloud sizes N of the backward, comma-separated")
    ap.add_argument("--rounds", type=int, default=12, help="rounds of turns between several sources")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("edge_conv_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    print(f"card: {smi.strip().splitlines()[0]}; sources {[os.path.abspath(d) for d in args.csrc]}",
          flush=True)
    if len(args.csrc) > 1:
        out = turns(args.csrc, int(args.sizes.split(",")[0]), args.rounds)
        print(json.dumps({"card": smi.strip().splitlines()[0], "sources": args.csrc,
                          "turns": out}), flush=True)
        return 0
    csrc = args.csrc[0]
    jobs = {"edge_conv": ("edge_conv.cu", ()),
            "edge_conv_from_idx": ("edge_conv_from_idx.cu", ())}
    jobs.update({f"edge_conv_bwd_{v}": ("edge_conv_bwd.cu", cuts)
                 for v, cuts in BWD_VARIANTS.items()})
    libs = build(csrc, jobs)

    randn = _randn_on_card()
    out = {}

    def report(name, ms, **extra):
        out[name] = dict(ms=ms, **extra)
        print(f"{name}: {ms} ms {extra if extra else ''}", flush=True)

    # ---- forward: scores and selection against the edge phase alone
    x = randn(B, N, C)
    a, h = randn(B, N, F, scale=0.5), randn(B, N, F, scale=0.5)
    w2, b2 = randn(F, F, scale=F ** -0.5), randn(F, scale=0.1)
    conv, err, x1, idx = forward_call(libs["edge_conv"].shim, x, a, h, w2, b2, "edge_conv")
    report("edge_conv", time_ms(conv), max_abs_err=err)
    report("edge_conv_winners", time_ms(lambda: conv(True)))
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
    f32 = getattr(libs["edge_conv"], "shim_f32", None)
    if f32 is None:
        print("edge_conv_f32: the sources hold no f32 instance; skipped", flush=True)
    else:  # the f32 instance on an f32 space, the same a, h, W2, b2
        xs = randn(B, N, C, dtype=torch.float32)
        conv32, err, _, _ = forward_call(f32, xs, a, h, w2, b2, "edge_conv_f32")
        report("edge_conv_f32", time_ms(conv32), max_abs_err=err)
        report("edge_conv_f32_winners", time_ms(lambda: conv32(True)))
        report("edge_conv_f32_scores_and_selection",
               out["edge_conv_f32"]["ms"] - out["edge_conv_from_idx"]["ms"],
               note="edge_conv_f32 less edge_conv_from_idx")
        split = getattr(libs["edge_conv"], "shim_split", None)
        if split is not None:  # the split pass alone, held to its plain version bit for bit
            planes = torch.empty(3, B, N, C, dtype=torch.bfloat16, device=xs.device)

            def split_call():
                _call(split, xs, planes, B * N * C)

            split_call()
            torch.cuda.synchronize()
            if not torch.equal(planes, edgeconv.split_planes_ref(xs)):
                raise RuntimeError("edge_split through the shim: differs from split_planes_ref")
            report("edge_split", time_ms(split_call))

    # ---- backward at twice the clouds, from the forward's idx and winners
    B2 = 2 * B
    for n in (int(v) for v in args.sizes.split(",")):
        backward(libs, report, randn, B2, n, w2, b2, "" if n == N else f"_N{n}")
    print(json.dumps({"card": smi.strip().splitlines()[0], "sources": csrc,
                      "parts": out}), flush=True)
    return 0


def _randn_on_card(seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    return randn


def forward_call(fn, x, a, h, w2, b2, name):
    """(a call of the ``edge_conv.cu`` shim ``fn`` on these inputs, with
    winners when given True, its max abs error, its x1 and idx): the call is
    held to the plain version on its own idx first (2e-2: one bf16 ulp
    below 4)."""
    dev = torch.device("cuda")
    b, n = x.shape[:2]
    norms = torch.nn.functional.pad(x.float().square().sum(-1), (0, -n % 64), value=float("inf"))
    x1, x2 = torch.empty_like(a), torch.empty_like(a)
    idx = torch.empty(b, n, K, dtype=torch.int32, device=dev)
    win1 = torch.empty(b, n, F, dtype=torch.uint8, device=dev)
    win2 = torch.empty_like(win1)

    def conv(winners=False):
        _call(fn, x, norms, a, h, w2, b2, x1, x2, idx, win1 if winners else None,
              win2 if winners else None, b, n, x.shape[-1], K, 0.0)

    conv()
    torch.cuda.synchronize()
    r1, r2 = edgeconv.fused_edge_conv_ref(x, a, h, w2, b2, K, idx=idx)[:2]
    err = max((x1.float() - r1.float()).abs().max().item(),
              (x2.float() - r2.float()).abs().max().item())
    if err > 2e-2:
        raise RuntimeError(f"{name} through the shim: max abs err {err} > 2e-2")
    return conv, err, x1, idx


def backward_inputs(fwd, randn, B2, n, w2, b2) -> tuple:
    """Seeded inputs of the backward at B2 clouds of n points: (idx, win1,
    win2, a, h, x2, ct1, ct2), idx and winners from ``fwd``, an
    ``edge_conv.cu`` shim."""
    dev = torch.device("cuda")
    x = randn(B2, n, C)
    a, h = randn(B2, n, F, scale=0.5), randn(B2, n, F, scale=0.5)
    # the forward reads whole 64-key tiles: keys past n get an infinite norm
    norms = torch.nn.functional.pad(x.float().square().sum(-1), (0, -n % 64), value=float("inf"))
    x1, x2 = torch.empty_like(a), torch.empty_like(a)
    idx = torch.empty(B2, n, K, dtype=torch.int32, device=dev)
    win1 = torch.empty(B2, n, F, dtype=torch.uint8, device=dev)
    win2 = torch.empty_like(win1)
    _call(fwd, x, norms, a, h, w2, b2, x1, x2, idx, win1, win2, B2, n, C, K, 0.0)
    ct1, ct2 = randn(B2, n, F), randn(B2, n, F)
    return idx, win1, win2, a, h, x2, ct1, ct2


def backward_call(lib, inputs, w2, B2, n):
    """(a call of ``lib``'s backward shim on ``inputs``, its outputs (da,
    dh, dW2, db2), its blocks); da is zeroed once, later calls add into it."""
    dev = torch.device("cuda")
    blocks, floats = ctypes.c_int(0), ctypes.c_longlong(0)
    if lib.shim_grid(ctypes.c_int(B2 * n), ctypes.byref(blocks), ctypes.byref(floats)):
        raise RuntimeError("edge_conv_bwd: grid query failed")
    da = torch.zeros(B2, n, F, device=dev)
    dh = torch.empty_like(da)
    dw2, db2 = torch.empty(F, F, device=dev), torch.empty(F, device=dev)
    partial = torch.empty(floats.value, device=dev)
    idx, win1, win2, a, h, x2, ct1, ct2 = inputs

    def bwd():
        _call(lib.shim, idx, win1, win2, a, h, w2, x2, ct1, ct2, da, dh, dw2, db2, partial,
              blocks.value, B2, n, K, 0.0)

    return bwd, (da, dh, dw2, db2), blocks.value


def check_backward(bwd, outs, inputs, w2, name) -> list:
    """Runs ``bwd`` once into its zeroed da and holds its outputs to the
    plain version (2^-7 relative for da, 1e-4 for dh, dW2, db2)."""
    bwd()
    torch.cuda.synchronize()
    idx, win1, win2, a, h, x2, ct1, ct2 = inputs
    want = edgeconv.edge_conv_bwd_ref(idx, win1, win2, a, h, w2, x2, ct1, ct2)
    errs = [rel_err(gv, wv) for gv, wv in zip(outs, want)]
    if errs[0] > 2 ** -7 or max(errs[1:]) > 1e-4:
        raise RuntimeError(f"{name} through the shim: relative errors {errs}")
    return errs


def turns(dirs, n, rounds) -> dict:
    """Each source directory's forward (edge_conv without and with winners;
    the f32 instance's too where the sources have it) at B clouds and its
    full backward at 2B clouds, of n points, timed in turns over ``rounds``
    rounds in this process: in a round, first the calls every source has,
    source after source, then the others."""
    def build_one(i):
        return build(dirs[i], {"fwd": ("edge_conv.cu", ()), "bwd": ("edge_conv_bwd.cu", ())},
                     build_dir=os.path.join(BUILD_DIR, "turns", str(i)))

    with ThreadPoolExecutor(len(dirs)) as pool:
        libs = list(pool.map(build_one, range(len(dirs))))
    randn = _randn_on_card()
    B2 = 2 * B
    w2, b2 = randn(F, F, scale=F ** -0.5), randn(F, scale=0.1)
    x, xs = randn(B, n, C), randn(B, n, C, dtype=torch.float32)
    a, h = randn(B, n, F, scale=0.5), randn(B, n, F, scale=0.5)
    inputs = backward_inputs(libs[0]["fwd"].shim, randn, B2, n, w2, b2)
    calls = {}  # (call name, source index) -> call
    for i, d in enumerate(dirs):
        conv, err, _, _ = forward_call(libs[i]["fwd"].shim, x, a, h, w2, b2, f"{d} edge_conv")
        calls["edge_conv", i], calls["edge_conv_winners", i] = conv, (lambda c=conv: c(True))
        f32 = getattr(libs[i]["fwd"], "shim_f32", None)
        if f32 is not None:
            conv32, err32, _, _ = forward_call(f32, xs, a, h, w2, b2, f"{d} edge_conv_f32")
            calls["edge_conv_f32", i] = conv32
            calls["edge_conv_f32_winners", i] = lambda c=conv32: c(True)
            err = max(err, err32)
        bwd, outs, _ = backward_call(libs[i]["bwd"], inputs, w2, B2, n)
        print(f"{d}: forward max abs err {err}; backward relative errors "
              f"{check_backward(bwd, outs, inputs, w2, d)}", flush=True)
        calls["edge_conv_bwd", i] = bwd
    # the calls every source has in turns, then those only some have (the f32
    # instance's), so that what runs before a shared call is alike for all
    shared = [name for name, i in calls if i == 0
              and all((name, j) in calls for j in range(len(dirs)))]
    times = {key: [] for key in calls}
    for r in range(rounds):
        order = list(range(len(dirs)))
        order = order[r % len(order):] + order[:r % len(order)]
        order = order[::-1] if r % 2 else order
        for i in order:
            for name in shared:
                times[name, i].append(time_ms(calls[name, i]))
        for i in order:
            for (name, j), call in calls.items():
                if j == i and name not in shared:
                    times[name, i].append(time_ms(call))
    out = {}
    for (name, i), ts in times.items():
        med = statistics.median(ts)
        first = times.get((name, 0))
        vs = med / statistics.median(first) - 1 if first else None
        slower = sum(t > t0 for t, t0 in zip(ts, first)) if first else None
        out.setdefault(dirs[i], {})[name] = dict(median_ms=med, vs_first=vs, rounds_slower=slower,
                                                 ms=ts)
        print(f"{dirs[i]} {name}: median {med} ms"
              + (f" ({100 * vs:+.2f}% against the first), slower in {slower} of {rounds} rounds"
                 if first else "")
              + f"; quartiles {statistics.quantiles(ts, n=4)}", flush=True)
    return out


def backward(libs, report, randn, B2, n, w2, b2, suffix) -> None:
    """Times each build of the backward at B2 clouds of n points (the full
    one held to the plain version first), reported with ``suffix``."""
    inputs = backward_inputs(libs["edge_conv"].shim, randn, B2, n, w2, b2)
    for v in BWD_VARIANTS:
        lib = libs[f"edge_conv_bwd_{v}"]
        if lib is None:
            print(f"edge_conv_bwd_{v}: the sources hold no such part; skipped", flush=True)
            continue
        bwd, outs, blocks = backward_call(lib, inputs, w2, B2, n)
        extra = {}
        if v == "full":
            extra = dict(rel_errs=check_backward(bwd, outs, inputs, w2, f"edge_conv_bwd N={n}"))
        report(f"edge_conv_bwd_{v}{suffix}", time_ms(bwd), blocks=blocks, **extra)


if __name__ == "__main__":
    raise SystemExit(main())
