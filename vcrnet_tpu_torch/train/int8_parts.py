"""What the int8 projection kernel's time is made of on the card.

    python3 -m vcrnet_tpu_torch.train.int8_parts [--csrc DIR [DIR ...]] [--rounds 12]

Compiles ``int8_linear.cu`` from each ``--csrc`` directory (default: this
package's sources; another checkout's ``vcrnet_tpu_torch/csrc`` times that
checkout's kernel) alone with nvcc into a shared library, through a C shim
for the interface the source has: one pair a call with the activations'
codes in device memory (``xq``/``xs`` scratch), or one activation through 1
to 3 pairs with the codes in shared memory. It times them with CUDA events
around ten calls back to back (device time; median of 15) at rows = 65536
(64 pairs of 1024 points), K = F = 512, the 64-pair request's projections,
on seeded random inputs:

* ``one``: one projection; ``qkv``: q, k and v of one input, which is one
  call of three pairs where the source takes pairs and three calls where
  it does not;
* parts, by builds with launches or steps cut from the source text (their
  results are wrong; only their times are read; a cut whose text a source
  does not hold is skipped): for the two-pass source its quantization pass
  alone (``quant_pass``) and its product alone (``product``, on the codes
  a full call left in the scratch); for the source that takes pairs its
  weight pass alone (``weight_pass``), its product kernel alone
  (``product``, on the weight codes a full call left) and the product
  kernel without the quantization of x (``product_no_x_quant``: x is still
  staged, but the codes in shared memory are whatever they were), each at
  one pair and at three;
* the yardsticks: bf16 ``F.linear`` once and three times, ``torch._int_mm``
  on the same codes (the product alone, into int32), and the bounds (bytes
  at 3.35 TB/s against int8 operations at 1,979 TOPS).

Before the timings, for a source whose codes come from ``row_quant`` and
``code`` (the division by Markstein's step), a kernel appended to it checks
every code those functions give against the correctly rounded division
(``__fdiv_rn``, ``__float2int_rn``, the clip) and every row scale, for every
finite bf16 value v under every finite bf16 row maximum a >= |v| (2^31
pairs): the whole domain of the kernel's quantization of x and W. The count
of pairs that differ is printed and must be 0; so is the count of row maxima
whose reciprocal of the scale differs from ``__frcp_rn``'s. The full builds are held to
the plain version bit for bit, so that a wrong call through the shim cannot
pass for a time. The calls run in turns
within one process: ``--rounds`` rounds, each timing every source's
``one`` and ``qkv`` (in an order that rotates and reverses from round to
round), then every source's parts, then the yardsticks; then each call's
median over the rounds against the first source's and the rounds in which
it was slower. Prints the card's ``nvidia-smi`` name and power limit first,
one line a call, and last one JSON object of them all. Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from vcrnet_tpu_torch.ops import _build
from vcrnet_tpu_torch.ops.int8_linear import int8_linear_ref, quantize_rows_ref
from vcrnet_tpu_torch.train.edge_conv_parts import _call, build

ROWS, K, F = 65536, 512, 512
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8
BUILD_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "int8_parts")

# the interface of a source, told by its entry point's first parameters
_TWO_PASS = "cudaError_t vcr_int8_linear(const void* x, const void* w, const void* bias, void* xq"
_PAIRS = "cudaError_t vcr_int8_linear(const void* x, int rows, int k, int pairs"

_SHIMS = {
    _TWO_PASS: """
extern "C" int shim(const void* x, const void* w, const void* bias, void* xq, float* xs, void* wq,
                    float* ws, void* out, int rows, int k, int f, void* stream) {
  return static_cast<int>(vcr_int8_linear(x, w, bias, xq, xs, wq, ws, out, rows, k, f,
                                          static_cast<cudaStream_t>(stream)));
}
""",
    _PAIRS: """
extern "C" int shim(const void* x, const void* w0, const void* w1, const void* w2,
                    const void* b0, const void* b1, const void* b2, void* o0, void* o1, void* o2,
                    void* wq, float* ws, float* xs, int rows, int k, int pairs, int f,
                    void* stream) {
  const void* w[3] = {w0, w1, w2};
  const void* b[3] = {b0, b1, b2};
  void* o[3] = {o0, o1, o2};
  const int fs[3] = {f, f, f};
  return static_cast<int>(vcr_int8_linear(x, rows, k, pairs, w, b, o, fs, wq, ws, xs,
                                          static_cast<cudaStream_t>(stream)));
}
""",
}

# every bf16 v under every bf16 row maximum a (blockIdx.y: a's bits, a grid
# of 256 blocks of 256 threads: v's bits): the source's codes and scale
# against the correctly rounded division
_CODES_CHECK = """
namespace vcr {
namespace quant {
namespace {
__global__ void codes_check_kernel(unsigned long long* counts) {
  const uint32_t v_bits = blockIdx.x * blockDim.x + threadIdx.x;
  const float a = __uint_as_float(blockIdx.y << 16), v = __uint_as_float(v_bits << 16);
  if (!(fabsf(v) <= a)) return;
  const RowQuant q = row_quant(a);
  const float s = __fdiv_rn(fmaxf(a, 1e-30f), 127.f);
  const int want = min(max(__float2int_rn(__fdiv_rn(v, s)), -127), 127);
  const int got = static_cast<int8_t>(code(v, q) & 0xffu);
  if (got != want || __float_as_uint(q.s) != __float_as_uint(s)) atomicAdd(&counts[0], 1ull);
  if (v_bits == 0 && __float_as_uint(q.inv) != __float_as_uint(__frcp_rn(s)))
    atomicAdd(&counts[1], 1ull);  // once a row maximum: its reciprocal
}
}  // namespace
}  // namespace quant
}  // namespace vcr

extern "C" int codes_check(unsigned long long* counts, void* stream) {
  vcr::quant::codes_check_kernel<<<dim3(256, 0x7F80), 256, 0,
                                   static_cast<cudaStream_t>(stream)>>>(counts);
  return static_cast<int>(cudaGetLastError());
}
"""

# cuts: (text in the source, its replacement)
_TWO_PASS_CUTS = {
    "quant_pass": (("  namespace gemm = vcr::gemm90;",
                    "  return cudaSuccess;\n  namespace gemm = vcr::gemm90;"),),
    "product": (("  quantize_kernel<<<", "  if (false) quantize_kernel<<<"),),
}
_PAIRS_CUTS = {
    "weight_pass": (("  err = vcr::hopper::make_box_map_s8(",
                     "  return cudaSuccess;\n  err = vcr::hopper::make_box_map_s8("),),
    "product": (("  quantize_weights_kernel<<<", "  if (false) quantize_weights_kernel<<<"),),
    "product_no_x_quant": (("  quantize_weights_kernel<<<",
                            "  if (false) quantize_weights_kernel<<<"),
                           ("      for (int r0 = qw * T::kQRows; r0 < T::kXRows;",
                            "      for (int r0 = qw * T::kQRows; r0 < 0;")),
}


def time_ms(fn, reps: int = 15, inner: int = 10, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``inner`` calls back to
    back (so the host's launch overhead hides behind the device's work), the
    median of ``reps`` such runs over ``inner``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def codes_check(csrc: str) -> dict | None:
    """Every code and row scale of the source's quantization against the
    correctly rounded division, over every finite bf16 v and row maximum a
    >= |v|, and each row maximum's reciprocal of its scale against
    ``__frcp_rn``: {"pairs": checked, "differ": count, "row_maxima": checked,
    "reciprocals_differ": count}, or None for a source without
    ``row_quant``."""
    with open(os.path.join(csrc, "int8_linear.cu")) as fh:
        if "RowQuant row_quant(float amax)" not in fh.read():
            return None
    lib = build(csrc, {"codes": ("int8_linear.cu", ())}, shims={"int8_linear.cu": _CODES_CHECK},
                build_dir=os.path.join(BUILD_DIR, "codes"))["codes"]
    counts = torch.zeros(2, dtype=torch.int64, device="cuda")
    _call(lib.codes_check, counts)
    torch.cuda.synchronize()
    differ, inv_differ = counts.tolist()
    # the pairs the kernel checks: finite bf16 a >= 0 (bits below 0x7F80), v with |v| <= a
    bits = torch.arange(1 << 16, dtype=torch.int32)
    values = (bits << 16).view(torch.float32)
    mags = values.abs()[~values.isnan()].sort().values
    a = values[: 0x7F80]
    pairs = int(torch.searchsorted(mags, a, right=True).sum())
    return {"pairs": pairs, "differ": differ, "row_maxima": 0x7F80,
            "reciprocals_differ": inv_differ}


class Source:
    """One source directory's kernel: its builds and its calls on the
    shared inputs, each with its own outputs and scratch."""

    def __init__(self, csrc: str, index: int):
        with open(os.path.join(csrc, "int8_linear.cu")) as fh:
            text = fh.read()
        self.csrc = csrc
        self.pairs = _PAIRS in text
        if not self.pairs and _TWO_PASS not in text:
            raise SystemExit(f"{csrc}/int8_linear.cu: an interface this script does not know")
        cuts = _PAIRS_CUTS if self.pairs else _TWO_PASS_CUTS
        jobs = {"full": ("int8_linear.cu", ()),
                **{name: ("int8_linear.cu", c) for name, c in cuts.items()}}
        shim = _SHIMS[_PAIRS if self.pairs else _TWO_PASS]
        self.libs = build(csrc, jobs, shims={"int8_linear.cu": shim},
                          build_dir=os.path.join(BUILD_DIR, str(index)))

    def calls(self, x, pairs) -> dict:
        """{name: call} of this source on x and ``pairs``, the full calls
        held to the plain version first."""
        dev = x.device
        rows, k = x.shape
        f = pairs[0][0].shape[0]
        outs = [torch.empty(rows, f, dtype=torch.bfloat16, device=dev) for _ in pairs]
        wq = torch.empty(len(pairs) * f, k, dtype=torch.int8, device=dev)
        ws = torch.empty(len(pairs) * f, device=dev)
        xq = torch.empty(rows, k, dtype=torch.int8, device=dev)
        xs = torch.empty(rows, device=dev)

        def call(lib, n):
            fn = lib.shim
            if self.pairs:
                ws3 = [w for w, _ in pairs[:n]] + [None] * (3 - n)
                bs3 = [b for _, b in pairs[:n]] + [None] * (3 - n)
                os3 = outs[:n] + [None] * (3 - n)
                return lambda: _call(fn, x, *ws3, *bs3, *os3, wq, ws, None, rows, k, n, f)

            def each():  # one pair a call, the codes through the scratch
                for (w, b), out in zip(pairs[:n], outs):
                    _call(fn, x, w, b, xq, xs, wq, ws, out, rows, k, f)
            return each

        full = self.libs["full"]
        found = {"one": call(full, 1), "qkv": call(full, 3)}
        for name, n in (("one", 1), ("qkv", 3)):
            for o in outs:
                o.zero_()
            found[name]()
            torch.cuda.synchronize()
            for i, (w, b) in enumerate(pairs[:n]):
                if not torch.equal(outs[i], int8_linear_ref(x, w, b)):
                    raise RuntimeError(f"{self.csrc}: {name} through the shim differs from the "
                                       f"plain version (pair {i})")
        for name, lib in self.libs.items():
            if name == "full":
                continue
            if lib is None:
                print(f"{self.csrc}: no cut {name} in this source; skipped", flush=True)
                continue
            found[f"{name}_one"] = call(lib, 1)
            if self.pairs:
                found[f"{name}_qkv"] = call(lib, 3)
        return found


def yardsticks(x, pairs) -> dict:
    """The library's calls on the same inputs: bf16 F.linear once and three
    times, torch._int_mm on the codes of x and of the first weight (checked
    against the exact product)."""
    import torch.nn.functional as F

    (w, b) = pairs[0]
    xq, wq = quantize_rows_ref(x)[0], quantize_rows_ref(w)[0]
    acc = torch._int_mm(xq, wq.t())
    if not torch.equal(acc.double(), torch.matmul(xq.double(), wq.double().t())):
        raise RuntimeError("torch._int_mm differs from the exact product")
    return {"bf16_linear_one": lambda: F.linear(x, w, b),
            "bf16_linear_qkv": lambda: [F.linear(x, w_, b_) for w_, b_ in pairs],
            "int_mm_one": lambda: torch._int_mm(xq, wq.t())}


def bounds(x, pairs) -> dict:
    """The least times of one projection and of q, k and v, in ms: the
    larger of the bytes (x, the weights and biases read once, the outputs
    written once) over the memory rate and the int8 operations over the
    peak."""
    rows, k = x.shape
    f = pairs[0][0].shape[0]
    out = {}
    for name, n in (("one", 1), ("qkv", 3)):
        moved = x.numel() * 2 + n * (f * k + f) * 2 + n * rows * f * 2
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = n * 2.0 * rows * f * k / INT8_OPS_PER_S * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops), "bytes_ms": t_bytes, "operations_ms": t_ops,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return out


def turns(sources, x, pairs, rounds: int) -> dict:
    calls = {}  # (call name, source index or -1 for the yardsticks) -> call
    for i, src in enumerate(sources):
        for name, call in src.calls(x, pairs).items():
            calls[name, i] = call
    for name, call in yardsticks(x, pairs).items():
        calls[name, -1] = call
    shared = ("one", "qkv")
    times = {key: [] for key in calls}
    for r in range(rounds):
        order = list(range(len(sources)))
        order = order[r % len(order):] + order[:r % len(order)]
        order = order[::-1] if r % 2 else order
        for i in order:
            for name in shared:
                times[name, i].append(time_ms(calls[name, i]))
        for i in order:
            for (name, j), call in calls.items():
                if j == i and name not in shared:
                    times[name, i].append(time_ms(call))
        for (name, j), call in calls.items():
            if j == -1:
                times[name, j].append(time_ms(call))
    out = {}
    for (name, i), ts in times.items():
        med = statistics.median(ts)
        first = times.get((name, 0)) if i > 0 else None
        where = sources[i].csrc if i >= 0 else "library"
        entry = dict(median_ms=med, ms=ts)
        line = f"{where} {name}: median {med} ms; quartiles {statistics.quantiles(ts, n=4)}"
        if first:
            entry["vs_first"] = med / statistics.median(first) - 1
            entry["rounds_slower"] = sum(t > t0 for t, t0 in zip(ts, first))
            line += (f"; {100 * entry['vs_first']:+.2f}% against the first source, slower in "
                     f"{entry['rounds_slower']} of {rounds} rounds")
        out.setdefault(where, {})[name] = entry
        print(line, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", nargs="+", default=[_build.CSRC_DIR],
                    help="the kernels' source directories, timed in turns")
    ap.add_argument("--rounds", type=int, default=12, help="rounds of turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_parts: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(f"card: {card}; sources {[os.path.abspath(d) for d in args.csrc]}", flush=True)
    with ThreadPoolExecutor(len(args.csrc)) as pool:
        sources = list(pool.map(lambda a: Source(*a), [(d, i) for i, d in enumerate(args.csrc)]))
    g = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(ROWS, K, generator=g, device="cuda").to(torch.bfloat16)
    pairs = [((torch.randn(F, K, generator=g, device="cuda") / K ** 0.5).to(torch.bfloat16),
              torch.randn(F, generator=g, device="cuda").to(torch.bfloat16)) for _ in range(3)]
    codes = {d: codes_check(d) for d in args.csrc}
    print(f"codes of every bf16 value under every bf16 row maximum against the correctly "
          f"rounded division: {codes}", flush=True)
    if any(c and c["differ"] for c in codes.values()):
        raise SystemExit("int8_parts: a source's codes differ from the division's")
    bound = bounds(x, pairs)
    print(f"bounds at rows={ROWS} K={K} F={F}: {bound}", flush=True)
    out = turns(sources, x, pairs, args.rounds)
    print(json.dumps({"card": card, "rows": ROWS, "k": K, "f": F, "bounds": bound, "codes": codes,
                      "sources": args.csrc, "turns": out}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
