"""Whether two source trees compile a kernel source to the same instructions.

    python3 -m vcrnet_tpu_torch.train.sass_diff OLD_CSRC NEW_CSRC [SOURCE ...]

Compiles each SOURCE (default ``pointer_mha.cu``) from both directories
with nvcc to a cubin (``sm_90a``, the extension's flags) in parallel,
disassembles both with ``cuobjdump -sass`` and compares them kernel by
kernel (kernels matched by name, without the translation unit's hash and
the template arguments): one line a kernel with both instruction counts
and whether the two sequences are equal, and the first differences where
they are not. A change meant to leave a kernel's code alone (a header
shared with another kernel, a template over an epilogue) is held by this:
the card's timings of the same code move by several per cent from call to
call, its instructions do not. Exits 1 when a kernel differs or is in one
build only. Needs nvcc and cuobjdump; no card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

from vcrnet_tpu_torch.ops import _build


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    return os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", name)


def kernels(cubin: str) -> dict:
    """{kernel name: [instructions]} of a cubin's SASS, without addresses."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True, text=True,
                         check=True).stdout
    found, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            k = re.search(r"\d([a-z][a-z_]*_kernel)", m.group(1))
            name = k.group(1) if k else m.group(1)
            found[name] = []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            found[name].append(m.group(1))
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", help="the first source directory")
    ap.add_argument("new", help="the second source directory")
    ap.add_argument("sources", nargs="*", default=["pointer_mha.cu"])
    args = ap.parse_args(argv)
    same = True
    with tempfile.TemporaryDirectory() as tmp:
        def compile_one(job):
            tag, csrc, src = job
            cubin = os.path.join(tmp, f"{tag}_{src}.cubin")
            subprocess.run([_tool("nvcc"), "-cubin", *_build.CUDA_FLAGS, "-o", cubin,
                            os.path.join(csrc, src)], check=True, timeout=900)
            return job, cubin

        jobs = [(tag, csrc, src) for src in args.sources
                for tag, csrc in (("old", args.old), ("new", args.new))]
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = dict(pool.map(compile_one, jobs))
        for src in args.sources:
            a = kernels(built[("old", args.old, src)])
            b = kernels(built[("new", args.new, src)])
            for name in sorted(set(a) | set(b)):
                if name not in a or name not in b:
                    print(f"{src} {name}: in the {'new' if name in b else 'old'} build only")
                    same = False
                    continue
                equal = a[name] == b[name]
                same &= equal
                print(f"{src} {name}: {len(a[name])} / {len(b[name])} instructions, "
                      f"identical: {equal}")
                if not equal:
                    diff = [(i, x, y) for i, (x, y) in enumerate(zip(a[name], b[name])) if x != y]
                    print("  first differences:", diff[:3])
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
