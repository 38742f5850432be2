"""Request latency of the Registrar for one or more checkouts of the port, in turns.

    python3 -m vcrnet_tpu_torch.train.serve_latency [--tree DIR ...] [--rounds R] [--reps N]

Each tree (a checkout of the repository; default: this one) is timed in a
process of its own, started in that tree with the tree first on
``sys.path``, so that it imports that tree's ``vcrnet_tpu_torch`` and builds
that tree's kernels into its own ``build/``: the committed checkpoint (this
checkout's copy, read by each tree's own reader) served through
``Registrar`` at full width, bf16, N = 1024, at iter=1 and iter=3, requests of 1, 8 and 64 pairs of the synthetic shapes eval set
(chip_smoke.py's serve and refine requests), each request once as a
warm-up and then the median of ``--reps`` host-clock timings of
``register`` (which returns host numpy). The trees run in turns, in the
order given and then reversed (A B B A for two trees), ``--rounds`` times,
so that a drift of the host over the call falls on both. Prints the card's
``nvidia-smi`` name and power limit first, one JSON line a process, and
last one JSON object: each tree's medians, one per turn, by iter and
request size. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHECKPOINT = os.path.join(ROOT, "checkpoints", "pretrained", "vcrnet_shapes_best.msgpack")

CHILD = r'''
import json, os, statistics, sys, time

tree, reps, checkpoint = os.path.abspath(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, tree)
import torch

torch.backends.cuda.matmul.allow_tf32 = False
import vcrnet_tpu_torch
from vcrnet_tpu_torch.config import Config
from vcrnet_tpu_torch.data.synthetic import shapes_eval_set
from vcrnet_tpu_torch.serve import Registrar
from vcrnet_tpu_torch.utils.params import load_checkpoint

if not vcrnet_tpu_torch.__file__.startswith(tree + os.sep):
    raise SystemExit(f"imported {vcrnet_tpu_torch.__file__}, not the tree {tree}")
state_dict = load_checkpoint(checkpoint)
data = shapes_eval_set(73, num_points=1024)
bounds = (0, 1, 9, 73)
requests = [(data["src"][a:b], data["tgt"][a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
out = {"tree": tree}
for n_iter in (1, 3):
    reg = Registrar(Config(compute_dtype="bfloat16", iter=n_iter, num_points=1024), state_dict)
    for src, tgt in requests:  # warm-up: the kernels' build, library handles, allocator
        reg.register(src, tgt)
    medians = {}
    for src, tgt in requests:
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            reg.register(src, tgt)
            runs.append((time.perf_counter() - t0) * 1e3)
        medians[len(src)] = statistics.median(runs)
    out[f"iter{n_iter}"] = medians
print(json.dumps(out))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", help="a checkout of the repository (repeatable)")
    ap.add_argument("--rounds", type=int, default=1, help="turns of the trees, each there and back")
    ap.add_argument("--reps", type=int, default=7, help="timings of each request a turn")
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.tree or [ROOT]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    turns = {tree: [] for tree in trees}
    for _ in range(args.rounds):
        for tree in trees + trees[::-1]:
            r = subprocess.run([sys.executable, "-c", CHILD, tree, str(args.reps), CHECKPOINT],
                               cwd=tree, capture_output=True, text=True, timeout=1800)
            if r.returncode:
                raise SystemExit(f"{tree} failed:\n{r.stdout}\n{r.stderr}")
            line = r.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            turns[tree].append(json.loads(line))
    summary = {tree: {key: {size: [t[key][size] for t in runs] for size in runs[0][key]}
                      for key in ("iter1", "iter3")} for tree, runs in turns.items()}
    print(json.dumps({"card": card, "latency_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
