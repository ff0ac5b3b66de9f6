"""Step time of ``chip_smoke.py``'s training phases, two checkouts in turns.

Usage (on a machine with a CUDA device)::

    python3 apex_tpu_torch/tools/step_pairs.py --base DIR --change DIR
        [--phases train,rn50_train] [--pairs 10] [--tag NAME] [--out FILE]

Each run is a fresh process that imports one checkout's ``chip_smoke.py``
(and so its ``apex_tpu_torch``, built into that checkout's ``build/``)
and runs one phase: 2 warm-up and 8 timed steps on one seeded batch,
checked as ``chip_smoke.py`` checks them (TF32 off, as its ``main``
sets). The phase's ``step_ms_median`` (host clock around a step ending in
a synchronise) is read from its line. Pair ``i`` runs the base first when
``i`` is even and the change first when it is odd. One JSON row a run,
then a summary row a phase: each side's median of the run medians, the
base's spread (the distance between its runs' quartiles) and the pairs
the change won. Two checkouts: unpack each with ``git archive`` into a
directory ``.gitignore`` lists.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

_RUN = """
import sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
chip_smoke.phase_build()
chip_smoke.phase_{phase}()
"""


def run_phase(root: Path, phase: str) -> tuple:
    """``(median step ms, the phase's [optimizer] line or None)`` of a
    fresh process of ``root``."""
    out = subprocess.run(
        [sys.executable, "-c", _RUN.format(root=str(root), phase=phase)],
        cwd=root, capture_output=True, text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"{root} {phase} failed:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-4000:]}")
    lines = out.stdout.splitlines()
    line = next(x for x in lines if x.startswith(f"[{phase}] "))
    opt = next((x for x in lines if x.startswith("[optimizer] ")), None)
    return float(re.search(r"step_ms_median=([0-9.]+)", line).group(1)), opt


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--base", required=True)
    parser.add_argument("--change", required=True)
    parser.add_argument("--phases", default="train,rn50_train")
    parser.add_argument("--pairs", type=int, default=10)
    parser.add_argument("--tag", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    roots = {"base": Path(args.base).resolve(),
             "change": Path(args.change).resolve()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]

    def emit(**fields):
        row = json.dumps(dict(tag=args.tag, card=card, **fields))
        print(row, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(row + "\n")

    for root in roots.values():      # build each checkout once, up front
        subprocess.run([sys.executable, "-c",
                        "from apex_tpu_torch.ops import _build; "
                        "_build.library()"], cwd=root, check=True,
                       timeout=900)
    for phase in args.phases.split(","):
        times = {"base": [], "change": []}
        for i in range(args.pairs):
            order = ("base", "change") if i % 2 == 0 else ("change", "base")
            for side in order:
                ms, opt = run_phase(roots[side], phase)
                times[side].append(ms)
                emit(phase=phase, pair=i, side=side, first=order[0],
                     step_ms_median=ms, optimizer=opt)
        q = statistics.quantiles(times["base"], n=4)
        wins = sum(c < b for b, c in zip(times["base"], times["change"]))
        emit(phase=phase, summary=True,
             base_median=statistics.median(times["base"]),
             change_median=statistics.median(times["change"]),
             base_spread=q[2] - q[0], change_wins=wins, pairs=args.pairs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
