"""fsck for sharded checkpoint directories.

The counterpart of ``apex_tpu/checkpoint/verify.py``: ``python -m
apex_tpu_torch.checkpoint verify <dir>`` walks every step directory under
``<dir>`` and classifies it, with the same statuses, problem strings and
exit codes as the JAX package's CLI (the format is shared):

- **ok** — committed (COMMIT marker present), manifest hashes to the
  sha256 the marker pinned, every shard file present with the manifested
  byte size and (``deep``, the default) sha256. These are the *adoptable*
  steps: ``restore_latest`` on this directory will succeed from the
  newest of them.
- **damaged** — committed but failing any of those checks (bit rot, torn
  manifest, missing/truncated shard). A damaged step makes the exit code
  non-zero: the step *claims* to be restorable and is not.
- **uncommitted** — no readable COMMIT marker. Listed informationally
  (it is debris from an interrupted save, invisible to restore) and does
  NOT affect the exit code; ``--gc`` deletes it.

Pure stdlib (shares :mod:`apex_tpu_torch.checkpoint.manifest`), so it
runs on any machine that can see the filesystem — no accelerator.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

from apex_tpu_torch.checkpoint.manifest import (
    list_step_dirs,
    read_commit,
    validate_step_dir,
)

__all__ = ["StepReport", "verify_directory", "format_report", "main"]


class StepReport:
    """Verification outcome for one step directory."""

    __slots__ = ("step", "dirname", "status", "problems")

    def __init__(self, step: int, dirname: str, status: str,
                 problems: List[str]):
        self.step = step
        self.dirname = dirname
        self.status = status  # "ok" | "damaged" | "uncommitted"
        self.problems = problems

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"StepReport(step={self.step}, status={self.status!r}, "
                f"problems={self.problems!r})")


def verify_directory(root: str, *, deep: bool = True) -> List[StepReport]:
    """Validate every step directory under ``root``; reports sorted by
    step. An empty / nonexistent ``root`` yields an empty list (nothing
    claimed, nothing damaged)."""
    reports: List[StepReport] = []
    for step, dirname in sorted(list_step_dirs(root).items()):
        step_dir = os.path.join(root, dirname)
        if read_commit(step_dir) is None:
            reports.append(StepReport(step, dirname, "uncommitted", []))
            continue
        problems = validate_step_dir(step_dir, deep=deep)
        reports.append(StepReport(
            step, dirname, "damaged" if problems else "ok", problems))
    return reports


def format_report(root: str, reports: List[StepReport]) -> str:
    lines = [f"checkpoint directory: {os.path.abspath(root)}"]
    if not reports:
        lines.append("  (no step directories)")
    for r in reports:
        lines.append(f"  step {r.step:>8}  {r.status}")
        for p in r.problems:
            lines.append(f"    - {p}")
    adoptable = [r.step for r in reports if r.status == "ok"]
    damaged = [r.step for r in reports if r.status == "damaged"]
    uncommitted = [r.step for r in reports if r.status == "uncommitted"]
    lines.append(f"adoptable steps: {adoptable or 'none'}")
    if damaged:
        lines.append(f"DAMAGED steps:   {damaged}")
    if uncommitted:
        lines.append(f"uncommitted (debris, ignored by restore): "
                     f"{uncommitted}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.checkpoint",
        description="Offline integrity checks for sharded checkpoints.")
    sub = parser.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser(
        "verify", help="fsck a checkpoint directory: validate manifests "
        "and shard checksums across all steps")
    v.add_argument("directory", help="checkpoint root (parent of the "
                   "per-step directories)")
    v.add_argument("--shallow", action="store_true",
                   help="skip per-shard sha256 re-hash (presence + byte "
                   "size only)")
    v.add_argument("--gc", action="store_true",
                   help="delete uncommitted debris directories")
    args = parser.parse_args(argv)

    reports = verify_directory(args.directory, deep=not args.shallow)
    print(format_report(args.directory, reports))
    if args.gc:
        for r in reports:
            if r.status == "uncommitted":
                shutil.rmtree(os.path.join(args.directory, r.dirname),
                              ignore_errors=True)
                print(f"gc: removed uncommitted step {r.step}")
    return 1 if any(r.status == "damaged" for r in reports) else 0
