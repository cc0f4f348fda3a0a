"""Time the CUDA kernels of two checkouts in turns on one card.

Run from the root of a checkout, with another checkout of the repository
(for example the parent commit unpacked with ``git archive``) as argument::

    python3 compare_kernels.py OTHER_ROOT [NAME ...]

It runs ``python3 compare_kernels.py --measure ROOT`` for OTHER_ROOT, this
checkout, this checkout and OTHER_ROOT, in that order; each process imports
``audioforge_tpu_torch`` from its ROOT and builds that checkout's kernels.
The configurations and their inputs are chip_smoke.py phase [2]'s
(``timed_calls``: the serving shapes at fleet 1024, made from fixed seeds,
the same in every process), all of them or those whose label starts with
one of the NAMEs. A time is the card's time per call (chip_smoke.py
``kernel_times``: a CUDA graph of the calls replayed, without the host's
launch cost). It prints the card's name and power limit, each run's times
and, per configuration, both runs of each checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def measure(root: str, names: list[str]) -> dict:
    """Times in ms of the kernels of the checkout at ``root``."""
    import torch

    import chip_smoke as cs  # this checkout's helpers; the package from root

    sys.path.insert(0, str(Path(root).resolve()))
    cs.check(torch.cuda.is_available(), "no CUDA device")
    out = {}
    for label, call, reps, blocks in cs.timed_calls():
        if not names or any(label.startswith(n) for n in names):
            out[label] = cs.kernel_times(call, reps)[0] / blocks
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2], sys.argv[3:])))
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    other, names = str(Path(sys.argv[1]).resolve()), sys.argv[2:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60)
    print(smi.stdout.strip() or "card not measured", flush=True)
    runs = []
    for label, root in (("other", other), ("this", str(HERE)), ("this", str(HERE)),
                        ("other", other)):
        proc = subprocess.run([sys.executable, str(HERE / "compare_kernels.py"),
                               "--measure", root, *names], capture_output=True, text=True,
                              check=False, cwd=root)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append((label, times))
        print(f"{label} ({root}): {json.dumps(times)}", flush=True)
    for name in runs[1][1]:  # a configuration the other checkout lacks shows as []
        med = {lab: sorted(t[name] for lb, t in runs if lb == lab and name in t)
               for lab in ("other", "this")}
        print(f"{name}: other {med['other']} ms, this {med['this']} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
