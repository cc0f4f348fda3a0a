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

``python3 compare_kernels.py OTHER_ROOT --replays`` runs six processes in
turns (OTHER_ROOT, this, OTHER_ROOT, this, this, OTHER_ROOT), each timing two
replays on its checkout's package: chip_smoke.py's VAD-on serving path at fleet 1024
([8], ``phase_model_path`` with REPLAY_TIMED_CALLS timed calls; its graph's
replay alone) and the live engine's VAD worker (``vad_window_times``: its
window graph's replay alone, host ms a window). A replay's time can differ
between processes of one tree, hence six processes.

``python3 compare_kernels.py --sass FUNCTION ...`` builds this checkout's
kernels and prints the SASS (``cuobjdump -sass``) of every kernel function
whose name contains one of the FUNCTIONs, for reading a loop's dependency
chain or checking that a kernel's loads go out together.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPLAY_TIMED_CALLS = 50


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


def measure_replays(root: str) -> dict:
    """The replays' times in ms on the package of the checkout at ``root``."""
    import chip_smoke as cs  # this checkout's helpers; the package from root

    sys.path.insert(0, str(Path(root).resolve()))
    card = cs.phase0_device()
    cs.phase1_build()
    cs.MODEL_TIMED_CALLS = REPLAY_TIMED_CALLS
    cs.phase_model_path(card, "VAD-on", "[8]")
    window_ms, call_ms = cs.vad_window_times()
    return {"VAD-on replay": cs.REPLAY_MS["[8]"], "VAD window replay": window_ms,
            "VAD window host": call_ms}


def sass(names: list[str]) -> str:
    """The SASS of this checkout's kernel functions whose names contain one
    of ``names``."""
    from audioforge_tpu_torch import kernels

    lib = kernels.build()
    tool = Path(kernels._find_nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    parts = re.split(r"\n\s*Function : ", dump)
    return "".join(f"Function : {p}" for p in parts[1:]
                   if any(n in p.splitlines()[0] for n in names))


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--sass":
        print(sass(sys.argv[2:]))
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2], sys.argv[3:])))
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--measure-replays":
        print(json.dumps(measure_replays(sys.argv[2])))
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    other, names = str(Path(sys.argv[1]).resolve()), sys.argv[2:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60)
    print(smi.stdout.strip() or "card not measured", flush=True)
    this = str(HERE)
    if names == ["--replays"]:
        mode, names, turns = "--measure-replays", [], (other, this, other, this, this, other)
    else:
        mode, turns = "--measure", (other, this, this, other)
    runs = []
    for root in turns:
        label = "this" if root == this else "other"
        proc = subprocess.run([sys.executable, str(HERE / "compare_kernels.py"), mode, root,
                               *names], capture_output=True, text=True, check=False, cwd=root)
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
