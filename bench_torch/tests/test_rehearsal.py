"""CPU rehearsal of the benchmark: the file's rules, the data-driven
harness, the result line, and what a run imports. Run from the root of
the repository:

    python -m pytest bench_torch/tests -q -p no:cacheprovider
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# a tiny cell for the CPU: 8 streams, calls of 3 blocks, 2 probes of 3 blocks
TINY = {"fleet": 8, "mix": {"call_blocks": 3, "pool_streams": 8, "pool_seconds": 0.5,
                            "tick_ms": 2000.0, "probe_latest": 0.1},
        "check": {"probes": 2, "blocks": 3}}


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])


def test_every_per_layer_metric_cell_reports_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_files_under_paths_name_every_config_and_mix():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert (ROOT / "bench_torch" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "bench_torch" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def _run_cpu(code: str, cwd: Path, pythonpath: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=900, env={"PYTHONPATH": pythonpath,
                                                       "PATH": "/usr/bin:/bin"})


DRIVE = """
import json, sys, time
t0 = time.perf_counter()
import torch
torch.set_num_threads(2)
from bench_torch import harness
bench = json.loads(open("BENCHMARK.json").read())
cell = harness.find_cell(bench, {cell!r})
r = harness.run_cell(bench, cell, 2**31 + 11, {seconds}, {trace}, t0, device="cpu",
                     sizes={sizes!r})
harness.print_result(r)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "audioforge_tpu.")))
print(json.dumps({{"imported": bad}}))
"""


def _last_lines(proc) -> tuple:
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_exactly_the_contract_keys(trace):
    proc = _run_cpu(DRIVE.format(cell="default_dfn3_ll.batch", seconds=3.0, trace=trace,
                                 sizes=TINY), ROOT, str(ROOT))
    result, modules = _last_lines(proc)
    keys = ["correct", "attempted", "failed", "metrics", "device", "check"]
    # the trace of a CPU run holds no device work, so no breakdown here
    assert list(result) == keys
    assert result["correct"] is True and result["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    want = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
            if "default_dfn3_ll.batch" in m.get("workloads", ["default_dfn3_ll.batch"])}
    got = set(result["metrics"])
    # the device's readers find nothing to read on the CPU and report nothing
    assert got <= want and (trace or got == want)
    assert modules["imported"] == []
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


def test_a_config_a_mix_a_metric_and_a_cell_added_as_new_files(tmp_path):
    shutil.copytree(ROOT / "bench_torch", tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "plain_chain", "source": "https://example.org",
                             "file": "bench_torch/configs/plain_chain.json", "reduced": [],
                             "why": "the default chain with no suppressor"})
    bench["workloads"].append({"name": "plain_chain.slow", "config": "plain_chain",
                               "traffic": "slow", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "blocks_run", "unit": "blocks", "better": "higher",
                               "source": "program_counter", "layer": "engine host",
                               "moves": "setup_s", "workloads": ["plain_chain.slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = tmp_path / "bench_torch"
    (b / "configs" / "plain_chain.json").write_text(json.dumps({
        "name": "plain_chain", "serving": {"suppressor_model": None}, "chain": {},
        "archives": {}, "check": {"probes": 1, "blocks": 2,
                                  "limits": {"probe_max_abs_err": 1e-4}}}))
    mix = json.loads((b / "traffic" / "batch.json").read_text())
    (b / "traffic" / "slow.json").write_text(json.dumps(dict(mix, call_blocks=2)))
    (b / "metrics" / "blocks_run.py").write_text("def read(run):\n    return run['blocks']\n")
    sizes = {"fleet": 4, "mix": {"pool_streams": 4, "pool_seconds": 0.5, "probe_latest": 0.1}}
    for trace in (False, True):
        proc = _run_cpu(DRIVE.format(cell="plain_chain.slow", seconds=2.0, trace=trace,
                                     sizes=sizes), tmp_path, f"{tmp_path}:{ROOT}")
        result, _ = _last_lines(proc)
        assert result["correct"] is True
        assert set(result["metrics"]) == ({"blocks_run"} if trace else {"setup_s"})


def test_run_exits_nonzero_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    proc = subprocess.run([sys.executable, "bench_torch/run.py", "--workload",
                           "full_rnnoise_vad.batch", "--seed", str(2**31 + 5), "--seconds",
                           "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_run_exits_nonzero_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(ROOT / "bench_torch", tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "bench_torch/run.py", "--workload",
                           "default_dfn3_ll.batch", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and not proc.stdout.strip()
