"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's);
the reference imports nothing of the program."""
import json
import os
import subprocess
import sys
from pathlib import Path

from speechbench import run as harness

ROOT = harness.ROOT
BENCH_MODULES = ["speechbench.run", "speechbench.control", "speechbench.sweep",
                 "speechbench.drivers.stream",
                 "speechbench.drivers.train"]
REFERENCE_MODULES = ["speechbench.reference." + p.stem for p in
                     (ROOT / "speechbench" / "reference").glob("*.py")
                     if p.stem != "__init__"]


def loaded(modules) -> set:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "minimax_speech_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "minimax_speech_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "minimax_speech_tpu.models.llm", sys)
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert {"minimax_speech_tpu", "flax"} <= set(harness.loaded_forbidden())


def test_benchmark_loads_no_jax():
    names = loaded(BENCH_MODULES)
    assert not names & set(harness.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE_MODULES)
    assert not names & (set(harness.FORBIDDEN) | {"minimax_speech_torch"})


def test_result_refused_when_jax_is_loaded(monkeypatch, capsys):
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    ctx = types.SimpleNamespace()
    assert harness.report(ctx, {}) == 5
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_a_tree_with_only_the_benchmark_exits_without_a_result(tmp_path):
    """A directory holding BENCHMARK.json and speechbench/ alone: the run
    exits non-zero and prints nothing on standard output (here for want
    of a card or, on the card, of the program)."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "speechbench", tmp_path / "speechbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "speechbench.run", "--workload",
         "dac.stream-open", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_a_later_addition_needs_no_edit(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric join
    as new files and entries: the harness finds each by its name."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "speechbench", tmp_path / "speechbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "speechbench"
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "cosyvoice2-dac.json").read_text())
    cfg["model"]["flow"]["n_timesteps"] = 5
    (bench / "configs" / "dac-5steps.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "stream-open.json").read_text())
    mix["rate_per_s"] = 0.5
    (bench / "traffic" / "stream-slow.json").write_text(json.dumps(mix))
    (bench / "metrics" / "ticks.stream.py").write_text(
        "def read(rec):\n    return float(len(rec.get('ticks', ())))\n")
    (bench / "limits" / "dac5.stream-slow.json").write_text(
        (bench / "limits" / "dac.stream-open.json").read_text())
    manifest["configs"].append(dict(manifest["configs"][0],
                                    name="dac-5steps",
                                    file="speechbench/configs/dac-5steps.json"))
    manifest["workloads"].append({"name": "dac5.stream-slow",
                                  "config": "dac-5steps",
                                  "traffic": "stream-slow", "chips": 1,
                                  "why": "a later cell"})
    manifest["per_layer"].append({"name": "ticks.stream", "unit": "ticks",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "serving scheduler",
                                  "moves": "stream_rtf_p90",
                                  "workloads": ["dac5.stream-slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = f"""
import json, sys
sys.path.insert(0, {str(tmp_path)!r})
from speechbench import run as h, traffic, checks
m = json.loads((h.ROOT / "BENCHMARK.json").read_text())
cell = h.find(m["workloads"], "dac5.stream-slow", "workload")
entry = h.find(m["configs"], cell["config"], "configuration")
cfg = json.loads((h.ROOT / entry["file"]).read_text())
mix = traffic.load(cell["traffic"])
rec = {{"kind": "stream", "ticks": [(0.0, 1), (1.0, 2)]}}
out = h.per_layer(m, cell, rec)
print(json.dumps([str(h.ROOT), cfg["model"]["flow"]["n_timesteps"],
                  mix["rate_per_s"], out["ticks.stream"]["value"],
                  sorted(checks.load_limits("dac5.stream-slow"))]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    root, steps, rate, ticks, limits = json.loads(out.stdout.splitlines()[-1])
    assert Path(root) == tmp_path
    assert (steps, rate, ticks) == (5, 0.5, 2.0)
    assert limits == sorted(json.loads(
        (bench / "limits" / "dac.stream-open.json").read_text()))
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed
