"""BENCHMARK.json against its format: names, units, keys and bounds; the pieces of
a cell found by name from files alone; the trace reduction; the import check."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from gbbench import registry, run, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = registry.benchmark()


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_names_and_units():
    names = list(_names())
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = [e["name"] for e in BENCH[key]]
        assert len(entries) == len(set(entries)), key
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_keys_and_bounds():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        _, _, _, per_layer, reports = registry.cell(w["name"])
        names = {m["name"] for m in reports}
        assert "setup_s" in names and len(names) >= 2 and per_layer
        assert all(m["moves"] in names for m in per_layer), w["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_piece_is_a_file():
    for c in BENCH["configs"]:
        assert c["file"] == f"gbbench/configs/{c['name']}.json"
        assert registry.config(c["name"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        entry, cfg, traffic, per_layer, e2e = registry.cell(w["name"])
        assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
        assert registry.algorithm(traffic["algorithm"]).build and registry.reference(traffic["algorithm"]).check
        assert set(traffic["limits"]) and per_layer and {m["name"] for m in e2e} >= {"setup_s"}
    for m in BENCH["per_layer"]:
        assert registry.metric(m["name"]).read(run.Readings({})) is None


def test_found_by_name_from_files_alone(tmp_path, monkeypatch):
    """A new configuration, traffic mix and metric are new files and new
    entries of BENCHMARK.json: the harness finds them without an edit."""
    here = tmp_path / "gbbench"
    shutil.copytree(registry.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((here / "configs" / "gap-urand21.json").read_text())
    (here / "configs" / "gap-urand20.json").write_text(json.dumps(dict(cfg, name="gap-urand20", scale=20)))
    mix = json.loads((here / "traffic" / "pagerank.json").read_text())
    (here / "traffic" / "pagerank-tight.json").write_text(json.dumps(dict(mix, name="pagerank-tight")))
    (here / "metrics" / "trials.seen.py").write_text("def read(r):\n    return 42.0\n")
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "urand20.pagerank-tight", "config": "gap-urand20", "traffic": "pagerank-tight", "chips": 1, "why": "x"}
    ]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "trials.seen", "unit": "1", "better": "higher", "source": "program_counter", "layer": "device",
         "moves": "trial_ms", "workloads": ["urand20.pagerank-tight"]}
    ]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "HERE", str(here))
    _, cfg2, mix2, per_layer, _ = registry.cell("urand20.pagerank-tight", root=str(tmp_path))
    assert cfg2["scale"] == 20 and mix2["name"] == "pagerank-tight"
    assert registry.metric("trials.seen").read(None) == 42.0
    assert "trials.seen" in [m["name"] for m in per_layer]
    with pytest.raises(ValueError):
        registry.config("../configs/g500-kron21")


def test_forbidden_modules_by_whole_top_level_name():
    assert run.forbidden_modules({"jax.numpy": 1, "numpy": 1}) == ["jax"]
    assert run.forbidden_modules({"graphblas_tpu.core.matrix": 1}) == ["graphblas_tpu"]
    assert run.forbidden_modules({"graphblas_tpu_torch": 1, "graphblas_tpu_torch.core": 1, "jaxtyping": 1}) == []
    assert run.forbidden_modules({"jaxlib": 1, "flax.linen": 1}) == ["flax", "jaxlib"]


def test_harness_and_library_load_no_jax():
    """In a fresh process, the harness with the library, its recipes,
    references and readers loads no module of JAX or the JAX package."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from gbbench import run, registry, generate, trace, control;"
        "import graphblas_tpu_torch, graphblas_tpu_torch.core.matrix, graphblas_tpu_torch.core.compiler;"
        "[registry.algorithm(a) and registry.reference(a) for a in ('pagerank', 'sssp')];"
        "[registry.metric(m['name']) for m in registry.benchmark()['per_layer']];"
        "print(run.forbidden_modules())"
    )
    root = os.path.dirname(registry.HERE)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "kron21.pagerank", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reduction():
    """A slice of 100 us: kernels over 10-30 and 25-40 (one overlap), a copy
    over 60-70; the host in a synchronisation over 40-50 and an operator
    over 70-100."""
    events = [
        _x("user_annotation", trace.SLICE, 0.0, 100.0),
        _x("kernel", "k1", 10.0, 20.0),
        _x("kernel", "k2", 25.0, 15.0),
        _x("gpu_memcpy", "Memcpy DtoH", 60.0, 10.0),
        _x("cuda_runtime", "cudaStreamSynchronize", 40.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 5.0, 2.0),
        _x("cpu_op", "aten::add", 70.0, 30.0),
        _x("kernel", "outside", 200.0, 5.0),
    ]
    r = trace.reduce(events)
    assert r.window_s == pytest.approx(100e-6)
    assert r.busy_s == pytest.approx(40e-6)
    assert r.kernel_s == pytest.approx(35e-6)
    assert r.syncs == 1
    assert [n for n, _ in r.device_ops] == ["k1", "k2", "Memcpy DtoH"]
    assert r.idle_gaps[0] == ["aten::add", pytest.approx(30e-6)]
    assert r.idle_gaps[1][0] == "cudaStreamSynchronize" and r.idle_gaps[1][1] == pytest.approx(20e-6)
    assert r.idle_gaps[2][0] == "cudaLaunchKernel"
    with pytest.raises(ValueError):
        trace.reduce(events[1:])


def test_trace_names_python_gaps_by_the_last_call():
    events = [
        _x("user_annotation", trace.SLICE, 0.0, 100.0),
        _x("user_annotation", "gbbench.trial", 0.0, 100.0),
        _x("kernel", "k1", 0.0, 10.0),
        _x("cpu_op", "aten::copy_", 5.0, 10.0),
        _x("kernel", "k2", 90.0, 10.0),
    ]
    r = trace.reduce(events)
    assert r.idle_gaps == [["gbbench.trial, after aten::copy_", pytest.approx(80e-6)]]


def test_alone_it_prints_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    (no library) gives no result and a non-zero exit."""
    root = os.path.dirname(registry.HERE)
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "gbbench", ignore=shutil.ignore_patterns("__pycache__"))
    cmd = BENCH["command"] + ["--workload", "kron21.pagerank", "--seed", "3", "--seconds", "1", "--trace", "0"]
    out = subprocess.run([sys.executable] + cmd[1:], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
