"""A configuration, a traffic mix, an arrival process, a per-layer and an
end-to-end metric, and a cell, added as files and entries in a copy of the
benchmark, run without an edit to any file that was there."""

import hashlib
import json
import shutil
import subprocess
import sys

from small import ROOT

NEW_CONFIG = {
    "deployment": "thumbnails",
    "geometry": [{"share": 1.0, "width": 96, "height": 64}],
    "quality": 75, "subsampling": "4:4:4",
    "noise": {"sigma": [2, 6], "per_image": True}, "pool": 3,
}
NEW_MIX = {"loop": "decoder", "order": "epochs", "batch": 1, "warmup": 1,
           "sample": 2, "restart_rows": 1, "trace_requests": 2,
           "arrivals": "paced", "think_ms": 5}
NEW_ARRIVALS = (
    '"""One client that waits think_ms between answer and request."""\n\n'
    'import time\n\n\n'
    'def drive(w):\n'
    '    t_end = time.perf_counter()\n'
    '    while t_end < w.deadline:\n'
    '        time.sleep(w.params["think_ms"] / 1e3)\n'
    '        req = w.stream.next()\n'
    '        t0 = time.perf_counter()\n'
    '        outs = w.loop.serve(req.datas, w.rec)\n'
    '        t_end = time.perf_counter()\n'
    '        w.rec.count("sent", 1)\n'
    '        w.answered(req, outs, t0, t_end)\n'
    '    return t_end\n')
NEW_LAYER = ('"""Requests the paced client sent."""\n\n\n'
             'def read(rec):\n'
             '    return float(len(rec.counters.get("sent", ()))) or None\n')
NEW_E2E = ('"""Median latency, ms."""\n\nimport statistics\n\n\n'
           'def read(rec):\n'
           '    return statistics.median(rec.latencies) * 1e3\n')


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_make_a_cell(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)
    b = tmp_path / "benchmark"
    (b / "configs" / "thumbs.json").write_text(json.dumps(NEW_CONFIG))
    (b / "traffic" / "tiny.json").write_text(json.dumps(NEW_MIX))
    (b / "arrivals" / "paced.py").write_text(NEW_ARRIVALS)
    (b / "layers" / "images_seen.py").write_text(NEW_LAYER)
    (b / "end_to_end" / "median_ms.py").write_text(NEW_E2E)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "thumbs", "source": "a test",
                             "file": "benchmark/configs/thumbs.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "thumbs.tiny", "config": "thumbs",
                               "traffic": "tiny", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "median_ms", "unit": "ms",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["thumbs.tiny"]})
    bench["per_layer"].append({"name": "images_seen", "unit": "images",
                               "better": "higher", "source": "program_span",
                               "layer": "decode", "moves": "median_ms",
                               "workloads": ["thumbs.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time, torch\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        f"sys.path.append({str(ROOT)!r})\n"
        "from benchmark import run\n"
        "assert run.ROOT == __import__('pathlib').Path(sys.path[0])\n"
        "out = {}\n"
        "for trace in (False, True):\n"
        "    r, _ = run.run_cell('thumbs.tiny', 5, 0.3, trace,\n"
        "        torch.device('cpu'), start=time.perf_counter(), workers=1)\n"
        "    out[trace] = r\n"
        "print(json.dumps({str(k): v for k, v in out.items()}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    e2e, traced = out["False"], out["True"]
    assert e2e["correct"] and traced["correct"]
    # every metric with no `workloads` key, and those that list the cell
    assert set(e2e["metrics"]) == {"median_ms", "setup_s"}
    assert traced["metrics"]["images_seen"]["value"] >= 1
    assert traced["metrics"]["images_seen"]["value"] == traced["attempted"]
    after = digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
