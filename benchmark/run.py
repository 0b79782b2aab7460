"""One run of one cell of the benchmark, on one CUDA card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (its ``file``) and a traffic mix (``traffic/<name>.json``).
The run makes its images from the seed, warms up on requests of its own,
then serves the mix's requests for ``--seconds`` seconds as the mix's
arrival process sends them (``arrivals/<arrivals>.py``, a closed loop of
one client by default) through the loop it names (``loops/<loop>.py``).
With ``--trace 1`` it also serves ``trace_requests`` more requests in a
profiler window and reports the per-layer metrics instead of the
end-to-end ones; without it, where an end-to-end metric of the cell reads
the device trace, the card's work over the whole window is recorded. Once
the window has closed, the images it kept (``sample``) are held against the
reference (:mod:`benchmark.check`).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, the numbers compared with their
limits, which also end standard error. The run exits non-zero and prints
no result where the cell's cards are not there, or where JAX or the JAX
package was loaded in this process.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "jpeggpu_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``jpeggpu_tpu_torch`` is not ``jpeggpu_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str, bench: Optional[Dict] = None) -> Tuple[Dict, Dict]:
    """(the cell's entry, its parameters: the configuration's file with the
    traffic mix's laid over it)."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    config, = (c for c in bench["configs"] if c["name"] == cell["config"])
    params = json.loads((ROOT / config["file"]).read_text())
    params.update(json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text()))
    return cell, params


def metric_names(bench: Dict, kind: str, cell: str) -> List[str]:
    return [m["name"] for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def window_traced(bench: Dict, cell: str) -> bool:
    """Whether an end-to-end metric of `cell` reads the device trace, so
    that its untraced runs record the card's work over the whole window."""
    names = metric_names(bench, "end_to_end", cell)
    return any(m["source"] == "device_trace" for m in bench["end_to_end"]
               if m["name"] in names)


def _load_loop(name: str):
    import importlib

    return importlib.import_module(f"benchmark.loops.{name}").Loop


def _host(planes) -> list:
    return [p.contiguous().cpu().numpy() if hasattr(p, "cpu") else p
            for p in planes]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device, *, start: float, bench: Optional[Dict] = None,
             params: Optional[Dict] = None,
             workers: Optional[int] = None) -> Tuple[Dict, List[str]]:
    """One run of a cell on `device`; (the result object, the check lines).
    `params` replaces the cell's parameters (the tests run small images on
    the host); `workers` is the reference's process count (default: the
    host's cores, at most 8)."""
    import torch

    from . import arrivals, check, profiler
    from .inputs import make_pool
    from .records import Records, load_reader
    from .traffic import Stream, row_cuts

    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cell_params = load_cell(cell_name, bench)
    params = params or cell_params
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def stage(what: str) -> None:
        log(f"{cell_name}: {what} at {time.perf_counter() - start:.2f} s")

    stage("set-up started")
    pool = make_pool(params, seed, device)
    rows = row_cuts(pool, params)
    stage(f"{len(pool)} images made, {sum(len(p.data) for p in pool)} "
          f"bytes,")
    loop = _load_loop(params["loop"])(device, ranges=trace)
    stage("the port loaded")
    rec = Records(batch=int(params.get("batch", 1)))
    scratch = Records()
    warm = Stream(pool, params, seed, sub=1, rows=rows)
    for _ in range(int(params.get("warmup", 2))):
        loop.serve(warm.next().datas, scratch)
    sync()
    stage(f"{params.get('warmup', 2)} requests of warm-up done")
    # the kept sample's slots, allocated apart so that the peak's report
    # leaves them out: the program's own peak is what is reported
    held = torch.cuda.memory_allocated(device) if cuda else 0
    sample = check.Sample(int(params.get("sample", 16)), seed,
                          slot_bytes=max(_plane_bytes(p) for p in pool),
                          device=device)
    if cuda:
        held = torch.cuda.memory_allocated(device) - held
        torch.cuda.reset_peak_memory_stats(device)

    # the measured window, driven by the mix's arrival process; where an
    # end-to-end metric of the cell reads the device trace, the card's
    # work over the whole window is recorded (not in a traced run, which
    # reports the per-layer metrics)
    stream = Stream(pool, params, seed, sub=0, rows=rows)
    drive = arrivals.load(params.get("arrivals", "closed"))
    whole = cuda and not trace and window_traced(bench, cell_name)
    on_card = (profiler.DeviceWindow(device) if whole
               else contextlib.nullcontext())
    with on_card:
        if whole:
            stage("the card's trace of the window started")
        t_open = time.perf_counter()
        rec.setup_s = t_open - start
        window = arrivals.Window(stream, loop, rec, sample,
                                 t_open + seconds, params)
        cpu_open, faults_open = time.process_time(), _minor_faults()
        t_end = drive(window)
    rec.window_s = t_end - t_open
    if whole:
        rec.window_trace = (None if on_card.device is None else
                            profiler.Window(device=on_card.device, ranges=[],
                                            wall_s=rec.window_s, lost=0))
        log(f"{cell_name}: the window's device trace: {on_card.events} "
            f"events, " + ("whole" if on_card.device is not None else
                           "events lost, no device metric") +
            f", read by {time.perf_counter() - start:.2f} s")
    attempted, failed = window.attempted, window.failed
    log(f"{cell_name}: window {rec.window_s:.3f} s, {len(rec.latencies)} "
        f"requests, {attempted} images, {failed} failed, "
        f"{time.process_time() - cpu_open:.2f} s of this process's CPU "
        f"time, {_minor_faults() - faults_open} minor page faults")
    log(f"{cell_name}: " + _profile_of_window(rec))

    breakdown = None
    device_info: Dict = dict(
        platform="gpu" if cuda else device.type,
        kind=torch.cuda.get_device_name(device) if cuda else device.type,
        count=1)
    rec.device_kind = device_info["kind"]
    if trace and cuda:
        reqs = [stream.next() for _ in range(int(params["trace_requests"]))]
        traced = Records()

        def run():
            for r in reqs:
                loop.serve(r.datas, traced)

        rec.trace = profiler.profiled(device, run)
        rec.traced_inputs = [d for r in reqs for d in r.datas]
        device_info.update(busy_s=profiler.busy_s(rec.trace),
                           window_s=rec.trace.wall_s)
        breakdown = dict(device_ops=profiler.device_ops(rec.trace),
                         idle_gaps=profiler.idle_gaps(rec.trace))
    if cuda:  # the program's own: the kept sample's slots left out
        device_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device)) - held
        device_info["power_limit"] = _power_limit()
    else:
        device_info["memory_peak_bytes"] = 0

    # the program's state freed, its kept outputs on the host, then the
    # reference
    kept = [(key, _host(planes)) for key, planes in sample.kept]
    del loop, sample, window
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = check.reference_planes(
        [p.data for p in pool], [k for k, _ in kept], rows,
        workers or min(8, os.cpu_count() or 1))
    checks = check.judge(kept, want, failed)
    log(f"{cell_name}: reference over {len(kept)} images in "
        f"{time.perf_counter() - t:.2f} s")

    kind, folder = (("per_layer", "layers") if trace
                    else ("end_to_end", "end_to_end"))
    metrics = {}
    units = {m["name"]: m["unit"] for m in bench[kind]}
    for name in metric_names(bench, kind, cell_name):
        value = load_reader(folder, name)(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    result = dict(correct=check.passed(checks), attempted=attempted,
                  failed=failed, metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, check.lines(checks)


def _plane_bytes(im) -> int:
    """Bytes that bound the planes of pool image `im`: three components
    at full size, padded to 16-pixel MCUs."""
    return 3 * (-(-im.width // 16) * 16) * (-(-im.height // 16) * 16)


def _minor_faults() -> int:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


def _profile_of_window(rec) -> str:
    """Request latencies' deciles, and requests a tenth of the window, so a
    run that drifts or stalls shows."""
    import numpy as np

    lat = np.asarray(rec.latencies) * 1e3
    if not lat.size:
        return "no requests"
    ends = np.cumsum(lat)
    tenth = np.bincount(np.minimum((ends / ends[-1] * 10).astype(int), 9),
                        minlength=10)
    dec = np.percentile(lat, [10, 50, 90, 95, 99, 100])
    spans = {k: round(float(np.median(v)) * 1e3, 3)
             for k, v in rec.spans.items()}
    return (f"latency ms p10/p50/p90/p95/p99/max "
            f"{'/'.join(f'{d:.2f}' for d in dec)}; requests by tenth "
            f"{tenth.tolist()}; span medians ms {spans}")


def _power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it, e.g. "700.00 W"."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, _ = load_cell(args.workload, bench)

    import torch

    log(f"{args.workload}: torch imported at "
        f"{time.perf_counter() - START:.2f} s; {len(os.sched_getaffinity(0))}"
        f" cores, {torch.get_num_threads()} torch threads")
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 2
    device = torch.device("cuda", 0)
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), device, start=START,
                             bench=bench)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)} (JAX or the JAX "
            f"package); no result")
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        log(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
