"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (its file under portbench/configs/, whose
"family" picks the module of its model-specific parts, families.py) and a
traffic mix (portbench/traffic/<traffic>.json, whose "kind" picks the
module that runs it: train.py or transcribe.py); its correctness limits are in
portbench/limits/<cell>.json and each per-layer metric's reader in
portbench/metrics/<metric>.py. With --trace 0 the last line of standard
output carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics; the numbers compared with the reference end standard error and
the result line. The run needs a CUDA card, and exits non-zero without
printing a result when it has none, when the program is not beside it, or
when the process has loaded JAX or the JAX package.

Readings for the correctness limits (not run by the benchmark's checks):
--check_only --seeds a,b,... runs each seed's set-up, checked steps (or one
batch) and comparison in one process; --control lower puts the reference
one precision down in the program's place (training: its steps against the
fp32 reference's; serving: at each position of the served utterances, the
token it puts first); --control half_batch (training) the reference over
half of each batch.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness as H  # noqa: E402

# The port's metrics logger writes TensorBoard events; TensorBoard imports
# TensorFlow where one is installed, and TensorFlow's lite converter imports
# JAX. Hidden, TensorBoard takes its own stub, as it does where TensorFlow is
# absent (the card's machine).
sys.modules.setdefault("tensorflow", None)
PH = H.Phases()
FORBIDDEN = ("jax", "jaxlib", "flax", "asr_finetune_tpu")
SHARE_UNITS = ("%",)


def load_cell(name: str, manifest: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    with open(manifest) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {manifest}")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    limits_path = os.path.join(HERE, "limits", name + ".json")
    limits = {}
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moves and name in m.get("workloads", [name])]
    return {"name": name, "chips": cell["chips"], "config": config, "traffic": traffic,
            "limits": limits, "end_to_end": e2e, "per_layer": per_layer}


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             faults=()) -> dict:
    """One run of a cell; returns the result line's object."""
    import torch
    kind = cell["traffic"]["kind"]
    if kind == "train":
        from portbench import train as runner
    elif kind == "transcribe":
        from portbench import transcribe as runner
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    dev = torch.device(device)
    out_dir = os.path.join(ROOT, "portbench_out", cell["name"], f"seed{seed}")
    res = runner.run(cell, seed, seconds, trace, dev, PH, out_dir, faults)
    checks = res["checks"]
    correct = all(c["limit"] is not None and c["value"] <= c["limit"]
                  and math.isfinite(c["value"]) for c in checks.values())
    correct = correct and res["failed"] == 0 and res["attempted"] > 0
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    if trace:
        w = res["window"]
        metrics = {}
        for m in cell["per_layer"]:
            v = H.read_metric(m["name"], w)
            if v is None:
                continue
            if m["unit"] in SHARE_UNITS and v > 100.0:
                raise RuntimeError(f"{m['name']} reads {v}%: over 100% is a fault of the "
                                   "count, not a result")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in res["metrics"].items()
                   if k in units}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": device_info}
    w = res["window"]
    if trace and getattr(w, "trace", None) is not None:
        device_info["busy_s"] = w.trace.busy_s()
        device_info["window_s"] = w.trace.window_s
        line["breakdown"] = {"device_ops": w.trace.top_ops(),
                             "idle_gaps": w.trace.idle_gaps(w.trace_spans)}
        H.write_json(os.path.join(out_dir, "profile.json"),
                     {"device_ops": w.trace.top_ops(40),
                      "idle_gaps": w.trace.idle_gaps(w.trace_spans, 40),
                      "launches": w.trace.launches(), "busy_s": w.trace.busy_s(),
                      "window_s": w.trace.window_s, "calls": len(w.calls.calls),
                      "decode_positions": getattr(w, "positions", None)})
    line["setup_phases_s"] = dict(PH.phases)
    line["reference_s"] = res["reference_s"]
    line["card"] = H.card_info()
    line["host"] = res["window"].host.out
    line["checks"] = checks
    return line


def control(cell: dict, seeds, kind: str, device: str) -> list:
    """Readings for the limits: a training cell's reference against the
    reference one precision down (or over half of each batch); a serving
    cell's run with the reference one precision down reading the served
    tokens. One line a seed, printed and returned."""
    import torch
    lines = []
    for seed in seeds:
        if cell["traffic"]["kind"] == "train":
            from portbench import families
            from portbench import traffic as TR
            from portbench import train as T
            family = families.load(cell["config"])
            tr = cell["traffic"]
            pool = TR.make_pool(tr, seed, tr["pool"])
            calib = TR.make_pool(tr, seed, 4, stream=1)
            B = tr["batch"]
            rows = [list(range(s * B, (s + 1) * B)) for s in range(tr["check_steps"])]
            opts = family.reference_opts(T.parse_program_args(cell, seed, device), seed)
            dev = torch.device(device)
            ref = family.train_steps(cell["config"], opts, seed, pool, rows, calib, dev)
            alt = family.train_steps(cell["config"], opts, seed, pool, rows, calib, dev,
                                     lower=kind == "lower", half_batch=kind == "half_batch")
            checks = T.compare(cell["limits"], alt["losses"], alt["first_grad"],
                               alt["change"], alt.get("outlier_sets"), ref)
            out = {"control": kind, "seed": seed, "checks": checks}
        else:
            line = run_cell(cell, seed, cell["traffic"]["serve"]["control_seconds"], False,
                            device, faults=(kind,))
            out = {"control": kind, "seed": seed, "correct": line["correct"],
                   "checks": line["checks"]}
        print(json.dumps(out), flush=True)
        lines.append(out)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("lower", "half_batch"), default=None)
    p.add_argument("--seeds", type=str, default="")
    p.add_argument("--check_only", action="store_true")
    a = p.parse_args(argv)
    cell = load_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # no JAX through a library; every build cache at a fixed path in the checkout
    # (the port's own kernels build into build/torch_kernels and build/torch_native)
    os.environ.update({"USE_FLAX": "0", "USE_JAX": "0",
                       "TRITON_CACHE_DIR": os.path.join(ROOT, "build", "triton"),
                       "TORCH_EXTENSIONS_DIR": os.path.join(ROOT, "build", "torch_extensions")})
    if a.control:
        seeds = [int(s) for s in a.seeds.split(",")] if a.seeds else [a.seed]
        control(cell, seeds, a.control, "cuda")
        return 0
    if a.check_only:
        for seed in [int(s) for s in a.seeds.split(",")] if a.seeds else [a.seed]:
            line = run_cell(cell, seed, 0.0, False)
            print(json.dumps({"seed": seed, "correct": line["correct"], "checks": line["checks"],
                              "reference_s": line["reference_s"],
                              "setup_phases_s": line["setup_phases_s"]}), flush=True)
        return 0
    line = run_cell(cell, a.seed, a.seconds, bool(a.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print("setup phases (s): " + json.dumps(line["setup_phases_s"]))
    print("card: " + json.dumps(line["card"]), file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
