"""One run of one cell: set-up, the measured window, the readings, the
check against the plain reference, and the result line.

Everything a cell needs is found by name:

* ``BENCHMARK.json`` — the cell (``workloads``), its configuration entry
  and the metrics it reports (an entry's ``workloads`` lists its cells;
  one without the key is reported by every cell);
* ``bench/configs/<config>.json`` (through the entry's ``file``) — the
  sizes as run (every one applied to the program, ``drive.port_config``),
  the screen's shape, ``port_config`` (the program's registry name the
  sizes are applied to) and ``family``;
* ``bench/reference/<family>.py`` — the plain reference: its weights
  (``param_spec``), ``hidden``, ``head`` and the model's FLOPs
  (``model_flops``);
* ``bench/traffic/<traffic>.json`` — the mix (``traffic.py``);
* ``bench/limits/<workload>.json`` — the limit of each number compared;
* ``bench/metrics/<metric>.py`` — one reader per metric, end to end or
  per layer: ``read(ctx)`` → a number, or None where it finds nothing to
  read (the metric is then left out of the line).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from l2sbench import drive, judge, profile, traffic, weights, work

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reference_module(cfg: dict):
    """``bench/reference/<family>.py``, loaded once a process."""
    name = f"bench_reference_{cfg['family']}"
    if name not in sys.modules:
        sys.modules[name] = load_module(
            BENCH / "reference" / f"{cfg['family']}.py", name)
    return sys.modules[name]


def precision(name: str):
    """A ``Precision`` of ``bench/reference/precision.py``."""
    mod = load_module(BENCH / "reference" / "precision.py",
                      "bench_reference_precision")
    return mod.Precision(name)


def metric_reader(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))


@dataclass
class Cell:
    """A cell with everything its files say."""
    name: str
    entry: dict
    cfg: dict
    mix: dict
    limits: dict

    @classmethod
    def find(cls, bench: dict, name: str) -> "Cell":
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                           f"{[w['name'] for w in bench['workloads']]}")
        conf = next(c for c in bench["configs"]
                    if c["name"] == entry["config"])
        return cls(name=name, entry=entry,
                   cfg=load_json(ROOT / conf["file"]),
                   mix=load_json(BENCH / "traffic"
                                 / f"{entry['traffic']}.json"),
                   limits=load_json(BENCH / "limits" / f"{name}.json"))


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metric entries: end to end, or per layer when traced."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


@dataclass
class Ctx:
    """What a metric reader reads."""
    cfg: dict
    mix: dict
    record: drive.Record
    setup_s: float
    screen_words: float                 # mean real words of a cluster
    trace: Optional[profile.Trace] = None
    traced_span: Optional[tuple] = None  # (start, stop) s of the profiler
    probe: Optional[dict] = None        # the head span of a traced run

    def request_flops(self, head: str, prompt: int, new: int) -> float:
        """FLOPs of one served request (``work.request_flops``) with the
        model's count from the configuration's reference."""
        return work.request_flops(self.cfg, reference_module(self.cfg),
                                  head, self.screen_words, prompt, new)


def screen_words(cand: torch.Tensor, vocab: int, block: int) -> torch.Tensor:
    """Real words of each cluster's candidate blocks (the last block of
    the vocabulary is short)."""
    real = torch.clamp(vocab - cand.long() * block, min=0, max=block)
    return real.sum(dim=1)


def probe_work(cfg: dict, probe: dict, v, cand) -> dict:
    """The least work of the probe's head call, its routes worked out
    here in plain float32."""
    h = probe["h"].float()
    if probe["head"] == "exact":
        nbytes, flops = work.head_call_work(cfg, "exact", h.shape[0])
        return {"bytes": nbytes, "flops": flops}
    V, blk = int(cfg["vocab_size"]), int(cfg["screen"]["block"])
    routes = torch.argmax(h @ v.float().T, dim=1)
    blocks = cand.long()[routes]
    tiles = torch.unique(blocks)
    tile_words = int(torch.clamp(V - tiles * blk, min=0, max=blk).sum())
    row_words = int(screen_words(cand, V, blk)[routes].sum())
    nbytes, flops = work.head_call_work(cfg, "screened", h.shape[0],
                                        tile_words, row_words)
    return {"bytes": nbytes, "flops": flops, "tiles": int(tiles.numel())}


@dataclass
class Setup:
    """The program as set up for a cell, ready for its window."""
    engine: object
    loop: drive.ClosedLoop
    v: torch.Tensor
    cand: torch.Tensor
    words: float


def setup(cell: Cell, seed: int, dev) -> Setup:
    """Weights and screen from the seed, the engine, the loop, warmed."""
    cfg, mix = cell.cfg, cell.mix
    V, blk = int(cfg["vocab_size"]), int(cfg["screen"]["block"])
    flat = weights.make_weights(reference_module(cfg).param_spec(cfg), seed,
                                dev)
    weights.check_layout(flat, drive.program_layout(cfg))
    v, cand = weights.make_screen(cfg, seed, dev)
    longest = traffic.longest(mix)
    engine = drive.build_engine(cfg, weights.as_tree(flat), v, cand, dev,
                                max_len=longest[0] + longest[1])
    loop = drive.ClosedLoop(engine, mix, seed, V)
    loop.warm()
    return Setup(engine=engine, loop=loop, v=v, cand=cand,
                 words=float(screen_words(cand, V, blk).float().mean()))


def run_cell(bench: dict, cell: Cell, seed: int, seconds: float,
             trace: bool, device="cuda", t_start: Optional[float] = None,
             chips: int = 1, control: Optional[str] = None) -> dict:
    """One run → the result line (a dict, the checks last). With
    ``control`` (a precision) the control's numbers on the same sample
    are added under ``control`` (calibration only)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cfg, mix = cell.cfg, cell.mix
    su = setup(cell, seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # the set-up's objects are never garbage: no collection in the window
    # walks them again
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    # -- the window ---------------------------------------------------------
    prof = drive.Profiler(trace and dev.type == "cuda",
                          float(mix["trace_at_s"]),
                          float(mix["trace_seconds"]))
    record = su.loop.run(seconds, prof)
    drive.sync(dev)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # -- readings that need the program ------------------------------------
    probe = None
    if trace and dev.type == "cuda":
        heads = [h for j in record.jobs for h in j.heads]
        probe = drive.head_probe(su.engine, cfg, mix,
                                 max(set(heads), key=heads.count), seed)
        probe.update(probe_work(cfg, probe, su.v, su.cand))
        del probe["h"]
    tr = None
    if prof.prof is not None:
        tr = profile.Trace.of(prof.prof, prof.window)
    span, prof = prof.span, None
    ctx = Ctx(cfg=cfg, mix=mix, record=record, setup_s=setup_s,
              screen_words=su.words, trace=tr, traced_span=span, probe=probe)
    metrics = {}
    for m in metrics_of(bench, cell.name, trace):
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # -- the program's state freed; the plain reference judges -------------
    del su
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check_outputs(cfg, mix, record, seed, dev, cell.limits)
    # a request served fewer tokens than it asked for never finished
    failed = sum(int((j.lengths != j.max_new).sum()) for j in record.jobs)
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in cell.limits.items()}
    checks["failed"] = {"value": failed, "limit": 0}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": sum(len(j.heads) for j in record.jobs),
           "failed": failed,
           "metrics": metrics,
           "device": device_info(dev, chips, peak, tr)}
    if tr is not None:
        out["breakdown"] = profile.breakdown(tr)
    if control is not None:
        out["program"] = numbers
        out["control"] = check_outputs(cfg, mix, record, seed, dev,
                                       cell.limits, control=control)
    out["checks"] = checks
    return out


def device_info(dev, chips: int, peak: int, tr) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": int(chips), "memory_peak_bytes": int(peak)}
    if tr is not None:
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s
    return info


def judged_sample(mix: dict, record: drive.Record, seed: int) -> list:
    """The finished requests the reference judges: (prompt, tokens, head)."""
    jobs = record.jobs
    done = [(k, j) for k, job in enumerate(jobs)
            for j in np.flatnonzero(job.lengths == job.max_new)]
    sizes = np.array([(jobs[k].lengths[j], jobs[k].prompts.shape[1])
                      for k, j in done]).reshape(-1, 2)
    idx = judge.pick_sample(sizes, int(mix["judge_requests"]),
                            traffic.rng_for(seed, 4))
    out = []
    for i in idx:
        k, j = done[i]
        job = jobs[k]
        out.append((job.prompts[j], job.tokens[j, :job.lengths[j]],
                    job.heads[j]))
    return out


def check_outputs(cfg: dict, mix: dict, record: drive.Record, seed: int,
                  dev, limits: dict, control: Optional[str] = None) -> dict:
    """The judge's numbers for a sample of the window's requests: the
    program's tokens, or with ``control`` (a precision) the control's
    tokens at the same positions."""
    ref = reference_module(cfg)
    sample = judged_sample(mix, record, seed)
    w = weights.make_weights(ref.param_spec(cfg), seed, dev)
    v, cand = weights.make_screen(cfg, seed, dev)
    scr = judge.Screen(v, cand, int(cfg["vocab_size"]),
                       int(cfg["screen"]["block"]))
    W, b = ref.head(w, cfg)
    f32 = precision("float32")
    pairs = [(p, t) for p, t, _ in sample]
    H = judge.teacher_forced_hidden(ref, w, cfg, pairs, f32, dev)
    if control is not None:
        low = precision(control)
        Hc = judge.teacher_forced_hidden(ref, w, cfg, pairs, low, dev)
    out = {"positions": 0, "logit_gap": 0.0, "outside": 0, "route_gap": 0.0}
    start = 0
    for p, t, head in sample:
        n = len(t)
        sl = slice(start, start + n)
        start += n
        screen = None if head == "exact" else scr
        toks = t
        if control is not None:
            toks = judge.control_tokens(Hc[sl], W, b, screen,
                                        low).cpu().numpy()
        got = judge.judge(H[sl], toks, W, b, screen, limits.get("route_gap"),
                          f32)
        out["positions"] += got["positions"]
        out["outside"] += got["outside"]
        for k in ("logit_gap", "route_gap"):
            out[k] = max(out[k], got.get(k, 0.0))
    return out


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def report(result: dict) -> None:
    """The checks on standard error (last lines there), the result line
    last on standard output."""
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
