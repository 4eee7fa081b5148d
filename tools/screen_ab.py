#!/usr/bin/env python3
"""Time builds of the gather kernel (``screened_logits``) against each other on
one NVIDIA GPU, in turns, at the shapes ``chip_smoke.py`` times it.

    python3 tools/screen_ab.py [NAME=SOURCE[:P][:-DMACRO=VALUE...] ...]

With no argument it compares the port's kernel (``split``,
``src/repro_torch/csrc/screen.cu``) with the owner / TMA-ring design kept in
``tools/screen_tma.cu`` (``tma``). Each NAME=SOURCE is a ``screen.cu``-like
file (path from the repository root) exporting ``l2s_screened_logits``; it
is compiled with the port's nvcc flags (its own directory first on the
include path, then ``src/repro_torch/csrc``) into ``build/screen_ab/``. With
``:P`` the entry takes the parts per tile after ``d`` (the port's signature)
and is timed at P = 1, 2, 4, 8; without it the entry has no P (an older
source). ``-D`` defines are passed to nvcc. Every build's output is first
checked against ``screened_logits_plain`` (rtol = atol = 1e-5) at each
shape, and each build's register and spill counts are printed.

Shapes: d = 500 (nmt-deen-lstm) at B = 1, 4, 8 with K = 16 routed ids, the
full cover (B = 4, K = 200) and a beam (B = 20 rows in 4 groups of 5, one
cluster each); d = 2560 (zamba2-2.7b) at B = 1, 4, 8 and the beam.
``SCREEN_AB_ONLY=<text>`` keeps the shapes whose label holds the text. Times
are CUDA-event medians with L2 flushed by reading 256 MB before each call
(``chip_smoke.Timer``), each build and P in turns, forward then reverse.
Prints one line per shape and writes ``build/screen_ab/screen_ab.json``.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

ROOT = cs.ROOT
DEFAULT = ("split=src/repro_torch/csrc/screen.cu:P", "tma=tools/screen_tma.cu:P")
OUT_DIR = ROOT / "build" / "screen_ab"
PARTS = (1, 2, 4, 8)


def build(specs):
    """[(name, source, takes_p, defines)] → {name: (ctypes fn, takes_p)},
    one nvcc per source, all started together, each library named by a
    hash of its source, the headers beside it and in ``csrc``, and its
    flags; the ptxas report of each build is printed."""
    from repro_torch.kernels import ops
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs, fns = {}, {}
    for name, src, takes_p, defines in specs:
        src = Path(src)
        cmd = [*ops.NVCC_FLAGS, f"-I{src.parent}", f"-I{ops.CSRC}", *defines]
        digest = hashlib.sha256(" ".join(cmd).encode())
        for path in [src, *sorted(src.parent.glob("*.cuh")),
                     *sorted(ops.CSRC.glob("*.cuh"))]:
            digest.update(path.read_bytes())
        so = OUT_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        if not so.exists():
            jobs[name] = (so, subprocess.Popen(
                [ops._nvcc(), *cmd, "-o", str(so), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        fns[name] = (so, takes_p)
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        so.with_suffix(".log").write_text(out)
    I, P_ = ctypes.c_int, ctypes.c_void_p
    for name, (so, takes_p) in fns.items():
        info = [ln.split("ptxas info    : ")[-1] for ln in
                so.with_suffix(".log").read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[ptxas] {name}: {'; '.join(info)}", flush=True)
        fn = ctypes.CDLL(str(so)).l2s_screened_logits
        fn.argtypes = [P_] * 5 + [I] * (5 if takes_p else 4) + [P_]
        fn.restype = I
        fns[name] = (fn, takes_p)
    return fns


def shapes(torch, np):
    """[(label, Wb, bb, h, ids)] at both widths."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.route import cluster_route_plain
    out = []
    for d, vocab, seed in ((cs.D, cs.V, 1), (cs.ZD, cs.ZV, 11)):
        W, b = cs.make_head(torch, seed, vocab=vocab, d=d)
        Wb, bb = ops.pack_head_blocks(W, b)
        del W, b
        n_blk = Wb.shape[0]
        cand = torch.from_numpy(cs.make_screen_blocks(np, seed + 2, n_blk)).cuda()
        v = torch.randn((cs.R, d), generator=torch.Generator().manual_seed(
            seed + 4)).cuda()
        g = torch.Generator().manual_seed(seed + 40)
        for B in (1, 4, 8):
            h = torch.randn((B, d), generator=g).cuda()
            ids = cand[cluster_route_plain(h, v).long()].contiguous()
            out.append((f"d={d} B={B} K={cs.K}", Wb, bb, h, ids))
        if d == cs.D:
            full = torch.full((4, 200), n_blk, dtype=torch.int32)
            full[:, :n_blk] = torch.arange(n_blk, dtype=torch.int32)
            out.append((f"d={d} full cover B=4 K=200", Wb, bb,
                        torch.randn((4, d), generator=g).cuda(),
                        full.cuda()))
        clusters = torch.randperm(cs.R, generator=g)[:4]
        ids = cand[clusters.repeat_interleave(5).cuda()].contiguous()
        out.append((f"d={d} beam B=20 K={cs.K}", Wb, bb,
                    torch.randn((20, d), generator=g).cuda(), ids))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("screen_ab: no CUDA GPU is visible", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.device import resolve_device
    from repro_torch.kernels.screen import screen_parts, screened_logits_plain
    resolve_device("cuda")
    specs = []
    for arg in sys.argv[1:] or DEFAULT:
        name, rest = arg.split("=", 1)
        src, *opts = rest.split(":")
        specs.append((name, str(ROOT / src), "P" in opts,
                      [o for o in opts if o.startswith("-D")]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    fns = build(specs)
    timer = cs.Timer(torch)
    stream = torch.cuda.current_stream().cuda_stream
    table = {}
    only = os.environ.get("SCREEN_AB_ONLY", "")
    for label, Wb, bb, h, ids in shapes(torch, np):
        if only not in label:
            continue
        n_blk, _, d = Wb.shape
        B, Ks = ids.shape
        out = torch.empty((B, Ks, cs.V_BLK), device="cuda")
        want = screened_logits_plain(Wb, bb, h, ids)

        def call(fn, takes_p, p, out=out, Wb=Wb, bb=bb, h=h, ids=ids,
                 B=B, Ks=Ks, n_blk=n_blk, d=d):
            args = [Wb.data_ptr(), bb.data_ptr(), h.data_ptr(),
                    ids.data_ptr(), out.data_ptr(), B, Ks, n_blk, d]
            rc = fn(*args, *([p] if takes_p else []), stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        runs = {}
        for name, (fn, takes_p) in fns.items():
            for p in (PARTS if takes_p else (0,)):
                key = f"{name} P={p}" if takes_p else name
                runs[key] = (lambda fn=fn, t=takes_p, p=p: call(fn, t, p))
                out.zero_()
                runs[key]()
                torch.testing.assert_close(out, want, **cs.TOL,
                                           msg=lambda m, k=key: f"{k}: {m}")
        t = timer.turns(runs)
        distinct = int(torch.unique(torch.where(ids < n_blk, ids, 0)).numel())
        bound = cs.bound_ms(distinct * cs.V_BLK * (d + 1) * 4 +
                            4 * (B * d + B * Ks + B * Ks * cs.V_BLK),
                            2 * B * Ks * cs.V_BLK * d)[0]
        rule = screen_parts(B, Ks, d, timer.n_sm)
        table[label] = {"ms": t, "bound_ms": bound, "distinct": distinct,
                        "screen_parts": rule}
        print(f"[ab] {label} (distinct tiles {distinct}, bound {bound:.5f} "
              f"ms, the port's rule picks P={rule}): " +
              ", ".join(f"{k} {v:.5f}" for k, v in t.items()), flush=True)
    (OUT_DIR / "screen_ab.json").write_text(json.dumps(
        {"device": smi, "builds": [s[:3] for s in specs], "shapes": table},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
