#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU, and
check it: the L2S screened decode of the paper's LSTM (nmt-deen-lstm) and the
Mamba2/Zamba2 decode path (zamba2-2.7b).

    python3 chip_smoke.py

Phases, one line (or a few) each:

  1. device   the card's name, and its name and power limit as nvidia-smi
              reports them;
  2. build    every kernel compiled from ``src/repro_torch/csrc`` (one nvcc
              per source, in parallel) and loaded;
  3. parity   each kernel against its plain PyTorch version on the card, at
              the main path's shapes (nmt-deen-lstm: d = 500, V = 25,000 →
              196 blocks, r = 100 clusters, K = 16 blocks per cluster, some
              clusters sentinel-padded; B ∈ {1, 8}, k ∈ {1, 5}), plus a
              dense-tie fixture and an all-sentinel row; the route also at
              zamba2-2.7b's d = 2560 (B ∈ {1, 4, 130}) and on an exact tie
              between clusters held by different blocks of its thread
              block cluster (the first index must win). Routes and ids
              must be equal except where the plain scores differ by less
              than 1e-5 relative (counted and printed); values and logZ
              agree within rtol = atol = 1e-5; the fused and unfused paths
              are bit-identical on ids and values. Then the fused kernel's
              split design (blocks per row, slot and part of the tile,
              merged by each row's last block) over k in {1, 5, 128, 129,
              130} x K in {1, 3, 16, 200} x B in {1, 4, 130} and k = K*128
              at K = 3, with sentinels mid-row and an all-sentinel row:
              fused == unfused bit for bit at d = 500 and 2560; a tie
              across blocks (slots and parts) going to the lowest
              position; noise; two calls bit-identical in ids, vals and
              logZ;
  4. timing   CUDA-event median times with a cold L2 of each kernel, its
              plain version and, where one PyTorch call computes the same
              function, that call, timed in turns (library, kernel, plain,
              plain, kernel, library); beside each, its bound (bytes over
              3.35 TB/s or float32 flops over 67 TFLOP/s, the larger); the
              L2S kernels at d = 500 and at zamba2's d = 2560; the fused
              kernel also beside the unfused composition (screened_logits
              + torch.where + stable top-k + logsumexp, "unfused_ms"), and
              at B = 4, K = 16, k = 1 with each tile cut into P = 1, 2, 4
              and 8 parts;
  5. e2e      full-width nmt-deen-lstm (random weights from a seeded
              torch.Generator) on DecodeEngine(device="cuda"): greedy
              4 prompts × 16 tokens through exact and screened-cuda (fused
              and unfused), sampled decode (Gumbel-max and top-p), beam
              search (beam 5), and a full-cover screen whose screened-cuda
              tokens must equal the exact head's except after a step whose
              exact top-2 gap is below 1e-4. Launch counters are reset just
              before and read just after: every kernel must have launched;
  6. ssm      the SSD intra-chunk kernel against its plain version at
              zamba2-2.7b's prefill chunk (B = 4, nc = 2, Q = 256, H = 80,
              P = N = 64, G = 1), mamba2-1.3b's (H = 64, N = 128) and a
              short odd one (Q = 7, G = 2): max |kernel - plain| / max |plain|
              of y and of S, each <= 1e-5; the KV-cache slot update against
              its plain version, bit for bit, float32 and bfloat16, slots
              0, 127, S/2, S-1, S+5 and per-row slots, for one cache and
              for the K and V pair written in one launch; both kernels
              timed like phase 4 (the pair launch beside two single
              launches and beside cache[rows, slot] = upd done twice);
  7. hybrid   full-width zamba2-2.7b in float32 (2.3 B parameters drawn on
              the card from a seeded CUDA generator) on DecodeEngine(
              device="cuda", max_len=640): greedy 4 prompts x 512 tokens
              (2 SSD chunks), 32 new, through exact and screened-cuda (fused
              and unfused; r = 100, K = 16 over 250 blocks), beam search
              (beam 4), and a full-cover screen whose tokens must equal
              exact's except after a step whose exact top-2 gap is below
              1e-4. Counters are reset just before and read just after:
              ssd_intra must launch 54 times per prefill and the cache
              update 9 times (once per shared-attention application) per
              decode step. Then a self-check: the hidden states of
              prefill over 512 tokens and 4 decode steps equal one prefill
              over 516 (max relative error <= 1e-3), and a profile of one
              greedy screened-cuda decode (each profile also gives the fused
              kernel's share of device time);
  8. a JSON line {"kernels": [...]} (each kernel with its launches on the
              path it was ported for and, in "launches_by_path", on both;
              the route and the fused kernel also "at_zamba2_width"; the
              fused kernel "unfused_ms"; the cache update's times are the K
              and V pair's, with "single_ms" of one single-cache launch)
              and, last, {"ok": true, "device": ...}.

Any failed check raises, and the script exits non-zero. Without a CUDA GPU,
or without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
D, V, R, K = 500, 25_000, 100, 16
V_BLK = 128
TOL = dict(rtol=1e-5, atol=1e-5)
GAP = 1e-4
L2S_KERNELS = ("cluster_route", "screened_logits", "fused_screened_topk")
# SSD chunk shapes (B, nc, Q, H, P, G, N): zamba2-2.7b's prefill of 4 x 512
# tokens, mamba2-1.3b's, and a short odd chunk
SSD_SHAPES = {"zamba2": (4, 2, 256, 80, 64, 1, 64),
              "mamba2": (4, 2, 256, 64, 64, 1, 128),
              "short": (4, 1, 7, 80, 64, 2, 64)}
SSD_REL_TOL = 1e-5
# zamba2-2.7b's decode cache: B = 4 rows of max_len = 640 slots, 32 KV heads
# of 80 channels; hybrid decode 4 prompts x 512 tokens, 32 new
CACHE_SHAPE = (4, 640, 32, 80)
ZB, ZT, ZNEW, ZMAX = 4, 512, 32, 640
ZD, ZV = 2560, 32_000                # zamba2-2.7b's d_model and vocabulary


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# -- fixtures ------------------------------------------------------------------
def make_head(torch, seed, kind="normal", vocab=V, d=D):
    """(W (vocab, d), b (vocab,)) on the card: random normal or quantized
    (ties)."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((vocab, d), generator=g)
    if kind == "ties":
        return (torch.round(W * 2) / 2).cuda(), torch.zeros(vocab).cuda()
    return (W * 0.05).cuda(), (torch.randn((vocab,), generator=g) * 0.1).cuda()


def make_screen_blocks(np, seed, n_blk, r=R, k=K, dups=False):
    """(r, K) int32 candidate blocks: K distinct sorted blocks per cluster,
    every 7th cluster with only 10 real blocks and 6 sentinel slots (with
    ``dups``, blocks may repeat: ties across slots)."""
    rng = np.random.default_rng(seed)
    cand = np.full((r, k), n_blk, np.int32)
    for t in range(r):
        n = 10 if t % 7 == 3 else k
        cand[t, :n] = (rng.integers(0, n_blk, n) if dups else
                       np.sort(rng.choice(n_blk, n, replace=False)))
    return cand


# -- timing --------------------------------------------------------------------
class Timer:
    """Median device time of one call, L2 flushed before each: the stream
    is held by a short sleep while the host enqueues the call, so host
    overhead does not enter the measurement."""

    def __init__(self, torch, reps=30):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(256 * 2 ** 20 // 4, device="cuda")
        self.n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def __call__(self, fn):
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def turns(self, fns):
        """{name: fn} → {name: mean of two medians}, timed in turns: each
        in the given order, then each in the reverse order (library,
        kernel, plain, plain, kernel, library)."""
        got = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            got[name].append(self(fns[name]))
        return {name: sum(t) / len(t) for name, t in got.items()}


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_share(kern, busy_ms):
    """The fused top-k kernel's device time in a profile, and its share."""
    ev = [e for e in kern if "fused_topk_kernel" in e.key]
    ms = sum(e.self_device_time_total for e in ev) / 1e3
    return (f"fused_topk_kernel {ms:.3f} ms x{sum(e.count for e in ev)} "
            f"({ms / busy_ms:.1%} of device time)")


# -- phases ----------------------------------------------------------------------
def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {name}; devices visible: {torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi.splitlines()[0])
    return name, smi.splitlines()[0]


def phase_build(ops):
    t0 = time.perf_counter()
    libs = ops.build_kernels()
    for stem in libs:
        ops._library(stem)
    secs = time.perf_counter() - t0
    log(f"[build] {len(libs)} kernel libraries built and loaded in "
        f"{secs:.1f} s under {ops.BUILD_DIR.relative_to(ROOT)}")
    for stem, so in libs.items():
        report = so.with_suffix(".log")
        lines = report.read_text().splitlines() if report.exists() else []
        usage = [ln.split("ptxas info    : ")[-1] for ln in lines
                 if "Used" in ln or "spill" in ln]
        log(f"[build] {stem}: " + " | ".join(usage))


def phase_parity(torch, np, K_):
    """Kernels vs plain versions on the card. → {kernel: max abs err}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.ref import NEG_INF, topk_desc
    from repro_torch.kernels.route import cluster_route, cluster_route_plain
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)

    err = {"cluster_route": 0.0, "screened_logits": 0.0,
           "fused_screened_topk": 0.0}
    near_ties = 0

    def ids_match(name, got, want, got_score, want_score):
        """Positions where ids differ must be near-ties: the scores there
        differ by less than 1e-5 relative."""
        nonlocal near_ties
        diff = (got != want).nonzero(as_tuple=True)
        if diff[0].numel():
            a, b = got_score[diff], want_score[diff]
            rel = (a - b).abs() / b.abs().clamp_min(1e-30)
            check(bool((rel < 1e-5).all()),
                  f"{name}: {diff[0].numel()} ids differ beyond near-ties")
            near_ties += diff[0].numel()

    for kind in ("normal", "ties"):
        W, b = make_head(torch, 1 if kind == "normal" else 2, kind)
        Wb, bb = ops.pack_head_blocks(W, b)
        n_blk = Wb.shape[0]
        check(n_blk == 196 and int((bb[-1] <= NEG_INF / 2).sum()) == 88,
              f"packing: {n_blk} blocks, last one padded wrong")
        cand = torch.from_numpy(make_screen_blocks(
            np, 3, n_blk, dups=kind == "ties")).cuda()
        g = torch.Generator().manual_seed(4)
        v = torch.randn((R, D), generator=g).cuda()
        for B in (1, 8):
            h = torch.randn((B, D), generator=g)
            if kind == "ties":
                h = torch.round(h) * 0.5
            h = h.cuda()
            route = cluster_route(h, v)
            plain = cluster_route_plain(h, v)
            scores = h @ v.T
            s_route = scores.gather(1, route.long()[:, None])[:, 0]
            s_plain = scores.gather(1, plain.long()[:, None])[:, 0]
            ids_match("cluster_route", route, plain, s_route, s_plain)
            err["cluster_route"] = max(err["cluster_route"],
                                       float((s_route - s_plain).abs().max()))
            block_ids = cand[plain.long()].contiguous()
            if B == 8:
                block_ids[-1] = n_blk                     # all-sentinel row
            raw = screened_logits(Wb, bb, h, block_ids)
            raw_p = screened_logits_plain(Wb, bb, h, block_ids)
            torch.testing.assert_close(raw, raw_p, **TOL)
            if kind == "ties":
                check(torch.equal(raw, raw_p), "ties: screened not exact")
            err["screened_logits"] = max(err["screened_logits"],
                                         float((raw - raw_p).abs().max()))
            valid = (block_ids < n_blk)[..., None]
            row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
            lane = torch.arange(V_BLK, device="cuda", dtype=torch.int32)
            word = torch.where(valid, block_ids[..., None] * V_BLK + lane,
                               n_blk * V_BLK).reshape(B, -1)
            for k in (1, 5, 130):
                gn = torch.Generator(device="cuda").manual_seed(k)
                for noise in (None, ops.gumbel_noise((B, K_, V_BLK), gn,
                                                     "cuda")):
                    fi, fv, fz = fused_screened_topk(Wb, bb, h, block_ids, k,
                                                     noise)
                    pi, pv, pz = fused_screened_topk_plain(Wb, bb, h,
                                                           block_ids, k, noise)
                    torch.testing.assert_close(fv, pv, **TOL)
                    fin = torch.isfinite(pz)
                    check(torch.equal(fin, torch.isfinite(fz)),
                          "fused: logZ finiteness differs")
                    torch.testing.assert_close(fz[fin], pz[fin], **TOL)
                    ids_match("fused_screened_topk", fi, pi, fv, pv)
                    err["fused_screened_topk"] = max(
                        err["fused_screened_topk"],
                        float((fv - pv).abs().max()),
                        float((fz[fin] - pz[fin]).abs().max()))
                    if kind == "ties":
                        check(torch.equal(fv, pv) and torch.equal(fi, pi),
                              "ties: fused not exact")
                    if noise is None:
                        # fused == masked unfused kernel logits + stable
                        # top-k, bit for bit
                        uv, upos = topk_desc(row, k)
                        check(torch.equal(fv, uv) and
                              torch.equal(fi, torch.gather(word, 1, upos)),
                              f"fused != unfused (B={B}, k={k}, {kind})")
                    if B == 8:
                        check(bool((fi[-1] == n_blk * V_BLK).all()) and
                              bool((fv[-1] == NEG_INF).all()) and
                              bool(torch.isneginf(fz[-1])),
                              "all-sentinel row: wrong ids, vals or logZ")
            # the compositions, routing through the kernel
            for k in (1, 5):
                ui, uv = ops.screened_topk(Wb, bb, v, cand, h, k=k)
                fi, fv, _ = ops.screened_fused_topk(Wb, bb, v, cand, h, k=k)
                check(torch.equal(ui, fi) and torch.equal(uv, fv),
                      f"screened_fused_topk != screened_topk (B={B}, k={k})")
    # the route at zamba2-2.7b's width, B up to 130 (17 thread block
    # clusters), and an exact tie across the blocks of one cluster: t = 3
    # in block 0, t = 50 and t = 99 in later blocks; the first index wins
    g = torch.Generator().manual_seed(9)
    vz = torch.randn((R, ZD), generator=g).cuda()
    for B in (1, 4, 130):
        h = torch.randn((B, ZD), generator=g).cuda()
        route, plain = cluster_route(h, vz), cluster_route_plain(h, vz)
        scores = h @ vz.T
        s_route = scores.gather(1, route.long()[:, None])[:, 0]
        s_plain = scores.gather(1, plain.long()[:, None])[:, 0]
        ids_match("cluster_route d=2560", route, plain, s_route, s_plain)
        err["cluster_route"] = max(err["cluster_route"],
                                   float((s_route - s_plain).abs().max()))
    vt = torch.round(torch.randn((R, D), generator=g) * 2) / 2
    vt[3] = vt[50] = vt[99] = 4.0
    ht = (torch.round(torch.rand((8, D), generator=g) * 3) * 0.5 + 0.5).cuda()
    check(bool((cluster_route_plain(ht, vt.cuda()) == 3).all()) and
          bool((cluster_route(ht, vt.cuda()) == 3).all()),
          "cluster_route: a tie across blocks did not pick the first index")
    log(f"[parity] kernels match their plain versions (rtol=atol=1e-5), "
        f"fused == unfused bit for bit, ties exact (route also at d={ZD}, "
        f"B in 1, 4, 130, and tied across the blocks of a cluster); near-tie "
        f"id positions: {near_ties}; max abs err {json.dumps(err)}")
    return err


def phase_fused_split(torch, np):
    """The fused kernel's split design on the card: parity over the k, K, B
    grid, fused == unfused bit for bit at d = 500 and 2560, a tie across
    blocks, mid-row sentinels, an all-sentinel row, noise, and run-to-run
    determinism. → max abs err against the plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import (fused_parts,
                                                fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.ref import NEG_INF, topk_desc
    from repro_torch.kernels.screen import screened_logits
    err = 0.0
    near = 0
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def one(Wb, bb, h, ids, k, noise=None):
        """One call against the plain version, and (without noise) against
        the masked unfused kernel logits + stable top-k, bit for bit."""
        nonlocal err, near
        n_blk = Wb.shape[0]
        B = h.shape[0]
        fi, fv, fz = fused_screened_topk(Wb, bb, h, ids, k, noise)
        pi, pv, pz = fused_screened_topk_plain(Wb, bb, h, ids, k, noise)
        torch.testing.assert_close(fv, pv, **TOL)
        fin = torch.isfinite(pz)
        check(torch.equal(fin, torch.isfinite(fz)) and
              bool(torch.isneginf(fz[~fin]).all()), "fused split: logZ not "
              "finite where the plain one is, or not -inf elsewhere")
        torch.testing.assert_close(fz[fin], pz[fin], **TOL)
        diff = fi != pi
        if bool(diff.any()):
            rel = (fv[diff] - pv[diff]).abs() / pv[diff].abs().clamp_min(1e-30)
            check(bool((rel < 1e-5).all()), "fused split: ids differ beyond "
                  "near-ties")
            near += int(diff.sum())
        err = max(err, float((fv - pv).abs().max()),
                  float((fz[fin] - pz[fin]).abs().max()) if bool(fin.any())
                  else 0.0)
        if noise is None:
            raw = screened_logits(Wb, bb, h, ids)
            valid = ((ids >= 0) & (ids < n_blk))[..., None]
            row = torch.where(valid, raw, NEG_INF).reshape(B, -1)
            lane = torch.arange(V_BLK, device="cuda", dtype=torch.int32)
            word = torch.where(valid, ids[..., None] * V_BLK + lane,
                               n_blk * V_BLK).reshape(B, -1)
            uv, upos = topk_desc(row, k)
            check(torch.equal(fv, uv) and
                  torch.equal(fi, torch.gather(word, 1, upos)),
                  f"fused split != unfused (B={B}, K={ids.shape[1]}, k={k}, "
                  f"d={h.shape[1]})")
        return fi, fv, fz

    def sentinels(ids, n_blk):
        K = ids.shape[1]
        ids[:, K // 2] = n_blk                    # mid-row sentinels
        if K > 2:
            ids[::2, 1] = -1
        if ids.shape[0] > 1:
            ids[-1] = n_blk                       # an all-sentinel row
        return ids

    W, b = make_head(torch, 21)
    Wb, bb = ops.pack_head_blocks(W, b)
    n_blk = Wb.shape[0]
    g = torch.Generator().manual_seed(22)
    grid = [(B, K_, k) for B in (1, 4, 130) for K_ in (1, 3, 16, 200)
            for k in (1, 5, 128, 129, 130) if k <= K_ * V_BLK]
    grid += [(B, 3, 3 * V_BLK) for B in (1, 4, 130)]
    parts = set()
    for B, K_, k in grid:
        h = torch.randn((B, D), generator=g).cuda()
        ids = torch.randint(0, n_blk, (B, K_), generator=g,
                            dtype=torch.int32).cuda()
        fi, fv, fz = one(Wb, bb, h, sentinels(ids, n_blk), k)
        parts.add(fused_parts(B, K_, n_sm))
        if B > 1:
            check(bool((fi[-1] == n_blk * V_BLK).all()) and
                  bool((fv[-1] == NEG_INF).all()) and
                  bool(torch.isneginf(fz[-1])),
                  f"all-sentinel row (B={B}, K={K_}, k={k}): wrong ids, vals "
                  f"or logZ")
    # noise, and two calls bit-identical in ids, vals and logZ
    for B, k in ((4, 1), (4, 5), (130, 130)):
        h = torch.randn((B, D), generator=g).cuda()
        ids = sentinels(torch.randint(0, n_blk, (B, K), generator=g,
                                      dtype=torch.int32).cuda(), n_blk)
        gn = torch.Generator(device="cuda").manual_seed(B + k)
        noise = ops.gumbel_noise((B, K, V_BLK), gn, "cuda")
        for nz in (None, noise):
            a = one(Wb, bb, h, ids, k, nz)
            b_ = fused_screened_topk(Wb, bb, h, ids, k, nz)
            check(all(torch.equal(x, y) for x, y in zip(a, b_)),
                  f"fused split: two calls differ (B={B}, k={k})")
    # a tie across blocks: equal maxima at slot 2 row 120, slot 5 row 64 and
    # slot 9 row 3 (three parts, three slots); W = 0, so logits are biases
    Wt = torch.zeros((40 * V_BLK, 32), device="cuda")
    bt = torch.rand((40 * V_BLK,), generator=g).cuda()
    Wtb, btb = ops.pack_head_blocks(Wt, bt)
    tie_ids = torch.randperm(40, generator=g)[:K].to(torch.int32)
    tied = [(2, 120), (5, 64), (9, 3)]
    for j, lane in tied:
        btb[int(tie_ids[j]), lane] = 5.0
    want = [int(tie_ids[j]) * V_BLK + lane for j, lane in tied]
    for B in (1, 4):
        h = torch.randn((B, 32), generator=g).cuda()
        ids = tie_ids.repeat(B, 1).contiguous().cuda()
        for k in (1, 3):
            fi, fv, _ = one(Wtb, btb, h, ids, k)
            check(fi.tolist() == [want[:k]] * B and bool((fv == 5.0).all()),
                  f"fused split: tie across blocks gave {fi.tolist()}, "
                  f"want {want[:k]}")
    del W, b, Wb, bb
    # fused == unfused at zamba2-2.7b's width
    W, b = make_head(torch, 23, vocab=ZV, d=ZD)
    Wb, bb = ops.pack_head_blocks(W, b)
    n_blk = Wb.shape[0]
    for B, k in ((1, 1), (4, 1), (4, 5), (130, 130)):
        h = torch.randn((B, ZD), generator=g).cuda()
        ids = sentinels(torch.randint(0, n_blk, (B, K), generator=g,
                                      dtype=torch.int32).cuda(), n_blk)
        one(Wb, bb, h, ids, k)
    torch.cuda.synchronize()
    from repro_torch.kernels import fused_topk
    check(all(int(c.abs().sum()) == 0 for c in fused_topk._COUNTERS.values()),
          "fused split: a merge counter was left non-zero")
    log(f"[parity] fused split (parts per tile {sorted(parts)}): {len(grid)} "
        f"(B, K, k) cases at d={D} with mid-row and all-sentinel rows, "
        f"fused == unfused bit for bit at d={D} and d={ZD}, tie across slots "
        f"and parts -> lowest position, noise, two calls bit-identical in "
        f"ids, vals and logZ, counters left zero; near-tie id positions vs "
        f"plain: {near}; max abs err {err:.3g}")
    return err


def unfused_topk(Wb, bb, h, block_ids, k):
    """The unfused composition the fused kernel replaces: the gather kernel,
    the sentinel mask, a stable top-k and a logsumexp."""
    import torch
    from repro_torch.kernels.ref import NEG_INF, topk_desc
    from repro_torch.kernels.screen import screened_logits
    n_blk = Wb.shape[0]
    B = h.shape[0]
    raw = screened_logits(Wb, bb, h, block_ids)
    valid = ((block_ids >= 0) & (block_ids < n_blk))[..., None]
    logz = torch.logsumexp(torch.where(valid, raw, -torch.inf).reshape(B, -1),
                           dim=-1)
    vals, pos = topk_desc(torch.where(valid, raw, NEG_INF).reshape(B, -1), k)
    lane = torch.arange(V_BLK, dtype=torch.int32, device=h.device)
    word = torch.where(valid, block_ids[..., None] * V_BLK + lane,
                       n_blk * V_BLK).reshape(B, -1)
    return torch.gather(word, 1, pos), vals, logz


def l2s_rows(torch, np, timer, Wb, bb, v, screen, B, k, seed):
    """Timing rows of the three L2S kernels at one decode shape: each
    kernel in turns with its plain version (and, for the route, the one
    PyTorch call), and its bound at these inputs."""
    from repro_torch.kernels import fused_topk
    from repro_torch.kernels.fused_topk import (fused_screened_topk,
                                                fused_screened_topk_plain)
    from repro_torch.kernels.route import cluster_route, cluster_route_plain
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    n_blk, _, d = Wb.shape
    r, Ks = v.shape[0], screen.shape[1]
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((B, d), generator=g).cuda()
    block_ids = screen[cluster_route_plain(h, v).long()].contiguous()
    valid = block_ids < n_blk
    safe_u = int(torch.unique(torch.where(valid, block_ids, 0)).numel())
    valid_u = int(torch.unique(block_ids[valid]).numel())
    n_valid = int(valid.sum())
    tile_bytes = V_BLK * (d + 1) * 4
    t = timer.turns({"library_ms": lambda: torch.argmax(h @ v.T, dim=-1),
                     "ms": lambda: cluster_route(h, v),
                     "plain_ms": lambda: cluster_route_plain(h, v)})
    rows = {"cluster_route": dict(
        t, bound=bound_ms(4 * (B * d + r * d + B), 2 * B * r * d))}
    t = timer.turns({"ms": lambda: screened_logits(Wb, bb, h, block_ids),
                     "plain_ms": lambda: screened_logits_plain(Wb, bb, h,
                                                               block_ids)})
    rows["screened_logits"] = dict(
        t, library_ms=None,
        bound=bound_ms(safe_u * tile_bytes + 4 * (B * d + B * Ks) +
                       4 * B * Ks * V_BLK, 2 * B * Ks * V_BLK * d))
    t = timer.turns({"ms": lambda: fused_screened_topk(Wb, bb, h, block_ids,
                                                       k),
                     "plain_ms": lambda: fused_screened_topk_plain(
                         Wb, bb, h, block_ids, k),
                     "unfused_ms": lambda: unfused_topk(Wb, bb, h, block_ids,
                                                        k)})
    rows["fused_screened_topk"] = dict(
        t, library_ms=None,
        bound=bound_ms(valid_u * tile_bytes + 4 * (B * d + B * Ks) +
                       4 * (2 * B * k + B), 2 * n_valid * V_BLK * d))
    if (B, k, Ks) == (4, 1, K):
        # the wrapper picks P parts per tile; time each P in turns
        sweep = timer.turns({f"P={p}": (lambda p=p: fused_topk._launch(
            Wb, bb, h, block_ids, k, None, p)) for p in (1, 2, 4, 8)})
        log(f"[timing] d={d} B={B} K={Ks} k={k} fused_screened_topk by parts "
            f"per tile (the wrapper picks P="
            f"{fused_topk.fused_parts(B, Ks, timer.n_sm)}): " +
            ", ".join(f"{n} {x:.5f} ms" for n, x in sweep.items()))
    for name, row in rows.items():
        lib = row["library_ms"]
        extra = (f", unfused {row['unfused_ms']:.5f} ms (ratio "
                 f"{row['unfused_ms'] / row['ms']:.2f})"
                 if "unfused_ms" in row else "")
        log(f"[timing] d={d} B={B} K={Ks} k={k} {name}: {row['ms']:.5f} ms, "
            f"plain {row['plain_ms']:.5f} ms, library "
            f"{'null' if lib is None else f'{lib:.5f}'} ms{extra}, bound "
            f"{row['bound'][0]:.7f} ms ({row['bound'][1]}); distinct tiles "
            f"{valid_u}")
    return rows


def phase_timing(torch, np):
    """→ ({kernel: timing dict} at the LSTM greedy decode step's shape
    (d = 500, B = 4, K = 16, k = 1), {kernel: timing dict} of the route and
    the fused kernel at zamba2-2.7b's width (d = 2560, same B, K, k)),
    after a table over B ∈ {1, 4, 8} and the full-cover screen's K = 200.
    CUDA-event medians with a cold L2, each kernel in turns with its plain
    version and the library call."""
    from repro_torch.kernels import ops
    timer = Timer(torch)
    W, b = make_head(torch, 1)
    Wb, bb = ops.pack_head_blocks(W, b)
    n_blk = Wb.shape[0]
    cand = torch.from_numpy(make_screen_blocks(np, 3, n_blk)).cuda()
    v = torch.randn((R, D), generator=torch.Generator().manual_seed(5)).cuda()
    full = torch.full((R, -(-n_blk // 8) * 8), n_blk, dtype=torch.int32,
                      device="cuda")
    full[:, :n_blk] = torch.arange(n_blk, device="cuda", dtype=torch.int32)
    out = {}
    for i, (B, k, screen) in enumerate(((1, 5, cand), (4, 1, cand),
                                        (8, 5, cand), (4, 1, full))):
        rows = l2s_rows(torch, np, timer, Wb, bb, v, screen, B, k, 50 + i)
        if (B, k, screen.shape[1]) == (4, 1, K):
            out = rows
    del W, b, Wb, bb
    W, b = make_head(torch, 11, vocab=ZV, d=ZD)
    Wb, bb = ops.pack_head_blocks(W, b)
    cand = torch.from_numpy(make_screen_blocks(np, 12, Wb.shape[0])).cuda()
    vz = torch.randn((R, ZD), generator=torch.Generator().manual_seed(13))
    wide = l2s_rows(torch, np, timer, Wb, bb, vz.cuda(), cand, 4, 1, 60)
    return out, {k: wide[k] for k in ("cluster_route", "fused_screened_topk")}


def phase_e2e(torch, np):
    from repro_torch import heads
    from repro_torch.configs import V_BLK as CFG_V_BLK, get_config
    from repro_torch.core.screening import candidates_to_padded
    from repro_torch.interop import screen_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine

    cfg = get_config("nmt-deen-lstm")
    check(cfg.d_model == D and cfg.vocab_size == V and CFG_V_BLK == V_BLK,
          "config drifted from the smoke's shapes")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cuda")
    rng = np.random.default_rng(0)
    n_blk = -(-V // V_BLK)
    v = rng.standard_normal((R, D)).astype(np.float32)
    cand = make_screen_blocks(np, 6, n_blk)
    screen = screen_from_numpy(v, cand, (cand < n_blk).sum(1), V, V_BLK)
    full_idx, full_len = candidates_to_padded(np.ones((R, n_blk), bool), V,
                                              block=V_BLK)
    full = screen_from_numpy(v, full_idx, full_len, V, V_BLK)
    prompts = rng.integers(0, V, (4, 8))
    eng = DecodeEngine(model, params, screen=screen, device="cuda")
    eng_full = DecodeEngine(model, params, screen=full, device="cuda")
    unfused = heads.get("screened-cuda", W=eng.W, b=eng.b, screen=eng.screen,
                        fused=False)
    for e in (eng, eng_full):                      # warm-up: loads, caches
        e.generate(prompts, 2, head="screened-cuda")
        e.generate(prompts, 2, head="exact")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    new = 16
    ops.reset_launches()
    exact, t_exact = timed(lambda: eng.generate(prompts, new, head="exact"))
    scr, t_scr = timed(lambda: eng.generate(prompts, new,
                                            head="screened-cuda"))
    scr_u = eng.generate(prompts, new, head=unfused)
    samp = eng.generate(prompts, new, head="screened-cuda", temperature=1.0,
                        seed=1)
    nucl = eng.generate(prompts, new, head="screened-cuda", temperature=1.0,
                        top_p=0.9, seed=2)
    beam = eng.beam_search(prompts[0], 5, new, head="screened-cuda")
    beam_x = eng.beam_search(prompts[0], 5, new, head="exact")
    f_exact = eng_full.generate(prompts, new, head="exact")
    f_scr = eng_full.generate(prompts, new, head="screened-cuda")
    launches = dict(ops.LAUNCHES)

    for name, r in (("exact", exact), ("screened-cuda", scr),
                    ("unfused", scr_u), ("sampled", samp), ("top-p", nucl)):
        check(r.tokens.shape == (4, new) and r.tokens.min() >= 0 and
              r.tokens.max() < V, f"{name}: tokens out of range")
    check(np.array_equal(scr.tokens, scr_u.tokens),
          "screened-cuda fused and unfused greedy tokens differ")
    for r in (beam, beam_x):
        check(r.tokens.shape == (1, new) and np.isfinite(r.scores).all() and
              r.tokens.max() < V, "beam search: bad result")

    # full cover: screened == exact up to the first near-tie step per row
    seq = torch.as_tensor(np.concatenate([prompts, f_exact.tokens[:, :-1]], 1),
                          device="cuda")
    with torch.inference_mode():
        h, _ = model.forward(eng.params, {"tokens": seq})
        logits = model.logits(eng.params, h[:, prompts.shape[1] - 1:])
    top2 = logits.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    near = []
    for i in range(len(prompts)):
        bad = np.nonzero(f_scr.tokens[i] != f_exact.tokens[i])[0]
        if bad.size:
            t = int(bad[0])
            check(gaps[i, t] < GAP,
                  f"full cover: row {i} differs at step {t} with exact top-2 "
                  f"gap {gaps[i, t]:.3g} >= {GAP}")
            near.append((i, t, float(gaps[i, t])))
    check(all(launches[k] > 0 for k in L2S_KERNELS),
          f"a kernel never launched on the main path: {launches}")
    # where the device time of the same greedy screened-cuda decode goes
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, new, head="screened-cuda")
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    if busy_ms > 0:
        log(f"[e2e] profile, greedy 4x{new} screened-cuda: device busy "
            f"{busy_ms:.3f} ms of {t_scr * 1e3:.3f} ms unprofiled wall (idle "
            f"share {1 - busy_ms / (t_scr * 1e3):.3f}); "
            f"{fused_share(kern, busy_ms)}; top kernels: " +
            "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                      f" x{e.count}" for e in top))
    else:
        log("[e2e] profile: the profiler saw no device time (not measured)")
    tok = 4 * new
    log(f"[e2e] nmt-deen-lstm d={D} V={V} on DecodeEngine(device='cuda'): "
        f"greedy 4x{new} exact {tok / t_exact:.1f} tok/s, screened-cuda "
        f"{tok / t_scr:.1f} tok/s (host clock, information only); fused == "
        f"unfused tokens; sampled/top-p/beam(5) in range, beam score "
        f"{float(beam.scores[0]):.4f} (exact head {float(beam_x.scores[0]):.4f})")
    log(f"[e2e] full-cover screen (K={full.c_max}): screened-cuda == exact "
        f"greedy tokens; rows that diverge after a near-tie step "
        f"(row, step, gap): {near}; steps with exact gap < {GAP}: "
        f"{int((gaps < GAP).sum())} of {gaps.size}")
    log(f"[e2e] launches on the main path: "
        f"{json.dumps({k: launches[k] for k in L2S_KERNELS})}")
    return launches


def ssd_inputs(torch, shape, seed):
    """Seeded SSD inputs on the card: xw, B, C normal; l a cumulative sum of
    negative log decays, as softplus(dt)·A gives them."""
    B, nc, Q, H, P, G, N = shape
    g = torch.Generator().manual_seed(seed)
    xw = torch.randn((B, nc, Q, H, P), generator=g)
    Bm = torch.randn((B, nc, Q, G, N), generator=g)
    Cm = torch.randn((B, nc, Q, G, N), generator=g)
    l = -torch.cumsum(torch.rand((B, nc, Q, H), generator=g) * 0.05, dim=2)
    return [a.cuda() for a in (xw, Bm, Cm, l)]


def ssd_bound(shape):
    """(bytes, flops) the SSD intra-chunk function needs: inputs read and
    outputs written once; C·B and M·x over the causal half (s <= t) and the
    chunk state, two flops per multiply-add."""
    B, nc, Q, H, P, G, N = shape
    nbytes = 4 * (2 * B * nc * Q * H * P + 2 * B * nc * Q * G * N +
                  B * nc * Q * H + B * nc * H * N * P)
    pairs = Q * (Q + 1) // 2
    flops = B * nc * H * (2 * pairs * (N + P) + 2 * Q * N * P)
    return nbytes, flops


def phase_ssm_kernels(torch):
    """SSD and cache-update kernels vs their plain versions on the card,
    then timed. → ({kernel: max abs err}, {kernel: timing dict})."""
    from repro_torch.kernels.cache_update import (cache_kv_update,
                                                  cache_slot_update,
                                                  cache_slot_update_plain)
    from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
    err = {"ssd_intra": 0.0, "cache_slot_update": 0.0}
    for i, (label, shape) in enumerate(SSD_SHAPES.items()):
        args = ssd_inputs(torch, shape, 10 + i)
        (y, S), (py, pS) = ssd_intra(*args), ssd_intra_plain(*args)
        torch.cuda.synchronize()
        rel = {}
        for name, got, want in (("y", y, py), ("S", S, pS)):
            diff = float((got - want).abs().max())
            rel[name] = diff / float(want.abs().max())
            err["ssd_intra"] = max(err["ssd_intra"], diff)
            check(rel[name] <= SSD_REL_TOL,
                  f"ssd_intra {label}: {name} relative error {rel[name]:.3g}")
        log(f"[ssm] ssd_intra {label} (B, nc, Q, H, P, G, N) = {shape}: "
            f"max |kernel - plain| / max |plain|: y {rel['y']:.3g}, S "
            f"{rel['S']:.3g} (<= {SSD_REL_TOL})")
    B, S_, KV, hd = CACHE_SHAPE
    g = torch.Generator().manual_seed(20)
    slots = (0, 127, S_ // 2, S_ - 1, S_ + 5,
             torch.tensor([0, 127, S_ + 5, -1], dtype=torch.int32).cuda())
    for dtype in (torch.float32, torch.bfloat16):
        cache = torch.randn(CACHE_SHAPE, generator=g).to("cuda", dtype)
        upd = torch.randn((B, KV, hd), generator=g).to("cuda", dtype)
        cache_v = torch.randn(CACHE_SHAPE, generator=g).to("cuda", dtype)
        upd_v = torch.randn((B, KV, hd), generator=g).to("cuda", dtype)
        for slot in slots:
            got = cache_slot_update(cache.clone(), upd, slot)
            want = cache_slot_update_plain(cache.clone(), upd, slot)
            check(torch.equal(got, want),
                  f"cache_slot_update {dtype} slot {slot}: not bit-identical")
            gk, gv = cache_kv_update(cache.clone(), upd, cache_v.clone(),
                                     upd_v, slot)
            check(torch.equal(gk, want) and
                  torch.equal(gv, cache_slot_update_plain(cache_v.clone(),
                                                          upd_v, slot)),
                  f"cache_kv_update {dtype} slot {slot}: not bit-identical")
    log(f"[ssm] cache_slot_update (B, S, KV, hd) = {CACHE_SHAPE}: bit-identical "
        f"to its plain version, float32 and bfloat16, slots 0, 127, S/2, S-1, "
        f"S+5 and per-row [0, 127, S+5, -1]; the K and V pair in one launch "
        f"(cache_kv_update) bit-identical to two plain writes at the same "
        f"slots")

    timer = Timer(torch)
    out = {}
    for label in ("zamba2", "mamba2"):
        shape = SSD_SHAPES[label]
        args = ssd_inputs(torch, shape, 30)
        t = timer.turns({"ms": lambda: ssd_intra(*args),
                         "plain_ms": lambda: ssd_intra_plain(*args)})
        t.update(library_ms=None, bound=bound_ms(*ssd_bound(shape)))
        log(f"[timing] ssd_intra {label} {shape}: {t['ms']:.5f} ms, plain "
            f"{t['plain_ms']:.5f} ms, library null, bound {t['bound'][0]:.5f} "
            f"ms ({t['bound'][1]}; bytes {ssd_bound(shape)[0]}, flops "
            f"{ssd_bound(shape)[1]})")
        if label == "zamba2":
            out["ssd_intra"] = t
    ck, cv = (torch.randn(CACHE_SHAPE, generator=g).cuda() for _ in range(2))
    uk, uv = (torch.randn((B, KV, hd), generator=g).cuda() for _ in range(2))
    rows = torch.arange(B, device="cuda")
    slot = ZT + 5

    def library():
        ck[rows, slot] = uk
        cv[rows, slot] = uv

    def singles():
        cache_slot_update(ck, uk, slot)
        cache_slot_update(cv, uv, slot)

    def plain():
        cache_slot_update_plain(ck, uk, slot)
        cache_slot_update_plain(cv, uv, slot)

    t = timer.turns({"library_ms": library,
                     "ms": lambda: cache_kv_update(ck, uk, cv, uv, slot),
                     "two_single_ms": singles, "plain_ms": plain,
                     "single_ms": lambda: cache_slot_update(ck, uk, slot)})
    t["bound"] = bound_ms(2 * 2 * B * KV * hd * 4, 0)
    log(f"[timing] cache_kv_update (K and V) {CACHE_SHAPE} f32: {t['ms']:.5f} "
        f"ms, two single launches {t['two_single_ms']:.5f} ms, one single "
        f"launch {t['single_ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, "
        f"library (cache[rows, slot] = upd, twice) {t['library_ms']:.5f} ms, "
        f"bound {t['bound'][0]:.7f} ms ({t['bound'][1]})")
    out["cache_slot_update"] = t
    return err, out


def phase_e2e_hybrid(torch, np):
    """Full-width zamba2-2.7b on DecodeEngine(device="cuda"). → launches."""
    from repro_torch import heads
    from repro_torch.configs import get_config
    from repro_torch.core.screening import candidates_to_padded
    from repro_torch.interop import screen_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving import DecodeEngine
    from repro_torch.tree import tree_leaves

    cfg = get_config("zamba2-2.7b")
    d, vocab = cfg.d_model, cfg.vocab_size
    check((d, vocab) == (ZD, ZV), "config drifted from the smoke's shapes")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[hybrid] zamba2-2.7b: {n_params} float32 parameters drawn on the "
        f"card in {time.perf_counter() - t0:.1f} s; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    rng = np.random.default_rng(1)
    n_blk = -(-vocab // V_BLK)
    v = rng.standard_normal((R, d)).astype(np.float32)
    cand = make_screen_blocks(np, 8, n_blk)
    screen = screen_from_numpy(v, cand, (cand < n_blk).sum(1), vocab, V_BLK)
    full_idx, full_len = candidates_to_padded(np.ones((R, n_blk), bool), vocab,
                                              block=V_BLK)
    full = screen_from_numpy(v, full_idx, full_len, vocab, V_BLK)
    prompts = rng.integers(0, vocab, (ZB, ZT))
    eng = DecodeEngine(model, params, screen=screen, max_len=ZMAX,
                       device="cuda")
    eng_full = DecodeEngine(model, params, screen=full, max_len=ZMAX,
                            device="cuda")
    unfused = heads.get("screened-cuda", W=eng.W, b=eng.b, screen=eng.screen,
                        fused=False)
    for e in (eng, eng_full):                      # warm-up: loads, caches
        e.generate(prompts[:, :16], 2, head="screened-cuda")
        e.generate(prompts[:, :16], 2, head="exact")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    with torch.inference_mode():                   # prefill alone, host clock
        cache = model.init_cache(ZB, ZMAX, device="cuda")
        tokens = torch.as_tensor(prompts, device="cuda")
        _, t_prefill = timed(lambda: model.prefill(eng.params,
                                                   {"tokens": tokens}, cache))
    del cache

    ops.reset_launches()
    exact, t_exact = timed(lambda: eng.generate(prompts, ZNEW, head="exact"))
    scr, t_scr = timed(lambda: eng.generate(prompts, ZNEW,
                                            head="screened-cuda"))
    scr_u = eng.generate(prompts, ZNEW, head=unfused)
    beam, t_beam = timed(lambda: eng.beam_search(prompts[0], 4, ZNEW,
                                                 head="screened-cuda"))
    f_exact = eng_full.generate(prompts, ZNEW, head="exact")
    f_scr = eng_full.generate(prompts, ZNEW, head="screened-cuda")
    launches = dict(ops.LAUNCHES)
    prefills = 6

    for name, r in (("exact", exact), ("screened-cuda", scr),
                    ("unfused", scr_u)):
        check(r.tokens.shape == (ZB, ZNEW) and r.tokens.min() >= 0 and
              r.tokens.max() < vocab, f"hybrid {name}: tokens out of range")
    check(np.array_equal(scr.tokens, scr_u.tokens),
          "hybrid: screened-cuda fused and unfused greedy tokens differ")
    check(beam.tokens.shape == (1, ZNEW) and np.isfinite(beam.scores).all()
          and beam.tokens.max() < vocab, "hybrid beam search: bad result")
    check(launches["ssd_intra"] == cfg.num_layers * prefills,
          f"ssd_intra launched {launches['ssd_intra']} times, expected "
          f"{cfg.num_layers} x {prefills} prefills")
    check(all(n > 0 for n in launches.values()),
          f"a kernel never launched on the hybrid path: {launches}")
    # K and V in one launch, once per shared-attention application per
    # decode step (ZNEW - 1 steps after each prefill)
    n_attn = cfg.num_layers // cfg.hybrid_shared_period
    check(launches["cache_slot_update"] == n_attn * prefills * (ZNEW - 1),
          f"cache_slot_update launched {launches['cache_slot_update']} times, "
          f"expected {n_attn} x {prefills * (ZNEW - 1)} decode steps")

    # full cover: screened == exact up to the first near-tie step per row
    seq = torch.as_tensor(np.concatenate([prompts, f_exact.tokens[:, :-1]], 1),
                          device="cuda")
    with torch.inference_mode():
        h, _ = model.forward(eng.params, {"tokens": seq})
        logits = model.logits(eng.params, h[:, ZT - 1:])
    top2 = logits.topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    near = []
    for i in range(ZB):
        bad = np.nonzero(f_scr.tokens[i] != f_exact.tokens[i])[0]
        if bad.size:
            t = int(bad[0])
            check(gaps[i, t] < GAP,
                  f"hybrid full cover: row {i} differs at step {t} with exact "
                  f"top-2 gap {gaps[i, t]:.3g} >= {GAP}")
            near.append((i, t, float(gaps[i, t])))
    del h, logits

    # self-check: prefill over T tokens + n decode steps == prefill over T + n
    n = 4
    seq = torch.as_tensor(rng.integers(0, vocab, (ZB, ZT + n)), device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(ZB, ZMAX, device="cuda")
        _, cache = model.prefill(eng.params, {"tokens": seq[:, :ZT]}, cache)
        steps = []
        for i in range(n):
            h1, cache = model.decode_step(eng.params, seq[:, ZT + i], cache,
                                          ZT + i)
            steps.append(h1)
        one, _ = model.forward(eng.params, {"tokens": seq})
        want = one[:, ZT:]
        rel = float((torch.stack(steps, 1) - want).abs().max() /
                    want.abs().max())
    del cache, one
    check(rel <= 1e-3, f"prefill + decode != prefill: relative error {rel:.3g}")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, ZNEW, head="screened-cuda")
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    if busy_ms > 0:
        log(f"[hybrid] profile, greedy {ZB}x{ZT}+{ZNEW} screened-cuda: device "
            f"busy {busy_ms:.3f} ms of {t_scr * 1e3:.3f} ms unprofiled wall "
            f"(idle share {1 - busy_ms / (t_scr * 1e3):.3f}), "
            f"{sum(e.count for e in kern)} device kernels; "
            f"{fused_share(kern, busy_ms)}; top kernels: " +
            "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                      f" x{e.count}" for e in top))
    else:
        log("[hybrid] profile: the profiler saw no device time (not measured)")
    tok = ZB * ZNEW
    log(f"[hybrid] zamba2-2.7b d={d} V={vocab} on DecodeEngine(device='cuda', "
        f"max_len={ZMAX}): greedy {ZB}x{ZT}+{ZNEW} exact {t_exact:.3f} s "
        f"({tok / t_exact:.1f} tok/s), screened-cuda {t_scr:.3f} s "
        f"({tok / t_scr:.1f} tok/s), beam(4) {t_beam:.3f} s; prefill alone "
        f"{t_prefill:.3f} s, so a screened-cuda decode step takes about "
        f"{(t_scr - t_prefill) / (ZNEW - 1) * 1e3:.1f} ms (host clock, "
        f"information only); fused == unfused tokens; beam score "
        f"{float(beam.scores[0]):.4f}")
    log(f"[hybrid] full-cover screen (K={full.c_max}): screened-cuda == exact "
        f"greedy tokens; rows that diverge after a near-tie step (row, step, "
        f"gap): {near}; steps with exact gap < {GAP}: "
        f"{int((gaps < GAP).sum())} of {gaps.size}")
    log(f"[hybrid] self-check: prefill {ZT} + {n} decode steps vs prefill "
        f"{ZT + n}: max relative error of the hidden states {rel:.3g} "
        f"(<= 1e-3)")
    log(f"[hybrid] launches on the hybrid path ({prefills} prefills): "
        f"{json.dumps(launches)}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is visible; nothing to run",
              file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    resolve_device("cuda")                     # TF32 off for float32 matmuls
    kind, _ = phase_device(torch)
    phase_build(ops)
    err = phase_parity(torch, np, K)
    err["fused_screened_topk"] = max(err["fused_screened_topk"],
                                     phase_fused_split(torch, np))
    times, wide = phase_timing(torch, np)
    lstm = phase_e2e(torch, np)
    ssm_err, ssm_times = phase_ssm_kernels(torch)
    err.update(ssm_err)
    times.update(ssm_times)
    hybrid = phase_e2e_hybrid(torch, np)
    # each kernel's launches on the path it was ported for, and on both
    launches = {k: (hybrid if k in ssm_err else lstm)[k] for k in lstm}

    replaces = {"cluster_route": ("src/repro_torch/csrc/route.cu",
                                  "src/repro/kernels/route.py:49"),
                "screened_logits": ("src/repro_torch/csrc/screen.cu",
                                    "src/repro/kernels/screen.py:68"),
                "fused_screened_topk": ("src/repro_torch/csrc/fused_topk.cu",
                                        "src/repro/kernels/fused_topk.py:193"),
                "ssd_intra": ("src/repro_torch/csrc/ssd.cu",
                              "src/repro/kernels/ssd.py:70"),
                "cache_slot_update": ("src/repro_torch/csrc/cache_update.cu",
                                      "src/repro/kernels/cache_update.py:69")}
    kernels = []
    for name, (source, rep) in replaces.items():
        t = times[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": err[name], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                        "bound_by": t["bound"][1],
                        "library_ms": t["library_ms"],
                        "launches_by_path": {"nmt-deen-lstm": lstm[name],
                                             "zamba2-2.7b": hybrid[name]}})
        for key in ("unfused_ms", "single_ms", "two_single_ms"):
            if key in t:
                kernels[-1][key] = t[key]
        if name in wide:
            w = wide[name]
            kernels[-1]["at_zamba2_width"] = {
                "d": ZD, "ms": w["ms"], "plain_ms": w["plain_ms"],
                "bound_ms": w["bound"][0], "bound_by": w["bound"][1],
                "library_ms": w["library_ms"]}
            if "unfused_ms" in w:
                kernels[-1]["at_zamba2_width"]["unfused_ms"] = w["unfused_ms"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
