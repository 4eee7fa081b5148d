#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA GPU, and
check it: the L2S screened decode of the paper's LSTM (nmt-deen-lstm), the
training side (the LM trainer and Algorithm 1, fitting a screen), the
Mamba2/Zamba2 decode path (zamba2-2.7b), continuous batching (decode
streams, the scheduler and the serving launcher) on both, and the other
heads (adaptive on the fused kernel, the §4.1 baselines on the host).

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
              logZ. Then the gather kernel's split grid (a block per row,
              slot and part of the tile) at d in {30, 130, 500, 2560} x
              B in {1, 4, 8, 20} with ids random, repeated in a row,
              shared across rows, all on one cluster, sentinels mixed with
              tile 0 plus an all-sentinel row, and a beam of 4 x 5 rows,
              and the full cover: against
              its plain version (rtol = atol = 1e-5), bit for bit against
              the fused kernel's masked logits (k = K*128), the same bits
              at P = 1, 2, 4, 8, two calls bit-identical;
  4. timing   CUDA-event median times of each kernel, its plain version
              and, where one PyTorch call computes the same function, that
              call, timed in turns (library, kernel, plain, plain, kernel,
              library), L2 flushed before each call by reading 256 MB (so
              it holds clean lines, as a decode step finds it); beside
              each, its bound (bytes over 3.35 TB/s or float32 flops over
              67 TFLOP/s, the larger; the gather kernels' bytes count each
              distinct tile once); the L2S kernels at d = 500 and at
              zamba2's d = 2560; the fused kernel also beside the unfused
              composition (screened_logits + torch.where + stable top-k +
              logsumexp, "unfused_ms"); both gather kernels at B = 4,
              K = 16, k = 1 once more under each flush in turns (reading,
              zeroing, the earlier flush, zeroing, reading); each tile cut
              into P = 1, 2, 4 and 8 parts for the fused kernel there, and
              for screened_logits at every shape it is timed (P = 1 is its
              grid before the split) and at a beam's shape (B = 20 rows in
              4 groups of 5, one cluster each, K = 16, d = 500 and 2560,
              timed with its bound);
  5. e2e      full-width nmt-deen-lstm (random weights from a seeded
              torch.Generator) on DecodeEngine(device="cuda"), whose decode
              steps are CUDA graph replays: greedy
              4 prompts × 16 tokens through exact and screened-cuda (fused
              and unfused), sampled decode (Gumbel-max and top-p), beam
              search (beam 5), and a full-cover screen whose screened-cuda
              tokens must equal the exact head's except after a step whose
              exact top-2 gap is below 1e-4. Launch counters are reset just
              before and read just after: every kernel must have launched;
              a profile of the fused greedy decode; the unfused greedy and
              top-p decodes, counted from zero, must launch screened_logits
              once a step (profiled for its device time);
     graph    on a fresh engine over the same model: greedy 4 x 16, sampled
              (T = 1 on each head, top-p 0.9 on screened-cuda) and beam 5
              through exact and screened-cuda fused and unfused (the latter
              registered as "screened-cuda-unfused"), first with the step
              bodies run eagerly (repro_torch.testing), then through the
              engine's graphs: tokens and beams bit-identical, launch
              counts (each side from zero) equal, sampled tokens equal to
              the head's own sample(h, generator=...) draws, one graph per
              (head, kind); prints compiled_step_counts, the launches per replay,
              the memory the graph pools add, and graph against eager
              host-clock tokens/s, median decode step and profiled idle
              share with the port's kernels' device time per launch;
     serve    16 ServeRequests (greedy and sampled, k = 1 and 5, prompts of
              8 and 12 tokens) routed by a CostAwarePolicy over exact and
              screened-cuda fused and unfused, one with an explicit head,
              through DecodeEngine.serve_batch: greedy results equal solo
              generate calls, and a second identical serve_batch adds no
              graph;
     train    the training side on full-width nmt-deen-lstm (seeded random
              init): the synthetic Zipf-Markov corpus (V = 25,000, 64
              successors; its host build time printed); one train step on
              the card against the same step on the CPU (gradients within
              1e-4 of the largest |g|, loss and gnorm within rtol 1e-5);
              300 steps of 32 x 64 tokens (lr 2e-3, warmup 20, cosine):
              the mean loss of the last 20 steps below the first 20's,
              every gnorm finite; s/step and peak device memory;
     l2s      Algorithm 1 on the trained LM: 100,000 contexts with their
              exact top-5 (90,000 to fit, 10,000 held out), fit_l2s (r =
              100, budget 1,024 words, 128-word blocks, 4 rounds x 200
              v-steps of 512) and the k-means-only ablation on the card,
              each round's loss, Lbar, coverage and c-/v-step times; the
              route kernel's clusters give back the fit's coverage (rows
              whose top-2 cluster scores differ by < 1e-5 relative aside);
              on the held-out rows screened-cuda fused == unfused ids, ==
              the plain block screened head (sentinels mapped) except rows
              whose top-k gap is < 1e-5; P@1 / P@5 against exact for L2S
              and k-means only, Lbar and the analytic speedup; greedy 4 x 16
              through exact and screened-cuda on DecodeEngine with the
              fitted screen (token agreement); launches of the evaluation
              and decode, counted from zero, with route and fused top-k
              launched; exact against screened-cuda head times (CUDA
              events) at B = 1 and B = 10,000;
     stream   on the trained LM and fitted screen: one screened-cuda
              DecodeStream of width 8, 12 requests (prompts of 8 and 12
              tokens, 4 to 24 new) joining at ticks 0, 0, 1, 3, 3, 5, ...:
              tokens equal solo generate except after a step whose top-2
              gap (route or candidate logits) is below 1e-4 (counted); a
              re-run bit-identical and adding no graph (one per (head,
              kind) at width 8); a width-1 sampled stream equal to solo
              sampled generate bit for bit;
     sched    on the same engine: ContinuousScheduler(max_slots=8,
              max_streams=4, LogicalClock) over 48 requests, 2 a tick,
              tiers round-robin (TierPolicy realtime -> screened-cuda,
              standard -> screened-cuda-unfused, else exact), a quarter
              sampled (T = 0.9, top-p 0.95), BudgetAdmission at 4x the
              catalog's largest flops_per_query: greedy results equal solo
              generate under the gap rule, a second identical run adds no
              graph and gives the same results bit for bit, the three L2S
              kernels launched (from zero), a profiled run (device calls ==
              counted launches; idle share); then 2 transient step faults on
              screened-cuda retried (retries == 2) bit-identical to the
              fault-free drain, and a permanent fault tripping the breaker
              and falling back to exact; prints the ServerStats funnel,
              p50 / p95 (logical clock) and host-clock tok/s;
     heads    on the trained LM and fitted screen: the adaptive head from
              the training tokens' unigram counts (shortlist 2048, 4 tails:
              16 short tiles, tails of 5,738 words in 45 tiles, 196 tiles),
              fused == unfused ids and values bit for bit on the 10,000
              held-out rows, P@1 / P@5 against exact, its descent rate
              beside the cost model's p_descend, and shortlist = L == exact
              except rows whose exact top-k gap is below 1e-5 (counted); the
              §4.1 baselines (svd, shortlist, greedy-mips, lsh-mips,
              pca-mips) and screened-cpu at the reference's defaults on
              1,000 held-out rows on the host: P@1 / P@5, flops_per_query,
              host ms a query, and full-rank svd == exact under the same
              rule on 200 of them; DecodeEngine through adaptive (graphs):
              greedy 4 x 16 == its eager body and == the unfused head,
              two fused top-k launches a token (from zero, held to the
              profiler's device calls), sampled == the head's own draws,
              beam 5 == eager; the host heads svd (full rank, == exact)
              and screened-cpu (== screened-cuda) between graph replays,
              and a greedy-mips stream of width 4 with 4 joins (== solo
              generate), tokens under the gap rule; a second identical
              run adds no graph; one step's head (next(h), B = 4) of
              exact, screened-cuda and adaptive timed in turns with its
              bound;
     serve-cli python -m repro_torch.launch.serve --arch nmt-deen-lstm --l2s
              --scheduler --log-jsonl ... --train-steps 50 --requests 12 on
              the card returns 0 and every JSONL record parses; bad flags
              return 2;
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
              kernel's share of device time); then the graph phase on a
              fresh engine (greedy 4 x 512 + 32 and beam 4, no sampling),
              with the same exact launch counts, and each kernel's launch
              cost at its decode shape: one eager launch, a one-launch
              graph and a graph of 9 launches, in turns under the timer;
     stream   on the same zamba2-2.7b: one screened-cuda stream of width 4,
              prompts of 512, 384, 256 and 100 tokens joining at ticks 0, 3,
              7 and 12 (per-row positions), 32 new each: ssd_intra 54 times
              a join, the K/V cache pair 9 times a step; tokens equal solo
              generate under the gap rule; one transient fault after every
              row joined gives the fault-free tokens and cache (K/V, SSM
              states, conv tails) bit for bit; the time of the step's
              rollback snapshot and of a join's splice;
     heads    adaptive on the same zamba2-2.7b (tiers by weight-row norm,
              shortlist 2048, 4 tails): greedy 4 x 512 + 32 through graphs,
              fused == unfused tokens, launches counted from zero (two
              fused top-k a token, 54 SSD, 9 cache a step) and held to the
              profiler; shortlist = L == exact under the gap rule; the head
              steps timed at d = 2560 as at d = 500;
     Every profile (e2e, hybrid, graph) holds the device calls the
              profiler counts for each port kernel equal to the launches
              its wrapper counted in the same call (graph replays add
              the count their capture recorded).
  8. a JSON line {"kernels": [...]} (each kernel with its launches on the
              path it was ported for and, in "launches_by_path", on each
              path: the two e2e paths, their graph phases, serve, the
              fitted screen's "nmt-deen-lstm l2s-fit", the streams
              ("nmt-deen-lstm stream", "zamba2-2.7b stream"),
              "nmt-deen-lstm scheduler", "nmt-deen-lstm heads" and
              "zamba2-2.7b adaptive"; its
              "launch_cost_ms" eager, in a graph and per launch in a graph
              of 9;
              the three L2S kernels also "at_zamba2_width"; the gather
              kernel "at_beam_shape"; the fused kernel "unfused_ms" and
              "adaptive_step" (the [heads] step times and bounds); the
              cache update's times are the K and V pair's, with "single_ms"
              of one single-cache launch)
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

T_START = time.perf_counter()
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
    overhead does not enter the measurement.

    The flush reads a 256 MB buffer (a sum into a preallocated scalar), so
    the timed call finds L2 full of clean lines, as a decode step finds it
    after the step before. ``dirty=True`` flushes by zeroing the buffer
    instead (the earlier timer): the call then also pays for writing
    up to 50 MB of dirty lines back to device memory."""

    def __init__(self, torch, reps=30, dirty=False):
        self.torch = torch
        self.reps = reps
        self.dirty = dirty
        self.flush = torch.zeros(256 * 2 ** 20 // 4, device="cuda")
        self.total = torch.zeros((), device="cuda")
        self.n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def _flush(self):
        if self.dirty:
            self.flush.zero_()
        else:
            self.torch.sum(self.flush, dim=0, out=self.total)

    def __call__(self, fn):
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(self.reps):
            self._flush()
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


# each port kernel's device symbols, as the profiler names them
KERNEL_NAMES = {"cluster_route": ("route_kernel",),
                "screened_logits": ("screened_logits_kernel",),
                "fused_screened_topk": ("fused_topk_kernel",),
                "ssd_intra": ("ssd_intra_kernel",),
                "cache_slot_update": ("cache_kv_update_kernel",
                                      "cache_slot_update_kernel")}


def kernel_events(kern, name):
    """The profiler's events of the port kernel ``name``."""
    return [e for e in kern if any(sym in e.key for sym in KERNEL_NAMES[name])]


def profile_counted(torch, tag, fn):
    """Profile one call of ``fn`` → its device kernels' events. The call
    count the profiler gives each port kernel must equal the launches its
    wrapper counted in the same call (a graph replay adds the count its
    capture recorded): the counts the launch checks read are the device's.
    A profiler that sees no kernel fails this too. The profiler's trace of
    a long, host-bound call can lose kernel records (seen once in the
    scheduler's drain of 25,000 kernels: every kernel short by a quarter);
    when it saw fewer calls of every port kernel than were counted, the
    call is profiled once more, its counts undone first, and that second
    profile must agree."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")]
        counted = {k: ops.LAUNCHES[k] - before[k] for k in KERNEL_NAMES}
        seen = {k: sum(e.count for e in kernel_events(kern, k))
                for k in KERNEL_NAMES}
        if (attempt == 2 or seen == counted or
                any(seen[k] > counted[k] for k in KERNEL_NAMES)):
            break
        log(f"{tag} profile: the trace holds fewer device calls {seen} than "
            f"the wrappers counted {counted} (records lost); profiling the "
            f"call once more")
        ops.LAUNCHES.update(before)
    check(seen == counted, f"{tag} profile: the device ran the port's kernels "
          f"{seen} times, their wrappers counted {counted}")
    log(f"{tag} profile: device calls == counted launches {json.dumps(seen)}")
    return kern


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
        parts.add(fused_parts(B, K_, n_sm, k, D))
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


def phase_screen_grid(torch, np):
    """The gather kernel's split grid on the card: each case against the
    plain version (rtol = atol = 1e-5) and bit for bit against the fused
    kernel's masked logits (k = K*128, so every logit is compared), the
    same bits at P = 1, 2, 4, 8 parts per tile, and two calls
    bit-identical. → max abs err against the plain version."""
    from repro_torch.kernels import ops, screen
    from repro_torch.kernels.fused_topk import fused_screened_topk
    from repro_torch.kernels.ref import NEG_INF, topk_desc
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    from repro_torch.testing import screen_id_patterns
    err, cases = 0.0, 0
    g = torch.Generator().manual_seed(40)

    def one(label, Wb, bb, h, ids):
        nonlocal err, cases
        n_blk = Wb.shape[0]
        B, K_ = ids.shape
        got = screened_logits(Wb, bb, h, ids)
        want = screened_logits_plain(Wb, bb, h, ids)
        torch.testing.assert_close(got, want, **TOL)
        check(torch.equal(got, screened_logits(Wb, bb, h, ids)),
              f"screened_logits {label}: two calls differ")
        for p in (1, 2, 4, 8):
            check(torch.equal(got, screen._launch(Wb, bb, h, ids, p)),
                  f"screened_logits {label}: P={p} gives other bits")
        valid = ((ids >= 0) & (ids < n_blk))[..., None]
        row = torch.where(valid, got, NEG_INF).reshape(B, -1)
        lane = torch.arange(V_BLK, device="cuda", dtype=torch.int32)
        word = torch.where(valid, ids[..., None] * V_BLK + lane,
                           n_blk * V_BLK).reshape(B, -1)
        fi, fv, _ = fused_screened_topk(Wb, bb, h, ids, K_ * V_BLK)
        uv, upos = topk_desc(row, K_ * V_BLK)
        check(torch.equal(fv, uv) and torch.equal(fi, torch.gather(word, 1,
                                                                   upos)),
              f"screened_logits {label}: masked logits != the fused kernel's")
        err = max(err, float((got - want).abs().max()))
        cases += 1

    for d, vocab in ((30, 3000), (130, 3000), (D, V), (ZD, ZV)):
        W, b = make_head(torch, 41 + d, vocab=vocab, d=d)
        Wb, bb = ops.pack_head_blocks(W, b)
        n_blk = Wb.shape[0]
        for B in (1, 4, 8, 20):
            h = torch.randn((B, d), generator=g).cuda()
            for name, ids in screen_id_patterns(g, n_blk, B, K).items():
                one(f"d={d} B={B} {name}", Wb, bb, h, ids.cuda())
        if d == D:                                 # full cover, K = 200
            full = torch.full((4, 200), n_blk, dtype=torch.int32)
            full[:, :n_blk] = torch.arange(n_blk, dtype=torch.int32)
            one("full cover", Wb, bb, torch.randn((4, d), generator=g).cuda(),
                full.cuda())
        del W, b, Wb, bb
    log(f"[parity] screened_logits split grid: {cases} cases (d in "
        f"30, 130, {D}, {ZD}; B in 1, 4, 8, 20; ids random, repeated in a "
        f"row, shared across rows, one cluster, sentinels with tile 0 and an "
        f"all-sentinel row, a beam of 4 x 5 rows; full cover K = 200): == "
        f"plain (rtol=atol=1e-5), == the fused kernel's masked logits bit for "
        f"bit, the same bits at P = 1, 2, 4, 8, two calls bit-identical; max "
        f"abs err {err:.3g}")
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
            f"{fused_topk.fused_parts(B, Ks, timer.n_sm, k, d)}): " +
            ", ".join(f"{n} {x:.5f} ms" for n, x in sweep.items()))
        flush_compare(timer, f"d={d} B={B} K={Ks} k={k}", {
            "screened_logits": lambda: screened_logits(Wb, bb, h, block_ids),
            "fused_screened_topk": lambda: fused_screened_topk(
                Wb, bb, h, block_ids, k)})
    screen_sweep(timer, Wb, bb, h, block_ids, f"d={d} B={B} K={Ks}")
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


def flush_compare(timer, label, fns):
    """Each of ``fns`` timed once under each L2 flush, in turns (reading,
    zeroing, zeroing, reading): how much of a time was the zeroing flush's
    write-back of dirty lines."""
    got = {(name, dirty): [] for name in fns for dirty in (False, True)}
    for dirty in (False, True, True, False):
        timer.dirty = dirty
        for name, fn in fns.items():
            got[(name, dirty)].append(timer(fn))
    timer.dirty = False
    log(f"[timing] {label} L2 flush by reading (clean lines) / by zeroing "
        f"(dirty lines, the earlier timer): " + "; ".join(
            f"{name} {sum(got[(name, False)]) / 2:.5f} / "
            f"{sum(got[(name, True)]) / 2:.5f} ms" for name in fns))


def screen_sweep(timer, Wb, bb, h, ids, label):
    """screened_logits with each tile cut into P = 1, 2, 4, 8 parts, in
    turns, beside the P the wrapper's rule picks."""
    from repro_torch.kernels import screen
    B, Ks = ids.shape
    sweep = timer.turns({f"P={p}": (lambda p=p: screen._launch(
        Wb, bb, h, ids, p)) for p in (1, 2, 4, 8)})
    rule = screen.screen_parts(B, Ks, Wb.shape[2], timer.n_sm)
    log(f"[timing] {label} screened_logits by parts per tile (the wrapper "
        f"picks P={rule}; P=1 is the grid before the split): " +
        ", ".join(f"{n} {x:.5f} ms" for n, x in sweep.items()))


def beam_rows(torch, timer, Wb, bb, screen, seed):
    """The gather kernels at a beam's shape: B = 20 rows in 4 groups of 5,
    each group routed to one cluster (the hypotheses of a beam mostly share
    one), K = 16; bound by the distinct tiles. → screened_logits' timing
    dict."""
    from repro_torch.kernels.fused_topk import fused_screened_topk
    from repro_torch.kernels.screen import (screened_logits,
                                            screened_logits_plain)
    n_blk, _, d = Wb.shape
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((20, d), generator=g).cuda()
    clusters = torch.randperm(screen.shape[0], generator=g)[:4]
    ids = screen[clusters.repeat_interleave(5).cuda()].contiguous()
    B, Ks = ids.shape
    distinct = int(torch.unique(torch.where(ids < n_blk, ids, 0)).numel())
    t = timer.turns({"ms": lambda: screened_logits(Wb, bb, h, ids),
                     "plain_ms": lambda: screened_logits_plain(Wb, bb, h,
                                                               ids),
                     "fused_ms": lambda: fused_screened_topk(Wb, bb, h, ids,
                                                             5)})
    t.update(library_ms=None, bound=bound_ms(
        distinct * V_BLK * (d + 1) * 4 + 4 * (B * d + B * Ks) +
        4 * B * Ks * V_BLK, 2 * B * Ks * V_BLK * d))
    log(f"[timing] d={d} beam B={B} (4 groups of 5 rows, one cluster each) "
        f"K={Ks} screened_logits: {t['ms']:.5f} ms, plain "
        f"{t['plain_ms']:.5f} ms, bound {t['bound'][0]:.7f} ms "
        f"({t['bound'][1]}; distinct tiles {distinct} of {B * Ks}); "
        f"fused_screened_topk k=5 {t['fused_ms']:.5f} ms")
    screen_sweep(timer, Wb, bb, h, ids, f"d={d} beam B={B} K={Ks}")
    return t


def phase_timing(torch, np):
    """→ ({kernel: timing dict} at the LSTM greedy decode step's shape
    (d = 500, B = 4, K = 16, k = 1), {kernel: timing dict} of the three L2S
    kernels at zamba2-2.7b's width (d = 2560, same B, K, k), [the gather
    kernel's timing dict at the beam shape, d = 500 and 2560]), after a
    table over B ∈ {1, 4, 8} and the full-cover screen's K = 200.
    CUDA-event medians with L2 flushed (clean) before each call, each kernel
    in turns with its plain version and the library call."""
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
    beam = [beam_rows(torch, timer, Wb, bb, cand, 55)]
    del W, b, Wb, bb
    W, b = make_head(torch, 11, vocab=ZV, d=ZD)
    Wb, bb = ops.pack_head_blocks(W, b)
    cand = torch.from_numpy(make_screen_blocks(np, 12, Wb.shape[0])).cuda()
    vz = torch.randn((R, ZD), generator=torch.Generator().manual_seed(13))
    wide = l2s_rows(torch, np, timer, Wb, bb, vz.cuda(), cand, 4, 1, 60)
    beam.append(beam_rows(torch, timer, Wb, bb, cand, 65))
    return out, wide, beam


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
    kern = profile_counted(torch, "[e2e] greedy screened-cuda", lambda:
                           eng.generate(prompts, new, head="screened-cuda"))
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[e2e] profile, greedy 4x{new} screened-cuda: device busy "
        f"{busy_ms:.3f} ms of {t_scr * 1e3:.3f} ms unprofiled wall (idle "
        f"share {1 - busy_ms / (t_scr * 1e3):.3f}); "
        f"{fused_share(kern, busy_ms)}; top kernels: " +
        "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                  f" x{e.count}" for e in top))
    # the gather kernel on the paths that run it, once a step: unfused
    # greedy and top-p (counted exactly; the profile gives its device time)
    ops.reset_launches()

    def unfused_and_top_p():
        eng.generate(prompts, new, head=unfused)
        eng.generate(prompts, new, head="screened-cuda", temperature=1.0,
                     top_p=0.9, seed=2)
    kern = profile_counted(torch, "[e2e] unfused + top-p", unfused_and_top_p)
    n_scr = ops.LAUNCHES["screened_logits"]
    check(n_scr == 2 * new, f"screened_logits launched {n_scr} times on the "
          f"unfused and top-p paths, expected {2 * new}")
    ev = [e for e in kern if "screened_logits_kernel" in e.key]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    log(f"[e2e] greedy unfused + top-p 4x{new} screened-cuda: screened_logits "
        f"launched {n_scr} times; profile: screened_logits_kernel "
        f"x{sum(e.count for e in ev)}, {dev_ms:.3f} ms of device time")
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
    return launches, dict(model=model, params=eng.params, screen=screen,
                          prompts=prompts)


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

    kern = profile_counted(torch, "[hybrid] greedy screened-cuda", lambda:
                           eng.generate(prompts, ZNEW, head="screened-cuda"))
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[hybrid] profile, greedy {ZB}x{ZT}+{ZNEW} screened-cuda: device "
        f"busy {busy_ms:.3f} ms of {t_scr * 1e3:.3f} ms unprofiled wall "
        f"(idle share {1 - busy_ms / (t_scr * 1e3):.3f}), "
        f"{sum(e.count for e in kern)} device kernels; "
        f"{fused_share(kern, busy_ms)}; top kernels: " +
        "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                  f" x{e.count}" for e in top))
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
    return launches, dict(model=model, params=eng.params, screen=screen,
                          prompts=prompts)


UNFUSED = "screened-cuda-unfused"
HEADS3 = ("exact", "screened-cuda", UNFUSED)


def register_unfused():
    """The unfused screened-cuda head under a registry name of its own, so
    that routing and compiled_step_counts tell it from the fused one."""
    from repro_torch import heads

    def build(W, b, screen=None, **_):
        head = heads.ScreenedCudaHead(W, b, screen, fused=False)
        head.name = UNFUSED
        return head
    heads.register(UNFUSED, build)


def host_timed(torch, fn):
    """(fn's result, host-clock seconds of fn ending in a synchronise)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t


def median_step_ms(torch, eng, head, prompts, n, eager):
    """Median host-clock time of ``n`` greedy decode steps, each ending in
    a synchronise: graph replays, or (``eager``) the step body run as it
    is."""
    with torch.inference_mode():
        hd = eng.resolve_head(head)
        slab, h = eng._prefill(prompts, n + 1)
        slab.tok.copy_(hd.next(h))
        step = eng._greedy_step(hd)
        times = []
        for _ in range(n):
            _, t = host_timed(torch, lambda: step.body(slab) if eager
                              else eng._run(step, slab))
            times.append(t * 1e3)
    return statistics.median(times)


def device_profile(torch, tag, fn, wall_s):
    """Profile one call of ``fn`` (``profile_counted``) → (device busy ms,
    idle share against the unprofiled wall ``wall_s``, {kernel: (device ms,
    calls)} of the port's kernels, device kernels in all)."""
    kern = profile_counted(torch, tag, fn)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    ours = {}
    for name in KERNEL_NAMES:
        ev = kernel_events(kern, name)
        if ev:
            ours[name] = (sum(e.self_device_time_total for e in ev) / 1e3,
                          sum(e.count for e in ev))
    return (busy, 1 - busy / (wall_s * 1e3), ours,
            sum(e.count for e in kern))


def phase_graph(torch, np, tag, eng, prompts, new, beam, sampled):
    """[graph] on one full-width path, on a fresh engine: the eager step
    bodies (``repro_torch.testing``) and then the engine's CUDA graphs
    decode greedy (and, with ``sampled``, sampled: T = 1 on each head, and
    top-p 0.9 on screened-cuda) 4 prompts and beam search, through exact
    and screened-cuda fused and unfused. Tokens, beams and launch counts
    (each side counted from zero) must be equal, and sampled tokens equal
    the head's own ``sample`` draws; one graph per (head, kind) at this
    width. Then graph against eager: host-clock tokens/s, median step time,
    and profiled idle share and per-launch device time of the port's
    kernels, whose device calls must equal the counted launches. →
    launches of the graph runs."""
    from repro_torch.kernels import ops
    from repro_torch.testing import (eager_beam_search, eager_generate,
                                     head_sampled_generate)
    B = len(prompts)
    runs = [(name, {}) for name in HEADS3]
    if sampled:
        runs += [(name, dict(temperature=1.0, seed=21)) for name in HEADS3]
        runs.append(("screened-cuda", dict(temperature=1.0, top_p=0.9,
                                           seed=22)))

    def key(name, kw):
        return (name,) + tuple(sorted(kw.items()))

    # the slabs (static caches) of both widths are held across both sides,
    # so the memory figure below is the graph pools' own: without a graph
    # a slab lives for one call only
    with torch.inference_mode():
        slabs = [eng._slab(w) for w in {B, beam}]
    ops.reset_launches()
    eager = {key(n, kw): eager_generate(eng, prompts, new, head=n, **kw)
             for n, kw in runs}
    eager_beam = {n: eager_beam_search(eng, prompts[0], beam, new, head=n)
                  for n in HEADS3}
    torch.cuda.synchronize()
    eager_launches = dict(ops.LAUNCHES)
    torch.cuda.empty_cache()
    mem0 = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
    ops.reset_launches()
    got = {key(n, kw): eng.generate(prompts, new, head=n, **kw)
           for n, kw in runs}
    got_beam = {n: eng.beam_search(prompts[0], beam, new, head=n)
                for n in HEADS3}
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    torch.cuda.empty_cache()
    pools = torch.cuda.memory_reserved() - mem0[0]
    held = torch.cuda.memory_allocated() - mem0[1]
    del slabs

    for k, want in eager.items():
        check(np.array_equal(got[k].tokens, want.tokens),
              f"[graph] {tag} {k}: graph tokens differ from the eager step "
              f"body's")
    for n, want in eager_beam.items():
        check(np.array_equal(got_beam[n].tokens, want.tokens) and
              np.array_equal(got_beam[n].scores, want.scores),
              f"[graph] {tag} beam {n}: graph beam differs from eager")
    check(launches == eager_launches,
          f"[graph] {tag}: graph runs launched {launches}, the eager step "
          f"bodies {eager_launches}")
    for n, kw in runs:
        if kw:
            own = head_sampled_generate(eng, prompts, new, n,
                                        kw["temperature"],
                                        kw.get("top_p", 1.0), kw["seed"])
            check(np.array_equal(got[key(n, kw)].tokens, own),
                  f"[graph] {tag} {key(n, kw)}: graph-sampled tokens differ "
                  f"from the head's own sample(h, generator=...) draws")
    check(all(launches[k] > 0 for k in L2S_KERNELS),
          f"[graph] {tag}: a kernel never launched: {launches}")
    counts = eng.compiled_step_counts()
    want = {(n, kind): 1 for n in HEADS3 for kind in ("greedy", "decode")}
    if sampled:
        want.update({(n, "sample"): 1 for n in HEADS3})
        want[("screened-cuda", "sample")] = 2
    check(counts == want, f"[graph] {tag}: compiled_step_counts {counts}, "
          f"expected {want}")
    per_replay = {f"{s_key[0][0]}/{s_key[1]}" + (
        f"/T={s_key[2]},top_p={s_key[3]}" if s_key[1] == "sample" else "") +
        f"/B={w}": g.launches
        for s_key, step in eng._step_cache.items()
        for w, g in step.graphs.items()}

    name = "screened-cuda"
    _, t_graph = host_timed(torch, lambda: eng.generate(prompts, new,
                                                        head=name))
    _, t_eager = host_timed(torch, lambda: eager_generate(eng, prompts, new,
                                                          head=name))
    _, t_gx = host_timed(torch, lambda: eng.generate(prompts, new,
                                                     head="exact"))
    _, t_ex = host_timed(torch, lambda: eager_generate(eng, prompts, new,
                                                       head="exact"))
    step_g = median_step_ms(torch, eng, name, prompts, min(new, 24), False)
    step_e = median_step_ms(torch, eng, name, prompts, min(new, 24), True)
    prof_g = device_profile(torch, f"[graph] {tag} graph", lambda:
                            eng.generate(prompts, new, head=name), t_graph)
    prof_e = device_profile(torch, f"[graph] {tag} eager", lambda:
                            eager_generate(eng, prompts, new, head=name),
                            t_eager)
    tok = B * new
    log(f"[graph] {tag}: graph == eager step body, bit for bit: greedy "
        f"{B}x{new} and beam({beam}) through {', '.join(HEADS3)}" +
        (", sampled T=1 on each and top-p 0.9 on screened-cuda (same seeds; "
         "== the head's own sample draws)"
         if sampled else "") + f"; launches (graph runs == eager runs, each "
        f"from zero): {json.dumps(launches)}")
    log(f"[graph] {tag}: compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in sorted(counts.items())} }; "
        f"launches per replay: {json.dumps(per_replay)}")
    log(f"[graph] {tag}: graph pools add {pools / 2 ** 20:.1f} MiB reserved "
        f"({held / 2 ** 20:.1f} MiB of graph outputs held), after the eager "
        f"runs of the same work")
    log(f"[graph] {tag}: greedy {B}x{new} (prefill included) screened-cuda "
        f"graph {tok / t_graph:.1f} tok/s vs eager {tok / t_eager:.1f} tok/s "
        f"(exact {tok / t_gx:.1f} vs {tok / t_ex:.1f}); median decode step "
        f"(synchronised) graph {step_g:.4f} ms vs eager {step_e:.4f} ms "
        f"(host clock, information only)")
    for label, (busy, idle, ours, n_kern), wall in (
            ("graph", prof_g, t_graph), ("eager", prof_e, t_eager)):
        log(f"[graph] {tag} profile {label}, greedy screened-cuda: device "
            f"busy {busy:.3f} ms of {wall * 1e3:.3f} ms unprofiled wall "
            f"(idle share {idle:.3f}), {n_kern} device kernels; per launch: "
            + "; ".join(f"{k} {ms / n * 1e3:.2f} us x{n}"
                        for k, (ms, n) in ours.items()))
    return launches


def launch_costs(torch, np):
    """What a launch costs inside a graph: each kernel at its decode shape
    timed (clean-L2 Timer) as one eager launch, one graph replay of one
    launch, and one replay of a graph of 9 launches (per launch; the cache
    pair's 9 are one zamba2 decode step's)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cache_update import cache_kv_update
    from repro_torch.kernels.fused_topk import fused_screened_topk
    from repro_torch.kernels.route import cluster_route
    from repro_torch.kernels.screen import screened_logits
    timer = Timer(torch)
    W, b = make_head(torch, 1)
    Wb, bb = ops.pack_head_blocks(W, b)
    cand = torch.from_numpy(make_screen_blocks(np, 3, Wb.shape[0])).cuda()
    g = torch.Generator().manual_seed(9)
    v = torch.randn((R, D), generator=g).cuda()
    h = torch.randn((4, D), generator=g).cuda()
    ids = cand[cluster_route(h, v).long()].contiguous()
    ck, cv = (torch.zeros(CACHE_SHAPE, device="cuda") for _ in range(2))
    uk, uv = (torch.randn(CACHE_SHAPE[:1] + CACHE_SHAPE[2:], generator=g)
              .cuda() for _ in range(2))
    slots = torch.full((CACHE_SHAPE[0],), 300, dtype=torch.int32,
                       device="cuda")
    fns = {"cluster_route": lambda: cluster_route(h, v),
           "screened_logits": lambda: screened_logits(Wb, bb, h, ids),
           "fused_screened_topk": lambda: fused_screened_topk(Wb, bb, h, ids,
                                                              1),
           "cache_slot_update": lambda: cache_kv_update(ck, uk, cv, uv,
                                                        slots)}
    stream = torch.cuda.Stream()
    out = {}
    for name, fn in fns.items():
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        graphs = {}
        for n in (1, 9):
            graphs[n] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graphs[n], stream=stream):
                for _ in range(n):
                    fn()
        t = timer.turns({"eager": fn, "graph": graphs[1].replay,
                         "graph9": graphs[9].replay})
        out[name] = dict(eager=t["eager"], graph=t["graph"],
                         graph9=t["graph9"] / 9)
        log(f"[graph] launch cost, {name} (clean-L2 timer): eager "
            f"{t['eager']:.5f} ms, one-launch graph {t['graph']:.5f} ms, "
            f"graph of 9 {t['graph9'] / 9:.5f} ms per launch")
    return out


def phase_serve(torch, np, ctx):
    """[serve] on full-width nmt-deen-lstm: 16 ServeRequests (greedy and
    sampled, k = 1 and 5, prompts of 8 and 12 tokens, accuracy floors 0
    and 1) routed by a CostAwarePolicy over screened-cuda fused, unfused
    and exact, one with an explicit head; greedy results equal solo
    generate calls, and a second identical serve_batch adds no graph.
    → launches of the first serve_batch."""
    from repro_torch.kernels import ops
    from repro_torch.serving import CostAwarePolicy, DecodeEngine, ServeRequest
    eng = DecodeEngine(ctx["model"], ctx["params"], screen=ctx["screen"],
                       device="cuda")
    rng = np.random.default_rng(16)
    reqs = []
    for i in range(16):
        sampled = i % 4 == 1
        reqs.append(ServeRequest(
            prompt=rng.integers(0, V, 8 if i % 2 == 0 else 12),
            max_new=8 + i % 5, k=5 if i % 3 == 0 else 1,
            accuracy_floor=1.0 if i % 5 == 2 else 0.0,
            temperature=0.9 if sampled else None,
            top_p=0.95 if i == 5 else 1.0, seed=100 + i,
            head=UNFUSED if i == 15 else None))
    pol = CostAwarePolicy(["screened-cuda", UNFUSED, "exact"],
                          accuracy={UNFUSED: 0.99})
    ops.reset_launches()
    first, t_first = host_timed(torch, lambda: eng.serve_batch(reqs, pol))
    launches = dict(ops.LAUNCHES)
    counts = eng.compiled_step_counts()
    again, t_again = host_timed(torch, lambda: eng.serve_batch(reqs, pol))
    check(eng.compiled_step_counts() == counts,
          f"[serve] the second serve_batch added graphs: {counts} -> "
          f"{eng.compiled_step_counts()}")
    check(all(launches[k] > 0 for k in L2S_KERNELS),
          f"[serve] a kernel never launched: {launches}")
    heads_used = sorted({r.head for r in first})
    check(heads_used == sorted(HEADS3), f"[serve] routes {heads_used}")
    for req, a, b in zip(reqs, first, again):
        check(np.array_equal(a.tokens, b.tokens) and
              a.tokens.shape == (req.max_new,) and a.tokens.max() < V,
              "[serve] a repeated serve_batch changed a result")
        if not req.sampled:
            solo = eng.generate(req.prompt[None], req.max_new, head=a.head)
            check(np.array_equal(solo.tokens[0], a.tokens),
                  f"[serve] request for {a.head} differs from solo generate")
    groups = len({r.group_key(a.head) for r, a in zip(reqs, first)})
    log(f"[serve] nmt-deen-lstm: 16 requests in {groups} groups routed to "
        f"{ {h: sum(r.head == h for r in first) for h in heads_used} }; "
        f"greedy results == solo generate; second identical serve_batch "
        f"adds 0 graphs (compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in sorted(counts.items())} }); "
        f"serve_batch {t_first:.3f} s first (captures included), "
        f"{t_again:.3f} s again (host clock, information only); launches: "
        f"{json.dumps(launches)}")
    return launches


# -- training side: the LM trainer and Algorithm 1 -------------------------------
TRAIN_B, TRAIN_T, TRAIN_STEPS = 32, 64, 300
N_CTX, N_FIT = 100_000, 90_000
TOP_GAP = 1e-5


def plain_topk_rows(torch, np, W, b, screen, H, k, batch=256):
    """The plain block screened head (``core/screening.py``) over H in
    batches on the card → (ids (N, k), smallest gap between its k + 1
    largest candidate logits (N,))."""
    from repro_torch.core.screening import screened_topk
    ids, gaps = [], []
    with torch.inference_mode():
        for i in range(0, len(H), batch):
            h = torch.as_tensor(H[i:i + batch], device="cuda")
            got, vals = screened_topk(W, b, screen, h, k + 1)
            ids.append(got[:, :k].cpu().numpy())
            gaps.append((vals[:, :-1] - vals[:, 1:]).min(dim=1).values
                        .cpu().numpy())
    return np.concatenate(ids), np.concatenate(gaps)


def phase_train_l2s(torch, np):
    """[train] / [l2s] on full-width nmt-deen-lstm: train the LM on the
    synthetic corpus (300 steps of 32 x 64 tokens; one step held against the
    CPU's), harvest 100,000 contexts, fit a 128-word block screen with
    ``fit_l2s`` (and the k-means-only ablation), then hold it to the exact
    head on 10,000 held-out contexts through the CUDA kernels and decode
    with it. → (launches of the evaluation and decode through the fitted
    screen, counted from zero; the trained model, params and screen)."""
    from repro_torch import heads
    from repro_torch.configs import L2SConfig, TrainConfig, get_config
    from repro_torch.core import collect_contexts, fit_l2s, precision_at_k
    from repro_torch.core.evaluate import (avg_candidate_size, exact_topk,
                                           speedup_model)
    from repro_torch.core.screening import assign_clusters
    from repro_torch.core.train_l2s import kmeans_only_screen
    from repro_torch.data import BatchLoader, ZipfMarkovCorpus, make_lm_batches
    from repro_torch.kernels import ops
    from repro_torch.kernels.route import cluster_route
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models import Model
    from repro_torch.models.model import to_device
    from repro_torch.optim import adamw_init, clip_by_global_norm
    from repro_torch.serving import DecodeEngine
    from repro_torch.tree import tree_flatten
    t_phase = time.perf_counter()

    t0 = time.perf_counter()
    corpus = ZipfMarkovCorpus(V, branching=64, seed=0)
    log(f"[train] ZipfMarkovCorpus({V}, branching=64) built on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    cfg = get_config("nmt-deen-lstm")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(17),
                        device="cuda")
    tcfg = TrainConfig(lr=2e-3, warmup_steps=20, total_steps=TRAIN_STEPS,
                       remat="none", loss_chunk=None)
    batches = list(BatchLoader(make_lm_batches(corpus, TRAIN_STEPS, TRAIN_B,
                                               TRAIN_T, seed=1), "cuda"))

    # one step's gradients, loss and gnorm on the card against the CPU's
    cpu_params = to_device(params, "cpu")
    cpu_batch = {k: x.cpu() for k, x in batches[0].items()}
    side = {}
    for where, p, bt in (("card", params, batches[0]),
                         ("cpu", cpu_params, cpu_batch)):
        loss, grads = loss_and_grads(model, tcfg, p, bt)
        _, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        side[where] = (float(loss), float(gnorm),
                     [g.cpu() for g in tree_flatten(grads)])
    gmax = max(float(g.abs().max()) for g in side["cpu"][2])
    gerr = max(float((a - c).abs().max())
               for a, c in zip(side["card"][2], side["cpu"][2]))
    lrel = abs(side["card"][0] - side["cpu"][0]) / abs(side["cpu"][0])
    nrel = abs(side["card"][1] - side["cpu"][1]) / abs(side["cpu"][1])
    check(gerr <= 1e-4 * gmax and lrel <= 1e-5 and nrel <= 1e-5,
          f"[train] card vs CPU step: max |dg| {gerr:.3g} (limit "
          f"{1e-4 * gmax:.3g}), loss rel {lrel:.3g}, gnorm rel {nrel:.3g}")
    log(f"[train] one step on the card vs the CPU from the same params and "
        f"batch: max |g_card - g_cpu| {gerr:.3g} <= 1e-4 x max |g| "
        f"{gmax:.3g}; loss {side['card'][0]:.6f} vs {side['cpu'][0]:.6f} "
        f"(rel {lrel:.2g}), gnorm {side['card'][1]:.6f} vs "
        f"{side['cpu'][1]:.6f} (rel {nrel:.2g}), each <= 1e-5")
    del cpu_params, cpu_batch, side

    step = make_train_step(model, tcfg)
    opt = adamw_init(params)
    losses, gnorms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for bt in batches:
        params, opt, m = step(params, opt, bt)
        losses.append(m["loss"])
        gnorms.append(m["gnorm"])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().numpy()
    gnorms = torch.stack(gnorms).cpu().numpy()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    check(np.isfinite(gnorms).all() and np.isfinite(losses).all(),
          "[train] a loss or gnorm is not finite")
    check(last < first, f"[train] loss did not fall: first 20 steps "
          f"{first:.4f}, last 20 {last:.4f}")
    log(f"[train] nmt-deen-lstm d={D} V={V}: {TRAIN_STEPS} steps of "
        f"{TRAIN_B}x{TRAIN_T} tokens (lr 2e-3, warmup 20, cosine), mean loss "
        f"first 20 steps {first:.4f} -> last 20 {last:.4f}, gnorm "
        f"{gnorms[0]:.3f} -> {gnorms[-1]:.3f} (all finite); "
        f"{t_train / TRAIN_STEPS:.4f} s/step (synchronised host clock), "
        f"peak device memory {peak / 2 ** 30:.2f} GiB")
    # the corpus's unigram counts (the training tokens), for [heads]
    counts = torch.bincount(torch.cat([bt["tokens"].reshape(-1)
                                       for bt in batches]),
                            minlength=V).cpu().numpy()
    del batches, opt

    t0 = time.perf_counter()
    tokens = [b["tokens"] for b in BatchLoader(make_lm_batches(
        corpus, -(-N_CTX // (TRAIN_B * TRAIN_T)), TRAIN_B, TRAIN_T, seed=99),
        "cuda")]
    H, y = collect_contexts(model, params, tokens, max_vectors=N_CTX, k=5)
    Hfit, yfit, Hte = H[:N_FIT], y[:N_FIT], H[N_FIT:]
    log(f"[l2s] harvested {len(H)} contexts (exact top-5) in "
        f"{time.perf_counter() - t0:.1f} s; {N_FIT} to fit, {len(Hte)} held "
        f"out")

    lcfg = L2SConfig(num_clusters=R, budget=1024, vocab_block=V_BLK,
                     outer_iters=4, sgd_steps=200, batch_size=512)
    t0 = time.perf_counter()
    state = fit_l2s(Hfit, yfit, V, lcfg, verbose=True, device="cuda")
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    km = kmeans_only_screen(Hfit, yfit, V, lcfg, device="cuda")
    t_km = time.perf_counter() - t0
    cov = state.history[-1]["coverage_best"]
    rounds = state.history[:-1]
    log(f"[l2s] fit_l2s (r={R}, budget 1024, block {V_BLK}, 4 rounds x 200 "
        f"v-steps of 512) in {t_fit:.1f} s: best coverage {cov:.6f}; per "
        f"round (loss, Lbar, coverage, c-step s, v-step ms): " +
        "; ".join(f"{h['loss']:.4f}, {h['lbar']:.1f}, {h['coverage']:.6f}, "
                  f"{h['cstep_s']:.3f}, {h['vstep_s'] * 1e3:.3f}"
                  for h in rounds) +
        f"; kmeans_only_screen in {t_km:.1f} s")

    W, b = model.softmax_weights(params)
    screen = state.screen
    n_blk = -(-V // V_BLK)

    # the route kernel's clusters on the fitting contexts give back the
    # fit's coverage, up to rows whose top-2 cluster scores nearly tie
    with torch.inference_mode():
        hf = torch.as_tensor(Hfit, device="cuda")
        plain = assign_clusters(screen.v, hf)
        kern = cluster_route(hf, screen.v)
        scores = torch.topk(hf @ screen.v.T, 2, dim=-1).values
        rel = ((scores[:, 0] - scores[:, 1]) /
               scores[:, 0].abs().clamp(min=1e-30)).cpu().numpy()
        plain, kern = plain.cpu().numpy(), kern.cpu().numpy()
    del hf
    items = yfit // V_BLK
    hits = state.mask[kern][np.arange(N_FIT)[:, None], items].sum()
    near = rel < 1e-5
    moved = kern != plain
    check(not (moved & ~near).any(),
          f"[l2s] the route kernel moved {int(moved.sum())} fitting rows, "
          f"some with top-2 cluster scores apart by >= 1e-5 relative")
    cov_k = hits / yfit.size
    check(abs(hits - round(cov * yfit.size)) <= 5 * int(near.sum()),
          f"[l2s] coverage through the route kernel {cov_k:.6f}, fit_l2s "
          f"reported {cov:.6f}, {int(near.sum())} near-tie rows")
    log(f"[l2s] cluster_route on the {N_FIT} fitting contexts: coverage "
        f"{cov_k:.6f} (fit_l2s reported {cov:.6f}); {int(moved.sum())} rows "
        f"routed otherwise than torch.argmax, all among the "
        f"{int(near.sum())} near-ties (< 1e-5 relative)")

    # held-out evaluation: exact, the plain screened head, screened-cuda
    # fused and unfused, counted from zero with the decode below
    exact = heads.get("exact", W=W, b=b, device="cuda")
    fused = heads.get("screened-cuda", W=W, b=b, screen=screen,
                      device="cuda")
    unfused = heads.get("screened-cuda", W=W, b=b, screen=screen,
                        fused=False, device="cuda")
    hte = torch.as_tensor(Hte, device="cuda")
    ex = exact_topk(W, b, Hte, 5)
    plain_ids, gaps = plain_topk_rows(torch, np, W, b, screen, Hte, 5)
    ops.reset_launches()
    with torch.inference_mode():
        f_ids = fused.topk(hte, 5)[0].cpu().numpy()
        u_ids = unfused.topk(hte, 5)[0].cpu().numpy()
    check(np.array_equal(f_ids, u_ids),
          "[l2s] screened-cuda fused and unfused ids differ")
    mapped = np.where(plain_ids >= V, n_blk * V_BLK, plain_ids)
    bad = np.nonzero((f_ids != mapped).any(1))[0]
    check((gaps[bad] < TOP_GAP).all(),
          f"[l2s] screened-cuda differs from the plain screened head on "
          f"{len(bad)} rows, some with a top-k gap >= {TOP_GAP}")
    km_head = heads.get("screened-cuda", W=W, b=b, screen=km.screen,
                        device="cuda")
    with torch.inference_mode():
        km_ids = km_head.topk(hte, 5)[0].cpu().numpy()
    p = {name: (precision_at_k(ids[:, :1], ex[:, :1]),
                precision_at_k(ids, ex))
         for name, ids in (("l2s", f_ids), ("kmeans", km_ids))}
    lbar = avg_candidate_size(screen, Hte)
    lbar_km = avg_candidate_size(km.screen, Hte)
    log(f"[l2s] held-out {len(Hte)}: screened-cuda fused == unfused ids; == "
        f"the plain screened head (sentinels mapped) except {len(bad)} rows "
        f"with a top-k gap < {TOP_GAP}; {len(np.unique(ex[:, 0]))} distinct "
        f"exact top-1 ids, {len(np.unique(ex))} distinct in the top-5")
    log(f"[l2s] P@1 / P@5 against exact: L2S {p['l2s'][0]:.4f} / "
        f"{p['l2s'][1]:.4f} (Lbar {lbar:.1f} words, analytic speedup "
        f"{speedup_model(V, D, R, lbar):.1f}x); k-means only "
        f"{p['kmeans'][0]:.4f} / {p['kmeans'][1]:.4f} (Lbar {lbar_km:.1f}, "
        f"{speedup_model(V, D, R, lbar_km):.1f}x)")

    # the fitted screen in the decode engine (graphs), greedy 4 x 16
    eng = DecodeEngine(model, params, screen=screen, device="cuda")
    prompts = corpus.sample_batch(4, 8, seed=7)
    g_exact = eng.generate(prompts, 16, head="exact")
    g_scr = eng.generate(prompts, 16, head="screened-cuda")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["cluster_route"] > 0 and launches["fused_screened_topk"] > 0,
          f"[l2s] a kernel never launched: {launches}")
    agree = float((g_exact.tokens == g_scr.tokens).mean())
    log(f"[l2s] DecodeEngine greedy 4x16 with the fitted screen: screened-cuda "
        f"== exact on {agree:.4f} of tokens; launches (evaluation and decode, "
        f"from zero): {json.dumps(launches)}")

    timer = Timer(torch, reps=10)
    out = {}
    for B in (1, len(Hte)):
        h = hte[:B].contiguous()
        with torch.inference_mode():
            t = timer.turns({"exact": lambda: exact.topk(h, 5),
                             "screened-cuda": lambda: fused.topk(h, 5)})
        out[B] = t
        log(f"[l2s] head time, B={B}, k=5 (CUDA events, clean L2): exact "
            f"{t['exact']:.5f} ms, screened-cuda {t['screened-cuda']:.5f} ms "
            f"(ratio {t['exact'] / t['screened-cuda']:.2f})")
    log(f"[l2s] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, dict(model=model, params=params, screen=screen,
                          corpus=corpus, Hte=Hte, exact_top5=ex,
                          counts=counts)


# -- continuous batching: streams, the scheduler, the launcher --------------------
SCHED_N = 48                    # [sched] requests, tiers round-robin
LSTM_W, ZSTREAM_W = 8, 4        # stream widths


def gap_steps(torch, np, model, params, screen, prompt, tokens, head):
    """The top-2 gaps that decide each of ``head``'s greedy steps of
    ``prompt`` into ``tokens`` on the card (model.forward over the
    sequence): the logit gap (within the routed candidates on a screened
    head) and, on a screened head, the cluster-score gap; the smaller of
    the two per step."""
    from repro_torch.core.screening import screened_topk
    seq = torch.as_tensor(np.concatenate([prompt, tokens[:-1]])[None],
                          device="cuda")
    with torch.inference_mode():
        h, _ = model.forward(params, {"tokens": seq})
        h = h[0, len(prompt) - 1:].contiguous()
        if head == "exact":
            top = model.logits(params, h).topk(2, dim=-1).values
            return (top[:, 0] - top[:, 1]).cpu().numpy()
        W, b = model.softmax_weights(params)
        _, vals = screened_topk(W, b, screen, h, 2)
        sc = (h @ screen.v.T).topk(2, dim=-1).values
        return torch.minimum(vals[:, 0] - vals[:, 1],
                             sc[:, 0] - sc[:, 1]).cpu().numpy()


def gap_rule(torch, np, tag, model, params, screen, prompt, got, want, head):
    """``got`` == ``want`` (solo generate's tokens), or they first differ
    after a step whose deciding top-2 gap is below GAP. → 1 for such an
    exception, else 0; fails otherwise."""
    check(len(got) == len(want), f"{tag}: {len(got)} tokens, want "
          f"{len(want)}")
    bad = np.nonzero(np.asarray(got) != np.asarray(want))[0]
    if not bad.size:
        return 0
    t = int(bad[0])
    gaps = gap_steps(torch, np, model, params, screen, prompt, want, head)
    check(gaps[t] < GAP, f"{tag}: differs from solo generate at step {t} "
          f"with a top-2 gap {gaps[t]:.3g} >= {GAP}")
    return 1


def drive_stream(stream, reqs, plan, injector=None):
    """Join ``reqs[i]`` at tick ``plan[i]`` (or the first tick after with a
    free slot), step every tick; a step the guard refuses is stepped again.
    → ({request index: tokens}, ticks, faults, host seconds per step)."""
    from repro_torch.serving import HeadFault
    stream.fault_injector = injector
    waiting = sorted(range(len(reqs)), key=lambda i: (plan[i], i))
    done, faults, tick, step_s = {}, 0, 0, []
    while waiting or stream.n_active:
        while waiting and plan[waiting[0]] <= tick and stream.free_slots:
            i = waiting.pop(0)
            stream.join(reqs[i], tag=i)
        t0 = time.perf_counter()
        try:
            out = stream.step()
        except HeadFault:
            faults += 1
            continue
        step_s.append(time.perf_counter() - t0)
        done.update({i: toks for i, _, toks in out + stream.pop_finished()})
        tick += 1
    return done, tick, faults, step_s


def phase_stream_lstm(torch, np, ctx):
    """[stream] on full-width nmt-deen-lstm with the LM trained and the
    screen fitted in [l2s]: one screened-cuda stream of width 8, 12 joins
    over 15 ticks (prompts of 8 and 12 tokens, 4 to 24 new): tokens ==
    solo generate under the gap rule, a re-run bit-identical, one graph;
    a width-1 sampled stream == solo sampled generate bit for bit.
    → (the engine, launches of the first run)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine, ServeRequest
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    eng = DecodeEngine(model, params, screen=screen, device="cuda")
    rng = np.random.default_rng(18)
    plan = [0, 0, 1, 3, 3, 5, 6, 8, 9, 11, 12, 14]
    reqs = [ServeRequest(prompt=rng.integers(0, V, 8 if i % 2 else 12),
                         max_new=4 + (i * 5) % 21) for i in range(len(plan))]
    head = "screened-cuda"
    ops.reset_launches()
    got, ticks, _, step_s = drive_stream(
        eng.open_stream(head, width=LSTM_W), reqs, plan)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    counts = eng.compiled_step_counts()
    check(counts == {(head, "greedy"): 1}, f"[stream] graphs {counts}, "
          f"expected one (screened-cuda, greedy) at width {LSTM_W}")
    check(launches["cluster_route"] > 0 and
          launches["fused_screened_topk"] > 0,
          f"[stream] a kernel never launched: {launches}")
    again, _, _, _ = drive_stream(eng.open_stream(head, width=LSTM_W), reqs,
                                  plan)
    check(set(again) == set(got) and all(np.array_equal(again[i], got[i])
                                         for i in got),
          "[stream] a re-run of the same joins changed a token")
    check(eng.compiled_step_counts() == counts,
          "[stream] the re-run added a graph")
    near = sum(gap_rule(torch, np, f"[stream] request {i}", model, params,
                        screen, r.prompt, got[i],
                        eng.generate(r.prompt[None], r.max_new,
                                     head=head).tokens[0], head)
               for i, r in enumerate(reqs))
    req = ServeRequest(prompt=reqs[0].prompt, max_new=16, temperature=0.9,
                       top_p=0.95, seed=23)
    s = eng.open_stream(head, width=1, temperature=0.9, top_p=0.95, seed=23)
    sampled, _, _, _ = drive_stream(s, [req], [0])
    solo = eng.generate(req.prompt[None], 16, head=head, temperature=0.9,
                        top_p=0.95, seed=23).tokens[0]
    check(np.array_equal(sampled[0], solo),
          "[stream] width-1 sampled stream != solo sampled generate")
    log(f"[stream] nmt-deen-lstm (trained, fitted screen): one {head} stream "
        f"of width {LSTM_W}, {len(reqs)} joins at ticks {plan}, {ticks} "
        f"ticks; tokens == solo generate except {near} request(s) that "
        f"first differ after a step with a top-2 gap < {GAP}; a re-run is "
        f"bit-identical and adds no graph (compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in counts.items()} }); width-1 "
        f"sampled (T=0.9, top-p 0.95) == solo sampled generate; host time "
        f"per stream step (replay, guard sync) median "
        f"{statistics.median(step_s) * 1e3:.4f} ms (host clock, information "
        f"only); launches: {json.dumps(launches)}")
    return eng, launches


def sched_traffic(np, rng):
    """[sched]'s 48 requests: tiers round-robin, prompts of 8 and 12
    tokens, 4 to 24 new, every fourth sampled (T = 0.9, top-p 0.95, one
    seed, so one sampled lane per head)."""
    from repro_torch.serving import ServeRequest
    tiers = ("realtime", "standard", "batch")
    return [ServeRequest(prompt=rng.integers(0, V, 8 if i % 2 else 12),
                         max_new=4 + (i * 5) % 21, latency_tier=tiers[i % 3],
                         temperature=0.9 if i % 4 == 3 else None,
                         top_p=0.95 if i % 4 == 3 else 1.0, seed=31)
            for i in range(SCHED_N)]


def run_sched(eng, reqs, policy, admission=None, per_tick=2, **kw):
    """A fresh ContinuousScheduler (max_slots 8, max_streams 4, a
    LogicalClock) fed ``per_tick`` requests a tick, then drained.
    → (results, scheduler, host seconds)."""
    from repro_torch.serving import ContinuousScheduler, LogicalClock
    sched = ContinuousScheduler(eng, policy=policy, admission=admission,
                                max_slots=LSTM_W, max_streams=4,
                                clock=LogicalClock(0.0, dt_per_read=1e-4),
                                **kw)
    t0 = time.perf_counter()
    for i in range(0, len(reqs), per_tick):
        for r in reqs[i:i + per_tick]:
            sched.submit(r)
        sched.step()
    out = sched.drain(max_ticks=5000)
    return out, sched, time.perf_counter() - t0


def phase_sched(torch, np, eng, ctx):
    """[sched] on [stream]'s engine: ContinuousScheduler over 48 requests
    (TierPolicy realtime -> screened-cuda, standard -> unfused, the rest
    exact; BudgetAdmission at 4x the largest flops_per_query; a quarter
    sampled), a second identical run (no graph added, bit-identical), a
    profiled run (device calls == counted launches, idle share), then the
    fault runs: two transient step faults retried bit for bit, and a
    permanent fault tripping the breaker to exact. → launches of the first
    run."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (BudgetAdmission, CircuitBreaker,
                                     FaultInjector, LogicalClock,
                                     ServeRequest, ServeResult, StaticPolicy,
                                     TierPolicy)
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    pol = TierPolicy({"realtime": "screened-cuda", "standard": UNFUSED},
                     default="exact")
    cat = eng.head_catalog(pol.candidates)
    budget = 4.0 * max(m["flops_per_query"] for m in cat.values())
    reqs = sched_traffic(np, np.random.default_rng(48))

    def admission():
        return BudgetAdmission(flops_budget=budget)

    torch.cuda.synchronize()
    ops.reset_launches()
    first, sched, wall = run_sched(eng, reqs, pol, admission())
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    counts = eng.compiled_step_counts()
    check(all(launches[k] > 0 for k in L2S_KERNELS),
          f"[sched] a kernel never launched: {launches}")
    again, _, wall2 = run_sched(eng, reqs, pol, admission())
    check(eng.compiled_step_counts() == counts,
          f"[sched] the second drain added graphs: {counts} -> "
          f"{eng.compiled_step_counts()}")
    same = [type(a) is type(b) and a.head == b.head and
            (a.tokens is None) == (b.tokens is None) and
            (a.tokens is None or np.array_equal(a.tokens, b.tokens))
            for a, b in zip(first, again)]
    check(len(first) == len(again) == SCHED_N and all(same),
          "[sched] the second drain's results differ from the first's")
    done = [(r, res) for r, res in zip(reqs, first)
            if isinstance(res, ServeResult)]
    check(len(done) >= SCHED_N // 4, f"[sched] only {len(done)} of "
          f"{SCHED_N} requests completed")
    near = 0
    for i, (r, res) in enumerate(done):
        check(len(res.tokens) == r.max_new and res.tokens.max() < V,
              f"[sched] request {i}: bad tokens")
        if not r.sampled:
            solo = eng.generate(r.prompt[None], r.max_new,
                                head=res.head).tokens[0]
            near += gap_rule(torch, np, f"[sched] request {i} on {res.head}",
                             model, params, screen, r.prompt, res.tokens,
                             solo, "exact" if res.head == "exact"
                             else "screened")
    snap = sched.stats.snapshot()
    tokens = sum(len(res.tokens) for _, res in done)
    busy, idle, ours, n_kern = device_profile(
        torch, "[sched] drain", lambda: run_sched(eng, reqs, pol,
                                                  admission()), wall2)

    # fault runs on the greedy traffic, all submitted at once, AcceptAll
    greedy = [r for r in reqs if not r.sampled][:16]
    clean, _, _ = run_sched(eng, greedy, pol, per_tick=len(greedy))
    inj = FaultInjector(seed=0)
    inj.arm("step", "transient", head="screened-cuda", count=2)
    retried, rs, _ = run_sched(
        eng, greedy, pol, per_tick=len(greedy), fault_injector=inj,
        max_retries=3, breaker=CircuitBreaker(failure_threshold=5,
                                              clock=LogicalClock()))
    rz = rs.stats.snapshot()["resilience"]
    check(rz["retries"] == 2 and rz["faults_transient"] == 2 and
          all(isinstance(a, ServeResult) and a.head == b.head and
              np.array_equal(a.tokens, b.tokens)
              for a, b in zip(clean, retried)),
          f"[sched] 2 transient faults: retries {rz['retries']}, results "
          f"not bit-identical to the fault-free drain")
    few = [ServeRequest(prompt=r.prompt, max_new=r.max_new)
           for r in greedy[:6]]
    inj = FaultInjector(seed=0)
    inj.arm("step", "permanent", head="screened-cuda", count=1)
    br = CircuitBreaker(failure_threshold=3, cooldown_s=1e9,
                        clock=LogicalClock())
    fell, fs, _ = run_sched(eng, few, StaticPolicy("screened-cuda"),
                            per_tick=len(few), fault_injector=inj,
                            breaker=br)
    check(br.state("screened-cuda") == "open" and
          all(isinstance(r, ServeResult) and r.head == "exact" for r in fell),
          f"[sched] permanent fault: breaker {br.state('screened-cuda')}, "
          f"heads {[getattr(r, 'head', None) for r in fell]}")
    for r, res in zip(few, fell):
        near += gap_rule(torch, np, "[sched] fallback", model, params, screen,
                         r.prompt, res.tokens,
                         eng.generate(r.prompt[None], r.max_new,
                                      head="exact").tokens[0], "exact")
    log(f"[sched] nmt-deen-lstm: ContinuousScheduler(max_slots={LSTM_W}, "
        f"max_streams=4, LogicalClock) over {SCHED_N} requests (2 a tick; "
        f"realtime -> screened-cuda, standard -> {UNFUSED}, else exact; "
        f"BudgetAdmission at 4x {max(m['flops_per_query'] for m in cat.values()):.4g}"
        f" flops; {sum(r.sampled for r in reqs)} sampled, T=0.9 top-p "
        f"0.95): admitted {snap['admitted']}, rejected {snap['rejected']}, "
        f"downgraded {snap['downgraded']}, preempted {snap['preempted']}, "
        f"completed {snap['completed']} on "
        f"{ {h: d['requests'] for h, d in snap['per_head'].items()} }; "
        f"latency p50 {snap['latency']['p50_s']:.4f} / p95 "
        f"{snap['latency']['p95_s']:.4f} logical s; {snap['ticks']} ticks")
    log(f"[sched] greedy results == solo generate except {near} that first "
        f"differ after a step with a top-2 gap < {GAP}; a second identical "
        f"drain adds no graph (compiled_step_counts "
        f"{ {f'{k[0]}/{k[1]}': v for k, v in sorted(counts.items())} }) and "
        f"gives the same results bit for bit; launches (first drain, from "
        f"zero): {json.dumps(launches)}")
    log(f"[sched] host clock (information only): first drain {wall:.3f} s "
        f"(captures included), second {wall2:.3f} s = {tokens / wall2:.1f} "
        f"tok/s, {wall2 / snap['ticks'] * 1e3:.4f} ms a tick; profile of a "
        f"third: device busy {busy:.3f} ms of {wall2 * 1e3:.3f} ms (idle "
        f"share {idle:.3f}), {n_kern} device kernels; per launch: " +
        "; ".join(f"{k} {ms / n * 1e3:.2f} us x{n}"
                  for k, (ms, n) in ours.items()))
    log(f"[sched] faults: 2 transient step faults on screened-cuda retried "
        f"(retries {rz['retries']}), results bit-identical to the fault-free "
        f"drain of the same {len(greedy)} greedy requests; a permanent fault "
        f"tripped the breaker ({fs.stats.snapshot()['resilience']['breaker_trips']}"
        f" trip) and {len(fell)} requests fell back to exact")
    return launches


def phase_stream_hybrid(torch, np, ctx):
    """[stream] on full-width float32 zamba2-2.7b: one screened-cuda stream
    of width 4, prompts of 512, 384, 256 and 100 tokens joining at ticks 0,
    3, 7 and 12, 32 new each: tokens == solo generate under the gap rule;
    one transient fault after every row joined gives the fault-free tokens
    and cache (K/V, SSM states, conv tails) bit for bit; 9 cache launches
    a step; the snapshot's and the join splice's times. → launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine, FaultInjector, ServeRequest
    from repro_torch.serving.engine import _recurrent_leaves, _splice_cache
    from repro_torch.tree import tree_leaves
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    cfg = model.cfg
    n_attn = cfg.num_layers // cfg.hybrid_shared_period
    eng = DecodeEngine(model, params, screen=screen, max_len=ZMAX,
                       device="cuda")
    rng = np.random.default_rng(19)
    lens, plan = (512, 384, 256, 100), [0, 3, 7, 12]
    reqs = [ServeRequest(prompt=rng.integers(0, ZV, n), max_new=ZNEW)
            for n in lens]
    head = "screened-cuda"
    # the one stream slab of the width, held here so that its cache can be
    # read after each run (both runs' streams are lent it)
    slab = eng._lend_stream_slab(ZSTREAM_W, eng._token_step_key(
        eng.resolve_head(head), None, 1.0))
    eng._return_stream_slab(slab)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    got, ticks, _, step_s = drive_stream(
        eng.open_stream(head, width=ZSTREAM_W), reqs, plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    clean = [x.clone() for x in tree_leaves(slab.cache)]
    check(launches["ssd_intra"] == cfg.num_layers * len(reqs),
          f"[stream] zamba2: ssd_intra launched {launches['ssd_intra']}, "
          f"expected {cfg.num_layers} per join")
    check(launches["cache_slot_update"] == n_attn * ticks,
          f"[stream] zamba2: cache_slot_update launched "
          f"{launches['cache_slot_update']}, expected {n_attn} x {ticks} "
          f"steps")
    check(launches["cluster_route"] > 0 and
          launches["fused_screened_topk"] > 0,
          f"[stream] zamba2: a kernel never launched: {launches}")
    inj = FaultInjector(seed=0)
    inj.arm("step", "transient", count=1, after=plan[-1] + 1)
    retried, _, faults, _ = drive_stream(
        eng.open_stream(head, width=ZSTREAM_W), reqs, plan, injector=inj)
    check(faults == 1 and all(np.array_equal(retried[i], got[i])
                              for i in got),
          f"[stream] zamba2: {faults} faults; the retried run's tokens differ")
    same = [torch.equal(a, b) for a, b in zip(tree_leaves(slab.cache),
                                              clean)]
    check(all(same), f"[stream] zamba2: the retried run's cache differs "
          f"from the fault-free run's in {same.count(False)} leaves")
    del clean
    near = sum(gap_rule(torch, np, f"[stream] zamba2 request {i}", model,
                        params, screen, r.prompt, got[i],
                        eng.generate(r.prompt[None], r.max_new,
                                     head=head).tokens[0], head)
               for i, r in enumerate(reqs))

    def event_ms(fn, n):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    with torch.inference_mode():
        save_ms = event_ms(slab.save, 20)
        solo, _ = eng._prefill(reqs[0].prompt[None], ZNEW)
        splice_ms = event_ms(lambda: _splice_cache(slab.cache, solo.cache, 1,
                                                   cfg), 20)
        t0 = time.perf_counter()
        s = eng.open_stream(head, width=ZSTREAM_W)
        s.join(reqs[0])
        torch.cuda.synchronize()
        join_s = time.perf_counter() - t0
        s.evict(0)
    saved = sum(x.numel() * x.element_size()
                for x in _recurrent_leaves(slab.cache))
    row = sum(x.select(0 if cfg.family == "lstm" else 1, 0).numel() *
              x.element_size() for x in tree_leaves(slab.cache))
    log(f"[stream] zamba2-2.7b: one {head} stream of width {ZSTREAM_W}, "
        f"prompts {lens} joining at ticks {plan}, {ZNEW} new each, "
        f"{ticks} ticks: tokens == solo generate except {near} request(s) "
        f"that first differ after a step with a top-2 gap < {GAP}; one "
        f"transient fault after every row joined: tokens and all "
        f"{len(same)} cache leaves (K/V, SSM states, conv tails) "
        f"bit-identical to the fault-free run; cache_slot_update "
        f"{n_attn} a step; launches: {json.dumps(launches)}")
    log(f"[stream] zamba2-2.7b rollback snapshot: {saved / 2 ** 20:.1f} MiB "
        f"of recurrent leaves copied at the start of every step, "
        f"{save_ms:.4f} ms (CUDA events, mean of 20), "
        f"{save_ms / statistics.median(step_s[plan[-1]:]) / 1e3:.2%} of the "
        f"median host-clock stream step "
        f"{statistics.median(step_s[plan[-1]:]) * 1e3:.3f} ms; join splice "
        f"(whole rows, {row / 2 ** 20:.1f} MiB): {splice_ms:.4f} ms; a whole "
        f"join of 512 tokens (B = 1 prefill, first token, splice) "
        f"{join_s * 1e3:.1f} ms; stream run {wall:.3f} s (host clock)")
    return launches


def phase_serve_cli(torch):
    """[serve-cli] ``python -m repro_torch.launch.serve`` on the card:
    --arch nmt-deen-lstm --l2s --scheduler --log-jsonl (50 train steps, 12
    requests) returns 0 and every JSONL line parses; bad flags return 2."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch import serve
    base = ["--arch", "nmt-deen-lstm", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ticks.jsonl"
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = serve.main(base + ["--l2s", "--scheduler", "--log-jsonl",
                                    str(path), "--train-steps", "50",
                                    "--requests", "12"])
        secs = time.perf_counter() - t0
        lines = path.read_text().splitlines()
        recs = [json.loads(ln) for ln in lines]
    check(rc == 0, f"[serve-cli] exit code {rc}:\n{out.getvalue()}")
    check(recs and all("tick" in r and "delta" in r for r in recs),
          "[serve-cli] a JSONL record lacks tick / delta")
    bad = {"--head screened without --l2s": ["--head", "screened"],
           "--log-jsonl without --scheduler": ["--log-jsonl", "x.jsonl"],
           "--draft-head": ["--scheduler", "--draft-head", "screened",
                            "--l2s"]}
    codes = {}
    for name, argv in bad.items():
        with contextlib.redirect_stdout(io.StringIO()):
            codes[name] = serve.main(base + argv)
    check(all(c == 2 for c in codes.values()), f"[serve-cli] bad flags "
          f"returned {codes}")
    for ln in out.getvalue().splitlines():
        log(ln)
    log(f"[serve-cli] python -m repro_torch.launch.serve {' '.join(base)} "
        f"--l2s --scheduler --log-jsonl ... --train-steps 50 --requests 12: "
        f"exit 0 in {secs:.1f} s, {len(recs)} JSONL tick records parse; bad "
        f"flags exit {codes}")


# -- the other heads: adaptive, the §4.1 baselines, host heads ---------------
SHORTLIST, N_TAILS = 2048, 4     # [heads] adaptive: 16 short tiles, 4 tails
N_BASE = 1_000                   # [heads] held-out rows for the baselines
N_SVD_FULL = 200                 # [heads] rows for full-rank svd == exact
# [heads] a layout whose rows descend: one short tile; the last k passes
# its 128 slots, so every row descends there
DESC_SHORTLIST, DESC_K = 128, (5, 64, 128, 129)
BASELINES = ("svd", "shortlist", "greedy-mips", "lsh-mips", "pca-mips",
             "screened-cpu")


def adaptive_bound(torch, hd, h, k=1):
    """Bound of one adaptive step on ``h`` (B, d) at ``k``: the short
    tiles, the distinct tail tiles the head's own rule sends the rows to
    (``tier_blocks``; each read once, bias rows included), the gates and h;
    per-row multiply-adds for the operations. → (ms, "bytes" |
    "operations")."""
    B, d = h.shape
    lay = hd.layout
    with torch.inference_mode():
        _, tail, _ = hd.tier_blocks(h, k)
        live = tail[tail < lay.n_blk]
        tiles = lay.nb0 + int(live.unique().numel())
    nbytes = 4 * (tiles * V_BLK * (d + 1) + lay.C * (d + 1) + B * d +
                  2 * B * (2 * k + 1))
    flops = 2 * d * (B * (lay.nb0 * V_BLK + lay.C) + live.numel() * V_BLK)
    return bound_ms(nbytes, flops)


def descent_check(torch, tag, fused, unfused, h, ks):
    """A tier layout whose rows descend, at each k of ``ks`` on ``h``:
    fused == unfused ids and values bit for bit, log-probs within TOL and
    never NaN; on the first 256 descending rows (the plain version gathers
    each row's tiles) the tail launch (live block ids) against
    ``fused_screened_topk_plain``, and logZ finite. → ({k: rows descending}, max abs
    error of the tail launch, ids differing at near-ties)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_topk import fused_screened_topk_plain
    lay = fused.layout
    down, err, near = {}, 0.0, 0
    with torch.inference_mode():
        for k in ks:
            fi, fv = fused.topk(h, k)
            ui, uv = unfused.topk(h, k)
            check(torch.equal(fi, ui) and torch.equal(fv, uv),
                  f"{tag} k={k}: fused and unfused ids or values differ")
            fl, ul = fused.topk_logprobs(h, k)[1], unfused.topk_logprobs(h, k)[1]
            check(not bool(torch.isnan(fl).any()), f"{tag} k={k}: NaN "
                  f"log-probs")
            torch.testing.assert_close(fl, ul, **TOL)
            _, tail, d = fused.tier_blocks(h, k)
            down[k] = int(d.sum())
            if not down[k]:
                continue
            hd, tb = h[d][:256].contiguous(), tail[d][:256].contiguous()
            kt = min(k, lay.kb * V_BLK)
            ti, tv, tz = ops.tier_fused_topk(fused._Wb, fused._bb, hd, tb,
                                             k=kt)
            pi, pv, pz = fused_screened_topk_plain(fused._Wb, fused._bb, hd,
                                                   tb, kt)
            torch.testing.assert_close(tv, pv, **TOL)
            torch.testing.assert_close(tz, pz, **TOL)
            check(bool(torch.isfinite(tz).all()), f"{tag} k={k}: a "
                  f"descending row's tail logZ is not finite")
            diff = ti != pi
            if bool(diff.any()):
                rel = ((tv[diff] - pv[diff]).abs() /
                       pv[diff].abs().clamp_min(1e-30))
                check(bool((rel < 1e-5).all()), f"{tag} k={k}: tail ids "
                      f"differ from the plain version beyond near-ties")
                near += int(diff.sum())
            err = max(err, float((tv - pv).abs().max()),
                      float((tz - pz).abs().max()))
    check(sum(down.values()) > 0, f"{tag}: no row descended at k in {ks}")
    return down, err, near


def screened_bound(torch, screen, h):
    """Bound of one screened-cuda step: the route's v, the distinct
    candidate tiles of the routed clusters, h."""
    B, d = h.shape
    with torch.inference_mode():
        cl = torch.argmax(h @ screen.v.T, dim=-1)
        blocks = screen.cand_idx[cl]
        n_blk = -(-screen.vocab_size // V_BLK)
        tiles = int(blocks[blocks < n_blk].unique().numel())
        per_row = int((blocks < n_blk).sum())
    nbytes = 4 * (screen.v.numel() + tiles * V_BLK * (d + 1) + B * d)
    flops = 2 * d * (B * screen.r + per_row * V_BLK)
    return bound_ms(nbytes, flops)


def time_head_steps(torch, timer, hd_by_name, W, h, screen, adaptive,
                    descent):
    """One decode step's head (``next``) of each head at ``h`` (B, d), the
    adaptive step's two fused launches alone (its tail ids by the head's
    own rule), and those of ``descent`` = (an adaptive head whose rows
    descend, its k), in turns under the clean-L2 timer → {name: (ms,
    bound)}."""
    from repro_torch.kernels import ops
    B, d = h.shape
    L = W.shape[0]

    def two_launches(ad, k):
        with torch.inference_mode():
            short, tail, _ = ad.tier_blocks(h, k)
        ks = min(k, ad.layout.nb0 * V_BLK)
        kt = min(k, ad.layout.kb * V_BLK)

        def run():
            ops.tier_fused_topk(ad._Wb, ad._bb, h, short, k=ks)
            ops.tier_fused_topk(ad._Wb, ad._bb, h, tail, k=kt)
        return run
    dh, dk = descent
    with torch.inference_mode():
        fns = {n: (lambda hd=hd: hd.next(h)) for n, hd in hd_by_name.items()}
        fns["adaptive-kernels"] = two_launches(adaptive, 1)
        fns["adaptive-descend-kernels"] = two_launches(dh, dk)
        t = timer.turns(fns)
    bounds = {"exact": bound_ms(4 * (L * (d + 1) + B * d), 2 * B * L * d),
              "screened-cuda": screened_bound(torch, screen, h),
              "adaptive": adaptive_bound(torch, adaptive, h),
              "adaptive-descend-kernels": adaptive_bound(torch, dh, h, dk)}
    bounds["adaptive-kernels"] = bounds["adaptive"]
    return {n: (t[n], bounds[n]) for n in fns}


def phase_heads(torch, np, ctx):
    """[heads] on the trained nmt-deen-lstm and fitted screen of [l2s]: the
    adaptive head (fused == unfused bit for bit on the 10,000 held-out rows,
    P@k, descent rate; shortlist = L against exact), the §4.1 baselines and
    screened-cpu on the host (P@k, flops, ms a query; full-rank svd ==
    exact), the engine through adaptive (graphs) and host heads, a stream
    through greedy-mips, and the head steps' times. → (launches of the
    engine part, counted from zero; the step times)."""
    from repro_torch import heads
    from repro_torch.core import precision_at_k
    from repro_torch.heads import AdaptiveHead
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import topk_desc
    from repro_torch.serving import DecodeEngine, ServeRequest
    from repro_torch.testing import (eager_beam_search, eager_generate,
                                     head_sampled_generate)
    t_phase = time.perf_counter()
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    Hte, ex, counts = ctx["Hte"], ctx["exact_top5"], ctx["counts"]
    W, b = model.softmax_weights(params)
    kw = dict(W=W, b=b, counts=counts, shortlist=SHORTLIST, n_tails=N_TAILS,
              device="cuda")
    fused = heads.get("adaptive", **kw)
    unfused = heads.get("adaptive", fused=False, **kw)
    lay = fused.layout
    check((lay.nb0, lay.C, lay.kb, lay.n_blk) == (16, 4, 45, 196),
          f"[heads] adaptive layout {(lay.nb0, lay.C, lay.kb, lay.n_blk)}, "
          f"want (16, 4, 45, 196)")
    hte = torch.as_tensor(Hte, device="cuda")
    with torch.inference_mode():
        fi, fv = fused.topk(hte, 5)
        ui, uv = unfused.topk(hte, 5)
        logits = hte @ W.T + b
        top6 = topk_desc(logits, 6)[0]
        gaps = (top6[:, :-1] - top6[:, 1:]).min(dim=1).values.cpu().numpy()
    check(torch.equal(fi, ui) and torch.equal(fv, uv),
          "[heads] adaptive fused and unfused ids or values differ")
    fi = fi.cpu().numpy()
    with torch.inference_mode():
        rate = float(fused.tier_blocks(hte, 5)[2].float().mean())
    p_ad = (precision_at_k(fi[:, :1], ex[:, :1]), precision_at_k(fi, ex))
    full = heads.get("adaptive", W=W, b=b, shortlist=V, device="cuda")
    with torch.inference_mode():
        full_ids = full.topk(hte, 5)[0].cpu().numpy()
    bad = np.nonzero((full_ids != ex).any(1))[0]
    check((gaps[bad] < TOP_GAP).all(), f"[heads] adaptive shortlist = L "
          f"differs from exact on {len(bad)} rows, some with a top-k gap >= "
          f"{TOP_GAP}")
    log(f"[heads] adaptive (counts of the training tokens, shortlist "
        f"{SHORTLIST}, {N_TAILS} tails: nb0 {lay.nb0}, tails of "
        f"{lay.tail_sizes} words, kb {lay.kb}, n_blk {lay.n_blk}) on the "
        f"{len(Hte)} held-out rows: fused == unfused ids and values bit for "
        f"bit; P@1 / P@5 against exact {p_ad[0]:.4f} / {p_ad[1]:.4f}; "
        f"descent rate at k=5 {rate:.4f} (cost model p_descend "
        f"{lay.p_descend:.4f}); flops_per_query {fused.flops_per_query:.0f} "
        f"(exact {V * D}); shortlist = L (one tier of {full._lay.nb0} "
        f"tiles) == exact except {len(bad)} rows with a top-k gap < "
        f"{TOP_GAP}")

    # a layout whose rows descend: one short tile, so the k-th short logit
    # falls below the best tail gate on some rows, and every row at k past
    # the short list's 128 slots
    dkw = dict(kw, shortlist=DESC_SHORTLIST)
    d_fused = heads.get("adaptive", **dkw)
    d_unfused = heads.get("adaptive", fused=False, **dkw)
    down, d_err, d_near = descent_check(
        torch, "[heads] adaptive descent", d_fused, d_unfused, hte, DESC_K)
    check(down[DESC_K[-1]] == len(Hte), f"[heads] adaptive descent: "
          f"{down[DESC_K[-1]]} of {len(Hte)} rows descend at k = "
          f"{DESC_K[-1]}, past the short list")
    dl = d_fused.layout
    log(f"[heads] adaptive with rows that descend (shortlist "
        f"{DESC_SHORTLIST}, {N_TAILS} tails: nb0 {dl.nb0}, kb {dl.kb}) on "
        f"the {len(Hte)} held-out rows: rows descending by k "
        f"{json.dumps(down)}; at each k fused == unfused ids and values bit "
        f"for bit, log-probs within rtol=atol=1e-5 and never NaN; the tail "
        f"launch on up to 256 descending rows a k against its plain "
        f"version max abs err {d_err:.3g} ({d_near} ids differ at "
        f"near-ties), logZ finite")

    # the baselines and screened-cpu on the host, one query at a time
    hb = torch.as_tensor(Hte[:N_BASE])               # a host tensor
    exb = ex[:N_BASE]
    rows = []
    for name in BASELINES:
        t0 = time.perf_counter()
        hd = heads.get(name, W=W, b=b, screen=screen, device="cuda")
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids = hd.topk(hb, 5)[0].numpy()
        ms = (time.perf_counter() - t0) * 1e3 / N_BASE
        rows.append((name, precision_at_k(ids[:, :1], exb[:, :1]),
                     precision_at_k(ids, exb), hd.flops_per_query, ms,
                     t_build))
    svd = heads.get("svd", W=W, b=b, rho=D, n_top=V, device="cuda")
    t0 = time.perf_counter()
    svd_ids = svd.topk(hb[:N_SVD_FULL], 5)[0].numpy()
    svd_ms = (time.perf_counter() - t0) * 1e3 / N_SVD_FULL
    bad = np.nonzero((svd_ids != exb[:N_SVD_FULL]).any(1))[0]
    check((gaps[bad] < TOP_GAP).all(), f"[heads] full-rank svd "
          f"differs from exact on {len(bad)} rows, some with a top-k gap >= "
          f"{TOP_GAP}")
    for name, p1, p5, flops, ms, tb in rows:
        log(f"[heads] {name} (host, one query at a time) on {N_BASE} held-out "
            f"rows: P@1 {p1:.4f} P@5 {p5:.4f}; flops_per_query {flops:.0f} "
            f"({V * D / flops:.1f}x fewer than exact); {ms:.4f} ms a query "
            f"(host clock); built in {tb:.2f} s")
    log(f"[heads] svd at rho = d = {D}, n_top = L on {N_SVD_FULL} of those "
        f"rows: == exact except {len(bad)} rows with a top-k gap < "
        f"{TOP_GAP}; {svd_ms:.4f} ms a query")

    # the engine: adaptive through graphs, host heads between replays
    eng = DecodeEngine(model, params, screen=screen, device="cuda",
                       head_kwargs=dict(counts=counts, shortlist=SHORTLIST,
                                        n_tails=N_TAILS))
    ad_unfused = AdaptiveHead(eng.W, eng.b, counts=counts, shortlist=SHORTLIST,
                              n_tails=N_TAILS, fused=False).prepare()
    corpus = ctx["corpus"]
    prompts = corpus.sample_batch(4, 8, seed=7)
    new = 16
    launches = {}

    def on_path(fn):
        """One of the path's own engine runs, its launches counted from zero
        and added to the path's; the runs that time, profile or check it
        against a reference are left out."""
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for name, n in ops.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + n
        return out
    g_ad = on_path(lambda: eng.generate(prompts, new, head="adaptive"))
    check(ops.LAUNCHES["fused_screened_topk"] == 2 * new,
          f"[heads] adaptive greedy {len(prompts)}x{new}: fused top-k "
          f"launched {ops.LAUNCHES['fused_screened_topk']} times, want "
          f"{2 * new} (two a token)")
    _, wall = host_timed(torch, lambda: eng.generate(prompts, new,
                                                     head="adaptive"))
    ops.reset_launches()
    busy, idle, ours, n_kern = device_profile(
        torch, "[heads] adaptive greedy replay",
        lambda: eng.generate(prompts, new, head="adaptive"), wall)
    replay = dict(ops.LAUNCHES)
    check(replay["fused_screened_topk"] == 2 * new,
          f"[heads] adaptive greedy replayed: {replay}")
    ops.reset_launches()
    e_ad = eager_generate(eng, prompts, new, head="adaptive")
    check(np.array_equal(g_ad.tokens, e_ad.tokens) and
          dict(ops.LAUNCHES) == replay,
          "[heads] adaptive graph tokens or launches != the eager body's")
    g_un = eng.generate(prompts, new, head=ad_unfused)
    check(np.array_equal(g_ad.tokens, g_un.tokens),
          "[heads] adaptive fused and unfused greedy tokens differ")
    s = [on_path(lambda: eng.generate(prompts, new, head="adaptive",
                                      temperature=0.9, seed=3)),
         eng.generate(prompts, new, head="adaptive", temperature=0.9, seed=3)]
    want = head_sampled_generate(eng, prompts, new, "adaptive", 0.9, seed=3)
    check(np.array_equal(s[0].tokens, s[1].tokens) and
          np.array_equal(s[0].tokens, want),
          "[heads] adaptive sampled tokens != the head's own draws")
    bm = on_path(lambda: eng.beam_search(prompts[0], 5, new, head="adaptive"))
    eb = eager_beam_search(eng, prompts[0], 5, new, head="adaptive")
    check(np.array_equal(bm.tokens, eb.tokens) and
          np.array_equal(bm.scores, eb.scores),
          "[heads] adaptive beam(5): graph != eager body")
    g_ex = eng.generate(prompts, new, head="exact")
    g_sc = eng.generate(prompts, new, head="screened-cuda")
    near = {}
    for name, ref, rule in ((svd, g_ex, "exact"),
                            ("screened-cpu", g_sc, "screened-cuda")):
        got = on_path(lambda: eng.generate(prompts, new, head=name))
        name = getattr(name, "name", name)
        near[name] = sum(gap_rule(torch, np, f"[heads] {name} row {i}",
                                  model, params, screen, prompts[i],
                                  got.tokens[i], ref.tokens[i], rule)
                         for i in range(len(prompts)))
    reqs = [ServeRequest(prompt=corpus.sample_batch(1, n, seed=40 + i)[0],
                         max_new=m)
            for i, (n, m) in enumerate(((8, 12), (12, 6), (8, 10),
                                        (12, 16)))]
    plan = [0, 1, 3, 5]

    def stream_run():
        done, ticks, _, _ = drive_stream(eng.open_stream("greedy-mips",
                                                         width=4), reqs, plan)
        return done, ticks
    got, ticks = on_path(stream_run)
    near["greedy-mips stream"] = sum(
        gap_rule(torch, np, f"[heads] greedy-mips stream request {i}", model,
                 params, screen, r.prompt, got[i],
                 eng.generate(r.prompt[None], r.max_new,
                              head="greedy-mips").tokens[0], "exact")
        for i, r in enumerate(reqs))
    check(launches["fused_screened_topk"] == 4 * new and
          launches["screened_logits"] == 2 * new and
          launches["cluster_route"] == 0,
          f"[heads] the path's own runs launched {launches}: want "
          f"{4 * new} fused top-k (greedy and beam, two a step), {2 * new} "
          f"gathers (the sampled rows, two a step) and no route")
    counts_1 = (eng.compiled_step_counts(), eng.host_model_graphs())
    check(all(counts_1[0][(n, "greedy")] == 0
              for n in ("svd", "screened-cpu", "greedy-mips")),
          f"[heads] a host head holds a graph: {counts_1[0]}")
    again = eng.generate(prompts, new, head="adaptive")
    again_svd = eng.generate(prompts, new, head=svd)
    got2, _ = stream_run()
    check(np.array_equal(again.tokens, g_ad.tokens) and
          all(np.array_equal(got2[i], got[i]) for i in got),
          "[heads] a second identical run changed tokens")
    counts_2 = (eng.compiled_step_counts(), eng.host_model_graphs())
    check(counts_2 == counts_1, f"[heads] a second identical run added "
          f"graphs: {counts_1} -> {counts_2}")
    del again_svd
    log(f"[heads] DecodeEngine through adaptive (graphs): greedy "
        f"{len(prompts)}x{new} == its eager body and == the unfused head's "
        f"tokens, fused top-k launched {2 * new} times (two a token, from "
        f"zero; device calls == counted launches), sampled (T = 0.9) == the "
        f"head's own draws, beam(5) == eager; host heads between replays: "
        f"full-rank svd == exact, screened-cpu == screened-cuda, and a "
        f"greedy-mips stream of width 4 (4 joins, {ticks} ticks) == solo "
        f"generate, except rows after a step with a top-2 gap < {GAP}: "
        f"{json.dumps(near)}; a second identical run adds no graph "
        f"(compiled_step_counts "
        f"{json.dumps({'/'.join(k): n for k, n in counts_2[0].items()})}, "
        f"model-only graphs of the host heads {counts_2[1]}); launches of "
        f"the path's own runs (adaptive greedy, sampled, beam(5); svd and "
        f"screened-cpu greedy; the greedy-mips stream), each from zero: "
        f"{json.dumps(launches)}")
    log(f"[heads] profile, adaptive greedy {len(prompts)}x{new} (graphs): "
        f"device busy {busy:.3f} ms of {wall * 1e3:.3f} ms unprofiled wall "
        f"(idle share {idle:.3f}), {n_kern} device kernels; fused_topk_kernel "
        f"{ours['fused_screened_topk'][0]:.3f} ms x"
        f"{ours['fused_screened_topk'][1]}")

    # one decode step's head at B = 4 under the clean-L2 timer
    timer = Timer(torch, reps=30)
    h4 = hte[:4].contiguous()
    steps = time_head_steps(
        torch, timer, {"exact": eng.resolve_head("exact"),
                       "screened-cuda": eng.resolve_head("screened-cuda"),
                       "adaptive": fused}, W, h4, screen, fused,
        (d_fused, DESC_K[-1]))
    with torch.inference_mode():
        n4 = [int(hd.tier_blocks(h4, k)[2].sum())
              for hd, k in ((fused, 1), (d_fused, DESC_K[-1]))]
    log(f"[heads] one step's head at B=4, d=500 (CUDA events, clean L2; "
        f"next(h); adaptive-kernels: its two fused launches alone, {n4[0]} "
        f"of 4 rows descending; adaptive-descend-kernels: the two launches "
        f"of shortlist {DESC_SHORTLIST} at k = {DESC_K[-1]}, {n4[1]} of 4 "
        f"rows descending): " + "; ".join(
            f"{n} {ms:.5f} ms (bound {bd[0]:.5f} ms by {bd[1]})"
            for n, (ms, bd) in steps.items()))
    log(f"[heads] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, steps


def phase_adaptive_hybrid(torch, np, ctx):
    """[heads] adaptive on full-width zamba2-2.7b (random weights, so the
    tiers follow the weight-row norms): greedy 4 x 512 + 32 with shortlist
    2048 fused == unfused tokens (graphs), two fused launches a step counted
    from zero and held to the profiler; shortlist = L against exact under
    the gap rule; the head steps' times at d = 2560. → (launches, times)."""
    from repro_torch.heads import AdaptiveHead
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine
    t_phase = time.perf_counter()
    model, params, screen = ctx["model"], ctx["params"], ctx["screen"]
    prompts = ctx["prompts"]
    cfg = model.cfg
    n_attn = cfg.num_layers // cfg.hybrid_shared_period
    eng = DecodeEngine(model, params, screen=screen, max_len=ZMAX,
                       device="cuda",
                       head_kwargs=dict(shortlist=SHORTLIST,
                                        n_tails=N_TAILS))
    fused = eng.resolve_head("adaptive")
    unfused = AdaptiveHead(eng.W, eng.b, shortlist=SHORTLIST,
                           n_tails=N_TAILS, fused=False).prepare()
    full = AdaptiveHead(eng.W, eng.b, shortlist=ZV).prepare()
    lay = fused.layout
    eng.generate(prompts[:, :16], 2, head=fused)       # capture at B = 4
    ops.reset_launches()
    got = eng.generate(prompts, ZNEW, head=fused)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    check(launches["fused_screened_topk"] == 2 * ZNEW and
          launches["ssd_intra"] == cfg.num_layers and
          launches["cache_slot_update"] == n_attn * (ZNEW - 1),
          f"[heads] zamba2 adaptive greedy: launches {launches}, want "
          f"{2 * ZNEW} fused top-k, {cfg.num_layers} SSD and "
          f"{n_attn * (ZNEW - 1)} cache launches")
    ops.reset_launches()
    profile_counted(torch, "[heads] zamba2 adaptive greedy",
                    lambda: eng.generate(prompts, ZNEW, head=fused))
    un = eng.generate(prompts, ZNEW, head=unfused)
    check(np.array_equal(got.tokens, un.tokens),
          "[heads] zamba2 adaptive fused and unfused tokens differ")
    g_full = eng.generate(prompts, ZNEW, head=full)
    g_ex = eng.generate(prompts, ZNEW, head="exact")
    near = sum(gap_rule(torch, np, f"[heads] zamba2 adaptive L row {i}",
                        model, params, screen, prompts[i], g_full.tokens[i],
                        g_ex.tokens[i], "exact")
               for i in range(ZB))
    with torch.inference_mode():
        h4, _ = model.forward(params, {"tokens": torch.as_tensor(
            prompts[:, :64], device="cuda")})
        h4 = h4[:, -1].contiguous()
    dkw = dict(shortlist=DESC_SHORTLIST, n_tails=N_TAILS)
    d_fused = AdaptiveHead(eng.W, eng.b, **dkw).prepare()
    d_unfused = AdaptiveHead(eng.W, eng.b, fused=False, **dkw).prepare()
    down, d_err, d_near = descent_check(
        torch, "[heads] zamba2 adaptive descent", d_fused, d_unfused, h4,
        DESC_K)
    check(any(0 < n < ZB for n in down.values()), f"[heads] zamba2 "
          f"adaptive descent: no k mixed descending and sentinel rows in "
          f"one tail launch ({down})")
    with torch.inference_mode():
        descend = fused.tier_blocks(h4, 1)[2]
    timer = Timer(torch, reps=30)
    steps = time_head_steps(
        torch, timer, {"exact": eng.resolve_head("exact"),
                       "screened-cuda": eng.resolve_head("screened-cuda"),
                       "adaptive": fused}, eng.W, h4, eng.screen, fused,
        (d_fused, DESC_K[-1]))
    log(f"[heads] zamba2-2.7b adaptive (weight-norm tiers, shortlist "
        f"{SHORTLIST}, {N_TAILS} tails: nb0 {lay.nb0}, kb {lay.kb}, n_blk "
        f"{lay.n_blk}) greedy {ZB}x{ZT}+{ZNEW} through graphs: fused == "
        f"unfused tokens; launches from zero {json.dumps(launches)} (fused "
        f"top-k two a token; device calls == counted launches); shortlist = "
        f"L == exact tokens except {near} rows after a step with a top-2 gap "
        f"< {GAP}; rows descending at the step timed: "
        f"{int(descend.sum())} of {ZB}; shortlist {DESC_SHORTLIST} (nb0 "
        f"{d_fused.layout.nb0}, kb {d_fused.layout.kb}) at that step: rows "
        f"descending by k {json.dumps(down)}, fused == unfused bit for bit, "
        f"the tail launch against its plain version max abs err {d_err:.3g} "
        f"({d_near} ids differ at near-ties)")
    log(f"[heads] one step's head at B=4, d=2560 (CUDA events, clean L2; "
        f"next(h); adaptive-kernels: its two fused launches alone; "
        f"adaptive-descend-kernels: those of shortlist {DESC_SHORTLIST} at "
        f"k = {DESC_K[-1]}, {down[DESC_K[-1]]} of {ZB} rows descending): " +
        "; ".join(
            f"{n} {ms:.5f} ms (bound {bd[0]:.5f} ms by {bd[1]})"
            for n, (ms, bd) in steps.items()))
    log(f"[heads] zamba2 adaptive phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, steps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is visible; nothing to run",
              file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.serving import DecodeEngine

    resolve_device("cuda")                     # TF32 off for float32 matmuls
    kind, _ = phase_device(torch)
    phase_build(ops)
    err = phase_parity(torch, np, K)
    err["fused_screened_topk"] = max(err["fused_screened_topk"],
                                     phase_fused_split(torch, np))
    err["screened_logits"] = max(err["screened_logits"],
                                 phase_screen_grid(torch, np))
    times, wide, beam = phase_timing(torch, np)
    register_unfused()
    lstm, ctx = phase_e2e(torch, np)
    graph_lstm = phase_graph(
        torch, np, "nmt-deen-lstm",
        DecodeEngine(ctx["model"], ctx["params"], screen=ctx["screen"],
                     device="cuda"), ctx["prompts"], 16, 5, sampled=True)
    serve = phase_serve(torch, np, ctx)
    del ctx
    l2s_fit, ctx = phase_train_l2s(torch, np)
    heads_lstm, steps_lstm = phase_heads(torch, np, ctx)
    t0 = time.perf_counter()
    eng, stream_lstm = phase_stream_lstm(torch, np, ctx)
    sched = phase_sched(torch, np, eng, ctx)
    del eng, ctx
    phase_serve_cli(torch)
    log(f"[sched] the LSTM stream, scheduler and launcher phases took "
        f"{time.perf_counter() - t0:.1f} s")
    ssm_err, ssm_times = phase_ssm_kernels(torch)
    err.update(ssm_err)
    times.update(ssm_times)
    hybrid, ctx = phase_e2e_hybrid(torch, np)
    graph_hybrid = phase_graph(
        torch, np, "zamba2-2.7b",
        DecodeEngine(ctx["model"], ctx["params"], screen=ctx["screen"],
                     max_len=ZMAX, device="cuda"), ctx["prompts"], ZNEW, 4,
        sampled=False)
    zcfg = ctx["model"].cfg
    n_attn = zcfg.num_layers // zcfg.hybrid_shared_period
    check(graph_hybrid["cache_slot_update"] == n_attn * 6 * (ZNEW - 1) and
          graph_hybrid["ssd_intra"] == zcfg.num_layers * 6,
          f"[graph] zamba2-2.7b: launches {graph_hybrid}, expected "
          f"{n_attn} cache and {zcfg.num_layers} SSD launches per decode "
          f"step and per prefill")
    t0 = time.perf_counter()
    stream_hybrid = phase_stream_hybrid(torch, np, ctx)
    log(f"[stream] the zamba2-2.7b stream phase took "
        f"{time.perf_counter() - t0:.1f} s")
    adaptive_z, steps_z = phase_adaptive_hybrid(torch, np, ctx)
    del ctx
    costs = launch_costs(torch, np)
    # each kernel's launches on the path it was ported for, and on each path
    launches = {k: (hybrid if k in ssm_err else lstm)[k] for k in lstm}
    paths = {"nmt-deen-lstm": lstm, "nmt-deen-lstm graph": graph_lstm,
             "serve": serve, "nmt-deen-lstm l2s-fit": l2s_fit,
             "zamba2-2.7b": hybrid,
             "zamba2-2.7b graph": graph_hybrid,
             "nmt-deen-lstm stream": stream_lstm,
             "nmt-deen-lstm scheduler": sched,
             "zamba2-2.7b stream": stream_hybrid,
             "nmt-deen-lstm heads": heads_lstm,
             "zamba2-2.7b adaptive": adaptive_z}

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
                        "launches_by_path": {p: n[name]
                                             for p, n in paths.items()},
                        "launch_cost_ms": costs.get(name)})
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
        if name == "fused_screened_topk":
            kernels[-1]["adaptive_step"] = {
                str(d_): {"B": 4, **{f"{n}_ms": t_[0] for n, t_ in st.items()},
                          **{f"{n}_bound_ms": t_[1][0]
                             for n, t_ in st.items()}}
                for d_, st in ((D, steps_lstm), (ZD, steps_z))}
        if name == "screened_logits":
            kernels[-1]["at_beam_shape"] = [
                {"B": 20, "K": K, "d": d_, "ms": t_["ms"],
                 "plain_ms": t_["plain_ms"], "bound_ms": t_["bound"][0],
                 "bound_by": t_["bound"][1], "fused_ms": t_["fused_ms"]}
                for d_, t_ in zip((D, ZD), beam)]
    log(f"[done] chip_smoke.py took {time.perf_counter() - T_START:.1f} s, "
        f"the kernels' build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
