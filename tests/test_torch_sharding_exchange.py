"""The port's per-device paths on a mesh that really splits and really
exchanges: eight CPU processes in a gloo group over the loopback, a (2, 4)
("data", "model") mesh (``tests/torch_mesh_worker.py``). Each case runs
once on DTensors and once on the same plain tensors without a mesh, and
every result of the first, gathered whole, is held to the second's:

  * the kernel wrappers and helpers on the same inputs: the route and the
    screened logits over a batch split on "data"; the fused top-k over a
    head whose tiles split on "model" (each device's k best, their ids
    made global, merged); ``ssd_intra`` with 8 heads over "model" and one
    B/C group, forward and backward; the vocab-parallel ``lookup``,
    ``gather_last`` and ``logsumexp_last``, with their gradients; the
    cache write into a sequence-split cache; the MoE layer with its
    experts split whole (expert parallel) and by their ff slice, with
    every gradient;
  * whole steps, the dry run's own (``mesh_step``: its step, its
    shardings) on real weights from a seed: gemma-2b's l2s decode (also
    ``serve_2d``) and train step, phi3.5-moe (2 KV heads: a KV group per
    device) prefill and train without expert parallelism, zamba2-2.7b's
    train step, nmt-deen-lstm's l2s decode; each reduced.

Ids, slots and every other integer result equal bit for bit; a float
result within FLOAT_TOL of the larger of 1 and its largest magnitude (the
devices sum their parts of a product in another order: float32 rounding),
its infinities where the other's are.
Each case also names the per-device paths it must have gone through, with
the split it must have had there, so that a case cannot pass by falling
back to replicated inputs.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_mesh_worker import CASES, WORLD

WORKER = Path(__file__).with_name("torch_mesh_worker.py")
SRC = Path(__file__).resolve().parents[1] / "src"
FLOAT_TOL = 1e-5
TIMEOUT_S = 420

# each case's per-device paths and their splits (``torch_mesh_worker._spy``)
PATHS = {
    "route and screen": {"route rows split", "screen rows split"},
    "fused vocab split": {"fused vocab split"},
    "ssd_intra heads split": {"ssd_intra heads split"},
    "lookup": {"lookup vocab split"},
    "loss terms": {"gather_last vocab split", "logsumexp_last vocab split"},
    "cache seq split": {"cache seq split"},
    "moe expert split": {"moe expert split"},
    "moe ff split": {"moe ff split"},
    "gemma-2b decode l2s": {"fused vocab split", "lookup vocab split",
                            "cache"},
    "gemma-2b decode l2s serve_2d": {"fused vocab split", "cache seq split"},
    "gemma-2b train": {"lookup vocab split", "gather_last vocab split",
                       "logsumexp_last vocab split"},
    "phi3.5-moe kv2 prefill": {"kv group", "moe expert split"},
    "phi3.5-moe kv2 train ff split": {"kv group", "moe ff split",
                                      "gather_last vocab split"},
    "zamba2-2.7b train": {"ssd heads split", "logsumexp_last vocab split"},
    "nmt-deen-lstm decode l2s": {"fused vocab split", "lookup vocab split"},
}


@pytest.fixture(scope="module")
def exchanged(tmp_path_factory):
    """Every case's results from the eight ranks (rank 0's file)."""
    tmp = tmp_path_factory.mktemp("mesh")
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(tmp / "store"),
         str(tmp / "out.pt")], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * WORLD, (rcs, (tmp / "rank0.log").read_text()[-4000:])
    return torch.load(tmp / "out.pt")


@pytest.mark.parametrize("case", list(CASES))
def test_a_split_mesh_gives_the_unsplit_results(case, exchanged):
    res = exchanged[case]
    assert "error" not in res, res.get("error")
    plain, on = res["plain"], res["mesh"]
    assert len(on) == len(plain) > 0
    for i, (a, b) in enumerate(zip(plain, on)):
        shape = tuple(a.shape)
        assert (tuple(b.shape), b.dtype) == (shape, a.dtype), i
        if a.is_floating_point():
            # an infinity (log Z of a row of sentinels) where the other has
            # one, of the same sign
            fin = a.isfinite()
            assert torch.equal(fin, b.isfinite()), i
            assert torch.equal(a[~fin], b[~fin]), i
            a, b = a[fin], b[fin]
            err = (a - b).abs().max().item() if a.numel() else 0.0
            scale = max(1.0, a.abs().max().item() if a.numel() else 0.0)
            print(f"{case} [{i}] {shape}: max |diff| {err:.3e}")
            assert err <= FLOAT_TOL * scale, (i, err, scale)
        else:
            assert torch.equal(a, b), i
    assert PATHS[case] <= set(res["paths"]), res["paths"]
