"""The port's gather-matmul (repro_torch.kernels.screen) against the JAX
package's Pallas kernel (interpret mode) on the shared id patterns
(repro_torch.testing.screen_id_patterns), and the wrapper's rule for the
parts each tile is cut into. On a CPU tensor the wrapper runs its plain
version; tests/test_torch_cuda.py holds the CUDA kernel to it on the card.

Sentinels here are ids >= n_blk only: the reference reads a negative id as
a valid tile (ROADMAP Queue 3), the port as a sentinel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.screen import screened_logits as j_screen
from repro_torch.kernels import ops
from repro_torch.kernels.fused_topk import fused_screened_topk
from repro_torch.kernels.ref import NEG_INF, topk_desc
from repro_torch.kernels.screen import screen_parts, screened_logits
from repro_torch.testing import screen_id_patterns

V_BLK = 128
TOL = dict(rtol=1e-5, atol=1e-5)


def test_screened_logits_patterns_match_pallas():
    """Every pattern at a ragged width (d = 30), B = 20 rows (the beam's
    4 x 5), K = 8, with -1 sentinels read as n_blk: the port equals the
    Pallas kernel, and the fused path's values equal the masked logits under
    a stable top-k over the whole row."""
    rng = np.random.default_rng(30)
    L, d, B, K = 1000, 30, 20, 8                 # 8 blocks, the last padded
    W = rng.standard_normal((L, d)).astype(np.float32)
    b = rng.standard_normal((L,)).astype(np.float32)
    h = rng.standard_normal((B, d)).astype(np.float32)
    jw, jb = jops.pack_head_blocks(jnp.asarray(W), jnp.asarray(b))
    tw, tb = ops.pack_head_blocks(torch.from_numpy(W), torch.from_numpy(b))
    n_blk = tw.shape[0]
    th = torch.from_numpy(h)
    pats = screen_id_patterns(torch.Generator().manual_seed(3), n_blk, B, K)
    assert set(pats) == {"random", "repeated_in_row", "shared_across_rows",
                         "one_cluster", "sentinels_and_tile0", "beam"}
    for name, ids in pats.items():
        ids = torch.where(ids < 0, n_blk, ids)
        want = np.asarray(j_screen(jw, jb, jnp.asarray(h),
                                   jnp.asarray(ids.numpy())))
        got = screened_logits(tw, tb, th, ids)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=name)
        valid = (ids < n_blk)[..., None]
        row = torch.where(valid, got, NEG_INF).reshape(B, -1)
        _, vals, _ = fused_screened_topk(tw, tb, th, ids, k=K * V_BLK)
        assert torch.equal(vals, topk_desc(row, K * V_BLK)[0]), name


@pytest.mark.parametrize("B,K,d,parts", [
    (1, 16, 500, 8), (4, 16, 500, 4), (8, 16, 500, 2), (20, 16, 500, 1),
    (4, 200, 500, 1), (4, 16, 2560, 8), (8, 16, 2560, 4), (20, 16, 2560, 2),
    (1, 1, 30, 8)])
def test_screen_parts_fills_the_sms(B, K, d, parts):
    """The fewest parts whose B·K·P blocks put ⌈d / 1024⌉ on each of the
    H100's 132 SMs, else 8."""
    got = screen_parts(B, K, d, 132)
    assert got == parts
    need = 132 * -(-d // 1024)
    assert B * K * got >= need or got == 8
    assert got == 1 or B * K * (got // 2) < need
