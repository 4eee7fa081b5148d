"""The port's SSM pieces against the JAX package's, on the same seeded numpy
inputs (the Pallas kernels in interpret mode, as tests/test_kernels.py runs
them):

  * configs: every ported config, full and ``reduced()``, equals the
    reference's field by field;
  * ``ssd_intra`` (its plain version, on CPU tensors) against
    ``ssd_intra_pallas``: rtol = atol = 1e-4, the reference's own tolerance;
  * ``ssd_chunked`` against the JAX one, with and without a padded tail:
    1e-3 (the tolerance of tests/test_kernels.py's kernel + scan check);
  * ``cache_slot_update`` against the Pallas kernel, float32 and bfloat16,
    slots in range, at S − 1, past the end and negative: bit-identical;
  * ``ssm_forward`` / ``ssm_decode_step`` on weights initialised in JAX:
    atol = 1e-4.

tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.cache_update import cache_slot_update as j_cache_update
from repro.kernels.ssd import ssd_intra_pallas
from repro.layers import ssm as jssm
from repro_torch.configs import REGISTRY, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.cache_update import (cache_slot_update,
                                              cache_slot_update_plain)
from repro_torch.kernels.ssd import ssd_intra, ssd_intra_plain
from repro_torch.layers import ssm as tssm


def _fields(cfg):
    return {f.name: (dataclasses.asdict(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_configs_and_reduced_match_reference(name):
    """Every field the port carries equals the reference's, for the full
    config and for its reduced CPU variant."""
    tcfg, jcfg = get_config(name), j_get_config(name)
    for port, ref in ((tcfg, jcfg), (tcfg.reduced(), jcfg.reduced())):
        for field, value in _fields(port).items():
            want = getattr(ref, field)
            if dataclasses.is_dataclass(want):
                want = dataclasses.asdict(want)
            assert value == want, (port.name, field)


def _ssd_inputs(B, nc, Q, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((B, nc, Q, H, P)).astype(f32),
            rng.standard_normal((B, nc, Q, G, N)).astype(f32),
            rng.standard_normal((B, nc, Q, G, N)).astype(f32),
            (-np.abs(np.cumsum(rng.uniform(0.01, 0.2, (B, nc, Q, H)),
                               axis=2))).astype(f32))


@pytest.mark.parametrize("B,nc,Q,H,P,G,N", [
    (2, 3, 16, 4, 8, 1, 16),          # tests/test_kernels.py's three shapes
    (1, 2, 32, 4, 16, 2, 8),
    (1, 1, 64, 2, 32, 1, 32),
    (2, 1, 7, 4, 8, 2, 16),           # a short, odd chunk (Q = min(chunk, T))
])
def test_ssd_intra_matches_pallas(B, nc, Q, H, P, G, N):
    xw, Bm, Cm, l = _ssd_inputs(B, nc, Q, H, P, G, N, seed=B * nc * Q + H)
    y, S = ssd_intra_pallas(*(jnp.asarray(a) for a in (xw, Bm, Cm, l)),
                            n_groups=G)
    args = [torch.from_numpy(a) for a in (xw, Bm, Cm, l)]
    ty, tS = ssd_intra(*args)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tS.numpy(), np.asarray(S), rtol=1e-4, atol=1e-4)
    py, pS = ssd_intra_plain(*args)       # a CPU tensor takes the plain version
    assert torch.equal(ty, py) and torch.equal(tS, pS)
    assert ops.LAUNCHES["ssd_intra"] == 0


def test_ssd_intra_rejects_bad_groups():
    xw, Bm, Cm, l = (torch.from_numpy(a) for a in
                     _ssd_inputs(1, 1, 8, 3, 4, 2, 4, seed=0))
    with pytest.raises(ValueError, match="G must divide H"):
        ssd_intra(xw, Bm, Cm, l)
    with pytest.raises(ValueError, match="float32"):
        ssd_intra(xw.double(), Bm, Cm, l)


@pytest.mark.parametrize("T", [48, 40], ids=["T48", "T40-padded"])
def test_ssd_chunked_matches_reference(T):
    rng = np.random.default_rng(T)
    B, H, P, G, N, chunk = 2, 4, 8, 1, 16, 16
    f32 = np.float32
    x = rng.standard_normal((B, T, H, P)).astype(f32)
    Bm = rng.standard_normal((B, T, G, N)).astype(f32)
    Cm = rng.standard_normal((B, T, G, N)).astype(f32)
    dt = rng.uniform(0.01, 0.2, (B, T, H)).astype(f32)
    A_log = np.log(rng.uniform(0.5, 4.0, (H,))).astype(f32)
    D = rng.standard_normal((H,)).astype(f32)
    y, h = jssm.ssd_chunked(*(jnp.asarray(a) for a in (x, Bm, Cm, dt, A_log, D)),
                            chunk)
    ty, th = tssm.ssd_chunked(*(torch.from_numpy(a) for a in
                                (x, Bm, Cm, dt, A_log, D)), chunk)
    assert ty.shape == (B, T, H, P) and th.shape == (B, H, P, N)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slot", [0, 127, 128, 255, 261, -1],
                         ids=["0", "127", "S/2", "S-1", "S+5", "neg"])
def test_cache_slot_update_matches_pallas(dtype, slot):
    """Per row, the Pallas kernel's write (S = 256, a multiple of its
    128-row blocks): one scalar slot for all rows, and per-row slots."""
    B, S, KV, hd = 3, 256, 2, 8
    rng = np.random.default_rng(S + slot)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    cache = jnp.asarray(rng.standard_normal((B, S, KV, hd)), jd)
    upd = jnp.asarray(rng.standard_normal((B, KV, hd)), jd)

    def port(c):                       # bf16 goes through float32 exactly
        return torch.from_numpy(np.array(c, np.float32)).to(td)

    per_row = np.asarray([slot, 3, S + 5], np.int32)
    for arg, slots in ((slot, [slot] * B), (torch.from_numpy(per_row), per_row)):
        want = np.stack([np.asarray(j_cache_update(cache[b], upd[b],
                                                   jnp.int32(slots[b])),
                                    np.float32) for b in range(B)])
        tc = port(cache)
        got = cache_slot_update(tc, port(upd), arg)
        assert got is tc                          # in place
        np.testing.assert_array_equal(got.float().numpy(), want)
        plain = cache_slot_update_plain(port(cache), port(upd), arg)
        assert torch.equal(plain, got)
    assert ops.LAUNCHES["cache_slot_update"] == 0


def test_cache_slot_update_validates_inputs():
    cache = torch.zeros((2, 5, 2, 4))
    with pytest.raises(ValueError, match="does not match"):
        cache_slot_update(cache, torch.zeros((2, 2, 3)), 1)
    with pytest.raises(ValueError, match="int32"):
        cache_slot_update(cache, torch.zeros((2, 2, 4)),
                          torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cache_slot_update(cache.double(), torch.zeros((2, 2, 4)).double(), 1)


@pytest.fixture(scope="module")
def mamba():
    jcfg = j_get_config("mamba2-1.3b").reduced()
    tcfg = get_config("mamba2-1.3b").reduced()
    jp = jssm.ssm_init(jax.random.key(3), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def test_ssm_forward_and_decode_match_reference(mamba):
    jcfg, tcfg, jp, tp = mamba
    rng = np.random.default_rng(11)
    B, T = 2, 40
    u = rng.standard_normal((B, T + 3, jcfg.d_model)).astype(np.float32)
    jy, jc = jssm.ssm_forward(jp, jnp.asarray(u[:, :T]), jcfg)
    ty, tc = tssm.ssm_forward(tp, torch.from_numpy(u[:, :T]), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
    for k in ("conv_tail", "state"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-4)
    for i in range(3):
        u1 = u[:, T + i:T + i + 1]
        jy, jc = jssm.ssm_decode_step(jp, jnp.asarray(u1), jc, jcfg)
        ty, tc = tssm.ssm_decode_step(tp, torch.from_numpy(u1), tc, tcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
        np.testing.assert_allclose(tc["state"].numpy(), np.asarray(jc["state"]),
                                   atol=1e-4)
    # the decode recurrence continues prefill: forward over all T + 3 tokens
    ty_full, _ = tssm.ssm_forward(tp, torch.from_numpy(u), tcfg)
    np.testing.assert_allclose(ty.numpy(), ty_full[:, -1:].numpy(), atol=1e-4)
