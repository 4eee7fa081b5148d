"""The port's moe family (``mixtral-8x7b``, ``phi3.5-moe-42b-a6.6b``) and
its sliding-window ring cache against the JAX package, on reduced configs
(2 layers, d = 128, 4 experts, mixtral's window 64) with the reference's
weights carried across with ``params_from_numpy``:

  * the configs' published fields and parameter counts (the rows of the
    reference's ``tests/test_configs.py``);
  * ``moe_apply`` (the twin of ``tests/test_layers_moe_mlp.py``): expert
    ids bit-identical to the reference's, outputs within atol = 1e-5 and
    the aux loss within 1e-6; the same dropped slots at capacity factors
    1e-9 and 0.5; the gate-weighted expert sum at an ample capacity; the
    capacity formula; each batch row routed on its own (a B = 1 call is
    bit for bit its row of a B = 4 one, which streams rely on);
  * the ring-buffer cache (the twins of ``tests/test_layers_attention.py``'s
    three ring and window tests): ``attn_decode`` on a ring against the
    reference's over 3× the window (atol = 1e-5), the tensor-pos ring path
    bit for bit against the int path, ring decode against a windowed
    forward (atol = 1e-5); reduced mixtral's ``decode_step`` on its ring
    over 3× the window against the reference's (atol = 1e-4);
  * serving, bit-identical on the CPU to the reference engine: greedy
    ``generate`` past the window through ``exact``, ``screened`` and
    ``screened-cuda`` on mixtral and phi, ``beam_search``, a
    ``DecodeStream`` with a join after the ring wrapped, a
    ``SpecDecodeStream`` (exact verifying a random screen's drafts) that
    rejects and rolls the ring back across a wrap, a ``PagedDecodeStream``
    on phi (no window), paged mixtral refused as in the reference, and a
    prompt longer than the ring refused (the reference mis-places it);
  * the moe leaves crossing ``interop`` in both directions, bf16 included.

The softmax matrix (``lm_head``) is scaled × 20, so greedy steps are
decided by gaps far above float32 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.layers import attention as jattn
from repro.layers import moe as jmoe
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.kvpool import PagePool as JPool
from repro.serving.request import ServeRequest as JRequest
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.layers import attention as tattn
from repro_torch.layers import moe as tmoe
from repro_torch.models import Model
from repro_torch.serving import DecodeEngine, PagePool, ServeRequest
from torch_serving_fixtures import TWIN, _build

MIXTRAL, PHI = "mixtral-8x7b", "phi3.5-moe-42b-a6.6b"
ARCHS = (MIXTRAL, PHI)
W_RED = 64                         # reduced mixtral's window


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(name, cf=None):
    j, t = j_get_config(name).reduced(), get_config(name).reduced()
    if cf is not None:
        j = dataclasses.replace(j, moe=dataclasses.replace(j.moe,
                                                           capacity_factor=cf))
        t = dataclasses.replace(t, moe=dataclasses.replace(t.moe,
                                                           capacity_factor=cf))
    return j, t


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_moe_configs_and_param_counts(name):
    """The published fields of ``tests/test_configs.py``, the reduced
    contract (≤ 4 experts), and the analytic counts equal to the
    reference's: mixtral 46.7e9 within 15 %, under 14e9 active."""
    cfg, ref = get_config(name), j_get_config(name)
    want = dict(num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8)
    for k, v in want.items():
        assert getattr(cfg, k) == v
    assert cfg.source == ref.source and cfg.moe == cfg.moe.__class__(
        **dataclasses.asdict(ref.moe))
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    r = cfg.reduced()
    assert r.moe.num_experts <= 4 and r.num_layers == 2 and r.d_model <= 128
    if name == MIXTRAL:
        assert (cfg.d_ff, cfg.vocab_size, cfg.sliding_window,
                cfg.moe.num_experts) == (14336, 32_000, 4096, 8)
        assert abs(cfg.param_count() - 46.7e9) / 46.7e9 < 0.15
        assert cfg.active_param_count() < 14e9
        assert r.sliding_window == W_RED
    else:
        assert (cfg.d_ff, cfg.vocab_size, cfg.norm, cfg.moe.num_experts) == \
            (6400, 32_064, "layernorm", 16)
        assert cfg.sliding_window is None


# -- moe_apply ----------------------------------------------------------------

def _moe_both(name, x, cf=None, seed=0):
    jc, tc = _cfgs(name, cf)
    jp = jmoe.moe_init(jax.random.key(seed), jc)
    tp = params_from_numpy(_np_tree(jp))
    jy, ja = jmoe.moe_apply(jp, jnp.asarray(x), jc)
    ty, ta = tmoe.moe_apply(tp, _t(x), tc)
    _, je, _ = jmoe._route(jp, jnp.asarray(x.reshape(-1, jc.d_model)), jc)
    _, te, _ = tmoe._route(tp, _t(x.reshape(-1, jc.d_model)), tc)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, jy=np.asarray(jy), ty=ty.numpy(),
                ja=float(ja), ta=float(ta), je=np.asarray(je), te=te.numpy())


@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_matches_reference(name):
    """Expert ids bit-identical, outputs within atol 1e-5, aux within 1e-6
    and positive (the reference's shapes-and-aux test)."""
    x = np.random.default_rng(1).standard_normal((3, 16, 128)).astype(
        np.float32)
    r = _moe_both(name, x)
    np.testing.assert_array_equal(r["te"], r["je"])
    np.testing.assert_allclose(r["ty"], r["jy"], atol=1e-5)
    assert abs(r["ta"] - r["ja"]) <= 1e-6 and r["ta"] > 0
    assert r["ty"].shape == x.shape and np.isfinite(r["ty"]).all()


@pytest.mark.parametrize("cf", [1e-9, 0.5])
def test_moe_capacity_drops_the_reference_slots(cf):
    """At capacity factors 1e-9 and 0.5 the port drops the slots the
    reference's cumsum positions drop (token-major, k-minor), and the rows
    the drops empty are the reference's zero rows."""
    x = np.random.default_rng(2).standard_normal((2, 64, 128)).astype(
        np.float32)
    r = _moe_both(MIXTRAL, x, cf=cf)
    C, E, K = tmoe.capacity(64, r["tc"]), 4, 2
    je = r["je"].reshape(2, 64 * K)
    onehot = (je[..., None] == np.arange(E)).astype(np.int64)
    want = np.sum((np.cumsum(onehot, axis=1) - onehot) * onehot, -1) < C
    _, keep = tmoe._slots(_t(r["te"].reshape(2, 64 * K)), E, C)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert (~want).sum() > 0
    np.testing.assert_allclose(r["ty"], r["jy"], atol=1e-5)
    zero_t = np.abs(r["ty"]).sum(-1) < 1e-6
    np.testing.assert_array_equal(zero_t, np.abs(r["jy"]).sum(-1) < 1e-6)
    if cf == 1e-9:                       # the reference's floor of 8 slots
        assert zero_t[0].sum() >= 24


def test_moe_is_weighted_expert_sum_and_capacity_formula():
    """With capacity ample (cf 8) each token's output is the gate-weighted
    sum of its top-k experts' SwiGLU FFNs; ``capacity`` equals the
    reference's (a multiple of 8, at least 8)."""
    x = np.random.default_rng(3).standard_normal((1, 6, 128)).astype(
        np.float32)
    r = _moe_both(MIXTRAL, x, cf=8.0)
    tp, tc = r["tp"], r["tc"]
    xt = _t(x[0])
    gv, ei, _ = tmoe._route(tp, xt, tc)
    want = torch.zeros_like(xt)
    for i in range(6):
        for j in range(2):
            e = int(ei[i, j])
            g = torch.nn.functional.silu(xt[i] @ tp["w_gate"][e]) * \
                (xt[i] @ tp["w_up"][e])
            want[i] += gv[i, j] * (g @ tp["w_down"][e])
    np.testing.assert_allclose(r["ty"][0], want.numpy(), atol=1e-4, rtol=1e-3)
    for T in (1, 6, 64, 513):
        for name in ARCHS:
            jc, tc = _cfgs(name)
            assert tmoe.capacity(T, tc) == jmoe.capacity(T, jc)
    assert tmoe.capacity(64, tc) % 8 == 0


def test_moe_rows_are_routed_on_their_own():
    """A B = 1 call equals its row of a B = 4 call bit for bit (each batch
    row is one routing group)."""
    _, tc = _cfgs(PHI)
    tp = tmoe.moe_init(torch.Generator().manual_seed(4), tc)
    x = torch.randn((4, 24, 128), generator=torch.Generator().manual_seed(5))
    y4, _ = tmoe.moe_apply(tp, x, tc)
    for b in range(4):
        y1, _ = tmoe.moe_apply(tp, x[b:b + 1], tc)
        assert torch.equal(y1[0], y4[b])


# -- the ring-buffer cache ----------------------------------------------------

def _attn_setup(W, T=12, seed=0):
    jcfg = dataclasses.replace(j_get_config(MIXTRAL).reduced(),
                               sliding_window=W)
    tcfg = dataclasses.replace(get_config(MIXTRAL).reduced(),
                               sliding_window=W)
    jp = jattn.attn_init(jax.random.key(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal(
        (2, T, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, params_from_numpy(_np_tree(jp)), x


def test_ring_decode_matches_reference_and_windowed_forward():
    """W = 4 over 12 positions (3× the window): the port's ring decode
    equals the reference's outputs and caches (atol 1e-5), and a windowed
    forward (atol 1e-5, the reference's own tolerance)."""
    W = 4
    jcfg, tcfg, jp, tp, x = _attn_setup(W)
    jc = jattn.init_cache(jcfg, 2, 12, dtype=jnp.float32, window=W)
    tc = tattn.init_cache(tcfg, 2, 12, dtype=torch.float32, window=W)
    assert tc["k"].shape[1] == W
    outs = []
    for t in range(12):
        jo, jc = jattn.attn_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, t, jcfg,
                                   window=W)
        to, tc = tattn.attn_decode(tp, _t(x[:, t:t + 1]), tc, t, tcfg,
                                   window=W)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
        outs.append(to)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   atol=1e-5)
    pos = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    full = tattn.attn_forward(tp, _t(x), tcfg, pos, window=W)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=1e-5)


def test_vector_pos_ring_decode_bit_identical_to_scalar():
    """The tensor-pos ring path (slots wrapped on the device) writes the
    same cache and gives the same outputs as the int path, bit for bit;
    rows at different depths wrap on their own."""
    W = 4
    _, tcfg, _, tp, x = _attn_setup(W)
    cs = tattn.init_cache(tcfg, 2, 12, dtype=torch.float32, window=W)
    cv = tattn.init_cache(tcfg, 2, 12, dtype=torch.float32, window=W)
    for t in range(12):
        os_, _ = tattn.attn_decode(tp, _t(x[:, t:t + 1]), cs, t, tcfg)
        ov, _ = tattn.attn_decode(tp, _t(x[:, t:t + 1]), cv,
                                  torch.full((2,), t, dtype=torch.int32),
                                  tcfg)
        assert torch.equal(os_, ov)
    assert torch.equal(cs["k"], cv["k"]) and torch.equal(cs["v"], cv["v"])
    # row 1 three positions ahead of row 0: each row equals the int path's
    # decode of its own sequence (run at the same width, 2 rows)
    c0 = tattn.init_cache(tcfg, 2, 12, dtype=torch.float32, window=W)
    c1 = tattn.init_cache(tcfg, 2, 12, dtype=torch.float32, window=W)
    cv = tattn.init_cache(tcfg, 2, 12, dtype=torch.float32, window=W)
    two = lambda r, t: _t(x[r:r + 1, t:t + 1]).expand(2, 1, -1).contiguous()
    for t in range(3):
        tattn.attn_decode(tp, two(1, t), c1, t, tcfg)
    for k in ("k", "v"):
        cv[k][1] = c1[k][0]
    for t in range(8):
        o0, _ = tattn.attn_decode(tp, two(0, t), c0, t, tcfg)
        o1, _ = tattn.attn_decode(tp, two(1, t + 3), c1, t + 3, tcfg)
        xv = torch.stack([_t(x[0, t]), _t(x[1, t + 3])])[:, None]
        ov, _ = tattn.attn_decode(tp, xv, cv,
                                  torch.tensor([t, t + 3], dtype=torch.int32),
                                  tcfg)
        assert torch.equal(ov[0], o0[0]) and torch.equal(ov[1], o1[0])
    assert torch.equal(cv["k"][0], c0["k"][0])
    assert torch.equal(cv["k"][1], c1["k"][0])


# -- reduced models and engines ---------------------------------------------------

@pytest.fixture(scope="module")
def mix():
    return _build(MIXTRAL, 21, "lm_head", 20.0)


@pytest.fixture(scope="module")
def phi():
    return _build(PHI, 22, "lm_head", 20.0)


def _engines(fx, max_len):
    teng = DecodeEngine(fx["tmodel"], fx["tparams"], screen=fx["tscreen"],
                        max_len=max_len, device="cpu")
    jeng = JEngine(fx["jmodel"], fx["jparams"], screen=fx["jscreen"],
                   max_len=max_len)
    return teng, jeng


def _prompts(fx, n, length, seed):
    return np.random.default_rng(seed).integers(
        0, fx["vocab"], (n, length)).astype(np.int32)


def test_mixtral_ring_decode_over_three_windows_matches_reference(mix):
    """Reduced mixtral: prefill 8 tokens into its 64-slot ring, then 184
    decode steps (3× the window): every hidden state within atol 1e-4 of
    the reference's (its jitted ``decode_step``), the rings too; the
    model's forward and aux within the same tolerance."""
    jm, jp, tm, tp = mix["jmodel"], mix["jparams"], mix["tmodel"], \
        mix["tparams"]
    toks = _prompts(mix, 2, 3 * W_RED, 9)
    jh, ja = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    th, ta = tm.forward(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    assert abs(float(ta) - float(ja)) <= 1e-6
    jcache = jm.init_cache(2, 16, dtype=jnp.float32)
    tcache = tm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    assert tcache["attn"]["k"].shape[2] == W_RED == jcache["attn"]["k"].shape[2]
    jh, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])}, jcache)
    th, _ = tm.prefill(tp, {"tokens": _t(toks[:, :8])}, tcache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    dec = jax.jit(jm.decode_step)
    for t in range(8, 3 * W_RED):
        jh1, jcache = dec(jp, jnp.asarray(toks[:, t]), jcache, t)
        th1, _ = tm.decode_step(tp, _t(toks[:, t]), tcache, t)
        np.testing.assert_allclose(th1.numpy(), np.asarray(jh1), atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache["attn"][k].numpy(),
                                   np.asarray(jcache["attn"][k]), atol=1e-4)


def test_mixtral_ring_decode_equals_a_windowed_forward(mix):
    """With a capacity that drops nothing (cf = E / k, so no token's output
    depends on the others'), prefill + ring decode over 2.5 windows gives
    the windowed forward's hidden states (atol 1e-4)."""
    tcfg = dataclasses.replace(get_config(MIXTRAL).reduced(), moe=dataclasses.
                               replace(get_config(MIXTRAL).reduced().moe,
                                       capacity_factor=2.0))
    tm, tp = Model(tcfg), mix["tparams"]
    T = 160
    toks = _prompts(mix, 2, T, 10)
    full, _ = tm.forward(tp, {"tokens": _t(toks)})
    cache = tm.init_cache(2, T, dtype=torch.float32, device="cpu")
    h, _ = tm.prefill(tp, {"tokens": _t(toks[:, :20])}, cache)
    np.testing.assert_allclose(h.numpy(), full[:, :20].numpy(), atol=1e-4)
    for t in range(20, T):
        h1, _ = tm.decode_step(tp, _t(toks[:, t]), cache, t)
        np.testing.assert_allclose(h1.numpy(), full[:, t].numpy(), atol=1e-4)


@pytest.mark.parametrize("name,tname,new", [
    (MIXTRAL, "exact", 56), (MIXTRAL, "screened", 56), (PHI, "exact", 8),
    (PHI, "screened-cuda", 8)])
def test_greedy_generate_matches_reference(mix, phi, name, tname, new):
    """Greedy tokens bit-identical to the reference engine's; mixtral's
    run past its 64-slot window (prompts of 12, 56 new), wrapping the
    ring."""
    fx = mix if name == MIXTRAL else phi
    teng, jeng = _engines(fx, max_len=24)
    ps = _prompts(fx, 3, 12, 5)
    got = teng.generate(ps, new, head=tname).tokens
    want = np.asarray(jeng.generate(ps, new, head=TWIN.get(tname, tname)).tokens)
    np.testing.assert_array_equal(got, want)


def test_beam_search_matches_reference(mix):
    """beam_search through screened-cuda past the window: the same top
    beam as the reference's screened-pallas, its score within 1e-4."""
    teng, jeng = _engines(mix, max_len=24)
    p = _prompts(mix, 1, 40, 6)[0]
    got = teng.beam_search(p, 3, 32, head="screened-cuda")
    want = jeng.beam_search(p, 3, 32, head="screened-pallas")
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=1e-4)


def _run_stream(stream, requests, joins=None):
    """Drive ``stream``: request i joins at the first tick from ``joins[i]``
    (0 for all by default) with a free slot, in order. → {i: tokens}."""
    joins = joins or [0] * len(requests)
    done, tick, nxt = {}, 0, 0
    while len(done) < len(requests):
        while nxt < len(requests) and joins[nxt] <= tick and \
                stream.free_slots:
            stream.join(requests[nxt], tag=nxt)
            nxt += 1
        for tag, _, toks in stream.step():
            done[tag] = toks
        tick += 1
        assert tick < 400, "stream never drained"
    return done


def test_decode_stream_join_after_a_wrap(mix):
    """A width-2 stream: request 0 decodes past its ring's wrap, request 1
    joins at tick 60, after it; both equal the reference stream's tokens
    and solo generate's."""
    teng, jeng = _engines(mix, max_len=80)
    ps = _prompts(mix, 2, 10, 7)
    reqs = [(10, 66), (9, 20)]
    t_reqs = [ServeRequest(prompt=ps[i][:n], max_new=m)
              for i, (n, m) in enumerate(reqs)]
    j_reqs = [JRequest(prompt=ps[i][:n], max_new=m)
              for i, (n, m) in enumerate(reqs)]
    got = _run_stream(teng.open_stream("exact", width=2), t_reqs, [0, 60])
    want = _run_stream(jeng.open_stream("exact", width=2), j_reqs, [0, 60])
    for i, r in enumerate(t_reqs):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
        solo = teng.generate(r.prompt[None], r.max_new).tokens[0]
        np.testing.assert_array_equal(got[i], solo)


def test_spec_stream_rolls_the_ring_back_across_a_wrap(mix):
    """A width-3 SpecDecodeStream, exact verifying the random screen's
    drafts (draft_len 4): prompts of 12, 60 new, so rounds draft across
    the 64-slot ring's wrap; drafts are rejected, rows restored from the
    snapshot ring (the ring K/V caches whole); tokens equal plain exact
    generate's and the reference spec stream's."""
    teng, jeng = _engines(mix, max_len=80)
    ps = _prompts(mix, 3, 12, 8)
    base = teng.generate(ps, 60, head="exact").tokens
    ts = teng.open_spec_stream("screened", "exact", width=3, draft_len=4)
    got = _run_stream(ts, [ServeRequest(prompt=p, max_new=60) for p in ps])
    js = jeng.open_spec_stream("screened", "exact", width=3, draft_len=4)
    want = _run_stream(js, [JRequest(prompt=p, max_new=60) for p in ps])
    for i in range(3):
        np.testing.assert_array_equal(got[i], base[i])
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    c = ts.spec_counters()
    assert c == js.spec_counters()
    assert c["accepted"] < c["drafted"] and ts.restored_rows > 0
    assert ts._snapshot
    ts.join(ServeRequest(prompt=ps[0], max_new=3))
    ring = ts._slab.spec.ring
    # the stacked ring K and V: (n_max, L, W, S = window, KV, hd) each
    assert len(ring) == 2 and ring[0].shape[:4] == (4, 2, 3, W_RED)


def test_paged_stream_on_phi_and_paged_mixtral_refused(mix, phi):
    """phi (no window) decodes over the page store: a width-2
    PagedDecodeStream over 4 requests sharing an 8-token prefix equals the
    reference's paged stream and solo generate bit for bit, with the same
    pool telemetry; mixtral's ring is refused, as in the reference."""
    teng, jeng = _engines(phi, max_len=24)
    rng = np.random.default_rng(3)
    tmpl = rng.integers(0, phi["vocab"], 8)
    ps = [np.concatenate([tmpl, rng.integers(0, phi["vocab"], 4)]).astype(
        np.int32) for _ in range(4)]
    tpool, jpool = PagePool(64, 4), JPool(64, 4)
    got = _run_stream(teng.open_paged_stream(tpool, width=2),
                      [ServeRequest(prompt=p, max_new=5) for p in ps],
                      [0, 0, 3, 4])
    want = _run_stream(jeng.open_paged_stream(jpool, width=2),
                       [JRequest(prompt=p, max_new=5) for p in ps],
                       [0, 0, 3, 4])
    for i, p in enumerate(ps):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
        np.testing.assert_array_equal(got[i],
                                      teng.generate(p[None], 5).tokens[0])
    assert tpool.telemetry() == jpool.telemetry()
    assert tpool.store.k.shape[0] == 2 and ("exact", "greedy-paged") in \
        teng.compiled_step_counts()
    meng, mjeng = _engines(mix, max_len=24)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        PagePool(8, 4).bind(meng)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        JPool(8, 4).bind(mjeng)


def test_prompt_longer_than_the_ring_is_refused(mix):
    """The prefill writes the prompt at slots [0, T): a prompt longer than
    the 64-slot ring is refused by the engine and by the model (the
    reference writes its last 64 positions at slots [0, 64), out of their
    ring places); a prompt that fits decodes past max_len."""
    teng, _ = _engines(mix, max_len=24)
    with pytest.raises(ValueError, match="ring"):
        teng.generate(_prompts(mix, 1, W_RED + 1, 1), 2)
    tm = mix["tmodel"]
    cache = tm.init_cache(1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        tm.prefill(mix["tparams"], {"tokens": _t(_prompts(mix, 1, 70, 2))},
                   cache)
    assert teng.generate(_prompts(mix, 1, W_RED, 1), 30).tokens.shape == (1, 30)


def test_moe_leaves_cross_interop_both_ways_in_bf16():
    """The moe leaves (w_router (L, d, E), w_gate / w_up (L, E, d, ff),
    w_down (L, E, ff, d)) of a bf16 reference model cross into the port
    and back bit for bit."""
    jcfg = dataclasses.replace(j_get_config(PHI).reduced(), dtype="bfloat16")
    from repro.models.model import Model as JModel
    jp = JModel(jcfg).init(jax.random.key(1))
    tp = params_from_numpy(_np_tree(jp))
    moe = tp["stack"]["blocks"]["moe"]
    assert moe["w_router"].shape == (2, 128, 4) and \
        moe["w_gate"].shape == (2, 4, 128, 256) and \
        moe["w_down"].shape == (2, 4, 256, 128)
    assert all(t.dtype == torch.bfloat16 for t in moe.values())
    back = params_to_numpy(tp, bf16=ml_dtypes.bfloat16)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_np_tree(jp))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16) if a.dtype.itemsize
                                      == 2 else a, b.view(np.uint16)
                                      if b.dtype.itemsize == 2 else b)
