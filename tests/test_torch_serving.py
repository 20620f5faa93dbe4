"""The port's serving stack against the JAX reference on the CPU: the
seeded KV quantizer, the paged pool's writes and reads, the layout's byte
accounting, the allocator and scheduler, and the continuous-batching
engine end to end; plus the port's import isolation.

The engine runs ``reduce_for_smoke`` configs with float32 activations, so
greedy tokens must be equal and logits agree within 1e-4 (matmuls sum in
other orders; a last-ulp difference in K or V can move an SR code by one
level, which moves a logit by far less).  The reference engine runs with
``policy="device"``, its green path."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_for_smoke as j_reduce
from repro.core import backend as j_backend
from repro.engine import seeds as j_seeds
from repro.models import Model as JModel
from repro.serving import KVCacheConfig as JKV
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro.serving import kvcache as j_kv
from repro.serving import plan_kv_layout as j_plan
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.engine import seeds as t_seeds
from repro_torch.kernels import quant_blockwise as t_qk
from repro_torch.launch.steps import make_serve_step
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (KVCacheConfig, PageAllocator, Request,
                                 Scheduler, ServeEngine, kvcache,
                                 plan_kv_layout)
from torch_threads import one_thread  # noqa: F401

S, GEN, T = 8, 6, 4                    # prompt len, gen budget, page tokens
#: The dense archs beside qwen1.5-4b (GQA with n_heads x d_head !=
#: d_model, qk-norm, 40 KV heads with QKV bias).
DENSE_TRIO = ["mistral-nemo-12b", "qwen3-32b", "qwen1.5-32b"]
REPO = Path(__file__).resolve().parents[1]


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _words(a):
    return np.asarray(a).view(np.int32)


# ------------------------------------------------------ seeded quantizer
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("nbt,g", [(4, 64), (1, 32), (40, 64)])
def test_seeded_quantizer_bit_equal_to_jax_vmap(bits, nbt, g):
    """One seed per token, counters restarting per token: the reference's
    ``jax.vmap(quantize_blocks(..., impl="jnp"))`` bit for bit."""
    n_tok = 7
    x = _normal((n_tok, nbt, g), nbt * g + bits, 1.7)
    seeds = np.asarray([0, 1, 12345, 2**31 - 1, 2**31, 2**32 - 1, 7927],
                       np.int64)
    pj, zj, rj = jax.vmap(lambda bl, sd: j_backend.quantize_blocks(
        bl, bits, sd, impl="jnp"))(jnp.asarray(x),
                                   jnp.asarray(seeds.astype(np.uint32)))
    pt, zt, rt = t_qk.quant_pack(torch.from_numpy(x.reshape(-1, g)), bits,
                                 torch.from_numpy(seeds), rows_per_seed=nbt)
    np.testing.assert_array_equal(pt.numpy(),
                                  _words(pj).reshape(n_tok * nbt, -1))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj).reshape(-1))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).reshape(-1))


def test_seed_table_of_one_run_is_the_plain_seed():
    x = torch.from_numpy(_normal((9, 64), 2))
    one = t_qk.quant_pack(x, 4, torch.tensor([2**32 - 9]), rows_per_seed=9)
    plain = t_qk.quant_pack(x, 4, 2**32 - 9)
    for a, b in zip(one, plain):
        assert torch.equal(a, b)


def test_seed_table_shape_is_checked():
    x = torch.from_numpy(_normal((8, 64), 3))
    with pytest.raises(ValueError, match="seed table"):
        t_qk.quant_pack(x, 4, torch.zeros(3, dtype=torch.int64),
                        rows_per_seed=4)
    with pytest.raises(ValueError, match="rows_per_seed"):
        t_qk.quant_pack(x, 4, 5, rows_per_seed=4)


# ---------------------------------------------------------------- layout
def _layouts(bits, group, page_tokens, n_pages, hkv, dh, n_layers=3):
    kw = dict(n_layers=n_layers, n_kv_heads=hkv, d_head=dh)
    return (plan_kv_layout(KVCacheConfig(bits=bits, group_size=group,
                                         page_tokens=page_tokens,
                                         n_pages=n_pages), **kw),
            j_plan(JKV(bits=bits, group_size=group, page_tokens=page_tokens,
                       n_pages=n_pages), **kw))


LAYOUT_PROPS = ("quantized", "elems_per_token", "blocks_per_token",
                "words_per_block", "words_per_page", "null_page",
                "page_bytes", "pool_bytes", "f32_page_bytes",
                "f32_pool_bytes", "total_words", "group_size")


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
@pytest.mark.parametrize("group,page_tokens,hkv,dh", [
    (64, 4, 4, 16), (64, 16, 20, 128), (32, 16, 8, 128), (256, 8, 2, 16),
    (128, 1, 4, 32)])
def test_layout_bytes_equal_reference(bits, group, page_tokens, hkv, dh):
    t, j = _layouts(bits, group, page_tokens, 11, hkv, dh)
    for prop in LAYOUT_PROPS:
        assert getattr(t, prop) == getattr(j, prop), prop
    assert list(t.page_segments()) == list(j.page_segments())
    pool = kvcache.init_kv_pool(t, device="cpu")
    assert kvcache.pool_nbytes(pool) == t.pool_bytes
    jpool = j_kv.init_kv_pool(j)
    assert {k: tuple(v.shape) for k, v in pool.items()} == \
        {k: v.shape for k, v in jpool.items()}


def test_served_layout_is_the_one_chip_smoke_checks():
    """qwen1.5-4b at 4-bit, G=64, 16-token pages, 4 slots of 1031 tokens."""
    cfg = T_ARCHS["qwen1.5-4b"]
    n_pages = 4 * -(-(1000 + 32 - 1) // 16)
    lay = plan_kv_layout(KVCacheConfig(bits=4, group_size=64,
                                       page_tokens=16, n_pages=n_pages),
                         n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                         d_head=cfg.d_head)
    assert (n_pages, lay.page_bytes, lay.pool_bytes, lay.f32_pool_bytes) == (
        260, 51_200, 532_480_000, 3_407_872_000)


@pytest.mark.parametrize("name", DENSE_TRIO)
def test_dense_trio_layouts_are_the_ones_chip_smoke_checks(name):
    """Each of the trio's full-size KV layouts at phase 18's traffic and
    depth (2 slots of 17 pages, 4-bit, G = 64, 16-token pages) equals the
    reference's, and its pool the reckoning ``chip_smoke.py`` holds the
    card's to; qwen1.5-32b's K (or V) rows are 80 blocks a token (1,280 a
    16-token page), the others' 16."""
    import chip_smoke

    cfg = dataclasses.replace(T_ARCHS[name],
                              n_layers=chip_smoke.DENSE_SERVE_LAYERS[name])
    kw = dict(bits=4, group_size=64, page_tokens=16,
              n_pages=2 * chip_smoke.DENSE_PAGES)
    geo = dict(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
               d_head=cfg.d_head)
    t, j = plan_kv_layout(KVCacheConfig(**kw), **geo), j_plan(JKV(**kw),
                                                               **geo)
    for prop in LAYOUT_PROPS:
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.pool_bytes == chip_smoke.dense_reckon(cfg, t.page_bytes)["pool"]
    assert cfg.n_layers == J_ARCHS[name].n_layers     # served whole
    assert t.blocks_per_token == (80 if name == "qwen1.5-32b" else 16)


def test_plan_kv_layout_validates():
    mk = lambda **kw: plan_kv_layout(KVCacheConfig(**kw), n_layers=2,
                                     n_kv_heads=4, d_head=16)
    with pytest.raises(ValueError, match="bits"):
        mk(bits=3)
    with pytest.raises(ValueError, match="divide"):
        mk(group_size=48)
    with pytest.raises(ValueError, match="offload"):
        mk(policy="bogus")
    for policy in ("host", "pinned-paged"):
        assert mk(policy=policy).policy == policy
    with pytest.raises(ValueError, match="page_tokens"):
        mk(page_tokens=0)
    lay4, lay16 = mk(bits=4), mk(bits=16)
    assert lay4.f32_pool_bytes / lay4.pool_bytes >= 3.0
    assert lay16.pool_bytes == lay16.f32_pool_bytes // 2


# ------------------------------------------------------ pool writes/reads
def _pools(bits, n_pages=8):
    t, j = _layouts(bits, 64, T, n_pages, 4, 16, n_layers=2)
    return t, j, kvcache.init_kv_pool(t, device="cpu"), j_kv.init_kv_pool(j)


def _assert_pools_equal(tpool, jpool):
    for key, a in tpool.items():
        b = np.asarray(jpool[key])
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        if a.dtype == torch.bfloat16:
            a, b = a.to(torch.float32), b.astype(np.float32)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=key)


@pytest.mark.parametrize("bits", [16, 8, 4, 2])
def test_write_prompt_token_and_reads_bit_equal_to_reference(bits):
    """The same K/V into both pools (one slot's page dropped at the null
    page), then a decode write with one inactive slot: pools bit-equal;
    the raw window and each page fetch equal (null pages read as zeros)."""
    t, j, tpool, jpool = _pools(bits)
    B = 2
    k = _normal((2, B, S, 4, 16), 2)
    v = _normal((2, B, S, 4, 16), 3)
    kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in (k, v))
    kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (k, v))
    phys = np.asarray([[0, 1], [5, t.null_page]], np.int32)
    slots = np.asarray([0, 1], np.int32)
    jpool = j_kv.write_prompt(jpool, j, kj, vj, jnp.asarray(phys),
                              jnp.asarray(slots))
    kvcache.write_prompt(tpool, t, kt, vt, phys, slots)
    _assert_pools_equal(tpool, jpool)

    table = np.asarray([[0, 1, 2, t.null_page],
                        [5, 6, t.null_page, t.null_page]], np.int32)
    pos = np.asarray([S, 5], np.int32)
    active = np.asarray([True, False])
    ktok, vtok = _normal((B, 4, 16), 4), _normal((B, 4, 16), 5)
    for li in range(2):
        sk = j_seeds.kv_seed(jnp.asarray(pos), jnp.arange(B), li, 0)
        sv = j_seeds.kv_seed(jnp.asarray(pos), jnp.arange(B), li, 1)
        jl = j_kv.write_token(jax.tree.map(lambda a: a[li], jpool), j,
                              jnp.asarray(table), jnp.asarray(pos),
                              jnp.asarray(active), jnp.asarray(ktok),
                              jnp.asarray(vtok), sk, sv)
        jpool = {key: jpool[key].at[li].set(jl[key]) for key in jpool}
        tp = torch.from_numpy(pos)
        kvcache.write_token(
            kvcache.layer_view(tpool, li), t, torch.from_numpy(table), tp,
            active, torch.from_numpy(ktok), torch.from_numpy(vtok),
            t_seeds.kv_seed(tp, torch.arange(B), li, 0),
            t_seeds.kv_seed(tp, torch.arange(B), li, 1))
    _assert_pools_equal(tpool, jpool)

    jl0 = jax.tree.map(lambda a: a[1], jpool)
    tl0 = kvcache.layer_view(tpool, 1)
    ttable = torch.from_numpy(table)
    if bits == 16:
        for a, b in zip(kvcache.gather_kv_raw(tl0, t, ttable),
                        j_kv.gather_kv_raw(jl0, j, jnp.asarray(table))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return
    # the port's page fetch is the reference's, page by page, bit for bit
    jfetch = j_kv.make_page_fetch(jl0, j, jnp.asarray(table))
    tfetch = kvcache.make_page_fetch(tl0, t, ttable)
    for jj in range(table.shape[1]):
        want, got = jfetch(jnp.int32(jj)), tfetch(jj)
        np.testing.assert_array_equal(
            np.asarray(want[2]), jj * t.page_tokens + np.arange(t.page_tokens))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_write_token_drops_every_inactive_slot():
    t, _, tpool, _ = _pools(8)
    before = {k: v.clone() for k, v in tpool.items()}
    kvcache.write_token(kvcache.layer_view(tpool, 0), t,
                        torch.zeros((2, 2), dtype=torch.int32),
                        torch.tensor([1, 2]), np.asarray([False, False]),
                        torch.ones((2, 4, 16)), torch.ones((2, 4, 16)),
                        torch.tensor([1, 2]), torch.tensor([3, 4]))
    for k, v in tpool.items():
        assert torch.equal(v, before[k])


# -------------------------------------------------- allocator, scheduler
def test_page_allocator_bounds_and_reuse():
    a = PageAllocator(4)
    assert a.alloc(3) == [0, 1, 2] and a.free_pages == 1
    assert a.used_pages == 3
    assert a.alloc(2) is None
    a.free([1])
    assert a.alloc(2) == [1, 3]
    with pytest.raises(ValueError, match="double free"):
        a.free([0, 0])
    with pytest.raises(ValueError, match="outside"):
        a.free([4])
    with pytest.raises(ValueError):
        PageAllocator(0)
    with pytest.raises(ValueError):
        a.alloc(-1)


@pytest.mark.parametrize("mode", ["continuous", "fixed"])
def test_scheduler_admission_matches_reference(mode):
    """The same submit/admit/tick/complete trace through both schedulers:
    the same slots, pages and rejection reasons."""
    from repro.serving import PageAllocator as JAlloc
    from repro.serving import Scheduler as JSched

    def drive(alloc_cls, sched_cls, req_cls):
        sch = sched_cls(max_batch=2, page_tokens=T, allocator=alloc_cls(9),
                        mode=mode, max_queue=3, max_prompt=S,
                        max_new_cap=GEN)
        log = []
        reqs = [req_cls(rid=i, prompt=np.zeros(n, np.int32), max_new=m)
                for i, (n, m) in enumerate([(8, 6), (3, 2), (8, 6), (20, 2),
                                            (4, 9), (5, 5), (6, 1)])]
        for r in reqs:
            log.append(sch.submit(r))
        for _ in range(12):
            log.append([(si, r.rid, p) for si, r, p in sch.admit()])
            sch.tick()
            for si, slot in enumerate(sch.slots):
                if slot is not None and slot.done:
                    log.append(("done", si, sch.complete(si).rid))
        log.append(sch.allocator.free_pages)
        return log

    assert drive(PageAllocator, Scheduler, Request) == \
        drive(JAlloc, JSched, JRequest)


# ---------------------------------------------------------------- engine
def _serve_pair(name):
    """The smoke-size ``name`` at float32 activations: the reference's
    model and weights, the port's model of the same weights, 3 prompts."""
    cfg = dataclasses.replace(j_reduce(J_ARCHS[name]), act_mode="none",
                              act_dtype="float32")
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(t_reduce(T_ARCHS[name]), act_mode="none",
                               act_dtype="float32")
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, S)).astype(
        np.int32)
    return jm, params, tm, prompts


@pytest.fixture(scope="module")
def served():
    return _serve_pair("qwen1.5-4b")


def _engine(tm, prompts, *, bits, n_pages, max_batch, mode, **kw):
    kv = KVCacheConfig(bits=bits, group_size=64, page_tokens=T,
                       n_pages=n_pages)
    eng = ServeEngine(tm, kv=kv, max_batch=max_batch, max_prompt=S,
                      gen_cap=GEN, mode=mode, **kw)
    out = eng.run([Request(rid=i, prompt=prompts[i], max_new=GEN)
                   for i in range(len(prompts))])
    assert kvcache.pool_nbytes(eng.pool) == eng.layout.pool_bytes
    return out


def _legacy_tokens(tm, prompts, max_seq):
    step = make_serve_step(tm)
    logits, cache = tm.prefill(torch.from_numpy(prompts), max_seq=max_seq)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    gen = [tok.numpy()]
    for _ in range(GEN - 1):
        tok, _, cache = step(cache, tok)
        gen.append(tok.numpy())
    return np.concatenate(gen, axis=1)


@pytest.mark.parametrize("mode", ["continuous", "fixed"])
def test_engine_bits16_token_identical_to_legacy_loop(served, mode):
    _, _, tm, prompts = served
    maxp = -(-(S + GEN - 1) // T)
    legacy = _legacy_tokens(tm, prompts, maxp * T)
    out = _engine(tm, prompts, bits=16, n_pages=3 * maxp, max_batch=3,
                  mode=mode)
    np.testing.assert_array_equal(
        np.stack([r.tokens for r in out["results"]]), legacy)
    assert out["rejected"] == 0 and out["gen_tokens"] == 3 * GEN
    single = _engine(tm, prompts, bits=16, n_pages=maxp, max_batch=1,
                     mode=mode)
    np.testing.assert_array_equal(
        np.stack([r.tokens for r in single["results"]]), legacy)
    assert single["decode_steps"] == 3 * (GEN - 1)


def _engine_parity(jm, params, tm, prompts, bits):
    """Three requests through two slots (the third reuses a freed slot's
    pages) on both engines: greedy tokens equal, every step's logits
    within 1e-4, the same summary keys and byte counts."""
    maxp = -(-(S + GEN - 1) // T)
    jkv = JKV(bits=bits, group_size=64, page_tokens=T, n_pages=2 * maxp)
    jout = JEngine(jm, params, kv=jkv, max_batch=2, max_prompt=S,
                   gen_cap=GEN, collect_logits=True).run(
        [JRequest(rid=i, prompt=prompts[i], max_new=GEN) for i in range(3)])
    tout = _engine(tm, prompts, bits=bits, n_pages=2 * maxp, max_batch=2,
                   mode="continuous", collect_logits=True)
    assert set(tout) == set(jout)
    for a, b in zip(tout["results"], jout["results"]):
        assert a.rid == b.rid and a.status == b.status == "done"
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(tout["logits"][a.rid],
                                   jout["logits"][b.rid], atol=1e-4,
                                   rtol=1e-5)
    for key in ("gen_tokens", "decode_steps", "rejected", "kv_pool_bytes",
                "kv_f32_pool_bytes", "kv_bits", "kv_mechanism", "mode"):
        assert tout[key] == jout[key], key


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_engine_matches_reference_engine(served, bits):
    _engine_parity(*served, bits)


@pytest.mark.parametrize("name", DENSE_TRIO)
def test_engine_4bit_matches_reference_engine_dense_trio(name):
    """The paged engine over the 4-bit cache for each of the trio."""
    _engine_parity(*_serve_pair(name), 4)


def test_engine_rejection_reasons(served):
    _, _, tm, prompts = served
    maxp = -(-(S + GEN - 1) // T)
    out = _engine(tm, prompts, bits=16, n_pages=maxp, max_batch=1,
                  mode="continuous", max_queue=2)
    assert [r.status for r in out["results"]] == ["done", "done", "rejected"]
    assert "queue full" in out["results"][2].reason and out["rejected"] == 1
    eng = ServeEngine(tm, kv=KVCacheConfig(bits=16, page_tokens=T,
                                           n_pages=maxp),
                      max_batch=1, max_prompt=S, gen_cap=GEN)
    ok, reason = eng.sched.submit(Request(rid=9, prompt=np.zeros(4 * S,
                                                                 np.int32),
                                          max_new=GEN))
    assert not ok and "prompt length" in reason
    ok, reason = eng.sched.submit(Request(rid=10, prompt=prompts[0],
                                          max_new=10 * GEN))
    assert not ok and "max_new" in reason
    big = ServeEngine(tm, kv=KVCacheConfig(bits=16, page_tokens=T,
                                           n_pages=1),
                      max_batch=1, max_prompt=S, gen_cap=GEN)
    ok, reason = big.sched.submit(Request(rid=11, prompt=prompts[0],
                                          max_new=GEN))
    assert not ok and "KV pages" in reason


@pytest.mark.parametrize("mode", ["continuous", "fixed"])
def test_engine_obs_counters_equal_to_reference(served, mode):
    """``obs=ObsPolicy(enabled=True)``: the tokens and logits of a run
    without it, every request admitted and completed, and the serving
    counters, gauge and histogram counts the reference's engine records
    for the same requests (times differ, so only counts are compared)."""
    from repro.obs import ObsPolicy as JObs
    from repro_torch.obs import ObsPolicy, ObsSession

    jm, params, tm, prompts = served
    maxp = -(-(S + GEN - 1) // T)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=GEN) for i in range(3)]
    plain = _engine(tm, prompts, bits=4, n_pages=2 * maxp, max_batch=2,
                    mode=mode, collect_logits=True)
    session = ObsSession(ObsPolicy(enabled=True))
    kv = KVCacheConfig(bits=4, group_size=64, page_tokens=T,
                       n_pages=2 * maxp)
    eng = ServeEngine(tm, kv=kv, max_batch=2, max_prompt=S, gen_cap=GEN,
                      mode=mode, obs=session, collect_logits=True)
    assert eng.session is session
    out = eng.run(reqs)
    for a, b in zip(out["results"], plain["results"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(out["logits"][a.rid],
                                      plain["logits"][b.rid])
    snap = session.registry.snapshot()
    assert snap["serve/admitted"] == snap["serve/completed"] == 3
    assert snap["serve/ttft_ms"]["count"] == 3
    names = [sp.name for sp in session.tracer.spans]
    assert names.count("serve/decode_step") == snap["serve/decode_steps"]
    jkv = JKV(bits=4, group_size=64, page_tokens=T, n_pages=2 * maxp)
    jeng = JEngine(jm, params, kv=jkv, max_batch=2, max_prompt=S,
                   gen_cap=GEN, mode=mode, obs=JObs(enabled=True))
    jeng.run([JRequest(rid=i, prompt=prompts[i], max_new=GEN)
              for i in range(3)])
    jsnap = jeng.session.registry.snapshot()
    assert set(snap) == set(jsnap)
    for key, want in jsnap.items():
        if isinstance(want, dict):
            assert snap[key]["count"] == want["count"], key
            if key in ("serve/queue_depth", "serve/occupancy"):
                assert snap[key] == want, key
        else:
            assert snap[key] == want, key
    jnames = [sp.name for sp in jeng.session.tracer.spans]
    assert names == jnames
    # a policy that is off binds the shared null session
    assert ServeEngine(tm, max_batch=1, max_prompt=S, gen_cap=GEN,
                       obs=ObsPolicy()).session.registry is None


def test_engine_refuses_what_is_not_ported(served):
    _, _, tm, _ = served
    mamba = dataclasses.replace(tm.cfg, family="ssm")
    fake = type("M", (), {"cfg": mamba})()
    with pytest.raises(ValueError, match="families"):
        ServeEngine(fake, max_batch=1, max_prompt=S, gen_cap=GEN)


# -------------------------------------------------------- import isolation
def test_port_imports_neither_jax_nor_the_reference():
    """Every module of the port, and chip_smoke.py, loads without JAX and
    without the reference package."""
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, env={"PYTHONPATH": f"{REPO / 'src'}:{REPO}",
                        "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 30
