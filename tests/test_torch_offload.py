"""The stash arena and offload engine on the CPU against the JAX reference:
the plan's layout and byte ledger, arena writes and reads, the prefetch
window, training through every placement (against the reference, and bit
for bit against the port's own per-tensor stash), the memory report's
arena section, the stash gauges, and the KV cache's host placements.

Setup: the reference's mini-batch test graph (700 nodes, 32 features, 5
classes), SAGE and GCN, G = 64, RP 8, with mixed widths and uncompressed
layers; the reference runs ``impl="jnp"`` and the port starts from the
reference's weights (``params_from_numpy``).  Tolerances: plans, bytes and
stored words exactly; every placement of the port bit-identical to every
other and to ``offload=None`` (they copy bits and run the same kernels in
the same order); losses against the reference rtol 1e-3 (as
tests/test_torch_gnn.py: another summation order can flip a rare SR code).
On the CPU the host placements copy into separate CPU tensors (no stream,
no pinning); the card's side-stream copies are ``gpu`` tests in
tests/test_torch_cuda.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressor import CompressionConfig as JCC
from repro.core.compressor import compress as j_compress
from repro.graph import data as j_data
from repro.graph.models import GNNConfig as JCfg
from repro.graph.models import init_gnn_params
from repro.graph.train import activation_memory_report as j_report
from repro.graph.train import train_gnn as j_train_gnn
from repro.offload import arena as j_ar
from repro.offload import engine as j_engine
from repro.offload.gnn import plan_gnn_stashes as j_plan_gnn
from repro_torch.core.compressor import CompressionConfig as TCC
from repro_torch.core.compressor import compress as t_compress
from repro_torch.core.compressor import decompress as t_decompress
from repro_torch.engine.compile import CompiledFull, masked_nll
from repro_torch.engine.forward import stash_gnn_forward, stash_nbytes
from repro_torch.engine.plan import StashPolicy
from repro_torch.graph import data as t_data
from repro_torch.graph.models import GNNConfig as TCfg
from repro_torch.graph.models import device_graph, params_from_numpy
from repro_torch.graph.train import activation_memory_report as t_report
from repro_torch.graph.train import train_gnn as t_train_gnn
from repro_torch.graph.train import train_gnn_batched as t_train_batched
from repro_torch.launch import serve as t_serve
from repro_torch.offload import arena as t_ar
from repro_torch.offload import engine as t_engine
from repro_torch.offload.gnn import plan_gnn_stashes as t_plan_gnn
from repro_torch.optim import AdamWConfig
from torch_threads import one_thread  # noqa: F401

GRAPH_ARGS = ("t", 700, 3500, 32, 5)
GRAPH_KW = dict(homophily=0.5, feature_noise=1.5, seed=1)
PLACEMENTS = [None, "device", "host", "pinned-paged"]
SEGMENTS = ("packed", "zero", "rng", "rp_seed", "raw", "mask")
MEASURED = ("measured_live_bytes", "device_peak_bytes")


@functools.lru_cache(maxsize=None)
def _graphs():
    return (j_data.synthetic_graph(*GRAPH_ARGS, **GRAPH_KW),
            t_data.synthetic_graph(*GRAPH_ARGS, **GRAPH_KW))


def _comp(spec, cls):
    """A ``GNNConfig.compression`` from a spec: None, a (bits, G, rp, vm)
    tuple, or a per-layer tuple of those and None."""
    if spec is None:
        return None
    if isinstance(spec[0], int):
        return cls(spec[0], spec[1], spec[2], vm=spec[3])
    return tuple(None if s is None else cls(s[0], s[1], s[2], vm=s[3])
                 for s in spec)


#: Compression specs: uniform RP 8, VM levels, mixed widths with an
#: uncompressed layer, ragged blocks (G = 96 does not divide 700 x 4), and
#: every layer raw.
CASES = {
    "uniform": (2, 64, 8, False),
    "vm": (2, 64, 8, True),
    "mixed": ((4, 64, 8, False), None, (8, 64, 0, False)),
    "ragged": (2, 96, 8, False),
    "raw": None,
}


def _cfgs(case, arch="sage", hidden=(32, 32)):
    spec = CASES[case]
    return (JCfg(arch=arch, hidden=hidden, n_classes=5,
                 compression=_comp(spec, JCC)),
            TCfg(arch=arch, hidden=hidden, n_classes=5,
                 compression=_comp(spec, TCC)))


def _carried(jcfg, tcfg, in_dim=32, seed=0):
    jp = init_gnn_params(jax.random.PRNGKey(seed), jcfg, in_dim)
    npp = [{k: np.asarray(v) for k, v in p.items()} for p in jp]
    return jp, params_from_numpy(npp, tcfg, device="cpu")


def _assert_plans_equal(tp, jp):
    """Field for field: every segment's arena, offset and size, the
    geometry, and the ledger."""
    assert len(tp.layers) == len(jp.layers)
    for tl, jl in zip(tp.layers, jp.layers):
        assert (tl.index, tl.shape, tl.proj_shape, tl.n_blocks,
                tl.words_per_block, tl.mask_elems) == (
            jl.index, jl.shape, jl.proj_shape, jl.n_blocks,
            jl.words_per_block, jl.mask_elems)
        assert (tl.cfg is None) == (jl.cfg is None)
        for f in SEGMENTS:
            ts, js = getattr(tl, f), getattr(jl, f)
            assert (ts is None) == (js is None), (tl.index, f)
            if ts is not None:
                assert (ts.arena, ts.offset, ts.size, ts.nbytes) == (
                    js.arena, js.offset, js.size, js.nbytes), (tl.index, f)
        assert (tl.nbytes, tl.n_reads) == (jl.nbytes, jl.n_reads)
    for prop in ("u32_words", "f32_elems", "u32_bytes", "f32_bytes",
                 "total_bytes", "max_layer_bytes", "n_reads", "dtype"):
        assert getattr(tp, prop) == getattr(jp, prop), prop
    assert tp.per_layer_rows() == jp.per_layer_rows()


def _assert_aligned(plan):
    """Every allocated start is 16-byte aligned, at or after its offset,
    and no two segments of an arena overlap; the padding is what the
    allocation adds."""
    for arena, alloc in (("u32", plan.u32_alloc_words),
                         ("f32", plan.f32_alloc_elems)):
        segs = sorted((s for lp in plan.layers for s in lp.segments()
                       if s.arena == arena), key=lambda s: s.start)
        end = 0
        for s in segs:
            assert s.start % t_ar.ALIGN_WORDS == 0 and s.start >= s.offset
            assert s.start >= end
            end = s.start + s.size
        assert end == alloc
    assert plan.padding_bytes == 4 * (plan.u32_alloc_words
                                      + plan.f32_alloc_elems) \
        - plan.total_bytes


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("n_nodes", [700, 333])
@pytest.mark.parametrize("arch", ["sage", "gcn"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gnn_plan_equal_to_reference(case, arch, n_nodes):
    jcfg, tcfg = _cfgs(case, arch)
    tp = t_plan_gnn(tcfg, 32, n_nodes)
    _assert_plans_equal(tp, j_plan_gnn(jcfg, 32, n_nodes))
    _assert_aligned(tp)


@pytest.mark.parametrize("masks", [None, (0, 77, 4096)])
def test_plan_stashes_equal_to_reference(masks):
    shapes = ((5, 7, 64), (33, 40), (129, 16))
    cfgs = ((2, 128, 8, True), None, (1, 48, 0, False))
    tp = t_ar.plan_stashes(shapes, _comp(cfgs, TCC), masks)
    _assert_plans_equal(tp, j_ar.plan_stashes(shapes, _comp(cfgs, JCC),
                                              masks))
    _assert_aligned(tp)
    with pytest.raises(ValueError, match="mismatch"):
        t_ar.plan_stashes(shapes, _comp(cfgs, TCC)[:2])


@pytest.mark.parametrize("policy", t_engine.POLICIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_resident_bytes_equal_to_reference(case, policy):
    jcfg, tcfg = _cfgs(case)
    got = t_engine.device_resident_stash_bytes(t_plan_gnn(tcfg, 32, 700),
                                               policy)
    assert got == j_engine.device_resident_stash_bytes(
        j_plan_gnn(jcfg, 32, 700), policy)
    single = t_plan_gnn(TCfg(hidden=(), n_classes=5), 32, 10)
    assert t_engine.device_resident_stash_bytes(single, policy) == \
        single.total_bytes


def test_check_policy_rejects_a_typo():
    assert t_engine.check_policy(None) is None
    for p in t_engine.POLICIES:
        assert t_engine.check_policy(p) == p
    with pytest.raises(ValueError, match="offload"):
        t_engine.check_policy("hsot")
    with pytest.raises(ValueError, match="offload"):
        t_engine.resolve_mechanism("hsot")
    assert [t_engine.resolve_mechanism(p) for p in t_engine.POLICIES] == \
        ["device", "pageable", "pinned"]
    _, tg = _graphs()
    _, tcfg = _cfgs("uniform")
    with pytest.raises(ValueError, match="offload"):
        t_train_gnn(tg, tcfg, n_epochs=1, offload="hsot", device="cpu")


# ----------------------------------------------------------------- arenas
@pytest.mark.parametrize("spec", [(2, 64, 8, True), (4, 96, 0, False),
                                  (1, 48, 2, False), (8, 128, 0, True)])
def test_arena_words_bit_equal_to_reference(spec):
    """The same numpy input compressed by both packages and written into
    their arenas: every segment's words equal; the read-back decompresses
    to the per-tensor stash's values bit for bit; raw and mask segments
    round-trip."""
    x = (np.random.default_rng(7).normal(size=(100, 64)) * 2).astype(
        np.float32)
    words = np.random.default_rng(8).integers(-2**31, 2**31, (1, 9),
                                              dtype=np.int64).astype(np.int32)
    shapes, masks = ((100, 64), (100, 64)), (0, 288)
    tcfgs, jcfgs = (_comp(spec, TCC), None), (_comp(spec, JCC), None)
    tp = t_ar.plan_stashes(shapes, tcfgs, masks)
    jp = j_ar.plan_stashes(shapes, jcfgs, masks)
    tct = t_compress(torch.from_numpy(x), tcfgs[0], 1234)
    # the same fields on both sides (the two RP matmuls round differently)
    jct = dataclasses.replace(
        j_compress(jnp.asarray(x), jcfgs[0], 1234),
        packed=jnp.asarray(tct.packed.numpy().view(np.uint32)),
        zero=jnp.asarray(tct.zero.numpy()), rng=jnp.asarray(tct.rng.numpy()))
    assert int(jct.rp_seed) == tct.seed
    ta = t_ar.stash_write(t_ar.arena_init(tp, "cpu"), tp, 0, tct)
    t_ar.write_raw(ta, tp, 1, torch.from_numpy(x))
    t_ar.write_mask(ta, tp, 1, torch.from_numpy(words))
    ja = j_ar.stash_write(j_ar.arena_init(jp), jp, 0, jct)
    ja = j_ar.write_raw(ja, jp, 1, jnp.asarray(x))
    ja = j_ar.write_mask(ja, jp, 1, jnp.asarray(words.view(np.uint32)))
    for tl, jl in zip(tp.layers, jp.layers):
        for f in SEGMENTS:
            ts, js = getattr(tl, f), getattr(jl, f)
            if ts is None:
                continue
            got = t_ar.segment_view(ta, ts).numpy().view(np.uint32)
            arena = ja[0] if js.arena == "u32" else ja[1]
            want = np.asarray(arena[js.offset:js.offset + js.size])
            np.testing.assert_array_equal(got, want.view(np.uint32), f)
    back = t_ar.stash_read(ta, tp, 0)           # the seed from its word
    assert back.seed == tct.seed and back.shape == tct.shape
    assert torch.equal(t_decompress(back), t_decompress(tct))
    assert torch.equal(t_ar.read_raw(ta, tp, 1), torch.from_numpy(x))
    assert torch.equal(t_ar.read_mask(ta, tp, 1), torch.from_numpy(words))
    with pytest.raises(ValueError, match="raw"):
        t_ar.stash_read(ta, tp, 1)
    with pytest.raises(ValueError, match="compressed"):
        t_ar.read_raw(ta, tp, 0)


# ------------------------------------------------------------- training
def _same(a, b):
    assert [h[1] for h in a["history"]] == [h[1] for h in b["history"]]
    assert all(torch.equal(p, q) for p, q in zip(a["model"].parameters(),
                                                 b["model"].parameters()))


@pytest.mark.parametrize("arch", ["sage", "gcn"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_gnn_placements_bit_identical(case, arch):
    """Every placement trains bit for bit as the per-tensor stash does;
    the arena's stash bytes are the per-tensor stash's, and its gauges
    stay inside the ledger."""
    _, tg = _graphs()
    _, tcfg = _cfgs(case, arch)
    runs = {p: t_train_gnn(tg, tcfg, n_epochs=3, offload=p, device="cpu")
            for p in PLACEMENTS}
    for p in PLACEMENTS[1:]:
        _same(runs[p], runs[None])
        assert runs[p]["stash_bytes"] == runs[None]["stash_bytes"]
        a = runs[p]["arena"]
        assert a["policy"] == p and a["misaligned_views"] == 0
        assert a["packed_views"] == 3 * sum(
            c is not None for c in tcfg.layer_compression())
        assert 0 < a["resident_peak_bytes"] <= a["device_resident_bytes"]
        assert a["planned_bytes"] == sum(runs[None]["stash_bytes"])
    assert "arena" not in runs[None]
    assert t_engine.host_store_bytes() == 0


@pytest.mark.parametrize("policy", ["device", "host"])
@pytest.mark.parametrize("case", ["vm", "mixed"])
def test_train_gnn_offload_matches_reference(case, policy):
    """The reference's ``train_gnn(offload=p)`` from the same weights:
    losses within rtol 1e-3."""
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(case)
    _, model = _carried(jcfg, tcfg)
    rj = j_train_gnn(jg, jcfg, n_epochs=3, seed=0, verbose=True,
                     eval_every=1, impl="jnp", offload=policy)
    rt = t_train_gnn(tg, tcfg, n_epochs=3, seed=0, params=model,
                     offload=policy, device="cpu")
    np.testing.assert_allclose([h[1] for h in rt["history"]],
                               [h[1] for h in rj["history"]], rtol=1e-3)


@pytest.mark.parametrize("case", ["uniform", "mixed"])
def test_train_gnn_batched_placements_bit_identical(case):
    _, tg = _graphs()
    _, tcfg = _cfgs(case)
    runs = {p: t_train_batched(tg, tcfg, 2, n_epochs=2, shuffle=False,
                               offload=p, device="cpu") for p in PLACEMENTS}
    for p in PLACEMENTS[1:]:
        _same(runs[p], runs[None])
        bn = runs[p]["batch_nodes"]
        assert runs[p]["arena"]["planned_bytes"] == \
            t_plan_gnn(tcfg, 32, bn).total_bytes
    assert t_engine.host_store_bytes() == 0


@pytest.mark.parametrize("n_parts", [None, 2])
def test_autoprec_recompile_replans_the_arena(n_parts):
    """Autoprec's refresh changes the widths mid-run: the arena is planned
    anew for them, and every placement stays bit-identical."""
    _, tg = _graphs()
    _, tcfg = _cfgs("uniform")
    kw = dict(n_epochs=4, bit_budget=3.0, autoprec_refresh=2, device="cpu")
    if n_parts is None:
        runs = {p: t_train_gnn(tg, tcfg, offload=p, **kw)
                for p in PLACEMENTS}
    else:
        runs = {p: t_train_batched(tg, tcfg, n_parts, shuffle=False,
                                   offload=p, **kw) for p in PLACEMENTS}
    assert runs[None]["bits_per_layer"] != [2, 2, 2]
    for p in PLACEMENTS[1:]:
        _same(runs[p], runs[None])
        assert runs[p]["bits_per_layer"] == runs[None]["bits_per_layer"]
        assert runs[p]["stash_bytes"] == runs[None]["stash_bytes"]


def test_compiled_recompile_plans_the_new_widths():
    _, tg = _graphs()
    _, tcfg = _cfgs("uniform")
    _, mixed = _cfgs("mixed")
    dg = device_graph(tg, "sage", "cpu")
    _, model = _carried(*_cfgs("uniform"))
    step = CompiledFull(dg, tcfg, model, AdamWConfig(lr=5e-3),
                        stash=StashPolicy(kind="arena", placement="host"))
    assert step.store.plan == t_plan_gnn(tcfg, 32, 700)
    step.step(0)
    step.recompile(mixed)
    assert step.store.plan == t_plan_gnn(mixed, 32, 700)
    step.step(1)
    assert step.stash_bytes == [lp.nbytes for lp in step.store.plan.layers]


@pytest.mark.parametrize("policy", ["host", "pinned-paged"])
def test_host_store_holds_the_plan_between_forward_and_backward(policy):
    """After a forward the host store holds the planned bytes; the backward
    drains it to 0, with at most two layers on the device at once, and the
    next forward reuses the same host arenas."""
    _, tg = _graphs()
    _, tcfg = _cfgs("mixed")
    dg = device_graph(tg, "sage", "cpu")
    _, model = _carried(*_cfgs("mixed"))
    plan = t_plan_gnn(tcfg, 32, 700)
    store = t_engine.ArenaStore(plan, policy, device="cpu")
    hosts = []
    for seed in (3, 4):
        logits = stash_gnn_forward(model, dg, tcfg, seed, store=store)
        assert t_engine.host_store_bytes() == plan.total_bytes
        assert stash_nbytes(logits) == [lp.nbytes for lp in plan.layers]
        hosts.append(logits.grad_fn.stash.host)
        loss = masked_nll(logits, dg.labels, dg.train_mask)
        torch.autograd.grad(loss, model.flat_params())
        assert t_engine.host_store_bytes() == 0
    assert hosts[0] is hosts[1]
    window = t_engine.device_resident_stash_bytes(plan, policy)
    assert 0 < store.resident_peak <= window < plan.total_bytes


def test_reader_frees_each_layer_once_consumed():
    """The per-tensor reader empties the residual layer by layer, as the
    engine's early free did."""
    _, tg = _graphs()
    _, tcfg = _cfgs("uniform")
    dg = device_graph(tg, "sage", "cpu")
    _, model = _carried(*_cfgs("uniform"))
    logits = stash_gnn_forward(model, dg, tcfg, 3)
    res = logits.grad_fn.stash
    reader = t_engine.make_reader(res)
    reader.get_mask(1)
    assert res[1] is not None
    reader.get_ct(1)
    assert res[1] is None and res[0] is not None


# ----------------------------------------------------------------- report
@pytest.mark.parametrize("kw", [dict(offload="host"),
                                dict(offload="device", n_parts=2),
                                dict(offload="pinned-paged", batch_nodes=384),
                                dict(offload="device", n_parts=4,
                                     batch_nodes=192)])
@pytest.mark.parametrize("case", ["uniform", "mixed", "raw"])
def test_report_arena_section_equal_to_reference(case, kw):
    jg, tg = _graphs()
    jcfg, tcfg = _cfgs(case)
    got, want = t_report(tg, tcfg, **kw), j_report(jg, jcfg, **kw)
    ga, wa = got.pop("arena"), want.pop("arena")
    assert got == want
    assert {k: v for k, v in ga.items() if k not in MEASURED} == \
        {k: v for k, v in wa.items() if k not in MEASURED}
    assert set(ga) == set(wa)
    # on the CPU nothing is measured on a card
    assert ga["measured_live_bytes"] == 0 or torch.cuda.is_initialized()


# ------------------------------------------------------------- serving KV
@pytest.mark.parametrize("bits", ["4", "16"])
def test_kv_host_placements_bit_equal_to_device(bits):
    """The launcher's smoke model (2 layers) under each KV placement: the
    same tokens and logits bit for bit, the host pool's bytes the layout's,
    and the mechanism each placement names."""
    outs = {}
    for policy in t_engine.POLICIES:
        args = t_serve.parser().parse_args(
            ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
             "--requests", "3", "--max-batch", "2", "--prompt-len", "12",
             "--gen-len", "5", "--kv-bits", bits, "--kv-policy", policy])
        engine, requests = t_serve.build_engine(args, collect_logits=True)
        assert engine.model.cfg.n_layers == 2
        outs[policy] = engine.run(requests)
        assert outs[policy]["kv_mechanism"] == \
            t_engine.resolve_mechanism(policy)
        if policy != "device":
            assert all(t.device.type == "cpu" and not t.is_pinned()
                       for t in engine.pool.host.values())
    base = outs["device"]
    for policy in ("host", "pinned-paged"):
        for a, b in zip(base["results"], outs[policy]["results"]):
            assert a.status == b.status == "done"
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(base["logits"][a.rid],
                                          outs[policy]["logits"][b.rid])
        assert outs[policy]["kv_pool_bytes"] == base["kv_pool_bytes"]
