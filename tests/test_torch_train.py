"""The port's LM training and training launcher against the JAX reference
on the CPU: ``core.backend.use_impl``, ``compressed_block`` and
``compressed_elementwise`` (with their host placements), ``Model.loss``
and its gradients under each ``act_mode``, ``make_train_step`` with
gradient accumulation, the checkpointer and ``TrainRunner``, and
``launch.train``: its graph half against ``engine.runner.run`` and the
reference's flag lowering, its LM half's falling loss and bit-identical
resume.

Setup: the smoke config of qwen1.5-4b (2 layers, d_model 64, vocab 512)
with float32 activations and the reference's weights
(``models.convert.params_from_jax``); the reference's compression runs
``impl="jnp"``.  Tolerances: stashes (packed words, zero, range) bit for
bit; losses 1e-5 relative; float32 gradients 1e-4; the gradients and
updated values of bf16 parameters within one bf16 ulp (2**-7 relative)
plus 1e-6 (the two libraries sum the float32 products in other orders
before rounding to bf16).  The port's own placements, resume and launcher
against ``run`` bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_for_smoke as j_reduce
from repro.core import act_compress as j_ac
from repro.core.compressor import CompressionConfig as JCC
from repro.core.compressor import compress as j_compress
from repro.launch import steps as j_steps
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.core import act_compress as t_ac
from repro_torch.core import backend
from repro_torch.core.compressor import CompressionConfig as TCC
from repro_torch.core.compressor import compress as t_compress
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import StragglerMonitor, TrainRunner
from torch_threads import one_thread  # noqa: F401

BF16 = dict(rtol=2.0 ** -7, atol=1e-6)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _f32(a):
    return (a.detach().to(torch.float32).numpy()
            if isinstance(a, torch.Tensor) else np.asarray(a, np.float32))


# ------------------------------------------------------------- use_impl
def test_use_impl_overrides_every_impl_inside():
    """``use_impl("cuda")`` reaches a config that names "auto" (CPU tensors
    then refuse the kernel path); ``None`` changes nothing; the override
    ends with the context; an unknown name raises."""
    x = torch.from_numpy(_normal((4, 64), 0))
    cfg = TCC(bits=2, group_size=64)
    want = t_compress(x, cfg, 5)
    with backend.use_impl(None):
        assert torch.equal(t_compress(x, cfg, 5).packed, want.packed)
    with backend.use_impl("cuda"), pytest.raises(ValueError, match="cuda"):
        t_compress(x, cfg, 5)
    with backend.use_impl("torch"):
        assert torch.equal(t_compress(x, cfg.with_impl("cuda"), 5).packed,
                           want.packed)
    assert torch.equal(t_compress(x, cfg, 5).packed, want.packed)
    with pytest.raises(ValueError), backend.use_impl("pallas"):
        pass


# ------------------------------------------------- block and elementwise
def _block_pair(d):
    w1, w2 = _normal((d, 2 * d), 1, d ** -0.5), _normal((2 * d, d), 2,
                                                        d ** -0.5)

    def j_f(x, p):
        return x + jnp.tanh(x @ p["w1"]) @ p["w2"]

    def t_f(x, p):
        return x + torch.tanh(x @ p["w1"]) @ p["w2"]

    return (w1, w2), j_f, t_f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_block_matches_reference(dtype):
    """The stash bit-equal to the reference's ``compress`` (bf16 inputs
    upcast to float32 first); the output and the gradients of x and the
    parameters (recomputed from the reconstruction) within 1e-4 at
    float32, and at bf16 within 2**-6 of each tensor's largest magnitude
    (two ulps at the top of its range)."""
    d, seed = 64, 31
    (w1, w2), j_f, t_f = _block_pair(d)
    x = _normal((3, 10, d), 3)
    g = _normal((3, 10, d), 4)
    jc = JCC(bits=2, group_size=64, impl="jnp")
    tc = TCC(bits=2, group_size=64)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx, jp = jnp.asarray(x, jdt), {"w1": jnp.asarray(w1, jdt),
                                   "w2": jnp.asarray(w2, jdt)}
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tp = {"w1": torch.from_numpy(w1).to(tdt).requires_grad_(),
          "w2": torch.from_numpy(w2).to(tdt).requires_grad_()}
    jct = j_compress(jx, jc, jnp.uint32(seed))
    tct = t_compress(tx.detach(), tc, seed)
    np.testing.assert_array_equal(tct.packed.numpy(),
                                  np.asarray(jct.packed).view(np.int32))
    for f in ("zero", "rng"):
        np.testing.assert_array_equal(getattr(tct, f).numpy(),
                                      np.asarray(getattr(jct, f)))
    jy, vjp = jax.vjp(lambda x_, p_: j_ac.compressed_block(j_f, jc)(
        x_, p_, jnp.uint32(seed)), jx, jp)
    jdx, jdp = vjp(jnp.asarray(g, jdt))
    ty = t_ac.compressed_block(t_f, tc)(tx, tp, seed)
    ty.backward(torch.from_numpy(g).to(tdt))
    for got, want in [(ty, jy), (tx.grad, jdx),
                      *((tp[k].grad, jdp[k]) for k in ("w1", "w2"))]:
        want = _f32(want)
        # bf16: every op rounds, and a term's one-ulp difference survives
        # the sum it cancels in, so the band scales with the largest value
        tol = (dict(rtol=0.0, atol=2.0 ** -6 * np.abs(want).max())
               if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4))
        np.testing.assert_allclose(_f32(got), want, **tol)


def test_compressed_elementwise_matches_reference():
    """``fn'`` evaluated at the reconstruction: the same dx as the
    reference's within 1e-5, the forward exact."""
    x, g = _normal((8, 128), 5), _normal((8, 128), 6)
    jc = JCC(bits=2, group_size=64, impl="jnp")
    jy, vjp = jax.vjp(lambda a: j_ac.compressed_elementwise(
        jax.nn.gelu, a, jnp.uint32(9), jc), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    ty = t_ac.compressed_elementwise(
        lambda a: torch.nn.functional.gelu(a, approximate="tanh"), tx, 9,
        TCC(bits=2, group_size=64))
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("offload", ["host", "pinned-paged"])
def test_compressed_block_host_placements_bit_identical(offload):
    """A host placement moves the stash, never its bits: the output and
    every gradient equal to the stash kept where it was made."""
    (w1, w2), _, t_f = _block_pair(64)
    x, g = _normal((2, 12, 64), 7), _normal((2, 12, 64), 8)
    outs = []
    for place in (None, "device", offload):
        tx = torch.from_numpy(x).requires_grad_()
        tp = {"w1": torch.from_numpy(w1).requires_grad_(),
              "w2": torch.from_numpy(w2).requires_grad_()}
        y = t_ac.compressed_block(t_f, TCC(bits=2, group_size=64),
                                  place)(tx, tp, 4)
        y.backward(torch.from_numpy(g))
        outs.append((y.detach(), tx.grad, tp["w1"].grad, tp["w2"].grad))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


# ------------------------------------------------------------ the model
def _lm_pair(mode, grad_accum=1):
    jcomp = JCC(bits=2, group_size=64, impl="jnp") if mode == "act" else None
    tcomp = TCC(bits=2, group_size=64) if mode == "act" else None
    jcfg = dataclasses.replace(j_reduce(J_ARCHS["qwen1.5-4b"]),
                               act_mode=mode, act_dtype="float32",
                               act_compression=jcomp, grad_accum=grad_accum)
    tcfg = dataclasses.replace(t_reduce(T_ARCHS["qwen1.5-4b"]),
                               act_mode=mode, act_dtype="float32",
                               act_compression=tcomp, grad_accum=grad_accum)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")


def _named(tm):
    """The port's parameters under the reference's tree paths (layer li's
    leaves under ``layers`` with the layer index last)."""
    out = {}
    for name, p in tm.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            out[(("layers", *parts[2:]), int(parts[1]))] = p
        else:
            out[((name,), None)] = p
    return out


def _reference_leaf(tree, key):
    path, li = key
    a = tree
    for k in path:
        a = a[k]
    return a if li is None else a[li]


@pytest.mark.parametrize("mode", ["none", "remat", "act"])
def test_model_loss_and_grads_match_reference(mode):
    """``Model.loss`` (the vocab projection in 16-position chunks, 39
    predicted positions padded to 48) and the gradient of every
    parameter against the reference's."""
    jm, params, tm = _lm_pair(mode)
    tok = np.random.default_rng(0).integers(0, 512, (2, 40)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tok), act_seed=7, vocab_chunk=16))(params)
    tl = tm.loss(torch.from_numpy(tok), act_seed=7, vocab_chunk=16)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for key, p in _named(tm).items():
        np.testing.assert_allclose(_f32(p.grad),
                                   _f32(_reference_leaf(jg, key)),
                                   err_msg=str(key), **BF16)


def test_hidden_states_seeds_wrap_at_32_bits():
    """Layer li stashes with ``act_seed + li`` mod 2**32: a base seed of
    2**32 - 1 gives layer 1 the seed 0, as the reference's uint32 add."""
    jm, params, tm = _lm_pair("act")
    tok = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)
    want = jm.hidden_states(params, jnp.asarray(tok), act_seed=2**32 - 1)[0]
    got = tm.hidden_states(torch.from_numpy(tok), act_seed=2**32 - 1)[0]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)


def assert_adamw_close(got, want, lr: float, steps: int, what: str):
    """Parameters after ``steps`` AdamW updates: at least 99 % of the
    elements within one bf16 ulp, and every element within ``2 * lr *
    steps``.  AdamW normalizes each gradient element, so one whose
    gradient is rounding noise moves by about +-lr in either library."""
    got, want = _f32(got), _f32(want)
    close = np.isclose(got, want, **BF16)
    assert close.mean() >= 0.99, (what, close.mean())
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr * steps,
                               err_msg=what)


def test_train_step_grad_accum_matches_reference():
    """``make_train_step`` with ``grad_accum=2`` over 2 steps (AdamW with
    warmup, weight decay and clipping): the losses within 1e-5 relative,
    the parameters as :func:`assert_adamw_close` says."""
    jm, params, tm = _lm_pair("act", grad_accum=2)
    kw = dict(lr=3e-3, weight_decay=0.01, grad_clip=1.0, warmup_steps=2)
    jstep = jax.jit(j_steps.make_train_step(jm, JAdamW(**kw)))
    jstate = j_adamw_init(params, JAdamW(**kw))
    opt = AdamWConfig(**kw)
    tstep = t_steps.make_train_step(tm, opt)
    tstate = adamw_init(list(tm.parameters()), opt)
    for step in range(2):
        tok = np.random.default_rng(step).integers(0, 512, (4, 24)).astype(
            np.int32)
        params, jstate, jm_ = jstep(params, jstate,
                                    {"tokens": jnp.asarray(tok)})
        tm_ = tstep(tstate, {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
    assert tstate["step"] == 2
    for key, p in _named(tm).items():
        assert_adamw_close(p, _reference_leaf(params, key), kw["lr"], 2,
                           str(key))


def test_prefill_step_is_model_prefill():
    _, _, tm = _lm_pair("none")
    tok = torch.from_numpy(
        np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32))
    logits, cache = t_steps.make_prefill_step(tm, max_seq=16)(
        {"tokens": tok})
    want, _ = tm.prefill(tok, max_seq=16)
    assert torch.equal(logits, want) and cache["k"].shape[2] == 16


# ------------------------------------------------------ checkpointing
def _tree():
    gen = torch.Generator().manual_seed(0)
    mod = torch.nn.Linear(4, 3)
    return {"a": torch.randn(16, 8, generator=gen),
            "nested": {"b": torch.randn(4, generator=gen).to(torch.bfloat16),
                       "step": 3},
            "mods": [mod]}


def test_checkpoint_round_trip_restores_in_place(tmp_path):
    """Every leaf back bit for bit (bf16 through its uint16 bits, recorded
    in the manifest), tensors restored into the given ones, numbers
    returned in place."""
    import json

    tree = _tree()
    save_checkpoint(tmp_path, 5, tree)
    manifest = json.loads((tmp_path / "step_5" / "manifest.json").read_text())
    assert manifest["dtypes"][1] == "bfloat16"
    assert np.load(tmp_path / "step_5" / "leaf_1.npy").dtype == np.uint16
    like = _tree()
    for t in (like["a"], like["nested"]["b"]):
        t.zero_()
    like["nested"]["step"] = 0
    with torch.no_grad():
        like["mods"][0].weight.zero_()
    a_id = id(like["a"])
    back = load_checkpoint(tmp_path, 5, like)
    assert id(back["a"]) == a_id and back["nested"]["step"] == 3
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["nested"]["b"], tree["nested"]["b"])
    assert torch.equal(like["mods"][0].weight, tree["mods"][0].weight)


def test_checkpoint_atomic_tmp_and_async_snapshot(tmp_path):
    """A leftover ``step_N.tmp`` (a crashed write) is never the latest; an
    async save takes its host copy before returning, so an in-place update
    right after it is not what the files hold."""
    tree = _tree()
    save_checkpoint(tmp_path, 1, tree)
    (tmp_path / "step_9.tmp").mkdir()
    assert latest_step(tmp_path) == 1
    want = tree["a"].clone()
    t = save_checkpoint(tmp_path, 2, tree, async_write=True)
    tree["a"].add_(1.0)
    t.join()
    assert latest_step(tmp_path) == 2
    back = load_checkpoint(tmp_path, 2, _tree())
    assert torch.equal(back["a"], want)
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(tmp_path, 2, {"a": tree["a"]})


def _toy_runner(path, fail_at=None):
    def step_fn(state, batch):
        state["a"].add_(batch)
        return state, {"loss": state["a"].sum()}

    return TrainRunner(step_fn, lambda step: float(step + 1), path,
                       ckpt_every=3, fail_at_step=fail_at)


def test_train_runner_failure_and_bitwise_resume(tmp_path):
    """Killed at step 7 (the pending write joined), restarted, the final
    state equal to an unfailed run's; the rerun resumes from step 6."""
    ref, _ = _toy_runner(tmp_path / "ref").run({"a": torch.zeros(2, 2)}, 10)
    with pytest.raises(RuntimeError, match="step 7"):
        _toy_runner(tmp_path / "run", fail_at=7).run(
            {"a": torch.zeros(2, 2)}, 10)
    assert latest_step(tmp_path / "run") == 6
    state, hist = _toy_runner(tmp_path / "run").run(
        {"a": torch.zeros(2, 2)}, 10)
    assert hist[0]["step"] == 6 and len(hist) == 4
    assert torch.equal(state["a"], ref["a"])


def test_straggler_monitor():
    events = []
    mon = StragglerMonitor(warmup=2, callback=lambda *e: events.append(e))
    for step, dt in enumerate([1.0, 1.0, 1.0, 1.0, 9.0, 1.0]):
        mon.record(step, dt)
    assert [e[0] for e in mon.events] == [4] and len(events) == 1
    assert mon.ewma == pytest.approx(1.0)


# ----------------------------------------------------------- launcher
SMOKE = ["--arch", "qwen1.5-4b", "--smoke", "--batch", "2", "--seq", "32",
         "--act-mode", "act", "--device", "cpu"]


def test_lm_launcher_loss_decreases(tmp_path):
    """The reference's system gate (``tests/test_system.py``) at the port's
    smoke config: 25 steps of act-mode training through the checkpointing
    runner, the last loss 0.1 below the first."""
    hist = t_train.main(["--arch", "qwen1.5-4b", "--smoke", "--steps", "25",
                         "--batch", "4", "--seq", "64", "--lr", "3e-3",
                         "--act-mode", "act", "--ckpt-dir",
                         str(tmp_path / "ck"), "--device", "cpu"])
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0] - 0.1, losses[:3] + losses[-3:]
    assert all(h["dt"] > 0 for h in hist)


@pytest.mark.parametrize("offload", ["none", "pinned-paged"])
def test_lm_launcher_resume_bit_identical(tmp_path, offload):
    """4 steps checkpointed every 2, then ``--steps 6`` in the same
    directory: it starts at step 4, runs 2 steps, and equals an
    uninterrupted 6-step run bit for bit; ``--fail-at 3`` raises and
    leaves ``step_2`` whole."""
    base = SMOKE + ["--offload", offload]
    run = lambda argv: t_train.lm_main(t_train.parser().parse_args(
        base + argv))
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    whole = run(["--steps", "6"])
    run(["--steps", "4"] + ck)
    resumed = run(["--steps", "6"] + ck)
    assert [h["step"] for h in resumed["history"]] == [4, 5]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in whole["history"][4:]]
    assert all(torch.equal(p, q) for p, q in zip(
        resumed["model"].parameters(), whole["model"].parameters()))
    fail = ["--ckpt-dir", str(tmp_path / "fail"), "--ckpt-every", "2"]
    with pytest.raises(RuntimeError, match="step 3"):
        run(["--steps", "6", "--fail-at", "3"] + fail)
    assert latest_step(tmp_path / "fail") == 2
    assert not (tmp_path / "fail" / "step_2.tmp").exists()


@pytest.mark.parametrize("argv,error,match", [
    (["--arch", "qwen1.5-4b", "--smoke", "--production-mesh"],
     RuntimeError, "needs 256 ranks; the process group has 1"),
    (["--graph-batches", "2", "--graph-scale", "0.004",
      "--production-mesh"],
     RuntimeError, "needs 256 ranks; the process group has 1"),
])
def test_lm_launcher_refuses_what_is_not_ported(argv, error, match):
    """``--production-mesh`` builds the reference's (16, 16) mesh: on one
    rank both halves raise, naming the 256 ranks it needs (it never
    shrinks to the world it has)."""
    with pytest.raises(error, match=match):
        t_train.main(argv + ["--steps", "1", "--device", "cpu"])


def test_launcher_defaults_to_the_card():
    """``--device`` defaults to cuda, and without a card both halves raise
    instead of training on the CPU unasked."""
    args = t_train.parser().parse_args(["--arch", "qwen1.5-4b"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    for argv in (["--arch", "qwen1.5-4b", "--smoke", "--steps", "1"],
                 ["--graph-batches", "2", "--steps", "1"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_train.main(argv)


GRAPH = ["--graph-scale", "0.004", "--act-mode", "act", "--device", "cpu"]


@pytest.mark.parametrize("flags", [["--graph-batches", "4"],
                                   ["--mesh-parts", "4"]],
                         ids=["batches", "mesh"])
def test_graph_launcher_is_run_on_the_same_plan(flags, capsys):
    """The launcher's graph half equals ``engine.runner.run`` on the plan
    it printed (losses and parameters bit for bit), and its printed peak is
    the memory report's."""
    from repro_torch.engine.runner import run
    from repro_torch.optim import AdamWConfig as TAdamW

    args = t_train.parser().parse_args(GRAPH + flags + ["--steps", "2"])
    res = t_train.graph_main(args)
    text = capsys.readouterr().out
    ref = run(res["graph"], res["cfg"], res["plan"],
              TAdamW(lr=5e-3, weight_decay=0.0), n_epochs=2, seed=0,
              device="cpu")
    assert [h[1] for h in res["history"]] == [h[1] for h in ref["history"]]
    assert all(torch.equal(p, q) for p, q in zip(
        res["model"].parameters(), ref["model"].parameters()))
    assert f"plan: {res['plan'].describe()}" in text
    key = "mesh" if "--mesh-parts" in flags else "batched"
    peak = res["report"][key].get("per_device_saved_bytes",
                                  res["report"][key]["peak_saved_bytes"])
    assert f"{peak / 1e6:.2f} MB" in text
    assert [h[1] for h in t_train.main(GRAPH + flags + ["--steps", "2"])] \
        == [h[1] for h in res["history"]]


class _Lowered(Exception):
    pass


@pytest.mark.parametrize("flags", [
    ["--graph-batches", "4"],
    ["--graph-batches", "4", "--graph-halo", "1", "--act-fused", "off"],
    ["--graph-batches", "4", "--offload", "device"],
    ["--graph-batches", "4", "--offload", "pinned-paged", "--bit-budget",
     "2.0", "--autoprec-refresh", "2"],
    ["--graph-batches", "4", "--obs", "--obs-quant-every", "3"],
    ["--mesh-parts", "4", "--act-fused", "on", "--obs"],
], ids=["batches", "halo-fused-off", "arena", "host-autoprec", "obs",
        "mesh"])
def test_graph_flags_lower_to_the_reference_plan(flags, monkeypatch):
    """Each graph flag lowers to the plan the reference's launcher lowers
    it to: ``describe()`` equal (the reference's run is stopped at its
    plan)."""
    import repro.engine

    seen = {}

    def stop(g, cfg, plan, *a, **kw):
        seen["plan"] = plan
        raise _Lowered

    monkeypatch.setattr(repro.engine, "run", stop, raising=False)
    from repro.launch import train as j_train

    with pytest.raises(_Lowered):
        j_train.main(["--graph-scale", "0.004", "--act-mode", "act",
                      "--act-impl", "jnp", *flags, "--steps", "1"])
    args = t_train.parser().parse_args(GRAPH + flags + ["--steps", "1"])
    assert t_train.graph_plan(args).describe() == seen["plan"].describe()
