"""The port's MoE family against the JAX reference on the CPU: ``moe_ffn``
(output, balance loss, dropped tokens, gradients, capacity), the MoE
``Model`` for qwen3-moe-235b-a22b (top-8 cut to 4, qk-norm, GQA) and
arctic-480b (top-2, dense FFN residual) at ``reduce_for_smoke`` size
(training forward, prefill, decode, weight carry-over, random init), the
serving engine over the 4-bit paged KV cache, and both launchers.

Inputs are numpy arrays from a seed; weights carry over from the
reference's ``Model.init`` through ``params_from_jax``.  Tolerances:
float32 activations 2e-5 absolute + 1e-5 relative (products and sums run
in other orders); gradients 1e-4 absolute + 1e-4 relative (the backward
adds more terms in other orders); bf16 experts 2**-5 absolute + 2**-6
relative on outputs of magnitude up to ~1 (each library rounds the three
expert products and SwiGLU's product to bf16 in its own way: a few bf16
ulps); the engine's logits 1e-4 (as ``test_torch_serving.py``).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import Model as JModel
from repro.models import moe as j_moe
from repro.serving import KVCacheConfig as JKV
from repro.serving import Request as JRequest
from repro.serving import ServeEngine as JEngine
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import Model
from repro_torch.models import moe as t_moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import swiglu
from repro_torch.serving import KVCacheConfig, Request, ServeEngine
from torch_threads import one_thread  # noqa: F401

MOE_ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
F32 = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2.0 ** -5, rtol=2.0 ** -6)


def _f32(a):
    return a.detach().to(torch.float32).numpy() \
        if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _bf16_np(a):
    """A float32 array rounded to bf16, as the numpy type JAX takes."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


# ----------------------------------------------------------------- moe_ffn
def _ffn_inputs(seed, b, s, d, e, f, *, expert_dtype="float32",
                identical=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = {"router": rng.normal(size=(d, e)).astype(np.float32) * 0.3,
         "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) * 0.2,
         "w_up": rng.normal(size=(e, d, f)).astype(np.float32) * 0.2,
         "w_down": rng.normal(size=(e, f, d)).astype(np.float32) * 0.2}
    if identical:
        for name in ("w_gate", "w_up", "w_down"):
            w[name] = np.broadcast_to(w[name][:1], w[name].shape).copy()
    if expert_dtype == "bfloat16":
        x = _bf16_np(x)
        for name in ("w_gate", "w_up", "w_down"):
            w[name] = _bf16_np(w[name])
    return x, w


def _torch(x, w, requires_grad=False):
    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            out = torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            out = torch.from_numpy(a.copy())
        return out.requires_grad_(requires_grad)

    return t(x), types.SimpleNamespace(**{k: t(v) for k, v in w.items()})


@pytest.mark.parametrize("seq,e,k,cf", [
    (1, 128, 8, 1.25), (1000, 128, 8, 1.25), (512, 128, 8, 1.25),
    (4096, 128, 8, 1.25), (256, 128, 2, 1.25), (64, 8, 2, 1.0),
    (64, 4, 1, 0.1), (20, 8, 4, 1.25), (37, 8, 2, 8.0)])
def test_capacity_matches_reference(seq, e, k, cf):
    assert t_moe.capacity(seq, e, k, cf) == j_moe.capacity(seq, e, k, cf)


@pytest.mark.parametrize("k", [2, 4])
def test_moe_ffn_float32_matches_reference(k):
    """y and the balance loss at float32, with some pairs over capacity
    (24 k pairs of a sequence over 8 experts at C = 8)."""
    e = 8
    x, w = _ffn_inputs(k, 2, 24, 32, e, 48)
    yj, auxj = j_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, w),
                             n_experts=e, top_k=k, capacity_factor=0.5)
    xt, pt = _torch(x, w)
    yt, auxt = t_moe.moe_ffn(xt, pt, n_experts=e, top_k=k,
                             capacity_factor=0.5)
    assert yt.dtype == torch.float32 and auxt.dtype == torch.float32
    np.testing.assert_allclose(_f32(yt), np.asarray(yj), **F32)
    np.testing.assert_allclose(float(auxt), float(auxj), **F32)
    # the plan drops what the reference drops
    c = t_moe.capacity(24, e, k, 0.5)
    assert c == 8
    r = t_moe.route(t_moe.router_probs(xt, pt.router), k, c)
    assert 0 < int((~r["keep"]).sum()) < r["keep"].numel()


def test_moe_ffn_bf16_experts_match_reference():
    """bf16 activations and experts (the float32 router): y in bf16 within
    the bf16 band, aux (float32 routing) within the float32 band."""
    e, k = 8, 2
    x, w = _ffn_inputs(7, 2, 24, 32, e, 48, expert_dtype="bfloat16")
    yj, auxj = j_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, w),
                             n_experts=e, top_k=k)
    xt, pt = _torch(x, w)
    yt, auxt = t_moe.moe_ffn(xt, pt, n_experts=e, top_k=k)
    assert yt.dtype == torch.bfloat16 and yj.dtype == jnp.bfloat16
    np.testing.assert_allclose(_f32(yt), _f32(yj), **BF16)
    np.testing.assert_allclose(float(auxt), float(auxj), **F32)


def test_moe_ffn_forced_overflow_drops_the_same_rows():
    """Every token routed to expert 0 (positive inputs, a large router
    column) at capacity_factor 0.1: C = 8 of 64 tokens kept, the rest drop
    to exactly zero, the same rows as the reference's."""
    e, k = 4, 1
    x, w = _ffn_inputs(11, 1, 64, 16, e, 32)
    x = np.abs(x)
    w["router"][:, 0] = 100.0
    yj, _ = j_moe.moe_ffn(jnp.asarray(x), jax.tree.map(jnp.asarray, w),
                          n_experts=e, top_k=k, capacity_factor=0.1)
    xt, pt = _torch(x, w)
    yt, _ = t_moe.moe_ffn(xt, pt, n_experts=e, top_k=k, capacity_factor=0.1)
    zero_t = (yt[0] == 0).all(-1).numpy()
    zero_j = np.asarray((yj[0] == 0).all(-1))
    np.testing.assert_array_equal(zero_t, zero_j)
    assert zero_t.sum() == 64 - t_moe.capacity(64, e, k, 0.1) == 56
    assert not zero_t[:8].any()          # the first C tokens are kept
    np.testing.assert_allclose(_f32(yt), np.asarray(yj), **F32)


def test_identical_experts_equal_the_dense_swiglu():
    """With every expert the same and room for every pair, the MoE is the
    dense SwiGLU (the renormalised gates sum to 1)."""
    e, k = 8, 2
    x, w = _ffn_inputs(13, 2, 16, 32, e, 64, identical=True)
    xt, pt = _torch(x, w)
    yt, _ = t_moe.moe_ffn(xt, pt, n_experts=e, top_k=k, capacity_factor=8.0)
    dense = swiglu(xt, pt.w_gate[0], pt.w_up[0], pt.w_down[0])
    np.testing.assert_allclose(_f32(yt), _f32(dense), **F32)


def test_moe_ffn_grads_match_reference():
    """Gradients of ``sum(y**2) + 0.01 aux`` for x, the router and the
    three expert stacks, against ``jax.grad``, with dropped pairs (96
    pairs of a sequence over 8 experts at C = 8)."""
    e, k = 8, 4
    x, w = _ffn_inputs(17, 2, 24, 32, e, 48)

    def j_loss(xx, pp):
        y, aux = j_moe.moe_ffn(xx, pp, n_experts=e, top_k=k,
                               capacity_factor=0.5)
        return (y ** 2).sum() + 0.01 * aux

    gx, gp = jax.grad(j_loss, argnums=(0, 1))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, w))
    xt, pt = _torch(x, w, requires_grad=True)
    y, aux = t_moe.moe_ffn(xt, pt, n_experts=e, top_k=k,
                           capacity_factor=0.5)
    ((y ** 2).sum() + 0.01 * aux).backward()
    np.testing.assert_allclose(_f32(xt.grad), np.asarray(gx), **GRAD)
    for name in ("router", "w_gate", "w_up", "w_down"):
        got = getattr(pt, name).grad
        assert float(got.abs().sum()) > 0, name
        np.testing.assert_allclose(_f32(got), np.asarray(gp[name]),
                                   err_msg=name, **GRAD)


# ------------------------------------------------------------------- Model
def _pair(name, act_dtype="float32", act_mode="none"):
    cfg = dataclasses.replace(j_reduce(J_ARCHS[name]), act_mode=act_mode,
                              act_dtype=act_dtype)
    tcfg = dataclasses.replace(t_reduce(T_ARCHS[name]), act_mode=act_mode,
                               act_dtype=act_dtype)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")


@pytest.mark.parametrize("mode", ["none", "remat", "act"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_training_forward_matches_reference(name, mode):
    """``hidden_states``, the summed balance loss and ``loss`` against the
    reference's under the same ``act_mode`` (float32 activations); ``act``
    stashes no MoE layer, so it gives ``none``'s numbers bit for bit, in
    the reference and here, and so does ``remat``'s forward."""
    jm, params, tm = _pair(name, act_mode=mode)
    tok = np.random.default_rng(5).integers(0, jm.cfg.vocab, (2, 20))
    jh, jaux = jm.hidden_states(params, jnp.asarray(tok, jnp.int32))
    jl = jm.loss(params, jnp.asarray(tok, jnp.int32), vocab_chunk=8)
    th, taux = tm.hidden_states(torch.as_tensor(tok))
    tl = tm.loss(torch.as_tensor(tok), vocab_chunk=8)
    np.testing.assert_allclose(_f32(th), _f32(jh), **F32)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **F32)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    if mode != "none":
        _, _, plain = _pair(name)
        ph, paux = plain.hidden_states(torch.as_tensor(tok))
        assert torch.equal(th, ph) and torch.equal(taux, paux)
    # every weight, the router and the experts included, gets a gradient
    tl.backward()
    router = tm.layers[0].moe.router
    assert router.grad is not None and float(router.grad.abs().sum()) > 0


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_prefill_and_decode_match_reference(name):
    """Prefill logits and KV cache, then 3 greedy decode steps, at float32
    activations."""
    jm, params, tm = _pair(name)
    tokens = np.random.default_rng(3).integers(
        0, jm.cfg.vocab, (2, 21)).astype(np.int32)
    lj, cj = jm.prefill(params, jnp.asarray(tokens), max_seq=32)
    lt, ct = tm.prefill(torch.from_numpy(tokens), max_seq=32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    for key in ("k", "v"):
        assert tuple(ct[key].shape) == cj[key].shape
        np.testing.assert_allclose(_f32(ct[key]), _f32(cj[key]), **F32)
    tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for _ in range(3):
        lj, cj = jm.decode_step(params, cj, jnp.asarray(tok))
        lt, ct = tm.decode_step(ct, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
        tok = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_params_from_jax_keeps_every_weight_bit(name):
    """Every leaf of every layer (the (L, E, D, F) expert stacks unstacked),
    bit for bit and in its dtype: the router float32, the experts bf16."""
    _, params, tm = _pair(name, act_dtype="bfloat16")
    flat = jax.tree_util.tree_flatten_with_path(params["layers"])[0]
    names = set()
    for path, leaf in flat:
        keys = [p.key for p in path]
        names.add(".".join(keys))
        for li, lp in enumerate(tm.layers):
            t = lp
            for key in keys:
                t = getattr(t, key)
            want = np.asarray(leaf)[li]
            assert str(t.dtype).split(".")[1] == str(want.dtype), keys
            got = t.detach()
            if want.dtype.name == "bfloat16":
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), want)
    assert {"moe.router", "moe.w_gate", "moe.w_up", "moe.w_down"} <= names
    assert ("mlp.w_gate" in names) == (name == "arctic-480b")
    assert tm.layers[0].moe.router.dtype == torch.float32
    assert tm.layers[0].moe.w_gate.dtype == torch.bfloat16


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_random_init_has_reference_shapes_dtypes_and_scales(name):
    cfg = dataclasses.replace(j_reduce(J_ARCHS[name]), act_mode="none")
    params = jax.eval_shape(lambda: JModel(cfg).init(jax.random.PRNGKey(0)))
    tm = Model(dataclasses.replace(t_reduce(T_ARCHS[name]), act_mode="none"),
               device="cpu", generator=torch.Generator().manual_seed(0))
    for key in ("embed", "final_norm", "lm_head"):
        t, spec = getattr(tm, key), params[key]
        assert tuple(t.shape) == spec.shape
        assert str(t.dtype).split(".")[1] == str(spec.dtype)
    for path, spec in jax.tree_util.tree_flatten_with_path(
            params["layers"])[0]:
        t = tm.layers[0]
        for p in path:
            t = getattr(t, p.key)
        assert tuple(t.shape) == spec.shape[1:], path
        assert str(t.dtype).split(".")[1] == str(spec.dtype), path
    assert len(tm.layers) == cfg.n_layers
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(params))
    moe = tm.layers[0].moe
    d, f = cfg.d_model, cfg.moe_d_ff
    for w, fan_in in ((moe.router, d), (moe.w_gate, d), (moe.w_up, d),
                      (moe.w_down, f)):
        assert abs(float(w.detach().float().std()) * fan_in ** 0.5 - 1) < 0.05
    # experts are drawn apart, not copies of one another
    assert not torch.equal(moe.w_gate[0], moe.w_gate[1])


# ------------------------------------------------------------------ serving
def test_moe_engine_matches_reference_engine():
    """qwen3-moe at the smoke size (float32 activations), 3 requests
    through 2 slots over the 4-bit paged cache: greedy tokens equal to the
    JAX engine's, every step's logits within 1e-4."""
    S, GEN, T = 8, 6, 4
    jm, params, tm = _pair("qwen3-moe-235b-a22b")
    prompts = np.random.default_rng(1).integers(
        0, jm.cfg.vocab, (3, S)).astype(np.int32)
    maxp = -(-(S + GEN - 1) // T)
    jout = JEngine(jm, params, kv=JKV(bits=4, group_size=64, page_tokens=T,
                                      n_pages=2 * maxp),
                   max_batch=2, max_prompt=S, gen_cap=GEN,
                   collect_logits=True).run(
        [JRequest(rid=i, prompt=prompts[i], max_new=GEN) for i in range(3)])
    tout = ServeEngine(tm, kv=KVCacheConfig(bits=4, group_size=64,
                                            page_tokens=T, n_pages=2 * maxp),
                       max_batch=2, max_prompt=S, gen_cap=GEN,
                       collect_logits=True).run(
        [Request(rid=i, prompt=prompts[i], max_new=GEN) for i in range(3)])
    for a, b in zip(tout["results"], jout["results"]):
        assert a.rid == b.rid and a.status == b.status == "done"
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(tout["logits"][a.rid],
                                   jout["logits"][b.rid], atol=1e-4,
                                   rtol=1e-5)
    for key in ("gen_tokens", "decode_steps", "kv_pool_bytes"):
        assert tout[key] == jout[key], key


# ---------------------------------------------------------------- launchers
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_serve_launcher_on_cpu(name):
    outs = t_serve.main(["--arch", name, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-batch", "2",
                         "--prompt-len", "12", "--gen-len", "5",
                         "--kv-bits", "4"])
    assert len(outs) == 3 and all(o.shape == (5,) for o in outs)


def test_moe_train_launcher_on_cpu():
    """remat with 8-bit moments: finite losses that fall over 6 steps."""
    hist = t_train.main(["--arch", "qwen3-moe-235b-a22b", "--smoke",
                         "--steps", "6", "--batch", "2", "--seq", "32",
                         "--lr", "3e-3", "--act-mode", "remat",
                         "--opt-bits", "8", "--device", "cpu"])
    losses = [h["loss"] for h in hist]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_launcher_batch_must_split_into_grad_accum():
    """qwen3-moe's own grad_accum is 8: --batch 8 splits, 12 does not."""
    args = t_train.parser().parse_args(["--arch", "qwen3-moe-235b-a22b",
                                        "--batch", "8", "--device", "cpu"])
    assert t_train.lm_config(args).grad_accum == 8
    args.batch = 12
    with pytest.raises(ValueError, match="grad_accum=8"):
        t_train.lm_config(args)
