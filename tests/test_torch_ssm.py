"""The port's SSM, hybrid and enc-dec families against the JAX reference on
the CPU: ``models.ssm`` (``ssd_chunked``, ``causal_conv1d``,
``mamba2_block``, ``mamba2_decode``), ``cross_attention_block``, the
``Model`` of mamba2-780m, zamba2-1.2b and seamless-m4t-large-v2 at
``reduce_for_smoke`` size (training forward and gradients under each
``act_mode``, prefill and decode, weight carry-over, random init), the
serve launcher's legacy loop and the train launcher.

Inputs are numpy arrays from a seed; weights carry over from the
reference's ``Model.init`` through ``params_from_jax``.  Tolerances:
float32 activations 2e-5 absolute + 1e-5 relative (products and sums in
other orders); the SSD scan's outputs and every float32 gradient 1e-4
absolute + 1e-4 relative (its einsums contract in other orders, and a
backward adds more terms); bf16 block outputs 2**-5 absolute + 2**-6
relative on values of magnitude up to ~1 (each library rounds the bf16
conv taps and products in its own way: a few bf16 ulps); the gradients of
bf16 parameters one bf16 ulp (2**-7 relative) plus 1e-5; the SSD against a
float64 recurrence 2e-4 (the reference test's band).

The one divergence that is a rule: the port masks the SSD's intra-chunk
decay before the exponential (``models/ssm.py``), so where a chunk's
summed ``dt * |a|`` passes ~88.7 the reference's dt-gradient is NaN and
the port's is finite and equal to a float64 recurrence's.
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
from repro.core.compressor import CompressionConfig as JCC
from repro.launch import serve as j_serve
from repro.models import Model as JModel
from repro.models import attention as j_attn
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.core.compressor import CompressionConfig as TCC
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import Model
from repro_torch.models import attention as t_attn
from repro_torch.models import ssm as t_ssm
from repro_torch.models.convert import params_from_jax, to_tensor
from torch_threads import one_thread  # noqa: F401

NAMES = ["mamba2-780m", "zamba2-1.2b", "seamless-m4t-large-v2"]
F32 = dict(atol=2e-5, rtol=1e-5)
SSD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=2.0 ** -5, rtol=2.0 ** -6)
BF16_GRAD = dict(rtol=2.0 ** -7, atol=1e-5)


def _f32(a):
    return a.detach().to(torch.float32).numpy() \
        if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _ns(tree: dict):
    """A numpy parameter dict as tensors under attribute names (what the
    port's block functions read)."""
    return types.SimpleNamespace(**{k: to_tensor(v) for k, v in tree.items()})


def naive_ssd(xh, dt, a_neg, bmat, cmat, state=None):
    """The token-by-token recurrence (the reference test's ``naive_ssd``)
    in float64 torch ops, differentiable: (y (B,S,H,P), final state)."""
    f64 = [torch.as_tensor(t).to(torch.float64)
           for t in (xh, dt, a_neg, bmat, cmat)]
    x, dt, a, bm, cm = f64
    b, s, h, p = x.shape
    st = torch.zeros((b, h, p, bm.shape[-1]), dtype=torch.float64) \
        if state is None else torch.as_tensor(state).to(torch.float64)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                       # (B,H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        st = st * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", st, cm[:, t]))
    return torch.stack(ys, 1), st


# ------------------------------------------------------------ ssd_chunked
def _ssd_inputs(seed, b=2, s=32, h=4, p=8, n=16):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_neg = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bmat = rng.standard_normal((b, s, n)).astype(np.float32)
    cmat = rng.standard_normal((b, s, n)).astype(np.float32)
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return xh, dt, a_neg, bmat, cmat, state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference(chunk, with_state):
    """y and the final state against the reference's scan, from zeros or
    from an initial state; both within the float64 recurrence's band."""
    *ins, state = _ssd_inputs(chunk)
    init = state if with_state else None
    jy, js = j_ssm.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk,
                               initial_state=None if init is None
                               else jnp.asarray(init), return_state=True)
    ty, ts = t_ssm.ssd_chunked(*map(torch.as_tensor, ins), chunk=chunk,
                               initial_state=None if init is None
                               else torch.as_tensor(init),
                               return_state=True)
    assert ty.dtype == torch.float32 and ts.dtype == torch.float32
    np.testing.assert_allclose(_f32(ty), _f32(jy), **SSD)
    np.testing.assert_allclose(_f32(ts), _f32(js), **SSD)
    ny, ns = naive_ssd(*ins, state=init)
    np.testing.assert_allclose(ty.double().numpy(), ny.numpy(), atol=2e-4,
                               rtol=2e-4)
    np.testing.assert_allclose(ts.double().numpy(), ns.numpy(), atol=2e-4,
                               rtol=2e-4)


def test_ssd_chunked_needs_whole_chunks():
    ins = _ssd_inputs(0, s=20)[:5]
    with pytest.raises(ValueError, match="chunk"):
        t_ssm.ssd_chunked(*map(torch.as_tensor, ins), chunk=8)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_grads_match_reference(chunk):
    """The gradient of every input (the initial state included) of a
    weighted sum of y and the final state, where the reference's are
    finite (at these inputs every one is)."""
    *ins, state = _ssd_inputs(10 + chunk)
    rng = np.random.default_rng(chunk)
    wy = rng.standard_normal(ins[0].shape).astype(np.float32)
    ws = rng.standard_normal(state.shape).astype(np.float32)

    def jloss(xh, dt, a_neg, bmat, cmat, st):
        y, fin = j_ssm.ssd_chunked(xh, dt, a_neg, bmat, cmat, chunk=chunk,
                                   initial_state=st, return_state=True)
        return jnp.sum(y * wy) + jnp.sum(fin * ws)

    jg = jax.grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, ins + [state]))
    tin = [torch.tensor(a, requires_grad=True) for a in ins + [state]]
    y, fin = t_ssm.ssd_chunked(*tin[:5], chunk=chunk, initial_state=tin[5],
                               return_state=True)
    (torch.sum(y * torch.as_tensor(wy))
     + torch.sum(fin * torch.as_tensor(ws))).backward()
    for name, t, j in zip(("xh", "dt", "a_neg", "bmat", "cmat", "state"),
                          tin, jg):
        assert np.isfinite(np.asarray(j)).all(), name
        np.testing.assert_allclose(_f32(t.grad), _f32(j), err_msg=name,
                                   **SSD)


def test_ssd_overflow_grads_finite_where_the_reference_is_nan():
    """At the full configs' chunk 128 with the init's a = -1 and dt =
    softplus(N(0, 1)), a chunk's summed dt passes 88.7: the reference's
    forward stays finite but its dt-gradient is NaN everywhere; the
    port's y equals the reference's and its gradients are finite and
    equal to float64 autograd of the plain recurrence."""
    rng = np.random.default_rng(128)
    b, s, h, p, n = 1, 256, 4, 8, 16
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_neg = -np.ones(h, np.float32)
    bmat = rng.standard_normal((b, s, n)).astype(np.float32)
    cmat = rng.standard_normal((b, s, n)).astype(np.float32)
    assert dt.reshape(b, 2, 128, h).sum(2).max() > 88.7
    ins = [xh, dt, a_neg, bmat, cmat]

    def jloss(*a):
        return j_ssm.ssd_chunked(*a, chunk=128)[0].sum()

    jy = j_ssm.ssd_chunked(*map(jnp.asarray, ins), chunk=128)[0]
    jg_dt = np.asarray(jax.grad(jloss, argnums=1)(*map(jnp.asarray, ins)))
    assert np.isfinite(np.asarray(jy)).all()
    assert np.isnan(jg_dt).all()

    tin = [torch.tensor(a, requires_grad=True) for a in ins]
    ty = t_ssm.ssd_chunked(*tin, chunk=128)[0]
    ty.sum().backward()
    np.testing.assert_allclose(_f32(ty), _f32(jy), **SSD)
    nin = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in ins]
    naive_ssd(*nin)[0].sum().backward()
    for name, t, nv in zip(("xh", "dt", "a_neg", "bmat", "cmat"), tin, nin):
        assert torch.isfinite(t.grad).all(), name
        np.testing.assert_allclose(t.grad.double().numpy(),
                                   nv.grad.numpy(), atol=1e-3, rtol=1e-4,
                                   err_msg=name)


# ------------------------------------------------------ the Mamba-2 block
def _block_setup(name, dtype, seed=0):
    cfg = j_reduce(J_ARCHS[name])
    p = jax.tree.map(np.asarray,
                     j_tf._ssm_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    # a_log and dt_bias off their init, so the decay varies by head
    p["a_log"] = (rng.standard_normal(p["a_log"].shape) * 0.3
                  ).astype(np.float32)
    p["dt_bias"] = (rng.standard_normal(p["dt_bias"].shape) * 0.3
                    ).astype(np.float32)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return cfg, p, jx, torch.as_tensor(np.asarray(jx.astype(jnp.float32))
                                       ).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_reference(dtype):
    """Tap by tap in the input's dtype, then the float32 bias promotes."""
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 12, 24)), dtype)
    w = jnp.asarray(rng.standard_normal((4, 24)) * 0.2, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(24), jnp.float32)
    want = j_ssm.causal_conv1d(x, w, b)
    got = t_ssm.causal_conv1d(*(to_tensor(np.asarray(a)) for a in (x, w, b)))
    assert str(got.dtype).split(".")[1] == str(want.dtype) == "float32"
    tol = F32 if dtype == "float32" else dict(atol=0, rtol=0)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-1.2b"])
def test_mamba2_block_matches_reference(name, dtype):
    """The mixer's output (in x's dtype) and final SSD state."""
    cfg, p, jx, tx = _block_setup(name, dtype)
    jy, js = j_ssm.mamba2_block(jx, p, cfg, chunk=cfg.ssm_chunk,
                                return_state=True)
    ty, ts = t_ssm.mamba2_block(tx, _ns(p), cfg, chunk=cfg.ssm_chunk,
                                return_state=True)
    assert str(ty.dtype).split(".")[1] == str(jy.dtype) == dtype
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_f32(ty), _f32(jy), **tol)
    np.testing.assert_allclose(_f32(ts), _f32(js),
                               **(SSD if dtype == "float32" else BF16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_matches_reference(dtype):
    """Three decode steps from random caches: y, the conv cache (the raw
    projections, the cache's dtype) and the SSD state."""
    cfg, p, jx, tx = _block_setup("mamba2-780m", dtype, seed=3)
    d_inner, n_heads = j_ssm.ssm_dims(cfg)
    rng = np.random.default_rng(4)
    conv = jnp.asarray(rng.standard_normal(
        (2, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state)), dtype)
    ssd = rng.standard_normal((2, n_heads, cfg.ssm_headdim, cfg.ssm_state)
                              ).astype(np.float32)
    jc, js = conv, jnp.asarray(ssd)
    tc, ts = to_tensor(np.asarray(conv)), torch.as_tensor(ssd)
    tp = _ns(p)
    for t in range(3):
        jy, jc, js = j_ssm.mamba2_decode(jx[:, t:t + 1], p, cfg, jc, js)
        ty, tc, ts = t_ssm.mamba2_decode(tx[:, t:t + 1], tp, cfg, tc, ts)
        assert str(ty.dtype).split(".")[1] == str(jy.dtype)
        assert str(tc.dtype).split(".")[1] == str(jc.dtype)
        tol = F32 if dtype == "float32" else BF16
        np.testing.assert_allclose(_f32(ty), _f32(jy), **tol)
        np.testing.assert_allclose(_f32(tc), _f32(jc), **tol)
        np.testing.assert_allclose(_f32(ts), _f32(js), **tol)


@pytest.mark.parametrize("online", [False, True])
def test_cross_attention_block_matches_reference(online):
    """Decoder queries over encoder keys (no rope, no mask), through the
    differentiable chunked path and through the kernel's route (its
    plain version here), at Sq 1 and Sq 7 over 40 keys."""
    cfg = j_reduce(J_ARCHS["seamless-m4t-large-v2"])
    p = jax.tree.map(np.asarray,
                     j_tf._attn_params(jax.random.PRNGKey(5), cfg))
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    for sq in (1, 7):
        x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
        want = j_attn.cross_attention_block(jnp.asarray(x), p, cfg,
                                            jnp.asarray(enc))
        got = t_attn.cross_attention_block(
            torch.as_tensor(x), _ns(p), cfg, torch.as_tensor(enc),
            online=online)
        np.testing.assert_allclose(_f32(got), _f32(want), **F32)


# ------------------------------------------------------------------ Model
def _pair(name, act_mode="none", act_dtype="float32"):
    jcomp = JCC(bits=2, group_size=64, impl="jnp") \
        if act_mode == "act" else None
    tcomp = TCC(bits=2, group_size=64) if act_mode == "act" else None
    jcfg = dataclasses.replace(j_reduce(J_ARCHS[name]), act_mode=act_mode,
                               act_dtype=act_dtype, act_compression=jcomp)
    tcfg = dataclasses.replace(t_reduce(T_ARCHS[name]), act_mode=act_mode,
                               act_dtype=act_dtype, act_compression=tcomp)
    jm = JModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")


def _inputs(cfg, seed, b=2, s=32):
    """Token ids, and for the enc-dec its (B, 24, D) encoder input."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    enc = rng.standard_normal((b, 24, cfg.d_model)).astype(np.float32) \
        if cfg.family == "encdec" else None
    return tok, enc


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("mode", ["none", "remat", "act"])
@pytest.mark.parametrize("name", NAMES)
def test_training_forward_matches_reference(name, mode):
    """``hidden_states`` and ``loss`` against the reference's under the
    same ``act_mode`` (float32 activations).  ``remat`` and ``act``
    forwards are ``none``'s bit for bit: the stash changes only what the
    backward reads."""
    jm, params, tm = _pair(name, mode)
    tok, enc = _inputs(jm.cfg, 7)
    jh, _ = jm.hidden_states(params, jnp.asarray(tok), enc_embeds=_j(enc),
                             act_seed=3)
    jl = jm.loss(params, jnp.asarray(tok), enc_embeds=_j(enc), act_seed=3,
                 vocab_chunk=16)
    th, taux = tm.hidden_states(torch.as_tensor(tok), enc_embeds=_t(enc),
                                act_seed=3)
    tl = tm.loss(torch.as_tensor(tok), enc_embeds=_t(enc), act_seed=3,
                 vocab_chunk=16)
    np.testing.assert_allclose(_f32(th), _f32(jh), **F32)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(taux) == 0.0
    if mode != "none":
        _, _, plain = _pair(name)
        ph, _ = plain.hidden_states(torch.as_tensor(tok),
                                    enc_embeds=_t(enc), act_seed=3)
        assert torch.equal(th, ph)


def _by_name(tree) -> dict:
    """The reference's tree flattened under the port's parameter names
    (``layers.<li>.mixer.w_x``): the stacked layer axes unstacked."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key for p in path]
        if keys[0] in ("layers", "enc_layers"):
            for li in range(leaf.shape[0]):
                out[f"{keys[0]}.{li}." + ".".join(keys[1:])] = leaf[li]
        else:
            out[".".join(keys)] = leaf
    return out


@pytest.mark.parametrize("mode", ["none", "act"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_grads_match_reference(name, mode):
    """The gradient of every parameter (bf16 weights within a bf16 ulp,
    float32 ones within 1e-4): under ``act`` a Mamba-2 layer's backward
    recomputes from the dequantized INT2 stash, the same words as the
    reference's; the enc-dec checkpoints instead and stashes nothing."""
    jm, params, tm = _pair(name, mode)
    tok, enc = _inputs(jm.cfg, 8)
    jl, jg = jax.value_and_grad(lambda p: jm.loss(
        p, jnp.asarray(tok), enc_embeds=_j(enc), act_seed=5,
        vocab_chunk=16))(params)
    tl = tm.loss(torch.as_tensor(tok), enc_embeds=_t(enc), act_seed=5,
                 vocab_chunk=16)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = _by_name(jg)
    for pname, p in tm.named_parameters():
        tol = BF16_GRAD if p.dtype == torch.bfloat16 else SSD
        np.testing.assert_allclose(_f32(p.grad), _f32(want.pop(pname)),
                                   err_msg=pname, **tol)
    assert not want


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_reference(name):
    """Prefill logits and cache (every entry), then 3 greedy decode steps
    (float32 activations; a prompt of two SSD chunks)."""
    jm, params, tm = _pair(name)
    tok, enc = _inputs(jm.cfg, 9, s=32)
    lj, cj = jm.prefill(params, jnp.asarray(tok), enc_embeds=_j(enc),
                        max_seq=40)
    lt, ct = tm.prefill(torch.as_tensor(tok), enc_embeds=_t(enc),
                        max_seq=40)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    assert set(ct) == set(cj)
    for key in cj:
        assert tuple(ct[key].shape) == cj[key].shape, key
        assert str(ct[key].dtype).split(".")[1] == str(cj[key].dtype), key
        np.testing.assert_allclose(_f32(ct[key]), _f32(cj[key]),
                                   err_msg=key, **SSD)
    t = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for _ in range(3):
        lj, cj = jm.decode_step(params, cj, jnp.asarray(t))
        lt, ct = tm.decode_step(ct, torch.as_tensor(t))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **SSD)
        t = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
    for key in cj:
        np.testing.assert_allclose(_f32(ct[key]), _f32(cj[key]),
                                   err_msg=key, **SSD)


@pytest.mark.parametrize("name", NAMES)
def test_params_from_jax_keeps_every_weight_bit(name):
    """Every leaf (the stacked layers unstacked, the hybrid's shared block
    and the encoder carried over) bit for bit and in its dtype."""
    _, params, tm = _pair(name, act_dtype="bfloat16")
    want = _by_name(params)
    for tname, got in tm.named_parameters():
        w, got = np.asarray(want.pop(tname)), got.detach()
        assert str(got.dtype).split(".")[1] == str(w.dtype), tname
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), w)
    assert not want


@pytest.mark.parametrize("name", NAMES)
def test_random_init_has_reference_shapes_dtypes_and_scales(name):
    """Random init: the reference's tree, shapes and dtypes, its parameter
    count (and ``param_count()``'s analytic one where that counts every
    leaf), dense weights at N(0, 1/fan_in), the convs at N(0, 0.04), the
    SSM's scalars at their constants."""
    cfg = dataclasses.replace(j_reduce(J_ARCHS[name]), act_mode="none")
    spec = jax.eval_shape(lambda: JModel(cfg).init(jax.random.PRNGKey(0)))
    tm = Model(dataclasses.replace(t_reduce(T_ARCHS[name]), act_mode="none"),
               device="cpu", generator=torch.Generator().manual_seed(0))
    want = _by_name(jax.tree.map(lambda a: np.empty(a.shape, a.dtype), spec))
    for tname, t in tm.named_parameters():
        leaf = want.pop(tname)
        assert tuple(t.shape) == leaf.shape, tname
        assert str(t.dtype).split(".")[1] == str(leaf.dtype), tname
    assert not want
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(spec))
    if cfg.family == "encdec":
        w = tm.layers[0].xattn.wq
    else:
        mix = tm.layers[0].mixer
        w = mix.w_x
        assert abs(float(mix.conv_x.float().std()) / 0.2 - 1) < 0.1
        assert torch.equal(mix.a_log, torch.zeros_like(mix.a_log))
        assert torch.equal(mix.d_skip, torch.ones_like(mix.d_skip))
        assert torch.equal(mix.dt_bias, torch.zeros_like(mix.dt_bias))
    assert abs(float(w.detach().float().std()) * cfg.d_model ** 0.5 - 1) \
        < 0.1


def test_full_configs_parameter_counts():
    """The full configs' parameter counts, the three this slice serves."""
    assert [T_ARCHS[n].param_count() for n in NAMES] == [
        856_350_720, 1_278_476_288, 2_034_659_328]
    assert T_ARCHS["zamba2-1.2b"].shared_attn_sites() == [5, 11, 17, 23, 29,
                                                          35]


def test_unknown_family_raises():
    cfg = dataclasses.replace(t_reduce(T_ARCHS["mamba2-780m"]),
                              family="rwkv")
    with pytest.raises(ValueError, match="family"):
        Model(cfg, device="cpu")


# -------------------------------------------------------------- launchers
def _serve_argv(name, requests=3):
    return ["--arch", name, "--smoke", "--requests", str(requests),
            "--max-batch", "2", "--prompt-len", "16", "--gen-len", "4"]


@pytest.mark.parametrize("name", NAMES)
def test_legacy_loop_matches_reference(name, monkeypatch):
    """The legacy loop from the reference's weights (float32
    activations): every request's tokens equal the reference loop's (the
    enc-dec batches fed the reference's ``enc_embeds``), and a second run
    gives the same tokens.  3 requests at max-batch 2: a full batch and a
    short one."""
    argv = _serve_argv(name)
    jm, params, tm = _pair(name)
    args = t_serve.parser().parse_args(argv + ["--device", "cpu"])
    want = j_serve._legacy_loop(jm, params, args)
    prefill = tm.prefill

    def fed(tokens, *, enc_embeds=None, max_seq):
        """The port's prefill, an enc-dec batch fed the reference loop's
        ``enc_embeds`` (``PRNGKey`` of the batch's first request)."""
        if enc_embeds is not None:
            ref = jax.random.normal(jax.random.PRNGKey(2 * fed.calls),
                                    enc_embeds.shape, jnp.bfloat16)
            enc_embeds = to_tensor(np.asarray(ref))
        fed.calls += 1
        return prefill(tokens, enc_embeds=enc_embeds, max_seq=max_seq)

    fed.calls = 0
    monkeypatch.setattr(tm, "prefill", fed)
    got = t_serve._legacy_loop(tm, args)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == (4,) and g.dtype == np.int32
        np.testing.assert_array_equal(g, np.asarray(w))
    fed.calls = 0
    again = t_serve._legacy_loop(tm, args)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)


@pytest.mark.parametrize("name", NAMES)
def test_serve_launcher_legacy_family_smoke(name, capsys):
    """``launch.serve`` routes the families outside KV_FAMILIES to the
    legacy loop, as the reference's system test runs it: every request
    comes back with its full generation budget."""
    outs = t_serve.main(_serve_argv(name, 2) + ["--device", "cpu"])
    assert len(outs) == 2 and all(o.shape == (4,) for o in outs)
    assert f"legacy {T_ARCHS[name].family} loop" in capsys.readouterr().out


@pytest.mark.parametrize("name", NAMES)
def test_train_launcher_trains_each_family(name):
    """``launch.train`` on each smoke config under ``act`` (the enc-dec
    with its ``enc_embeds``): finite losses that fall."""
    hist = t_train.main(["--arch", name, "--smoke", "--steps", "12",
                         "--batch", "2", "--seq", "32", "--lr", "3e-3",
                         "--act-mode", "act", "--act-group", "64",
                         "--device", "cpu"])
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_train_launcher_resume_mamba2(tmp_path):
    """The reference's resume recipe on mamba2-780m --smoke: 6 steps
    checkpointed every 3, then ``--steps 9`` in the same directory runs
    only steps 6-8, equal bit for bit to an uninterrupted 9-step run."""
    base = ["--arch", "mamba2-780m", "--smoke", "--batch", "2", "--seq",
            "64", "--device", "cpu"]
    ck = ["--ckpt-dir", str(tmp_path / "ck2"), "--ckpt-every", "3"]
    whole = t_train.lm_main(t_train.parser().parse_args(base + ["--steps",
                                                                "9"]))
    t_train.main(base + ["--steps", "6"] + ck)
    resumed = t_train.lm_main(t_train.parser().parse_args(
        base + ["--steps", "9"] + ck))
    hist = resumed["history"]
    assert hist[0]["step"] == 6 and len(hist) == 3
    assert [h["loss"] for h in hist] == \
        [h["loss"] for h in whole["history"][6:]]
    assert all(torch.equal(p, q) for p, q in zip(
        resumed["model"].parameters(), whole["model"].parameters()))
