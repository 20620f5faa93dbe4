"""The port's attention against the JAX reference on the CPU: the flash
kernel's plain version against the Pallas kernel in interpret mode and the
reference's softmax oracle, ``online_attention`` against the reference's
chunked scan, the shared layers, and the decode paths.  The CUDA kernel
itself runs only on the card (``tests/test_torch_cuda.py``).

Tolerances: float32 3e-5 (the reference flash test's band; the plain
version sums a full softmax where the reference scans chunks); bf16 3e-2
(an output may round to the other neighbouring bf16 value)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_for_smoke as j_reduce
from repro.kernels import ref as j_ref
from repro.kernels.flash_attention import flash_attention_call
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import Model as JModel
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models.convert import params_from_jax
from torch_threads import one_thread  # noqa: F401


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _bf16(a):
    """float32 numpy -> the same bf16 values in both frameworks."""
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _np(t):
    return t.to(torch.float32).numpy()


# ------------------------------------------------- flash: plain vs Pallas
@pytest.mark.parametrize("bh,sq,skv,dh,causal,bq,bk", [
    (4, 256, 256, 64, True, 128, 128),
    (2, 256, 512, 64, False, 128, 128),
    (2, 128, 128, 128, True, 64, 64),
    (1, 512, 256, 64, False, 128, 64),
])
def test_flash_plain_matches_pallas_and_oracle(bh, sq, skv, dh, causal, bq,
                                               bk):
    q, k, v = (_normal(s, bh + sq + i) for i, s in
               enumerate([(bh, sq, dh), (bh, skv, dh), (bh, skv, dh)]))
    got = t_ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal).numpy()
    pallas = flash_attention_call(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, blk_q=bq,
                                  blk_k=bk, interpret=True)
    oracle = j_ref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=3e-5, rtol=3e-5)


def test_flash_plain_bf16_matches_pallas():
    q, k, v = (_normal((2, 128, 64), 7 + i) for i in range(3))
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
    got = t_ref.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == torch.bfloat16
    pallas = flash_attention_call(qj, kj, vj, causal=True, blk_q=64,
                                  blk_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(pallas, np.float32),
                               atol=3e-2, rtol=3e-2)


def test_flash_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper (and the ops route) is the plain version,
    bit for bit, and launches nothing."""
    q, k, v = (torch.from_numpy(_normal((3, 50, 32), i)) for i in range(3))
    before = t_fa.flash_attention.launches
    for kw in (dict(causal=True), dict(causal=False, kv_len=20),
               dict(causal=True, q_offset=7, scale_q=True, scale=0.3)):
        want = t_ref.flash_attention(q, k, v, **kw)
        assert torch.equal(t_fa.flash_attention(q, k, v, **kw), want)
        assert torch.equal(t_ops.flash_attention(q, k, v, **kw), want)
    assert t_fa.flash_attention.launches == before


def test_flash_plain_scale_orders_differ_only_in_rounding():
    """scale_q scales q before the product (the model's order) instead of
    the scores after it (the Pallas kernel's order): the same function up
    to float32 rounding."""
    q, k, v = (torch.from_numpy(_normal((2, 40, 64), 20 + i))
               for i in range(3))
    a = t_ref.flash_attention(q, k, v, causal=True, scale_q=True)
    b = t_ref.flash_attention(q, k, v, causal=True, scale_q=False)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# -------------------------------------------- online attention vs the scan
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,q_offset,kv_len,k_chunk", [
    (37, 37, 0, None, 16),       # ragged Skv against k_chunk
    (24, 50, 26, None, 32),      # chunked prefill: queries at 26..49
    (20, 64, 0, 41, 16),         # a padded cache: 41 valid keys
    (1, 48, 30, 31, 16),         # a decode-shaped query
])
def test_online_attention_matches_jax(dtype, causal, sq, skv, q_offset,
                                      kv_len, k_chunk):
    b, h, dh = 2, 4, 16
    q = _normal((b, sq, h, dh), sq)
    k = _normal((b, skv, h, dh), skv)
    v = _normal((b, skv, h, dh), skv + 1)
    if dtype == "bfloat16":
        (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
        tol = 3e-2
    else:
        qj, kj, vj = map(jnp.asarray, (q, k, v))
        qt, kt, vt = map(torch.from_numpy, (q, k, v))
        tol = 3e-5
    want = j_attn.online_attention(qj, kj, vj, causal=causal,
                                   q_offset=q_offset, kv_len=kv_len,
                                   k_chunk=k_chunk)
    got = t_attn.online_attention(qt, kt, vt, causal=causal,
                                  q_offset=q_offset, kv_len=kv_len)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,q_offset,kv_len,k_chunk", [
    (37, 37, 0, None, 16),       # ragged Skv against k_chunk
    (20, 64, 0, 41, 16),         # a padded cache: 41 valid keys
    (24, 50, 26, None, 32),      # chunked prefill: queries at 26..49
])
def test_chunked_attention_and_grads_match_jax(causal, sq, skv, q_offset,
                                               kv_len, k_chunk):
    """Training attention: the reference's scan spelled in torch ops, its
    output and its q/k/v gradients (autograd against jax.vjp) within 1e-5
    at float32."""
    b, h, dh = 2, 4, 16
    q = _normal((b, sq, h, dh), sq)
    k = _normal((b, skv, h, dh), skv)
    v = _normal((b, skv, h, dh), skv + 1)
    g = _normal((b, sq, h, dh), 7)
    fn = lambda q_, k_, v_: j_attn.online_attention(
        q_, k_, v_, causal=causal, q_offset=q_offset, kv_len=kv_len,
        k_chunk=k_chunk)
    want, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = t_attn.chunked_attention(qt, kt, vt, causal=causal,
                                   q_offset=q_offset, kv_len=kv_len,
                                   k_chunk=k_chunk)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for t, j in zip((qt, kt, vt), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


def test_repeat_kv_matches_jax():
    k = _normal((2, 5, 3, 8), 1)
    np.testing.assert_array_equal(
        t_attn._repeat_kv(torch.from_numpy(k), 4).numpy(),
        np.asarray(j_attn._repeat_kv(jnp.asarray(k), 4)))
    assert t_attn._repeat_kv(torch.from_numpy(k), 1).shape == k.shape


# ----------------------------------------------------------- shared layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_swiglu_match_jax(dtype):
    """Elementwise layers: float32 within 1e-6; bf16 within one bf16 ulp
    of the values (2**-7 relative), where the two libraries may round an
    intermediate differently."""
    x = _normal((2, 9, 4, 16), 3)
    w = _normal((16,), 4, 0.5) + 1
    pos = np.arange(9, dtype=np.int32)[None].repeat(2, 0) + 5
    if dtype == "bfloat16":
        xj, xt = _bf16(x)
        tol = 2 ** -7
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        tol = 1e-6
    np.testing.assert_allclose(
        _np(t_layers.rmsnorm(xt, torch.from_numpy(w))),
        np.asarray(j_layers.rmsnorm(xj, jnp.asarray(w)), np.float32),
        atol=tol, rtol=tol)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            _np(t_layers.apply_rope(xt, torch.from_numpy(pos), theta)),
            np.asarray(j_layers.apply_rope(xj, jnp.asarray(pos), theta),
                       np.float32), atol=tol * 4, rtol=tol)
    h = _normal((3, 7, 32), 5)
    wg, wu = _normal((32, 48), 6, 0.2), _normal((32, 48), 7, 0.2)
    wd = _normal((48, 32), 8, 0.2)
    ws = [(jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16())
          for a in (wg, wu, wd)]
    hj, ht = _bf16(h) if dtype == "bfloat16" else (jnp.asarray(h),
                                                   torch.from_numpy(h))
    want = np.asarray(j_layers.swiglu(hj, *[a for a, _ in ws]), np.float32)
    got = _np(t_layers.swiglu(ht, *[b for _, b in ws]))
    np.testing.assert_allclose(got, want, atol=max(tol * 4, 1e-5),
                               rtol=max(tol * 2, 1e-5))


def _model_pair(name, act_dtype="float32"):
    cfg = dataclasses.replace(j_reduce(J_ARCHS[name]), act_mode="none",
                              act_dtype=act_dtype)
    tcfg = dataclasses.replace(t_reduce(T_ARCHS[name]), act_mode="none",
                               act_dtype=act_dtype)
    params = JModel(cfg).init(jax.random.PRNGKey(0))
    if cfg.qkv_bias:   # non-zero biases, so that adding them is checked
        for i, b in enumerate(("bq", "bk", "bv")):
            a = params["layers"]["attn"][b]
            params["layers"]["attn"][b] = jnp.asarray(
                _normal(a.shape, 40 + i, 0.3))
    tm = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                         device="cpu")
    return cfg, params, tm


@pytest.mark.parametrize("name", ["qwen1.5-4b", "mistral-nemo-12b",
                                  "qwen3-32b"])
def test_qkv_project_and_attention_block_match_jax(name):
    """QKV bias (qwen1.5), GQA with H*Dh != d_model (mistral-nemo), qk-norm
    (qwen3), float32 activations against bf16 weights: within 1e-5."""
    cfg, params, tm = _model_pair(name)
    lp = jax.tree.map(lambda a: a[0], params["layers"])["attn"]
    x = _normal((2, 11, cfg.d_model), 9)
    pos = np.arange(11, dtype=np.int32)[None].repeat(2, 0)
    want = j_attn.qkv_project(jnp.asarray(x), lp, cfg, jnp.asarray(pos))
    with torch.no_grad():   # the model's parameters are trainable
        got = t_attn.qkv_project(torch.from_numpy(x), tm.layers[0].attn,
                                 tm.cfg, torch.from_numpy(pos))
        block = t_attn.attention_block(torch.from_numpy(x),
                                       tm.layers[0].attn, tm.cfg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_allclose(
        block.numpy(),
        np.asarray(j_attn.attention_block(jnp.asarray(x), lp, cfg,
                                          k_chunk=4)), atol=1e-5, rtol=1e-5)


def test_decode_attend_and_paged_match_jax():
    """The decode core on a padded float32 window, GQA (8 query heads over
    2 KV heads), against the reference's dense masked softmax and against
    its page-by-page online one, and the port's page-by-page read against
    the reference's (the same pages through both), within 1e-5."""
    b, s, hq, hkv, dh, T = 3, 24, 8, 2, 16, 8
    q = _normal((b, 1, hq, dh), 1)
    kf, vf = _normal((b, s, hkv, dh), 2), _normal((b, s, hkv, dh), 3)
    pos = np.asarray([0, 13, 23], np.int32)
    want = j_attn.decode_attend(jnp.asarray(q), jnp.asarray(kf),
                                jnp.asarray(vf), jnp.asarray(pos),
                                out_dtype=jnp.float32)
    got = t_attn.decode_attend(torch.from_numpy(q), torch.from_numpy(kf),
                               torch.from_numpy(vf), torch.from_numpy(pos),
                               out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)

    def fetch_j(j):   # j is traced inside the reference's scan
        return (jax.lax.dynamic_slice_in_dim(jnp.asarray(kf), j * T, T, 1),
                jax.lax.dynamic_slice_in_dim(jnp.asarray(vf), j * T, T, 1),
                j * T + jnp.arange(T))

    want_p = j_attn.decode_attend_paged(jnp.asarray(q), jnp.asarray(pos),
                                        s // T, fetch_j, n_kv_heads=hkv,
                                        out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), atol=1e-5,
                               rtol=1e-5)

    def fetch_t(j):
        return (torch.from_numpy(kf[:, j * T:(j + 1) * T]),
                torch.from_numpy(vf[:, j * T:(j + 1) * T]),
                j * T + torch.arange(T))

    got_p = t_attn.decode_attend_paged(torch.from_numpy(q),
                                       torch.from_numpy(pos), s // T,
                                       fetch_t, n_kv_heads=hkv,
                                       out_dtype=torch.float32)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5,
                               rtol=1e-5)
