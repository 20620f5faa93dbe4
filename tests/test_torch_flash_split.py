"""The bf16 flash-attention kernel's arithmetic, repeated in plain torch on
the CPU, against the JAX reference.

``csrc/flash_attention.cu`` runs bf16 attention on tensor cores: S = Q K^T
from bf16 q and k summed in float32 (each product is exact in float32),
then times the scale in float32; the keys in tiles of 64 with the running
max, sum and accumulator; P split in two bf16 parts, hi = rn(p) and
lo = rn(p - hi), both multiplied by the bf16 V into one float32 sum.  Here
the same steps run in float32 torch on inputs whose values are bf16, and
the result must stay within 3e-5 (rtol and atol, the float32 band of the
reference's flash test) of the reference's ``online_attention`` (float32,
scale on q first, with ``q_offset`` and ``kv_len``) and of the Pallas
``flash_attention_call`` in interpret mode (scale on the scores).  A single
bf16 P (hi alone, as a bf16 attention computes it) must fall outside that
band: that is why the kernel splits.  The tensor cores' own order of
summation is checked on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_call
from repro.models.attention import online_attention
from torch_threads import one_thread  # noqa: F401

BAND = 3e-5
NEG_INF = -1e30
TILE = 64
# (causal, sq, skv, q_offset, kv_len): a prompt, full attention, a chunk of
# a longer prompt, a padded cache
CASES = {"causal": (True, 256, 256, 0, None),
         "full": (False, 192, 256, 0, None),
         "chunk": (True, 70, 200, 130, 180),
         "padded": (False, 100, 200, 0, 131)}
HEAD_DIMS = (64, 128)


def bf16_split(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi = rn(p), lo = rn(p - hi), both bf16 values held in float32 (the
    subtraction is exact: hi is within a factor 2 of p)."""
    hi = p.to(torch.bfloat16).to(torch.float32)
    return hi, (p - hi).to(torch.bfloat16).to(torch.float32)


def kernel_attention(q, k, v, *, causal, q_offset=0, kv_len=None,
                     parts=2) -> torch.Tensor:
    """q (BH, Sq, Dh), k, v (BH, Skv, Dh), float32 tensors of bf16 values ->
    float32 (BH, Sq, Dh), in the kernel's steps; ``parts=1`` keeps P as one
    bf16 value."""
    bh, sq, dh = q.shape
    skv = k.shape[1]
    scale = torch.tensor(1.0 / np.sqrt(dh), dtype=torch.float32)
    kv_end = skv if kv_len is None else min(kv_len, skv)
    q_pos = q_offset + torch.arange(sq)[:, None]
    m = torch.full((bh, sq, 1), NEG_INF)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, dh))
    for k0 in range(0, kv_end, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        s = (q @ kt.transpose(1, 2)) * scale
        k_pos = k0 + torch.arange(kt.shape[1])[None, :]
        ok = k_pos < kv_end
        if causal:
            ok = ok & (k_pos <= q_pos)
        s = torch.where(ok, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi, lo = bf16_split(p)
        acc = acc * corr + hi @ vt
        if parts == 2:
            acc = acc + lo @ vt
        m = m_new
    return acc / torch.clamp(l, min=1e-30)


def _qkv(b, h, sq, skv, dh, seed):
    """bf16-representable float32 numpy arrays, (B, S, H, Dh)."""
    r = np.random.default_rng(seed)
    mk = lambda s: torch.from_numpy(r.normal(size=(b, s, h, dh)).astype(
        np.float32)).to(torch.bfloat16).to(torch.float32).numpy()
    return mk(sq), mk(skv), mk(skv)


def _heads(a):
    """(B, S, H, Dh) numpy -> (B*H, S, Dh) torch."""
    b, s, h, dh = a.shape
    return torch.from_numpy(a).transpose(1, 2).reshape(b * h, s, dh)


def _reference(case, dh):
    causal, sq, skv, q_offset, kv_len = CASES[case]
    q, k, v = _qkv(1, 3, sq, skv, dh, seed=sq + skv + dh)
    want = np.array(online_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, kv_len=kv_len))
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    return (_heads(q), _heads(k), _heads(v)), kw, _heads(want).numpy()


def _excess(got, want):
    """max |got - want| in units of the band (> 1: outside it)."""
    return float(np.max(np.abs(got - want) / (BAND + BAND * np.abs(want))))


def test_split_residual_within_2_pow_minus_16():
    """p = hi + lo + e with |e| <= 2^-16 p (one bf16 P: up to 2^-8 p)."""
    p = torch.from_numpy(np.exp(-np.random.default_rng(0).uniform(
        0, 20, 100_000)).astype(np.float32))
    hi, lo = bf16_split(p)
    for part in (hi, lo):
        assert torch.equal(part, part.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(p - hi, p.double() - hi.double())
    resid = (p.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -16 * p.double()).all())
    assert bool(((p - hi).abs() <= 2.0 ** -8 * p).all())


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES)
def test_kernel_arithmetic_matches_online_attention(case, dh):
    (q, k, v), kw, want = _reference(case, dh)
    got = kernel_attention(q, k, v, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=BAND, atol=BAND)


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("case", ["causal", "full"])
def test_kernel_arithmetic_matches_pallas_interp(case, dh):
    """The Pallas kernel takes whole blocks (Sq, Skv multiples of 64) and
    neither q_offset nor kv_len."""
    causal, sq, skv, _, _ = CASES[case]
    q, k, v = (_heads(a) for a in _qkv(1, 2, sq, skv, dh, seed=dh))
    want = np.asarray(flash_attention_call(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
        blk_q=64, blk_k=64, interpret=True))
    got = kernel_attention(q, k, v, causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=BAND, atol=BAND)


@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES)
def test_single_bf16_p_breaks_the_band(case, dh):
    """hi alone drops up to 2^-8 p a term: 20-50x outside the band here,
    where the split stays within 0.13 of it."""
    (q, k, v), kw, want = _reference(case, dh)
    assert _excess(kernel_attention(q, k, v, parts=1, **kw).numpy(),
                   want) > 1.0
