"""Every family on the (data, model) mesh on the CPU: training, 8-bit AdamW
moments of split parameters, the sharded decode step, and the vlm's vision
prefix, against the JAX reference and against the port's one-rank run.

* The one-rank model of each family at ``reduce_for_smoke`` size, in
  float32, from the reference's weights (``params_from_jax``): its loss is
  the reference's (rtol 2e-5).  The vlm (internvl2-2b) also with
  ``prefix_embeds``: ``hidden_states``, ``loss`` (the prefix positions
  dropped) and ``prefill`` (logits and cache) are the reference's.
* 8-bit moments: a shard's blocks quantized at its offset
  (``moment_offset``: ``row0`` and the column split's stride) are the
  unsharded moment's words, zero and range bit for bit, for a row split,
  a column split, both at once and an expert stack; a split whose runs
  straddle the blocks raises, naming its shape.
* Two gloo ranks on the CPU, one pair of processes for the file
  (``tests/torch_family_ranks.py``): mamba2-780m, zamba2-1.2b,
  seamless-m4t-large-v2, qwen3-moe-235b-a22b and internvl2-2b train 2
  steps on (1, 2) and (2, 1), held to the one-rank run (losses and every
  parameter after each step within rtol 2e-4 / atol 2e-5, the reference's
  mesh gate; layer 0's step-0 stash rows bit-equal under ``act``; local
  shapes as ``param_pspecs`` says); 8-bit moments of a row and a column
  split fed the same gradients dequantize bit-equal to one rank's, and a
  straddling split raises naming the parameter; a gradient split unevenly
  (a vocabulary the axis does not divide) is gathered whole by
  ``optim.adamw.placed``; the sharded prefill gives one rank's logits and
  cache within 1e-4 (six archs, every family); the sharded decode step
  over ``cache_pspecs``'s layout gives one rank's greedy tokens, logits
  within 1e-4, for every family (and a batch of 1 with the sequence over
  the data axis).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_family_ranks as ranks
from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import Model as JModel
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.core import backend
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.adamw import _q_state, moment_offset
from repro_torch.parallel import run_ranks, sharding
from torch_threads import one_thread  # noqa: F401

BAND = dict(rtol=2e-4, atol=2e-5)
F32 = dict(atol=2e-5, rtol=1e-5)


def _pair(name):
    cfg = dataclasses.replace(j_reduce(J_ARCHS[name]), act_mode="none",
                              act_dtype="float32")
    tcfg = dataclasses.replace(t_reduce(T_ARCHS[name]), act_mode="none",
                               act_dtype="float32")
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")


def _fronts(cfg, b: int, s: int) -> dict:
    rs = np.random.default_rng(9)
    out = {}
    if cfg.frontend == "vision":
        out["prefix_embeds"] = rs.standard_normal(
            (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["enc_embeds"] = rs.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(ranks.FAMILIES))
def test_one_rank_family_loss_is_the_references(name):
    jm, params, tm = _pair(name)
    tok = np.random.default_rng(5).integers(0, jm.cfg.vocab, (2, 32))
    fronts = _fronts(jm.cfg, 2, 32)
    jl = jm.loss(params, jnp.asarray(tok, jnp.int32), vocab_chunk=8,
                 **{k: jnp.asarray(v) for k, v in fronts.items()})
    with torch.no_grad():
        tl = tm.loss(torch.as_tensor(tok), vocab_chunk=8,
                     **{k: torch.from_numpy(v) for k, v in fronts.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)


def test_vlm_vision_prefix_is_the_references():
    """internvl2-2b with ``prefix_embeds``: the hidden states over prefix
    and tokens, the loss over the tokens alone, and the prefill's logits
    and cache (prefix positions first)."""
    jm, params, tm = _pair("internvl2-2b")
    b, s = 2, 20
    tok = np.random.default_rng(6).integers(0, jm.cfg.vocab, (b, s))
    pfx = _fronts(jm.cfg, b, s)["prefix_embeds"]
    npfx = pfx.shape[1]
    jh, _ = jm.hidden_states(params, jnp.asarray(tok, jnp.int32),
                             prefix_embeds=jnp.asarray(pfx))
    jl = jm.loss(params, jnp.asarray(tok, jnp.int32), vocab_chunk=8,
                 prefix_embeds=jnp.asarray(pfx))
    lj, cj = jm.prefill(params, jnp.asarray(tok, jnp.int32),
                        prefix_embeds=jnp.asarray(pfx), max_seq=npfx + s + 4)
    with torch.no_grad():
        th, _ = tm.hidden_states(torch.as_tensor(tok),
                                 prefix_embeds=torch.from_numpy(pfx))
        tl = tm.loss(torch.as_tensor(tok), vocab_chunk=8,
                     prefix_embeds=torch.from_numpy(pfx))
    lt, ct = tm.prefill(torch.as_tensor(tok), prefix_embeds=torch.from_numpy(
        pfx), max_seq=npfx + s + 4)
    assert tuple(th.shape) == (b, npfx + s, jm.cfg.d_model)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **F32)
    for key in ("k", "v"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]),
                                   **F32)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    assert int(ct["pos"][0]) == npfx + s


#: (global shape, the shard's local shape, its global offset): a row
#: split, a column split, both at once (FSDP rows, model columns), and an
#: expert stack split on E (model) and D (FSDP).
SHARDS = {"rows": ((8, 512), (4, 512), (4, 0)),
          "cols": ((6, 1024), (6, 256), (0, 512)),
          "both": ((8, 1024), (2, 512), (6, 512)),
          "experts": ((8, 16, 64), (2, 4, 64), (4, 8, 0))}


@pytest.mark.parametrize("case", sorted(SHARDS))
def test_moment_shard_blocks_are_the_unsharded_moments(case):
    """A shard's 8-bit moment, quantized at its ``moment_offset``, is the
    whole moment's blocks bit for bit (words, zero, range): the noise is
    the global element's."""
    shape, local, offset = SHARDS[case]
    g = 64
    rs = np.random.default_rng(len(case))
    x = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
    whole = _q_state(x, 8, g, 77)
    idx = tuple(slice(o, o + n) for o, n in zip(offset, local))
    row0, stride = moment_offset(shape, local, offset, g)
    part = _q_state(x[idx].contiguous(), 8, g, 77, (row0, stride))
    # the shard's blocks among the whole moment's, by the element index
    flat = torch.arange(x.numel()).reshape(shape)[idx].reshape(-1, g)[:, 0]
    blocks = flat // g
    for key in ("p", "z", "r"):
        assert torch.equal(part[key], whole[key][blocks]), key
    assert (stride is None) == (case == "rows")


def test_moment_offset_refuses_a_straddling_shard():
    with pytest.raises(ValueError, match=r"\(4, 192\).*straddle"):
        moment_offset((4, 384), (4, 192), (0, 192), 256)
    with pytest.raises(ValueError, match="whole local rows"):
        ops.quantize_packed(torch.zeros(6, 64), 8, 1, block_stride=(4, 8))
    assert moment_offset((4, 384), (4, 384), (0, 0), 256) == (0, None)
    # a stride-free offset is the row0 of a contiguous run
    x = torch.randn(12, 64)
    full = backend.quantize_blocks(x, 2, 5)
    part = backend.quantize_blocks(x[4:8], 2, 5, row0=4, block_stride=(4, 4))
    assert torch.equal(part[0], full[0][4:8])


def test_local_helpers_are_the_plain_ops_on_an_unsharded_model():
    """One decode and prefill path serves plain and sharded models: on
    plain tensors every ``parallel.local`` helper the path reads its
    weights and cache through is the plain op itself."""
    from repro_torch.models.layers import mm, rmsnorm
    from repro_torch.parallel import local as tp

    rs = np.random.default_rng(3)
    x = torch.from_numpy(rs.standard_normal((2, 3, 8)).astype(np.float32))
    w = torch.from_numpy(rs.standard_normal((8, 5)).astype(np.float32))
    assert tp.whole(w) is w and tp.plain_operand(w, x) is w
    assert tp.local_param(w, x, True) is w and tp.local_input(x, True) is x
    assert tp.like(x, x) is x and tp.replicated(w, x) is w
    assert tp.reduce_all(x, (), "max") is x
    assert torch.equal(mm(x, w), x @ w)
    table = torch.from_numpy(rs.standard_normal((11, 4)).astype(np.float32))
    tok = torch.tensor([[3], [10]])
    assert torch.equal(tp.lookup(table, tok), table[tok])
    cache = {"pos": torch.tensor([4, 6], dtype=torch.int32),
             "k": torch.zeros((2, 2, 9, 1, 4))}
    view = tp.CacheView(table, cache)
    assert view.rows(tok) is tok and view.wrap(x) is x
    assert view.pos is cache["pos"] and view.seq(cache["k"]) == (0, ())
    src = torch.ones((2, 5, 1, 4))
    tp.write(cache["k"], 1, src)
    assert float(cache["k"][1, :, :5].sum()) == src.numel()
    assert float(cache["k"].sum()) == src.numel()
    assert torch.equal(rmsnorm(x, w[:, 0]), rmsnorm(x, w[:, 0].clone()))


def test_two_ranks_train_every_family_hold_moments_and_decode():
    local = make_local_mesh("cpu")
    one = {arch: ranks.train(arch, local) for arch in ranks.FAMILIES}
    moments = ranks.moments()
    decode = {(arch, b): ranks.decode(arch, batch=b)
              for arch, b, _ in ranks.DECODE}
    prefill = {arch: ranks.prefill(arch) for arch in ranks.PREFILL}
    got = run_ranks(ranks.everything, 2, timeout=600)
    for rank, res in enumerate(got):
        for (arch, shape), r in res["train"].items():
            want = one[arch]
            tag = f"{arch} {shape} rank {rank}"
            np.testing.assert_allclose(r["loss"], want["loss"], **BAND,
                                       err_msg=tag)
            for step in range(ranks.STEPS):
                for name, w in want["params"][step].items():
                    np.testing.assert_allclose(
                        r["params"][step][name], w, **BAND,
                        err_msg=f"{tag} step {step} {name}")
            sizes = dict(zip(("data", "model"), shape))
            specs = sharding.param_pspecs(None, dict(
                (n, torch.empty(s, device="meta"))
                for n, s in want["local"].items()), sizes)
            for name, spec in specs.items():
                full = want["local"][name]
                exp = tuple(d // int(np.prod([sizes[a] for a in (
                    (e,) if isinstance(e, str) else (e or ()))]))
                    for d, e in zip(full, spec))
                assert r["local"][name] == exp, (tag, name)
            if want["stash"] is not None:
                row0, words = r["stash"]
                np.testing.assert_array_equal(
                    words, want["stash"][1][row0:row0 + len(words)])
        for mesh in ("moments", "moments_2x1"):
            for name, m in res[mesh].items():
                if name == "straddle":
                    continue
                w = moments[name]
                for key in ("m", "v"):
                    # this rank's shard of the one-rank moments
                    np.testing.assert_array_equal(
                        m[key], _shard_of(w[key], m[key].shape, rank),
                        err_msg=f"{mesh} {name}")
                np.testing.assert_array_equal(m["p"], w["p"])
        assert res["uneven"]
        assert "straddle" in res["moments"]["straddle"] \
            and "(4, 384)" in res["moments"]["straddle"]
        for arch, r in res["prefill"].items():
            for key, want in prefill[arch].items():
                np.testing.assert_allclose(r[key], want, atol=1e-4, rtol=1e-4,
                                           err_msg=f"prefill {arch} {key}")
        for key, r in res["decode"].items():
            np.testing.assert_array_equal(r["tokens"], decode[key]["tokens"],
                                          err_msg=str(key))
            np.testing.assert_allclose(r["logits"], decode[key]["logits"],
                                       atol=1e-4, rtol=1e-4,
                                       err_msg=str(key))


def _shard_of(whole: np.ndarray, local_shape, rank: int):
    """Rank ``rank``'s shard of ``whole`` of ``local_shape``: the split dim
    is the one whose size differs."""
    for dim, (a, b) in enumerate(zip(whole.shape, local_shape)):
        if a != b:
            idx = [slice(None)] * whole.ndim
            idx[dim] = slice(rank * b, (rank + 1) * b)
            return whole[tuple(idx)]
    return whole
