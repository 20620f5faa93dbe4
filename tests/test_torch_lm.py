"""The port's LM against the JAX reference on the CPU: configs, seeds and
the synthetic prompt source (exact), then ``Model.prefill`` logits and KV
cache and several ``decode_step``s from the same weights
(``params_from_jax``) for qwen1.5-4b (QKV bias, MHA), mistral-nemo-12b
(GQA, H*Dh != d_model), qwen3-32b (qk-norm) and qwen1.5-32b (QKV bias,
40 KV heads), the training forward (``hidden_states`` and ``loss``), the
legacy loop's greedy decode, and the launcher.

Tolerances: float32 activations 2e-5 absolute + 1e-5 relative (the
matmuls sum in other orders); bf16 activations 0.1 absolute on logits of
magnitude up to ~4 (about six bf16 ulps: the two libraries round some bf16
intermediates differently, and the differences carry through the layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import reduce_for_smoke as j_reduce
from repro.data import batch_for_step as j_batch_for_step
from repro.engine import seeds as j_seeds
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.models import Model as JModel
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import cell_applicable as t_cell_applicable
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.data import batch_for_step as t_batch_for_step
from repro_torch.engine import seeds as t_seeds
from repro_torch.launch import serve as t_serve
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import Model
from repro_torch.models.convert import params_from_jax, to_tensor
from torch_threads import one_thread  # noqa: F401

LM_ARCHS = ["qwen1.5-4b", "mistral-nemo-12b", "qwen3-32b", "qwen1.5-32b"]
TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
       "bfloat16": dict(atol=0.1, rtol=0.0)}


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_configs_match_reference(name):
    """Every field, the analytic parameter counts, the smoke reduction and
    the cell gate equal the reference's."""
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import cell_applicable as j_cell_applicable

    def fields(cfg):
        d = dataclasses.asdict(cfg)
        d.pop("act_compression")
        return d

    j, t = J_ARCHS[name], T_ARCHS[name]
    assert fields(t) == fields(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.shared_attn_sites() == j.shared_attn_sites()
    assert fields(t_reduce(t)) == fields(j_reduce(j))
    for shape in J_SHAPES:
        assert dataclasses.asdict(T_SHAPES[shape]) == \
            dataclasses.asdict(J_SHAPES[shape])
        assert t_cell_applicable(t, T_SHAPES[shape]) == \
            j_cell_applicable(j, J_SHAPES[shape])


def test_qwen1_5_4b_is_the_served_config():
    cfg = T_ARCHS["qwen1.5-4b"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab, cfg.qkv_bias) == (
        40, 2560, 20, 20, 128, 6912, 151_936, True)
    assert cfg.param_count() == 3_949_854_720


# ------------------------------------------------------ seeds and prompts
def test_step_and_kv_seeds_match_reference():
    pos = np.asarray([0, 1, 999, 1031, 2**31 + 7, 2**32 - 1], np.int64)
    for step in pos.tolist():
        assert t_seeds.step_seed(step) == int(j_seeds.step_seed(
            np.uint32(step)))
    np.testing.assert_array_equal(
        t_seeds.step_seed(torch.from_numpy(pos)).numpy(),
        np.asarray(j_seeds.step_seed(jnp.asarray(pos.astype(np.uint32)))))
    slots = np.arange(4, dtype=np.int64)
    for li in (0, 1, 39):
        for field in (0, 1):
            want = np.asarray(j_seeds.kv_seed(
                jnp.asarray(pos.astype(np.uint32))[:, None],
                jnp.asarray(slots)[None, :], li, field)).astype(np.int64)
            got = t_seeds.kv_seed(torch.from_numpy(pos)[:, None],
                                  torch.from_numpy(slots)[None, :], li, field)
            np.testing.assert_array_equal(got.numpy(), want)
            assert t_seeds.kv_seed(int(pos[4]), 3, li, field) == want[4, 3]
    assert t_seeds.KV_SLOT_STRIDE == j_seeds.KV_SLOT_STRIDE


@pytest.mark.parametrize("step", [0, 1, 7])
def test_batch_for_step_matches_reference(step):
    np.testing.assert_array_equal(
        t_batch_for_step(151_936, 2, 100, step=step, seed=11),
        j_batch_for_step(151_936, 2, 100, step=step, seed=11))


# ------------------------------------------------------------------ model
def _pair(name, act_dtype):
    cfg = dataclasses.replace(j_reduce(J_ARCHS[name]), act_mode="none",
                              act_dtype=act_dtype)
    tcfg = dataclasses.replace(t_reduce(T_ARCHS[name]), act_mode="none",
                               act_dtype=act_dtype)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    if cfg.qkv_bias:   # non-zero biases, so that adding them is checked
        for i, b in enumerate(("bq", "bk", "bv")):
            shape = params["layers"]["attn"][b].shape
            params["layers"]["attn"][b] = jnp.asarray(
                np.random.default_rng(i).normal(size=shape) * 0.3,
                jnp.float32)
    return jm, params, params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg, device="cpu")


def _f32(a):
    return a.detach().to(torch.float32).numpy() \
        if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_and_decode_match_reference(name, act_dtype):
    jm, params, tm = _pair(name, act_dtype)
    tol = TOL[act_dtype]
    tokens = np.random.default_rng(3).integers(
        0, jm.cfg.vocab, (2, 37)).astype(np.int32)
    lj, cj = jm.prefill(params, jnp.asarray(tokens), max_seq=48)
    lt, ct = tm.prefill(torch.from_numpy(tokens), max_seq=48)
    assert lt.dtype == torch.float32 and lt.shape == (2, jm.cfg.vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
    for key in ("k", "v"):
        assert ct[key].dtype == getattr(torch, act_dtype)
        assert tuple(ct[key].shape) == cj[key].shape
        np.testing.assert_allclose(_f32(ct[key]), _f32(cj[key]), **tol)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))
    tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    for _ in range(3):
        lj, cj = jm.decode_step(params, cj, jnp.asarray(tok))
        lt, ct = tm.decode_step(ct, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
        tok = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None].astype(np.int32)
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(cj["pos"]))


def test_params_from_jax_keeps_every_weight_bit():
    jm, params, tm = _pair("qwen3-32b", "bfloat16")
    assert tm.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(tm.lm_head),
                                  _f32(params["lm_head"]))
    for li, lp in enumerate(tm.layers):
        for name in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
            np.testing.assert_array_equal(
                _f32(getattr(lp.attn, name)),
                _f32(params["layers"]["attn"][name][li]))
        np.testing.assert_array_equal(
            _f32(lp.mlp.w_down), _f32(params["layers"]["mlp"]["w_down"][li]))
    bits = np.asarray(params["embed"]).view(np.uint16)
    assert np.array_equal(to_tensor(params["embed"]).view(torch.int16)
                          .numpy().view(np.uint16), bits)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_random_init_has_reference_shapes_and_dtypes(name):
    cfg = dataclasses.replace(j_reduce(J_ARCHS[name]), act_mode="none")
    params = jax.eval_shape(lambda: JModel(cfg).init(jax.random.PRNGKey(0)))
    tm = Model(dataclasses.replace(t_reduce(T_ARCHS[name]), act_mode="none"),
               device="cpu", generator=torch.Generator().manual_seed(0))
    want = {"embed": params["embed"], "final_norm": params["final_norm"],
            "lm_head": params["lm_head"]}
    for key, spec in want.items():
        t = getattr(tm, key)
        assert tuple(t.shape) == spec.shape
        assert str(t.dtype).split(".")[1] == str(spec.dtype)
    flat = jax.tree_util.tree_flatten_with_path(params["layers"])[0]
    for path, spec in flat:
        names = [p.key for p in path]
        t = tm.layers[0]
        for n in names:
            t = getattr(t, n)
        assert tuple(t.shape) == spec.shape[1:], names
        assert str(t.dtype).split(".")[1] == str(spec.dtype), names
    assert len(tm.layers) == cfg.n_layers
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(params))
    w = tm.layers[0].mlp.w_gate.detach().float()
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.05


def test_model_lives_on_the_card_unless_the_cpu_is_asked_for():
    """``Model`` and ``params_from_jax`` default to the card; without one
    they raise instead of serving on the CPU unasked."""
    cfg = t_reduce(T_ARCHS["qwen1.5-4b"])
    params = JModel(dataclasses.replace(
        j_reduce(J_ARCHS["qwen1.5-4b"]), act_mode="none")).init(
            jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
        assert params_from_jax(params, cfg).device.type == "cuda"
    else:
        for make in (lambda: Model(cfg), lambda: params_from_jax(params, cfg)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    assert Model(cfg, device="cpu").device.type == "cpu"
    assert params_from_jax(params, cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", LM_ARCHS)
def test_hidden_states_and_loss_match_reference(name):
    """The training forward (``act_mode="none"``): ``hidden_states`` and
    ``loss`` from the same weights as the reference's, at float32
    activations, for QKV bias, GQA and qk-norm."""
    jm, params, tm = _pair(name, "float32")
    tok = np.random.default_rng(5).integers(0, jm.cfg.vocab, (2, 20))
    jh, _ = jm.hidden_states(params, jnp.asarray(tok, jnp.int32))
    with torch.no_grad():
        th, aux = tm.hidden_states(torch.as_tensor(tok))
        tl = tm.loss(torch.as_tensor(tok), vocab_chunk=8)
    np.testing.assert_allclose(_f32(th), _f32(jh), **TOL["float32"])
    assert float(aux) == 0.0
    jl = jm.loss(params, jnp.asarray(tok, jnp.int32), vocab_chunk=8)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_serve_step_greedy_decode_matches_reference(name):
    """The legacy loop's step: prefill, then 6 greedy tokens, equal to the
    reference's at float32 activations (and the same on a rerun)."""
    jm, params, tm = _pair(name, "float32")
    prompt = np.random.default_rng(4).integers(0, jm.cfg.vocab, (2, 16))
    _, cj = jm.prefill(params, jnp.asarray(prompt, jnp.int32), max_seq=32)
    jstep = jax.jit(j_make_serve_step(jm))
    tok = jnp.asarray(prompt[:, -1:], jnp.int32)
    want = []
    for _ in range(6):
        tok, _, cj = jstep(params, cj, tok)
        want.append(np.asarray(tok))
    step = make_serve_step(tm)
    runs = []
    for _ in range(2):
        _, ct = tm.prefill(torch.as_tensor(prompt, dtype=torch.int32),
                           max_seq=32)
        tok = torch.as_tensor(prompt[:, -1:], dtype=torch.int32)
        got = []
        for _ in range(6):
            tok, _, ct = step(ct, tok)
            got.append(tok.numpy())
        runs.append(np.concatenate(got, 1))
    np.testing.assert_array_equal(runs[0], np.concatenate(want, 1))
    np.testing.assert_array_equal(runs[0], runs[1])


# ---------------------------------------------------------------- launcher
def test_serve_launcher_on_cpu():
    outs = t_serve.main(["--arch", "qwen1.5-4b", "--smoke", "--device",
                         "cpu", "--requests", "3", "--max-batch", "2",
                         "--prompt-len", "12", "--gen-len", "5",
                         "--kv-bits", "4"])
    assert len(outs) == 3 and all(o.shape == (5,) for o in outs)
    again = t_serve.main(["--arch", "qwen1.5-4b", "--smoke", "--device",
                          "cpu", "--requests", "3", "--max-batch", "2",
                          "--prompt-len", "12", "--gen-len", "5",
                          "--kv-bits", "4", "--mode", "fixed"])
    for a, b in zip(outs, again):   # fixed batching: the same tokens
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["host", "pinned-paged"])
def test_serve_launcher_kv_host_policies(policy):
    """``--kv-policy host|pinned-paged`` serves the ``device`` policy's
    tokens."""
    argv = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-batch", "2", "--prompt-len", "12",
            "--gen-len", "5", "--kv-bits", "4"]
    outs = t_serve.main(argv + ["--kv-policy", policy])
    for a, b in zip(outs, t_serve.main(argv)):
        np.testing.assert_array_equal(a, b)


def test_serve_launcher_obs(capsys):
    """``--obs`` serves the same tokens and prints the reference's serving
    counters."""
    argv = ["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-batch", "2", "--prompt-len", "12",
            "--gen-len", "5", "--kv-bits", "4"]
    plain = t_serve.main(argv)
    capsys.readouterr()
    outs = t_serve.main(argv + ["--obs"])
    for a, b in zip(outs, plain):
        np.testing.assert_array_equal(a, b)
    printed = dict(line.strip().split(": ", 1)
                   for line in capsys.readouterr().out.splitlines()
                   if line.startswith("  serve/"))
    # a counter prints once it has counted: nothing was rejected
    assert set(printed) == set(t_serve.OBS_KEYS) - {"serve/rejected"}
    assert printed["serve/admitted"] == printed["serve/completed"] == "3"
    assert int(printed["serve/decode_steps"]) > 0


def test_serve_launcher_defaults_to_the_card():
    args = t_serve.parser().parse_args(["--arch", "qwen1.5-4b"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_serve.build_model(args)
