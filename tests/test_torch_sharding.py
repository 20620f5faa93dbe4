"""The LM sharding rules, the mesh, the step inputs and sharded training on
the CPU, against the JAX reference and against the port's one-rank run.

* The rules (``param_pspecs``, ``batch_pspecs``, ``cache_pspecs``,
  ``graph_batch_pspecs``, ``rules_for``) are pure functions of shapes and
  axis sizes: they are evaluated at the production sizes (16 x 16 and
  2 x 16 x 16, through ``{name: size}`` mappings as the reference's tests
  use a ``FakeMesh``) and at two ranks' (1, 2) and (2, 1), for all ten
  archs.  The reference's trees come from ``jax.eval_shape``, the port's
  from its own parameter tree and cache on the ``meta`` device.  The port
  has one module a layer where the reference stacks the layers, so each
  layer's spec is the reference's with the leading ``None`` dropped;
  otherwise they are equal, leaf for leaf.
* ``input_specs`` builds all 32 applicable cells on ``meta`` (nothing
  allocated) with the reference's keys, shapes and dtypes.
* ``quant_pack``'s block offset: a shard of rows quantized with its
  offset is bit-equal to those rows of the unsharded call (and both to
  the reference's jnp path).
* Two gloo ranks on the CPU train ``reduce_for_smoke(qwen1.5-4b)`` under
  ``act`` on the (data 1, model 2) and (data 2, model 1) meshes, in one
  pair of processes (``tests/torch_sharding_ranks.py``), held to the
  port's one-rank run: losses and every parameter after each of 2 steps
  within rtol 2e-4 / atol 2e-5 (the reference's mesh gate), layer 0's
  step-0 stash bit-equal to the one-rank stash's rows, and each
  parameter's local shape what ``param_pspecs`` says.  Weights and
  residual stream are float32 there (``torch_sharding_ranks.config``):
  in bf16 the sharded partial sums round apart by a bf16 step.  The
  one-rank run is held to the JAX reference by
  ``tests/test_torch_train.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_sharding_ranks as ranks
from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import input_specs as j_input_specs
from repro.kernels import ref as j_ref
from repro.models import Model as JModel
from repro.parallel import annotate as j_annotate
from repro.parallel import sharding as j_sharding
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, input_specs
from repro_torch.core import act_compress
from repro_torch.core.variance import optimize_levels
from repro_torch.kernels import ops
from repro_torch.kernels import ref as t_ref
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.parallel import annotate, run_ranks, sharding
from torch_threads import one_thread  # noqa: F401


class FakeMesh:
    """The reference tests' mesh stand-in: axis sizes alone."""

    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "1x2": {"data": 1, "model": 2},
          "2x1": {"data": 2, "model": 1}}
ARCH_IDS = sorted(ARCHS)


@functools.lru_cache(maxsize=None)
def _j_param_shapes(arch):
    model = JModel(J_ARCHS[arch])
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))


def _j_flat(tree, specs, n_layers: dict) -> dict:
    """The reference's specs by the port's dotted names: a stacked leaf
    (under ``layers`` / ``enc_layers``) becomes one name a layer, its
    spec without the leading layer axis."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    for path, spec in flat:
        keys = [p.key for p in path]
        spec = tuple(spec)
        if keys[0] in n_layers:
            for i in range(n_layers[keys[0]]):
                out[".".join([keys[0], str(i), *keys[1:]])] = spec[1:]
        else:
            out[".".join(keys)] = spec
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_are_the_references(arch, mesh):
    cfg = ARCHS[arch]
    sizes = MESHES[mesh]
    jshape = _j_param_shapes(arch)
    want = _j_flat(jshape, j_sharding.param_pspecs(
        J_ARCHS[arch], jshape, FakeMesh(sizes)),
        {"layers": max(cfg.n_layers, 1), "enc_layers": cfg.encoder_layers})
    tree = init_params(cfg, torch.device("meta"))
    got = sharding.param_pspecs(cfg, tree, sizes)
    assert got == want
    # and each spec's dims divide their axes (the reference's own test)
    shapes = dict(sharding._named_leaves(tree))
    for name, spec in got.items():
        for dim, entry in zip(shapes[name].shape, spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_and_batch_specs_are_the_references(mesh):
    sizes = MESHES[mesh]
    for arch in ARCH_IDS:
        for batch in (256, 32, 1):
            for train in (True, False):
                assert annotate.rules_for(ARCHS[arch], sizes, batch,
                                          is_train=train) == \
                    j_annotate.rules_for(J_ARCHS[arch], FakeMesh(sizes),
                                         batch, is_train=train)
            want = j_sharding.batch_pspecs(J_ARCHS[arch], "train",
                                           FakeMesh(sizes), batch)
            got = sharding.batch_pspecs(ARCHS[arch], "train", sizes, batch)
            assert got == {k: tuple(v) for k, v in want.items()}
    assert sharding.dp_size(sizes) == j_sharding.dp_size(FakeMesh(sizes))
    assert sharding.dp_axes(sizes) == j_sharding.dp_axes(FakeMesh(sizes))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_pspecs_are_the_references(mesh):
    """Every arch's decode cache at the decode cells' batches and a small
    sequence (the rules read the cache's head and sequence dims), and the
    long-context cell's batch of 1."""
    sizes = MESHES[mesh]
    for arch in ARCH_IDS:
        cfg = ARCHS[arch]
        for batch, seq in ((128, 4096), (1, 8192), (3, 96)):
            enc = min(4096, seq) if cfg.family == "encdec" else 0
            model = JModel(J_ARCHS[arch])
            jc = jax.eval_shape(lambda: model.init_cache(batch, seq,
                                                         enc_len=enc))
            want = j_sharding.cache_pspecs(J_ARCHS[arch], jc,
                                           FakeMesh(sizes), batch, seq)
            tc = init_cache(cfg, batch, seq, enc_len=enc, device="meta")
            assert {k: tuple(v.shape) for k, v in tc.items()} == \
                {k: tuple(v.shape) for k, v in jc.items()}
            got = sharding.cache_pspecs(cfg, tc, sizes, batch, seq)
            assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_graph_batch_pspecs_are_the_references(mesh):
    sizes = MESHES[mesh]
    batch = {"features": np.zeros((2, 4, 32, 8), np.float32),
             "adj": (np.zeros((2, 4, 96), np.int32),
                     np.zeros((2, 3, 96), np.int32)),
             "labels": np.zeros((2, 4, 32), np.int32),
             "n_real": np.zeros((32,), np.int32)}
    for axis in (0, 1, 2):
        want = j_sharding.graph_batch_pspecs(batch, FakeMesh(sizes), axis)
        got = sharding.graph_batch_pspecs(batch, sizes, axis)
        assert got == jax.tree.map(tuple, want,
                                   is_leaf=lambda x: isinstance(x, P))


def test_input_specs_build_every_cell_on_meta():
    """All 32 applicable cells (10 archs x 4 shapes, less the 8
    full-attention long-context skips), on ``meta``, with the reference's
    keys, shapes and dtypes."""
    n = 0
    for arch, cfg in ARCHS.items():
        for name, shape in SHAPES.items():
            if not cell_applicable(cfg, shape)[0]:
                continue
            got = input_specs(cfg, shape)
            want = j_input_specs(J_ARCHS[arch], J_SHAPES[name])
            flat = {"cache": got.pop("cache")} if "cache" in got else {}
            leaves = list(got.values()) + list(flat.get("cache", {}).values())
            assert all(t.device.type == "meta" for t in leaves)
            wflat = dict(want)
            wcache = wflat.pop("cache", None)
            assert set(got) == set(wflat)
            for k, t in got.items():
                assert tuple(t.shape) == tuple(wflat[k].shape)
                assert str(t.dtype).split(".")[-1] == str(wflat[k].dtype)
            if wcache is not None:
                for k, t in flat["cache"].items():
                    assert tuple(t.shape) == tuple(wcache[k].shape), (arch, k)
                    assert str(t.dtype).split(".")[-1] == \
                        str(wcache[k].dtype)
            n += 1
    assert n == 32


@pytest.mark.parametrize("g,bits,vm,row0", [(64, 2, False, 7),
                                            (256, 2, True, 5),
                                            (64, 4, False, 0),
                                            (128, 8, False, 11)])
def test_quant_pack_offset_rows_are_the_unsharded_calls(g, bits, vm, row0):
    """Rows ``row0 ..`` quantized alone with ``row0`` are the unsharded
    call's rows bit for bit, words, zero and range, against the
    reference's jnp path too."""
    rs = np.random.default_rng(g + bits)
    x = (rs.standard_normal((24, g)) * 2.0).astype(np.float32)
    levels = tuple(float(v) for v in optimize_levels(g, bits)) if vm \
        else None
    jp, jz, jr = j_ref.quantize_packed(
        jnp.asarray(x), bits, 99,
        None if levels is None else np.asarray(levels, np.float32))
    jp = np.asarray(jp).view(np.int32)
    full = ops.quantize_packed(torch.from_numpy(x), bits, 99, levels)
    np.testing.assert_array_equal(full[0].numpy(), jp)
    part = ops.quantize_packed(torch.from_numpy(x[row0:row0 + 9]), bits, 99,
                               levels, row0=row0)
    np.testing.assert_array_equal(part[0].numpy(), jp[row0:row0 + 9])
    np.testing.assert_array_equal(part[1].numpy(),
                                  np.asarray(jz)[row0:row0 + 9])
    np.testing.assert_array_equal(part[2].numpy(),
                                  np.asarray(jr)[row0:row0 + 9])
    with pytest.raises(ValueError, match="seed table"):
        t_ref.quantize_packed(torch.from_numpy(x[:4]), bits,
                              torch.tensor([1, 2]), rows_per_seed=2, row0=1)


def test_shard_rows_of_a_plain_tensor_is_itself():
    x = torch.zeros(4, 64)
    assert act_compress.shard_rows(x, 64) == (x, 0)


def test_local_mesh_installs_rules_that_change_nothing():
    """A (1, 1) mesh needs no process group, distributes nothing, and the
    rules it yields leave every annotation an identity."""
    mesh = make_local_mesh("cpu")
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data", "model")
    cfg = ranks.config()
    annotate.set_rules(**annotate.rules_for(cfg, mesh, 4))
    try:
        x = torch.randn(2, 3, 4)
        assert annotate.shard(x, "batch", None, "dff") is x
        b = {"tokens": torch.zeros(2, 8, dtype=torch.int32)}
        assert sharding.distribute_batch(cfg, b, mesh) is b
    finally:
        annotate.set_rules()
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        make_mesh((1, 2), ("data", "model"), "cpu")


def test_two_gloo_ranks_train_the_dense_lm_on_both_meshes():
    one = ranks.train(make_local_mesh("cpu"))
    got = run_ranks(ranks.two_meshes, 2, timeout=300)
    for rank, res in enumerate(got):
        # 8-bit moments refuse only shards that straddle their blocks,
        # naming the parameter; the MoE family distributes
        assert len(res["refusals"]) == 1
        assert "8-bit moments of layers.0.attn.wq (64, 64)" in \
            res["refusals"][0] and "straddle" in res["refusals"][0]
        for shape, dp in (((1, 2), 1), ((2, 1), 2)):
            r = res[shape]
            assert r["dp_group"] == dp
            np.testing.assert_allclose(r["loss"], one["loss"], rtol=2e-4,
                                       atol=2e-5)
            for step in range(ranks.STEPS):
                for name, want in one["params"][step].items():
                    np.testing.assert_allclose(
                        r["params"][step][name], want, rtol=2e-4, atol=2e-5,
                        err_msg=f"{shape} rank {rank} step {step} {name}")
            sizes = dict(zip(("data", "model"), shape))
            for name, spec in r["specs"].items():
                full = one["local"][name]
                want = tuple(
                    d // int(np.prod([sizes[a] for a in
                                      ((e,) if isinstance(e, str)
                                       else (e or ()))]))
                    for d, e in zip(full, spec))
                assert r["local"][name] == want, (shape, name)
            row0, packed, zero = r["stash"]
            assert row0 == (rank * len(packed) if dp == 2 else 0)
            np.testing.assert_array_equal(
                packed, one["stash"][1][row0:row0 + len(packed)])
            np.testing.assert_array_equal(
                zero, one["stash"][2][row0:row0 + len(zero)])
