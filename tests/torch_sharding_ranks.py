"""What each rank runs in the two-rank test of ``tests/test_torch_sharding.py``
(``repro_torch.parallel.run_ranks`` starts the ranks by ``spawn``, which
imports this module by name).  It imports nothing of JAX; every function
returns numpy arrays and python values."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get, reduce_for_smoke
from repro_torch.core import act_compress
from repro_torch.core.compressor import CompressionConfig
from repro_torch.data import batch_for_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import data_group
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import annotate, sharding

BATCH, SEQ, STEPS = 4, 64, 2
OPT = AdamWConfig(lr=3e-5, weight_decay=0.01, grad_clip=1.0)


def config():
    """qwen1.5-4b cut to the smoke size, trained under ``act`` (INT2, G
    256), its residual stream in float32 (and its weights, see
    :func:`model`): a bf16 stream rounds the sharded partial sums
    differently from the unsharded product, and INT2's stochastic
    rounding turns those last-bit differences into whole-level flips
    downstream."""
    return dataclasses.replace(
        reduce_for_smoke(get("qwen1.5-4b")), act_mode="act",
        act_dtype="float32",
        act_compression=CompressionConfig(bits=2, group_size=256))


def tokens(step: int) -> torch.Tensor:
    return torch.as_tensor(batch_for_step(config().vocab, BATCH, SEQ, step))


def full(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t``'s global value (a float32 parameter's numpy view
    would follow the later in-place updates)."""
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().to(torch.float32).numpy().copy()


def float_model():
    """The seed-0 weights in float32: a bf16 weight's gradient is rounded
    to bf16 after the sharded partial sums are added, and one bf16 step
    of a weight (0.4 %) is far outside the band the sharded run is held
    to."""
    return Model(config(), device="cpu",
                 generator=torch.Generator().manual_seed(0)).float()


def train(mesh) -> dict:
    """STEPS steps of the launcher's recipe on ``mesh``: each step's loss
    and every parameter after it (gathered), layer 0's step-0 stash and
    its global block offset, and each parameter's local shape."""
    cfg = config()
    annotate.set_rules(**annotate.rules_for(cfg, mesh, BATCH))
    model = float_model()
    specs = sharding.distribute_model(model, mesh)
    local = {n: tuple(p.to_local().shape if hasattr(p, "to_local")
                      else p.shape) for n, p in model.named_parameters()}
    params = list(model.parameters())
    state = adamw_init(params, OPT)
    step_fn = make_train_step(model, OPT)
    stash = []
    real = act_compress.compress

    def record(x, cfg_, seed, row0=0):
        ct = real(x, cfg_, seed, row0)
        if not stash:
            stash.append((row0, ct.packed.numpy().copy(),
                          ct.zero.numpy().copy()))
        return ct

    act_compress.compress = record
    try:
        losses, after = [], []
        for step in range(STEPS):
            batch = sharding.distribute_batch(cfg, {"tokens": tokens(step)},
                                              mesh)
            losses.append(float(step_fn(state, batch)["loss"]))
            after.append({n: full(p) for n, p in model.named_parameters()})
    finally:
        act_compress.compress = real
        annotate.set_rules()
    return {"loss": losses, "params": after, "stash": stash[0],
            "local": local, "specs": specs}


def two_meshes(rank: int, world: int) -> dict:
    """Both (data, model) meshes of two ranks in one pair of processes,
    and what the (1, 2) mesh refuses: 8-bit moments whose shards straddle
    blocks of 256 (the smoke width's 32-column shards), nothing at blocks
    of 16, nor the MoE family.  Two threads a rank: the test suite runs
    beside them."""
    torch.set_num_threads(2)
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        out[shape] = train(mesh)
        out[shape]["dp_group"] = torch.distributed.get_world_size(
            data_group(mesh))
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    refusals = []
    model = float_model()
    sharding.distribute_model(model, mesh)
    names, params = zip(*model.named_parameters())
    for group in (256, 16):
        try:
            adamw_init(params, AdamWConfig(state_bits=8, state_group=group),
                       names=names)
        except ValueError as e:
            refusals.append(str(e))
    moe = reduce_for_smoke(get("qwen3-moe-235b-a22b"))
    sharding.distribute_model(
        Model(moe, device="cpu", generator=torch.Generator().manual_seed(0)),
        mesh)
    out["refusals"] = refusals
    return out
