"""What each rank runs in the two-rank test of ``tests/test_torch_families.py``
(``repro_torch.parallel.run_ranks`` starts the ranks by ``spawn``, which
imports this module by name): every family trained on the (1, 2) and
(2, 1) (data, model) meshes, 8-bit AdamW moments of a row split, a column
split and a straddling split, and the sharded prefill and decode step.  It
imports nothing of JAX; every function returns numpy arrays and python
values."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get, reduce_for_smoke
from repro_torch.core import act_compress
from repro_torch.core.compressor import CompressionConfig
from repro_torch.data import batch_for_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_serve_step, make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import _dq_state, adamw_update
from repro_torch.parallel import annotate, sharding

BATCH, SEQ, STEPS = 4, 32, 2
OPT = AdamWConfig(lr=3e-5, weight_decay=0.01, grad_clip=1.0)
#: Each family's arch and the mode it trains under: the SSM and the
#: hybrid stash their layers compressed (``act``), the enc-dec and the MoE
#: checkpoint them (what ``act`` and ``remat`` both mean there).
FAMILIES = {"mamba2-780m": "act", "zamba2-1.2b": "act",
            "seamless-m4t-large-v2": "remat", "qwen3-moe-235b-a22b": "remat",
            "internvl2-2b": "act"}
MESHES = ((1, 2), (2, 1))
#: The decode check: (arch, batch, mesh) of each run (a batch of 1 lays
#: the cache sequence over the data axis and ``model``), prompt length,
#: steps.
DECODE = tuple((arch, BATCH, (1, 2)) for arch in (
    "qwen1.5-4b", "mamba2-780m", "zamba2-1.2b", "seamless-m4t-large-v2",
    "qwen3-moe-235b-a22b", "arctic-480b", "internvl2-2b")) + (
    ("qwen1.5-4b", 1, (2, 1)), ("zamba2-1.2b", 1, (2, 1)))
PROMPT, GEN = 16, 4


def config(arch: str, mode: str | None = None):
    """``arch`` cut to the smoke size, its residual stream in float32 (a
    bf16 stream rounds the sharded partial sums apart from the unsharded
    product's, and INT2's stochastic rounding turns those into whole-level
    flips)."""
    return dataclasses.replace(
        reduce_for_smoke(get(arch)), act_mode=mode or FAMILIES[arch],
        act_dtype="float32",
        act_compression=CompressionConfig(bits=2, group_size=256))


def fronts(cfg, step: int) -> dict:
    """The step's tokens and the stub frontends' outputs (float32), the
    same on every rank."""
    out = {"tokens": torch.as_tensor(batch_for_step(cfg.vocab, BATCH, SEQ,
                                                    step))}
    gen = torch.Generator().manual_seed(1000 + step)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = torch.randn(
            (BATCH, cfg.frontend_len, cfg.d_model), generator=gen)
    if cfg.family == "encdec":
        out["enc_embeds"] = torch.randn((BATCH, SEQ, cfg.d_model),
                                        generator=gen)
    return out


def full(t: torch.Tensor) -> np.ndarray:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().to(torch.float32).numpy().copy()


def float_model(cfg):
    """The seed-0 weights in float32."""
    return Model(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(0)).float()


def train(arch: str, mesh) -> dict:
    """STEPS steps of ``arch`` on ``mesh``: each step's loss, every
    parameter after it (gathered), layer 0's step-0 stash and its block
    offset (``act``), and each parameter's local shape."""
    cfg = config(arch)
    annotate.set_rules(**annotate.rules_for(cfg, mesh, BATCH))
    model = float_model(cfg)
    sharding.distribute_model(model, mesh)
    local = {n: tuple(p.to_local().shape if hasattr(p, "to_local")
                      else p.shape) for n, p in model.named_parameters()}
    state = adamw_init(list(model.parameters()), OPT)
    step_fn = make_train_step(model, OPT)
    stash, real = [], act_compress.compress

    def record(x, cfg_, seed, row0=0):
        ct = real(x, cfg_, seed, row0)
        if not stash:
            stash.append((row0, ct.packed.numpy().copy()))
        return ct

    act_compress.compress = record
    try:
        losses, after = [], []
        for step in range(STEPS):
            b = sharding.distribute_batch(cfg, fronts(cfg, step), mesh)
            losses.append(float(step_fn(state, b)["loss"]))
            after.append({n: full(p) for n, p in model.named_parameters()})
    finally:
        act_compress.compress = real
        annotate.set_rules()
    return {"loss": losses, "params": after,
            "stash": stash[0] if stash else None, "local": local}


# ---------------------------------------------------------- 8-bit moments
#: (name, global shape, placement over (data, model)) of the parameters
#: whose 8-bit moments are held to one rank's: a row split, a column split
#: (blocks of a local row 256 apart from the next row's) and both at once.
MOMENTS = (("rows", (8, 512), "row"), ("cols", (6, 512), "col"),
           ("both", (4, 1024), "both"))
#: A split whose local rows straddle blocks of 256.
STRADDLE = ("straddle", (4, 384))


def moment_grads(shape, step: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(7 * step + shape[0])
    return torch.randn(shape, generator=gen)


def moments(mesh=None) -> dict:
    """Two 8-bit AdamW steps of each parameter of MOMENTS, fed the same
    full gradients (each rank its shard), from zero moments: the moments
    dequantized and gathered, and the parameters; on ``mesh``, and what a
    straddling split raises."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    opt = AdamWConfig(lr=1e-2, state_bits=8)
    out = {}
    for name, shape, how in MOMENTS:
        p0 = torch.linspace(-1, 1, int(np.prod(shape))).reshape(shape)
        if mesh is None:
            p = p0.clone()
        else:
            pl = {"row": (Replicate(), Shard(0)), "col": (Replicate(),
                                                           Shard(1)),
                  "both": (Shard(0), Shard(1))}[how]
            p = distribute_tensor(p0, mesh, pl, src_data_rank=None)
        state = adamw_init([p], opt, names=[name])
        for step in range(2):
            g = moment_grads(shape, step)
            if mesh is not None:
                g = distribute_tensor(g, mesh, p.placements,
                                      src_data_rank=None)
            adamw_update([g], state, [p], opt)
        local = p.to_local() if mesh is not None else p
        m = _dq_state(state["m"][0], 8, opt.state_group, local.shape)
        v = _dq_state(state["v"][0], 8, opt.state_group, local.shape)
        out[name] = {"m": m.numpy().copy(), "v": v.numpy().copy(),
                     "p": full(p), "words": state["m"][0]["p"].numpy().copy()}
    if mesh is not None:
        name, shape = STRADDLE
        p = distribute_tensor(torch.zeros(shape), mesh,
                              (Replicate(), Shard(1)), src_data_rank=None)
        try:
            adamw_init([p], opt, names=[name])
            out["straddle"] = None
        except ValueError as exc:
            out["straddle"] = str(exc)
    return out


def uneven_gather(mesh) -> bool:
    """A gradient split unevenly over ``model`` (7 columns over 2 ranks: a
    vocabulary of 50,280 over 16) gathered by ``optim.adamw.placed``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.optim.adamw import placed

    full = torch.arange(21, dtype=torch.float32).reshape(3, 7)
    g = distribute_tensor(full, mesh, (Replicate(), Shard(1)),
                          src_data_rank=None)
    p = distribute_tensor(torch.zeros(3, 7), mesh, (Replicate(),
                                                    Replicate()),
                          src_data_rank=None)
    return bool(torch.equal(placed(g, p).to_local(), full))


# ------------------------------------------------------------------ decode
def decode(arch: str, mesh=None, batch: int = BATCH) -> dict:
    """Greedy decode of GEN tokens after a PROMPT-token prefill of
    ``batch`` sequences on one rank (the cache then laid out by
    ``cache_pspecs`` on ``mesh``): the tokens and each step's logits."""
    cfg = config(arch, "none")
    model = float_model(cfg)
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (batch, PROMPT), generator=gen)
    front = {k: v[:batch] for k, v in fronts(cfg, 0).items()
             if k != "tokens"}
    seq = PROMPT + GEN + (cfg.frontend_len if cfg.frontend == "vision"
                          else 0)
    logits, cache = model.prefill(tokens, max_seq=seq, **front)
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    if mesh is not None:
        annotate.set_rules(**annotate.rules_for(cfg, mesh, batch,
                                                is_train=False))
        sharding.distribute_model(model, mesh)
        cache = sharding.distribute_cache(cfg, cache, mesh, batch, seq)
    step = make_serve_step(model)
    toks, logs = [], []
    try:
        for _ in range(GEN):
            tok, lg, cache = step(cache, tok)
            toks.append(full(tok).astype(np.int64))
            logs.append(full(lg))
    finally:
        annotate.set_rules()
    return {"tokens": np.concatenate(toks, 1), "logits": np.stack(logs)}


#: Archs whose sharded prefill (its logits and cache) is held to one rank's.
PREFILL = ("qwen1.5-4b", "mamba2-780m", "zamba2-1.2b",
           "seamless-m4t-large-v2", "qwen3-moe-235b-a22b", "internvl2-2b")


def prefill(arch: str, mesh=None) -> dict:
    """A PROMPT-token prefill of BATCH sequences, on one rank or sharded on
    ``mesh`` (inputs laid out by ``batch_pspecs``): its last logits and
    every cache entry, gathered."""
    cfg = config(arch, "none")
    model = float_model(cfg)
    tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(5))
    batch = {**fronts(cfg, 0), "tokens": tokens}
    if mesh is not None:
        annotate.set_rules(**annotate.rules_for(cfg, mesh, BATCH,
                                                is_train=False))
        sharding.distribute_model(model, mesh)
        batch = sharding.distribute_batch(cfg, batch, mesh)
    try:
        logits, cache = model.prefill(
            batch["tokens"], prefix_embeds=batch.get("prefix_embeds"),
            enc_embeds=batch.get("enc_embeds"))
    finally:
        annotate.set_rules()
    return {"logits": full(logits), **{k: full(v) for k, v in cache.items()}}


def everything(rank: int, world: int) -> dict:
    """Every family on both (data, model) meshes, the 8-bit moments on
    both, each DECODE run and each PREFILL arch's sharded prefill, in one
    pair of processes (two threads each: the test suite runs beside
    them)."""
    torch.set_num_threads(2)
    out = {"train": {}, "decode": {}}
    for shape in MESHES:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        for arch in FAMILIES:
            out["train"][arch, shape] = train(arch, mesh)
    out["uneven"] = uneven_gather(make_mesh((1, 2), ("data", "model"),
                                            "cpu"))
    out["moments"] = moments(make_mesh((1, 2), ("data", "model"), "cpu"))
    out["moments_2x1"] = moments(make_mesh((2, 1), ("data", "model"), "cpu"))
    for arch, b, shape in DECODE:
        out["decode"][arch, b] = decode(
            arch, make_mesh(shape, ("data", "model"), "cpu"), b)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    out["prefill"] = {arch: prefill(arch, mesh) for arch in PREFILL}
    return out
