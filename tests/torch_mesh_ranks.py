"""What each rank runs in the two-rank tests of ``tests/test_torch_mesh.py``
(``repro_torch.parallel.run_ranks`` starts the ranks by ``spawn``, which
imports this module by name).  It imports nothing of JAX, so a rank starts
in a few seconds; every function returns numpy arrays and python values."""
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.compressor import CompressionConfig
from repro_torch.graph import data
from repro_torch.graph.models import GNN, GNNConfig, params_from_numpy
from repro_torch.graph.train import train_gnn_batched, train_gnn_mesh
from repro_torch.parallel.halo import graph_mesh, halo_exchange, send_csr

GRAPH_ARGS = ("t", 700, 3500, 32, 5)
GRAPH_KW = dict(homophily=0.5, feature_noise=1.5, seed=1)
INT2 = CompressionConfig(bits=2, group_size=64, rp_ratio=8)


def graph():
    return data.synthetic_graph(*GRAPH_ARGS, **GRAPH_KW)


def config(arch: str = "sage", compressed: bool = True,
           hidden=(32,)) -> GNNConfig:
    return GNNConfig(arch=arch, hidden=hidden, n_classes=5,
                     compression=INT2 if compressed else None)


def model(cfg: GNNConfig) -> GNN:
    return GNN(cfg, GRAPH_ARGS[3], generator=torch.Generator().manual_seed(0))


def exchange_case(m: int, n: int, H: int, f: int, seed: int = 0):
    """Every rank's block, send map, real-slot counts and output cotangent,
    alike on every rank.  As in a halo program, the map from rank 0 to the
    last rank has two pad slots, which gather row 0 and send back no
    gradient."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(m, n, f)).astype(np.float32)
    send = rng.integers(0, n, (m, m, H))
    count = np.full((m, m), H, np.int32)
    count[0, m - 1] = H - 2
    send[0, m - 1, H - 2:] = 0
    g = rng.normal(size=(m, n + m * H, f)).astype(np.float32)
    return h, send, count, g


def exchange(rank: int, world: int, n: int, H: int, f: int,
             device: str = "cpu") -> dict:
    """The exchange of :func:`exchange_case` on ``device`` twice (outputs
    and gradients), and whether the default group refuses 3 partitions."""
    h, send, count, g = exchange_case(world, n, H, f)
    back = send_csr(send[rank], count[rank], n, device)
    try:
        graph_mesh(3)
        refused = False
    except ValueError as e:
        refused = "multiple of the graph-mesh size" in str(e)
    outs, grads = [], []
    for _ in range(2):
        x = torch.tensor(h[rank], device=device, requires_grad=True)
        y = halo_exchange(x, torch.from_numpy(send[rank]).to(device), back,
                          dist.group.WORLD)
        y.backward(torch.from_numpy(g[rank]).to(device))
        outs.append(y.detach().cpu().numpy())
        grads.append(x.grad.cpu().numpy())
    return {"out": outs, "grad": grads, "refused": refused}


def train(rank: int, world: int, entry: str, arch: str, compressed: bool,
          kw: dict, device: str = "cpu", params: list | None = None) -> dict:
    """``train_gnn_mesh`` or ``train_gnn_batched`` over the default group
    on ``device``, from ``params`` (the reference's, a list of ``{"w",
    "b"}`` arrays) or else :func:`model`'s weights."""
    g, cfg = graph(), config(arch, compressed)
    fn = train_gnn_mesh if entry == "mesh" else train_gnn_batched
    start = (model(cfg) if params is None
             else params_from_numpy(params, cfg, device="cpu"))
    res = fn(g, cfg, params=start, device=device, mesh=dist.group.WORLD,
             **kw)
    keep = ("mesh_devices", "updates_per_epoch", "halo_width",
            "dropped_edges", "halo_bytes_per_epoch", "halo_bytes_sent",
            "batch_nodes", "pager", "stash_bytes", "val_acc", "test_acc",
            "n_parts")
    return {"losses": [h[1] for h in res["history"]],
            "params": [p.detach().cpu().numpy()
                       for p in res["model"].parameters()],
            **{k: res[k] for k in keep if k in res}}


def fail_on_rank_1(rank: int, world: int) -> int:
    """Rank 1 raises; rank 0 returns its rank."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def hang_on_rank_1(rank: int, world: int, seconds: float) -> int:
    """Rank 1 sleeps for ``seconds``; rank 0 returns its rank."""
    if rank == 1:
        time.sleep(seconds)
    return rank
