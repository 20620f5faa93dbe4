"""The plain reference of the GraphSAGE training step with i-EXACT
activation compression (arXiv:2309.11856), in plain PyTorch.

It works out again, from the inputs alone, everything the program derives
from them: the aggregation over the edge list, the random projection, the
stochastic-rounding noise and the level table.  Nothing of the program is
imported.  The model is GraphSAGE with mean aggregation: layer ``l`` takes
``x = [h, A h]`` (``A`` the row-mean adjacency with self loops) to ``z = x W
+ b``, with ReLU between layers and a masked mean cross-entropy on the
logits.  The forward uses the exact ``x``; what the backward reads of
``x`` is its stash:

* the recipe ``None`` stashes ``x`` itself (float32);
* a compressed recipe projects ``x`` to ``D / rp_ratio`` columns with the
  normalized Rademacher matrix ``R`` (``rp_ratio`` 0: no projection), cuts
  the flattened result into blocks of ``group_size`` (the tail padded with
  its last element), and rounds each block's ``(v - min) / (max - min) * B``
  stochastically onto the level table; the backward reads ``deq(codes) R^T``.

ReLU's backward reads only the sign of its input; ``dW = x_stash^T g`` and
``dx = g W^T``; the features take no gradient.  AdamW follows (float32
moments, bias-corrected).

The seeds follow the system's published scheme: update ``t`` (0-based) has
the base seed ``(t + 1) * 7919``, layer ``l`` adds ``l * 1013``, the
projection takes that seed XOR ``0xA5A5A5A5``; element ``i`` of the block
array draws the uniform of counter ``i`` and a projection entry ``(d, p)``
the sign of counter ``d * r + p``.

``tf32=True`` rounds both operands of every dense product to TF32 (10
mantissa bits, to nearest) and accumulates in float32, which is what the
card's TF32 tensor cores compute: the benchmark's control.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import prng
from portbench.reference.levels import level_table

MASK32 = 0xFFFF_FFFF
SR_PRIME = 7919
LAYER_STRIDE = 1013
RP_SALT = 0xA5A5_A5A5
EPS = 1e-10
#: Edges a gather takes at once: bounds the (edges, F) transient.
EDGE_CHUNK = 1 << 20


@dataclasses.dataclass(frozen=True)
class Recipe:
    """One compressed stash: ``bits``, ``group_size``, ``rp_ratio`` (0 or 1:
    no projection) and ``vm`` (variance-minimized levels)."""

    bits: int
    group_size: int
    rp_ratio: int
    vm: bool


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _tf32(a) @ _tf32(b) if tf32 else a @ b


class _Edges:
    """``out[d] += w * h[s]`` over the edge list, a chunk of edges at once."""

    def __init__(self, src, dst, w, n: int, device):
        self.src = torch.as_tensor(src, device=device)
        self.dst = torch.as_tensor(dst, device=device)
        self.w = torch.as_tensor(w, device=device)
        self.n = n

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self._sum(h, self.src, self.dst)

    def transpose(self, g: torch.Tensor) -> torch.Tensor:
        return self._sum(g, self.dst, self.src)

    def _sum(self, h, frm, to) -> torch.Tensor:
        out = torch.zeros((self.n, h.shape[1]), dtype=h.dtype,
                          device=h.device)
        for e0 in range(0, frm.shape[0], EDGE_CHUNK):
            sl = slice(e0, e0 + EDGE_CHUNK)
            out.index_add_(0, to[sl], h[frm[sl]] * self.w[sl, None])
        return out


def sr_seed(update: int) -> int:
    return (((int(update) & MASK32) + 1) * SR_PRIME) & MASK32


def layer_seed(base: int, li: int) -> int:
    return (int(base) + li * LAYER_STRIDE) & MASK32


def rp_matrix(seed: int, d_in: int, d_out: int, device) -> torch.Tensor:
    counter = torch.arange(d_in * d_out, dtype=torch.int64, device=device)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d_out)))
    return prng.rademacher(seed, counter).reshape(d_in, d_out) * scale


def stash(x: torch.Tensor, recipe: Recipe, seed: int,
          tf32: bool) -> torch.Tensor:
    """What the backward reads of ``x`` under ``recipe``: the
    reconstruction from its codes (projected back if it was projected)."""
    n, d = x.shape
    project = recipe.rp_ratio > 1
    if project:
        r = rp_matrix(seed ^ RP_SALT, d, d // recipe.rp_ratio, x.device)
        x = _mm(x, r, tf32)
    g = recipe.group_size
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % g
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    blocks = flat.reshape(-1, g)
    b = float(2**recipe.bits - 1)
    levels = torch.tensor(level_table(recipe.bits, g, recipe.rp_ratio,
                                      recipe.vm),
                          dtype=torch.float32, device=x.device)
    lo = blocks.amin(dim=1, keepdim=True)
    span = blocks.amax(dim=1, keepdim=True) - lo
    h = ((blocks - lo) / span.clamp_min(EPS) * b).clamp(0.0, b)
    up = torch.searchsorted(levels, h.contiguous(), right=True)
    up = up.clamp(1, levels.shape[0] - 1)
    lv_lo, lv_hi = levels[up - 1], levels[up]
    p_up = (h - lv_lo) / (lv_hi - lv_lo).clamp_min(EPS)
    u = prng.uniform(seed, torch.arange(blocks.numel(), dtype=torch.int64,
                                        device=x.device).reshape(blocks.shape))
    code = torch.where(u < p_up, up, up - 1)
    deq = levels[code] * (span / b) + lo
    deq = deq.reshape(-1)[:x.numel()].reshape(x.shape)
    if project:
        deq = _mm(deq, r.T, tf32)
    return deq


def masked_nll(logits, labels, mask) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)


def grads(params, edges: _Edges, feats, labels, mask, recipe, update: int,
          tf32: bool):
    """Loss and the gradient of every leaf (``[w0, b0, w1, ...]``) of one
    full-graph step at update ``update``."""
    base = sr_seed(update)
    n_layers = len(params) // 2
    h = feats
    saved = []
    for li in range(n_layers):
        w, bias = params[2 * li], params[2 * li + 1]
        x = torch.cat([h, edges.forward(h)], dim=1)
        z = _mm(x, w, tf32) + bias
        kept = x if recipe is None else stash(x, recipe,
                                              layer_seed(base, li), tf32)
        mask_relu = None
        if li < n_layers - 1:
            mask_relu = z > 0
            z = torch.relu(z)
        saved.append((kept, mask_relu))
        h = z
    logits = h.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = masked_nll(logits, labels, mask)
        (g,) = torch.autograd.grad(loss, logits)
    out = [None] * len(params)
    for li in reversed(range(n_layers)):
        kept, mask_relu = saved[li]
        saved[li] = None
        if mask_relu is not None:
            g = g * mask_relu.to(g.dtype)
        out[2 * li] = _mm(kept.T, g, tf32)
        out[2 * li + 1] = g.sum(dim=0)
        if li == 0:
            break
        gx = _mm(g, params[2 * li].T, tf32)
        d = gx.shape[1] // 2
        g = gx[:, :d] + edges.transpose(gx[:, d:])
    return loss.detach(), out


def adamw(params, gs, m, v, step: int, opt: dict) -> None:
    """One AdamW step in place (float32 moments; the bias corrections and
    the learning rate rounded to float32)."""
    b1, b2 = float(opt["b1"]), float(opt["b2"])
    t = np.float32(step + 1)
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    lr = float(np.float32(opt["lr"]))
    for p, g, mi, vi in zip(params, gs, m, v):
        mi.mul_(b1).add_((1 - b1) * g)
        vi.mul_(b2).add_((1 - b2) * g * g)
        upd = (mi / bc1) / (torch.sqrt(vi / bc2) + float(opt["eps"]))
        if opt["weight_decay"]:
            upd = upd + float(opt["weight_decay"]) * p
        p.sub_(lr * upd)


@torch.no_grad()
def train(graph, params0, recipe: Recipe | None, opt: dict, n_steps: int,
          device, tf32: bool = False) -> dict:
    """``n_steps`` full-graph updates from ``params0`` (numpy ``[w0, b0,
    ...]``): each step's loss, each leaf's gradient at the first update
    (on the host) and its norm, and the norm of each leaf's change after
    the last (float64 norms)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        edges = _Edges(graph.edge_src, graph.edge_dst, graph.mean_weight,
                       graph.n_nodes, device)
        feats = torch.as_tensor(graph.features, device=device)
        labels = torch.as_tensor(graph.labels, device=device)
        mask = torch.as_tensor(graph.train_mask, device=device).to(
            torch.float32)
        params = [torch.tensor(np.asarray(p, np.float32), device=device)
                  for p in params0]
        start = [p.clone() for p in params]
        m = [torch.zeros_like(p) for p in params]
        v = [torch.zeros_like(p) for p in params]
        losses, first = [], None
        for step in range(n_steps):
            loss, gs = grads(params, edges, feats, labels, mask, recipe,
                             step, tf32)
            losses.append(float(loss))
            if first is None:
                first = [g.cpu() for g in gs]
            adamw(params, gs, m, v, step, opt)
        delta = [float(torch.linalg.vector_norm((p - s).double()))
                 for p, s in zip(params, start)]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return {"losses": losses, "grads": first,
            "grad_norms": [float(torch.linalg.vector_norm(g.double()))
                           for g in first],
            "delta_norms": delta}
