"""Beyond-paper (PyTorch/CUDA port): activation-compressed training of a
transformer LM.

Trains a reduced qwen3-32b-family config twice, plain remat vs ACT (INT2
block-quantized residual stash), and compares losses + stash bytes.

  PYTHONPATH=src python examples/torch_train_lm_compressed.py [--steps 40] [--device cpu]

Weights come from a seeded ``torch.Generator`` (the reference's from
``jax.random``); the token stream is the same function of the step.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.core.compressor import CompressionConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.pack import packed_nbytes
from repro_torch.data.synthetic import batch_for_step
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamWConfig, adamw_init

B, S = 4, 128


def main(argv=None) -> dict:
    """Train both modes; returns each mode's losses and residual stash
    bytes a layer."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out = {}
    for mode in ("remat", "act"):
        cfg = dataclasses.replace(
            reduce_for_smoke(ARCHS[args.arch]), act_mode=mode,
            act_compression=CompressionConfig(bits=2, group_size=64))
        model = Model(cfg, device=device,
                      generator=torch.Generator(device).manual_seed(0))
        # 8-bit Adam too
        opt = AdamWConfig(lr=3e-3, warmup_steps=5, state_bits=8)
        step = make_train_step(model, opt)
        state = adamw_init(list(model.parameters()), opt)
        losses = []
        for s in range(args.steps):
            toks = torch.from_numpy(batch_for_step(cfg.vocab, B, S, s)).to(
                device)
            m = step(state, {"tokens": toks})
            losses.append(float(m["loss"]))
        full = B * S * cfg.d_model * 2
        stash = full if mode == "remat" else packed_nbytes(
            (B, S, cfg.d_model), 2, 64)
        print(f"{mode:6s} loss {losses[0]:.4f} -> {losses[-1]:.4f} | "
              f"residual stash/layer: {stash} B "
              f"({100 * (1 - stash / full):.1f}% less than bf16)")
        out[mode] = {"losses": losses, "stash_bytes": stash}
    print("\nboth modes train; ACT stores the per-layer residual stream at "
          "INT2 instead of recomputing from bf16 (remat); compose them for "
          "the full memory ladder.")
    return out


if __name__ == "__main__":
    main()
