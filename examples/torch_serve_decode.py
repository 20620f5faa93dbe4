"""Serving example (PyTorch/CUDA port): prefill a batch of prompts, then
greedy-decode with the KV/state cache; runs any of the 10 assigned
architectures (reduced config).

  PYTHONPATH=src python examples/torch_serve_decode.py --arch zamba2-1.2b [--device cpu]

Weights, prompts and the enc-dec's encoder inputs come from seeded
``torch.Generator``s (the reference's from ``jax.random``).
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCHS, reduce_for_smoke
from repro_torch.core.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Prefill and decode; returns the timings, the generated tokens and
    whether every logit stayed finite."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = dataclasses.replace(reduce_for_smoke(ARCHS[args.arch]),
                              act_mode="none")
    model = Model(cfg, device=device,
                  generator=torch.Generator(device).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(device).manual_seed(1),
                            device=device, dtype=torch.int32)

    max_seq = args.prompt_len + args.gen_len
    kwargs = {}
    if cfg.family == "encdec":
        kwargs["enc_embeds"] = torch.randn(
            (args.batch, args.prompt_len, cfg.d_model),
            generator=torch.Generator(device).manual_seed(2), device=device,
            dtype=torch.bfloat16)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, max_seq=max_seq, **kwargs)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    print(f"prefill {args.batch}x{args.prompt_len}: {prefill_s:.2f}s "
          f"(cache pos={int(cache['pos'][0])})")

    serve = make_serve_step(model)
    finite = bool(torch.isfinite(logits).all())
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(args.gen_len - 1):
        tok, step_logits, cache = serve(cache, tok)
        finite &= bool(torch.isfinite(step_logits).all())
        generated.append(tok)
    _sync(device)
    decode_s = time.perf_counter() - t0
    out = torch.cat(generated, dim=1)
    steps = args.gen_len - 1
    tok_s = steps * args.batch / decode_s if decode_s > 0 else float("inf")
    print(f"decoded {steps} steps in {decode_s:.2f}s ({tok_s:.1f} tok/s)")
    print("sample token ids:", out[0, :16].tolist())
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "tokens_per_s": tok_s, "tokens": out.cpu(),
            "logits_finite": finite}


if __name__ == "__main__":
    main()
