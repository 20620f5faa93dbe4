"""Serving launcher: continuous-batching engine over the block-quantized
paged KV cache (the reference's ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --prompt-len 1000 --gen-len 32 --kv-bits 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \\
      --smoke --device cpu

Runs on the card (``--device cuda``, the default) unless the CPU is asked
for.  Weights are random, drawn from a seeded generator on the device.
The attention-cache families serve through
:class:`repro_torch.serving.ServeEngine`: slot-based continuous batching
with page-level admission control, KV written block-quantized
(``--kv-bits {2,4,8}``; 16 = raw bf16).
``--mode fixed`` recovers the sequential fixed-batch loop as a scheduler
configuration.

``--kv-policy host|pinned-paged`` keeps the page pool in pageable or
page-locked host memory and serves it one layer ahead through a device
stage (:class:`repro_torch.serving.kvcache.HostKVPool`); the tokens are
the ``device`` policy's bit for bit.

``--obs`` turns on the engine's serving telemetry
(:class:`repro_torch.obs.ObsPolicy`) and prints its counters after the
summary.

The MoE family (``--arch qwen3-moe-235b-a22b``, ``--arch arctic-480b``)
serves through the same engine: the experts replace the dense MLP in
prefill and decode.

The SSM / hybrid state caches and the enc-dec's encoder cache are not
paged-KV shaped (``--arch mamba2-780m``, ``zamba2-1.2b``,
``seamless-m4t-large-v2``): they decode through the legacy fixed-batch
loop (:func:`_legacy_loop`), greedily, ``--max-batch`` requests a batch,
tokens gathered in a device buffer and copied to the host once a batch.
The KV flags do not apply there.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get, reduce_for_smoke
from repro_torch.core.device import resolve_device
from repro_torch.data import batch_for_step
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import Model
from repro_torch.obs import ObsPolicy, stopwatch
from repro_torch.serving import (KV_FAMILIES, KVCacheConfig, Request,
                                 ServeEngine)


#: The serving counters ``--obs`` prints (the reference's).
OBS_KEYS = ("serve/admitted", "serve/completed", "serve/rejected",
            "serve/decode_steps", "serve/pages_in_use")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots (continuous) / batch size (fixed)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--kv-bits", type=int, default=8, choices=[2, 4, 8, 16],
                    help="KV cache width: 2/4/8 block-quantized, 16 raw bf16")
    ap.add_argument("--kv-policy", default="device",
                    choices=["device", "host", "pinned-paged"],
                    help="page-pool placement: on the card, or in pageable "
                         "or page-locked host memory")
    ap.add_argument("--kv-group", type=int, default=64,
                    help="quantization block size along the KV token row")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="physical pages in the pool (default: sized so "
                         "max_batch full-horizon requests fit)")
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "fixed"],
                    help="fixed = legacy sequential batch loop, as a "
                         "scheduler configuration")
    ap.add_argument("--obs", action="store_true",
                    help="enable scheduler/engine metrics "
                         "(queue depth, occupancy, TTFT/TPOT, page residency)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the KV pool live (cuda, or "
                         "cpu for the plain versions)")
    return ap


def build_model(args) -> Model:
    """The model ``args`` name, with random weights from seed 0 drawn on
    ``args.device``."""
    device = resolve_device(args.device)
    cfg = get(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, act_mode="none")
    return Model(cfg, device=device)


def _legacy_loop(model: Model, args) -> list:
    """Fixed-batch greedy decode for the families outside ``KV_FAMILIES``:
    batches of ``--max-batch`` requests, each prefilled (``serve/prefill``
    span) and decoded ``--gen-len - 1`` steps (``serve/decode`` span),
    the tokens written into a device buffer and copied to the host once a
    batch (no read-back a token).  An enc-dec batch's ``enc_embeds`` are
    (n, prompt_len, d_model) bf16, drawn on the host from a generator
    seeded with the batch's first request index (so the card and the CPU
    serve the same inputs).  Returns one (gen_len,) array a request."""
    cfg, device = model.cfg, model.device
    serve = make_serve_step(model)
    max_seq = args.prompt_len + args.gen_len
    done, t_prefill, t_decode, n_decoded = 0, 0.0, 0.0, 0
    outputs = []
    while done < args.requests:
        n = min(args.max_batch, args.requests - done)
        prompts = torch.as_tensor(batch_for_step(
            cfg.vocab, n, args.prompt_len, step=done, seed=11), device=device)
        kwargs = {}
        if cfg.family == "encdec":
            gen = torch.Generator().manual_seed(done)
            kwargs["enc_embeds"] = torch.randn(
                (n, args.prompt_len, cfg.d_model), generator=gen
            ).to(device=device, dtype=torch.bfloat16)
        with stopwatch("serve/prefill", batch=n) as sw:
            logits, cache = model.prefill(prompts, max_seq=max_seq, **kwargs)
            _sync(device)
        t_prefill += sw.elapsed_s
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        buf = torch.zeros((n, args.gen_len), dtype=torch.int32,
                          device=device)
        buf[:, 0] = tok[:, 0]
        with stopwatch("serve/decode", batch=n, gen_len=args.gen_len) as sw:
            for i in range(1, args.gen_len):
                tok, _, cache = serve(cache, tok)
                buf[:, i] = tok[:, 0]
            _sync(device)
        t_decode += sw.elapsed_s
        n_decoded += (args.gen_len - 1) * n
        outputs.append(buf.cpu().numpy())          # one copy a batch
        done += n
    print(f"served {done} requests (legacy {cfg.family} loop, {device}): "
          f"prefill {t_prefill:.2f}s total, decode "
          f"{n_decoded / max(t_decode, 1e-9):.1f} tok/s")
    return [row for batch in outputs for row in batch]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_engine(args, model: Model | None = None, *,
                 collect_logits: bool = False):
    """The engine and request list that ``main`` runs for parsed ``args``
    (``chip_smoke.py`` drives this same path); ``model`` defaults to
    :func:`build_model`'s."""
    model = model or build_model(args)
    cfg = model.cfg
    pages_per_req = -(-(args.prompt_len + args.gen_len - 1)
                      // args.page_tokens)
    n_pages = args.kv_pages or args.max_batch * pages_per_req
    kv = KVCacheConfig(bits=args.kv_bits, group_size=args.kv_group,
                       policy=args.kv_policy, page_tokens=args.page_tokens,
                       n_pages=n_pages)
    engine = ServeEngine(model, kv=kv, max_batch=args.max_batch,
                         max_prompt=args.prompt_len, gen_cap=args.gen_len,
                         mode=args.mode, collect_logits=collect_logits,
                         obs=ObsPolicy(enabled=True) if args.obs else None)
    requests = [
        Request(rid=i,
                prompt=batch_for_step(cfg.vocab, 1, args.prompt_len,
                                      step=i, seed=11)[0],
                max_new=args.gen_len)
        for i in range(args.requests)]
    return engine, requests


def report(args, engine, out) -> None:
    print(f"served {args.requests - out['rejected']}/{args.requests} "
          f"requests [{args.mode}, kv-bits={args.kv_bits}, "
          f"{engine.mechanism}, {engine.device}]: "
          f"{out['tokens_per_sec']:.1f} tok/s, "
          f"p50 {out['p50_latency_ms']:.0f} ms / "
          f"p99 {out['p99_latency_ms']:.0f} ms, "
          f"ttft {out['ttft_mean_ms']:.0f} ms, "
          f"tpot {out['tpot_mean_ms']:.1f} ms")
    print(f"kv pool: {out['kv_pool_bytes']} B "
          f"({out['kv_f32_pool_bytes']} B as f32, "
          f"{out['kv_f32_pool_bytes'] / max(out['kv_pool_bytes'], 1):.1f}x)")
    if args.obs:
        snap = engine.session.summary().get("metrics", {})
        for key in OBS_KEYS:
            if key in snap:
                print(f"  {key}: {snap[key]}")


def main(argv=None):
    args = parser().parse_args(argv)
    model = build_model(args)
    if model.cfg.family not in KV_FAMILIES:
        return _legacy_loop(model, args)
    engine, requests = build_engine(args, model)
    out = engine.run(requests)
    report(args, engine, out)
    return [r.tokens for r in out["results"] if r.status == "done"]


if __name__ == "__main__":
    main()
