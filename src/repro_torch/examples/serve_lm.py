"""Serve a model with batched requests: prefill a batch of prompts, then
greedy-decode continuations through the KV / SSM cache (counterpart of
``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch \\
        mamba2-1.3b --smoke --prompt-len 64 --gen 32 [--device cpu]

The weights and the prompt come from one ``torch.Generator`` seeded 0, so
the ids differ from the reference's (JAX's threefry draws others); the
decode loop is :func:`generate`, which a caller can feed any weights.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.examples import Record, add_device_arg, sync
from repro_torch.kernels.config import resolve_device
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.obs.timer import now


def generate(cfg, params, batch: dict, gen: int) -> tuple:
    """Prefill ``batch`` and decode greedily: returns the (B, gen) int32
    ids (the prompt's next token first), the (B, gen, vocab) logits each
    was taken from, and the prefill's and the decode loop's seconds, each
    closed by a device sync."""
    dev = batch["tokens"].device
    with torch.no_grad():
        t0 = now()
        logits, cache, pos = prefill(cfg, params, batch)
        sync(dev)
        t_prefill = now() - t0

        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        outs, seen = [tok], [logits]
        t0 = now()
        for _ in range(gen - 1):
            logits, cache, pos = decode_step(cfg, params, tok, cache, pos)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            outs.append(tok)
            seen.append(logits)
        sync(dev)
        t_decode = now() - t0
    return (torch.cat(outs, dim=1), torch.stack(seen, dim=1), t_prefill,
            t_decode)


def main(argv=None) -> Record:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = Record()

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    rng = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator=rng, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=rng, device=dev)}
    if cfg.n_vision_tokens:
        batch["vision"] = 0.02 * torch.randn(
            (args.batch, cfg.n_vision_tokens, cfg.d_model), generator=rng,
            device=dev)

    ids, _, t_prefill, t_decode = generate(cfg, params, batch, args.gen)
    tok_s = args.batch * args.gen / max(t_decode, 1e-9)
    out.say(f"{cfg.name}: prefill {args.batch}x{args.prompt_len} in "
            f"{t_prefill*1e3:.0f} ms; decoded {args.gen} tokens/request in "
            f"{t_decode*1e3:.0f} ms ({tok_s:.0f} tok/s)")
    out.say(f"first request's continuation ids: {ids[0].tolist()}")
    out.fields.update(name=cfg.name, prefill_s=t_prefill,
                      decode_s=t_decode, tokens_per_s=tok_s,
                      ids=ids.tolist())
    return out


if __name__ == "__main__":
    main()
