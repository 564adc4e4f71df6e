"""Serving launcher of the port, LM mode: batched prefill, then greedy (or
sampled) decode, as `repro/launch/serve.py` runs it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --batch 4 --prompt-len 2048 --max-new 32

runs on the card; add `--reduced --device cpu` for the CPU-sized
miniature on the plain path. Parameters are drawn from seed 0 and the
prompts from seed 1 (torch.Generator; not the JAX launcher's numbers).
Prefill and decode take the direct attention path, so the flash kernel
does not run here. The BPMF modes are not ported yet (ROADMAP.md, queue 1
item 9).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.models import DecoderModel, build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: DecoderModel, params, prompts: torch.Tensor, max_new: int, *,
             temperature: float = 0.0, generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, float, float]:
    """Prefill `prompts` (B, P), then max_new - 1 decode steps.

    Returns (the max_new new tokens (B, max_new), prefill seconds, decode
    seconds); greedy at temperature 0, else sampled from softmax(logits / T).
    """
    dev = model.device
    _sync(dev)
    t0 = time.perf_counter()
    out = model.prefill_fn(params, {"tokens": prompts}, headroom=max_new + 8)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    def pick(logits):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=generator).to(torch.int32)
        return logits.argmax(-1, keepdim=True).to(torch.int32)

    cache = out["cache"]
    tok = pick(out["logits"])
    toks = [tok]
    t0 = time.perf_counter()
    for _ in range(max_new - 1):
        cache, logits = model.decode_fn(params, cache, {"tokens": tok})
        tok = pick(logits)
        toks.append(tok)
    _sync(dev)
    return torch.cat(toks, dim=1), t_prefill, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain path")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, device=args.device)
    params = model.init(seed=0)
    gen = torch.Generator(device=model.device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=model.device, dtype=torch.int32)
    gen_toks, t_prefill, t_decode = generate(model, params, prompts, args.max_new,
                                             temperature=args.temperature, generator=gen)
    n_tok = args.batch * (args.max_new - 1)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"device={model.device}")
    print(f"prefill: {t_prefill * 1e3:.0f} ms   decode: {n_tok / max(t_decode, 1e-9):,.0f} tok/s")
    print("sample:", gen_toks[0][:16].tolist(), "...")


if __name__ == "__main__":
    main()
