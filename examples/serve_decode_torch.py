"""Batched prefill and greedy decode with a KV cache on the PyTorch port
(`examples/serve_decode.py` on `repro_torch`).

    PYTHONPATH=src python examples/serve_decode_torch.py --arch gemma2-2b                # the card
    PYTHONPATH=src python examples/serve_decode_torch.py --arch gemma2-2b --device cpu   # the plain path

Runs a width-reduced model with random weights from a seed: prefills a
batch of prompts, then decodes new tokens step by step through
`launch/serve.py::generate`, and checks the last step's logits against a
fresh prefill of the whole sequence (the cache invariant).
"""
import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch.serve import generate
from repro_torch.models import build_model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    model = build_model(cfg, device=args.device)
    params = model.init(seed=0)
    dev = model.device
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g, dtype=torch.int32).to(dev)
    inputs = {}
    if cfg.family == "audio":
        inputs["frames"] = (0.1 * torch.randn(args.batch, cfg.encoder_seq, cfg.d_model,
                                              generator=g)).to(dev)
    if cfg.family == "vlm":
        inputs["patch_embeds"] = (0.1 * torch.randn(args.batch, cfg.n_patches, cfg.d_model,
                                                    generator=g)).to(dev)
        s_total = cfg.n_patches + args.prompt_len
        inputs["positions"] = torch.arange(s_total, dtype=torch.int32, device=dev).expand(
            args.batch, 3, s_total).contiguous()

    with torch.no_grad():
        new, t_prefill, t_decode = generate(model, params, prompts, args.tokens,
                                            inputs=inputs)
        # the cache invariant: a fresh prefill of prompt + the first new
        # tokens picks the token the decode loop picked next
        n = min(args.tokens, 8) - 1
        seq = torch.cat([prompts, new[:, :n]], dim=1)
        full = dict(inputs)
        if cfg.family == "vlm":
            s_total = cfg.n_patches + seq.shape[1]
            full["positions"] = torch.arange(s_total, dtype=torch.int32, device=dev).expand(
                args.batch, 3, s_total).contiguous()
        kw = {"headroom": 8} if model.cache_grows else {}
        ref = model.prefill_fn(params, {"tokens": seq, **full}, **kw)["logits"]
    print(f"arch={cfg.name}: prefilled {args.prompt_len} in {t_prefill * 1e3:.1f} ms, "
          f"decoded {new.shape[1]} tokens in {t_decode * 1e3:.1f} ms")
    print("sample row:", new[0, :16].tolist(), "...")
    assert bool(torch.isfinite(ref).all())
    agree = (ref.argmax(-1).to(torch.int32) == new[:, n]).float().mean().item()
    print(f"cache invariant: {agree:.0%} of rows pick the same token from a fresh prefill")
    return new, agree


if __name__ == "__main__":
    main()
