"""End-to-end driver of the PyTorch port: train a width-reduced LM for a few
hundred steps with the fault-tolerant trainer (checkpoint/restart, failure
injection, resume), the counterpart of examples/train_lm.py.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

gemma2-2b is the only architecture the port has (the default). The config
is cut as examples/train_lm.py cuts it: a quarter of the layers (at least
2), d_model 512, 8 heads of 64, d_ff 1024, a vocabulary of at most 16,384,
no remat, and the direct attention path. Runs on the card unless
`--device cpu` asks for the plain path.
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.train import init_train_state, make_train_step
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a fresh temporary directory (resume needs a matching config)")
    ap.add_argument("--inject-failure", action="store_true",
                    help="kill the step at 1/3 and 2/3 of the run to show recovery")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix=f"repro_torch_train_lm_{args.arch}_")

    cfg = get_config(args.arch)
    kv = max(d for d in (1, 2, 4, 8) if d <= max(cfg.n_kv_heads, 1))
    cfg = dataclasses.replace(
        cfg, n_layers=max(2, cfg.n_layers // 4), d_model=512,
        n_heads=8, n_kv_heads=kv, head_dim=64,
        d_ff=1024 if cfg.d_ff else 0, vocab_size=min(cfg.vocab_size, 16_384),
        remat=False, chunked_attn_min_len=1 << 30,
    )
    opt = AdamWConfig(lr=1e-3)
    state = init_train_state(cfg, 0, opt, device=args.device)
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M device={args.device}")

    step_fn = make_train_step(cfg, opt, total_steps=args.steps, device=args.device)
    data = TokenStream(cfg, batch=args.batch, seq=args.seq)
    fails = (args.steps // 3, 2 * args.steps // 3) if args.inject_failure else ()
    trainer = Trainer(
        step_fn, state, data,
        TrainerConfig(
            ckpt_dir=args.ckpt_dir,
            ckpt_every=max(1, min(10, args.steps // 10)),
            fail_at_steps=fails,
        ),
    )
    out = trainer.run(args.steps, log_every=25)
    print(f"final step {out['final_step']}, recoveries {out['recoveries']}, "
          f"loss {out['loss_history'][0]:.3f} -> {out['loss_history'][-1]:.3f}")


if __name__ == "__main__":
    main()
