"""End-to-end LM training on PyTorch: the counterpart of
``examples/train_lm.py``.  Trains a qwen2-family model with the MapReduce
engine on synthetic token data, with checkpointing + resume, through
``repro_torch.launch.train`` (on the card every full-causal attention of
the forward runs through kernel K9).

Default runs a reduced geometry; ``--full-100m`` selects the ~100M
configuration (24 layers x 512 d_model) and a few hundred steps.
Checkpoints go under ``build/`` at the root of the checkout unless
``--ckpt-dir`` says otherwise.

  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
  PYTHONPATH=src python examples/train_lm_torch.py --full-100m --steps 300
"""
import argparse
import os

from repro_torch.launch.train import main as train_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--engine", default="mapreduce")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(ROOT, "build", "train_lm_ckpt"))
    args = ap.parse_args()

    common = ["--engine", args.engine, "--device", args.device,
              "--ckpt-dir", args.ckpt_dir]
    if args.full_100m:
        # ~100M params: 24L x 512d, qwen2 family
        argv = ["--arch", "qwen2-0.5b", "--layers", "24", "--d-model", "512",
                "--steps", str(args.steps or 300), "--global-batch", "8",
                "--seq-len", "512", "--ckpt-every", "50"] + common
    else:
        argv = ["--arch", "qwen2-0.5b", "--reduced",
                "--steps", str(args.steps or 60), "--global-batch", "8",
                "--seq-len", "128", "--lr", "1e-3",
                "--ckpt-every", "25"] + common
    out = train_main(argv)
    print(f"train_lm done: loss {out['history'][0]:.3f} -> "
          f"{out['final_loss']:.3f} over {out['steps']} steps")


if __name__ == "__main__":
    main()
