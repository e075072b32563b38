"""Serving example on PyTorch: the counterpart of ``examples/serve_lm.py``.
Every family the port builds is served by the continuous-batching engine
(``--engine auto``): attention LMs over the paged KV pool, the state-slot
families (mamba2-780m, recurrentgemma-2b) over one checkpointable state
slot a request.  Reduced geometry, random weights; on the card unless
``--device cpu``.

  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
      --arch qwen2-0.5b --mixed
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
      --arch mamba2-780m --verify
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
      --arch recurrentgemma-2b --gen 32
  # shared-prefix traffic served through the radix prefix cache
  PYTHONPATH=src python examples/serve_lm_torch.py --device cpu \
      --arch qwen2-0.5b --requests 8 --shared-prefix 2 --prefix-cache
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mixed", action="store_true")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="number of shared prompt-prefix families")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prefix KV pages via the radix cache")
    ap.add_argument("--verify", action="store_true",
                    help="check the tokens against the static "
                         "single-request baseline")
    args = ap.parse_args()
    serve_main(["--arch", args.arch, "--reduced", "--device", args.device,
                "--requests", str(args.requests),
                "--batch", str(args.batch),
                "--prompt-len", str(args.prompt_len),
                "--gen", str(args.gen)]
               + (["--mixed"] if args.mixed else [])
               + (["--shared-prefix", str(args.shared_prefix)]
                  if args.shared_prefix else [])
               + (["--prefix-cache"] if args.prefix_cache else [])
               + (["--verify"] if args.verify else []))


if __name__ == "__main__":
    main()
