"""The paper's figures on PyTorch, one function per figure, CSV rows
(name,key=value,...): the counterpart of ``benchmarks/run.py``.

  fig6  — unsupervised reconstruction error vs iteration   (paper Fig. 6)
  fig7  — supervised misclassification vs iteration        (paper Fig. 7)
  fig8  — MapReduce scaling: time vs #workers              (paper Fig. 8)
  roofline — the dry-run sweep's roofline table on H100 constants
             (``launch/roofline.py``; a plan, nothing runs on a device)

``--quick`` (the default) shrinks sizes as ``benchmarks/run.py`` does;
``--full`` runs each script's own defaults.  Runs on ``cuda`` (every RBM
probability through kernel K8) unless given ``--device cpu``; Fig. 8 runs
one NCCL process on the card and the worker sweep (1, 2, 4, 8 gloo
processes) on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.figures --only fig6 --device cpu

``--only roofline`` reads the JSONs ``launch/sweep.py`` wrote under
``--dryrun-dir`` and touches no device.
"""
from __future__ import annotations

import argparse
import time

from .. import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    choices=[None, "fig6", "fig7", "fig8", "roofline"])
    ap.add_argument("--quick", action="store_true", default=True)
    ap.add_argument("--full", dest="quick", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--dryrun-dir", default=None,
                    help="the sweep's JSONs (default experiments/dryrun_torch)")
    args = ap.parse_args(argv)
    t0 = time.time()
    if args.only == "roofline":
        from . import roofline
        out = args.dryrun_dir or roofline.OUT
        roofline.run(out)
        print()
        print(roofline.markdown(out))
        print(f"benchmarks,total_s={time.time() - t0:.1f}")
        return
    device = str(resolve_device(args.device))

    if args.only in (None, "fig6"):
        from . import fig6_unsup_error
        if args.quick:
            fig6_unsup_error.run(n_train=1024, n_test=256, epochs=4,
                                 stack=(784, 128, 32), device=device)
        else:
            fig6_unsup_error.run(device=device)
    if args.only in (None, "fig7"):
        from . import fig7_sup_error
        if args.quick:
            fig7_sup_error.run(n_train=1024, n_test=256, epochs=10,
                               stack=(784, 128), device=device)
        else:
            fig7_sup_error.run(device=device)
    if args.only in (None, "fig8"):
        from . import fig8_scaling
        fig8_scaling.run(device=device)
    if args.only is None:
        from . import roofline
        roofline.run(args.dryrun_dir or roofline.OUT)
    print(f"benchmarks,total_s={time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
