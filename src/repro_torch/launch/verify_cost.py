"""Time the speculative verify step against the decode step of a
full-width model on the card (``hopper`` backend, random weights).

B requests are prefilled into one paged pool; then the step under test
runs 30 times on the same inputs (each run rewrites the same K/V
slots with the same values) and the script prints the p50 of its
wall-clock time, closed by ``torch.cuda.synchronize()``, for one verify
step of Q = 5 query tokens per request and for one decode step.

It imports the port by absolute name, so it times whichever ``repro_torch``
is first on the path; run it as a file to compare two trees on one card:

    PYTHONPATH=src python3 src/repro_torch/launch/verify_cost.py --arch qwen2-0.5b
    PYTHONPATH=<other tree>/src python3 src/repro_torch/launch/verify_cost.py ...

The last line is one JSON object with the numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

# per arch: requests and their prefix length (one prefill chunk each, within
# the sliding window where there is one)
SHAPES = {"qwen2-0.5b": (8, 1024), "starcoder2-7b": (4, 2048)}
REPEAT = 30


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("verify_cost: needs an NVIDIA card")
    import repro_torch
    from repro_torch.configs import ServeConfig, get_arch
    from repro_torch.models.attn_backend import (decode_meta, meta_to_device,
                                                 prefill_meta, verify_meta)
    from repro_torch.models.registry import build_model, init_params
    from repro_torch.serving import PagedKVPool

    cfg = get_arch(args.arch)
    B, T = SHAPES[args.arch]
    Q, ps = 5, 16
    params = init_params(cfg, 0, "cuda")
    model = build_model(cfg, "hopper")
    pool = PagedKVPool(cfg, ServeConfig(page_size=ps, max_slots=B,
                                        max_len=T + 2 * ps,
                                        prefill_chunk_tokens=T),
                       device="cuda")
    rng = np.random.RandomState(0)
    tables = np.zeros((B, pool.table_width), np.int32)
    with torch.no_grad():
        for b in range(B):
            pages = pool.alloc(pool.pages_for(T + Q))
            tables[b, :len(pages)] = pages
            toks = rng.randint(1, cfg.vocab, size=(1, T)).astype(np.int32)
            meta = meta_to_device(prefill_meta(
                cfg, ps, tables[b:b + 1], np.zeros(1, np.int32),
                np.zeros(1, np.int32), np.array([T], np.int32), T), "cuda")
            model.prefill_paged(params, pool.kv, {}, meta,
                                torch.as_tensor(toks, device="cuda"))
        pos = np.full(B, T, np.int32)
        vt = torch.as_tensor(rng.randint(1, cfg.vocab, size=(B, Q))
                             .astype(np.int32), device="cuda")
        vmeta = meta_to_device(verify_meta(cfg, ps, tables, pos,
                                           np.full(B, Q, np.int32), Q),
                               "cuda")
        dmeta = meta_to_device(decode_meta(cfg, ps, tables, pos), "cuda")

        def p50(fn):
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(REPEAT):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))

        verify_ms = p50(lambda: model.verify_paged(params, pool.kv, {}, vmeta,
                                                   vt))
        decode_ms = p50(lambda: model.decode_paged(params, pool.kv, {}, dmeta,
                                                   vt[:, 0]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"arch": cfg.name, "tree": repro_torch.__file__, "B": B,
           "prefix": T, "Q": Q, "verify_step_ms_p50": verify_ms,
           "decode_step_ms_p50": decode_ms, "repeat": REPEAT,
           "card": card}
    print(f"[verify_cost] {cfg.name} ({card}; {repro_torch.__file__}): "
          f"verify step (B={B}, Q={Q}, prefix {T}) p50 {verify_ms:.3f} ms, "
          f"decode step p50 {decode_ms:.3f} ms over {REPEAT} runs",
          flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
