"""LM serving launcher: continuous-batching decode for ``--arch <id>``.

Port of ``repro/launch/serve.py``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --smoke --device cpu --requests 8 --max-new 16

The reference's flags, plus ``--device`` (the CUDA card by default;
``cpu`` runs the same plain PyTorch code on the host).  Parameters are
drawn from seed 0 on the serving device; nothing is downloaded.  Prints one line: requests, tokens, seconds, tokens/s, the
KV cache dtype and the device.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import Request, ServeEngine

    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.config
    if args.int8_kv:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_len=args.max_len, temperature=args.temperature,
                      device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=[int(t) for t in
                            rng.integers(1, cfg.vocab_size, 4)],
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    steps = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tok = sum(len(r.out) for r in reqs)
    print(f"{len(reqs)} requests, {tok} tokens, {dt:.2f}s "
          f"({tok / dt:.1f} tok/s, kv={cfg.kv_cache_dtype}, "
          f"device={device.type}, steps={steps})")
    return dict(requests=len(reqs), tokens=tok, seconds=dt, steps=steps,
                done=all(r.done for r in reqs),
                outputs=[list(r.out) for r in reqs])


if __name__ == "__main__":
    main()
