"""Training launcher: ``--arch <id> [--smoke]``, the port of
``repro/launch/train.py``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --steps 100 --ckpt /path/to/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --steps 20 --device cpu

The reference's flags, plus ``--device`` (the CUDA card by default;
``cpu`` runs the same plain PyTorch code on the host).  It trains on the
reference's synthetic stream (token t+1 = (5 t + 7) mod V, from random
first tokens of ``numpy.random.default_rng(0)``; zero patch and frame
stubs for the vlm and audio families), with the reference's checkpoints
and auto-resume under ``--ckpt``.  ``--mesh 4x2`` sets the
``MeshContext`` that the expert-parallel MoE dispatch reads
(``("data", "model")``; three dims add ``"pod"`` in front).  The last
line is ``done: final loss <x>``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 4x2 -> (data, model) axes of sizes 4, 2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs.base import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig, train

    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.smoke else entry.config

    mesh = None
    if args.mesh:
        dims = tuple(int(d) for d in args.mesh.split("x"))
        names = ("data", "model")[:len(dims)] if len(dims) <= 2 else \
            ("pod", "data", "model")
        mesh = make_mesh(dims, names)

    def data_iter():
        rng = np.random.default_rng(0)
        V = cfg.vocab_size
        while True:
            t0 = rng.integers(0, V, (args.batch, 1))
            seq = [t0]
            for _ in range(args.seq):
                seq.append((seq[-1] * 5 + 7) % V)
            arr = np.concatenate(seq, axis=1)
            batch = {"tokens": torch.from_numpy(arr[:, :args.seq]),
                     "labels": torch.from_numpy(arr[:, 1:args.seq + 1])}
            if cfg.frontend in ("patch", "audio"):
                key = "patch_embeds" if cfg.frontend == "patch" else "frames"
                batch[key] = torch.zeros(
                    (args.batch, cfg.frontend_len, cfg.d_model),
                    dtype=torch.bfloat16)
            yield batch

    tc = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
        microbatches=args.microbatches,
        ckpt_dir=args.ckpt, ckpt_every=max(args.steps // 4, 1))
    res = train(cfg, tc, data_iter(), num_steps=args.steps, mesh=mesh,
                device=device)
    print(f"done: final loss {res['losses'][-1]:.4f}")
    return res


if __name__ == "__main__":
    main()
