"""Training launcher (counterpart of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \\
        --steps 1000 --batch 8 --seq 2048 --ckpt-dir /path/to/ckpts

Runs ``runtime.train_loop.train`` with the reference's optimizer settings
(bf16 momentum, factored second moment) and prints the reference's last
line. ``--smoke`` takes the architecture's smoke config. Alone it trains
on the card (``--device cpu`` for the host). Under ``torchrun`` every rank
joins the default group (NCCL, one rank a card; gloo with ``--device
cpu``) and trains on the reference's mesh: the production ``(16, 16)``
mesh (``make_production_mesh``) where the world holds 256 ranks or more,
else the host mesh ``(n // tp, tp)`` with ``tp = min(2, n)``:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch \\
        qwen3_moe_235b --smoke --steps 3
"""
from __future__ import annotations

import argparse
import os
import sys

import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import init_group, init_mesh, make_production_mesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.train_loop import train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = rank = None
    if "RANK" in os.environ:  # under torchrun: the reference's host mesh
        rank, n, dev = init_group(device=args.device)
        mesh = (make_production_mesh(device=dev) if n >= 256
                else init_mesh(tp=min(2, n), device=dev))
    try:
        res = train(
            cfg, steps=args.steps,
            dcfg=DataConfig(seed=0, batch=args.batch, seq_len=args.seq),
            opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps,
                              m_dtype="bfloat16", v_mode="factored"),
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            device=args.device, mesh=mesh,
        )
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if not rank:
        print(f"done: final loss {res.losses[-1]:.4f} "
              f"(skipped {res.skipped_steps} poisoned steps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
