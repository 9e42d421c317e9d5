"""Train an LM with the full loop: the host mesh, AdamW (bf16 momentum,
factored second moment), the deterministic pipeline, asynchronous
checkpoints and automatic resume (counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch \\
        qwen3-moe-235b-a22b --steps 50 --smoke [--device cpu]

The reference's ``make_host_mesh(tp=2)`` is ``init_mesh(tp=2)`` over the
ranks present: run plainly, this process joins a world of one itself
(NCCL on the card, gloo on the CPU, over a ``file://`` store in a
temporary directory); under ``torchrun`` every rank joins the launcher's
world and rank 0 prints. The checkpoints go to ``--ckpt-dir`` (default
``repro_ckpt`` in the temporary directory); a run finds the newest one
there and resumes from it.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.examples import Record, add_device_arg
from repro_torch.launch.mesh import init_group, init_mesh
from repro_torch.optim.adamw import OptConfig
from repro_torch.runtime.train_loop import train


def main(argv=None) -> Record:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-friendly)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    out = Record()

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    store = None
    if "RANK" in os.environ:  # under torchrun: the launcher's world
        rank, _, dev = init_group(device=args.device)
    else:
        store = tempfile.mkdtemp(prefix="repro_torch_train_")
        rank, _, dev = init_group(0, 1, init_method=f"file://{store}/store",
                                  device=args.device)
    try:
        mesh = init_mesh(tp=2, device=dev)
        if rank == 0:
            out.say(f"training {cfg.name} on mesh {dict(mesh.shape)}")
        res = train(
            cfg, steps=args.steps,
            dcfg=DataConfig(seed=0, batch=args.batch, seq_len=args.seq),
            opt_cfg=OptConfig(lr=args.lr, warmup_steps=10,
                              total_steps=args.steps, m_dtype="bfloat16",
                              v_mode="factored"),
            ckpt_dir=args.ckpt_dir, ckpt_every=25, mesh=mesh,
        )
    finally:
        dist.destroy_process_group()
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)
    if rank == 0:
        if res.restored_from:
            out.say(f"(resumed from checkpointed step {res.restored_from})")
        k = max(len(res.losses) // 10, 1)
        for i in range(0, len(res.losses), k):
            out.say(f"step {i + (res.restored_from or 0):5d}  loss "
                    f"{res.losses[i]:.4f}")
        out.say(f"final loss {res.losses[-1]:.4f}  "
                f"skipped(NaN-guard)={res.skipped_steps}")
    out.fields.update(name=cfg.name, mesh=dict(mesh.shape),
                      losses=list(res.losses),
                      restored_from=res.restored_from,
                      skipped=res.skipped_steps)
    return out


if __name__ == "__main__":
    main()
