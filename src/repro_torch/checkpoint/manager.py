"""Fault-tolerant checkpointing: atomic, asynchronous, retention-managed
(counterpart of ``repro.checkpoint.manager``), in the reference's on-disk
format, so a checkpoint written by either package restores in the other.

Format: one ``.npz`` per step holding the flattened tree (``'/'``-joined
dict keys -> arrays) plus a JSON manifest (step, leaf count, wall time). A
model (``models.transformer.LM``) in the tree is written as the
reference's parameter tree, each ``units`` leaf stacked over the units
(``params/units/l0/attn/wq`` is (U, D, H*dh)); the optimizer state's leaf
paths are the reference's already (``opt/m/...``, ``opt/v/.../vr``,
``opt/step``). bf16 leaves are 2-byte void records, as numpy writes the
reference's ``ml_dtypes.bfloat16``, and are read back through their
16-bit pattern. Writes go to ``<dir>/tmp.<step>.<nonce>`` and are
``os.replace``d into place, the manifest last: a crash mid-write never
corrupts the newest complete checkpoint (restore scans the manifests).

``save_async`` snapshots to host memory synchronously (copies: on the CPU a
tensor's numpy view would alias the parameter that the next step updates
in place) and writes on a background thread, overlapping the write with
the next steps; ``wait`` joins it and raises what the write raised.
``restore`` places the leaves on ``device``.

On a mesh (a placed model in the tree, and ``shardings``: the
``partition.to_shardings`` tree of the other leaves' specs, which torch
tensors do not carry as the reference's arrays do) every rank of the mesh
calls ``save`` / ``save_async`` / ``wait`` / ``restore``: each leaf is
gathered whole, rank 0 writes the reference's format, and ``wait`` ends
with a barrier, so every rank then reads the same directory; ``restore``
takes the whole leaves and places each rank's block per ``shardings``,
onto any mesh (an elastic restart).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import numpy as np
import torch.distributed as dist

from repro_torch.interop import flatten_tree, unflatten_into
from repro_torch.kernels.config import resolve_device


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._mesh = None  # the mesh of the last sharded save

    def _snapshot(self, tree: Any, shardings: Any):
        """(host arrays of the tree, whether this rank writes them)."""
        mesh = _mesh_of(tree, shardings)
        self._mesh = mesh or self._mesh
        return flatten_tree(tree, shardings=shardings), (
            mesh is None or mesh.rank == 0)

    # ---------------- write path ----------------
    def save(self, step: int, tree: Any, shardings: Any = None) -> str:
        flat, writes = self._snapshot(tree, shardings)
        path = self._write(step, flat) if writes else None
        self._barrier()
        return path

    def save_async(self, step: int, tree: Any, shardings: Any = None) -> None:
        # the host snapshot, before the next step
        flat, writes = self._snapshot(tree, shardings)
        self.wait()
        if writes:
            self._thread = threading.Thread(target=self._write_logged,
                                            args=(step, flat))
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint write failed") \
                from err

    def _barrier(self) -> None:
        if self._mesh is not None and self._mesh.size(("data", "model")) > 1:
            dist.barrier(group=self._mesh.world)

    def _write_logged(self, step: int, flat: dict) -> None:
        try:
            self._write(step, flat)
        except Exception as err:  # handed to wait(), which raises it
            self._error = err

    def _write(self, step: int, flat: dict[str, np.ndarray]) -> str:
        nonce = f"{os.getpid()}.{threading.get_ident()}"
        tmp_npz = os.path.join(self.dir, f"tmp.{step}.{nonce}.npz")
        tmp_man = os.path.join(self.dir, f"tmp.{step}.{nonce}.json")
        final_npz = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        final_man = os.path.join(self.dir, f"ckpt_{step:08d}.json")
        np.savez(tmp_npz, **flat)
        # the reference's manifest field: a wall-clock stamp, not a timing
        manifest = {"step": step, "n_leaves": len(flat),
                    "time": time.time()}  # repro_torch: allow(raw-timer)
        with open(tmp_man, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp_npz, final_npz)
        os.replace(tmp_man, final_man)  # manifest last => marks completeness
        self._retain()
        return final_npz

    def _retain(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            for ext in ("npz", "json"):
                try:
                    os.remove(os.path.join(self.dir, f"ckpt_{s:08d}.{ext}"))
                except FileNotFoundError:
                    pass

    # ---------------- read path ----------------
    def all_steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".json"):
                try:
                    with open(os.path.join(self.dir, f)) as fh:
                        out.append(int(json.load(fh)["step"]))
                except (ValueError, KeyError, json.JSONDecodeError):
                    continue  # incomplete/corrupt manifest => not restorable
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any, device=None,
                shardings: Any = None) -> Any:
        """Load ``step`` into the structure of ``template`` (a tree of dicts,
        tensors and models, whole shapes; its leaves may be on the meta
        device), every leaf on ``device`` (None = the CUDA card), or where
        ``shardings`` names a leaf's sharding (a model's: a dict of them by
        leaf path), this rank's block of it on the sharding's mesh."""
        mesh = _mesh_of(None, shardings)
        dev = mesh.device if mesh is not None else resolve_device(device)
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return unflatten_into(template, flat, dev, shardings=shardings)


def _mesh_of(tree: Any, shardings: Any):
    """The mesh of a placed model in ``tree`` or of a sharding in
    ``shardings`` (None: nothing is sharded)."""
    for node in (tree, shardings):
        stack = [node]
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            elif getattr(x, "mesh", None) is not None:
                return x.mesh
    return None
