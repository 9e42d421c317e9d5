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
``restore`` places the leaves on ``device`` where the reference takes
shardings.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import numpy as np

from repro_torch.interop import flatten_tree, unflatten_into
from repro_torch.kernels.config import resolve_device


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ---------------- write path ----------------
    def save(self, step: int, tree: Any) -> str:
        return self._write(step, flatten_tree(tree))

    def save_async(self, step: int, tree: Any) -> None:
        flat = flatten_tree(tree)  # the host snapshot, before the next step
        self.wait()
        self._thread = threading.Thread(target=self._write_logged,
                                        args=(step, flat))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint write failed") \
                from err

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

    def restore(self, step: int, template: Any, device=None) -> Any:
        """Load ``step`` into the structure of ``template`` (a tree of dicts,
        tensors and models; its leaves may be on the meta device), every
        leaf on ``device`` (None = the CUDA card)."""
        dev = resolve_device(device)
        path = os.path.join(self.dir, f"ckpt_{step:08d}.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        return unflatten_into(template, flat, dev)
