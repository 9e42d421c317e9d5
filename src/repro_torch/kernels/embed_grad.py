"""The gradient of an embedding lookup in a fixed order (CUDA kernel).

``embed_grad(grad, ids, num_rows)`` is the ``(num_rows, D)`` gradient of
``table[ids]``: each row of ``grad`` added into its id's row, the adds of
one row in position order, from +0, rounded to the table's type as a
sequential ``index_add_`` rounds them; rows no id names are +0. The
reference's lookup (``jnp.take``) leaves its gradient to XLA, whose bits
are the same on every run; PyTorch's ``index_select`` backward on the card
adds with atomics, in an order that changes from run to run. Here the
order is fixed: the ids are sorted with a stable sort into runs
(``ref.embed_runs``), and ``csrc/embed_grad.cu`` sums each run in order
into its row, one thread a column, with no atomics.

The block form (``row0``): a table of ``num_rows`` rows that is the block
[row0, row0 + num_rows) of a larger one (the rank's block of a
vocabulary-parallel embedding); ids outside it are skipped. The wrapper
shifts the ids by ``row0`` before the sort, so the ids before the block
sort ahead of every run and those after it behind: the kernel reads only
the runs and needs no change for it. ``embed_grad.block_launches`` counts
the block form's launches (within ``launches``).

A tensor on the CPU runs the plain twin ``ref.embed_grad_ref`` (the same
adds in the same order); a CUDA tensor launches the kernel or raises. A
fake tensor (``FakeTensorMode``: the dry run's, which has no data to sort)
takes ``index_add_``'s shapes and nothing else: no kernel, no launch
counted.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels import _build, ref
from repro_torch.kernels.config import runs_twin
from repro_torch.kernels.ell_relax_keys import on_stream

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "embed_grad_launch": ([_P, _P, _P, _P, _LL, _I, _I, _P], _I),
}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's table types


def embed_grad(grad: torch.Tensor, ids: torch.Tensor, num_rows: int,
               row0: int | None = None) -> torch.Tensor:
    """Returns the (num_rows, D) gradient of ``table[ids]`` for ``grad``
    of shape ``ids.shape + (D,)`` (or (N, D) for N ids), in ``grad``'s
    dtype (f32 or bf16 on the card). ``ids`` are integers in [0,
    num_rows), as the lookup took them; with ``row0`` the table is rows
    [row0, row0 + num_rows) of a larger one, the ids index that one, and
    those outside the block add nowhere."""
    num_rows = int(num_rows)
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"want int32 or int64 ids; got {ids.dtype}")
    if grad.dim() < 1 or grad.numel() != ids.numel() * grad.shape[-1]:
        raise ValueError(f"want grad {tuple(ids.shape)} + (D,); got "
                         f"{tuple(grad.shape)}")
    if num_rows < 0:
        raise ValueError(f"num_rows must be >= 0; got {num_rows}")
    if grad.device != ids.device:
        raise ValueError(f"grad on {grad.device}, ids on {ids.device}")
    d = grad.shape[-1]
    if is_fake(grad):
        flat = ids.reshape(-1).to(torch.int64)
        return grad.new_zeros((num_rows, d)).index_add_(
            0, flat.clamp(0, max(num_rows - 1, 0)), grad.reshape(-1, d))
    if runs_twin(grad):
        return ref.embed_grad_ref(grad, ids, num_rows, row0)
    if grad.dtype not in DTYPES:
        raise TypeError(f"the kernel sums f32 or bf16 tables; got "
                        f"{grad.dtype}")
    grad = grad.reshape(-1, d).contiguous()
    perm, starts = ref.embed_runs(ids if row0 is None else ids - row0,
                                  num_rows)
    out = torch.empty((num_rows, d), dtype=grad.dtype, device=grad.device)
    if num_rows == 0 or d == 0:
        return out
    lib = _build.load("embed_grad", _SIGNATURES)
    rc = on_stream(grad.device, lambda stream: lib.embed_grad_launch(
        grad.data_ptr(), perm.data_ptr(), starts.data_ptr(), out.data_ptr(),
        num_rows, d, DTYPES[grad.dtype], stream))
    if rc != 0:
        raise RuntimeError(f"embed_grad launch failed: CUDA error {rc}")
    embed_grad.launches += 1
    if row0 is not None:
        embed_grad.block_launches += 1
    return out


embed_grad.launches = 0  # kernel launches since the last reset
embed_grad.block_launches = 0  # of which the block form's


class EmbedLookup(torch.autograd.Function):
    """``table[ids]`` (``index_select`` over the flat ids), whose gradient
    is :func:`embed_grad`'s fixed-order sum. With ``row0`` the table is
    the block [row0, row0 + rows) of a larger one (a rank's block of a
    vocabulary-parallel embedding): an id outside it gives a row of zeros
    and adds to no gradient row."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor,
                row0: int | None = None):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.row0 = table.shape[0], row0
        flat = ids.reshape(-1)
        if row0 is None:
            out = torch.index_select(table, 0, flat)
        else:
            local = flat - row0
            inside = (local >= 0) & (local < table.shape[0])
            out = torch.index_select(table, 0, torch.where(inside, local, 0))
            out = torch.where(inside[:, None], out, 0)
        return out.reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return embed_grad(g, ids, ctx.rows, ctx.row0), None, None


def register_kernels(reg):
    """Register this module's kernel contract (``kernels/registry.py``)."""
    from repro_torch.kernels import registry as R

    def cases():
        import numpy as np

        out = []
        # (label, ids shape, rows, D, seed): repeats, rows no id names, a
        # row of 1, D off a multiple of the block's threads
        for label, shape, rows, d, seed in (
                ("b2_s5", (2, 5), 7, 3, 40), ("repeats", (16,), 3, 9, 41),
                ("one_row", (4,), 1, 300, 42), ("absent_rows", (6,), 40, 5, 43)):
            rng = np.random.default_rng(seed)
            ids = rng.integers(0, rows, size=shape).astype(np.int32)
            g = rng.standard_normal(shape + (d,)).astype(np.float32)
            g[..., 0] = np.float32(-0.0)  # -0 rows: the sum starts from +0
            out.append(R.SpecCase(label, (R._t(g), R._t(ids), rows)))
        # the block form: rows [30, 60) of a 90-row table, ids all over it
        rng = np.random.default_rng(44)
        ids = rng.integers(0, 90, size=(3, 40)).astype(np.int32)
        g = rng.standard_normal((3, 40, 12)).astype(np.float32)
        out.append(R.SpecCase("block", (R._t(g), R._t(ids), 30, 30)))
        return tuple(out)

    reg.register(R.KernelContract(
        name="embed_grad", module=__name__, wrapper=embed_grad,
        make_cases=cases, kernels=((R.SRC_EMBED, "embed_grad_kernel"),),
        notes="one thread a column walks its row's run of gathered grad "
              "rows in position order: no atomics"))
