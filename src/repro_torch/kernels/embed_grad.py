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


def embed_grad(grad: torch.Tensor, ids: torch.Tensor,
               num_rows: int) -> torch.Tensor:
    """Returns the (num_rows, D) gradient of ``table[ids]`` for ``grad``
    of shape ``ids.shape + (D,)`` (or (N, D) for N ids), in ``grad``'s
    dtype (f32 or bf16 on the card). ``ids`` are integers in [0,
    num_rows), as the lookup took them."""
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
            0, flat, grad.reshape(-1, d))
    if runs_twin(grad):
        return ref.embed_grad_ref(grad, ids, num_rows)
    if grad.dtype not in DTYPES:
        raise TypeError(f"the kernel sums f32 or bf16 tables; got "
                        f"{grad.dtype}")
    grad = grad.reshape(-1, d).contiguous()
    perm, starts = ref.embed_runs(ids, num_rows)
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
    return out


embed_grad.launches = 0  # kernel launches since the last reset


class EmbedLookup(torch.autograd.Function):
    """``table[ids]`` (``index_select`` over the flat ids), whose gradient
    is :func:`embed_grad`'s fixed-order sum."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return torch.index_select(table, 0, ids.reshape(-1)).reshape(
            *ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return embed_grad(g, ids, ctx.rows), None


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
        return tuple(out)

    reg.register(R.KernelContract(
        name="embed_grad", module=__name__, wrapper=embed_grad,
        make_cases=cases, kernels=((R.SRC_EMBED, "embed_grad_kernel"),),
        notes="one thread a column walks its row's run of gathered grad "
              "rows in position order: no atomics"))
