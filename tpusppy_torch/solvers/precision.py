"""Mixed-precision contraction helpers for the sweep engines.

Port of ``tpusppy/solvers/precision.py``.  A float32 matmul on the TPU's
MXU at jax precision "highest" runs as six bf16 passes, "high" as three
(bf16x3) and "default" as one (bf16 operands, f32 accumulation); the
reference's frozen sweep phase may run lowered (``ADMMSettings.
sweep_precision``) while every defect, residual and bound stays exact
(doc/precision.md).  This module maps a mode string onto a contraction.

The reference hands the mode to the MXU on the TPU and emulates it on every
other backend; the port keeps the emulation branch only: :func:`contract`
rounds each operand to bf16 ("default") or splits it into a two-term bf16
expansion whose three cross products are kept ("high"), then contracts
exactly in float32 and casts back to the operands' dtype.  The rounding
chain is the reference's: round to nearest even, always through float32
(a float64 value is first rounded to float32, then to bf16), the parts kept
in float32.  The sweep kernels' plain versions and operands
(:mod:`.cuda_kernels`) round with :func:`bf16_round` and split with
:func:`bf16_parts`, the same chain.

``precision.lowered_contractions.<mode>`` counts the lowered contractions a
sweep block is built with: each call of :func:`contract` below "highest",
so once per block at a CUDA graph's warm-up and capture (a replay runs no
Python), and at every block run eagerly on the CPU.
"""

from __future__ import annotations

import torch

from ..obs import metrics as _metrics

#: Recognized matmul precision modes, fastest first (the reference's).
MODES = ("default", "high", "highest")


def canon(mode: str | None) -> str:
    """Validate a mode string; ``None`` means "highest" (full precision)."""
    if mode is None:
        return "highest"
    if mode not in MODES:
        raise ValueError(
            f"matmul precision mode must be one of {MODES}; got {mode!r}")
    return mode


def is_low(mode: str | None) -> bool:
    """True when ``mode`` lowers precision below full f32."""
    return mode is not None and canon(mode) != "highest"


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 through float32 (nearest even), kept in
    ``x``'s dtype."""
    return x.float().to(torch.bfloat16).to(x.dtype)


def bf16_parts(x: torch.Tensor, mode: str):
    """The bf16 expansion of ``x`` at ``mode``, as bf16 tensors: ``(x1,
    None)`` for "default", ``(x1, x2)`` for "high" with x1 = bf16(f32(x))
    and x2 = bf16(f32(x) - f32(x1)), both through float32 (the reference's
    ``pallas_kernels._prep_mat``)."""
    xf = x.float()
    x1 = xf.to(torch.bfloat16)
    if canon(mode) == "default":
        return x1, None
    return x1, (xf - x1.float()).to(torch.bfloat16)


def contract(spec: str, a, b, mode: str | None = None):
    """``torch.einsum(spec, a, b)`` at the given mode.

    "highest" (or None) is the exact einsum in the operands' dtype.  Lower
    modes emulate the MXU's passes: both operands go to float32 and are
    rounded to bf16 ("default", one exact float32 product) or split into
    two bf16 terms ("high", the three products a1 b1 + a1 b2 + a2 b1, the
    low-low one dropped); the result is cast back to the operands' dtype
    (a float64 caller gets bf16-grade products, as it asked)."""
    mode = canon(mode)
    if mode == "highest":
        return torch.einsum(spec, a, b)
    _metrics.inc(f"precision.lowered_contractions.{mode}")
    dt = torch.result_type(a, b)
    a32, b32 = a.float(), b.float()
    a1, b1 = bf16_round(a32), bf16_round(b32)
    if mode == "default":
        out = torch.einsum(spec, a1, b1)
    else:
        a2, b2 = bf16_round(a32 - a1), bf16_round(b32 - b1)
        out = (torch.einsum(spec, a1, b1) + torch.einsum(spec, a1, b2)
               + torch.einsum(spec, a2, b1))
    return out.to(dt)
