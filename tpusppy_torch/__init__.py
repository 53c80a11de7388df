"""tpusppy_torch: the PyTorch/CUDA port of tpusppy for NVIDIA Hopper.

The JAX package ``tpusppy`` is the reference; this package mirrors its module
paths (``tpusppy_torch/solvers/admm.py`` answers to
``tpusppy/solvers/admm.py``) and is held against it on the same inputs.  It
imports ``torch``, numpy and scipy and nothing of ``jax`` or ``tpusppy``.

Device policy: every entry point runs on CUDA unless the caller asks for the
CPU (``options["device"] = "cpu"`` for SPBase/PH; ``device=`` or the device
of the input tensors for the solver functions).  Asking for the default
without a GPU raises; nothing falls back to the CPU quietly.
"""

import time as _time

import torch

__version__ = "0.1.0"

_T0 = _time.time()


def global_toc(msg, cond=True):
    """Timestamped progress message (analogue of mpisppy.global_toc)."""
    if cond:
        print(f"[{_time.time() - _T0:10.2f}] {msg}", flush=True)


def resolve_device(device=None, *tensors) -> torch.device:
    """The device an entry point runs on.

    ``device`` wins when given; else the device of the first torch tensor
    among ``tensors``; else CUDA.  Resolving to CUDA without a GPU raises
    instead of running on the CPU.
    """
    if device is None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                return t.device
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpusppy_torch runs on a CUDA device unless asked for the CPU, "
            "and no CUDA device is present: pass device='cpu' (or "
            "options['device']='cpu' for SPBase/PH) to run on the CPU")
    return device
