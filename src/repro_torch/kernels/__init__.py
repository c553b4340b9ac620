"""Kernel layer of the PyTorch port: CUDA C++ kernels written by hand for
Hopper (``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at first use by
``_build.py`` and loaded with ``ctypes``), one package per kernel holding
its wrapper and its plain PyTorch version.

A wrapper runs the plain version only for tensors on the CPU, where there
is no kernel to launch; on CUDA tensors it launches the kernel or raises.
Each wrapper adds one to its entry of ``LAUNCHES`` where it launches.  On
``meta`` tensors an LM kernel's wrapper checks what its kernel would check
and hands the call to :func:`meta_stand_in`, which raises outside a cost
counter (``launch.roofline.CostCounter``).
"""
from __future__ import annotations

import torch

KERNEL_FLAGS = ("auto", "on", "off")

# a tick's kernel package -> (its wrapper, its plain version) by name
ROUTES = {"seg_waterfill": ("seg_waterfill", "seg_waterfill_ref"),
          "fw_minplus": ("floyd_warshall", "floyd_warshall_ref")}

# wrapper name -> launches since the last reset_launch_counts()
LAUNCHES: dict[str, int] = {"seg_waterfill": 0, "fw_minplus": 0,
                             "flash_attention": 0, "ssd_scan": 0,
                             "place_round": 0}


# the cost counter tracing a shape-only program, while one is open
_COUNTER = None


def meta_stand_in(name: str, plain, *args):
    """Kernel ``name`` on ``meta`` inputs, inside a cost counter only: the
    counter records the kernel's work (``launch.roofline.kernel_work``)
    and ``plain(*args)`` gives the outputs' shapes, left out of the
    count.  Raises outside a counter: a meta tensor has no kernel to
    launch."""
    if _COUNTER is None:
        raise RuntimeError(
            f"{name}: a meta tensor has no kernel to launch; only a cost "
            f"counter (launch.roofline.CostCounter) traces one's shapes")
    return _COUNTER.kernel(name, plain, *args)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def resolve_kernel(flag: str, device) -> bool:
    """Resolve an 'auto' | 'on' | 'off' selector to use-the-kernel.

    * ``'auto'`` — the kernel on a CUDA device, the plain version on the
      CPU;
    * ``'on'``  — the kernel; raises on the CPU, which has no kernel and
      no interpreter;
    * ``'off'`` — the plain version (an explicit choice only).
    """
    if flag not in KERNEL_FLAGS:
        raise ValueError(
            f"kernel flag must be one of {KERNEL_FLAGS}, got {flag!r}")
    on_cuda = torch.device(device).type == "cuda"
    if flag == "on" and not on_cuda:
        raise RuntimeError(
            "kernel selector 'on' needs a CUDA device: the CUDA kernels "
            "have no CPU interpreter (use 'auto' or 'off' on the CPU)")
    if flag == "off":
        return False
    return on_cuda


def kernel_route(kernel, flag: str, device):
    """The callable a tick calls for ``kernel`` (the kernel's package, one
    of ``ROUTES``) under the selector ``flag`` on ``device``: its wrapper
    where :func:`resolve_kernel` picks the kernel, else its plain version.
    Raises as :func:`resolve_kernel` does."""
    wrapper, plain = ROUTES[kernel.__name__.rsplit(".", 1)[-1]]
    return getattr(kernel, wrapper if resolve_kernel(flag, device) else plain)


def check_tensor(name: str, t: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and
    ``shape``."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_cuda_tensor(name: str, t: torch.Tensor, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` — what a kernel's C interface takes."""
    check_tensor(name, t, dtype, shape)
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


def check_no_grad(kernel: str, **inputs: torch.Tensor) -> None:
    """Raise if grad mode is on and an input of ``kernel`` requires grad.
    The simulator's kernels have no backward and write their outputs
    where autograd cannot see them, so a gradient through one would be
    dropped without a word."""
    if not torch.is_grad_enabled():
        return
    for name, t in inputs.items():
        if t.requires_grad:
            raise RuntimeError(
                f"{kernel}: input {name!r} requires grad, but the kernel "
                f"has no backward; its gradient would be dropped (detach "
                f"it, or run under torch.no_grad)")
