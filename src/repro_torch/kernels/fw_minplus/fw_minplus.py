"""Blocked min-plus Floyd-Warshall: wrapper and plain version.

The wrapper launches ``csrc/fw_minplus.cu`` (see the note at the top of
that file) on CUDA tensors and runs the plain version,
``network.floyd_warshall_ref``, on CPU tensors.  Contract against the
plain version: bit for bit on dyadic weights (every path sum is exact,
so the blocked association cannot round differently), rtol 1e-5
otherwise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import network
from repro_torch.kernels import LAUNCHES, check_cuda_tensor, check_no_grad

TILE = 64      # the kernel's tile edge: n is padded up to a multiple
PAD = 1e9      # off-diagonal padding, as the TPU kernel pads


def cuda_launches(n: int) -> int:
    """CUDA launches of one kernel call at n nodes: two per pivot block of
    ``TILE`` nodes, one where a single tile holds the graph."""
    nb = -(-n // TILE)
    return 2 * nb if nb > 1 else 1


def floyd_warshall_ref(A: torch.Tensor) -> torch.Tensor:
    """The plain version (one pivot at a time over the whole matrix)."""
    return network.floyd_warshall_ref(A)


def _lib():
    from repro_torch.kernels import _build
    fn = _build.load("fw_minplus").fw_minplus_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pad_adjacency(A: torch.Tensor) -> torch.Tensor:
    """``A`` [n, n] padded to a multiple of ``TILE`` with ``PAD`` off the
    diagonal and 0 on it, so padding never relays a path."""
    n = A.shape[0]
    n_pad = -(-n // TILE) * TILE
    D = torch.full((n_pad, n_pad), PAD, dtype=torch.float32, device=A.device)
    D[:n, :n] = A
    D.diagonal()[n:] = 0.0
    return D


def floyd_warshall(A: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths over adjacency ``A`` [n, n] f32 (``INF``
    where there is no edge).  CPU tensors run :func:`floyd_warshall_ref`;
    CUDA tensors launch the kernel on the current stream: two CUDA
    launches per pivot block of ``TILE`` nodes (one where n <= TILE); they
    raise if grad mode is on and ``A`` requires grad (no backward)."""
    if A.device.type == "cpu":
        return floyd_warshall_ref(A)
    n = A.shape[0]
    check_cuda_tensor("A", A, torch.float32, (n, n))
    check_no_grad("fw_minplus", A=A)
    D = pad_adjacency(A)
    err = _lib()(D.data_ptr(), D.shape[0],
                 torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fw_minplus launch failed: CUDA error {err}")
    LAUNCHES["fw_minplus"] += 1
    return D[:n, :n].contiguous()
