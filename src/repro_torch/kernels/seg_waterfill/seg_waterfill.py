"""ECMP waterfilling + Mathis cap + per-link load: wrapper and plain version.

The wrapper launches ``csrc/seg_waterfill.cu`` (see the note at the top of
that file for its design) on CUDA tensors and runs the plain version on
CPU tensors.  Two variants, chosen by size alone (:func:`variant`): one
launch with the whole state in one block's shared memory where it fits,
else the four-launch kernel with a global-memory workspace.  Each is built
for paths of P = 4 link ids (the spine-leaf fabric) and P = 6 (the fat
tree), P read from the ``links`` operand's width.  Contract
against the plain version run on the CPU: rates bit for bit, load within
rtol 2e-6 (the kernel adds each link's slots in ascending slot order, as
the plain version does on every device, ``network.segment_sum``, so in
practice load agrees bit for bit as well).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import network
from repro_torch.kernels import LAUNCHES, check_cuda_tensor, check_no_grad

SMEM_LIMIT = 232448      # dynamic shared memory one block may take (sm_90)
SMEM_MAX_FLOWS = 16383   # every flow id and tile count fits u16
HOPS = (4, 6)            # path widths P the kernel is built for
_MAX_TILES = 256   # global variant's CSR tiles (its workspace: tiles * E ints)
# CUDA launches per call of each variant (the global one adds 2 memsets)
CUDA_LAUNCHES_PER_CALL = {"smem": 1, "global": 4}


def smem_bytes(F: int, E: int, P: int = 4) -> int:
    """Dynamic shared memory of the one-launch variant at (F, E) and paths
    of P link ids: red[32] f32, ptr[E+1] i32, the CSR list [PF] u16, cnt
    [E] i32, cap_rem and share [E] f32, alloc [F] f32, newly [F] u8,
    touched [E] u8."""
    return (2 * P + 5) * F + 17 * E + 132


def variant(F: int, E: int, P: int = 4) -> str:
    """The kernel variant a CUDA call runs, by size alone: ``'smem'`` (one
    launch, the state in shared memory) when it fits one block's shared
    memory and F <= SMEM_MAX_FLOWS, else ``'global'`` (four launches over
    a global-memory workspace)."""
    fits = F <= SMEM_MAX_FLOWS and smem_bytes(F, E, P) <= SMEM_LIMIT
    return "smem" if fits else "global"


def seg_waterfill_ref(links: torch.Tensor, active: torch.Tensor,
                      link_bw_kbps: torch.Tensor, tcp_cap: torch.Tensor,
                      n_rounds: int = 8):
    """The plain version, ``network.waterfill_sparse``: (rates [F], load
    [E]) from [F, P] link ids, any P — the sparse max-min-fair allocation,
    the Mathis min and the load, unfused."""
    return network.waterfill_sparse(links, active, link_bw_kbps, tcp_cap,
                                    n_rounds=n_rounds)


def _lib(name: str):
    from repro_torch.kernels import _build
    fn = getattr(_build.load("seg_waterfill"), name)
    if name == "seg_waterfill_smem_launch":
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def seg_waterfill(links: torch.Tensor, active: torch.Tensor,
                  link_bw_kbps: torch.Tensor, tcp_cap: torch.Tensor,
                  n_rounds: int = 8):
    """Fused max-min-fair + Mathis allocation; returns (rates [F], load [E]).

    ``links`` [F, P] integer ECMP link ids (-1 pad, P in :data:`HOPS`; any
    P on the CPU), ``active`` [F] bool or
    integer, ``link_bw_kbps`` [E] f32, ``tcp_cap`` [F] f32 Mathis ceiling.
    CPU tensors run :func:`seg_waterfill_ref`; CUDA tensors launch the
    kernel variant :func:`variant` names on the current stream, and raise
    if grad mode is on and an input requires grad (no backward).
    """
    if links.device.type == "cpu":
        return seg_waterfill_ref(links, active, link_bw_kbps, tcp_cap,
                                 n_rounds=n_rounds)
    F, P = links.shape
    launch = (_launch_smem if variant(F, link_bw_kbps.shape[0], P) == "smem"
              else _launch_global)
    return launch(links, active, link_bw_kbps, tcp_cap, n_rounds)


def _operands(links, active, link_bw_kbps, tcp_cap):
    """The kernel's operands: ``links`` int32 (16-byte aligned: the kernel
    reads a flow's ids in 16- or 8-byte words) and ``active`` bool, cast
    only where their dtype differs, every input checked (none may require
    grad in grad mode); then the outputs ``rates`` [F] and ``load`` [E]."""
    F, E, P = links.shape[0], link_bw_kbps.shape[0], links.shape[-1]
    if links.dim() != 2 or P not in HOPS:
        raise ValueError(f"seg_waterfill: links must be [F, P] with P in "
                         f"{HOPS}, got {tuple(links.shape)}")
    check_no_grad("seg_waterfill", links=links, active=active,
                  link_bw_kbps=link_bw_kbps, tcp_cap=tcp_cap)
    if links.dtype != torch.int32:
        links = links.to(torch.int32)
    if active.dtype != torch.bool:
        active = active != 0
    links, active = links.contiguous(), active.contiguous()
    if links.data_ptr() % 16:
        links = links.clone()
    check_cuda_tensor("links", links, torch.int32, (F, P))
    check_cuda_tensor("active", active, torch.bool, (F,))
    check_cuda_tensor("link_bw_kbps", link_bw_kbps, torch.float32, (E,))
    check_cuda_tensor("tcp_cap", tcp_cap, torch.float32, (F,))
    rates = torch.empty((F,), dtype=torch.float32, device=links.device)
    load = torch.empty((E,), dtype=torch.float32, device=links.device)
    return (links, active, link_bw_kbps, tcp_cap, rates, load)


def _finish(which: str, err: int, rates, load):
    if err != 0:
        raise RuntimeError(f"seg_waterfill ({which}) launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["seg_waterfill"] += 1
    return rates, load


def _launch_smem(links, active, link_bw_kbps, tcp_cap, n_rounds=8):
    """The one-launch variant on CUDA tensors (the kernel returns
    cudaErrorInvalidValue where ``variant`` would not pick it)."""
    ops = _operands(links, active, link_bw_kbps, tcp_cap)
    (F, P), E = links.shape, link_bw_kbps.shape[0]
    stream = torch.cuda.current_stream(ops[0].device).cuda_stream
    err = _lib("seg_waterfill_smem_launch")(
        *(t.data_ptr() for t in ops), F, E, P, n_rounds,
        network.LOCAL_RATE_KBPS, network.INF, stream)
    return _finish("smem", err, *ops[4:])


def _launch_global(links, active, link_bw_kbps, tcp_cap, n_rounds=8):
    """The four-launch variant on CUDA tensors, its workspace in device
    memory; runs at any size."""
    ops = _operands(links, active, link_bw_kbps, tcp_cap)
    (F, P), E = links.shape, link_bw_kbps.shape[0]
    dev = ops[0].device
    n_slots = P * F
    n_tiles = max(1, min(_MAX_TILES, -(-n_slots // 256)))
    tile = -(-n_slots // n_tiles)
    ws_i = torch.empty((n_tiles * E + E + 1 + n_slots + 2 * F,),
                       dtype=torch.int32, device=dev)
    ws_f = torch.empty((2 * E + 2 * F,), dtype=torch.float32, device=dev)
    err = _lib("seg_waterfill_launch")(
        *(t.data_ptr() for t in ops), ws_i.data_ptr(), ws_f.data_ptr(), F,
        E, P, n_tiles, tile, n_rounds, network.LOCAL_RATE_KBPS, network.INF,
        torch.cuda.current_stream(dev).cuda_stream)
    return _finish("global", err, *ops[4:])
