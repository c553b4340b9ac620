"""ECMP waterfilling + Mathis cap + per-link load: wrapper and plain version.

The wrapper launches ``csrc/seg_waterfill.cu`` (see the note at the top of
that file for its design) on CUDA tensors and runs the plain version on
CPU tensors.  Contract against the plain version: rates bit for bit, load
within rtol 2e-6 (both add each link's slots in ascending slot order, so
in practice load agrees bit for bit as well).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import network
from repro_torch.kernels import LAUNCHES, check_cuda_tensor

_MAX_TILES = 256   # CSR histogram tiles: the workspace holds tiles * E ints


def seg_waterfill_ref(links: torch.Tensor, active: torch.Tensor,
                      link_bw_kbps: torch.Tensor, tcp_cap: torch.Tensor,
                      n_rounds: int = 8):
    """(rates [F], load [E]) from [F, 4] link ids — the unfused op chain
    ``network.flow_rates(sparse=True)`` runs without the kernel: the
    sparse max-min-fair allocation, the Mathis min and the load."""
    E = link_bw_kbps.shape[0]
    active = active.to(torch.bool)
    fair = network.max_min_fair_rates_sparse(links, active, link_bw_kbps,
                                             n_rounds=n_rounds)
    rates = torch.minimum(fair, tcp_cap) * active
    valid = links >= 0
    seg = torch.where(valid, links, E).reshape(-1).long()
    w = (rates[:, None] * valid.to(torch.float32)).reshape(-1)
    return rates, network.segment_sum_slots(w, seg, E)


def _lib():
    from repro_torch.kernels import _build
    lib = _build.load("seg_waterfill")
    fn = lib.seg_waterfill_launch
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def seg_waterfill(links: torch.Tensor, active: torch.Tensor,
                  link_bw_kbps: torch.Tensor, tcp_cap: torch.Tensor,
                  n_rounds: int = 8):
    """Fused max-min-fair + Mathis allocation; returns (rates [F], load [E]).

    ``links`` [F, 4] integer ECMP link ids (-1 pad), ``active`` [F] bool or
    integer, ``link_bw_kbps`` [E] f32, ``tcp_cap`` [F] f32 Mathis ceiling.
    CPU tensors run :func:`seg_waterfill_ref`; CUDA tensors launch the
    kernel on the current stream.
    """
    if links.device.type == "cpu":
        return seg_waterfill_ref(links, active, link_bw_kbps, tcp_cap,
                                 n_rounds=n_rounds)
    F = links.shape[0]
    E = link_bw_kbps.shape[0]
    links_i = links.to(torch.int32).contiguous()
    active_i = active.to(torch.int32).contiguous()
    check_cuda_tensor("links", links_i, torch.int32, (F, 4))
    check_cuda_tensor("active", active_i, torch.int32, (F,))
    check_cuda_tensor("link_bw_kbps", link_bw_kbps, torch.float32, (E,))
    check_cuda_tensor("tcp_cap", tcp_cap, torch.float32, (F,))
    dev = links.device
    n_slots = 4 * F
    n_tiles = max(1, min(_MAX_TILES, -(-n_slots // 256)))
    tile = -(-n_slots // n_tiles)
    rates = torch.empty((F,), dtype=torch.float32, device=dev)
    load = torch.empty((E,), dtype=torch.float32, device=dev)
    ws_i = torch.empty((n_tiles * E + E + 1 + n_slots + 2 * F,),
                       dtype=torch.int32, device=dev)
    ws_f = torch.empty((2 * E + 2 * F,), dtype=torch.float32, device=dev)
    err = _lib()(links_i.data_ptr(), active_i.data_ptr(),
                 link_bw_kbps.data_ptr(), tcp_cap.data_ptr(),
                 rates.data_ptr(), load.data_ptr(), ws_i.data_ptr(),
                 ws_f.data_ptr(), F, E, n_tiles, tile, n_rounds,
                 network.LOCAL_RATE_KBPS, network.INF,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seg_waterfill launch failed: CUDA error {err}")
    LAUNCHES["seg_waterfill"] += 1
    return rates, load
