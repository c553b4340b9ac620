"""The admit round's candidate loop: wrapper and plain version.

The batched placement round (``engine._place_batched``) ranks the
schedulable containers, takes the K best as candidates and admits them in
order, each against the hosts' live ``used`` and slot counts and the
placement carry that the admits before it changed.  That loop is this
module.  The wrapper launches ``csrc/place_round.cu`` (see the note at the
top of that file) on CUDA tensors, the whole loop in one launch, and runs
the plain version, :func:`place_round_ref`, on CPU tensors.  Contract
against the plain version on the card: ``chosen``, ``used``, ``ncont``
and the pointer bit for bit, at every fleet size up to the kernel's
shared memory (about 8000 hosts).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import scheduling
from repro_torch.core.scheduling import PlaceCarry, feasible_hosts
from repro_torch.core.types import (F_COMM, F_HOST_UTIL, NUM_POLICY_WEIGHTS,
                                    W_ROW0, W_RR_TRACK)
from repro_torch.kernels import LAUNCHES, check_no_grad, check_tensor

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
SMEM_LIMIT = 232448   # dynamic shared memory one block may take (sm_90)


class Round(NamedTuple):
    chosen: torch.Tensor        # i64[K] host admitted, -1 none or past n_valid
    used: torch.Tensor          # f32[H, 3] after the round
    ncont: torch.Tensor         # i32[H]
    carry: PlaceCarry           # only ``rr`` outlives the round
    soft: tuple | None          # (soft_comm, soft_util, soft_n) or None


def place_round_ref(sim, cfg, params, policy, cand: torch.Tensor,
                    valid: torch.Tensor, req_k: torch.Tensor,
                    pcarry: PlaceCarry, n_valid: int,
                    soft: bool = False) -> Round:
    """The plain version: the K-step loop in eager PyTorch over the first
    ``n_valid`` candidates (valid ones come first in key order, and an
    invalid one admits nothing).  With ``soft`` it also sums the
    surrogate of ``engine._place_batched``: the expected comm and
    host-util columns under ``scheduling.soft_assign`` of the row the
    argmin takes, and the count of candidates with a feasible host; the
    JAX package's scan adds an exact 0.0 to each for the candidates past
    ``n_valid`` (an all-infeasible row has an all-zero softmax)."""
    H = sim.hosts.cap.shape[0]
    K = cand.shape[0]
    dev = sim.t.device
    used, ncont = sim.hosts.used, sim.hosts.n_containers
    arange_h = torch.arange(H, device=dev)
    chosen = [torch.full((), -1, dtype=I64, device=dev)] * K
    if soft:
        s_comm = s_util = s_n = torch.zeros((), dtype=F32, device=dev)
    for k in range(n_valid):
        feas = feasible_hosts(sim.hosts.cap, used, ncont, req_k[k],
                              cfg) & valid[k]
        row, cols = scheduling.host_row_cols(sim, cfg, params, policy,
                                             pcarry, k, cand, used)
        h = scheduling.first_true(row, feas)
        if soft:
            q = scheduling.soft_assign(row, feas, params.tau)
            s_comm = s_comm + (q * cols[F_COMM]).sum()
            s_util = s_util + (q * cols[F_HOST_UTIL]).sum()
            s_n = s_n + feas.any().to(F32)
        ok = h >= 0
        hh = torch.clamp(h, 0, H - 1)
        hot = (arange_h == hh) & ok
        used = torch.where(hot[:, None], used + req_k[k][None, :], used)
        ncont = torch.where(hot, ncont + 1, ncont)
        pcarry = scheduling.update_place_carry(sim, policy, pcarry, k, cand,
                                               hh, ok)
        chosen[k] = h
    return Round(torch.stack(chosen), used, ncont, pcarry,
                 (s_comm, s_util, s_n) if soft else None)


def comm_split(H: int, n_sms: int, threads_per_sm: int = 2048):
    """``(Y, C)``: how ATen's float32 sum over dim 0 of a contiguous
    [H, H] tensor (the comm column's ``(cnt[:, None] * comm_cost).sum(0)``)
    deals the H rows of a column to its reducing threads, Y in a block and
    C blocks, on a card of ``n_sms`` SMs.  ``setReduceConfig`` in
    ``ATen/native/cuda/Reduce.cuh`` decides it: the outputs vectorised by
    4, 2 or 1 as H divides; a block of ``width`` x ``height`` threads out
    of 512 / vec; the rows split across the ``height`` warps once a
    column's H values reach ``min(16 height, 256)``, and across blocks
    once each warp's share reaches 256 and the grid leaves SMs idle.  The
    kernel adds each column in the order this gives (Y = C = 1: one
    thread a column, every H below 128); the card tests hold it to the
    sum itself at H from 1 to 300 and at 1024, 2000 and 2048."""
    vec = 4
    while H % vec:
        vec //= 2
    max_threads = 512 // vec
    pow2 = lambda n: 1 << (max(n, 1).bit_length() - 1)
    d0 = pow2(H // vec) if H // vec < max_threads else max_threads
    d1 = pow2(H) if H < max_threads else max_threads
    height = min(d1, max_threads // min(d0, 32))
    width = min(d0, max_threads // height)
    if H < min(16 * height, 256):
        return 1, 1
    per_thread = -(-H // height)
    grid = -(-(H // vec) // width)
    target = n_sms * (threads_per_sm // (width * height))
    if per_thread < 256 or grid > target:
        return height, 1
    return height, max(min(-(-target // grid), -(-per_thread // 16)),
                       -(-per_thread // 256))


@functools.lru_cache(maxsize=None)
def _card_split(H: int, device_index: int):
    props = torch.cuda.get_device_properties(device_index)
    return comm_split(H, props.multi_processor_count,
                      getattr(props, "max_threads_per_multi_processor",
                              2048))


def threads_for(H: int) -> int:
    """Threads of the one block: a thread a host, in whole warps, 32 to
    512 (past 512 hosts a thread takes several)."""
    return min(512, max(32, -(-H // 32) * 32))


def smem_bytes(H: int, K: int, rows_in_smem: bool) -> int:
    """Dynamic shared memory of a launch: the live state (5H + 4K words),
    the comm sum's two row lists (2H), the warps' partial argmins (48
    words), the pointer and the list's length (4), and the two [K, H]
    count rows where ``rows_in_smem``."""
    return 4 * (7 * H + 4 * K + 52 + (2 * K * H if rows_in_smem else 0))


def max_hosts(K: int) -> int:
    """The largest fleet whose live state fits one block's shared memory
    with the count rows in device memory."""
    return (SMEM_LIMIT // 4 - 4 * K - 52) // 7


def rows_fit(H: int, K: int) -> bool:
    """Whether the [K, H] count rows go into shared memory (else they stay
    in device memory, updated there)."""
    return smem_bytes(H, K, True) <= SMEM_LIMIT


def _lib():
    from repro_torch.kernels import _build
    fn = _build.load("place_round").place_round_launch
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(cap, speed, leaf, link_util, comm_cost, used, ncont, rr, counts,
           leafpeers, cand, job, ctype, req_k, weights, n_valid: int,
           max_per_host: int, scores=None):
    """The kernel on CUDA tensors, checked as its C interface takes them;
    returns ``(chosen i64[K], used f32[H, 3], ncont i32[H], rr i32[])``.
    ``counts`` and ``leafpeers`` are the kernel's scratch: where they do
    not fit shared memory it updates them in place.  ``scores`` (f32[K,
    H], tests only) receives the score row of each candidate the round
    reached, before the feasibility mask."""
    H, K, C = cap.shape[0], cand.shape[0], job.shape[0]
    specs = (
        ("cap", cap, F32, (H, 3)), ("speed", speed, F32, (H, 3)),
        ("leaf", leaf, I32, (H,)), ("link_util", link_util, F32, (H,)),
        ("comm_cost", comm_cost, F32, (H, H)), ("used", used, F32, (H, 3)),
        ("ncont", ncont, I32, (H,)), ("rr", rr, I32, ()),
        ("counts", counts, F32, (K, H)), ("leafpeers", leafpeers, F32, (K, H)),
        ("cand", cand, I64, (K,)), ("job", job, I32, (C,)),
        ("ctype", ctype, I32, (C,)), ("req_k", req_k, F32, (K, 3)),
        ("weights", weights, F32, (NUM_POLICY_WEIGHTS,)),
    ) + ((("scores", scores, F32, (K, H)),) if scores is not None else ())
    # every dtype, shape and layout before any device, so that the CPU
    # tests reach each check
    for spec in specs:
        check_tensor(*spec)
    if smem_bytes(H, K, False) > SMEM_LIMIT:
        raise ValueError(f"place_round takes up to {max_hosts(K)} hosts at "
                         f"K={K}, got H={H}")
    for name, t, _, _ in specs:
        if t.device.type != "cuda" or t.device != cap.device:
            raise ValueError(f"{name} must be a CUDA tensor on cap's "
                             f"device, got {t.device}")
    check_no_grad("place_round", used=used, counts=counts,
                  leafpeers=leafpeers, req_k=req_k, weights=weights,
                  comm_cost=comm_cost, link_util=link_util)
    if not 0 <= n_valid <= K:
        raise ValueError(f"n_valid must lie in [0, {K}], got {n_valid}")
    dev = cap.device
    Y, C_split = _card_split(H, dev.index if dev.index is not None
                             else torch.cuda.current_device())
    chosen = torch.empty((K,), dtype=I64, device=dev)
    used_out = torch.empty_like(used)
    ncont_out = torch.empty_like(ncont)
    rr_out = torch.empty((), dtype=I32, device=dev)
    ptrs = [t.data_ptr() for t in (
        cap, speed, leaf, link_util, comm_cost, used, ncont, rr, counts,
        leafpeers, cand, job, ctype, req_k, weights, used_out, ncont_out,
        rr_out, chosen)] + [None if scores is None else scores.data_ptr()]
    err = _lib()(*ptrs, H, K, n_valid, max_per_host, W_ROW0, W_RR_TRACK,
                 threads_for(H), int(rows_fit(H, K)), Y, C_split,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"place_round launch at H={H}, K={K} failed: "
                           f"CUDA error {err}")
    LAUNCHES["place_round"] += 1
    return chosen, used_out, ncont_out, rr_out


def place_round(sim, cfg, params, policy, cand: torch.Tensor,
                valid: torch.Tensor, req_k: torch.Tensor, pcarry: PlaceCarry,
                n_valid: int) -> Round:
    """The admit loop of :func:`place_round_ref` without the surrogate:
    on the CPU the plain version, on the card one launch of the kernel on
    the current stream.  The kernel consumes ``pcarry``'s count rows;
    only its pointer is returned anew."""
    if sim.t.device.type == "cpu":
        return place_round_ref(sim, cfg, params, policy, cand, valid, req_k,
                               pcarry, n_valid)
    H = sim.hosts.cap.shape[0]
    hosts, ct = sim.hosts, sim.containers
    chosen, used, ncont, rr = launch(
        hosts.cap, hosts.speed, hosts.leaf, sim.net.link_util[:H],
        sim.net.comm_cost, hosts.used, hosts.n_containers, pcarry.rr,
        pcarry.counts.contiguous(), pcarry.leafpeers.contiguous(), cand,
        ct.job, ct.ctype, req_k, policy.weights.contiguous(), n_valid,
        cfg.max_containers_per_host)
    return Round(chosen, used, ncont, pcarry._replace(rr=rr), None)
