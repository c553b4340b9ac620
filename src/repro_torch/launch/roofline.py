"""Roofline terms of the port's programs (the JAX package's
``launch/roofline.py``), per device, priced with H100 constants:

    compute    = FLOPs / PEAK_FLOPS
    memory     = HBM bytes / HBM_BW
    collective = wire bytes / LINK_BW

The JAX module reads FLOPs and bytes from a compiled XLA program
(``cost_analysis()``) and collective bytes from its HLO text.  The port has
no compiler and no HLO: :class:`CostCounter` counts a program as it runs
on ``meta`` tensors (a ``TorchDispatchMode``; ``launch/dryrun.py`` runs
one rank of a production mesh, ``launch.mesh.ShapeMesh``).  What it counts,
and how that differs from XLA's ``cost_analysis``:

* **FLOPs**: 2·M·N·K of each matmul-family op (the ops
  ``torch.utils.flop_counter`` counts).  Elementwise FLOPs are not counted;
  XLA counts them.
* **HBM bytes**: each aten op's inputs read once and its outputs written
  once; views move nothing, a gather reads the rows it returns and a
  scatter writes the rows it is given, a fill or a copy does not read its
  destination.  Bytes are per op, with nothing fused: the port runs
  eagerly, so this is the traffic it makes, L2 hits aside.  XLA counts its
  fused program's bytes.
* **Peak live bytes**: storage counted from its creation to its release,
  the arguments' included.
* **Collectives**: the records of ``distributed.collectives.recording``,
  priced by JAX's ring multipliers (:func:`wire_bytes`).
* **Hand-written kernels**: where the card would launch one
  (``flash_attention``, ``ssd_scan``: impl ``'kernel'`` on meta tensors),
  the counter records the kernel's own work (:func:`kernel_work`), and
  the plain version that stands in for the outputs' shapes is left out.
* **Layout**: the port's per-device FLOPs carry its layout.  A rank
  computes its batch rows with every layer but the experts on weights
  gathered whole (``models/sharding.py``: no tensor parallelism), so the
  ``model`` ranks of a data group compute the same dense layers, where
  XLA's GSPMD program splits them.

The peaks are an NVIDIA H100 SXM's from NVIDIA's data sheet
(``core/h100.py``).  No TPU figure is used.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import kernels
from repro_torch.core.h100 import HBM_BW, LINK_BW, PEAK_FLOPS, PEAK_FP32_PER_S
from repro_torch.distributed import collectives as coll


def bound_ms(n_bytes: float, n_ops: float, peak_ops=PEAK_FP32_PER_S):
    """(the least milliseconds the card could take, what bounds it): the
    larger of ``n_bytes`` at the HBM rate and ``n_ops`` at ``peak_ops``."""
    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# ---------------------------------------------------------------------------
# The hand-written kernels' work
# ---------------------------------------------------------------------------
def flash_work(B, S, Hq, Hkv, D, elem):
    """(bytes, operations) of causal attention: q, k, v read once and o
    written once; 2 D multiply-adds per (q, k) pair with k <= q, for the
    scores and for the PV product."""
    n_bytes = elem * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    return n_bytes, 4.0 * B * Hq * D * (S * (S + 1) / 2)


def ssd_work(B, S, H, P, N, Q):
    """(bytes, operations) of the chunk scan: xs, B, C, dt and A_log read
    once, y and the final state written once; per (b, chunk of Qc) the
    causal half of C.B^T, N multiply-adds per pair (B and C have one
    group, so every head shares it); per (b, h, chunk) the causal half of
    M.xs, P multiply-adds per pair, plus Qc N P for C.h and Qc N P for the
    state update."""
    n_bytes = 4 * (2 * B * S * H * P + 2 * B * S * N + B * S * H + H
                   + B * H * P * N)
    ops = 0.0
    for c0 in range(0, S, Q):
        qc = min(Q, S - c0)
        pairs = qc * (qc + 1) / 2
        ops += 2.0 * B * (pairs * N + H * (pairs * P + 2 * qc * N * P))
    return n_bytes, ops


def ssd_scratch_bytes(B, S, H, P, N, Q) -> int:
    """The scratch the ssd_scan wrapper allocates for its passes: cum
    [B,Cn,H,Qp], C.B^T [B,Cn,Qp,Qp] and the chunk states [B,Cn,H,P,N] in
    f32, Cn chunks of Qp = Q rounded up to 64."""
    Cn, Qp = -(-S // Q), -(-Q // 64) * 64
    return 4 * B * Cn * (H * Qp + Qp * Qp + H * P * N)


def kernel_work(name: str, args) -> Tuple[float, float, int]:
    """(bytes, operations, scratch bytes) of one call of kernel ``name``
    on the inputs ``args`` (its wrapper's)."""
    if name == "flash_attention":
        q, k = args[0], args[1]
        B, S, Hq, D = q.shape
        return (*flash_work(B, S, Hq, k.shape[2], D, q.element_size()), 0)
    if name == "ssd_scan":
        xs, Bm, Q = args[0], args[1], args[5]
        B, S, H, P = xs.shape
        N = Bm.shape[-1]
        return (*ssd_work(B, S, H, P, N, Q),
                ssd_scratch_bytes(B, S, H, P, N, Q))
    raise KeyError(f"no work formula for kernel {name!r}")


def n_moe_layers(cfg) -> int:
    return cfg.n_layers - cfg.first_dense if cfg.n_experts else 0


def prefill_flops(cfg, B, S) -> float:
    """The prefill's products (2 FLOP a multiply-add): projections, MLPs and
    the grouped expert products over all E x C capacity slots, causal
    attention (its half of S^2), the router and the last position's
    unembedding."""
    from repro_torch.models.moe import capacity
    T, d, H = B * S, cfg.d_model, cfg.n_heads
    if cfg.use_mla:
        dk, dv = cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
        proj = (d * cfg.q_lora_rank + cfg.q_lora_rank * H * dk
                + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                + cfg.kv_lora_rank * H * (cfg.qk_nope_dim + dv) + H * dv * d)
    else:
        dk = dv = cfg.d_head
        proj = d * (H + 2 * cfg.n_kv_heads) * dk + H * dk * d
    per_layer = 2.0 * T * proj + 2.0 * B * H * (dk + dv) * S * (S + 1) / 2
    n_moe = n_moe_layers(cfg)
    flops = cfg.n_layers * per_layer
    flops += (cfg.n_layers - n_moe) * 2.0 * T * 3 * d * cfg.d_ff
    if n_moe:
        C = capacity(T, cfg)
        f = cfg.d_ff_expert
        flops += n_moe * (2.0 * 3 * cfg.n_experts * C * d * f
                          + 2.0 * T * d * cfg.n_experts
                          + 2.0 * T * 3 * d * cfg.n_shared_experts * f)
    return flops + 2.0 * B * d * cfg.vocab_padded


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------
def wire_bytes(op: str, nbytes: float, n: int) -> float:
    """Per-device wire bytes of one collective over ``n`` ranks (JAX's ring
    model): all-reduce 2(n-1)/n x buffer; all-gather (n-1)/n x result;
    reduce-scatter (n-1) x result; all-to-all (n-1)/n x buffer;
    collective-permute 1 x buffer; a group of one moves nothing."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * nbytes
    if op == "all-gather":
        return (n - 1) / n * nbytes
    if op == "reduce-scatter":
        return float(n - 1) * nbytes
    if op in ("all-to-all", "ragged-all-to-all"):
        return (n - 1) / n * nbytes
    if op == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective {op!r}")


def collective_bytes(records: Iterable[Tuple[str, float, int]]
                     ) -> Dict[str, float]:
    """Per-device wire bytes by op of ``(op, bytes, group size)`` records,
    with their ``total`` (a group of one skipped)."""
    out: Dict[str, float] = {}
    for op, nbytes, n in records:
        if n <= 1:
            continue
        out[op] = out.get(op, 0.0) + wire_bytes(op, nbytes, n)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RooflineTerms:
    """All quantities are PER DEVICE (one rank's program)."""

    flops: float                 # per-device counted FLOPs
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device wire bytes
    n_devices: int
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0     # whole-step model flops (all devices)
    useful_ratio: float = 0.0    # model_flops / (flops * n_devices)
    coll_breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)

    def finalize(self) -> "RooflineTerms":
        self.t_compute = self.flops / PEAK_FLOPS
        self.t_memory = self.hbm_bytes / HBM_BW
        self.t_collective = self.coll_bytes / LINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        if self.model_flops:
            self.useful_ratio = self.model_flops / max(
                self.flops * self.n_devices, 1.0)
        return self


def from_probes(c1: Dict, c2: Dict, k1: int, k2: int, L: int,
                n_devices: int, model_flops: float = 0.0) -> RooflineTerms:
    """Linear depth-extrapolation of two shallow probes: for a homogeneous
    stack cost(L) is affine in L, so two probes k1 < k2 recover slope and
    intercept exactly: cost(L) = c1 + (c2-c1)/(k2-k1) * (L-k1).  (The
    port's stack is a Python loop, so a full-depth count is exact too.)"""
    def extrap(a, b):
        return a + (b - a) / (k2 - k1) * (L - k1)

    coll = {k: extrap(c1["coll_breakdown"].get(k, 0.0),
                      c2["coll_breakdown"].get(k, 0.0))
            for k in set(c1["coll_breakdown"]) | set(c2["coll_breakdown"])}
    return RooflineTerms(
        flops=extrap(c1["flops"], c2["flops"]),
        hbm_bytes=extrap(c1["hbm_bytes"], c2["hbm_bytes"]),
        coll_bytes=extrap(c1["coll_bytes"], c2["coll_bytes"]),
        n_devices=n_devices, model_flops=model_flops,
        coll_breakdown=coll,
    ).finalize()


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) per step; decode
    steps process one token per sequence."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch        # decode: 1 tok/seq


# ---------------------------------------------------------------------------
# The cost counter
# ---------------------------------------------------------------------------
_aten = torch.ops.aten
_NO_TRAFFIC = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten.new_empty, _aten.new_empty_strided, _aten.detach,
               _aten.alias, _aten.lift_fresh, _aten.sym_size,
               _aten.sym_stride, _aten.sym_numel}
_GATHERS = {_aten.index, _aten.embedding, _aten.gather, _aten.index_select}
_SCATTERS = {_aten.index_put_, _aten.index_copy_, _aten.index_add_,
             _aten.scatter_, _aten.scatter_add_}
_WRITES = {_aten.fill_, _aten.zero_, _aten.copy_}


def _is_view(func) -> bool:
    """Whether an aten op returns a view of an input (moves no bytes)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class CostCounter(TorchDispatchMode):
    """Counts a program run on ``meta`` tensors inside the block (see the
    module's docstring): ``flops`` (and ``flops_by_dtype``),
    ``hbm_bytes``, ``peak_bytes`` (with ``argument_bytes``, those of the
    tensors of ``args``, live from the start), ``records`` (the
    collectives) and ``kernels`` ({name: calls}).  An op that makes a
    tensor with storage off ``meta`` raises: the count allocates nothing
    on a device."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0.0
        self.flops_by_dtype: Dict[str, float] = {}
        self.hbm_bytes = 0.0
        self.kernels: Dict[str, int] = {}
        self.records: list = []
        self.live_bytes = self.peak_bytes = 0
        self._live: Dict[int, Tuple[int, Any]] = {}
        self._suspended = 0
        for t in _tensors(args):
            self._track(t)
        self.argument_bytes = self.live_bytes

    # -- storage lifetimes ---------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if t.device.type != "meta":
            # no storage allocates nothing (the empty CPU tensor that
            # torch.utils.checkpoint makes for itself)
            if st.nbytes() == 0:
                return
            raise RuntimeError(f"the cost counter takes meta tensors; got "
                               f"one of {st.nbytes()} bytes on {t.device}")
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        live = self._live

        def release(_, key=key, n=n):
            if live.pop(key, None) is not None:
                self.live_bytes -= n
        self._live[key] = (n, weakref.ref(st, release))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- the dispatch --------------------------------------------------------
    def __enter__(self):
        self._recording = coll.recording()
        self.records = self._recording.__enter__()
        self._saved_counter, kernels._COUNTER = kernels._COUNTER, self
        return super().__enter__()

    def __exit__(self, *exc):
        kernels._COUNTER = self._saved_counter
        self._recording.__exit__(*exc)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suspended:
            return out
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        packet = func.overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            ins = _tensors(args)
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "?"
            self.flops += f
            self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0.0) + f
        self.hbm_bytes += self._op_bytes(func, packet, args, kwargs, outs)
        return out

    @staticmethod
    def _op_bytes(func, packet, args, kwargs, outs) -> int:
        if _is_view(func) or packet in _NO_TRAFFIC:
            return 0
        ins = list({id(t): t for t in _tensors((args, kwargs))}.values())
        if packet in _GATHERS:            # the source's rows that are read
            src = ins[0]
            return (sum(_nbytes(t) for t in ins if t is not src)
                    + 2 * sum(_nbytes(t) for t in outs))
        if packet in _SCATTERS:           # the rows given, read and written
            dst = ins[0]
            given = [t for t in ins if t is not dst]
            return sum(_nbytes(t) for t in given) + max(
                (_nbytes(t) for t in given), default=0)
        if packet in _WRITES:             # the destination is not read
            dst = ins[0]
            return (sum(_nbytes(t) for t in ins if t is not dst)
                    + sum(_nbytes(t) for t in outs))
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)

    # -- hand-written kernels --------------------------------------------------
    def kernel(self, name: str, plain, *args):
        """One call of kernel ``name`` (``kernels.meta_stand_in``): its
        work counted, ``plain(*args)`` run uncounted for the outputs'
        shapes, which are then live; its scratch live for the call."""
        n_bytes, ops, scratch = kernel_work(name, args)
        self._suspended += 1
        try:
            out = plain(*args)
        finally:
            self._suspended -= 1
        for t in _tensors(out):
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes + scratch)
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self.flops += ops
        dt = str(args[0].dtype).replace("torch.", "")
        self.flops_by_dtype[dt] = self.flops_by_dtype.get(dt, 0.0) + ops
        self.hbm_bytes += n_bytes
        return out

    # -- results ---------------------------------------------------------------
    def raw_costs(self) -> Dict[str, Any]:
        """{flops, hbm_bytes, coll_bytes, coll_breakdown} (what JAX's
        ``roofline.raw_costs`` gives from a compiled program)."""
        coll = collective_bytes(self.records)
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "coll_bytes": coll["total"], "coll_breakdown": coll}

    def terms(self, n_devices: int, model_flops: float = 0.0
              ) -> RooflineTerms:
        c = self.raw_costs()
        return RooflineTerms(
            flops=c["flops"], hbm_bytes=c["hbm_bytes"],
            coll_bytes=c["coll_bytes"], n_devices=n_devices,
            model_flops=model_flops, coll_breakdown=c["coll_breakdown"],
        ).finalize()
