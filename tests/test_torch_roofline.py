"""The port's roofline (repro_torch.launch.roofline) against the JAX
package's ``launch/roofline.py``, and its cost counter, on the CPU.

Contracts:
* ``wire_bytes`` / ``collective_bytes`` of ``(op, bytes, group size)``
  records equal JAX's ``collective_bytes`` of the same collectives written
  as HLO lines (every op kind, tuple results, explicit and iota
  ``replica_groups``, a group of one skipped), exactly;
* ``from_probes`` equals JAX's on seeded inputs in every field the
  hardware constants do not price (the terms priced at the port's H100
  constants), exactly; ``model_flops_for`` equals JAX's for all ten
  architectures at the four shapes, exactly;
* the counter's FLOPs of a reduced dense prefill (kernels at their work)
  at the (1, 1) shape-only mesh equal ``prefill_flops``; with impl 'ref'
  the difference is named: the plain attention's scores over the whole
  S^2, not its causal half;
* a hand-written kernel is counted at its work, its stand-in plain
  version not; outside a counter a meta tensor reaches no kernel; the
  counter refuses a tensor off ``meta`` and follows storage lifetimes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.mesh import ShapeMesh  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402

OPS = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute", "ragged-all-to-all"]
DT = {"f32": 4, "bf16": 2, "s32": 4, "u32": 4}


def hlo_line(i, op, shapes, groups, start=False):
    """One HLO instruction of ``op`` with result ``shapes`` ([(type,
    dims)]: one plain result or a tuple) over ``groups`` (a list of rank
    lists, or ("iota", n_groups, size)); and the bytes of its result."""
    txt = [f"{t}[{','.join(map(str, d))}]{{0}}" for t, d in shapes]
    res = txt[0] if len(txt) == 1 else "(" + ", ".join(txt) + ")"
    if groups[0] == "iota":
        rg = f"replica_groups=[{groups[1]},{groups[2]}]<=[{groups[1] * groups[2]}]"
    else:
        rg = "replica_groups={" + ",".join(
            "{" + ",".join(map(str, g)) + "}" for g in groups) + "}"
    name = op + ("-start" if start else "")
    line = (f"  %c{i} = {res} {name}(f32[8]{{0}} %p{i}), channel_id={i}, "
            f"{rg}, use_global_device_ids=true")
    nbytes = sum(DT[t] * int(np.prod(d)) for t, d in shapes)
    return line, nbytes


def group_size(groups):
    return groups[2] if groups[0] == "iota" else len(groups[0])


GROUPS = {"explicit4": [[0, 1, 2, 3], [4, 5, 6, 7]],
          "explicit2": [[0, 1], [2, 3], [4, 5], [6, 7]],
          "iota16": ("iota", 16, 16), "iota2": ("iota", 256, 2),
          "one": [[0], [1], [2]]}


@pytest.mark.parametrize("groups", sorted(GROUPS))
@pytest.mark.parametrize("op", OPS)
def test_collective_bytes_match_jax(op, groups):
    from repro.launch import roofline as jroof
    g = GROUPS[groups]
    lines, records = [], []
    rng = np.random.default_rng(len(op) * 31 + len(groups))
    for i in range(4):
        dims = tuple(int(x) for x in rng.integers(1, 64, size=i % 3 + 1))
        shapes = [("bf16" if i % 2 else "f32", dims)]
        if i == 3:                       # a tuple-typed async start
            shapes.append(("u32", ()))
        line, nbytes = hlo_line(i, op, shapes, g, start=(i == 3))
        lines.append(line)
        records.append((op, nbytes, group_size(g)))
    lines.append("  %add = f32[8]{0} add(f32[8]{0} %a, f32[8]{0} %b)")
    want = jroof.collective_bytes("\n".join(lines))
    got = roofline.collective_bytes(records)
    assert got == want
    if group_size(g) > 1:
        assert got[op] == sum(roofline.wire_bytes(*r) for r in records) > 0
    else:
        assert got == {"total": 0.0}


def test_collective_bytes_sum_over_ops_as_jax():
    from repro.launch import roofline as jroof
    lines, records = [], []
    for i, op in enumerate(OPS * 2):
        g = list(GROUPS.values())[i % 4]
        line, nbytes = hlo_line(i, op, [("f32", (i + 1, 8))], g)
        lines.append(line)
        records.append((op, nbytes, group_size(g)))
    assert roofline.collective_bytes(records) == \
        jroof.collective_bytes("\n".join(lines))
    with pytest.raises(ValueError, match="unknown collective"):
        roofline.wire_bytes("broadcast", 8, 4)


def probe_costs(rng):
    keys = ["all-reduce", "all-gather", "all-to-all"]
    pick = rng.permutation(keys)[:int(rng.integers(1, 4))]
    br = {k: float(rng.uniform(1e6, 1e10)) for k in pick}
    br["total"] = sum(br.values())
    return {"flops": float(rng.uniform(1e12, 1e16)),
            "hbm_bytes": float(rng.uniform(1e9, 1e13)),
            "coll_bytes": br["total"], "coll_breakdown": br}


@pytest.mark.parametrize("seed", range(6))
def test_from_probes_matches_jax(seed):
    from repro.launch import roofline as jroof
    rng = np.random.default_rng(seed)
    c1, c2 = probe_costs(rng), probe_costs(rng)
    k1 = int(rng.integers(1, 6))
    k2 = k1 + int(rng.integers(1, 6))
    L = int(rng.integers(k2, 100))
    n, mf = int(rng.choice([256, 512])), float(rng.uniform(1e15, 1e18))
    got = roofline.from_probes(c1, c2, k1, k2, L, n, mf)
    want = jroof.from_probes(c1, c2, k1, k2, L, n, mf)
    for f in ("flops", "hbm_bytes", "coll_bytes", "n_devices",
              "model_flops", "useful_ratio", "coll_breakdown"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.t_compute == got.flops / roofline.PEAK_FLOPS
    assert got.t_memory == got.hbm_bytes / roofline.HBM_BW
    assert got.t_collective == got.coll_bytes / roofline.LINK_BW
    terms = {"compute": got.t_compute, "memory": got.t_memory,
             "collective": got.t_collective}
    assert got.bottleneck == max(terms, key=terms.get)


def test_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 50e9)
    assert roofline.bound_ms(3.35e9, 0.0) == (1.0, "bytes")
    assert roofline.bound_ms(0.0, 989e9, roofline.PEAK_FLOPS) == (
        1.0, "operations")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_for_matches_jax(arch):
    from repro.configs import get_config as jget_config
    from repro.launch import roofline as jroof
    from repro.models.config import SHAPES as JSHAPES
    for name, shape in SHAPES.items():
        assert roofline.model_flops_for(get_config(arch), shape) == \
            jroof.model_flops_for(jget_config(arch), JSHAPES[name]), name


def prefill_count(cfg, B, S):
    from repro_torch.launch import dryrun
    mesh = ShapeMesh((1, 1), ("data", "model"))
    cc, *_ = dryrun.trace_cell(cfg, ShapeSpec("p", S, B, "prefill"), mesh)
    return cc


@pytest.mark.parametrize("arch", ["smollm_360m", "qwen2_5_3b",
                                  "olmoe_1b_7b"])
def test_counter_flops_of_a_prefill_equal_prefill_flops(arch):
    """Kernels at their work: every product of the prefill counted once,
    equal to the analytic count (projections, MLPs or the experts' E x C
    slots and the router, causal attention, the last position's
    unembedding)."""
    B, S = 2, 64
    cfg = dataclasses.replace(get_reduced(arch), attn_impl="kernel")
    cc = prefill_count(cfg, B, S)
    assert cc.kernels == {"flash_attention": cfg.n_layers}
    assert cc.flops == roofline.prefill_flops(cfg, B, S)


def test_counter_flops_with_the_plain_attention_name_the_difference():
    """impl 'ref': the plain attention computes its scores and PV products
    over the whole S^2 (masked), where the kernel's work is the causal
    half S(S+1)/2: the counts differ by exactly that."""
    B, S = 2, 64
    cfg = get_reduced("smollm_360m")
    cc = prefill_count(cfg, B, S)
    assert cc.kernels == {}
    H, D = cfg.n_heads, cfg.d_head
    extra = cfg.n_layers * 4.0 * B * H * D * (S * S - S * (S + 1) / 2)
    assert cc.flops == roofline.prefill_flops(cfg, B, S) + extra


def test_counter_counts_the_kernel_not_its_stand_in():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    B, S, H, D = 2, 128, 4, 32
    q = torch.empty((B, S, H, D), dtype=torch.bfloat16, device="meta")
    xs = torch.empty((B, S, H, 16), device="meta")
    Bm = torch.empty((B, S, 8), device="meta")
    dt = torch.empty((B, S, H), device="meta")
    A = torch.empty((H,), device="meta")
    with roofline.CostCounter((q, xs, Bm, dt, A)) as cc:
        o = flash_attention(q, q, q)
        y, h = ssd_scan(xs, Bm, Bm, dt, A, 64)
    assert o.shape == q.shape and o.device.type == "meta"
    assert y.shape == xs.shape and h.shape == (B, H, 16, 8)
    fb, fo = roofline.flash_work(B, S, H, H, D, 2)
    sb, so = roofline.ssd_work(B, S, H, 16, 8, 64)
    assert cc.kernels == {"flash_attention": 1, "ssd_scan": 1}
    assert cc.flops == fo + so and cc.hbm_bytes == fb + sb
    scratch = roofline.ssd_scratch_bytes(B, S, H, 16, 8, 64)
    assert cc.peak_bytes >= cc.argument_bytes + scratch


def test_meta_tensors_reach_no_kernel_outside_a_counter():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    q = torch.empty((1, 64, 2, 32), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="cost counter"):
        flash_attention(q, q, q)
    xs = torch.empty((1, 64, 2, 16), device="meta")
    Bm = torch.empty((1, 64, 8), device="meta")
    with pytest.raises(RuntimeError, match="cost counter"):
        ssd_scan(xs, Bm, Bm, torch.empty((1, 64, 2), device="meta"),
                 torch.empty((2,), device="meta"), 64)


def test_counter_refuses_tensors_off_meta():
    with pytest.raises(RuntimeError, match="meta"):
        with roofline.CostCounter():
            torch.ones(3) + 1
    with roofline.CostCounter() as cc:      # no storage: nothing allocated
        torch.empty((0,), requires_grad=True)
    assert cc.peak_bytes == 0
    with pytest.raises(RuntimeError, match="meta"):
        roofline.CostCounter((torch.ones(2),))


def test_counter_follows_storage_lifetimes():
    a = torch.empty((256, 256), device="meta")            # 256 KiB
    with roofline.CostCounter((a,)) as cc:
        b = a @ a                                          # +256 KiB
        c = b.t()                                          # a view
        del b
        d = c + 1.0                                        # +256 KiB
        del c
        e = torch.zeros((1024,), device="meta")           # +4 KiB
        e.copy_(d[0].repeat(4))
        del d
        rows = a[torch.zeros((8,), dtype=torch.long, device="meta")]
    kib = 256 * 256 * 4
    assert cc.argument_bytes == kib
    assert cc.peak_bytes == 3 * kib           # a, b (held by c) and d
    assert cc.live_bytes == kib + 4096 + rows.numel() * 4
    assert cc.flops == 2 * 256 ** 3
    assert cc.flops_by_dtype == {"float32": 2 * 256 ** 3}
    assert cc.records == [] and cc.kernels == {}
