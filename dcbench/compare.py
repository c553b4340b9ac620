"""The comparison that decides ``correct``: the program's results against
the plain reference's, worked out again from the same numpy inputs.

The numbers of a result, each held to a limit the cell's traffic file
states (``limits``; PERF.md gives the readings each was set from):

* ``decisions_differ`` -- containers whose final status, host, migration
  destination or migration count differ from the reference's, plus the
  integer fields of the run's summary (ticks, arrivals, placement
  decisions, migration starts, flow-ticks, peaks) that differ;
* ``state_gap`` -- the widest gap over the float leaves of the final
  state (work done, flow bytes left, comm clocks, start and finish
  times, host usage and busy clocks, link utilization, the refreshed
  delay matrix and comm-cost table, the total cost), each leaf's gap
  taken against the largest magnitude in the reference's leaf;
* ``summary_gap`` -- the widest relative gap of the streamed summary's
  float fields (utilization variance and mean, flow rate, Welford pair)
  against the reference's f64 fold of its per-tick series;
* ``delay_gap`` -- where the reference follows the program's delay
  refreshes (``reference.sim.run``'s ``follow``): the widest gap of the
  reference's own refreshed delay matrix to the program's, over the
  largest entry of the reference's, at any refresh.  A mix whose
  ``limits`` name it is judged by it.
"""
from __future__ import annotations

import numpy as np

from dcbench.reference import sim as ref_sim

INT_STATE = ("c.status", "c.host", "c.mig_dst", "c.n_migrations")
FLOAT_STATE = ("c.run_at", "c.start_t", "c.finish_t", "c.comm_bytes_left",
               "c.mig_bytes_left", "c.comm_time", "c.next_comm_at",
               "h.used", "h.busy", "net.link_util", "net.delay_matrix",
               "net.comm_cost", "total_cost")
INT_SUMMARY = ("n_ticks", "sum_active_flows", "sum_arrivals",
               "sum_decisions", "sum_migrations", "peak_running",
               "peak_deployed", "peak_overloaded", "peak_inactive")
FLOAT_SUMMARY = ("sum_util_var", "sum_mean_util", "sum_flow_rate",
                 "w_mean_util", "w_m2_util")
NUMBERS = ("decisions_differ", "state_gap", "summary_gap", "delay_gap")


def reference_device(ctx):
    """Where the reference runs: on the run's device on the CPU, else on
    the device the traffic names (``reference_device``, the card's
    ``cuda`` where it names none)."""
    import torch
    if ctx.device.type == "cpu":
        return ctx.device
    return torch.device(ctx.traffic.get("reference_device", "cuda"))


def reference_state(s: ref_sim.Sim) -> dict:
    n = lambda x: x.detach().cpu().numpy()
    out = {"c." + k: n(v) for k, v in s.c.items()}
    out.update({"h.used": n(s.h["used"]), "h.n": n(s.h["n"]),
                "h.busy": n(s.h["busy"]),
                "net.link_util": n(s.net["link_util"]),
                "net.delay_matrix": n(s.net["delay_matrix"]),
                "net.comm_cost": n(s.net["comm_cost"]),
                "total_cost": n(s.total_cost), "t": n(s.t), "rr": n(s.rr)})
    return out


def reference_summary(series: dict) -> dict:
    """The run's summary from the per-tick series, in f64 (two-pass
    mean and M2 of the mean utilization)."""
    mu = series["mean_util"]
    w_mean = mu.mean()
    return dict(
        n_ticks=np.int64(mu.shape[0]),
        sum_util_var=series["util_variance"].sum(),
        sum_mean_util=mu.sum(), sum_flow_rate=series["mean_flow_rate"].sum(),
        w_mean_util=w_mean, w_m2_util=((mu - w_mean) ** 2).sum(),
        sum_active_flows=series["active_flows"].sum().astype(np.int64),
        sum_arrivals=series["new_arrivals"].sum().astype(np.int64),
        sum_decisions=series["decisions"].sum().astype(np.int64),
        sum_migrations=series["migrations"].sum().astype(np.int64),
        peak_running=series["n_running"].max().astype(np.int64),
        peak_deployed=series["n_deployed"].max().astype(np.int64),
        peak_overloaded=series["n_overloaded"].max().astype(np.int64),
        peak_inactive=series["n_inactive"].max().astype(np.int64))


def numbers(state: dict, summary: dict, ref_state: dict,
            ref_summ: dict) -> dict:
    """The first three compared numbers of one run (module
    docstring)."""
    differ = 0
    mismatch = None
    for k in INT_STATE:
        diff = np.asarray(state[k]) != ref_state[k]
        mismatch = diff if mismatch is None else (mismatch | diff)
    differ += int(mismatch.sum())
    differ += sum(int(np.asarray(summary[k]) != ref_summ[k])
                  for k in INT_SUMMARY)
    state_gap = 0.0
    for k in FLOAT_STATE:
        a = np.asarray(state[k], np.float64)
        b = np.asarray(ref_state[k], np.float64)
        scale = float(np.abs(b[np.isfinite(b)]).max(initial=0.0))
        both_inf = (a == b) & ~np.isfinite(b)
        gap = np.where(both_inf, 0.0, np.abs(a - b))
        gap = float(np.nan_to_num(gap, nan=np.inf).max(initial=0.0))
        state_gap = max(state_gap, gap / max(scale, 1e-30))
    summary_gap = 0.0
    for k in FLOAT_SUMMARY:
        a, b = float(summary[k]), float(ref_summ[k])
        gap = 0.0 if a == b else abs(a - b) / max(abs(b), 1e-30)
        summary_gap = max(summary_gap, gap if np.isfinite(gap) else np.inf)
    return dict(decisions_differ=differ, state_gap=state_gap,
                summary_gap=summary_gap)


def worst(readings: list, keys=NUMBERS) -> dict:
    """The largest reading of each number over several compared runs."""
    return {k: max(r[k] for r in readings) for k in keys}


def judge(readings: list, limits: dict) -> tuple:
    """(correct, failed runs, the worst reading of each number that
    ``limits`` names beside its limit).  A run fails where any of those
    numbers is over its limit."""
    keys = [k for k in NUMBERS if k in limits]
    failed = sum(any(r[k] > limits[k] for k in keys) for r in readings)
    top = worst(readings, keys) if readings else {k: float("inf")
                                                  for k in keys}
    checks = {k: {"value": top[k], "limit": limits[k]} for k in keys}
    return bool(readings) and failed == 0, failed, checks
