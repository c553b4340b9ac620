"""Window driver of a policy x scenario x seed sweep, one whole grid a
unit.

A grid is the port's streamed sweep over its cells, ``launch.sweep``'s
``make_stream_fn`` as ``run_sweep`` builds it (cells one after another
in the flattened policy-major order, ``plan.slab`` cells gathered to the
host at a time), over the mix's containers in the orders that seeds
``--seed + g * n`` .. ``--seed + g * n + n - 1`` give, for grid ``g`` of
``n`` seeds.  The unit is a whole grid, so a window holds every policy
equally; its work is the grid's cells.  The finished cells, or a sample
of them drawn from the seed, are compared with the plain reference.
"""
from __future__ import annotations

import numpy as np

from dcbench import compare, inputs, program
from dcbench.reference import sim as ref_sim

WARM_TICKS = 2            # the refresh at tick 0 and one tick after it
# grids whose inputs set-up builds; a window that runs more builds the
# rest as it comes
GRIDS_BUILT_IN_SETUP = 4
# cells held to the reference a run: every cell of two grids of six, the
# grids a 30 s window holds today; a faster sweep is sampled from the seed
REFERENCE_CELLS = 12


class Driver:
    unit_name = "grid"

    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.policies = list(tr["policies"])
        self.scenarios = list(tr["scenarios"])
        self.n_seeds = tr.get("seeds_per_grid", 1)
        self.horizon = ctx.sim["horizon"]
        self.grids = []          # (g, finals on the host, summary)
        self.cells = self.ticks = 0
        self._inputs = {}

    def build_inputs(self):
        """The fleet's numpy tables; each grid's workloads are drawn from
        its seeds as it comes (:meth:`seeds`)."""
        ctx = self.ctx
        fleet = ctx.config["fleet"]
        self.hosts = inputs.host_tables(ctx.topology.port.host_switch(fleet),
                                        fleet["host_categories"])

    def setup(self):
        ctx, p = self.ctx, program.port()
        self.build_inputs()
        self.cfg = program.sim_config(ctx.sim)
        self.net, self.H, self.N = ctx.topology.port.build(
            ctx.config["fleet"], ctx.device)
        plan = ctx.traffic["plan"]
        self.fn = p.sweep.make_stream_fn(
            self.cfg, self.H, self.N, self.horizon, chunk=plan["chunk"],
            slab=plan.get("slab"), telescope=plan.get("telescope", False))
        self.pols = p.sweep.stack_policies(self.policies, device=ctx.device)
        p.engine.use_deterministic(ctx.device)
        for g in range(GRIDS_BUILT_IN_SETUP):
            self._grid_inputs(g)

    def _workload(self, scenario: dict, seed: int) -> dict:
        """The mix's containers under ``scenario``'s arrival process, in
        the order ``seed`` gives (``inputs.mix_workload``)."""
        mix = dict(self.ctx.traffic,
                   arrival=scenario.get("arrival",
                                        self.ctx.traffic["arrival"]))
        return inputs.mix_workload(self.ctx.sim, mix, seed)

    def seeds(self, g: int) -> list:
        return [self.ctx.seed + g * self.n_seeds + i
                for i in range(self.n_seeds)]

    def _grid_inputs(self, g: int):
        """The grid's stacked states [S, N] and run parameters [S]."""
        if g in self._inputs:
            return self._inputs[g]
        ctx, p = self.ctx, program.port()
        stack = p.scenario.stack_tree
        sims, rps = [], []
        for sc in self.scenarios:
            spec = p.scenario.ScenarioSpec(**sc)
            per_seed = [program.initial_state(
                self.hosts, self._workload(sc, s), self.net, ctx.device)
                for s in self.seeds(g)]
            sims.append(stack(per_seed))
            rps.append(spec.run_params(self.cfg, ctx.device))
        self._inputs[g] = (stack(sims), stack(rps))
        return self._inputs[g]

    def warm(self):
        """One cell of the grid's first seed through a stream function of
        the same chunk over the first ticks (the refresh at tick 0 among
        them): the kernels load and the allocator fills."""
        p = program.port()
        sims, rps = self._grid_inputs(0)
        n = WARM_TICKS
        plan = self.ctx.traffic["plan"]
        fn = p.sweep.make_stream_fn(self.cfg, self.H, self.N, n,
                                    chunk=min(plan["chunk"], n), slab=1)
        fn(sims, p.sweep.stack_policies(self.policies[:1],
                                        device=self.ctx.device), rps)

    def unit(self) -> int:
        g = len(self.grids)
        sims, rps = self._grid_inputs(g)
        finals, summary = self.fn(sims, self.pols, rps)
        self._inputs.pop(g)
        self.grids.append((g, finals, summary))
        n = len(self.policies) * len(self.scenarios) * self.n_seeds
        self.cells += n
        self.ticks += n * self.horizon
        return n

    def close(self):
        self.n_answers = len(self.grids)
        del self.net, self._inputs

    def sample(self) -> list:
        """The cells compared, as (g, policy, scenario, seed) indices:
        every cell of the finished grids, or ``REFERENCE_CELLS`` of them
        drawn from the seed where there are more."""
        rng = np.random.default_rng(self.ctx.seed)
        all_cells = [(g, p, s, n) for g, _, _ in self.grids
                     for p in range(len(self.policies))
                     for s in range(len(self.scenarios))
                     for n in range(self.n_seeds)]
        k = min(REFERENCE_CELLS, len(all_cells))
        pick = rng.choice(len(all_cells), size=k, replace=False)
        return [all_cells[i] for i in sorted(pick)]

    def reference(self, g, p, s, n, lowp=False):
        ctx = self.ctx
        sc = dict(self.scenarios[s])
        cols = self._workload(sc, self.seeds(g)[n])
        sc.pop("name")
        sc.pop("arrival", None)
        dev = compare.reference_device(ctx)
        fabric = ctx.topology.reference.build_net(ctx.config["fleet"], dev)
        st, series, _ = ref_sim.run(self.hosts, cols, fabric, ctx.sim,
                                    self.policies[p], self.horizon, dev,
                                    lowp=lowp, scenario=sc)
        return compare.reference_state(st), compare.reference_summary(series)

    def cell_result(self, g, p, s, n):
        """Cell (p, s, n) of grid g: its final state and summary."""
        _, finals, summary = self.grids[g]
        state = {k: np.asarray(v)[p, s, n]
                 for k, v in program.state_to_host(finals).items()}
        summ = {k: np.asarray(v)[p, s, n]
                for k, v in program.summary_to_dict(summary).items()}
        return state, summ

    def check(self) -> list:
        out = []
        for idx in self.sample():
            ref_state, ref_summ = self.reference(*idx)
            st, su = self.cell_result(*idx)
            out.append(compare.numbers(st, su, ref_state, ref_summ))
        return out

    def counters(self) -> dict:
        return {"ticks": self.ticks, "cells": self.cells}

    def shapes(self) -> dict:
        return self.ctx.topology.port.kernel_shapes(self.ctx.config["fleet"],
                                                    self.ctx.sim)
