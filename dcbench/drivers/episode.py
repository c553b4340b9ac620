"""Window driver of simulation episodes, one whole episode a unit.

One episode is the port's own entry as its users call it:
``engine.run_sim(sim0, ..., horizon, params, plan=ExecPlan(chunk=...,
telescope=...))``, which streams the horizon chunk by chunk and returns
the final state and the streamed summary.  The window closes at the
first episode boundary after its seconds; the work of an episode is its
``horizon`` ticks (cheap ticks of a telescoped run included).  Episodes
run back to back from the same set-up state, which ``run_sim`` never
writes to, so every episode that completes is the same answer, and each
is compared with one reference run.

The reference follows the program's delay refreshes: while the window's
first episode runs, the matrix each refresh gives
(``network.update_delay_matrix``'s result) is kept, and the reference,
at each of its own refreshes, measures its own matrix against the
program's (``delay_gap``) and goes on from the program's.  The
simulation is chaotic: an ulp of delay, which another association of the
shortest paths' sums moves, turns a tie between hosts and every decision
after it.  So the decisions are judged on the program's own delays, and
the delays on their own gap, and neither hangs on how the program's
``fw_minplus`` groups its sums.
"""
from __future__ import annotations

from dcbench import compare, inputs, program
from dcbench.reference import sim as ref_sim

WARM_TICKS = 2            # the refresh at tick 0 and one tick after it


class DelayRecorder:
    """Stands in for the port's ``network.update_delay_matrix`` while
    installed: calls it, and while ``sink`` is a list appends each
    refreshed delay matrix to it (the tensor itself: no later phase
    writes it in place)."""

    def __init__(self, network):
        self.network = network
        self.real = network.update_delay_matrix
        self.sink = None

    def __call__(self, *args, **kwargs):
        net = self.real(*args, **kwargs)
        if self.sink is not None:
            self.sink.append(net.delay_matrix)
        return net

    def install(self):
        self.network.update_delay_matrix = self

    def remove(self):
        self.network.update_delay_matrix = self.real


class Driver:
    unit_name = "episode"

    def __init__(self, ctx):
        self.ctx = ctx
        self.horizon = ctx.sim["horizon"]
        self.ticks = 0
        self.episodes = []
        self.delays = None        # the first episode's refreshed matrices

    # -- set-up ------------------------------------------------------------
    def build_inputs(self):
        """The seed's numpy inputs, which the program and the reference
        are both built from."""
        ctx = self.ctx
        fleet = ctx.config["fleet"]
        self.hosts = inputs.host_tables(ctx.topology.port.host_switch(fleet),
                                        fleet["host_categories"])
        self.cols = inputs.mix_workload(ctx.sim, ctx.traffic, ctx.seed)

    def setup(self):
        ctx, p = self.ctx, program.port()
        self.build_inputs()
        self.cfg = program.sim_config(ctx.sim)
        net, self.H, self.N = ctx.topology.port.build(ctx.config["fleet"],
                                                      ctx.device)
        self.sim0 = program.initial_state(self.hosts, self.cols, net,
                                          ctx.device)
        self.policy = p.scheduling.get_policy(ctx.traffic["policy"],
                                              device=ctx.device)
        self.params = self.cfg.run_params(ctx.device)
        plan = ctx.traffic["plan"]
        self.plan = p.types.ExecPlan(chunk=plan["chunk"],
                                     telescope=plan.get("telescope", False))
        self.recorder = DelayRecorder(p.network)
        self.recorder.install()

    def _episode(self, horizon):
        return program.port().engine.run_sim(
            self.sim0, self.cfg, self.policy, self.H, self.N, horizon,
            self.params, plan=self.plan)

    def warm(self):
        """The first ticks of an episode through the same entry and plan,
        the delay refresh at tick 0 among them: the kernels load and the
        allocator fills."""
        self._episode(WARM_TICKS)

    # -- the window --------------------------------------------------------
    def unit(self) -> int:
        """One whole episode; returns its ticks."""
        rec = self.recorder
        rec.sink = [] if self.delays is None else None
        final, online = self._episode(self.horizon)
        if rec.sink is not None:
            self.delays, rec.sink = rec.sink, None
        self.episodes.append((final, online))
        self.ticks += self.horizon
        return self.horizon

    def close(self):
        """After the window: the results come to the host and the device
        state goes."""
        self.recorder.remove()
        self.results = [(program.state_to_host(f), program.summary_to_dict(o))
                        for f, o in self.episodes]
        self.delays = [d.detach().cpu() for d in self.delays or []]
        self.n_answers = len(self.episodes)
        del self.episodes, self.sim0

    # -- the check -----------------------------------------------------------
    def reference(self, lowp=False, follow=None, record=None):
        """The plain reference over the same inputs: (state, summary,
        delay gap).  ``follow``: the delay matrices to go on from at each
        refresh; ``record``: a list that takes the reference's own."""
        ctx = self.ctx
        dev = compare.reference_device(ctx)
        fabric = ctx.topology.reference.build_net(ctx.config["fleet"], dev)
        s, series, gap = ref_sim.run(
            self.hosts, self.cols, fabric, ctx.sim, ctx.traffic["policy"],
            self.horizon, dev, lowp=lowp, follow=follow, record=record)
        return (compare.reference_state(s), compare.reference_summary(series),
                gap)

    def check(self) -> list:
        """The compared numbers of each completed episode."""
        ref_state, ref_summ, gap = self.reference(follow=self.delays)
        return [dict(compare.numbers(st, su, ref_state, ref_summ),
                     delay_gap=gap) for st, su in self.results]

    # -- what the per-layer readers read ------------------------------------
    def counters(self) -> dict:
        return {"ticks": self.ticks}

    def shapes(self) -> dict:
        return self.ctx.topology.port.kernel_shapes(self.ctx.config["fleet"],
                                                    self.ctx.sim)
