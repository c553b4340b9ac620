# DCSim in PyTorch: the port of repro.core (the JAX package) to PyTorch and
# CUDA; the same modules and names, state tuples of tensors on one device.
from repro_torch.core.datacenter import (  # noqa: F401
    HOST_MIXES, PAPER_HOST_CATEGORIES, HostCategory, SimConfig,
    build_paper_hosts, build_paper_network, mixed_hosts, scaled_hosts,
)
from repro_torch.core.engine import (  # noqa: F401
    init_sim, run_sim, run_sim_chunked, simulate, simulate_chunk,
)
from repro_torch.core.report import (  # noqa: F401
    summarize, sweep_summaries, sweep_table, timeseries, to_csv, tune_table,
)
from repro_torch.core.scenario import (  # noqa: F401
    ScenarioSpec, build_scenario, build_scenarios, default_scenarios,
)
from repro_torch.core.scheduling import (  # noqa: F401
    get_policy, list_policies, register, validate_weights, weight_vector,
)
from repro_torch.core.stats import (  # noqa: F401
    acc_init, acc_update, check_chunk, max_chunk_ticks, online_fold,
    online_from_metrics, online_init,
)
from repro_torch.core.types import (  # noqa: F401
    NUM_POLICY_WEIGHTS, WEIGHT_NAMES, ExecPlan, OnlineSummary, PolicyParams,
    RunParams, SummaryAcc,
)
from repro_torch.core.workload import (  # noqa: F401
    bursty_workload, paper_workload, trace_workload,
)
