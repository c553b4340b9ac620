# DCSim in PyTorch: the port of repro.core (the JAX package) to PyTorch and
# CUDA; the same modules and names, state tuples of tensors on one device.
from repro_torch.core.datacenter import (  # noqa: F401
    HOST_MIXES, PAPER_HOST_CATEGORIES, HostCategory, SimConfig,
    build_paper_hosts, build_paper_network, mixed_hosts, scaled_hosts,
)
from repro_torch.core.engine import init_sim, run_sim, simulate  # noqa: F401
from repro_torch.core.report import summarize, timeseries, to_csv  # noqa: F401
from repro_torch.core.scheduling import (  # noqa: F401
    get_policy, list_policies, register, validate_weights, weight_vector,
)
from repro_torch.core.stats import online_from_metrics  # noqa: F401
from repro_torch.core.types import (  # noqa: F401
    NUM_POLICY_WEIGHTS, WEIGHT_NAMES, ExecPlan, OnlineSummary, PolicyParams,
    RunParams,
)
from repro_torch.core.workload import paper_workload, trace_workload  # noqa: F401
