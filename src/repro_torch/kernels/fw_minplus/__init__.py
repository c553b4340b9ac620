from repro_torch.kernels.fw_minplus.fw_minplus import (  # noqa: F401
    floyd_warshall, floyd_warshall_ref,
)
