from repro_torch.kernels.seg_waterfill.seg_waterfill import (  # noqa: F401
    seg_waterfill, seg_waterfill_ref,
)
