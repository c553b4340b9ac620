from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: F401
    CUDA_LAUNCHES_PER_CALL, SSDScanFn, ssd_chunked, ssd_scan, ssd_scan_ref,
)
