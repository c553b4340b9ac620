from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: F401
    ssd_chunked, ssd_scan, ssd_scan_ref,
)
