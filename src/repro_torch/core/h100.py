"""An NVIDIA H100 SXM's peak rates, from NVIDIA's data sheet (dense, no
sparsity, at the full 700 W): what ``launch/roofline.py`` prices a
program with and ``core/bridge.py`` takes as a card's speed."""

PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
# bytes/s a GPU puts on the wire: one 400 Gb/s NDR InfiniBand port per GPU,
# as a DGX H100 has.  Every collective group of the production meshes (16
# ranks along data or model, or the pod axis) spans more than one 8-GPU
# node, so a ring over it is held to the inter-node link, not NVLink's
# 450 GB/s.
LINK_BW = 50e9
PEAK_FP32_PER_S = 67e12    # f32 outside the tensor cores
PEAK_TF32_PER_S = 495e12   # dense TF32 tensor-core rate
