# The distributed substrate of the PyTorch port: slab checkpoints and the
# fault-tolerance state machines (repro.distributed's counterparts).
