# The distributed substrate of the PyTorch port: slab checkpoints (re-sharded
# across meshes), the fault-tolerance state machines, collectives over a
# mesh's axes and the int8 cross-pod gradient compression
# (repro.distributed's counterparts).
