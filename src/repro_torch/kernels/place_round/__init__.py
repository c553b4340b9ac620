from repro_torch.kernels.place_round.place_round import (  # noqa: F401
    place_round, place_round_ref,
)
