# The deterministic data pipeline (repro.data's counterpart).
