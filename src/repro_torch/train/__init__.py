# Training on one card: the chunked loss, AdamW and the train step
# (repro.train's counterparts).
