# Training on one card or a device mesh: the chunked loss, AdamW and the train
# step (repro.train's counterparts).
