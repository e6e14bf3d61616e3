"""Training of the port's language models: AdamW with float32 master
weights (``optimizer``), the train step and the fault-tolerant loop
(``trainer``), checkpoints (``checkpoint``), int8 gradient compression
(``compression``) and elastic restarts (``elastic``)."""
