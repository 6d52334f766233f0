"""The training loop (the port of `repro/runtime/trainer.py`)."""
