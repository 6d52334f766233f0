"""AdamW with f32 master weights (the port of `repro/optim/adamw.py`)."""
