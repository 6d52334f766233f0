"""Synthetic LM data (a copy of `repro/data/pipeline.py`)."""
