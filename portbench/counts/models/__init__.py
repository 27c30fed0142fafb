"""The model FLOP counts, one module a reference (`counts/model.py`)."""
