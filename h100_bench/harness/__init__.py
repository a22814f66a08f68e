"""The port's H100 benchmark harness (see ``h100_bench/run.py``)."""
