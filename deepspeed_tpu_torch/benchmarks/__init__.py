"""Benchmarks of the port (counterpart of ``deepspeed_tpu/benchmarks/``)."""
