"""Measurement pieces of the port.  So far only the NVML reader in
``core/backends/nvml.py``; the copy of the PMT library (Session,
sampler, resolver, registry) comes with the next slice."""
