"""Sensor backends of the port."""
