"""Kernels of the port and the device code around them (layout, planning)."""
