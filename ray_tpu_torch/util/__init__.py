"""Utilities of the port (``ray_tpu/util``): the host-plane collectives."""
