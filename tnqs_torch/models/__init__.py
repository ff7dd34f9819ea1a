"""Circuit layers of the benchmark workloads."""

from .ising import heavy_hex_kicked_ising_layer, tfim_layer

__all__ = ["heavy_hex_kicked_ising_layer", "tfim_layer"]
