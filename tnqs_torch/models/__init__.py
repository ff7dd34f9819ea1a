"""Circuit layers of the benchmark workloads."""

from .heisenberg import heisenberg_thermal_layer, htse_free_energy_density_4th
from .ising import heavy_hex_kicked_ising_layer, operator_picture_layer, tfim_layer

__all__ = [
    "heavy_hex_kicked_ising_layer",
    "heisenberg_thermal_layer",
    "htse_free_energy_density_4th",
    "operator_picture_layer",
    "tfim_layer",
]
