"""Measurement tools for the port: `phase_costs` runs on a CUDA card, `bmps_cost` on
any machine (meta tensors)."""
