"""Optimisation of the layer network: the per-layer gradient updater."""
