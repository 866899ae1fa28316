"""Activations, weight initialisers, losses and the float32-output
product of the port's layer network."""
