"""Spiking-neuron primitives of the port."""
