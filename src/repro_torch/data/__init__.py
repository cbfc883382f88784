"""Datasets of the port: numpy copies of `repro.data`, giving the same arrays
from the same seed."""
