"""Core pieces of the port's training path: the worker-axis seam,
gradient compression, communication scheduling and the elastic
worker-set surface."""
