"""Parallelism over several GPUs: the mesh and its specs, tensor
parallelism, ring and Ulysses attention, and process-group set-up."""
