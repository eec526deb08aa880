"""Parallel samplers and placement: ``tempering`` (replica exchange over
the chain axis) and ``mesh`` (the chains of an ensemble split over the
ranks of a ``torch.distributed`` process group)."""
