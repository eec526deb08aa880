"""Frozen FLOP and byte arithmetic: the program may change its kernels,
the yardstick here stays."""
